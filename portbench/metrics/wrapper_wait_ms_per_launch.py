"""kernel wrappers: host milliseconds waiting for a launch
(``kernels.wait``: the read of its abort flag, which returns once the
kernel has ended) per launch."""

from ._per_launch import ms_per_launch


def read(run):
    return ms_per_launch(run, "kernels.wait")
