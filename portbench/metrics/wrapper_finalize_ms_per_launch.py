"""kernel wrappers: host milliseconds in a launch's top-K finalize after
the wait (``kernels.finalize``, with the recorder's read of the walk
counters) per launch."""

from ._per_launch import ms_per_launch


def read(run):
    return ms_per_launch(run, "kernels.finalize")
