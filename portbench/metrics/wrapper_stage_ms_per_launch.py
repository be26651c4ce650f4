"""kernel wrappers: host milliseconds staging a launch (``kernels.stage``:
the geometry, the outputs' allocation, the parameters and the launch
call) per launch."""

from ._per_launch import ms_per_launch


def read(run):
    return ms_per_launch(run, "kernels.stage")
