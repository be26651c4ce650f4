"""The set-up time (s): from the start of the process to the opening of
the window: imports, the CUDA context, loading (or, in a fresh checkout,
building) the kernels and the C core, the pool, and the cell's warm
solves."""


def read(run):
    return run.setup_s
