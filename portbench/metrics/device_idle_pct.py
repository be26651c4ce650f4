"""device: the share of the traced window in which the card ran no
kernel, copy or set (%), from the profiler's timeline."""


def read(run):
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
