"""Solves completed without failure over all the window's time
(solves/s); the window closes when the first solve that ends after the
run's length ends."""


def read(run):
    return sum(run.oks) / run.elapsed
