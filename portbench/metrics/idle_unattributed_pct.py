"""device: the share of the traced window in which the card is idle and
the host is in no program span below the request's root (%): the
harness between solves, and the facade's and the veneer's own Python.
The card's busy intervals come from the profiler, placed on the host
clock (``harness.program.card_on_host_clock``); the spans from the
port's recorder."""

from ..harness.profile import gaps, union


def read(run):
    snap = getattr(run, "program", None)
    if snap is None or getattr(run, "window", None) is None:
        return None
    w0, w1 = run.window
    spans = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in snap.spans
             if s.parent is not None]
    free = gaps(union(list(run.card_busy) + spans), w0, w1)
    return 100.0 * sum(b - a for a, b in free) / (w1 - w0)
