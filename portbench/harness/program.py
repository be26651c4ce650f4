"""The port's own recorder (``fplll_tpu_torch.trace``) in a traced run,
and the card's busy time on the same clock.

The recorder's spans sit on the host clock (``time.perf_counter``), the
profiler's timeline on its own. The harness's ``portbench.solve`` ranges
are on both: the profiler records each as a ``record_function`` range,
and the harness's spans record ``perf_counter`` at each one's start. The
median difference over the window's solves places the profiler's
window and the card's busy intervals on the host clock.

:func:`recorded` runs one traced run of :func:`runner.run_cell` with the
recorder on over the measured window (started right after the profiler,
stopped right before the harness's spans come off) and hands the
metric readers of the recorder (``metrics/<name>.py`` of
:data:`METRICS`) a :class:`ProgramView`.
"""

from __future__ import annotations

import contextlib
import statistics
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from . import profile, runner
from .registry import reader

__all__ = ["METRICS", "ProgramView", "card_on_host_clock", "recorded",
           "read_all"]

# the per-layer metrics that read the recorder, with their units
METRICS = {
    "first_pass_iters_per_node": "iters/node",
    "roots_native_ms_per_launch": "ms",
    "pack_h2d_ms_per_launch": "ms",
    "wrapper_stage_ms_per_launch": "ms",
    "wrapper_wait_ms_per_launch": "ms",
    "wrapper_finalize_ms_per_launch": "ms",
    "walker_busy_pct": "%",
    "idle_unattributed_pct": "%",
}


@dataclass
class ProgramView:
    """What the recorder's readers see of one traced run: the snapshot
    (None: the program has no recorder), and, where the profiler saw the
    card, the window and the card's busy intervals on the host clock
    (seconds)."""
    program: object = None
    window: Optional[Tuple[float, float]] = None
    card_busy: List[Tuple[float, float]] = field(default_factory=list)


def card_on_host_clock(prof, solve_starts: List[float]):
    """(window, busy intervals) of the profiler's timeline on the host
    clock, through the offset of the ``portbench.solve`` ranges from
    `solve_starts` (their ``perf_counter`` starts, in order); None
    without device activity or solves."""
    dev, host = profile._events(prof)
    win = [(a, b) for name, a, b in host if name == "window"]
    ranges = sorted(a for name, a, _ in host if name == "solve")
    n = min(len(ranges), len(solve_starts))
    if not dev or not win or not n:
        return None
    off = statistics.median(t * 1e6 - a for t, a in
                            zip(sorted(solve_starts)[:n], ranges[:n]))
    w0, w1 = win[0]
    busy = profile.union([(max(a, w0), min(b, w1)) for _, a, b in dev
                          if b > w0 and a < w1])
    return ((w0 + off) * 1e-6, (w1 + off) * 1e-6), \
        [((a + off) * 1e-6, (b + off) * 1e-6) for a, b in busy]


@contextlib.contextmanager
def recorded():
    """Within it, :func:`runner.run_cell`'s traced runs record with the
    port's recorder over the window; yields a list that receives one
    :class:`ProgramView` per such run."""
    from fplll_tpu_torch import trace

    views: List[ProgramView] = []
    got: dict = {}
    measure, read, tracer = runner.measure, profile.read, runner.Tracer

    class Tracer(tracer):
        def install(self):
            got["tracer"] = self
            super().install()

        def remove(self):
            if "snap" not in got and trace.on():
                got["snap"] = trace.stop()
            super().remove()

    def window(*a, **k):
        if "tracer" in got:
            trace.start()
        return measure(*a, **k)

    def profiled(prof):
        view = ProgramView(got.pop("snap", None))
        solves = [t0 for t0, _, _ in got.pop("tracer").spans.get("solve",
                                                                  ())]
        card = card_on_host_clock(prof, solves)
        if card is not None:
            view.window, view.card_busy = card
        views.append(view)
        return read(prof)

    runner.measure, runner.Tracer, profile.read = window, Tracer, profiled
    try:
        yield views
    finally:
        runner.measure, runner.Tracer, profile.read = measure, tracer, read
        if trace.on():
            trace.stop()


def read_all(view: ProgramView) -> dict:
    """{metric: {value, unit}} of every metric of :data:`METRICS` that
    has something to read."""
    out = {}
    for name, unit in METRICS.items():
        v = reader(name)(view)
        if v is not None:
            out[name] = {"value": float(v), "unit": unit}
    return out
