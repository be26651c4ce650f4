"""One recorder of spans, counters and card launches for the whole port.

    from fplll_tpu_torch import trace
    trace.start()
    ...                      # any calls into the port
    snap = trace.stop()      # spans, counts, launches, sweeps

Off (the default), ``trace.span(name)`` reads one module global and
returns a shared no-op context: no allocation, no clock read, no CUDA
event, no read of the device. On, each span records its name, start and
end (``time.perf_counter_ns``), its own id, its parent's id and its
request: a span opened with no span open in its thread starts a new
request, so the spans of one solve share one request id. A layer's self
time is its span's duration less what its child spans cover; readers
compute it. Everything stays in memory until :func:`stop`.

The port's spans and counters, and who reads them:

- ``facade.enumerate``: the request's root (``enum/api.py``);
- ``facade.first_pass``, with the counters ``first_pass.iters`` (the C
  core's loop iterations, its budget's unit) and ``first_pass.nodes``
  (the nodes it counts per level, summed); the counter
  ``first_pass.skipped``, once per facade call that sends its search
  straight to the card without the first pass
  (``enum/device.py:skips_first_pass``);
- ``enum.roots`` > ``enum.roots.native``: root generation and the native
  expansion in it, with the counters ``enum.frontier.native`` and
  ``enum.frontier.python``, once per frontier the C core's expansion or
  the NumPy level loop built; ``enum.pack`` > ``enum.pack.h2d``: the sort
  and pad into the device's staging buffer, and the one copy to the
  device, with the counter ``enum.stage.grown``, once per (re)allocation
  of a staging buffer;
- ``kernels.run`` > ``kernels.stage`` (geometry, outputs, the launch
  call, up to the return of ``enum_launch``; on CPU tensors the plain
  version's whole run), ``kernels.wait`` (the read of the abort flag)
  and ``kernels.finalize`` (the top-K and the launch record);
- ``mesh.sweep``: one sweep of the sharded enumerator, with its shards'
  records in ``sweeps``.

Each card launch leaves a record in ``launches``: its form, walkers, the
walk counters (steps, root_steps, walk_steps, donations, barren_skips),
the nodes it counted, its device, the innermost span and the request
open when it was recorded, and the interval between two CUDA events
around the launch call placed on the host clock (``start_ns``,
``end_ns``) with ``kernel_ms``. The recorder puts one reference event on
each visible card at :func:`start` and waits for it; :func:`stop` waits
for every card once and places each launch's events from its card's
reference, so that host spans and kernel intervals share one clock.

No span is a ``torch.profiler.record_function`` range: the profiler
would show such a range on the card's timeline as well.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

__all__ = ["Span", "Snapshot", "start", "stop", "on", "span", "spanned",
           "count", "record_launch", "record_sweep"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]       # None: the request's root
    request: int


@dataclass
class Snapshot:
    """What one recording holds: closed spans in the order they closed,
    counters, card launch records and the mesh's sweeps (one list of
    shard records each)."""
    spans: List[Span] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    launches: List[dict] = field(default_factory=list)
    sweeps: List[List[dict]] = field(default_factory=list)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name) * 1e-9


class _Recorder:
    def __init__(self):
        self.snap = Snapshot(counts=Counter())
        self.ids = itertools.count()
        self.requests = itertools.count()
        self.local = threading.local()
        self.refs = _card_references()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_rec: Optional[_Recorder] = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "name", "id", "parent", "request", "t0")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        st = self.rec.stack()
        self.id = next(self.rec.ids)
        if st:
            self.parent, self.request = st[-1].id, st[-1].request
        else:
            self.parent, self.request = None, next(self.rec.requests)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rec.stack().pop()
        self.rec.snap.spans.append(Span(self.name, self.t0, t1, self.id,
                                        self.parent, self.request))
        return False


def span(name: str):
    """A context that records one span while the recorder is on."""
    rec = _rec
    return _OFF if rec is None else _Open(rec, name)


def spanned(name: str):
    """Decorator: every call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _rec
            if rec is None:
                return fn(*args, **kwargs)
            with _Open(rec, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def on() -> bool:
    return _rec is not None


def count(name: str, n: int = 1) -> None:
    rec = _rec
    if rec is not None:
        rec.snap.counts[name] += int(n)


def record_launch(rec: dict) -> Optional[dict]:
    """Add one card launch's record (its ``events`` (e0, e1) and its
    ``device`` index among the fields); returns it, tagged with the
    innermost open span and its request, or None when off."""
    r = _rec
    if r is None:
        return None
    st = r.stack()
    rec["span"] = st[-1].id if st else None
    rec["request"] = st[-1].request if st else None
    r.snap.launches.append(rec)
    return rec


def record_sweep(shards: List[dict]) -> None:
    """Add one mesh sweep's shard records; a record's ``launch`` (the
    record of its card launch) is resolved at :func:`stop` into the
    shard's ``device``, ``kernel_ms``, ``start_s`` and ``end_s``."""
    r = _rec
    if r is not None:
        r.snap.sweeps.append(shards)


def _card_references() -> dict:
    """Per visible card, an event recorded on its current stream and
    waited for, with the host clock just after: {index: (event, ns)}."""
    import torch
    refs = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            with torch.cuda.device(i):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ev.synchronize()
                refs[i] = (ev, time.perf_counter_ns())
    return refs


def start() -> None:
    """Turn the recorder on, with nothing recorded."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace: already recording")
    _rec = _Recorder()


def stop() -> Snapshot:
    """Turn the recorder off and return what it recorded, every launch
    placed on the host clock."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        raise RuntimeError("trace: not recording")
    snap = rec.snap
    snap.counts = dict(snap.counts)
    if rec.refs:
        import torch
        for i in rec.refs:
            torch.cuda.synchronize(i)
    for ln in snap.launches:
        e0, e1 = ln.pop("events")
        ref = rec.refs.get(ln["device"])
        ln["kernel_ms"] = e0.elapsed_time(e1)
        ln["start_ns"] = ln["end_ns"] = None
        if ref is not None:
            ev, t_ns = ref
            ln["start_ns"] = t_ns + round(ev.elapsed_time(e0) * 1e6)
            ln["end_ns"] = t_ns + round(ev.elapsed_time(e1) * 1e6)
    for sweep in snap.sweeps:
        for r in sweep:
            ln = r.pop("launch", None)
            if ln is not None:
                r.update(device=f"cuda:{ln['device']}",
                         kernel_ms=ln["kernel_ms"])
                if ln["start_ns"] is not None:
                    r.update(start_s=ln["start_ns"] * 1e-9,
                             end_s=ln["end_ns"] * 1e-9)
    return snap
