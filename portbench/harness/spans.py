"""Spans and counters around the calls into the port's layers, recorded
from the benchmark's side (the port itself records none yet).

:class:`Tracer` replaces, for the traced run only, the functions through
which one layer calls the next, and puts them back afterwards:

- entry: each request (``solve``), recorded by the harness;
- facade: ``native.native_enumerate``, the facade's first pass
  (``first_pass``), counted per call and as finished when it visited
  fewer nodes than its budget (the facade then launches nothing);
- enumerator: ``DeviceEnumerator._gen_roots`` and ``._pack``
  (``gen_roots``, ``pack``);
- kernel wrappers: ``enum.device.enum_run`` (``wrapper``), with the
  launch's per-level nodes, element size, real height and the roots
  inside its radius; CUDA events around ``kernels.enum_launch`` time
  the launch itself on the card.

Each span is (name, start, end, request) on the host clock and is also
a ``torch.profiler.record_function`` range named ``portbench.<name>``,
so that the profiler's timeline can say what the host did while the
card was idle.
"""

from __future__ import annotations

import inspect
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

__all__ = ["Tracer"]


class Tracer:
    def __init__(self, cuda_events: bool):
        self.cuda_events = cuda_events
        self.spans: Dict[str, List[Tuple[float, float, int]]] = \
            defaultdict(list)
        self.counts: Counter = Counter()
        self.launches: List[dict] = []
        self.request = -1
        self._undo: List[tuple] = []
        self._pending = None      # the events of the launch in flight

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench." + name):
            try:
                yield
            finally:
                self.spans[name].append((t0, time.perf_counter(),
                                         self.request))

    def _replace(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def install(self) -> None:
        from fplll_tpu_torch import native
        from fplll_tpu_torch.enum import device, kernels

        tr = self

        def spanned(name):
            def make(orig):
                def wrapped(*a, **k):
                    with tr.span(name):
                        return orig(*a, **k)
                return wrapped
            return make

        def first_pass(orig):
            def wrapped(*a, **k):
                with tr.span("first_pass"):
                    out = orig(*a, **k)
                budget = int(k.get("node_budget", 0))
                tr.counts["first_pass_calls"] += 1
                if out is not None and budget and int(out[5]) < budget:
                    tr.counts["first_pass_done"] += 1
                return out
            return wrapped

        def wrapper(orig):
            sig = inspect.signature(orig)

            def wrapped(*a, **k):
                with tr.span("wrapper"):
                    out = orig(*a, **k)
                arg = sig.bind(*a, **k).arguments
                a0 = float(arg["A0"])
                tr.launches.append({
                    "nodes": out["nodes"].cpu().tolist(),
                    "elem": arg["mut"].element_size(),
                    "m": int(arg["m"]),
                    "m_real": int(arg.get("m_real") or arg["m"]),
                    "nfix": int(arg["roots_x"].shape[-1]),
                    "roots_live": int((arg["roots_pd"] <= a0).sum()),
                    "dual": bool(arg.get("dual", False)),
                    "subsols": bool(arg.get("findsubsols", False)),
                    "slots": int(out["best_dist"].numel()),
                    "events": tr._pending})
                tr._pending = None
                return out
            return wrapped

        def launch(orig):
            def wrapped(*a, **k):
                dev = (a[0] if a else k["mut"]).device
                if not tr.cuda_events or dev.type != "cuda":
                    return orig(*a, **k)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = orig(*a, **k)
                e1.record()
                tr._pending = (e0, e1)
                return out
            return wrapped

        self._replace(native, "native_enumerate", first_pass)
        self._replace(device.DeviceEnumerator, "_gen_roots",
                      spanned("gen_roots"))
        self._replace(device.DeviceEnumerator, "_pack", spanned("pack"))
        self._replace(device, "enum_run", wrapper)
        self._replace(kernels, "enum_launch", launch)

    def remove(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def event_kernel_s(self) -> float | None:
        """Seconds between the CUDA events around every launch (the
        fallback for kernel time where the profiler shows none); None
        without events."""
        evs = [ln["events"] for ln in self.launches if ln["events"]]
        if not evs:
            return None
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in evs) / 1e3
