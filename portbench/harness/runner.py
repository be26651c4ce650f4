"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line's content.

:func:`run_cell` takes the device it is given and looks for no card
itself (``run.py`` does, and refuses to run without one), so the tests
drive a whole run on the CPU at a small size, with the port's plain
versions in place of the kernel.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import profile
from .imports import forbidden_loaded
from .registry import entry, load_cell, metric_names, reader
from .spans import Tracer
from .traffic import requests
from .window import measure

__all__ = ["RunView", "run_cell"]


@dataclass
class RunView:
    """What the metric readers see of one run."""
    setup_s: float
    elapsed: float
    latencies: List[float]
    oks: List[bool]
    spans: Dict[str, list] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    launches: List[dict] = field(default_factory=list)
    launches_total: int = 0
    kernel_s: Optional[float] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None

    def span_s(self, name: str) -> float:
        return sum(b - a for a, b, _ in self.spans.get(name, ()))


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _sample(win, seed: int, k: int) -> list:
    """The solves whose answers are compared: the longest, and k - 1 more
    drawn from the seed among those that did not fail."""
    ok = [i for i, s in enumerate(win.solves) if s.ok]
    if not ok:
        return []
    longest = max(ok, key=lambda i: win.solves[i].latency)
    rest = [i for i in ok if i != longest]
    rng = random.Random(int(seed) * 2654435761 + 97)
    pick = rng.sample(rest, min(len(rest), k - 1)) if k > 1 else []
    return [longest] + sorted(pick)


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             root: str | None = None, marks: list | None = None) -> dict:
    """Run `name` once; returns the result line's dict. `root`: the folder
    of the cell's files (default: this benchmark's). `marks`: (label,
    time) of the caller's own steps since `t_start`, printed with the
    set-up's."""
    marks = list(marks or [])
    marks.append(("harness", time.perf_counter()))
    from fplll_tpu_torch.enum import kernels

    from ..reference import judge

    marks.append(("the port's import", time.perf_counter()))
    cell = load_cell(bench, name, root)
    marks.append(("cell and pool", time.perf_counter()))
    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    marks.append(("entry", time.perf_counter()))
    for row in cell.traffic["warmup"]:
        ent.solve(row)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    last = t_start
    parts = []
    for label, t in marks:
        parts.append(f"{label} {t - last:.3f}")
        last = t
    print(f"portbench: set-up {setup_s:.3f} s: " + ", ".join(parts),
          file=sys.stderr)

    tracer = Tracer(cuda_events=device == "cuda") if trace else None
    solve = ent.solve
    if tracer is not None:
        def solve(row, _solve=ent.solve):
            tracer.request += 1
            with tracer.span("solve"):
                return _solve(row)
    launches0 = sum(kernels.LAUNCHES.values())
    prof = None
    if tracer is not None:
        tracer.install()
        prof = profile.start()
    try:
        with torch.profiler.record_function("portbench.window"):
            win = measure(solve, requests(cell.table, cell.traffic, seed),
                          seconds)
            _sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if tracer is not None:
            tracer.remove()
    launches_total = sum(kernels.LAUNCHES.values()) - launches0
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    view = RunView(setup_s, win.elapsed, [s.latency for s in win.solves],
                   [s.ok for s in win.solves])
    breakdown = None
    dev_extra = {}
    if tracer is not None:
        view.spans, view.counts = dict(tracer.spans), dict(tracer.counts)
        view.launches, view.launches_total = tracer.launches, launches_total
        got = profile.read(prof)
        if got["device_events"] and got["kernel_s"] > 0:
            view.kernel_s, view.busy_s = got["kernel_s"], got["busy_s"]
            view.window_s = got["window_s"]
            breakdown = {"device_ops": got["device_ops"],
                         "idle_gaps": got["idle_gaps"]}
        elif device == "cuda":
            # the profiler shows no device time: the CUDA events around
            # each launch give the kernel time, and the card counts as
            # busy for that time only
            view.kernel_s = tracer.event_kernel_s()
            view.busy_s, view.window_s = view.kernel_s, win.elapsed
        else:
            view.window_s = win.elapsed
        print(f"portbench: profiler device events {got['device_events']}, "
              f"kernel s {got['kernel_s']}, launches {launches_total}",
              file=sys.stderr)
        dev_extra = {"busy_s": view.busy_s, "window_s": view.window_s}

    # the comparison runs once the window has closed and the peak is read,
    # with the program's state freed
    picked = _sample(win, seed, int(cell.spec["sample"]))
    answered = [(win.solves[i].row, win.solves[i].answer) for i in picked]
    del ent, solve, tracer, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge.load(cell.spec["judge"]).judge(
        cell.pool, cell.config, cell.table, answered, device=device)
    numbers["failed"] = float(sum(not s.ok for s in win.solves))
    ver = judge.verdict(numbers, cell.spec["limits"])
    print(f"portbench: compared {len(answered)} answers in "
          f"{time.perf_counter() - t_ref:.2f} s: "
          + ", ".join(f"{k} {v!r}" for k, v in numbers.items()),
          file=sys.stderr)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench[kind]}
    for m in metric_names(bench, name, kind):
        v = reader(m)(view)
        if v is not None:
            metrics[m] = {"value": float(v), "unit": units[m]}
    out = {"correct": ver["correct"], "attempted": len(win.solves),
           "failed": int(numbers["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": torch.cuda.get_device_name(0)
                      if device == "cuda" else "cpu",
                      "count": int(cell.workload["chips"]),
                      "memory_peak_bytes": int(mem), **dev_extra}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = ver["checks"]
    # last, once the judge and every reader have been imported and run
    leaked = forbidden_loaded()
    if leaked:
        raise RuntimeError("modules of JAX or the JAX package are loaded: "
                           + ", ".join(leaked))
    return out
