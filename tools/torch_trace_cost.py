"""What the port's recorder (fplll_tpu_torch.trace) costs, off and on.

    python tools/torch_trace_cost.py [--device cuda|cpu] [--reps 200] \
        [--block 40]

- ns per ``trace.span`` context and per call of a ``trace.spanned``
  function (of an empty body), off and on, each the median of 7 timings
  of 100,000;
- on a card, the two parts of a launch record: us per pair of timing
  CUDA events made and recorded, and us per read of the walk counters
  (one concatenation and one copy to the host of a launch's outputs),
  each the median of 7 timings of 1,000;
- on `device`, the milliseconds of one search of a pruned window (the
  first `block` levels, default 40) of a dim-80 q-ary basis through
  ``DeviceEnumerator.enumerate`` (root generation, packing, one launch
  and its finalize: seven spans, and on a card a launch record), off
  and on in turns, the median of `reps` each.

Prints one JSON line with the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def ns_per(fn, n: int = 100_000) -> float:
    times = []
    for _ in range(7):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        times.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(times)


def span_costs() -> dict:
    from fplll_tpu_torch import trace

    def ctx():
        with trace.span("x"):
            pass

    @trace.spanned("x")
    def dec():
        pass

    out = {}
    for state in ("off", "on"):
        if state == "on":
            trace.start()
        out[f"span_ns_{state}"] = ns_per(ctx)
        out[f"spanned_ns_{state}"] = ns_per(dec)
        if state == "on":
            trace.stop()
    return out


def record_costs() -> dict:
    import torch
    from fplll_tpu_torch.enum import kernels

    def events():
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        pair[1].record()

    out = {k: torch.zeros(1, dtype=torch.int64, device="cuda")
           for k in kernels._WALK_COUNTERS}
    out["nodes"] = torch.zeros((1, 64), dtype=torch.int64, device="cuda")

    def counters():
        torch.cat([out[k] for k in kernels._WALK_COUNTERS] +
                  [out["nodes"].view(-1)]).tolist()

    return {"event_pair_us": ns_per(events, 1000) * 1e-3,
            "counter_read_us": ns_per(counters, 1000) * 1e-3}


def window(device: str, block: int):
    """One search of a pruned window, as a function of no argument."""
    import numpy as np
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.enum.device import DeviceEnumerator
    from fplll_tpu_torch.enum.evaluator import FastEvaluator
    from fplll_tpu_torch.fpylll import LLL, GSO, IntegerMatrix
    from fplll_tpu_torch.nr.rng import RandGen
    RandGen.init_with_seed(5)
    A = IntegerMatrix.random(80, "qary", k=40, bits=30)
    LLL.reduction(A)
    M = GSO.Mat(A)
    M.update_gso()
    mut, rdiag, _ = M.export_mu_r(0, block)
    pruning = np.array(load_strategies_json("default.json")[block]
                       .pruning_parameters[-1].coefficients)
    enum = DeviceEnumerator(device=device)

    def search():
        return enum.enumerate(mut, rdiag, pruning, np.zeros(block),
                              1.01 * rdiag[0], True, FastEvaluator())
    return search


def search_costs(device: str, reps: int, block: int) -> dict:
    import torch
    from fplll_tpu_torch import trace
    search = window(device, block)
    search()
    ms = {"off": [], "on": []}
    spans = launches = 0
    for _ in range(reps):
        for state in ("off", "on"):
            if state == "on":
                trace.start()
            t0 = time.perf_counter()
            search()
            if device == "cuda":
                torch.cuda.synchronize()
            ms[state].append((time.perf_counter() - t0) * 1e3)
            if state == "on":
                snap = trace.stop()
                spans, launches = len(snap.spans), len(snap.launches)
    off, on = statistics.median(ms["off"]), statistics.median(ms["on"])
    return {"search_ms_off": off, "search_ms_on": on,
            "search_ms_on_minus_off": on - off,
            "spans_per_search": spans, "launch_records_per_search": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--block", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    out = {"device": args.device,
           "card": torch.cuda.get_device_name(0)
           if args.device == "cuda" else "cpu"}
    out.update(span_costs())
    if args.device == "cuda":
        out.update(record_costs())
    out.update(search_costs(args.device, args.reps, args.block))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
