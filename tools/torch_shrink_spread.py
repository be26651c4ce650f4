#!/usr/bin/env python3
"""The enumeration kernel's search overhead on chip_smoke.py's
shrinking-bound check, launch after launch, on the card.

    python tools/torch_shrink_spread.py [--launches 300] [--rounds 3]
        [--against OTHER.cu ...]

Builds fplll_tpu_torch/csrc/enum_chunk.cu and each --against source
(another version of the same file, e.g. one written out by `git show
<commit>:fplll_tpu_torch/csrc/enum_chunk.cu`) and launches them in turns
(the order reversed every other round). Per source it prints one JSON
line: on the shrink check's window (chip_smoke.SHRINK_CASE) the search
overhead, search-mode nodes over count-mode nodes at the final bound,
as min / median / 90th percentile / max over the launches, how many
launches lie above chip_smoke.SHRINK_TOL, and the wrapper's median ms
(CUDA events); the same, over fewer launches, on the lattices of
chip_smoke.SHRINK_SPREAD_SEEDS given by --seeds; the grouped block-60
window's wrapper ms at GROUPED_RADIUS and GROUPED_TIMED_RADIUS; and
ptxas's registers, stack and spills of every instance. The ratio varies
from launch to launch because the walkers re-read the falling bound
asynchronously and idle walkers take donated ranges as they come free.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(src: str, name: str):
    """Build `src` as its own library and bind it as kernels.build_kernel
    binds the package's."""
    from fplll_tpu_torch import cuda_build
    from fplll_tpu_torch.enum import kernels

    lib, log = cuda_build.build(name, src=src)
    return kernels._bind(lib), log


def timed(fn):
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def summary(ratios, ms, tol) -> dict:
    r = sorted(ratios)
    return {"launches": len(r), "min": r[0], "median": statistics.median(r),
            "p90": r[int(0.9 * len(r))], "max": r[-1],
            "above_tol": sum(v > tol for v in r),
            "wrapper_ms_median": statistics.median(ms)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="*", default=[7, 12])
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from fplll_tpu_torch.enum import kernels

    dev = torch.device("cuda")
    srcs = {"this": os.path.join(ROOT, "fplll_tpu_torch", "csrc",
                                 "enum_chunk.cu")}
    srcs.update({f"against{i}": os.path.abspath(p)
                 for i, p in enumerate(args.against)})
    libs = {k: load(p, f"enum_chunk_spread_{k}") for k, p in srcs.items()}
    kw = dict(is_svp=True, batch=1024, max_steps=1 << 30)
    _, d, seed, radius = cs.SHRINK_CASE
    windows = {}
    for s in [seed, *args.seeds]:
        _, mut, rdiag, prune, A, _ = cs.uniform_window(d, s, False, radius)
        windows[s] = cs.packed_problem(mut, rdiag, prune, A, dev)
    gp = cs.grouped_window_problem(dev, 80, 60, cs.GROUPED_RADIUS)
    grouped = {cs.GROUPED_RADIUS: gp["tensors"],
               cs.GROUPED_TIMED_RADIUS: gp["pack"](cs.GROUPED_TIMED_RADIUS)[0]}
    gkw = dict(G_real=len(gp["m_reals"]), batch=1024, is_svp=True,
               max_steps=1 << 30)
    # the final bound and its count, from this tree's kernel
    kernels._LIB = libs["this"][0]
    finals = {}
    for s, pack in windows.items():
        mr = pack["m_real"]
        best = float(kernels.enum_run(**pack, count_mode=False,
                                      **kw)["best_dist"][0])
        nodes = kernels.enum_run(**dict(pack, A0=best * 1.00001),
                                 count_mode=True, **kw)["nodes"]
        finals[s] = (best, float(nodes[:mr].sum()))
    runs = {k: {} for k in srcs}
    for rnd in range(args.rounds):
        order = list(srcs) if rnd % 2 == 0 else list(srcs)[::-1]
        for k in order:
            kernels._LIB = libs[k][0]
            for s, pack in windows.items():
                best, n_final = finals[s]
                mr = pack["m_real"]
                n = args.launches if s == seed else max(
                    1, args.launches // 10)
                for _ in range(-(-n // args.rounds)):
                    out, ms = timed(lambda: kernels.enum_run(
                        **pack, count_mode=False, **kw))
                    assert abs(float(out["best_dist"][0]) - best) <= \
                        1e-6 * best, (k, s)
                    rec = runs[k].setdefault(f"seed{s}", ([], []))
                    rec[0].append(float(out["nodes"][:mr].sum()) / n_final)
                    rec[1].append(ms)
            for r, t in grouped.items():
                for _ in range(10):
                    _, ms = timed(lambda: kernels.enum_run_grouped(**t, **gkw))
                    runs[k].setdefault(f"grouped{r}", []).append(ms)
    kernels._LIB = None
    for k, p in srcs.items():
        line = {"source": p, "shrink_case": cs.SHRINK_CASE[0],
                "shrink_tol": cs.SHRINK_TOL}
        for key, v in runs[k].items():
            line[key] = summary(*v, cs.SHRINK_TOL) if key.startswith(
                "seed") else {"launches": len(v),
                              "wrapper_ms_median": statistics.median(v)}
        line["ptxas"] = {"/".join(map(str, i)): v for i, v in
                         cs.ptxas_instances(libs[k][1]).items()}
        print(json.dumps(line), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
