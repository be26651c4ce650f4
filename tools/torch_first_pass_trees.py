"""The facade's first pass over every window of a benchmark cell, on the
CPU with no budget, so that it walks each whole tree: per window the C
core's loop iterations and the nodes it counts (the recorder's
``first_pass.iters`` and ``first_pass.nodes``), and how many windows a
first pass of a given budget finishes, counted two ways: exactly (the
whole tree's iterations under the budget) and from the nodes times an
iterations-per-node ratio (the benchmark's ``first_pass_iters_per_node``).

Per window it also gives what the facade's rule on a card
(``enum/device.py:skips_first_pass``) reads and decides at that budget:
the Gaussian-heuristic tree estimate, its over-count of the whole tree
(estimate over the C core's nodes), the radius over the window's squared
Gaussian heuristic, and whether the window would skip the first pass;
and, over the windows, the over-count's range and log-correlation and
how many windows that the budget finishes the rule would send to the
card all the same.

    python tools/torch_first_pass_trees.py [--cell <cell>] \\
        [--budget 2000000] [--ratio <iters per node>]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="svpchal80-bkz2.b60-windows")
    ap.add_argument("--budget", type=int, default=2_000_000)
    ap.add_argument("--ratio", type=float, default=None)
    args = ap.parse_args(argv)
    os.environ["FPLLL_TORCH_DEVICE"] = "cpu"
    os.environ["FPLLL_TPU_HYBRID_NODES"] = str(1 << 62)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from fplll_tpu_torch import trace
    from fplll_tpu_torch.enum import device as tdev
    from portbench.harness.registry import entry, load_cell
    from portbench.reference import gso as ref_gso

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = load_cell(json.load(f), args.cell)
    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    block = int(cell.config["block_size"])
    sets = cell.config["pruning"]["sets"]
    gsos = {}
    iters, nodes, windows = [], [], []
    t0 = time.perf_counter()
    for row, req in enumerate(cell.table):
        trace.start()
        try:
            ent.solve(row)
        finally:
            snap = trace.stop()
        if len(snap.named("kernels.run")):
            raise RuntimeError(f"window {row} left the first pass")
        it = snap.counts["first_pass.iters"]
        nd = snap.counts["first_pass.nodes"]
        iters.append(it)
        nodes.append(nd)
        # the rule's inputs, from the reference's float64 GSO of the
        # window (the estimate and the radius over the GH do not depend
        # on the facade's scaling of both)
        b, k = int(req["basis"]), int(req["kappa"])
        if b not in gsos:
            gsos[b] = ref_gso.gso(np.asarray(cell.pool["bases"][b],
                                             dtype=np.int64))[1]
        rdiag = gsos[b][k:k + block]
        prune = np.asarray(sets[int(req["prune"])]["coefficients"])
        radius, gh2 = float(req["radius"]), tdev.gh_squared(rdiag)
        est = tdev.gh_tree_estimate(rdiag, prune, radius)
        windows.append({
            "row": row, "iters": it, "nodes": nd, "estimate": est,
            "radius_over_gh": radius / gh2, "over_count": est / nd,
            "skips": tdev.skips_first_pass(torch.device("cuda"), rdiag,
                                           prune, radius, gh2, args.budget)})
    ratio = [i / n for i, n in zip(iters, nodes)]
    over = [w["over_count"] for w in windows]
    out = {"cell": args.cell, "windows": len(iters),
           "seconds": time.perf_counter() - t0, "budget": args.budget,
           "iters_per_node": sum(iters) / sum(nodes),
           "iters_per_node_min": min(ratio), "iters_per_node_max": max(ratio),
           "nodes_median": statistics.median(nodes),
           "nodes_min": min(nodes), "nodes_max": max(nodes),
           "nodes_under_budget": sum(n < args.budget for n in nodes),
           "finish_exactly": sum(i < args.budget for i in iters),
           "over_count_min": min(over),
           "over_count_median": statistics.median(over),
           "over_count_max": max(over),
           "log_correlation": statistics.correlation(
               [math.log(w["estimate"]) for w in windows],
               [math.log(n) for n in nodes]),
           "estimate_min": min(w["estimate"] for w in windows),
           "radius_over_gh_max": max(w["radius_over_gh"] for w in windows),
           "skipped": sum(w["skips"] for w in windows),
           "finished_yet_skipped": [w["row"] for w in windows
                                    if w["skips"] and
                                    w["iters"] < args.budget],
           "per_window": windows}
    if args.ratio:
        out["ratio"] = args.ratio
        out["finish_by_ratio"] = sum(n * args.ratio < args.budget
                                     for n in nodes)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
