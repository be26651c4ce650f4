"""The facade's first pass over every window of a benchmark cell, on the
CPU with no budget, so that it walks each whole tree: per window the C
core's loop iterations and the nodes it counts (the recorder's
``first_pass.iters`` and ``first_pass.nodes``), and how many windows a
first pass of a given budget finishes, counted two ways: exactly (the
whole tree's iterations under the budget) and from the nodes times an
iterations-per-node ratio (the benchmark's ``first_pass_iters_per_node``).

    python tools/torch_first_pass_trees.py [--cell <cell>] \\
        [--budget 2000000] [--ratio <iters per node>]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
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
    from fplll_tpu_torch import trace
    from portbench.harness.registry import entry, load_cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = load_cell(json.load(f), args.cell)
    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    iters, nodes = [], []
    t0 = time.perf_counter()
    for row in range(len(cell.table)):
        trace.start()
        try:
            ent.solve(row)
        finally:
            snap = trace.stop()
        if len(snap.named("kernels.run")):
            raise RuntimeError(f"window {row} left the first pass")
        iters.append(snap.counts["first_pass.iters"])
        nodes.append(snap.counts["first_pass.nodes"])
    ratio = [i / n for i, n in zip(iters, nodes)]
    out = {"cell": args.cell, "windows": len(iters),
           "seconds": time.perf_counter() - t0, "budget": args.budget,
           "iters_per_node": sum(iters) / sum(nodes),
           "iters_per_node_min": min(ratio), "iters_per_node_max": max(ratio),
           "nodes_median": statistics.median(nodes),
           "nodes_min": min(nodes), "nodes_max": max(nodes),
           "nodes_under_budget": sum(n < args.budget for n in nodes),
           "finish_exactly": sum(i < args.budget for i in iters)}
    if args.ratio:
        out["ratio"] = args.ratio
        out["finish_by_ratio"] = sum(n * args.ratio < args.budget
                                     for n in nodes)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
