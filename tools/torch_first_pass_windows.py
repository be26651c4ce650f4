"""The facade on smaller BKZ-2.0 windows of the benchmark cell's lattices:
where the first pass's rule (``enum/device.py:skips_first_pass``) keeps
or skips the pass, and what each window costs on the device.

The windows are made as the cell's pool is (``portbench/make_data.py``:
the SVP Challenge's Goldstein-Mayer lattices of dimension 80 from fplll's
generator, LLL, then BKZ-2.0's ``svp_preprocessing`` of each window with
default.json's strategy for the block, radius min(0.99 r_kappa, 1.1 GH),
the pruning set fplll's ``get_pruning`` picks), at the blocks asked for
(40, 48 and 52 by default: 52 is where the trees cross the budget)
and fewer lattices and kappas. ``--gh-factor 0`` drops the GH bound,
as BKZ-2.0 without ``BKZ_GH_BND`` does: the radius is then 0.99 r_kappa.
Per window: the radius over the window's Gaussian heuristic, the tree
estimate the rule reads, the C core's whole tree (nodes, loop iterations
and milliseconds on the CPU, no budget) and the estimate's over-count of
it, the rule's decision at the card's default budget (where the port has
the rule), and on the device, for each of ``--ways``, the facade's wall
time through the fpylll veneer (median of ``--reps``) with what the
recorder saw: whether the first pass ran, finished, or was skipped, the
launches, and the milliseconds of the facade's, the first pass's, root
generation's, packing's and the wrapper's spans in that solve. The ways
are ``rule`` (the facade as it is), ``pass`` (the first pass kept
wherever it applies, as before the rule) and ``skip`` (straight to the
card wherever the pass applies); the last two replace the rule for the
run and need a port that has it.

    python tools/torch_first_pass_windows.py [--blocks 40 48 52] \\
        [--seeds 11 12] [--kappas 0 4 8 12] [--gh-factor 1.1] \\
        [--ways rule] [--reps 5] [--device cuda] [--windows <file.json>]

Prints one JSON line. Runs against the port next to it, so it times any
checkout it is copied into. With ``--windows``, the windows are read
from the file where it exists and written to it where it does not, so
that two checkouts time the same windows: the native cores are built
with ``-march=native``, and two builds made on different hosts reduce
some lattices to different bases, so two checkouts that carry different
builds make different windows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUDGET = 2_000_000      # the facade's default first-pass budget on a card


def windows(block: int, seeds, kappas):
    """(config, pool, table) of the windows of one block size, in the
    form of the cell's entry."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from portbench.make_data import challenge_windows

    strat = load_strategies_json("default.json")[block]
    sets = [{"gh_factor": p.gh_factor,
             "coefficients": [float(c) for c in p.coefficients]}
            for p in strat.pruning_parameters]
    cfg = {"generator": {"n": 80, "bits": 800}, "block_size": block,
           "seeds": list(seeds), "kappa": [0, max(kappas)], "delta": 0.99,
           "gh_factor": 1.1}
    arrays, _ = challenge_windows(cfg, sets)
    table = [{"lattice": int(lat), "kappa": int(k), "basis": int(b),
              "radius": float(r), "prune": int(p)}
             for lat, k, b, r, p in zip(*(arrays[f"win_{c}"] for c in (
                 "lattice", "kappa", "basis", "radius", "prune")))
             if int(k) in kappas]
    config = {"block_size": block, "pruning": {"sets": sets}}
    return config, {"bases": arrays["bases"]}, table


def window_r(bases, req, block):
    """The window's squared Gram-Schmidt norms, from the reference's
    float64 GSO of its basis."""
    import numpy as np

    from portbench.reference import gso as ref_gso

    _, r = ref_gso.gso(np.asarray(bases[req["basis"]], dtype=np.int64))
    return r[req["kappa"]:req["kappa"] + block]


@contextlib.contextmanager
def way(tdev, name):
    """The facade's choice of first pass for one way of timing it."""
    if name == "rule":
        yield
        return
    rule = tdev.skips_first_pass
    tdev.skips_first_pass = lambda *a, **k: name == "skip"
    try:
        yield
    finally:
        tdev.skips_first_pass = rule


def recorded(fn):
    from fplll_tpu_torch import trace
    trace.start()
    try:
        fn()
    finally:
        snap = trace.stop()
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[40, 48, 52])
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12])
    ap.add_argument("--kappas", type=int, nargs="+", default=[0, 4, 8, 12])
    ap.add_argument("--gh-factor", type=float, default=1.1)
    ap.add_argument("--ways", nargs="+", default=["rule"],
                    choices=["rule", "pass", "skip"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import math

    import numpy as np
    import torch

    from fplll_tpu_torch.enum import device as tdev
    from portbench.entries.fpylll_window import Entry
    from portbench.reference import gso as ref_gso

    os.environ["FPLLL_TORCH_DEVICE"] = "cpu"
    os.environ["FPLLL_TPU_HYBRID_NODES"] = str(1 << 62)
    rule = getattr(tdev, "skips_first_pass", None)
    out = {"device": args.device, "budget": BUDGET, "has_rule": bool(rule),
           "gh_factor": args.gh_factor, "ways": args.ways, "windows": []}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    saved = {}
    if args.windows and os.path.exists(args.windows):
        with open(args.windows) as f:
            saved = json.load(f)
    made = []
    for block in args.blocks:
        t0 = time.perf_counter()
        if str(block) in saved:
            config, bases, table = saved[str(block)]
            pool = {"bases": np.asarray(bases)}
        else:
            with contextlib.redirect_stdout(sys.stderr):
                config, pool, table = windows(block, args.seeds, args.kappas)
            saved[str(block)] = (config, pool["bases"].tolist(), table)
        ent = Entry(config, pool, table)
        out[f"make_s_b{block}"] = time.perf_counter() - t0
        for row, req in enumerate(table):
            prune = np.asarray(
                config["pruning"]["sets"][req["prune"]]["coefficients"])
            rw = window_r(pool["bases"], req, block)
            req["radius"] = ref_gso.window_radius(
                rw, 0.99, args.gh_factor or math.inf)
            gh = ref_gso.gh_radius(rw)
            est = tdev.gh_tree_estimate(rw, prune, req["radius"])
            t0 = time.perf_counter()
            snap = recorded(lambda: ent.solve(row))
            whole_ms = (time.perf_counter() - t0) * 1e3
            nodes = snap.counts["first_pass.nodes"]
            rec = {"block": block, "lattice": req["lattice"],
                   "kappa": req["kappa"],
                   "radius_over_gh": req["radius"] / gh,
                   "estimate": est, "whole_nodes": nodes,
                   "whole_iters": snap.counts["first_pass.iters"],
                   "whole_cpu_ms": whole_ms, "over_count": est / nodes}
            if rule is not None:
                rec["skips"] = rule(torch.device("cuda"), rw, prune,
                                    req["radius"], gh, BUDGET)
            out["windows"].append(rec)
            made.append((ent, row, rec))

    if args.windows and not os.path.exists(args.windows):
        with open(args.windows, "w") as f:
            json.dump(saved, f)
    os.environ["FPLLL_TORCH_DEVICE"] = args.device
    os.environ.pop("FPLLL_TPU_HYBRID_NODES")
    for ent, row, _ in made:
        ent.solve(row)          # builds and loads the kernels untimed
    for name in args.ways:
        with way(tdev, name):
            for ent, row, rec in made:
                snap = recorded(lambda: ent.solve(row))
                got = {"first_pass": len(snap.named("facade.first_pass")),
                       "skipped": snap.counts.get("first_pass.skipped", 0),
                       "launches": len(snap.named("kernels.run"))}
                got["finished"] = bool(got["first_pass"] and
                                       not got["launches"])
                got["span_ms"] = {n: snap.seconds(n) * 1e3 for n in (
                    "facade.enumerate", "facade.first_pass", "enum.roots",
                    "enum.pack", "kernels.run")}
                walls = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    ent.solve(row)
                    walls.append((time.perf_counter() - t0) * 1e3)
                got["wall_ms"] = statistics.median(walls)
                got["wall_ms_all"] = walls
                rec.setdefault("ways", {})[name] = got
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
