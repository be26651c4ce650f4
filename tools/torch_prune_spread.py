#!/usr/bin/env python3
"""How far `fplll -a pru` of the PyTorch port moves when its analytic
gradient moves by a few ulps.

    FPLLL_TORCH_DEVICE=cpu python tools/torch_prune_spread.py [--end 60]
        [--seeds 1 2 3] [--eps 1e-15]

Runs `fplll -a pru -pruend <end>` (the port's CLI, in process) on the
BKZ-20-reduced gen_intrel(60, 600) basis of chip_smoke.py phase 6, once
with the gradient as computed and once per seed with each of its
coordinates multiplied by 1 + eps * N(0, 1), and prints one JSON line:
each run's repeated-enumeration cost and expectation. The pruner's
descent and Nelder-Mead are chaotic in the coefficients, so this spread
says how closely two correct gradient implementations that differ in
their last bits (the card's kernel and the plain version on CPU tensors,
or two releases of torch) can be expected to agree on the prune.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def intrel_basis(d: int, seed: int):
    """gen_intrel(d, 10 d), LLL- then BKZ-20-reduced on the host."""
    from fplll_tpu_torch.algs.bkz import bkz_reduction
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_intrel

    RandGen.init_with_seed(seed)
    b = gen_intrel(d, 10 * d)
    lll_reduction(b)
    bkz_reduction(b, 20, device="cpu")
    return b


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--end", type=int, default=60)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--eps", type=float, default=1e-15)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import contextlib
    import io

    import numpy as np
    import torch
    from fplll_tpu_torch.cli import main as cli
    from fplll_tpu_torch.ops.intmat import format_matrix
    from fplll_tpu_torch.pruner import pruner as pruner_mod
    from fplll_tpu_torch.pruner import torchgrad

    text = format_matrix(intrel_basis(60, 5))
    results = []
    orig_prune = pruner_mod.prune

    def prune(*a, **k):
        res = orig_prune(*a, **k)
        p = pruner_mod.Pruner(*a[:6])
        results.append((p.repeated_enum_cost(res.coefficients),
                        res.expectation))
        return res

    pruner_mod.prune = prune
    exact = torchgrad.log_target_and_grad

    def perturbed(seed):
        rng = np.random.default_rng(seed)

        def log_target_and_grad(inp, d, *consts):
            r = exact(inp, d, *consts).clone()
            r[1:] *= torch.from_numpy(
                1.0 + args.eps * rng.standard_normal(d)).to(r.device)
            return r
        return log_target_and_grad

    runs = {}
    for name, fn in [("as computed", exact)] + [
            (f"seed {s}", perturbed(s)) for s in args.seeds]:
        torchgrad.log_target_and_grad = fn
        sys.stdin = io.StringIO(text)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-a", "pru", "-pruend", str(args.end)])
        assert rc == 0
        cost, expectation = results[-1]
        runs[name] = {"repeated_cost": cost, "expectation": expectation,
                      "wall_s": time.perf_counter() - t0}
    torchgrad.log_target_and_grad = exact
    base = runs["as computed"]["repeated_cost"]
    print(json.dumps({
        "case": f"fplll -a pru -pruend {args.end}, gradient x (1 + "
                f"{args.eps} N(0, 1)) per coordinate",
        "device": os.environ.get("FPLLL_TORCH_DEVICE", "cuda"),
        "torch": torch.__version__, "runs": runs,
        "cost_rel_spread": [min(r["repeated_cost"] for r in runs.values())
                            / base - 1.0,
                            max(r["repeated_cost"] for r in runs.values())
                            / base - 1.0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
