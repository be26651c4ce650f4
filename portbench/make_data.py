"""Make the input pools under portbench/data/ (run once; the pools are
committed with their provenance).

    python3 portbench/make_data.py svpchal80-bkz2

Each pool is an .npz of integer bases with the request table its traffic
draws from, made from fixed seeds by the port on the CPU
(FPLLL_TORCH_DEVICE=cpu; the crossover is raised so that every
enumeration stays in the host's C core), and a JSON file of the same
name with the provenance: generator, seeds, preprocessing, the commit
of the port that made it and the digest of each array. The squared
radius and the pruning set of each window are worked out by the
reference (reference/gso.py), not by the port, so the port and the
reference receive the same request.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from portbench.harness.pool import digest  # noqa: E402
from portbench.reference import gso as ref_gso  # noqa: E402


def _port_commit() -> str:
    try:
        return subprocess.run(["git", "-C", ROOT, "rev-parse", "HEAD"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _rows(b) -> np.ndarray:
    return np.array([[int(b.a[i, j]) for j in range(b.ncols)]
                     for i in range(b.nrows)], dtype=np.int64)


def challenge_windows(cfg: dict, sets: list) -> tuple:
    """For each seed a Goldstein-Mayer lattice of the SVP Challenge's form
    (fplll `latticegen -randseed s q n 1 bits p`: det a prime of `bits`
    bits), LLL-reduced; then for each kappa, on a copy of that basis,
    BKZ-2.0's `svp_preprocessing` of the window [kappa, kappa + block)
    (LLL of the rows up to kappa + block, then one tour per preprocessing
    block size of the block's strategy), after which the window is cut
    as `svp_reduction` enumerates it: the squared radius min(delta
    r_kappa, gh_factor GH) and the pruning set whose gh_factor lies
    closest to r_kappa / min(r_kappa, GH) (fplll's get_pruning)."""
    from fplll_tpu_torch.algs.bkz import BKZReduction
    from fplll_tpu_torch.algs.bkz_param import BKZParam, load_strategies_json
    from fplll_tpu_torch.algs.lll import LLLReduction
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import (BKZ_GH_BND, GSO_ROW_EXPO, LLL_DEF_DELTA,
                                      LLL_DEF_ETA, LLL_DEFAULT)
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_qary_prime

    gen = cfg["generator"]
    beta = cfg["block_size"]
    par = BKZParam(beta, load_strategies_json("default.json"),
                   flags=BKZ_GH_BND)
    factors = np.asarray([s["gh_factor"] for s in sets])
    bases, rows_out = [], []
    for li, s in enumerate(cfg["seeds"]):
        t0 = time.time()
        RandGen.init_with_seed(s)
        lat = gen_qary_prime(gen["n"], 1, gen["bits"])
        lll_reduction(lat)
        for kappa in range(cfg["kappa"][0], cfg["kappa"][1] + 1):
            b = lat.copy()
            m = MatGSO(b, None, None, flags=GSO_ROW_EXPO, device="cpu")
            bkz = BKZReduction(m, LLLReduction(m, LLL_DEF_DELTA, LLL_DEF_ETA,
                                               LLL_DEFAULT), par,
                               device="cpu")
            bkz.svp_preprocessing(kappa, beta, par)
            rows = _rows(b)
            mu, r = ref_gso.gso(rows)
            _, rw = ref_gso.window(mu, r, kappa, kappa + beta)
            ratio = float(rw[0]) / min(float(rw[0]), ref_gso.gh_radius(rw))
            rows_out.append((li, kappa, len(bases),
                             ref_gso.window_radius(rw, cfg["delta"],
                                                   cfg["gh_factor"]),
                             int(np.argmin(np.abs(factors - ratio)))))
            bases.append(rows)
        print(f"seed {s}: {time.time() - t0:.1f} s", flush=True)
    stack = np.stack(bases)
    if np.abs(stack).max() >= 2 ** 31:
        raise ValueError("basis entries do not fit int32")
    arrays = {
        "bases": stack.astype(np.int32),
        "seeds": np.asarray(cfg["seeds"], dtype=np.int64),
        "win_lattice": np.asarray([w[0] for w in rows_out], dtype=np.int64),
        "win_kappa": np.asarray([w[1] for w in rows_out], dtype=np.int64),
        "win_basis": np.asarray([w[2] for w in rows_out], dtype=np.int64),
        "win_radius": np.asarray([w[3] for w in rows_out], dtype=np.float64),
        "win_prune": np.asarray([w[4] for w in rows_out], dtype=np.int64),
    }
    return arrays, {
        "generator": f"gen_qary_prime({gen['n']}, 1, {gen['bits']}) per "
                     "seed (fplll latticegen q n 1 bits p): the SVP "
                     "Challenge's Goldstein-Mayer form",
        "preprocessing": "LLL (0.99, 0.51) of the lattice; then per window, "
                         "on a copy, BKZReduction.svp_preprocessing(kappa, "
                         f"{beta}) with default.json (block {beta}: one "
                         "tour per preprocessing block size "
                         f"{list(par.strategies[beta].preprocessing_block_sizes)})",
        "requests": "one row per window: lattice, kappa, basis (its own "
                    "preprocessed basis in `bases`), squared radius "
                    "min(delta r_kappa, gh_factor GH) and pruning set "
                    "(closest gh_factor to r_kappa / min(r_kappa, GH)), "
                    "both from the reference's GSO"}


MAKERS = {"challenge_windows": challenge_windows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    args = ap.parse_args(argv)
    os.environ["FPLLL_TORCH_DEVICE"] = "cpu"
    os.environ["FPLLL_TPU_HYBRID_NODES"] = str(1 << 62)
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        cfg = json.load(f)
    pool = cfg["pool"]
    arrays, prov = MAKERS[pool["maker"]](pool, cfg["pruning"]["sets"])
    prov = write_pool(HERE, args.config, pool, arrays, prov)
    print(json.dumps(prov["digests"]))
    return 0


def write_pool(root: str, config: str, pool: dict, arrays: dict,
               prov: dict) -> dict:
    """Write data/<pool file> and its provenance beside it."""
    out = os.path.join(root, "data", pool["file"])
    np.savez_compressed(out, **arrays)
    prov = dict(prov, config=config, seeds=pool["seeds"],
                made_by="portbench/make_data.py", port_commit=_port_commit(),
                digests={k: digest(v) for k, v in arrays.items()})
    with open(out[:-len(".npz")] + ".json", "w") as f:
        json.dump(prov, f, indent=1)
        f.write("\n")
    return prov


if __name__ == "__main__":
    sys.exit(main())
