#!/usr/bin/env python3
"""The f64 primal instance of the enumeration kernel at several launch
bounds, beside the extended instance, on the card.

    python tools/torch_f64_instance_ab.py [--min-blocks 2 3 1] [--reps 3]
        [--rounds 2]

Builds fplll_tpu_torch/csrc/enum_chunk.cu once per value of
ENUM_F64_MIN_BLOCKS (the resident blocks per SM the f64 primal instance
asks ptxas for at M <= 64; one nvcc per value, all started together) and
prints per build both f64 instances' registers, stack frame and spills
(`-Xptxas -v`) and their blocks per SM and walkers at M = 32, 64 and 128.
Then, per build in turns (the order reversed every other round), times
chip_smoke.py's f64 trees on the f64 primal instance and on the extended
one (kernels._enum_run_extended, the same in every build): phase 2's
d = 40 tree in count and search mode (median of `reps` CUDA-event
timings of the wrapper; count mode held against the plain version's
counts with chip_smoke.compare_counts, searches against its best
distance), with the longest work item's steps, the walkers, donations
and barren-descend skips; and phase 5's proved SVP at d = 56 through
shortest_vector (the kernel ms of its f64 launches, CUDA events,
chip_smoke.OnInstance). One JSON line per build and round, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[2, 3, 1])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_f64_instance_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fplll_tpu_torch import cuda_build
    from fplll_tpu_torch.algs.svpcvp import shortest_vector
    from fplll_tpu_torch.enum import kernels

    mbs = args.min_blocks
    with ThreadPoolExecutor(len(mbs)) as pool:
        built = list(pool.map(lambda mb: cuda_build.build(
            "enum_chunk", (f"ENUM_F64_MIN_BLOCKS={mb}",)), mbs))
    libs = {}
    for mb, (lib, log) in zip(mbs, built):
        libs[mb] = kernels._LIB = kernels._bind(lib)
        inst = cs.ptxas_instances(log)
        print(json.dumps({
            "min_blocks": mb,
            "ptxas": {f"{'f64 primal' if k[4] == 'primal' else k[4]} "
                      f"M={k[1]}": v for k, v in sorted(inst.items())
                      if k[0] == "double" and k[4] in ("primal",
                                                       "extended")},
            "geometry": cs.f64_geometries()}), flush=True)

    pack, _ = cs.ext_problem(40, 3, "f64", False, "cuda")
    mr = pack["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    plain = {cm: kernels.enum_run_plain(
        **plain_args, is_svp=True, count_mode=cm, batch=1024,
        max_steps=1 << 30) for cm in (True, False)}
    b = cs.intrel_basis(cs.SVP_DIM, cs.SVP_SEED)
    for rnd in range(args.rounds):
        for mb in (mbs if rnd % 2 == 0 else mbs[::-1]):
            kernels._LIB = libs[mb]
            rec = {"min_blocks": mb, "round": rnd}
            for name, run in (("f64 primal", kernels.enum_run),
                              ("extended", kernels._enum_run_extended)):
                for cm in (True, False):
                    kw = dict(is_svp=True, count_mode=cm, batch=1024,
                              max_steps=1 << 30)
                    out, ms = cs.wrapper_ms(lambda: run(**pack, **kw),
                                            args.reps)
                    mode = "count" if cm else "search"
                    tag = f"{name} d40 {mode}"
                    if cm:
                        cs.compare_counts(tag, out, plain[cm], mr)
                    pb = float(plain[cm]["best_dist"][0])
                    assert abs(float(out["best_dist"][0]) - pb) <= \
                        cs.EXT_RTOL["f64"] * pb, tag
                    rec[tag] = {"ms": ms, "walkers": out["geometry"]["walkers"],
                                "root_steps": int(out["root_steps"]),
                                "donations": int(out["donations"]),
                                "barren_skips": int(out["barren_skips"])}
            both = cs.on_both_instances(
                lambda: shortest_vector(b.copy(), device="cuda"),
                turns=(False, True))
            norms = {sum(v * v for v in cs.lattice_point(b, x))
                     for _, x in both.pop("results")}
            assert len(norms) == 1 and math.isfinite(norms.pop())
            rec["proved svp d56"] = both
            print(json.dumps(rec), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
