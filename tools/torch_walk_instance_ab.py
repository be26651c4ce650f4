#!/usr/bin/env python3
"""The dual and sub-solution instances of the enumeration kernel at
several launch bounds, beside the extended instance, on the card.

    python tools/torch_walk_instance_ab.py [--macros ENUM_SUBSOLS_F64_MIN_BLOCKS
        ENUM_SUBSOLS_F32_MIN_BLOCKS ENUM_DUAL_F32_MIN_BLOCKS]
        [--values 1 2 3] [--reps 3] [--rounds 2]

Builds fplll_tpu_torch/csrc/enum_chunk.cu once per value, with every
macro of `--macros` set to it (the source's ENUM_*_MIN_BLOCKS, the
resident blocks per SM an instance asks ptxas for; one nvcc per value,
all started together) and
prints per build the registers, stack frame and spills (`-Xptxas -v`) of
the dual, sub-solution and extended instances of both element types, and
their blocks per SM and walkers at M = 32, 64 and 128 (chip_smoke.py's
walk_instances). Then, per build in turns (the order reversed every
other round), times chip_smoke.py's phase-2 trees of the dual and
sub-solution forms (f32 and f64, d = 40, count mode) on the form's
instance and on the extended one (kernels._enum_run_extended): the
median of `reps` CUDA-event timings of the wrapper, each held against
the plain version's counts with chip_smoke.compare_counts, with the
longest work item's steps, the walkers, donations and barren-descend
skips. One JSON line per build and round, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (form, element type, dual, sub-solutions, seed): phase 2's trees
FORMS = (("f32-dual", "f32", True, False, 4),
         ("f64-dual", "f64", True, False, 4),
         ("f32-subsols", "f32", False, True, 3),
         ("f64-subsols", "f64", False, True, 3))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--macros", nargs="+", default=[
        "ENUM_SUBSOLS_F64_MIN_BLOCKS", "ENUM_SUBSOLS_F32_MIN_BLOCKS",
        "ENUM_DUAL_F32_MIN_BLOCKS"])
    ap.add_argument("--values", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_instance_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fplll_tpu_torch import cuda_build
    from fplll_tpu_torch.enum import kernels

    vals = args.values
    with ThreadPoolExecutor(len(vals)) as pool:
        built = list(pool.map(lambda v: cuda_build.build(
            "enum_chunk", tuple(f"{m}={v}" for m in args.macros)), vals))
    libs = {}
    for v, (lib, log) in zip(vals, built):
        libs[v] = kernels._LIB = kernels._bind(lib)
        inst = cs.ptxas_instances(log)
        print(json.dumps({
            "macros": args.macros, "value": v,
            "ptxas": {f"{'f64' if k[0] == 'double' else 'f32'}-{k[4]} "
                      f"M={k[1]}": r for k, r in sorted(inst.items())
                      if k[4] in cs.WALK_KERNELS},
            "geometry": cs.walk_geometries(cs.walk_instances())}),
            flush=True)

    trees = {}
    for form, dtype, dual, subsols, seed in FORMS:
        pack, _ = cs.ext_problem(40, seed, dtype, dual, "cuda")
        mr = pack["m_real"]
        kw = dict(is_svp=True, count_mode=True, batch=1024,
                  max_steps=1 << 30, dual=dual, findsubsols=subsols)
        plain = kernels.enum_run_plain(
            **{k: x for k, x in pack.items() if k != "m_real"}, **kw)
        trees[form] = (pack, mr, kw, plain)
    for rnd in range(args.rounds):
        for v in (vals if rnd % 2 == 0 else vals[::-1]):
            kernels._LIB = libs[v]
            rec = {"macros": args.macros, "value": v, "round": rnd}
            for form, (pack, mr, kw, plain) in trees.items():
                for name, run in ((cs.INSTANCE_OF[form], kernels.enum_run),
                                  ("extended", kernels._enum_run_extended)):
                    out, ms = cs.wrapper_ms(lambda: run(**pack, **kw),
                                            args.reps)
                    tag = f"{form} {name} d40 count"
                    cs.compare_counts(tag, out, plain, mr)
                    rec[tag] = {"ms": ms, "walkers": out["geometry"]["walkers"],
                                "root_steps": int(out["root_steps"]),
                                "donations": int(out["donations"]),
                                "barren_skips": int(out["barren_skips"])}
            print(json.dumps(rec), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
