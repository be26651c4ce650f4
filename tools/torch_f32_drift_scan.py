#!/usr/bin/env python3
"""The f32 tree's distance drift on windows of the family HKZ reduces.

    FPLLL_TORCH_DEVICE=cpu python tools/torch_f32_drift_scan.py --dims 36
        [--seeds 1 2 3] [--starts 0 2 4] [--batch 64] [--root-factor 1]

For each BKZ-20-reduced gen_intrel(d, 10 d) basis (chip_smoke.py's
`intrel_basis`) and each window [k, d), runs one unpruned SVP search of
the window at HKZ's radius (r_kk) through the port's f32 walk
(DeviceEnumerator in float32 on CPU tensors, the kernel's plain version)
and the native C core in f64, and prints one JSON line per window: the
f32 walk's height (m_real, set by the root split: `--batch` lanes times
`--root-factor` roots), its answer's drift (reported distance over the
answer's norm from the window's f64 GSO, less one, as chip_smoke.py's
WindowAnswers.drift computes it), and whether the C core found a
shorter vector (a lost vector: the f32 walk ranked or pruned it away).
The default root split (1024 lanes, factor 32) leaves only the bottom of
the tree to the f32 walk; 64 lanes at factor 1 give it 34-36 levels of a
d = 40 window, where the drift passes the 1e-5 slack. Slow: a
64-lane search of a d = 40 window takes minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="+", default=[36])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--starts", type=int, nargs="+", default=[0, 2, 4])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--root-factor", type=int, default=1)
    args = ap.parse_args()
    os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from chip_smoke import gso_of, intrel_basis, partial_dist
    from fplll_tpu_torch.enum.device import DeviceEnumerator
    from fplll_tpu_torch.enum.evaluator import FastEvaluator
    from fplll_tpu_torch.native import native_enumerate

    for d in args.dims:
        for seed in args.seeds:
            mut_all, rdiag_all, _ = gso_of(intrel_basis(d, seed))
            for k in args.starts:
                mut = np.ascontiguousarray(mut_all[k:, k:])
                rdiag = rdiag_all[k:].copy()
                A = float(rdiag[0]) * 1.00001
                ev = FastEvaluator()
                enum = DeviceEnumerator(batch=args.batch, device="cpu",
                                        target_root_factor=args.root_factor,
                                        dtype=torch.float32)
                t0 = time.perf_counter()
                enum.enumerate(mut, rdiag, None, np.zeros(d - k), A, True,
                               ev)
                secs = time.perf_counter() - t0
                dist, x = ev.begin()
                norm = partial_dist(np.asarray(x, dtype=np.float64), mut,
                                    rdiag, 0)
                ref = native_enumerate(mut, rdiag, None, None, A, True,
                                       False, False)
                print(json.dumps({
                    "d": d, "seed": seed, "window": [k, d],
                    "m_real": enum._last_m_real, "drift": dist / norm - 1,
                    "lost": bool(norm > ref[1] * (1 + 1e-12)),
                    "norm_over_c_core": norm / ref[1] - 1,
                    "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
