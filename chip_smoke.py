#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernel.

    python3 chip_smoke.py              # every phase; needs one CUDA card

Phases (each one fails the run if it fails):
  1. report the card, build the CUDA kernel (every template instance,
     `-Xptxas -v` printed, no spills) and the native C cores;
  2. the kernel against its plain PyTorch version on the card, for each
     launch form (root queue, with the plain version at 1024 and 16384
     lanes, a single root with nfix = 0) in count and search mode, a
     search whose bound shrinks several times, and the grouped form as a
     block-60 tour launches it (three rerandomized trials of one window,
     padded to G = 4, m = 64); the same count at the persistent grid and
     at a grid of one block; the shrinking-bound search's overhead over
     several lattices;
  3. the main path: BKZ-2.0 with the shipped strategies on a dim-80 q-ary
     basis after a 40 -> 50 warm-up, one block-60 tour with the device
     crossover at FPLLL_TPU_HYBRID_NODES=2000000 (every launch on the
     persistent grid, blocks per SM times SMs), then the same tour on the
     host C core alone;
  4. one block-60 window through DeviceEnumerator and the native C core,
     each answer certified by the other implementation.

The line before the last is one JSON object with the kernel's numbers;
the last line is {"ok": true, "device": {...}}. Imports only torch, numpy
and the port (fplll_tpu_torch); builds everything from the checkout.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_F32_FLOPS = 67e12       # non-tensor f32 peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12     # HBM3 rate, H100 SXM data sheet
CROSSOVER = 2_000_000        # estimated nodes; windows above it go to the card
# recorded times of the kernel before the walker redesign, one thread
# per lane (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6): printed
# for comparison on a line of their own, never as this run's measurements
LANE_KERNEL_RECORDED_MS = {"queue d56 count": 108.47,
                           "grouped G=3 (G=4) d60 search": 57.91}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 2 helpers: windows, packing, comparisons
# ---------------------------------------------------------------------------
def uniform_window(d: int, seed: int, pruned: bool, radius: float = 1.0):
    """An LLL-reduced gen_uniform basis, its normalized (mu^T, r) and the
    squared radius `radius` * min ||b_i||^2 (the recipe of
    tests/test_pallas_parity.py), with a mild linear pruning taper when
    `pruned`."""
    import numpy as np
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops import gen

    RandGen.init_with_seed(seed)
    b = gen.gen_uniform(d, 12)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso.update_gso()
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.00001 * \
        radius
    prune = np.ones(d)
    if pruned:
        for i in range(d // 2, d):
            prune[d - 1 - i] = max((d - i) / float(d), 0.6)
    return b, np.asarray(mut), np.asarray(rdiag), prune, \
        math.ldexp(A0, -normexp), normexp


def packed_problem(mut, rdiag, prune, A, device, nfix0=False):
    """Roots and padded tensors exactly as DeviceEnumerator builds them for
    a BKZ window (root factor 16, m/nfix/R pinned to the window path's
    buckets); nfix0 puts the whole tree under one root instead."""
    import numpy as np
    from fplll_tpu_torch.enum.device import DeviceEnumerator

    d = len(rdiag)
    enum = DeviceEnumerator(batch=1024, target_root_factor=16, device=device)
    enum.nodes = np.zeros(d, dtype=np.int64)
    if nfix0:
        rx, rpd, m_real = np.zeros((1, 0)), np.zeros(1), d
    else:
        enum.pin_m = 64      # the height of the main path's block-60 windows
        enum.pin_nfix, enum.pin_R = 16, 32768
        rx, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d),
                                          A, d, True)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real)
    pack["A0"] = A * enum.bound_slack
    return pack


def op_count(nodes) -> float:
    """f32 operations the walk needs for these per-level node counts: per
    counted node at level k, the bound test and zig-zag step (about 20)
    plus the descend/restore update of the k center sums below it (4k)."""
    return float(sum(int(n) * (4 * k + 20) for k, n in enumerate(nodes)))


def bound_ms(pack, nodes, slots: int) -> tuple:
    """Least time for the work: max(bytes / HBM rate, ops / f32 rate).
    Bytes: each input tensor read once; written once, the `slots` results
    the function returns (distance, root index and m coordinates each:
    the K best of one problem, or each problem's best) and the counters
    (per-level nodes and solutions per problem, the two walk lengths)."""
    m = pack["mut"].shape[-1]
    G = pack["mut"].shape[0] if pack["mut"].dim() == 3 else 1
    nbytes = sum(pack[k].numel() * pack[k].element_size() for k in
                 ("mut", "rdiag", "prune", "mut_fix", "cp0", "roots_x",
                  "roots_pd"))
    nbytes += slots * (m + 2) * 4 + G * (m + 1) * 8 + 2 * 8
    t_bytes = nbytes / H100_HBM_BYTES
    t_ops = op_count(nodes.cpu().tolist()) / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def compare_counts(name, k_out, p_out, m_real):
    """Count mode: the tolerances of tests/test_pallas_parity.py:164-175;
    returns whether the per-level counts are also exactly equal."""
    import numpy as np
    kn = k_out["nodes"].cpu().numpy()[:m_real].astype(np.float64)
    pn = p_out["nodes"].cpu().numpy()[:m_real].astype(np.float64)
    ks, ps = int(k_out["sol_count"]), int(p_out["sol_count"])
    assert ks == ps, f"{name}: solution counts {ks} vs {ps}"
    kb, pb = float(k_out["best_dist"][0]), float(p_out["best_dist"][0])
    assert_best(name, kb, pb)
    assert abs(kn.sum() - pn.sum()) <= 0.01 * pn.sum(), \
        f"{name}: total nodes {kn.sum()} vs {pn.sum()}"
    for lvl in range(m_real):
        if max(kn[lvl], pn[lvl]) > 200:
            assert abs(kn[lvl] - pn[lvl]) <= 0.02 * max(kn[lvl], pn[lvl]), \
                f"{name}: level {lvl} nodes {kn[lvl]} vs {pn[lvl]}"
    return bool(np.array_equal(kn, pn)), kn.sum()


def assert_best(name, kb: float, pb: float) -> float:
    if math.isinf(kb) or math.isinf(pb):
        assert kb == pb, f"{name}: best distance {kb} vs {pb}"
        return 0.0
    assert abs(kb - pb) <= 1e-4 * abs(pb), \
        f"{name}: best distance {kb} vs {pb}"
    return abs(kb - pb)


# (name, dim, seed, linear pruning, radius factor, single root, lanes,
# modes: True = count, False = search). The dim-56 window keeps the main
# path's launch shape (m=64, nfix=16, B=1024, R=32768); its radius is cut
# to 0.85 of the shortest basis vector so that the plain version, which
# runs one lockstep step per node of the longest lane walk, finishes in
# about a minute on the card. At that radius a search finds nothing, so
# it runs in count mode only; search mode is held by the d40 cases and
# by the shrinking-bound check. The 16384-lane case is the form the TPU
# split into lane tiles: the same roots as "queue d40" with the plain
# version over 16 times the lanes (the kernel's walkers are set by the
# card, so its launch is the queue form's).
BOTH = (True, False)
CHECK_CASES = [("queue d40 pruned", 40, 3, True, 1.0, False, 1024, BOTH),
               ("queue d40", 40, 3, False, 1.0, False, 1024, BOTH),
               ("lanes d40", 40, 3, False, 1.0, False, 16384, BOTH),
               ("queue d56", 56, 4, False, 0.85, False, 1024, (True,)),
               ("nfix0 d24", 24, 1, False, 1.0, True, 1024, BOTH)]
TIMED_CASE = "queue d56"
# the shrinking-bound search: the "queue d40" lattice at 1.3 times the
# squared norm of its shortest basis vector, a ball that holds 30 vectors
SHRINK_CASE = ("shrink d40 r1.3", 40, 3, 1.3)
# search-mode nodes at most this multiple of the count-mode nodes at the
# final bound (the walk's extra work while the bound was still falling).
# The ratio is set by the lattice and the number of walkers, which all
# start at the first radius, not by timing: the kernel's stays within
# 1.36-1.42 on this lattice; a search that never lowered its bound would
# give the start radius' 11.6
SHRINK_TOL = 1.5
# other lattices of the shrink check's shape, whose kernel search overhead
# is logged, not asserted: it ranges more widely than on the checked one
SHRINK_SPREAD_SEEDS = tuple(range(5, 14))
# relative error of a distance the kernel computes in f32 against the
# exact norm of its vector: the center sums drift over a lane's
# subtract/restore round trips (8.8e-5 measured on the block-60 window
# of phase 4)
F32_DIST_TOL = 2e-4
# the grouped check's radius, times the union best: keeps the plain
# version, which walks the three trials one after another, near 100 s
GROUPED_RADIUS = 1.03


def geometry_fields(out) -> dict:
    """The launch geometry and walk lengths of one kernel run, for the
    kernel-check lines."""
    geo = out["geometry"]
    return {"walkers": geo["walkers"], "W": geo["width"], "M": geo["M"],
            "grid": geo["grid"], "blocks_per_sm": geo["blocks_per_sm"],
            "sms": geo["sms"], "smem": geo["smem"],
            "longest_walker_walk": int(out["steps"]),
            "longest_root_walk": int(out["root_steps"])}


def wrapper_ms(fn, reps: int = 3):
    """One warm-up call, then the median of `reps` calls timed with CUDA
    events (the wrapper's launch and its top-K finalize)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        ts.append(t0.elapsed_time(t1))
    return out, sorted(ts)[reps // 2]


def native_ms(mut, rdiag, prune, A, count_mode):
    """The native C core on the same window: (ms, nodes of the whole
    tree, best distance), the yardstick beside the kernel."""
    from fplll_tpu_torch.native import native_enumerate
    t0 = time.perf_counter()
    out = native_enumerate(mut, rdiag, prune, None, A, True, False,
                           count_mode)
    return (time.perf_counter() - t0) * 1e3, float(out[4].sum()), \
        float(out[1])


def phase_kernel_checks(device, cases=CHECK_CASES, shrink=SHRINK_CASE,
                        grouped=(80, 60, GROUPED_RADIUS)):
    """Phase 2. Returns the per-form records, the largest best-distance
    difference and the timing record of the main-path shape. The size
    parameters let it be rehearsed small; the script runs the defaults."""
    import torch
    from fplll_tpu_torch.enum import kernels

    sync = torch.cuda.synchronize
    forms, errs, timing = [], [], None
    for name, d, seed, pruned, radius, nfix0, lanes, modes in cases:
        _, mut, rdiag, prune, A, _ = uniform_window(d, seed, pruned, radius)
        pack = packed_problem(mut, rdiag, prune, A, device, nfix0=nfix0)
        mr = pack["m_real"]
        plain_args = {k: v for k, v in pack.items() if k != "m_real"}
        for count_mode in modes:
            kw = dict(is_svp=True, count_mode=count_mode, batch=lanes,
                      max_steps=1 << 30)
            k_out, k_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw))
            p_out, p_s = timed(lambda: kernels.enum_run_plain(
                **plain_args, **kw), sync)
            n_ms, n_nodes, _ = native_ms(mut, rdiag, prune, A, count_mode)
            mode = "count" if count_mode else "search"
            if count_mode:
                exact, total = compare_counts(f"{name} {mode}", k_out, p_out,
                                              mr)
            else:
                exact, total = None, float(k_out["nodes"][:mr].sum())
            kb, pb = float(k_out["best_dist"][0]), float(p_out["best_dist"][0])
            errs.append(assert_best(f"{name} {mode}", kb, pb))
            rec = {"form": name, "mode": mode, "m": pack["m"], "m_real": mr,
                   "nfix": pack["roots_x"].shape[1],
                   "R": pack["roots_x"].shape[0], "B": lanes,
                   "kernel_ms": k_ms, "plain_ms": p_s * 1e3,
                   "nodes": total, "nodes_per_s": total / (k_ms * 1e-3),
                   "native_ms": n_ms, "native_nodes": n_nodes,
                   "best": kb, "counts_exact": exact,
                   **geometry_fields(k_out),
                   "plain_steps": int(p_out["steps"])}
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                pack, k_out["nodes"], len(k_out["best_dist"]))
            if name == TIMED_CASE and count_mode:
                timing = rec
                rec["us_per_step"] = k_ms * 1e3 / rec["longest_walker_walk"]
                rec["grid_1_block"] = grid_check(name, pack, kw, k_out, mr)
            forms.append(rec)
            log("kernel-check " + json.dumps(rec))

    rec, err = shrink_check(device, *shrink)
    forms.append(rec)
    errs.append(err)
    rec, err = grouped_check(device, *grouped)
    forms.append(rec)
    errs.append(err)
    return forms, max(errs), timing


def grid_check(name, pack, kw, k_out, m_real) -> dict:
    """The same count-mode problem on a grid of one block: per-level node
    counts and the solution count identical to the persistent grid's (a
    root's walk does not depend on which walker takes it). Its time over
    its longest walker walk is the time of one step with few walkers per
    SM."""
    import numpy as np
    from fplll_tpu_torch.enum import kernels

    one, one_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw, grid=1),
                             reps=1)
    assert one["geometry"]["grid"] == 1
    a = k_out["nodes"].cpu().numpy()[:m_real]
    b = one["nodes"].cpu().numpy()[:m_real]
    assert np.array_equal(a, b), f"{name}: counts at grid 1 differ: {a} {b}"
    assert int(one["sol_count"]) == int(k_out["sol_count"]), name
    return {"walkers": one["geometry"]["walkers"], "counts_identical": True,
            "kernel_ms": one_ms, "longest_walker_walk": int(one["steps"]),
            "us_per_step": one_ms * 1e3 / int(one["steps"])}


def kernel_search_overhead(device, d, seed, radius) -> float:
    """The kernel's search-mode nodes over its count-mode nodes at the
    bound the search ended at, on the shrink check's window shape."""
    from fplll_tpu_torch.enum import kernels

    _, mut, rdiag, prune, A, _ = uniform_window(d, seed, False, radius)
    pack = packed_problem(mut, rdiag, prune, A, device)
    mr = pack["m_real"]
    kw = dict(is_svp=True, batch=1024, max_steps=1 << 30)
    k_s = kernels.enum_run(**pack, count_mode=False, **kw)
    final = dict(pack, A0=float(k_s["best_dist"][0]) * 1.00001)
    k_f = kernels.enum_run(**final, count_mode=True, **kw)
    return float(k_s["nodes"][:mr].sum()) / float(k_f["nodes"][:mr].sum())


def shrink_check(device, name, d, seed, radius, spread=SHRINK_SPREAD_SEEDS):
    """Search mode with a bound that shrinks several times, at the main
    path's launch shape: an unpruned window whose ball holds tens of
    vectors, so lanes find several and the shared bound falls more than
    once. The kernel's best must equal the plain version's and lie well
    inside the start radius; its count-mode nodes at the final bound must
    equal the plain version's per level; its search-mode nodes must lie
    between those and SHRINK_TOL times those, while the tree at the start
    radius holds at least 3 times more (so a kernel that ignored search
    mode, or never re-read or lowered the bound, fails). The kernel's
    ratio is also logged, not asserted, on the lattices of `spread`."""
    import torch
    from fplll_tpu_torch.enum import kernels

    _, mut, rdiag, prune, A, _ = uniform_window(d, seed, False, radius)
    pack = packed_problem(mut, rdiag, prune, A, device)
    mr = pack["m_real"]
    kw = dict(is_svp=True, batch=1024, max_steps=1 << 30)

    def plain(p, count_mode):
        args = {k: v for k, v in p.items() if k != "m_real"}
        return kernels.enum_run_plain(**args, count_mode=count_mode, **kw)

    k_s, k_ms = wrapper_ms(lambda: kernels.enum_run(**pack, count_mode=False,
                                                    **kw))
    p_s, p_t = timed(lambda: plain(pack, False), torch.cuda.synchronize)
    kb, pb = float(k_s["best_dist"][0]), float(p_s["best_dist"][0])
    assert math.isfinite(kb), f"{name}: the search found nothing"
    err = assert_best(f"{name} search", kb, pb)
    assert kb <= 0.9 * A, f"{name}: best {kb} not inside the radius {A}"
    final = dict(pack, A0=kb * 1.00001)     # the bound slack of the path
    k_f = kernels.enum_run(**final, count_mode=True, **kw)
    exact, n_final = compare_counts(f"{name} count at the final bound", k_f,
                                    plain(final, True), mr)
    n_start = float(kernels.enum_run(**pack, count_mode=True,
                                     **kw)["nodes"][:mr].sum())
    n_k = float(k_s["nodes"][:mr].sum())
    n_p = float(p_s["nodes"][:mr].sum())
    rec = {"form": name, "mode": "search", "m": pack["m"], "m_real": mr,
           "B": 1024, "kernel_ms": k_ms, "plain_ms": p_t * 1e3,
           "best": kb, "radius": A, "nodes": n_k, "plain_nodes": n_p,
           "count_nodes_final_bound": n_final,
           "count_nodes_start_radius": n_start,
           "search_over_final": n_k / n_final,
           "counts_exact_final_bound": exact,
           **geometry_fields(k_s)}
    rec["search_over_final_by_seed"] = {seed: n_k / n_final, **{
        s: kernel_search_overhead(device, d, s, radius) for s in spread}}
    log("kernel-check " + json.dumps(rec))
    assert n_start >= 3 * n_final, f"{name}: the check cannot tell " \
        f"({n_start} nodes at the start radius, {n_final} at the end)"
    for who, n in (("kernel", n_k), ("plain", n_p)):
        assert n_final * (1 - 1e-3) <= n <= SHRINK_TOL * n_final, \
            f"{name}: {who} search nodes {n} against {n_final} at the " \
            "final bound"
    return rec, err


def grouped_window_problem(device, dim=80, block=60, radius=GROUPED_RADIUS,
                           trials=3):
    """The grouped trials of a block-60 window, built the way the C tour
    builds them (bkz_core.c:grouped_trials_c): the [0, block) window of
    the dim-80 q-ary basis after the 40 -> 50 warm-up; trial 0 as it
    stands, each other trial rerandomized below its first row (as
    rerandomize_block) and preprocessed by one BKZ tour at the block-60
    strategy's preprocessing block size; all with the block-60 strategy's
    pruning; packed by the grouped window path's own packing (G_real = 3
    problems padded to G = 4, height m = 64).

    The radius is `radius` times the union best, which the C core finds
    first at the tour's radius (min(0.99 r_0, 1.1 GH)). Under pruning,
    which vector a search returns can depend on the order in which its
    bound falls. The C core shows that here it cannot: a trial that still
    finds the union best at 1 + 1e-5 times its norm finds it under every
    bound a search can hold before, so the kernel and the plain version
    must both return it."""
    import random
    import numpy as np
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.enum.device import _pack_grouped
    from fplll_tpu_torch.native import native_enumerate
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_qary_bits
    from fplll_tpu_torch.ops.intmat import IntMat

    RandGen.init_with_seed(11)
    b = gen_qary_bits(dim, dim // 2, 30)
    lll_reduction(b)
    strategies = load_strategies_json("default.json")
    for warm in (40, 50):
        bkz_tour(b, strategies, warm, device, 0)
    prune = np.asarray(strategies[block].pruning_parameters[0].coefficients)
    pre = strategies[block].preprocessing_block_sizes[0]
    rng = random.Random(5)
    bases, muts, rdiags, exps = [], [], [], []
    for g in range(trials):
        bb = IntMat(data=b.a[:block].copy())
        if g:
            for _ in range(4 * (block - 1)):
                i = j = rng.randrange(1, block)
                while j == i:
                    j = rng.randrange(1, block)
                bb.row_swap(i, j)
            for i in range(1, block - 2):
                for _ in range(3):
                    j = rng.randrange(i + 1, block)
                    bb.row_addmul(i, j, 1 if rng.random() < .5 else -1)
            lll_reduction(bb)
            bkz_tour(bb, strategies, pre, device, 0)
        gso = MatGSO(bb, flags=GSO_INT_GRAM)
        gso.update_gso()
        mut, rdiag, normexp = gso.export_mu_r(0, block)
        bases.append(bb)
        muts.append(np.asarray(mut))
        rdiags.append(np.asarray(rdiag))
        exps.append(normexp)
    # one scale, so that the shared bound compares like with like
    assert len(set(exps)) == 1, f"trials in different scales {exps}"
    tgh = math.exp(math.lgamma(block / 2 + 1) * 2 / block) / math.pi
    A_tour = min(0.99 * rdiags[0][0], 1.1 * tgh * math.exp(
        float(np.mean(np.log(rdiags[0])))))
    t0 = time.perf_counter()
    found = [native_enumerate(mu, r, prune, None, A_tour, True, False,
                              False) for mu, r in zip(muts, rdiags)]
    native_s = time.perf_counter() - t0
    best = min(float(f[1]) for f in found)
    assert math.isfinite(best), "the C core found no vector in any trial"
    certified = [float(native_enumerate(mu, r, prune, None, best * 1.00001,
                                        True, False, False)[1]) <=
                 best * (1 + 1e-9) for mu, r in zip(muts, rdiags)]
    assert any(certified), "the union best depends on the bound's order"
    maxds = np.full(trials, best * radius)
    tensors, m_reals, _ = _pack_grouped(
        np.stack(muts), np.stack(rdiags), np.stack([prune] * trials), maxds,
        device, 1024)
    return {"tensors": tensors, "m_reals": [int(v) for v in m_reals],
            "bases": bases,
            "normexp": exps[0], "union_best_c": best, "radius": best * radius,
            "trial_best_c": [float(f[1]) for f in found],
            "certified": certified, "native_ms": native_s * 1e3,
            "native_nodes": sum(float(f[4].sum()) for f in found)}


def exact_norm(basis, coeffs) -> int:
    """The squared norm of sum_i coeffs[i] * basis row i, in integers."""
    x = [int(round(float(c))) for c in coeffs]
    v = [sum(x[i] * int(basis.a[i][c]) for i in range(len(x)) if x[i])
         for c in range(basis.ncols)]
    return sum(c * c for c in v)


def grouped_check(device, dim, block, radius):
    """The grouped form at the main path's shape against the plain
    version: equal union best (which the C core found too), padding
    problem empty, the shared bound ending at the union best, and the
    kernel's vector verified in exact integers: its norm is the C core's
    union best."""
    import torch
    from fplll_tpu_torch.enum import kernels

    gp = grouped_window_problem(device, dim, block, radius)
    t = gp["tensors"]
    G, m = t["mut"].shape[0], t["mut"].shape[1]
    G_real = len(gp["m_reals"])
    assert (G, G_real) == (4, 3) and m == -(-block // 8) * 8 and \
        float(t["A0"][3]) == 0.0, (G, m, G_real)
    kw = dict(G_real=G_real, batch=1024, is_svp=True, max_steps=1 << 30)
    k_out, k_ms = wrapper_ms(lambda: kernels.enum_run_grouped(**t, **kw))
    name = f"grouped G={G_real} (G={G}) d{block}"
    plain_args = {k: v for k, v in t.items() if k != "m_real"}
    p_out, p_s = timed(lambda: kernels.enum_run_grouped_plain(
        **plain_args, **kw), torch.cuda.synchronize)
    kdist, pdist = k_out["dist"].cpu(), p_out["dist"].cpu()
    kd, pd = float(kdist[:G_real].min()), float(pdist[:G_real].min())
    assert math.isfinite(kd), "grouped: the kernel found no vector"
    err = assert_best("grouped union best", kd, pd)
    assert math.isinf(float(kdist[G_real:].min())) and \
        math.isinf(float(pdist[G_real:].min())), "a padding problem found"
    assert float(k_out["bound"]) == kd, \
        f"shared bound {float(k_out['bound'])} against union best {kd}"
    g = int(kdist[:G_real].argmin())
    mr = gp["m_reals"][g]
    coeffs = list(k_out["dev"][g][:mr].cpu()) + \
        list(k_out["root"][g][:block - mr].cpu())
    exact = math.ldexp(exact_norm(gp["bases"][g], coeffs), -gp["normexp"])
    assert abs(exact - kd) <= F32_DIST_TOL * exact, (exact, kd)
    c_best = gp["union_best_c"]
    assert abs(exact - c_best) <= 1e-9 * c_best, \
        f"grouped: the kernel's vector {exact} against the C core's {c_best}"
    nodes = float(k_out["nodes"].sum())
    rec = {"form": name, "mode": "search",
           "m": m, "m_reals": gp["m_reals"],
           "R": t["roots_pd"].shape[1], "B": 1024,
           "kernel_ms": k_ms, "plain_ms": p_s * 1e3, "nodes": nodes,
           "nodes_per_s": nodes / (k_ms * 1e-3),
           "native_ms": gp["native_ms"], "native_nodes": gp["native_nodes"],
           "radius": gp["radius"], "union_best": kd,
           "plain_union_best": pd, "c_core_union_best": gp["union_best_c"],
           "c_core_trial_best": gp["trial_best_c"],
           "certified_trials": gp["certified"], "exact_norm": exact,
           "shared_bound": float(k_out["bound"]),
           **geometry_fields(k_out),
           "plain_steps": int(p_out["steps"])}
    rec["bound_ms"], rec["bound_by"] = bound_ms(t, k_out["nodes"], G)
    log("kernel-check " + json.dumps(rec))
    return rec, err


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def gso_stats(b):
    """(is LLL-reduced, root-Hermite factor) of an integer basis."""
    import numpy as np
    from fplll_tpu_torch.algs.lll import is_lll_reduced
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_ROW_EXPO

    m = MatGSO(b.copy(), flags=GSO_ROW_EXPO)
    red = is_lll_reduced(m, 0.99, 0.51)
    m.update_gso()
    d = b.nrows
    logr = []
    for i in range(d):
        v, e = m.get_r_exp(i, i)
        logr.append(math.log(float(v)) + e * math.log(2.0))
    logvol = 0.5 * sum(logr)
    n0 = math.log(float(np.linalg.norm(np.array(
        [int(v) for v in b.a[0]], dtype=np.float64))))
    return red, math.exp((n0 - logvol / d) / d)


def bkz_tour(b, strategies, block, device, hybrid):
    """One BKZ-2.0 tour through bkz_reduction; returns (wall s, nodes,
    device nodes, g_max, phase timers of the C tour) read from the
    BKZReduction the entry point built."""
    from fplll_tpu_torch.algs.bkz import BKZReduction, bkz_reduction
    from fplll_tpu_torch.algs.bkz_param import BKZParam
    from fplll_tpu_torch.defs import BKZ_GH_BND, BKZ_MAX_LOOPS

    os.environ["FPLLL_TPU_HYBRID_NODES"] = str(hybrid)
    stats = {}
    orig = BKZReduction.bkz

    def spy(self):
        try:
            return orig(self)
        finally:
            stats["nodes"] = self.nodes
            stats["dev"] = getattr(self, "dev_nodes", 0)
            stats["g_max"] = getattr(self, "g_max", 0)
            stats["timers"] = dict(getattr(self, "native_timers", {}))

    BKZReduction.bkz = spy
    try:
        t0 = time.perf_counter()
        bkz_reduction(b, BKZParam(block, strategies,
                                  flags=BKZ_MAX_LOOPS | BKZ_GH_BND,
                                  max_loops=1), device=device)
        dt = time.perf_counter() - t0
    finally:
        BKZReduction.bkz = orig
    return dt, stats["nodes"], stats["dev"], stats["g_max"], stats["timers"]


def phase_main_path(device, dim=80, warm_blocks=(40, 50), block=60,
                    crossover=CROSSOVER):
    """Phase 3: BKZ-2.0 on a q-ary basis, the warm-up on the host C core,
    then one tour with the device crossover and the same tour on the host
    C core alone. Sizes are parameters only so the phase can be rehearsed
    small; the script runs it at the defaults."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.enum import kernels
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_qary_bits

    RandGen.init_with_seed(11)
    b = gen_qary_bits(dim, dim // 2, 30)
    lll_reduction(b)
    strategies = load_strategies_json("default.json")
    t0 = time.perf_counter()
    for warm in warm_blocks:
        bkz_tour(b, strategies, warm, device, 0)
    log(f"main-path warm-up {warm_blocks} (host C core): "
        f"{time.perf_counter() - t0:.3f} s")
    b_dev, b_host = b.copy(), b.copy()

    kernels.reset_launch_counts()
    RandGen.init_with_seed(12)
    dev_wall, dev_total, dev_nodes, g_max, dev_timers = bkz_tour(
        b_dev, strategies, block, device, crossover)
    launches = dict(kernels.LAUNCHES)
    grids = sorted(set().union(*kernels.GRIDS.values()))
    kernels.reset_launch_counts()
    RandGen.init_with_seed(12)
    host_wall, host_total, host_dev, _, host_timers = bkz_tour(
        b_host, strategies, block, device, 0)
    assert host_dev == 0 and sum(kernels.LAUNCHES.values()) == 0

    red_dev, rhf_dev = gso_stats(b_dev)
    red_host, rhf_host = gso_stats(b_host)
    _, rhf_warm = gso_stats(b)
    rec = {"crossover_FPLLL_TPU_HYBRID_NODES": crossover,
           "device_tour_wall_s": dev_wall, "device_tour_nodes": dev_total,
           "device_nodes": dev_nodes,
           "device_node_share": dev_nodes / max(dev_total, 1),
           "g_max": g_max, "launches": launches,
           # (grid, blocks per SM, SMs) of the tour's launches
           "grids": grids,
           "host_tour_wall_s": host_wall, "host_tour_nodes": host_total,
           "rhf_warmup_bkz50": rhf_warm, "rhf_device_tour": rhf_dev,
           "rhf_host_tour": rhf_host,
           # seconds in the C tour's phases: enum_s sequential C
           # enumeration, device_s the device callback (root generation,
           # packing, launches), lll_s in-tour LLL, misc_s the rest
           "device_tour_timers": dev_timers, "host_tour_timers": host_timers}
    log("main-path " + json.dumps(rec))
    assert dev_nodes > 0, "no window reached the card"
    assert sum(launches.values()) > 0, "the kernel was never launched"
    assert all(g == bps * sms for g, bps, sms in grids), \
        f"a launch did not fill the card: {grids}"
    assert red_dev and red_host, "BKZ output is not LLL-reduced"
    # BKZ-60 regime, calibrated on the host-only tour of the same input:
    # the host tour takes the root-Hermite factor from rhf_warm down to
    # rhf_host; the device tour must keep at least 95% of that gain
    assert rhf_host < rhf_warm, (rhf_host, rhf_warm)
    assert rhf_dev - rhf_host <= 0.05 * (rhf_warm - rhf_host), \
        (rhf_dev, rhf_host, rhf_warm)
    return rec


# ---------------------------------------------------------------------------
# phase 4: one block-60 window
# ---------------------------------------------------------------------------
def phase_window(device, dim=80, block=60, warm=40):
    """Phase 4: the [0, block) window of a BKZ-warm q-ary basis with the
    shipped pruning through DeviceEnumerator and the native C core
    (bench.py:measure_block60_window).

    Under pruning the two may return different vectors: the tree a search
    walks shrinks with its bound, so which vector it ends at depends on
    the order it finds vectors in, and the card's lanes find them in
    another order than the sequential C core. What each search does
    promise is that the pruned tree at its answer's distance holds no
    shorter vector (its bound never fell below that distance). So each
    answer is checked in exact integers and then certified by the other
    implementation: searching the same pruned tree inside 0.999 times
    that distance (a margin over the kernel's f32 distance error), it must
    find nothing."""
    import numpy as np
    import torch
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_ROW_EXPO
    from fplll_tpu_torch.enum.device import DeviceEnumerator
    from fplll_tpu_torch.enum.evaluator import FastEvaluator
    from fplll_tpu_torch.native import native_enumerate
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_qary_bits

    RandGen.init_with_seed(11)
    b = gen_qary_bits(dim, dim // 2, 30)
    lll_reduction(b)
    strategies = load_strategies_json("default.json")
    bkz_tour(b, strategies, warm, device, 0)
    m0 = MatGSO(b, flags=GSO_ROW_EXPO)
    m0.update_gso()
    mut, rdiag, normexp = m0.export_mu_r(0, block)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag)
    tgh = math.exp(math.lgamma(block / 2 + 1) * 2 / block) / math.pi
    maxdist = min(0.99 * rdiag[0],
                  tgh * 1.1 * math.exp(float(np.mean(np.log(rdiag)))))
    prune = np.asarray(strategies[block].pruning_parameters[0].coefficients)

    t0 = time.perf_counter()
    ref = native_enumerate(mut, rdiag, prune, None, maxdist, True, False,
                           False)
    nat_s = time.perf_counter() - t0
    nat_nodes = float(ref[4].sum())
    enum = DeviceEnumerator(batch=1024, device=device)

    def device_search(radius):
        ev = FastEvaluator(nr_solutions=1)
        _, dt = timed(lambda: enum.enumerate(
            mut, rdiag, prune, np.zeros(block), radius, True, ev),
            torch.cuda.synchronize)
        sol = ev.begin() if not ev.empty() else (math.inf, None)
        return dt, float(enum.nodes.sum()), sol[0], sol[1]

    runs = sorted((device_search(maxdist) for _ in range(3)),
                  key=lambda r: r[0])
    dev_s, dev_nodes, dev_best, dev_x = runs[1]
    assert math.isfinite(ref[1]), "the C core found no vector"
    assert math.isfinite(dev_best), "the card found no vector"
    dev_exact = math.ldexp(exact_norm(b, dev_x), -normexp)
    nat_exact = math.ldexp(exact_norm(b, ref[2]), -normexp)
    # each answer certified by the other implementation
    c_cert = native_enumerate(mut, rdiag, prune, None, dev_exact * 0.999,
                              True, False, False)
    d_cert = device_search(nat_exact * 0.999)
    rec = {"window": f"[0,{block}) of dim-{dim} q-ary after BKZ-{warm}",
           "device_wall_s": dev_s, "device_nodes": dev_nodes,
           "device_nodes_per_s": dev_nodes / dev_s,
           "native_wall_s": nat_s, "native_nodes": nat_nodes,
           "native_nodes_per_s": nat_nodes / nat_s,
           "device_best": dev_best, "device_exact": dev_exact,
           "native_best": float(ref[1]), "native_exact": nat_exact,
           "device_runs_best": [r[2] for r in runs],
           "c_core_inside_device_best": float(c_cert[1]),
           "card_inside_c_core_best": d_cert[2]}
    log("window " + json.dumps(rec))
    assert abs(dev_exact - dev_best) <= F32_DIST_TOL * dev_exact, \
        (dev_exact, dev_best)
    assert abs(nat_exact - ref[1]) <= 1e-9 * nat_exact, (nat_exact, ref[1])
    assert math.isinf(c_cert[1]), \
        f"the C core found {c_cert[1]} inside the card's {dev_exact}"
    assert math.isinf(d_cert[2]), \
        f"the card found {d_cert[2]} inside the C core's {nat_exact}"
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import fplll_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2
    from fplll_tpu_torch import native
    from fplll_tpu_torch.enum import kernels

    device = "cuda"
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_kernel()
    log(f"build enum_chunk.cu (nvcc): {time.perf_counter() - t0:.3f} s")
    for line in kernels.BUILD_LOG.strip().splitlines():
        log(f"  ptxas: {line.strip()}")
    frames = [tuple(int(v) for v in f) for f in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads", kernels.BUILD_LOG)]
    log(f"ptxas: {len(frames)} kernel instances, (stack frame, spill "
        f"stores, spill loads) bytes: {frames}")
    # M in (32, 64, 128) x (shared, global memory), at W = ENUM_WIDTH
    assert len(frames) == 3 * 2, "an instance is missing"
    assert all(st == ld == 0 for _, st, ld in frames), "registers spill"
    for name, get in (("enum_core", native.get_lib),
                      ("lll_core", native.get_lll_lib),
                      ("bkz_core", native.get_bkz_lib)):
        t0 = time.perf_counter()
        lib = get()
        assert lib is not None, f"native {name} did not load"
        log(f"build {name}.c (cc): {time.perf_counter() - t0:.3f} s")

    # -- phase 2: kernel against plain version -----------------------------
    t0 = time.perf_counter()
    forms, max_err, timing = phase_kernel_checks(device)
    log(f"phase 2 done in {time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path ----------------------------------------------
    t0 = time.perf_counter()
    main_rec = phase_main_path(device)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")

    # -- phase 4: one block-60 window ---------------------------------------
    t0 = time.perf_counter()
    win = phase_window(device)
    log(f"phase 4 done in {time.perf_counter() - t0:.1f} s; plain version "
        f"on the card, dim-56 window count mode: {timing['plain_ms']:.1f} ms "
        f"against the kernel's {timing['kernel_ms']:.1f} ms")

    grouped = next(f for f in forms if f["form"].startswith("grouped"))
    by_form = {"queue d56 count": timing["kernel_ms"],
               f"{grouped['form']} search": grouped["kernel_ms"]}
    log("recorded times of the one-thread-per-lane kernel (PERF.md "
        "section 6, not measured in this run): "
        + json.dumps(LANE_KERNEL_RECORDED_MS))
    log(card)
    log(json.dumps({"kernels": [{
        "name": "enum_chunk_kernel",
        "route": "cuda",
        "source": "fplll_tpu_torch/csrc/enum_chunk.cu",
        "replaces": "fplll_tpu/enum/pallas_kernel.py:136",
        "replaces_sites": ["fplll_tpu/enum/pallas_kernel.py:728",
                           "fplll_tpu/enum/pallas_kernel.py:792",
                           "fplll_tpu/enum/pallas_kernel.py:925",
                           "fplll_tpu/enum/pallas_kernel.py:961"],
        "launches": sum(main_rec["launches"].values()),
        "launches_by_wrapper": main_rec["launches"],
        "max_abs_err": max_err,
        "ms": timing["kernel_ms"],
        "ms_by_form": by_form,
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "check": "pass",
        "tolerance": "equal solution counts; best distance 1e-4 relative; "
                     "nodes 1% in total, 2% per level above 200; search "
                     f"nodes within {SHRINK_TOL}x the count at the final "
                     "bound; grouped union best 1e-4 relative, its exact "
                     "norm the C core's to 1e-9",
        "shape": {k: timing[k] for k in ("m", "m_real", "nfix", "R", "B")},
        "geometry": {k: timing[k] for k in (
            "walkers", "W", "M", "grid", "blocks_per_sm", "sms",
            "longest_walker_walk", "longest_root_walk")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
