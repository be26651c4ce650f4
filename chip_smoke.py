#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernel.

    python3 chip_smoke.py              # every phase; needs one CUDA card

Phases (each one fails the run if it fails):
  1. report the card, build the CUDA kernel (every template instance,
     `-Xptxas -v` printed, no spills, the six f32 instances of BKZ-2.0 at
     the registers they had before the element type became a template
     parameter) and the native C cores;
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
     each answer certified by the other implementation;
  5. proved SVP (d = 56), fast and proved CVP, dual SVP and sub-solutions
     (d = 50) on BKZ-20-reduced gen_intrel bases through the port's
     public functions, each against the same call host-only.

Phase 2 also holds the f64, dual and sub-solution forms of the kernel
against the plain version.

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
H100_F64_FLOPS = 34e12       # non-tensor f64 peak, H100 SXM data sheet
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
        rx, _, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d),
                                          A, d, True)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real)
    pack["A0"] = A * enum.bound_slack
    return pack


def op_count(nodes) -> float:
    """Operations the walk needs for these per-level node counts: per
    counted node at level k, the bound test and zig-zag step (about 20)
    plus the descend/restore update of the k center sums below it (4k)."""
    return float(sum(int(n) * (4 * k + 20) for k, n in enumerate(nodes)))


def bound_ms(pack, nodes, slots: int, d: int, m_reals,
             subsols: bool = False) -> tuple:
    """Least time for the work: max(bytes / HBM rate, ops / the rate of
    the tree's element type, outside the tensor cores, which the walk
    does not use). Bytes: what the walk needs of each real problem (one
    per entry of `m_reals`, its real height; d - m_real fixed levels),
    read once, with none of the padding to the kernel's buckets: mu's
    strict triangle, rdiag, prune and the start centers over the m_real
    levels, mu against the fixed levels, and the roots inside the start
    radius (the padding roots lie outside it and stop the walk at the
    first one): each one's partial distance and the values it feeds the
    center sums (its coordinates, or under dual its alpha values, with
    the coordinates read only for the reported results). Written once:
    the `slots` results the function returns (distance, root index and
    m_real coordinates each: the K best of one problem, or each problem's
    best), the counters (per-level nodes and solutions per problem, the
    two walk lengths) and, with `subsols`, the per-level records
    (distance, root index and m_real coordinates per level). Returns
    (ms, what bounds it, the roots inside the start radius per problem)."""
    import torch
    elem = pack["mut"].element_size()
    dual = "roots_a" in pack
    rpd = pack["roots_pd"].reshape(-1, pack["roots_pd"].shape[-1]).cpu()
    A0 = torch.as_tensor(pack["A0"]).reshape(-1).cpu()
    roots = [int((rpd[g] <= A0[g]).sum()) for g in range(len(m_reals))]
    floats = 0
    for mr, R in zip(m_reals, roots):
        nf = d - mr
        floats += mr * (mr - 1) // 2 + 3 * mr + mr * nf + R * (nf + 1)
        if dual:
            floats += min(slots, R) * nf
    mr = max(m_reals)
    nbytes = floats * elem + slots * ((mr + 1) * elem + 4) + \
        sum((m + 1) * 8 for m in m_reals) + 2 * 8
    if subsols:
        nbytes += sum(m * ((m + 1) * elem + 4) for m in m_reals)
    t_bytes = nbytes / H100_HBM_BYTES
    rate = H100_F64_FLOPS if elem == 8 else H100_F32_FLOPS
    t_ops = op_count(nodes.cpu().tolist()) / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", roots)


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
# version, which walks the three trials one after another, near a minute
GROUPED_RADIUS = 1.015
# the radius of the grouped check's earlier, larger tree; the kernel alone
# is also timed there, beside the times recorded at it (PERF.md section 6)
GROUPED_TIMED_RADIUS = 1.03


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


def native_ms(mut, rdiag, prune, A, count_mode, dual=False):
    """The native C core on the same window: (ms, nodes of the whole
    tree, best distance), the yardstick beside the kernel."""
    from fplll_tpu_torch.native import native_enumerate
    t0 = time.perf_counter()
    out = native_enumerate(mut, rdiag, prune, None, A, True, dual,
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
            rec["bound_ms"], rec["bound_by"], (rec["R_real"],) = bound_ms(
                pack, k_out["nodes"], len(k_out["best_dist"]), d, [mr])
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
    def pack(r):
        return _pack_grouped(np.stack(muts), np.stack(rdiags),
                             np.stack([prune] * trials),
                             np.full(trials, best * r), device, 1024)

    tensors, m_reals, _ = pack(radius)
    return {"tensors": tensors, "m_reals": [int(v) for v in m_reals],
            "pack": pack,
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
    wide = gp["pack"](GROUPED_TIMED_RADIUS)[0]
    _, wide_ms = wrapper_ms(lambda: kernels.enum_run_grouped(**wide, **kw))
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
           f"kernel_ms_at_{GROUPED_TIMED_RADIUS}": wide_ms,
           **geometry_fields(k_out),
           "plain_steps": int(p_out["steps"])}
    rec["bound_ms"], rec["bound_by"], rec["R_real"] = bound_ms(
        t, k_out["nodes"], G, block, gp["m_reals"])
    log("kernel-check " + json.dumps(rec))
    return rec, err


# the forms of the proved SVP/CVP solvers: (form, element type, dual,
# sub-solutions, dim, seed, modes), each against its plain version at the
# main path's launch shape (m = 64, nfix = 16, R = 32768). The primal
# trees are the "queue d40" window (0.22 M nodes in the C core); the dual
# ones the seed-4 window's dual tree at its longest 1/r_ii (0.22 M nodes
# too), so each plain run takes seconds. Sub-solutions run in count mode,
# where the records do not depend on timing.
EXT_CASES = [("f64", "f64", False, False, 40, 3, BOTH),
             ("f32-dual", "f32", True, False, 40, 4, BOTH),
             ("f64-dual", "f64", True, False, 40, 4, BOTH),
             ("f32-subsols", "f32", False, True, 40, 3, (True,)),
             ("f64-subsols", "f64", False, True, 40, 3, (True,))]


def dual_tree(mut, rdiag, radius=1.0):
    """The reversed, inverted (mu, r) of the dual recurrence (as the
    facade transforms a block, enumerate.cpp:98-121) and `radius` times
    its longest 1/r_ii, the length of a dual basis vector."""
    import numpy as np
    mu2 = np.triu(-(mut.T)[::-1, ::-1], 1)
    r2 = (1.0 / rdiag)[::-1].copy()
    return mu2, r2, 1.00001 * float(r2.max()) * radius


def ext_problem(d, seed, dtype, dual, device):
    """A window (or its dual tree) packed as DeviceEnumerator packs it in
    `dtype`, at the main path's launch shape."""
    import numpy as np
    import torch
    from fplll_tpu_torch.enum.device import DeviceEnumerator

    _, mut, rdiag, prune, A, _ = uniform_window(d, seed, False)
    if dual:
        mut, rdiag, A = dual_tree(mut, rdiag)
    enum = DeviceEnumerator(batch=1024, target_root_factor=16, device=device,
                            dtype=torch.float64 if dtype == "f64"
                            else torch.float32)
    enum.nodes = np.zeros(d, dtype=np.int64)
    enum.pin_m, enum.pin_nfix, enum.pin_R = 64, 16, 32768
    rx, ra, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d), A,
                                          d, True, dual=dual)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real,
                      ra if dual else None)
    pack["A0"] = A * enum.bound_slack
    return pack, (mut, rdiag, prune, A)


def phase_extended_checks(device, cases=EXT_CASES):
    """Phase 2, the forms of the proved solvers: each against its plain
    version on the card with the tolerances of the CPU tests of the host
    build (tests/test_torch_enum_f64.py): count mode, per-level nodes,
    the solution count and the sub-solution distances exactly equal; both
    modes, bit-equal best distances. Returns the records, each with the
    largest difference of its best distance or a sub-solution distance
    from the plain version's (max_abs_err)."""
    import numpy as np
    import torch
    from fplll_tpu_torch.enum import kernels

    sync = torch.cuda.synchronize
    recs = []
    for form, dtype, dual, subsols, d, seed, modes in cases:
        pack, (mut, rdiag, prune, A) = ext_problem(d, seed, dtype, dual,
                                                   device)
        assert kernels._form(pack["mut"].dtype, dual, subsols) == form
        mr = pack["m_real"]
        plain_args = {k: v for k, v in pack.items() if k != "m_real"}
        for count_mode in modes:
            kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                      max_steps=1 << 30, dual=dual, findsubsols=subsols)
            k_out, k_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw))
            p_out, p_s = timed(lambda: kernels.enum_run_plain(
                **plain_args, **kw), sync)
            n_ms, n_nodes, _ = native_ms(mut, rdiag, prune, A, count_mode,
                                         dual)
            mode = "count" if count_mode else "search"
            name = f"{form} d{d} {mode}"
            kb, pb = float(k_out["best_dist"][0]), float(p_out["best_dist"][0])
            err = abs(kb - pb) if math.isfinite(kb) else 0.0
            assert kb == pb, f"{name}: best distance {kb} vs {pb}"
            assert math.isfinite(kb), f"{name}: nothing found"
            kn = k_out["nodes"].cpu().numpy()[:mr]
            pn = p_out["nodes"].cpu().numpy()[:mr]
            if count_mode:
                assert np.array_equal(kn, pn), f"{name}: counts {kn} {pn}"
                ks, ps = int(k_out["sol_count"]), int(p_out["sol_count"])
                assert ks == ps > 0, f"{name}: solution counts {ks} {ps}"
                if subsols:
                    a = k_out["subsol_dist"].cpu().numpy()[:mr]
                    b = p_out["subsol_dist"].cpu().numpy()[:mr]
                    both = np.isfinite(a) & np.isfinite(b)
                    err = max(err, float(np.abs(a - b)[both].max(
                        initial=0.0)))
                    assert np.array_equal(a, b), f"{name}: records {a} {b}"
            rec = {"form": form, "mode": mode, "dim": d, "seed": seed,
                   "m": pack["m"], "m_real": mr,
                   "nfix": pack["roots_x"].shape[1],
                   "R": pack["roots_x"].shape[0], "B": 1024,
                   "kernel_ms": k_ms, "plain_ms": p_s * 1e3,
                   "nodes": float(kn.sum()),
                   "nodes_per_s": float(kn.sum()) / (k_ms * 1e-3),
                   "native_ms": n_ms, "native_nodes": n_nodes, "best": kb,
                   "max_abs_err": err,
                   "counts_exact": True if count_mode else None,
                   **geometry_fields(k_out),
                   "plain_steps": int(p_out["steps"])}
            rec["bound_ms"], rec["bound_by"], (rec["R_real"],) = bound_ms(
                pack, k_out["nodes"], len(k_out["best_dist"]), d, [mr],
                subsols)
            recs.append(rec)
            log("kernel-check " + json.dumps(rec))
    return recs


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


# ---------------------------------------------------------------------------
# phase 5: SVP and CVP through the port's public functions
# ---------------------------------------------------------------------------
SVP_DIM, SVP_SEED = 56, 29   # proved SVP; see PERF.md section 4
# CVP (both methods), dual SVP and sub-solutions: a seed whose reduced
# basis has its largest r_ii first, so the proved CVP's reset below the top
# level has no nested reset and goes to the card (cpu.py:_reset_on_device)
CVP_DIM, CVP_SEED = 50, 2
# the exact SVP/CVP answers are integers; float answers (the dual length,
# sub-solution distances) agree to this relative error
PHASE5_RTOL = 1e-9


def intrel_basis(d: int, seed: int):
    """gen_intrel(d, 10 d), the knapsack-style basis of fplll's
    `latticegen r d b`, LLL- then BKZ-20-reduced on the host."""
    from fplll_tpu_torch.algs.bkz import bkz_reduction
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_intrel

    RandGen.init_with_seed(seed)
    b = gen_intrel(d, 10 * d)
    lll_reduction(b)
    bkz_reduction(b, 20, device="cpu")
    return b


class PathSpy:
    """Counts what one call through the public functions did: nodes the
    enumeration facades reported, each kernel launch's form, nodes and
    walks (wrapping the enum_run that DeviceEnumerator calls), and the
    proved-CVP resets the card handled."""

    def __enter__(self):
        from fplll_tpu_torch.enum import api, cpu, device, kernels

        self.nodes = 0
        self.device_nodes = 0
        self.longest_walker_walk = self.longest_root_walk = 0
        self.resets_on_card = 0
        kernels.reset_launch_counts()
        self._saved = [(device, "enum_run", device.enum_run),
                       (api.Enumeration, "enumerate",
                        api.Enumeration.enumerate),
                       (cpu.EnumerationDyn, "_reset_on_device",
                        cpu.EnumerationDyn._reset_on_device)]
        run, enumerate_, reset = (f for _, _, f in self._saved)
        spy = self

        def enum_run(*a, **kw):
            out = run(*a, **kw)
            spy.device_nodes += int(out["nodes"].sum())
            spy.longest_walker_walk = max(spy.longest_walker_walk,
                                          int(out["steps"]))
            spy.longest_root_walk = max(spy.longest_root_walk,
                                        int(out.get("root_steps", 0)))
            return out

        def facade(self_, *a, **kw):
            out = enumerate_(self_, *a, **kw)
            spy.nodes += self_.get_nodes()
            return out

        def reset_on_device(self_, *a, **kw):
            handled = reset(self_, *a, **kw)
            spy.resets_on_card += bool(handled)
            return handled

        device.enum_run = enum_run
        api.Enumeration.enumerate = facade
        cpu.EnumerationDyn._reset_on_device = reset_on_device
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.enum import kernels

        for owner, name, f in self._saved:
            setattr(owner, name, f)
        self.launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        return False

    def record(self, wall_s: float) -> dict:
        return {"wall_s": wall_s, "nodes": self.nodes,
                "device_nodes": self.device_nodes, "launches": self.launches,
                "longest_walker_walk": self.longest_walker_walk,
                "longest_root_walk": self.longest_root_walk,
                "resets_on_card": self.resets_on_card}


def card_and_host(name, call, device, forms, **extra):
    """One call on the card and the same call host-only (backend="cpu":
    the native C core in f64 where the facade allows it); the card's must
    have launched each of `forms`. Returns both results and the log
    record."""
    import torch

    with PathSpy() as card:
        t0 = time.perf_counter()
        on_card = call(device=device)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    with PathSpy() as host:
        t0 = time.perf_counter()
        on_host = call(backend="cpu")
        host_s = time.perf_counter() - t0
    assert not host.launches, f"{name}: the host-only run launched"
    for form in forms:
        assert card.launches.get(form, 0) > 0, \
            f"{name}: no {form} launch on the card ({card.launches})"
    rec = {"case": name, "card": card.record(card_s),
           "host": host.record(host_s), **extra}
    return on_card, on_host, rec


def lattice_point(b, coeffs):
    return [sum(int(c) * int(b.a[i][j]) for i, c in enumerate(coeffs))
            for j in range(b.ncols)]


def gso_of(b):
    """(mu^T, r, normexp) of an integer basis, exact Gram."""
    import numpy as np
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx

    gso = MatGSO(b.copy(), flags=GSO_INT_GRAM, ctx=MPCtx(120))
    gso.update_gso()
    mut, rdiag, normexp = gso.export_mu_r(0, b.nrows)
    return np.asarray(mut, dtype=np.float64), \
        np.asarray(rdiag, dtype=np.float64), normexp


def partial_dist(x, mut, rdiag, k, dual=False) -> float:
    """sum_{i >= k} r_i alpha_i^2 in f64: alpha_i = x_i - c_i, c_i =
    -sum_{j > i} w_j mu_ji with w = x, or w = alpha for the dual
    recurrence."""
    import numpy as np
    d = len(x)
    alpha = np.zeros(d)
    for i in range(d - 1, k - 1, -1):
        w = alpha if dual else x
        alpha[i] = x[i] + float(np.dot(w[i + 1:], mut[i, i + 1:]))
    return float(np.dot(rdiag[k:], alpha[k:] ** 2))


def dual_length(b, x) -> float:
    """The squared length of the dual lattice vector with dual
    coefficients x, recomputed in f64 from the basis (the dual tree's
    recurrence over the reversed, inverted GSO)."""
    import numpy as np
    mut, rdiag, normexp = gso_of(b)
    mu2, r2, _ = dual_tree(mut, np.ldexp(rdiag, normexp))
    return partial_dist(np.asarray(x[::-1], dtype=np.float64), mu2, r2, 0,
                        dual=True)


def svp_tree_estimate(b) -> float:
    """gh_tree_estimate of a proved SVP search on b from its starting
    radius, the shortest basis vector."""
    from fplll_tpu_torch.enum.device import gh_tree_estimate
    mut, rdiag, normexp = gso_of(b)
    A = min(sum(int(v) * int(v) for v in b.a[i]) for i in range(b.nrows))
    return gh_tree_estimate(rdiag, None, math.ldexp(A, -normexp))


def phase_svp_cvp(device, svp_dim=SVP_DIM, cvp_dim=CVP_DIM,
                  svp_seed=SVP_SEED, seed=CVP_SEED):
    """Phase 5: proved SVP, both CVP methods, dual SVP and sub-solutions
    through the port's public functions on the card, each answer held
    against the same call host-only. Sizes are parameters only so the
    phase can be rehearsed small."""
    import random

    import numpy as np
    from fplll_tpu_torch.algs.svpcvp import (closest_vector, shortest_vector,
                                             shortest_vector_ex,
                                             shortest_vector_pruning)
    from fplll_tpu_torch.defs import CVPM_PROVED, SVP_DUAL
    from fplll_tpu_torch.native import native_enumerate

    recs = []
    # proved SVP: the exact minimum norm is unique. Its size: d = 60 was
    # asked for; the facade's own node estimate (gh_tree_estimate at the
    # radius the search starts from, the shortest basis vector) of the
    # smallest d = 60 tree among seeds 1-30 (seed 5) is logged beside this
    # tree's, to show why the host certificate would take too long there
    b = intrel_basis(svp_dim, svp_seed)
    log("svp-size " + json.dumps({
        f"d{svp_dim} seed {svp_seed}": svp_tree_estimate(b),
        "d60 seed 5": svp_tree_estimate(intrel_basis(60, 5))}))
    (sc, xc), (sh, xh), rec = card_and_host(
        f"proved SVP d{svp_dim}",
        lambda **kw: shortest_vector(b.copy(), **kw), device, ("f64",))
    nc = sum(v * v for v in lattice_point(b, xc))
    nh = sum(v * v for v in lattice_point(b, xh))
    rec.update(status=(sc, sh), norm_card=nc, norm_host=nh)
    log("svp-cvp " + json.dumps(rec))
    assert sc == sh == 0 and nc == nh > 0, (sc, sh, nc, nh)
    recs.append(rec)

    # CVP, both methods: a lattice vector plus a random integer offset
    # whose expected squared length is 1.1 times the Gaussian heuristic,
    # so that the fast method's tree passes the card's crossover
    b = intrel_basis(cvp_dim, seed)
    mut, rdiag, normexp = gso_of(b)
    gh = math.ldexp(math.exp(float(np.mean(np.log(rdiag))) + 2 * math.lgamma(
        cvp_dim / 2 + 1) / cvp_dim) / math.pi, normexp)
    R = max(1, round(math.sqrt(3 * 1.1 * gh / b.ncols)))
    rng = random.Random(seed)
    v = lattice_point(b, [rng.randint(-3, 3) for _ in range(cvp_dim)])
    target = [c + rng.randint(-R, R) for c in v]

    def cvp_dist(x):
        return sum((t - c) ** 2 for t, c in zip(target, lattice_point(b, x)))

    # the host runs the fast method both times: its proved method runs
    # every reset on the Python DFS, far too slow at this size
    for method in (0, CVPM_PROVED):
        (sc, xc), (sh, xh), rec = card_and_host(
            f"CVP method {method} d{cvp_dim}",
            lambda **kw: closest_vector(
                b.copy(), target, method=method if "device" in kw else 0,
                **kw), device, ("f64",))
        rec.update(status=(sc, sh), dist_card=cvp_dist(xc),
                   dist_host_fast_method=cvp_dist(xh), offset_bound=R,
                   gaussian_heuristic=gh)
        log("svp-cvp " + json.dumps(rec))
        assert sc == sh == 0 and \
            rec["dist_card"] == rec["dist_host_fast_method"], rec
        if method == CVPM_PROVED:
            assert rec["card"]["resets_on_card"] > 0, "no reset on the card"
        recs.append(rec)

    # dual SVP: the dual length, a float. The card runs the dual tree in
    # f32 (a FastEvaluator search, as in the JAX package), so the length
    # it reports carries f32 rounding; the length of its vector,
    # recomputed in f64, must be the host's (both reported in the
    # evaluator's scale, the recomputed ones in the basis')
    (sc, _, ec, _), (sh, _, eh, _), rec = card_and_host(
        f"dual SVP d{cvp_dim}",
        lambda **kw: shortest_vector_ex(b.copy(), flags=SVP_DUAL, **kw),
        device, ("f32-dual",))
    lc, lh = dual_length(b, ec.begin()[1]), dual_length(b, eh.begin()[1])
    rec.update(status=(sc, sh), length_card=lc, length_host=lh,
               reported_card=ec.begin()[0], reported_host=eh.begin()[0])
    log("svp-cvp " + json.dumps(rec))
    assert sc == sh == 0 and abs(lc - lh) <= PHASE5_RTOL * lh, rec
    assert abs(rec["reported_card"] - rec["reported_host"]) <= \
        F32_DIST_TOL * rec["reported_host"], rec
    recs.append(rec)

    # sub-solutions: each record is a passing node (its recomputed
    # partial distance) and no longer than the shortest nonzero vector of
    # its level's projected lattice where that one lies inside the
    # search's final bound, where an unpruned search must have visited it
    # (the C core finds that vector, one SVP per level)
    t0 = time.perf_counter()
    with PathSpy() as card:
        sc, xc, ev = shortest_vector_pruning(b.copy(), [], find_subsols=True,
                                             device=device)
    card_s = time.perf_counter() - t0
    assert card.launches.get("f64-subsols", 0) > 0, card.launches
    lam = math.ldexp(sum(v * v for v in lattice_point(b, xc)), -normexp)
    t0 = time.perf_counter()
    worst, below, checked = 0.0, 0, 0
    for lvl, (dist, vec) in enumerate(ev.sub_solutions):
        if not vec:
            continue
        checked += 1
        x = np.asarray(vec, dtype=np.float64)
        assert np.all(x[:lvl] == 0), lvl
        rec_n = math.ldexp(dist, -normexp)
        true = partial_dist(x, mut, rdiag, lvl)
        worst = max(worst, abs(true - rec_n) / true)
        assert abs(true - rec_n) <= PHASE5_RTOL * true, (lvl, true, rec_n)
        best = float(native_enumerate(
            np.ascontiguousarray(mut[lvl:, lvl:]), rdiag[lvl:].copy(), None,
            None, rdiag[lvl] * (1 + 1e-9), True, False, False)[1])
        assert rec_n >= best * (1 - PHASE5_RTOL), (lvl, rec_n, best)
        if best <= lam * (1 + PHASE5_RTOL):
            below += 1
            assert rec_n <= best * (1 + PHASE5_RTOL), (lvl, rec_n, best)
    rec = {"case": f"sub-solutions d{cvp_dim}", "card": card.record(card_s),
           "host_level_svps_s": time.perf_counter() - t0,
           "levels_recorded": checked, "levels_inside_final_bound": below,
           "worst_record_rel_err": worst, "status": sc}
    log("svp-cvp " + json.dumps(rec))
    assert sc == 0 and checked > 0 and below > 0, rec
    recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 1: the build's instances
# ---------------------------------------------------------------------------
# registers of the six f32 instances of BKZ-2.0, (M, SMEM) -> registers,
# as the source compiled them before the element type became a template
# parameter, with the flags of kernels.build_kernel (no stack frame, no
# spills; the nvcc release is printed beside them): a change to the
# shared walk must leave them as they were
BKZ_F32_PTXAS = {(32, False): 61, (32, True): 64, (64, False): 72,
                 (64, True): 64, (128, False): 80, (128, True): 80}
def ptxas_instances(build_log: str) -> dict:
    """Per instance of enum_chunk_kernel (f32 primal) and
    enum_chunk_ext_kernel in nvcc's `-Xptxas -v` output: (element type, M,
    W, SMEM, extended walk) -> (registers, stack frame, spill stores,
    spill loads)."""
    out, key = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            t = re.match(r"_Z\d+enum_chunk_kernelILi(\d+)ELi(\d+)ELb([01])E",
                         m.group(1))
            e = re.match(r"_Z\d+enum_chunk_ext_kernelI([fd])Li(\d+)ELi"
                         r"(\d+)E", m.group(1))
            key = None
            if t is not None:
                key = ("float", int(t.group(1)), int(t.group(2)),
                       t.group(3) == "1", False)
            if e is not None:
                key = ("double" if e.group(1) == "d" else "float",
                       int(e.group(2)), int(e.group(3)), True, True)
            if key is not None:
                out.setdefault(key, [None, None, None, None])
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[key][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_build() -> dict:
    """Phase 1: build the kernel, print every instance's registers, stack
    frame and spills, and assert the instance set (the six f32 instances
    of BKZ-2.0, M x SMEM, and the extended walk per element type and M),
    that nothing spills, and that the six f32 instances compile to the
    registers of BKZ_F32_PTXAS."""
    from fplll_tpu_torch.enum import kernels

    t0 = time.perf_counter()
    kernels.build_kernel()
    build_s = time.perf_counter() - t0
    release = subprocess.run([kernels._nvcc(), "--version"],
                             capture_output=True, text=True).stdout
    log(f"build enum_chunk.cu (nvcc {release.strip().splitlines()[-1]}): "
        f"{build_s:.3f} s")
    for line in kernels.BUILD_LOG.strip().splitlines():
        log(f"  ptxas: {line.strip()}")
    inst = ptxas_instances(kernels.BUILD_LOG)
    log("ptxas: (type, M, W, SMEM, extended) -> (registers, stack frame, "
        "spill stores, spill loads): " + json.dumps(
            {str(k): v for k, v in sorted(inst.items())}))
    bkz = {("float", M, 32, sm, False): (regs, 0, 0, 0)
           for (M, sm), regs in BKZ_F32_PTXAS.items()}
    ext = {(t, M, 32, True, True) for t in ("float", "double")
           for M in (32, 64, 128)}
    assert set(inst) == set(bkz) | ext, f"instances {sorted(inst)}"
    assert all(v[1] == v[2] == v[3] == 0 for v in inst.values()), \
        "an instance has a stack frame or spills"
    for k, v in bkz.items():
        assert inst[k] == v, f"{k}: {inst[k]} against {v}"
    return {"nvcc_s": build_s, "instances": len(inst)}


def extended_entries(ext_recs, svp_recs) -> list:
    """The `kernels` line's entry of each form of the proved solvers: its
    phase-2 numbers (count mode, and search mode where it ran) and its
    launches on phase 5's path."""
    launches = {}
    for r in svp_recs:
        for form, n in r["card"]["launches"].items():
            launches[form] = launches.get(form, 0) + n
    entries = []
    for form in dict.fromkeys(r["form"] for r in ext_recs):
        by_mode = {r["mode"]: r for r in ext_recs if r["form"] == form}
        c = by_mode["count"]
        elem = "double" if form.startswith("f64") else "float"
        walk = ", ".join(w for w in ("dual" if "dual" in form else "",
                                     "findsubsols" if "subsols" in form
                                     else "") if w) or "primal"
        entries.append({
            "name": f"enum_chunk_ext_kernel<{elem}, M, 32> {form}",
            "route": "cuda",
            "source": "fplll_tpu_torch/csrc/enum_chunk.cu",
            "replaces": f"fplll_tpu/enum/tpu.py:213 (_enum_run, {elem} "
                        f"{walk})",
            "launches": launches.get(form, 0),
            "max_abs_err": max(r["max_abs_err"] for r in by_mode.values()),
            "ms": c["kernel_ms"],
            "ms_search": by_mode["search"]["kernel_ms"]
            if "search" in by_mode else None,
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "native_ms": c["native_ms"],
            "check": "pass",
            "tolerance": "count mode: per-level nodes, solution count and "
                         "sub-solution distances exactly equal; best "
                         "distance bit-equal",
            "shape": {k: c[k] for k in ("dim", "m", "m_real", "nfix", "R",
                                        "R_real")},
            "geometry": {k: c[k] for k in (
                "walkers", "grid", "longest_walker_walk",
                "longest_root_walk")},
        })
    return entries


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
    phase_build()
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
    ext_recs = phase_extended_checks(device)
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

    # -- phase 5: SVP and CVP through the public functions ------------------
    t0 = time.perf_counter()
    svp_recs = phase_svp_cvp(device)
    log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")

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
        "shape": {k: timing[k] for k in ("m", "m_real", "nfix", "R", "R_real",
                                         "B")},
        "geometry": {k: timing[k] for k in (
            "walkers", "W", "M", "grid", "blocks_per_sm", "sms",
            "longest_walker_walk", "longest_root_walk")},
    }] + extended_entries(ext_recs, svp_recs)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
