#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernel.

    python3 chip_smoke.py              # every phase; needs one CUDA card

Phases (each one fails the run if it fails):
  1. report the card, build the CUDA kernels, one nvcc per source started
     together (the enumeration kernel's every template instance and the
     pruner's gradient kernel, `-Xptxas -v` printed; the enumeration's
     instances without stack or spills, its six f32 instances of BKZ-2.0
     at the registers recorded in BKZ_F32_PTXAS; the registers, blocks
     per SM and walkers at M = 32, 64 and 128 of the f64 primal instance
     and of the dual, sub-solution, combined (dual with sub-solutions)
     and extended instances of both element types, the f64 primal, f64
     dual and f64 combined ones at two blocks per SM or more at M <= 64)
     and the native C cores;
  2. the kernel against its plain PyTorch version on the card, for each
     launch form (root queue, with the plain version at 1024 and 16384
     lanes, a single root with nfix = 0) in count and search mode, a
     search whose bound shrinks several times, and the grouped form as a
     block-60 tour launches it (three rerandomized trials of one window,
     padded to G = 4, m = 64); the same count at the persistent grid and
     at a grid of one block; the shrinking-bound search's overhead over
     several lattices; per form the walkers' donations, busy share,
     longest work-item walk and barren-descend skips;
  3. the main path: BKZ-2.0 with the shipped strategies on a dim-80 q-ary
     basis after a 40 -> 50 warm-up, one block-60 tour with the device
     crossover at FPLLL_TPU_HYBRID_NODES=2000000 (every launch on the
     persistent grid, blocks per SM times SMs; every window answer's f32
     distance against its f64 norm), then the same tour on the host C
     core alone;
  4. one block-60 window (pruned, f32) through DeviceEnumerator and the
     native C core, each answer certified by the other implementation,
     and the f32 answers' excess over their exact norms (the bound slack
     is 1e-5);
  5. proved SVP (d = 56), fast and proved CVP, dual SVP, dual SVP with
     sub-solutions and sub-solutions (d = 50) on BKZ-20-reduced
     gen_intrel bases through the port's public functions, each against
     the same call host-only (the dual SVP with sub-solutions against
     the host-only dual SVP, its records against the C core's per-level
     dual SVPs); the dual SVP also on the dual and the extended instance
     in turns, the dual SVP with sub-solutions on the combined and the
     extended instance;
  6. the user surfaces: `latticegen r d 10d` into `fplll -a svp` and
     `-a cvp` (in this process and, for the SVP, as a pipeline of two
     processes); the pruner's gradient kernel against its plain version
     on the card and on CPU tensors (d = 2 to 30, both metrics, SVP and
     CVP symmetry, a clip and a non-finite case) and timed at d = 30;
     `fplll -a pru -pruend 40` and `-pruend 60` (d = 20 and 30) with the
     gradient on the card (one kernel launch per gradient), on CPU
     tensors and by the host's numerical scheme; the fpylll veneer's SVP,
     Pruning.run and a pruned Enumeration; and the device GSO at d = 400
     and 800; each answer certified by the host route;
  7. the mesh (parallel/mesh.py) over four shards, one per card where
     several are visible, else four streams of the one card: a count
     tree with the single card's counts (to the Pallas tolerance: both
     donate), a falling-bound search, a skewed tree on which drained
     shards steal, phase 5's proved SVP in f64 through the public
     function, and phase 2's grouped trials one per shard (f64); each
     wall beside the same work on one card. Phases 3, 5 and 7 print their
     walls beside the ones recorded before the donation;
  8. the variant reductions through the port's entry points at the
     default crossovers (the facade's 2M, the C tour's 60M), each with
     the card and host-only, six legs in processes of their own: the
     host-only ones start after phase 1 and run beside phases 2-7
     without the card, SD-BKZ's card leg once phase 2's kernels have
     run, beside phase 2's checks against the plain version and phases
     3-7, the other card legs after phase 7, with phase 2's grouped
     plain check beside them: one self-dual BKZ
     tour at block 60 on phase 3's warm-up basis (bkz_reduction), one loop of
     slide reduction at block 60 on an LLL-reduced dim-120 q-ary basis
     (`fplll -a sld`), and HKZ on phase 5's proved-SVP basis (`fplll -a
     hkz`); the first two launch `single` and `f32-dual` (pruned
     windows) and keep 95% of the host-only run's root-Hermite gain, HKZ
     launches `f64` alone (unpruned windows), every answer within 1e-9
     of its f64 norm and certified by the f64 C core, and gives phase
     5's proved norm and the host-only run's profile; per run the
     launches per form, the windows sent to the card against those the
     native first pass finished, the device node share and every card
     answer's distance against its f64 norm, f32 and f64 answers apart.

Trees run in f64 where the search is unpruned or certified, in f32 where
it is pruned (enum/device.py:tree_dtype): phase 3's tour launches `single`
and `grouped` alone, phases 5 and 6 the f64 forms (the dual SVP
`f64-dual`, with sub-solutions `f64-dual-subsols`), phase 6's pruned
Enumeration `single`. Phases 4-7 run the
facade at its default, native first pass included (bkz_tour puts the
environment back as it found it).

    python3 chip_smoke.py --mesh       # phases 1 and 7 alone (several
                                       # cards)
    python3 chip_smoke.py --variants   # phases 1 and 8 alone, on the
                                       # inputs phases 3 and 5 would make
                                       # (all six legs run together)
    python3 chip_smoke.py --variant-leg RUN LEG DEVICE
        # one of phase 8's legs in this process (RUN sd-bkz, slide or
        # hkz; LEG card or host), its record as a VARIANT_LEG line
    python3 chip_smoke.py --pruner-ab DIR [DIR ...]
        # the pruner's gradient kernel of other checkouts (e.g. a `git
        # archive` of the parent) and of this one, in turns (DIR, this,
        # this, DIR), each in a process of its own that imports that
        # checkout's package: its build and ptxas line, then this
        # script's checks against the plain version and its d = 30
        # timing, so that every checkout is measured the same way

Phase 2 also holds the f64, dual, sub-solution and combined forms of
the kernel against the plain version, each on its own instance
(enum_chunk_f64_kernel, enum_chunk_dual_kernel,
enum_chunk_subsols_kernel, enum_chunk_dual_subsols_kernel, with the
lookahead); the same trees also run on the extended instance
(kernels._enum_run_extended), in turns on one card: phase 2's d = 40
trees (with each instance's ns per step at a grid of one block and
latency floor); phase 5's proved SVP (f64), its dual SVP (f64-dual,
d = 50, or the proved-SVP basis's where the d = 50 kernel takes no more
than DUAL_TREE_MS) and its dual SVP with sub-solutions
(f64-dual-subsols, d = 50); phase 8's HKZ windows, recorded by its card leg and
replayed once both HKZ card legs have reduced, beside the SD-BKZ and
slide card legs; and the `f32-dual` launches of SD-BKZ's card leg,
recorded there and replayed once phase 8 has collected its legs. The
second HKZ card leg (the repeat leg, started once the first has reduced)
hands its window lists for comparison with the first's.

The line before the last is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}. Imports only torch, numpy
and the port (fplll_tpu_torch); builds everything from the checkout.
"""

from __future__ import annotations

import functools
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
H100_F64_TC_FLOPS = 67e12    # f64 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12     # HBM3 rate, H100 SXM data sheet
CROSSOVER = 2_000_000        # estimated nodes; windows above it go to the card
# recorded times of the kernel before the walker redesign, one thread
# per lane (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6): printed
# for comparison on a line of their own, never as this run's measurements
LANE_KERNEL_RECORDED_MS = {"queue d56 count": 108.47,
                           "grouped G=3 (G=4) d60 search": 57.91}
# walls recorded before the donation and the lookahead (PR 5's final
# tree, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 5 and table
# X3), printed beside this run's, never as this run's measurements
PR5_RECORDED_WALLS_S = {
    "phase 3: block-60 tour with the card": 8.46,
    "phase 5: proved SVP d56": 1.55, "phase 5: CVP method 0 d50": 0.25,
    "phase 5: CVP method 2 d50": 36.56, "phase 5: dual SVP d50": 1.52,
    # phase 7: [mesh, one card]
    "phase 7: count d56 r0.85": [0.083, 0.034],
    "phase 7: search d40 r1.3": [0.043, 0.033],
    "phase 7: skewed q-ary count d40 r1.2": [0.176, 0.125],
    "phase 7: proved SVP d56 seed 29 (f64, facade)": [1.665, 1.548],
    "phase 7: grouped trials G=3 block 60 (mesh_enumerate_trials)":
        [0.096, 0.053]}


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
    """Count mode: the tolerances of tests/test_pallas_parity.py:164-175
    (the kernel's donation and lookahead skip or re-derive f32 round
    trips, so marginal bound tests may flip); returns whether the
    per-level counts are also exactly equal."""
    import numpy as np
    kn = k_out["nodes"].cpu().numpy()[:m_real].astype(np.float64)
    pn = p_out["nodes"].cpu().numpy()[:m_real].astype(np.float64)
    ks, ps = int(k_out["sol_count"]), int(p_out["sol_count"])
    assert ks == ps, f"{name}: solution counts {ks} vs {ps}"
    kb, pb = float(k_out["best_dist"][0]), float(p_out["best_dist"][0])
    assert_best(name, kb, pb)
    assert_nodes_close(name, kn, pn)
    return bool(np.array_equal(kn, pn)), kn.sum()


def assert_nodes_close(name, kn, pn) -> None:
    """Per-level nodes to tests/test_pallas_parity.py:164-175: the total
    to 1%, levels above 200 nodes to 2%."""
    import numpy as np
    kn = np.asarray(kn, dtype=np.float64)
    pn = np.asarray(pn, dtype=np.float64)
    assert abs(kn.sum() - pn.sum()) <= 0.01 * pn.sum(), \
        f"{name}: total nodes {kn.sum()} vs {pn.sum()}"
    for lvl, (a, b) in enumerate(zip(kn, pn)):
        if max(a, b) > 200:
            assert abs(a - b) <= 0.02 * max(a, b), \
                f"{name}: level {lvl} nodes {a} vs {b}"


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
# to 0.7 of the shortest basis vector so that the plain version, which
# runs one lockstep step per node of the longest lane walk, finishes in
# seconds on the card (at 0.85 it took 85-88 s, time phase 8 needs). The
# kernel alone is also timed at D56_KERNEL_RADIUS, the radius of its
# recorded times. At these radii a search finds nothing, so the case
# runs in count mode only; search mode is held by the d40 cases and by
# the shrinking-bound check. The 16384-lane case is the form the TPU
# split into lane tiles: the same roots as "queue d40" with the plain
# version over 16 times the lanes (the kernel's walkers are set by the
# card, so its launch is the queue form's).
BOTH = (True, False)
CHECK_CASES = [("queue d40 pruned", 40, 3, True, 1.0, False, 1024, BOTH),
               ("queue d40", 40, 3, False, 1.0, False, 1024, BOTH),
               ("lanes d40", 40, 3, False, 1.0, False, 16384, BOTH),
               ("queue d56", 56, 4, False, 0.7, False, 1024, (True,)),
               ("nfix0 d24", 24, 1, False, 1.0, True, 1024, BOTH)]
TIMED_CASE = "queue d56"
D56_KERNEL_RADIUS = 0.85
# the shrinking-bound search: the "queue d40" lattice at 1.3 times the
# squared norm of its shortest basis vector, a ball that holds 30 vectors
SHRINK_CASE = ("shrink d40 r1.3", 40, 3, 1.3)
# search-mode nodes at most this multiple of the count-mode nodes at the
# final bound (the walk's extra work while the bound was still falling).
# The ratio is set by the lattice, the number of walkers, which all start
# at the first radius, and how soon they re-read the falling bound: on an
# H100 at 3,168 walkers the kernel's ratio on this lattice lay within
# 1.26-1.43 over 300 launches with the bound re-read every 4 iterations
# (1.32-1.54, 16 launches of 300 above this limit, when it was re-read
# every 32; tools/torch_shrink_spread.py); a search that never lowered
# its bound would give the start radius' 11.6
SHRINK_TOL = 1.5
# other lattices of the shrink check's shape, whose kernel search overhead
# is logged, not asserted: it ranges more widely than on the checked one
SHRINK_SPREAD_SEEDS = tuple(range(5, 14))
# relative error of a distance the kernel computes in f32 against the
# exact norm of its vector: the center sums drift over a lane's
# subtract/restore round trips (8.8e-5 measured on the block-60 window
# of phase 4)
F32_DIST_TOL = 2e-4
# the same for an f64 tree (every unpruned search: enum/device.py
# tree_dtype): its distances must sit within this of the f64 norm
F64_DIST_TOL = 1e-9
# the grouped check's radius, times the union best: keeps the plain
# version, which walks the three trials one after another, near a minute
GROUPED_RADIUS = 1.015
# the radius of the grouped check's earlier, larger tree; the kernel alone
# is also timed there, beside the times recorded at it (PERF.md section 6)
GROUPED_TIMED_RADIUS = 1.03


def geometry_fields(out) -> dict:
    """The launch geometry and walk counters of one kernel run, for the
    kernel-check lines: the longest walk of a walker and of one work item
    (a root or a donated sibling range), the walkers' busy share
    (iterations of all walkers over walkers x the longest walk), the
    sibling ranges donated and the descends the lookahead skipped."""
    geo = out["geometry"]
    steps, walk = int(out["steps"]), int(out["walk_steps"])
    return {"walkers": geo["walkers"], "W": geo["width"], "M": geo["M"],
            "grid": geo["grid"], "blocks_per_sm": geo["blocks_per_sm"],
            "sms": geo["sms"], "smem": geo["smem"],
            "longest_walker_walk": steps,
            "longest_item_walk": int(out["root_steps"]),
            "walk_steps": walk,
            "busy_share": walk / (geo["walkers"] * steps) if steps else 0.0,
            "donations": int(out["donations"]),
            "barren_skips": int(out["barren_skips"])}


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
    """Phase 2's kernel runs: every case's kernel timings and the checks
    that need no plain version. Returns the per-form records, the checks
    against the plain version still to run (calls that fill their
    records' plain fields, log them and return the best-distance
    difference: the smoke runs them once every kernel of phase 2 has been
    timed, beside phase 8's SD-BKZ card leg), the timing record of the
    main-path shape and the grouped form's check against its plain
    version (grouped_check), run later still. The size parameters let it
    be rehearsed small; the script runs the defaults."""
    from fplll_tpu_torch.enum import kernels

    forms, checks, timing = [], [], None
    for name, d, seed, pruned, radius, nfix0, lanes, modes in cases:
        _, mut, rdiag, prune, A, _ = uniform_window(d, seed, pruned, radius)
        pack = packed_problem(mut, rdiag, prune, A, device, nfix0=nfix0)
        mr = pack["m_real"]
        for count_mode in modes:
            kw = dict(is_svp=True, count_mode=count_mode, batch=lanes,
                      max_steps=1 << 30)
            k_out, k_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw))
            mode = "count" if count_mode else "search"
            total = float(k_out["nodes"][:mr].sum())
            rec = {"form": name, "mode": mode, "m": pack["m"], "m_real": mr,
                   "nfix": pack["roots_x"].shape[1],
                   "R": pack["roots_x"].shape[0], "B": lanes,
                   "kernel_ms": k_ms, "nodes": total,
                   "nodes_per_s": total / (k_ms * 1e-3),
                   "best": float(k_out["best_dist"][0]),
                   **geometry_fields(k_out)}
            rec["bound_ms"], rec["bound_by"], (rec["R_real"],) = bound_ms(
                pack, k_out["nodes"], len(k_out["best_dist"]), d, [mr])
            if name == TIMED_CASE and count_mode:
                timing = rec
                rec["us_per_step"] = k_ms * 1e3 / rec["longest_walker_walk"]
                rec["grid_1_block"] = grid_check(name, pack, kw, k_out, mr)
                wide = packed_problem(*uniform_window(
                    d, seed, pruned, D56_KERNEL_RADIUS)[1:5], device)
                rec[f"kernel_ms_at_{D56_KERNEL_RADIUS}"] = wrapper_ms(
                    lambda: kernels.enum_run(**wide, **kw))[1]
            forms.append(rec)
            checks.append(functools.partial(
                form_plain_check, rec, pack, kw, k_out, (mut, rdiag, prune,
                                                         A)))

    rec, check = shrink_check(device, *shrink)
    forms.append(rec)
    checks.append(check)
    rec, grouped_plain = grouped_check(device, *grouped)
    forms.append(rec)
    return forms, checks, timing, grouped_plain


def form_plain_check(rec, pack, kw, k_out, tree) -> float:
    """One phase-2 case against its plain version on the same tensors
    (count mode: compare_counts' tolerances; both modes: the best
    distance), with the C core's time on the same tree; fills the
    record's plain fields, logs it and returns the best-distance
    difference."""
    import torch
    from fplll_tpu_torch.enum import kernels

    name, mode, mr = rec["form"], rec["mode"], rec["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    p_out, p_s = timed(lambda: kernels.enum_run_plain(**plain_args, **kw),
                       torch.cuda.synchronize)
    n_ms, n_nodes, _ = native_ms(*tree, kw["count_mode"])
    exact = compare_counts(f"{name} {mode}", k_out, p_out, mr)[0] \
        if kw["count_mode"] else None
    err = assert_best(f"{name} {mode}", rec["best"],
                      float(p_out["best_dist"][0]))
    rec.update(plain_ms=p_s * 1e3, native_ms=n_ms, native_nodes=n_nodes,
               counts_exact=exact, plain_steps=int(p_out["steps"]))
    log("kernel-check " + json.dumps(rec))
    return err


def grid_check(name, pack, kw, k_out, m_real) -> dict:
    """The same count-mode problem on a grid of one block: per-level node
    counts and the solution count those of the persistent grid, to the
    tolerance of compare_counts (both grids donate, each with its own
    splits). Its time over its longest walker walk is the time of one
    step with few walkers per SM."""
    from fplll_tpu_torch.enum import kernels

    one, one_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw, grid=1),
                             reps=1)
    assert one["geometry"]["grid"] == 1
    exact, _ = compare_counts(f"{name} at grid 1", one, k_out, m_real)
    return {"walkers": one["geometry"]["walkers"], "counts_identical": exact,
            "kernel_ms": one_ms, "longest_walker_walk": int(one["steps"]),
            "donations": int(one["donations"]),
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
    once. The kernel's best must lie well inside the start radius; its
    search-mode nodes must lie between its count-mode nodes at the final
    bound and SHRINK_TOL times those, while the tree at the start radius
    holds at least 3 times more (so a kernel that ignored search mode, or
    never re-read or lowered the bound, fails). The kernel's ratio is
    also logged, not asserted, on the lattices of `spread`. Returns the
    record and its check against the plain version, still to run (as
    phase_kernel_checks' are): the same best, the count at the final
    bound equal per level, and the plain search's nodes inside the same
    limits."""
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
    kb = float(k_s["best_dist"][0])
    assert math.isfinite(kb), f"{name}: the search found nothing"
    assert kb <= 0.9 * A, f"{name}: best {kb} not inside the radius {A}"
    final = dict(pack, A0=kb * 1.00001)     # the bound slack of the path
    k_f = kernels.enum_run(**final, count_mode=True, **kw)
    n_final = float(k_f["nodes"][:mr].sum())
    n_start = float(kernels.enum_run(**pack, count_mode=True,
                                     **kw)["nodes"][:mr].sum())
    n_k = float(k_s["nodes"][:mr].sum())
    rec = {"form": name, "mode": "search", "m": pack["m"], "m_real": mr,
           "B": 1024, "kernel_ms": k_ms, "best": kb, "radius": A,
           "nodes": n_k, "count_nodes_final_bound": n_final,
           "count_nodes_start_radius": n_start,
           "search_over_final": n_k / n_final, **geometry_fields(k_s)}
    rec["search_over_final_by_seed"] = {seed: n_k / n_final, **{
        s: kernel_search_overhead(device, d, s, radius) for s in spread}}
    assert n_start >= 3 * n_final, f"{name}: the check cannot tell " \
        f"({n_start} nodes at the start radius, {n_final} at the end)"

    def within(who, n):
        assert n_final * (1 - 1e-3) <= n <= SHRINK_TOL * n_final, \
            f"{name}: {who} search nodes {n} against {n_final} at the " \
            "final bound"
    within("kernel", n_k)

    def plain_check() -> float:
        p_s, p_t = timed(lambda: plain(pack, False), torch.cuda.synchronize)
        err = assert_best(f"{name} search", kb, float(p_s["best_dist"][0]))
        exact, _ = compare_counts(f"{name} count at the final bound", k_f,
                                  plain(final, True), mr)
        n_p = float(p_s["nodes"][:mr].sum())
        rec.update(plain_ms=p_t * 1e3, plain_nodes=n_p,
                   counts_exact_final_bound=exact)
        log("kernel-check " + json.dumps(rec))
        within("plain", n_p)
        return err
    return rec, plain_check


@functools.lru_cache(maxsize=None)
def grouped_trials(device, dim=80, block=60, trials=3) -> dict:
    """The grouped trials of a block-60 window, built the way the C tour
    builds them (bkz_core.c:grouped_trials_c): the [0, block) window of
    the dim-80 q-ary basis after the 40 -> 50 warm-up; trial 0 as it
    stands, each other trial rerandomized below its first row (as
    rerandomize_block) and preprocessed by one BKZ tour at the block-60
    strategy's preprocessing block size; all with the block-60 strategy's
    pruning. Returns their (mu^T, r), bases and pruning, and the union
    best, which the C core finds first at the tour's radius (min(0.99 r_0,
    1.1 GH)). Built once per process (phases 2 and 7 share it).

    Under pruning, which vector a search returns can depend on the order
    in which its bound falls. The C core shows that here it cannot: a
    trial that still finds the union best at 1 + 1e-5 times its norm
    finds it under every bound a search can hold before, so the kernel
    and the plain version must both return it."""
    import random
    import numpy as np
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
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
    return {"muts": np.stack(muts), "rdiags": np.stack(rdiags),
            "prunes": np.stack([prune] * trials), "bases": bases,
            "normexp": exps[0], "union_best_c": best,
            "trial_best_c": [float(f[1]) for f in found],
            "certified": certified, "native_ms": native_s * 1e3,
            "native_nodes": sum(float(f[4].sum()) for f in found)}


def grouped_window_problem(device, dim=80, block=60, radius=GROUPED_RADIUS,
                           trials=3):
    """grouped_trials packed by the grouped window path's own packing
    (G_real = 3 problems padded to G = 4, height m = 64) at `radius` times
    the union best."""
    import numpy as np
    from fplll_tpu_torch.enum.device import _pack_grouped

    gt = grouped_trials(device, dim, block, trials)

    def pack(r):
        return _pack_grouped(gt["muts"], gt["rdiags"], gt["prunes"],
                             np.full(trials, gt["union_best_c"] * r), device,
                             1024)

    tensors, m_reals, _ = pack(radius)
    return {**gt, "tensors": tensors, "m_reals": [int(v) for v in m_reals],
            "pack": pack, "radius": gt["union_best_c"] * radius}


def exact_norm(basis, coeffs) -> int:
    """The squared norm of sum_i coeffs[i] * basis row i, in integers."""
    x = [int(round(float(c))) for c in coeffs]
    v = [sum(x[i] * int(basis.a[i][c]) for i in range(len(x)) if x[i])
         for c in range(basis.ncols)]
    return sum(c * c for c in v)


def grouped_check(device, dim, block, radius):
    """The grouped form at the main path's shape: padding problem empty,
    the shared bound ending at the union best, and the kernel's vector
    verified in exact integers: its norm is the C core's union best.
    Returns its record and the check against the plain version (equal
    union best, padding problem empty), a call that fills the record's
    plain fields and returns the best-distance difference: the plain
    version walks the three trials one after another for about two
    minutes, so the smoke runs it beside phase 8's card legs."""
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
    kdist = k_out["dist"].cpu()
    kd = float(kdist[:G_real].min())
    assert math.isfinite(kd), "grouped: the kernel found no vector"
    assert math.isinf(float(kdist[G_real:].min())), "a padding problem found"
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
           "kernel_ms": k_ms, "nodes": nodes,
           "nodes_per_s": nodes / (k_ms * 1e-3),
           "native_ms": gp["native_ms"], "native_nodes": gp["native_nodes"],
           "radius": gp["radius"], "union_best": kd,
           "c_core_union_best": gp["union_best_c"],
           "c_core_trial_best": gp["trial_best_c"],
           "certified_trials": gp["certified"], "exact_norm": exact,
           "shared_bound": float(k_out["bound"]),
           f"kernel_ms_at_{GROUPED_TIMED_RADIUS}": wide_ms,
           **geometry_fields(k_out)}
    rec["bound_ms"], rec["bound_by"], rec["R_real"] = bound_ms(
        t, k_out["nodes"], G, block, gp["m_reals"])
    log("kernel-check " + json.dumps(rec))

    def plain_check() -> float:
        plain_args = {k: v for k, v in t.items() if k != "m_real"}
        p_out, p_s = timed(lambda: kernels.enum_run_grouped_plain(
            **plain_args, **kw), torch.cuda.synchronize)
        pdist = p_out["dist"].cpu()
        pd = float(pdist[:G_real].min())
        err = assert_best("grouped union best", kd, pd)
        assert math.isinf(float(pdist[G_real:].min())), \
            "a padding problem found by the plain version"
        rec.update(plain_ms=p_s * 1e3, plain_union_best=pd,
                   plain_steps=int(p_out["steps"]))
        log(f"kernel-check {name} against the plain version, beside phase "
            "8's card legs " + json.dumps({k: rec[k] for k in (
                "union_best", "plain_union_best", "plain_ms",
                "plain_steps")}))
        return err
    return rec, plain_check


# the forms of the proved SVP/CVP solvers: (form, element type, dual,
# sub-solutions, dim, seed, modes), each against its plain version at the
# main path's launch shape (m = 64, nfix = 16, R = 32768). The primal
# trees are the "queue d40" window (0.22 M nodes in the C core); the dual
# ones the seed-4 window's dual tree at its longest 1/r_ii (0.22 M nodes
# too), so each plain run takes seconds. Sub-solutions run in count mode,
# where the records do not depend on timing.
# relative difference from the plain version of a best or record
# distance where the launch donated (an adoptee re-derives its center
# sums); 0 where it did not
EXT_RTOL = {"f64": 1e-12, "f32": 1e-6}
EXT_CASES = [("f64", "f64", False, False, 40, 3, BOTH),
             ("f32-dual", "f32", True, False, 40, 4, BOTH),
             ("f64-dual", "f64", True, False, 40, 4, BOTH),
             ("f32-subsols", "f32", False, True, 40, 3, (True,)),
             ("f64-subsols", "f64", False, True, 40, 3, (True,)),
             ("f32-dual-subsols", "f32", True, True, 40, 4, (True,)),
             ("f64-dual-subsols", "f64", True, True, 40, 4, (True,))]


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


# the instance each form of the proved solvers launches, beside which
# phase 2 runs the same tree on the extended one: the label its numbers
# carry in the kernels line
INSTANCE_OF = {"f64": "f64 primal", "f32-dual": "dual", "f64-dual": "dual",
               "f32-subsols": "subsols", "f64-subsols": "subsols",
               "f32-dual-subsols": "dual-subsols",
               "f64-dual-subsols": "dual-subsols"}


def both_instances(name, form, pack, kw, k_ms, m_real):
    """The tree of one extended check on the instance of its form
    (INSTANCE_OF: the f64 primal, dual or sub-solution instance) and on
    the extended instance, on one card, in turns: the form's instance
    (its first time is the check's kernel_ms, `k_ms`), the extended
    instance (kernels._enum_run_extended), the extended one again and
    the form's instance again, each the median of 3 CUDA-event timings of
    the wrapper. In count mode also each instance at a grid of one block:
    its ns per step (the time over the longest walker walk, with 8
    walkers on the card the latency of one step) and the latency floor of
    its persistent-grid launch, the longest work item's steps times that.
    Returns the record and its check against the plain version's output,
    still to run (phase_extended_checks): the extended instance's best
    distance and sub-solution distances to EXT_RTOL of the plain
    version's, which walks with the lookahead (the two walks round trip
    the center sums at different nodes), in count mode the counts to
    compare_counts' tolerance."""
    import numpy as np
    from fplll_tpu_torch.enum import kernels

    t0 = time.perf_counter()
    new = INSTANCE_OF[form]
    rtol = EXT_RTOL[form[:3]]
    runs = {new: lambda **x: kernels.enum_run(**pack, **kw, **x),
            "extended": lambda **x: kernels._enum_run_extended(
                **pack, **kw, **x)}
    ms = {new: [k_ms], "extended": []}
    outs = {}
    for inst in ("extended", "extended", new):
        outs[inst], t = wrapper_ms(runs[inst])
        ms[inst].append(t)
    e_out = outs["extended"]
    rec = {"kernel_ms": ms,
           "extended_donations": int(e_out["donations"]),
           "extended_barren_skips": int(e_out["barren_skips"])}
    if kw["count_mode"]:
        for inst, run in runs.items():
            one, one_ms = wrapper_ms(lambda: run(grid=1), reps=1)
            ns = one_ms * 1e6 / int(one["steps"])
            rec[inst] = {
                "grid_1_block": {"kernel_ms": one_ms,
                                 "walkers": one["geometry"]["walkers"],
                                 "longest_walker_walk": int(one["steps"]),
                                 "ns_per_step": ns},
                "root_steps": int(outs[inst]["root_steps"]),
                "latency_floor_ms": int(outs[inst]["root_steps"]) * ns * 1e-6,
                "barren_skips": int(outs[inst]["barren_skips"]),
                **{k: outs[inst]["geometry"][k]
                   for k in ("walkers", "blocks_per_sm")}}
    rec["seconds"] = time.perf_counter() - t0

    def plain_check(p_out) -> None:
        kb, pb = float(e_out["best_dist"][0]), float(p_out["best_dist"][0])
        assert abs(kb - pb) <= rtol * pb, \
            f"{name} on the extended instance: best {kb} vs {pb}"
        err = abs(kb - pb)
        if "subsol_dist" in p_out and kw["count_mode"]:
            a = e_out["subsol_dist"].cpu().numpy()[:m_real]
            b = p_out["subsol_dist"].cpu().numpy()[:m_real]
            assert np.allclose(a, b, rtol=rtol, atol=0.0), \
                f"{name} on the extended instance: records {a} {b}"
            err = max(err, float(np.abs(a - b).max(initial=0.0)))
        rec["extended_best_abs_err"] = err
        if kw["count_mode"]:
            rec["extended_counts_exact"], _ = compare_counts(
                f"{name} on the extended instance", e_out, p_out, m_real)
        log(("f64-instances " if form == "f64" else "ext-instances ") +
            f"{name} " + json.dumps(rec))
    return rec, plain_check


def phase_extended_checks(device, cases=EXT_CASES):
    """Phase 2, the forms of the proved solvers: each against its plain
    version on the card with the tolerances of the CPU tests of the host
    build (tests/test_torch_enum_f64.py): where the launch donated
    nothing, count mode's per-level nodes, solution count and sub-solution
    distances exactly equal and both modes' best distances bit-equal;
    where it donated, the solution count equal, the nodes to
    compare_counts' tolerance and the distances to EXT_RTOL. The trees
    of the f64 primal, dual and sub-solution forms also run on the
    extended instance (both_instances). The kernels run here; the checks
    against the plain version are returned, still to run (as
    phase_kernel_checks' are). Returns the records, which those checks
    complete with the largest difference of the best distance or a
    sub-solution distance from the plain version's (max_abs_err), and
    the checks."""
    from fplll_tpu_torch.enum import kernels

    recs, checks = [], []
    for form, dtype, dual, subsols, d, seed, modes in cases:
        pack, tree = ext_problem(d, seed, dtype, dual, device)
        assert kernels._form(pack["mut"].dtype, dual, subsols) == form
        mr = pack["m_real"]
        for count_mode in modes:
            kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                      max_steps=1 << 30, dual=dual, findsubsols=subsols)
            k_out, k_ms = wrapper_ms(lambda: kernels.enum_run(**pack, **kw))
            mode = "count" if count_mode else "search"
            name = f"{form} d{d} {mode}"
            kb = float(k_out["best_dist"][0])
            assert math.isfinite(kb), f"{name}: nothing found"
            if count_mode:
                assert int(k_out["sol_count"]) > 0, f"{name}: no solution"
            total = float(k_out["nodes"][:mr].sum())
            rec = {"form": form, "mode": mode, "dim": d, "seed": seed,
                   "m": pack["m"], "m_real": mr,
                   "nfix": pack["roots_x"].shape[1],
                   "R": pack["roots_x"].shape[0], "B": 1024,
                   "kernel_ms": k_ms, "nodes": total,
                   "nodes_per_s": total / (k_ms * 1e-3), "best": kb,
                   **geometry_fields(k_out)}
            rec["bound_ms"], rec["bound_by"], (rec["R_real"],) = bound_ms(
                pack, k_out["nodes"], len(k_out["best_dist"]), d, [mr],
                subsols)
            both = None
            if form in INSTANCE_OF:
                rec["instances"], both = both_instances(name, form, pack, kw,
                                                        k_ms, mr)
            recs.append(rec)
            checks.append(functools.partial(
                extended_plain_check, rec, name, pack, kw, k_out, tree, dual,
                both))
    return recs, checks


def extended_plain_check(rec, name, pack, kw, k_out, tree, dual,
                         both) -> None:
    """One of phase_extended_checks' cases against its plain version on
    the same tensors, with the C core's time on the same tree (and the
    extended instance's check, `both`); fills the record's plain fields
    and max_abs_err and logs it."""
    import numpy as np
    import torch
    from fplll_tpu_torch.enum import kernels

    mr, count_mode = rec["m_real"], kw["count_mode"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    p_out, p_s = timed(lambda: kernels.enum_run_plain(**plain_args, **kw),
                       torch.cuda.synchronize)
    n_ms, n_nodes, _ = native_ms(*tree, count_mode, dual)
    kb, pb = rec["best"], float(p_out["best_dist"][0])
    err = abs(kb - pb)
    rtol = EXT_RTOL[rec["form"][:3]] if int(k_out["donations"]) else 0.0
    assert abs(kb - pb) <= rtol * pb, f"{name}: best distance {kb} vs {pb}"
    exact = None
    if count_mode:
        exact, _ = compare_counts(name, k_out, p_out, mr)
        assert exact or rtol, f"{name}: counts differ, no donation"
        if kw["findsubsols"]:
            a = k_out["subsol_dist"].cpu().numpy()[:mr]
            b = p_out["subsol_dist"].cpu().numpy()[:mr]
            fin = np.isfinite(a) & np.isfinite(b)
            err = max(err, float(np.abs(a - b)[fin].max(initial=0.0)))
            assert np.allclose(a, b, rtol=rtol, atol=0.0), \
                f"{name}: records {a} {b}"
    rec.update(plain_ms=p_s * 1e3, native_ms=n_ms, native_nodes=n_nodes,
               max_abs_err=err, counts_exact=exact,
               plain_steps=int(p_out["steps"]))
    if both is not None:
        both(p_out)
    log("kernel-check " + json.dumps(rec))


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


class HybridNodes:
    """FPLLL_TPU_HYBRID_NODES set to `value` (None: unset) inside the
    block and put back as it was after it: the C tour's device crossover,
    and the facade's native first-pass budget (where 0 means no first
    pass)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self._saved = os.environ.get("FPLLL_TPU_HYBRID_NODES")
        if self.value is None:
            os.environ.pop("FPLLL_TPU_HYBRID_NODES", None)
        else:
            os.environ["FPLLL_TPU_HYBRID_NODES"] = str(self.value)
        return self

    def __exit__(self, *exc):
        if self._saved is None:
            os.environ.pop("FPLLL_TPU_HYBRID_NODES", None)
        else:
            os.environ["FPLLL_TPU_HYBRID_NODES"] = self._saved
        return False


def bkz_tour(b, strategies, block, device, hybrid):
    """One BKZ-2.0 tour through bkz_reduction with the C tour's crossover
    at `hybrid` (the environment as it was afterwards); returns (wall s,
    nodes, device nodes, g_max, phase timers of the C tour) read from the
    BKZReduction the entry point built."""
    from fplll_tpu_torch.algs.bkz import BKZReduction, bkz_reduction
    from fplll_tpu_torch.algs.bkz_param import BKZParam
    from fplll_tpu_torch.defs import BKZ_GH_BND, BKZ_MAX_LOOPS

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
        with HybridNodes(hybrid):
            t0 = time.perf_counter()
            bkz_reduction(b, BKZParam(block, strategies,
                                      flags=BKZ_MAX_LOOPS | BKZ_GH_BND,
                                      max_loops=1), device=device)
            dt = time.perf_counter() - t0
    finally:
        BKZReduction.bkz = orig
    return dt, stats["nodes"], stats["dev"], stats["g_max"], stats["timers"]


class WindowAnswers:
    """Keeps every answer a card search hands back, through either route:
    the C tour's windows (enum/device.py:device_enumerate_windows, grouped
    trials included) and every other DeviceEnumerator search (the
    facade's): the window's f64 mu and r (dual-transformed where the
    search was dual), the reported distance, the coefficients, whether
    the search was dual, its pruning and its tree's element type ("f32"
    or "f64"), for the drift of f32 and f64 answers and the f64
    certificate, both computed after the run so that a timed run pays
    only for the copies. Also counts the card searches
    (DeviceEnumerator.enumerate, any route), their seconds and nodes, and
    the windows the C tour handed to the card, and keeps each list it
    handed (`windows`: f64 copies of muts, rdiags, prunes, maxdists and
    the distances that came back)."""

    def __enter__(self):
        import inspect

        import numpy as np
        import torch
        from fplll_tpu_torch.enum import device as device_mod

        self.kept, self.windows = [], []
        self.searches = self.search_nodes = self.c_tour_windows = 0
        self.search_s = 0.0
        windows = device_mod.device_enumerate_windows
        search = device_mod.DeviceEnumerator.enumerate
        self._saved = [(device_mod, "device_enumerate_windows", windows),
                       (device_mod.DeviceEnumerator, "enumerate", search)]
        search_args = inspect.signature(search).bind
        spy, inside = self, []

        def c_tour_windows(muts, rdiags, prunes, maxdists, device=None):
            inside.append(True)
            try:
                dists, sols, nodes = windows(muts, rdiags, prunes, maxdists,
                                             device=device)
            finally:
                inside.pop()
            spy.c_tour_windows += len(muts)
            spy.windows.append(tuple(np.array(a, dtype=np.float64) for a in (
                muts, rdiags, prunes, maxdists, dists)))
            for g in np.flatnonzero(np.isfinite(dists)):
                # the window path's rule: f64 where the window is unpruned
                # (device.tree_dtype); pruned windows and grouped trials f32
                dtype = "f64" if device_mod.tree_dtype(prunes[g]) == \
                    torch.float64 else "f32"
                spy.kept.append((np.array(muts[g], dtype=np.float64),
                                 np.array(rdiags[g], dtype=np.float64),
                                 float(dists[g]),
                                 np.array(sols[g], dtype=np.float64), False,
                                 np.array(prunes[g], dtype=np.float64),
                                 dtype))
            return dists, sols, nodes

        def card_search(*a, **kw):
            bound = search_args(*a, **kw)
            bound.apply_defaults()
            p, found = bound.arguments, []
            ev = p["evaluator"]
            eval_sol = ev.eval_sol

            def answer(x, dist, *rest):
                found.append((float(dist), [float(v) for v in x]))
                return eval_sol(x, dist, *rest)

            ev.eval_sol = answer
            t0 = time.perf_counter()
            try:
                out = search(*a, **kw)
            finally:
                spy.search_s += time.perf_counter() - t0
                del ev.eval_sol
            spy.searches += 1
            spy.search_nodes += int(np.sum(out[1]))
            if found and not inside and p["is_svp"] and not p["count_mode"]:
                dist, x = min(found)
                prune = p["prune"]
                if prune is None or len(prune) == 0:
                    prune = np.ones(len(p["rdiag"]))
                dtype = "f64" if p["self"].dtype == torch.float64 else "f32"
                spy.kept.append((np.array(p["mut"], dtype=np.float64),
                                 np.array(p["rdiag"], dtype=np.float64),
                                 dist, np.array(x), bool(p["dual"]),
                                 np.array(prune, dtype=np.float64), dtype))
            return out

        device_mod.device_enumerate_windows = c_tour_windows
        device_mod.DeviceEnumerator.enumerate = card_search
        return self

    def __exit__(self, *exc):
        for owner, name, f in reversed(self._saved):
            setattr(owner, name, f)
        return False

    def drift(self) -> dict:
        """Each answer's reported distance over its vector's norm from the
        window's f64 GSO (partial_dist; the dual recurrence where the
        answer says so), less one, for the f32 and the f64 answers apart:
        how many, how many exceed the f32 bound slack (1e-5) and the f64
        tolerance (F64_DIST_TOL), and the extremes."""
        out = {}
        for dtype in ("f32", "f64"):
            excess = [dist / partial_dist(x, mut, r, 0, dual) - 1.0
                      for mut, r, dist, x, dual, _, dt in self.kept
                      if dt == dtype]
            out[dtype] = {
                "answers": len(excess),
                "above_slack_1e-5": sum(e > 1e-5 for e in excess),
                "beyond_1e-9": sum(abs(e) > F64_DIST_TOL for e in excess),
                "largest_excess": max(excess, default=None),
                "least_excess": min(excess, default=None)}
        return out

    def certify(self) -> dict:
        """Each answer against the f64 native C core on its window: the
        same (pruned; dual where the answer is) tree searched inside the
        answer's f64 norm less 1e-9 of it. A search's bound never falls
        below its answer, so that tree holds no shorter vector unless the
        f32 walk pruned one (ROADMAP.md queue 3): how many answers were
        certified, and how many windows held a shorter vector, with its
        norm's shortfall."""
        from fplll_tpu_torch.native import native_enumerate

        certified, shorter = 0, []
        for mut, r, _, x, dual, prune, _ in self.kept:
            norm = partial_dist(x, mut, r, 0, dual)
            out = native_enumerate(mut, r, prune, None, norm * (1 - 1e-9),
                                   True, dual, False)
            if math.isfinite(out[1]):
                shorter.append(1.0 - out[1] / norm)
            else:
                certified += 1
        return {"answers": len(self.kept), "certified": certified,
                "shorter_vector_found": len(shorter),
                "largest_shortfall": max(shorter, default=None)}


def qary_warm_basis(device, dim=80, warm_blocks=(40, 50)):
    """gen_qary_bits(dim, dim / 2, 30), seed 11, LLL-reduced, then one
    BKZ-2.0 tour at each of `warm_blocks` on the host C core."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.algs.wrapper import lll_reduction
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
    return b


def phase_main_path(device, dim=80, warm_blocks=(40, 50), block=60,
                    crossover=CROSSOVER):
    """Phase 3: BKZ-2.0 on a q-ary basis, the warm-up on the host C core,
    then one tour with the device crossover and the same tour on the host
    C core alone. Sizes are parameters only so the phase can be rehearsed
    small; the script runs it at the defaults."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.enum import kernels
    from fplll_tpu_torch.nr.rng import RandGen

    b = qary_warm_basis(device, dim, warm_blocks)
    strategies = load_strategies_json("default.json")
    b_dev, b_host = b.copy(), b.copy()

    kernels.reset_launch_counts()
    RandGen.init_with_seed(12)
    with WindowAnswers() as answers:
        dev_wall, dev_total, dev_nodes, g_max, dev_timers = bkz_tour(
            b_dev, strategies, block, device, crossover)
    launches = dict(kernels.LAUNCHES)
    extended = extended_launch_count()
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
           "extended_launches": extended,
           # (grid, blocks per SM, SMs) of the tour's launches
           "grids": grids,
           "host_tour_wall_s": host_wall, "host_tour_nodes": host_total,
           "rhf_warmup_bkz50": rhf_warm, "rhf_device_tour": rhf_dev,
           "rhf_host_tour": rhf_host,
           # seconds in the C tour's phases: enum_s sequential C
           # enumeration, device_s the device callback (root generation,
           # packing, launches), lll_s in-tour LLL, misc_s the rest
           "device_tour_timers": dev_timers, "host_tour_timers": host_timers,
           "drift": answers.drift()}
    log("main-path " + json.dumps(rec))
    assert dev_nodes > 0, "no window reached the card"
    assert sum(launches.values()) > 0, "the kernel was never launched"
    # every window of the tour is pruned (default.json at block 60): the
    # f32 forms only, the one window and the grouped trials
    assert {k for k, v in launches.items() if v} <= {"single", "grouped"}, \
        f"the block-60 tour launched another form: {launches}"
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
    # the f32 drift (ROADMAP.md queue 3, "Not faults"): each answer's reported
    # distance over its vector's exact norm, against the 1e-5 bound slack
    excess = [r[2] / math.ldexp(exact_norm(b, r[3]), -normexp) - 1.0
              for r in runs]
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
           "f32_excess_over_exact_norm": excess,
           "f32_largest_excess": max(excess),
           "answers_beyond_slack_1e-5": sum(abs(e) > 1e-5 for e in excess),
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


def extended_launch_count() -> int:
    """Launches of the extended instance (kernels._enum_run_extended)
    since the counts were last zeroed: none on a path, where every form
    runs its own instance."""
    from fplll_tpu_torch.enum import kernels

    return sum(kernels.EXTENDED["launches"].values())


class PathSpy:
    """Counts what one call through the public functions did: nodes the
    enumeration facades reported, each kernel launch's form, nodes and
    walks (wrapping the enum_run that DeviceEnumerator calls), and the
    proved-CVP resets the card handled."""

    def __enter__(self):
        from fplll_tpu_torch.enum import api, cpu, device, kernels

        self.nodes = 0
        self.device_nodes = 0
        self.longest_walker_walk = self.longest_item_walk = 0
        self.donations = self.barren_skips = 0
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
            spy.longest_item_walk = max(spy.longest_item_walk,
                                        int(out.get("root_steps", 0)))
            spy.donations += int(out.get("donations", 0))
            spy.barren_skips += int(out.get("barren_skips", 0))
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
        self.extended_launches = extended_launch_count()
        return False

    def record(self, wall_s: float) -> dict:
        return {"wall_s": wall_s, "nodes": self.nodes,
                "device_nodes": self.device_nodes, "launches": self.launches,
                "extended_launches": self.extended_launches,
                "longest_walker_walk": self.longest_walker_walk,
                "longest_item_walk": self.longest_item_walk,
                "donations": self.donations,
                "barren_skips": self.barren_skips,
                "resets_on_card": self.resets_on_card}


class OnInstance:
    """Inside the block, every launch of DeviceEnumerator (the facade's
    and the window path's searches) of one of `forms` (kernels.FORMS)
    runs on the instance of its form (kernels.enum_run, extended=False)
    or on the extended one (kernels._enum_run_extended), each timed with
    CUDA events around the wrapper: `ms` and `root_steps` hold one entry
    per such launch. Other forms pass through untimed (`other` counts
    them)."""

    def __init__(self, extended: bool, forms=("f64",)):
        self.extended, self.forms = extended, forms

    def __enter__(self):
        import torch
        from fplll_tpu_torch.enum import device, kernels

        self.ms, self.root_steps, self.other = [], [], 0
        self._saved = device.enum_run
        run = kernels._enum_run_extended if self.extended \
            else kernels.enum_run
        spy = self

        def enum_run(*a, **kw):
            mut = kw["mut"] if "mut" in kw else a[0]
            if kernels._form(mut.dtype, kw.get("dual", False),
                             kw.get("findsubsols", False)) not in spy.forms:
                spy.other += 1
                return spy._saved(*a, **kw)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = run(*a, **kw)
            t1.record()
            torch.cuda.synchronize()
            spy.ms.append(t0.elapsed_time(t1))
            spy.root_steps.append(int(out.get("root_steps", 0)))
            return out

        device.enum_run = enum_run
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.enum import device

        device.enum_run = self._saved
        return False


def on_both_instances(call, turns=(False, True, True, False),
                      forms=("f64",), new="f64 primal") -> dict:
    """`call()` once per entry of `turns` (False: the instance of each
    form, labelled `new`; True: the extended one), in that order on one
    card, with the launches of `forms` sent there (OnInstance): per
    instance, each call's launches of those forms and their kernel ms
    (CUDA events around the wrapper), summed per call, and its wall;
    `results` holds what each call returned, in turn order."""
    import torch

    out = {new: [], "extended": [], "results": []}
    for ext in turns:
        with OnInstance(ext, forms) as inst:
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["extended" if ext else new].append({
            "launches": len(inst.ms), "kernel_ms": sum(inst.ms),
            "kernel_ms_per_launch": inst.ms, "wall_s": wall,
            "root_steps": max(inst.root_steps, default=0)})
        out["results"].append(res)
    return out


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


# a dual SVP tree the kernel dominates: phase 5's d = 50 dual SVP where
# its kernel takes more than this on the extended instance, else the dual
# SVP of the proved-SVP basis (d = 56)
DUAL_TREE_MS = 50.0


def dual_svp_on_both_instances(device, trees) -> dict:
    """The dual SVP (shortest_vector_ex with SVP_DUAL, the `f64-dual`
    form) on the dual instance and on the extended one in turns
    (on_both_instances), on the first of `trees` (label, basis, the
    host's dual length or None) whose one run on the extended instance
    took more than DUAL_TREE_MS of kernel, else on the last: per turn
    the kernel ms and wall; every turn's dual length, recomputed in f64
    from its vector, equal to the others' (and to the host's where
    given) to PHASE5_RTOL."""
    from fplll_tpu_torch.algs.svpcvp import shortest_vector_ex
    from fplll_tpu_torch.defs import SVP_DUAL

    t0 = time.perf_counter()
    probes = {}
    for label, b, host in trees:
        def call(b=b):
            return shortest_vector_ex(b.copy(), flags=SVP_DUAL, device=device)
        probe = on_both_instances(call, turns=(True,), forms=("f64-dual",),
                                  new="dual")
        probes[label] = probe["extended"][0]["kernel_ms"]
        if probes[label] > DUAL_TREE_MS or label == trees[-1][0]:
            break
    both = on_both_instances(call, forms=("f64-dual",), new="dual")
    lengths = []
    for status, _, ev, _ in both.pop("results"):
        assert status == 0, status
        lengths.append(dual_length(b, ev.begin()[1]))
    ref = host if host is not None else lengths[0]
    assert all(abs(v - ref) <= PHASE5_RTOL * ref for v in lengths), \
        (lengths, host)
    assert all(r["launches"] > 0 for k in ("dual", "extended")
               for r in both[k]), both
    rec = {"tree": f"dual SVP {label}", "probe_extended_kernel_ms": probes,
           "lengths": lengths, "host_length": host, **both,
           "seconds": time.perf_counter() - t0}
    log("dual-instances " + json.dumps(rec))
    return rec


def subsol_records(subsols, scale_exp, mu, r, lam, dual=False) -> dict:
    """Checks of a search's sub-solution records (`subsols`, the
    evaluator's (distance, coordinates) per level; the distances
    2^scale_exp times the scale of the tree (mu, r)): each is a passing
    node (its partial distance, recomputed in f64 from its coordinates
    over the tree, with the dual recurrence where `dual`, to
    PHASE5_RTOL) and no shorter than its level's shortest vector, which
    the C core finds (one SVP per level on that level's subtree, from its
    initial record r[lvl]); where that vector lies inside the final bound
    `lam`, an unpruned search visited it, so the record is no longer than
    it either. Returns the levels recorded, those inside the final
    bound, the worst relative error and the seconds of the C core's
    SVPs."""
    import numpy as np
    from fplll_tpu_torch.native import native_enumerate

    t0 = time.perf_counter()
    worst, below, checked = 0.0, 0, 0
    for lvl, (dist, vec) in enumerate(subsols):
        if not vec:
            continue
        checked += 1
        x = np.asarray(vec, dtype=np.float64)
        assert np.all(x[:lvl] == 0), lvl
        rec_n = math.ldexp(dist, -scale_exp)
        true = partial_dist(x, mu, r, lvl, dual)
        worst = max(worst, abs(true - rec_n) / true)
        assert abs(true - rec_n) <= PHASE5_RTOL * true, (lvl, true, rec_n)
        best = float(native_enumerate(
            np.ascontiguousarray(mu[lvl:, lvl:]), r[lvl:].copy(), None,
            None, r[lvl] * (1 + 1e-9), True, dual, False)[1])
        assert rec_n >= best * (1 - PHASE5_RTOL), (lvl, rec_n, best)
        if best <= lam * (1 + PHASE5_RTOL):
            below += 1
            assert rec_n <= best * (1 + PHASE5_RTOL), (lvl, rec_n, best)
    return {"host_level_svps_s": time.perf_counter() - t0,
            "levels_recorded": checked, "levels_inside_final_bound": below,
            "worst_record_rel_err": worst}


def dual_svp_subsols(device, b, host) -> dict:
    """Phase 5's dual SVP with sub-solutions through the public function
    (shortest_vector_pruning with SVP_DUAL and find_subsols, unpruned: the
    f64-dual-subsols form) on the card: every launch on the combined
    instance (none on the extended one), the status and the dual length
    (recomputed in f64 from its vector) and the reported length those of
    the host-only dual SVP (`host`: status, dual length, reported length;
    the same tree without the records: the host's C core keeps no
    sub-solutions, and its Python walk would take the 1e8-node tree far
    too long), every record valid (subsol_records over the dual tree in
    the basis' scale: the records are in the dual tree's coordinates and
    level order, their distances 2^(2 normExp) times the basis'); then
    the same call on the combined and the extended instance in turns
    (on_both_instances), every turn's answer the host's and its records
    inside the final bound the first card run's (to PHASE5_RTOL)."""
    import numpy as np
    import torch
    from fplll_tpu_torch.algs.svpcvp import shortest_vector_pruning
    from fplll_tpu_torch.defs import SVP_DUAL

    def call():
        return shortest_vector_pruning(b.copy(), [], flags=SVP_DUAL,
                                       find_subsols=True, device=device)

    sh, lh, reported_host = host
    t0 = time.perf_counter()
    with PathSpy() as card:
        sc, _, ev = call()
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert card.launches.get("f64-dual-subsols", 0) > 0 and \
        card.extended_launches == 0, (card.launches, card.extended_launches)
    mut, rdiag, normexp = gso_of(b)
    mu2, r2, _ = dual_tree(mut, np.ldexp(rdiag, normexp))
    lc = dual_length(b, ev.begin()[1])
    assert sc == sh == 0 and abs(lc - lh) <= PHASE5_RTOL * lh, (sc, lc, lh)
    assert abs(ev.begin()[0] - reported_host) <= \
        PHASE5_RTOL * reported_host, (ev.begin()[0], reported_host)
    rec = {"case": f"dual SVP with sub-solutions d{b.nrows}",
           "card": card.record(card_s),
           "status": (sc, sh), "length_card": lc, "length_host": lh,
           **subsol_records(ev.sub_solutions, 2 * ev.normExp, mu2, r2, lc,
                            dual=True)}
    assert rec["levels_recorded"] > 0 and \
        rec["levels_inside_final_bound"] > 0, rec
    t0 = time.perf_counter()
    both = on_both_instances(call, forms=("f64-dual-subsols",),
                             new="dual-subsols")
    # the levels whose record lies inside the final bound: there the
    # level's shortest vector does too, so every run visits it and records
    # it; above the bound a record depends on the order of the search
    first = {lvl: d for lvl, (d, x) in enumerate(ev.sub_solutions)
             if x and math.ldexp(d, -2 * ev.normExp) <=
             lc * (1 + PHASE5_RTOL)}
    assert len(first) == rec["levels_inside_final_bound"], (first, rec)
    for st, _, e in both.pop("results"):
        v = dual_length(b, e.begin()[1])
        assert st == 0 and abs(v - lh) <= PHASE5_RTOL * lh, (st, v, lh)
        turn = e.sub_solutions
        assert all(turn[lvl][1] and abs(turn[lvl][0] - d0) <=
                   PHASE5_RTOL * d0 for lvl, d0 in first.items()), \
            (turn, first)
    assert all(r["launches"] > 0 for k in ("dual-subsols", "extended")
               for r in both[k]), both
    rec["dual_subsols_instances"] = {
        "tree": f"dual SVP with sub-solutions d{b.nrows}", **both,
        "seconds": time.perf_counter() - t0}
    log("svp-cvp " + json.dumps(rec))
    return rec


def phase_svp_cvp(device, svp_dim=SVP_DIM, cvp_dim=CVP_DIM,
                  svp_seed=SVP_SEED, seed=CVP_SEED):
    """Phase 5: proved SVP, both CVP methods, dual SVP, dual SVP with
    sub-solutions and sub-solutions through the port's public functions
    on the card, each answer held against the same call host-only (the
    dual SVP with sub-solutions against the host-only dual SVP). Sizes
    are parameters only so the phase can be rehearsed small."""
    import random

    import numpy as np
    from fplll_tpu_torch.algs.svpcvp import (closest_vector, shortest_vector,
                                             shortest_vector_ex,
                                             shortest_vector_pruning)
    from fplll_tpu_torch.defs import CVPM_PROVED, SVP_DUAL

    recs = []
    # proved SVP: the exact minimum norm is unique. Its size: d = 60 was
    # asked for; the facade's own node estimate (gh_tree_estimate at the
    # radius the search starts from, the shortest basis vector) of the
    # smallest d = 60 tree among seeds 1-30 (seed 5) is logged beside this
    # tree's, to show why the host certificate would take too long there
    b = b_svp = intrel_basis(svp_dim, svp_seed)
    log("svp-size " + json.dumps({
        f"d{svp_dim} seed {svp_seed}": svp_tree_estimate(b),
        "d60 seed 5": svp_tree_estimate(intrel_basis(60, 5))}))
    (sc, xc), (sh, xh), rec = card_and_host(
        f"proved SVP d{svp_dim}",
        lambda **kw: shortest_vector(b.copy(), **kw), device, ("f64",))
    nc = sum(v * v for v in lattice_point(b, xc))
    nh = sum(v * v for v in lattice_point(b, xh))
    rec.update(status=(sc, sh), norm_card=nc, norm_host=nh)
    # the same call on both f64 instances, in turns: kernel ms and wall
    both = on_both_instances(
        lambda: shortest_vector(b.copy(), device=device))
    norms = [sum(v * v for v in lattice_point(b, x))
             for _, x in both.pop("results")]
    rec["f64_instances"] = both
    log("svp-cvp " + json.dumps(rec))
    assert sc == sh == 0 and nc == nh > 0, (sc, sh, nc, nh)
    assert norms == [nh] * len(norms), (norms, nh)
    assert all(r["launches"] > 0 for k in ("f64 primal", "extended")
               for r in both[k]), both
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

    # dual SVP: the dual length, a float. The dual tree is a
    # FastEvaluator search and unpruned, so the card runs it in f64
    # (enum/device.py:tree_dtype; the JAX package runs it in f32): the
    # length it reports and the length of its vector, recomputed in f64,
    # must both be the host's (both reported in the evaluator's scale,
    # the recomputed ones in the basis')
    (sc, _, ec, _), (sh, _, eh, _), rec = card_and_host(
        f"dual SVP d{cvp_dim}",
        lambda **kw: shortest_vector_ex(b.copy(), flags=SVP_DUAL, **kw),
        device, ("f64-dual",))
    lc, lh = dual_length(b, ec.begin()[1]), dual_length(b, eh.begin()[1])
    rec.update(status=(sc, sh), length_card=lc, length_host=lh,
               reported_card=ec.begin()[0], reported_host=eh.begin()[0])
    assert sc == sh == 0 and abs(lc - lh) <= PHASE5_RTOL * lh, rec
    assert abs(rec["reported_card"] - rec["reported_host"]) <= \
        PHASE5_RTOL * rec["reported_host"], rec
    rec["dual_instances"] = dual_svp_on_both_instances(
        device, ((f"d{cvp_dim}", b, lh), (f"d{svp_dim}", b_svp, None)))
    log("svp-cvp " + json.dumps(rec))
    recs.append(rec)
    recs.append(dual_svp_subsols(device, b, (sh, lh, eh.begin()[0])))

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
    rec = {"case": f"sub-solutions d{cvp_dim}", "card": card.record(card_s),
           **subsol_records(ev.sub_solutions, normexp, mut, rdiag, lam),
           "status": sc}
    log("svp-cvp " + json.dumps(rec))
    assert sc == 0 and rec["levels_recorded"] > 0 and \
        rec["levels_inside_final_bound"] > 0, rec
    recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 6: the user surfaces on the card
# ---------------------------------------------------------------------------
# `latticegen -randseed 1 r 42 420` piped into `fplll -a svp`, which reduces
# with LLL only: the facade estimates the proved tree at 1.7e8 nodes from
# the shortest basis vector, above the 2M crossover, and the host C core
# certifies it in about a second (1.3e7 nodes once the radius falls)
CLI_SVP = (42, 1)
# `fplll -a cvp` (the proved method) on `latticegen -randseed 1 r 40 400`,
# to a lattice vector plus integer offsets of expected squared length 1.1
# times the Gaussian heuristic: the fast method's host tree is 1.1e7 nodes
CLI_CVP = (40, 1)
# `fplll -a pru -pruend 40` and `-pruend 60` on a BKZ-20-reduced
# gen_intrel(60, 600) basis: d = 20, and d = 30, the full width of the
# analytic gradient (torchgrad._MAX_D)
PRU_BASIS, PRU_ENDS = (60, 5), (40, 60)
# the veneer's Pruning.run: preprocessing cost and target probability that
# leave the pruned tree at the Gaussian heuristic (VENEER_RADIUS times it)
# above the 2M crossover: 1.15e7 nodes estimated, 1.07e7 in the C core
VENEER_PREPROC, VENEER_TARGET, VENEER_RADIUS = 1e10, 0.9, 1.0
GSO_DIMS = (400, 800)
GSO_RTOL = 1e-10             # device GSO's r against LAPACK's, of max |r|
# its mu against LAPACK's, of max |mu|: on these ill-conditioned Grams two
# f64 orders of the factorization part by 3.1e-10 (d = 400) and 1.1e-9
# (d = 800) on an H100
GSO_MU_RTOL = 1e-8
# max |mu diag(r) mu^T - G| / max |G|, which the condition does not enter:
# 1.3e-15 and 2.2e-15 on an H100, where an f32 Cholesky would sit near
# f32's unit roundoff (6e-8) and a mu off by a part in 1000 near 1e-3
GSO_BACKWARD_TOL = 1e-12
PRU_RTOL = 1e-5              # the card's prune against the same on the CPU
# ... except the cost at d = 30 (`-pruend 60`): there the descent and
# Nelder-Mead are chaotic in the gradient's last bits. With each
# coordinate of the CPU's gradient multiplied by 1 + 1e-15 N(0, 1) (five
# seeds, tools/torch_prune_spread.py on an x86-64 CPU, torch 2.13) the
# prune's cost lands 4.2% below to 0.4% above the unperturbed one, two
# runs up to 4.7% apart; the CPU legs under torch 2.11 and 2.13 differ by
# 1.8%. The card's math library rounds other operations than torch's CPU
# one, so its prune is one more draw from that spread: its cost is held
# to about twice the widest measured gap, its expectation to PRU_RTOL
PRU30_COST_RTOL = 0.1
# norm-relative tolerance of one d = 30 gradient, card against CPU tensors,
# per metric: about 100 times the 1.17e-11 and 9.4e-13 measured on an H100
# between the two plain versions (the 1e-5 and 1e-11 of
# tests/test_torch_pruner.py hold the port against jaxgrad, whose XLA
# contracts multiply-adds). pruner_grad_kernel is held to it at every d
# of GRAD_CHECK_DS, against the plain version on the card and on CPU
# tensors: the emulated kernel sits within 4e-16 and 1.8e-12 of the CPU
# one (tests/test_torch_pruner_kernel.py), and below d = 30 the recurrence
# cancels less
GRAD30_TOL = {"probability": 1e-9, "expected solutions": 1e-10}
GRAD_CHECK_DS = (2, 5, 10, 20, 30)
# the log-target itself, kernel against either plain version
GRAD_VALUE_RTOL = 1e-12


def run_cli(mod, argv, text=""):
    """main(argv) of one of the port's CLI modules in this process, with
    stdin and stdout swapped: (exit code, stdout)."""
    import contextlib
    import io

    saved = sys.stdin
    sys.stdin = io.StringIO(text)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main(list(argv))
    finally:
        sys.stdin = saved
    return rc, out.getvalue()


def pipeline(cmd: str, timeout: float) -> str:
    """stdout of a shell pipeline of the port's CLIs, run from the repo
    root in a process group of its own that is killed if it outlives the
    call."""
    import signal

    proc = subprocess.Popen(["bash", "-c", "set -o pipefail; " + cmd],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    return out


class GradientSpy:
    """Counts and times the pruner's analytic gradients: the calls of
    pruner/torchgrad.gradient that reached a device (not those it declines
    before any device work, for a full-length vector or d > 30), by the
    device each ran on, in order. Each ends in a copy to the host, so its
    wall is the device's. `none` counts those that came back None (a
    non-finite gradient)."""

    def __enter__(self):
        from fplll_tpu_torch.pruner import torchgrad
        from fplll_tpu_torch.torchsetup import resolve_device

        self.calls = []
        self.none = 0
        self._orig = orig = torchgrad.gradient
        spy = self

        def gradient(pruner, b, device=None):
            dev = resolve_device(device).type
            t0 = time.perf_counter()
            g = orig(pruner, b, device=device)
            if len(b) == pruner.d <= torchgrad._MAX_D:
                spy.calls.append((dev, time.perf_counter() - t0))
                spy.none += g is None
            return g

        torchgrad.gradient = gradient
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.pruner import torchgrad
        torchgrad.gradient = self._orig
        return False

    def on(self, dev: str) -> list:
        return [s for d, s in self.calls if d == dev]

    def numbers(self) -> dict:
        """Calls, those on the card, and the first call's ms apart from the
        median of the rest."""
        secs = [s for _, s in self.calls]
        return {"gradient_calls": len(self.calls),
                "on_card": len(self.on("cuda")), "none": self.none,
                "first_gradient_ms": secs[0] * 1e3 if secs else None,
                "median_gradient_ms": median_ms(secs[1:])}


def median_ms(secs) -> float | None:
    import numpy as np
    return float(np.median(secs)) * 1e3 if len(secs) else None


def gradient_flops(d: int, prob: bool) -> float:
    """f64 operations of one analytic gradient as pruner_grad_kernel does
    it: row r runs r + 1 steps (the shell-shrunk row d steps), each d + 2
    shifts and multiply-adds and a scaled abscissa, about twice as many
    in the adjoint, and the cost's 2d terms (about 10 each)."""
    steps = d * (d + 1) // 2 + (d if prob else 0)
    return 3.0 * (steps * (3 * (d + 2) + 1) + 20 * d)


def gradient_chain(d: int) -> int:
    """Dependent f64 operations of the longest row (rd = d) as
    pruner_grad_kernel runs them: step j runs its band's Horner positions
    forward (its band's last step + 2, at most PG_COEF) and one ga
    multiply fewer backward; PG_BAND and PRUNER_GRAD_MAX_D are read from
    the source."""
    from fplll_tpu_torch import cuda_build

    with open(os.path.join(cuda_build.CSRC, "pruner_grad.cu")) as f:
        text = f.read()
    band = int(re.search(r"#define PG_BAND (\d+)", text).group(1))
    coef = int(re.search(r"#define PRUNER_GRAD_MAX_D (\d+)",
                         text).group(1)) + 2
    n = 0
    for j in range(d):
        j1 = (j // band + 1) * band
        n += min(j1 + 1, coef) + min(j1, coef - 1)
    return n


# this script's own measuring aid, not a part of the port: one thread runs
# n dependent f64 multiply-adds (x[0] <- x[0] x[1] + x[2]), so that a
# launch's time over n is the dependent latency one link of the gradient
# kernel's chain pays
FMA_PROBE_CU = r"""
__global__ void fma_probe(double *x, int n) {
  double v = x[0];
  const double a = x[1], c = x[2];
#pragma unroll 16
  for (int i = 0; i < n; ++i) v = fma(v, a, c);
  x[0] = v;
}

extern "C" int fma_probe_launch(double *x, int n, void *stream) {
  fma_probe<<<1, 1, 0, (cudaStream_t)stream>>>(x, n);
  return (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def fma_probe_lib():
    """FMA_PROBE_CU built by the port's nvcc helper into the build
    directory."""
    import ctypes

    from fplll_tpu_torch import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "fma_probe.cu")
    with open(src, "w") as f:
        f.write(FMA_PROBE_CU)
    lib, _ = cuda_build.build("fma_probe", src=src)
    lib.fma_probe_launch.restype = ctypes.c_int
    lib.fma_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def pruner_profile_lib():
    """(pruner_grad.cu built with PRUNER_GRAD_PROFILE, its nvcc output):
    the same kernel with pruner_grad_launch_clocked, for the breakdown
    only."""
    import ctypes

    from fplll_tpu_torch import cuda_build

    lib, text = cuda_build.build("pruner_grad",
                                 defines=("PRUNER_GRAD_PROFILE",))
    fn = lib.pruner_grad_launch_clocked
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_double] * 4 + [ctypes.c_void_p] * 2
    return lib, text


def fma_latency_ns(n: int = 1 << 20) -> float:
    """ns per dependent f64 multiply-add on the card: one thread's chain of
    n (FMA_PROBE_CU), CUDA events, median of 3 after a warm launch. The
    unit of the gradient kernel's chain floor."""
    import numpy as np
    import torch

    lib = fma_probe_lib()
    x = torch.tensor([0.5, 0.999999, 1e-6], dtype=torch.float64,
                     device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    secs = []
    for _ in range(4):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        assert lib.fma_probe_launch(x.data_ptr(), n, stream) == 0
        ev1.record()
        torch.cuda.synchronize()
        secs.append(ev0.elapsed_time(ev1) * 1e-3)
    assert math.isfinite(float(x[0])), x
    return float(np.median(secs[1:])) / n * 1e9


# pruner_grad_kernel's phases, from its PG_CLOCKS stamps (slots 0-11):
# (name, first stamp, last stamp); warp 0's forward and warp 1's pow calls
# run side by side
PRUNER_PHASES = (("profiles", 0, 1), ("forward, warp 0", 1, 2),
                 ("pow calls, warp 1", 1, 3), ("forward barrier", 1, 4),
                 ("cost terms", 4, 5), ("scalar chain", 5, 6),
                 ("terms' adjoint", 6, 7), ("volumes' adjoints", 7, 8),
                 ("backward, warp 0", 8, 9), ("backward barrier", 9, 10),
                 ("dlog/db sums", 10, 11), ("total", 0, 11))


def pruner_kernel_phases(inp, d: int, scalars: tuple,
                         reps: int = 20) -> dict:
    """SM cycles of each phase of pruner_grad_kernel (PRUNER_PHASES),
    median over `reps` launches of the PRUNER_GRAD_PROFILE build's
    pruner_grad_launch_clocked, which stamps clock64() at the phase
    boundaries."""
    import numpy as np
    import torch
    from fplll_tpu_torch.pruner import torchgrad

    fn = pruner_profile_lib()[0].pruner_grad_launch_clocked
    tab = torchgrad.kernel_tables(d)
    tab = torch.from_numpy(tab).to(inp.device)
    out = torch.empty(d + 1, dtype=torch.float64, device=inp.device)
    clocks = torch.zeros((reps, 12), dtype=torch.int64, device=inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    for r in range(reps):
        assert fn(tab.data_ptr(), inp.data_ptr(), out.data_ptr(), d,
                  *scalars, clocks[r].data_ptr(), stream) == 0
    torch.cuda.synchronize()
    c = clocks.cpu().numpy()
    return {name: float(np.median(c[:, b] - c[:, a]))
            for name, a, b in PRUNER_PHASES}


def graph_kernel_ms(fn, launches: int) -> float:
    """Device ms per call of `fn` (one kernel launch) with the launches
    back to back: `launches` calls captured in one CUDA graph, one replay
    timed by CUDA events, so that the host's pace between launches is not
    in it."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                         # warm, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    graph.replay()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / launches


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def gradient_kernels(fn) -> dict | None:
    """What one call of fn runs on the card, from torch.profiler's device
    trace: {"kernels": launches of CUDA kernels, "copies": memory copies
    and sets, "kernel_ms": {name: device ms per launch}}; None when the
    profiler records no device activity or cannot trace the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        return None
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"torch.profiler could not trace the card: {e}")
        return None
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    copy = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kern = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
    return {"kernels": sum(e.count for e in kern),
            "copies": sum(e.count for e in copy),
            "kernel_ms": {e.key: getattr(e, "device_time_total",
                                         getattr(e, "cuda_time_total", 0.0))
                          / e.count / 1e3 for e in kern[:8]}}


def profiler_kernel_ms(card_run) -> float | None:
    """pruner_grad_kernel's device ms in a gradient_kernels record."""
    return next((ms for name, ms in ((card_run or {}).get("kernel_ms")
                                     or {}).items()
                 if "pruner_grad_kernel" in name), None)


def gradient_profile(d: int, metric: int, device=None, flags: int = 0):
    """The profile of tests/test_pruner.py's gradient test at n = 2d
    (r_i = 1.012^(-4i), radius 1.1 GH), b = linspace(0.3, 1, d) enforced;
    flags: 0 (SVP) or PRUNER_CVP."""
    import numpy as np
    from fplll_tpu_torch.defs import PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    from fplll_tpu_torch.pruner.pruner import Pruner

    n = 2 * d
    r = [math.exp(-4 * math.log(1.012) * i) for i in range(n)]
    gh = math.exp(sum(math.log(x) for x in r) / n - 2 * (
        (n / 2) * math.log(math.pi) - math.lgamma(n / 2 + 1)) / n)
    target = 0.5 if metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST else 1.0
    p = Pruner(1.1 * gh, 1e10, r, target, metric, flags, device=device)
    b = np.linspace(0.3, 1.0, d)
    p.enforce(b)
    return p, b


def gradient_input(p, b, device):
    """(the kernel's packed input of pruner p at b on device, its consts)."""
    import torch
    from fplll_tpu_torch.pruner import torchgrad

    consts = (int(p.metric), float(p.symmetry_factor), float(p.shell_ratio))
    inp = torchgrad.pack(b, p.ipv[:2 * p.d], float(p.normalized_radius),
                         float(p.target), float(p.preproc_cost), consts[0])
    return torch.from_numpy(inp).to(device), consts


def metric_labels():
    from fplll_tpu_torch.defs import (PRUNER_METRIC_EXPECTED_SOLUTIONS,
                                      PRUNER_METRIC_PROBABILITY_OF_SHORTEST)
    return ((PRUNER_METRIC_PROBABILITY_OF_SHORTEST, "probability"),
            (PRUNER_METRIC_EXPECTED_SOLUTIONS, "expected solutions"))


def surfaces_cli(device, svp=CLI_SVP, cvp=CLI_CVP, pipe=True) -> dict:
    """`latticegen r d 10d` into `fplll -a svp` and `fplll -a cvp` in this
    process, each certified by the port's host route on the same
    LLL-reduced basis (every tree on the C core), and the same SVP through
    a subprocess pipeline of the two CLIs."""
    import random

    import numpy as np
    import torch
    from fplll_tpu_torch.algs.svpcvp import closest_vector, shortest_vector
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.cli import latticegen
    from fplll_tpu_torch.cli import main as cli
    from fplll_tpu_torch.defs import SVPM_PROVED
    from fplll_tpu_torch.ops.intmat import parse_matrix, parse_vector

    out = {}
    d, seed = svp
    gen_argv = ["-randseed", str(seed), "r", str(d), str(10 * d)]
    _, text = run_cli(latticegen, gen_argv)
    b = parse_matrix(text)
    lll_reduction(b)
    est = svp_tree_estimate(b)
    with PathSpy() as card:
        t0 = time.perf_counter()
        rc, printed = run_cli(cli, ["-a", "svp"], text)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    norm_card = sum(v * v for v in parse_vector(printed.strip()))
    with PathSpy() as host:
        t0 = time.perf_counter()
        st, x = shortest_vector(b.copy(), SVPM_PROVED, backend="cpu")
        host_s = time.perf_counter() - t0
    norm_host = sum(v * v for v in lattice_point(b, x))
    rec = {"case": f"fplll -a svp, latticegen r {d} {10 * d}, seed {seed}",
           "tree_estimate": est, "card": card.record(card_s),
           "host": host.record(host_s), "norm_card": norm_card,
           "norm_host": norm_host}
    log("surfaces " + json.dumps(rec))
    assert rc == st == 0 and norm_card == norm_host > 0, rec
    # a proved search (an error-bounded evaluator): the f64 form only
    assert set(card.launches) == {"f64"}, \
        f"fplll -a svp launched {card.launches}, not f64"
    assert not host.launches, "the host certificate launched"
    out["svp"] = rec

    if pipe:
        py = sys.executable
        t0 = time.perf_counter()
        piped = pipeline(f"{py} -m fplll_tpu_torch.cli.latticegen "
                         f"{' '.join(gen_argv)} | {py} -m "
                         "fplll_tpu_torch.cli.main -a svp", timeout=300)
        out["pipeline"] = {"wall_s": time.perf_counter() - t0,
                           "same_stdout": piped == printed}
        log("surfaces " + json.dumps({"case": "latticegen | fplll -a svp, "
                                      "two processes", **out["pipeline"]}))
        assert piped == printed, (piped, printed)

    d, seed = cvp
    _, text = run_cli(latticegen, ["-randseed", str(seed), "r", str(d),
                                   str(10 * d)])
    b = parse_matrix(text)
    lll_reduction(b)
    mut, rdiag, normexp = gso_of(b)
    gh = math.ldexp(math.exp(float(np.mean(np.log(rdiag))) + 2 * math.lgamma(
        d / 2 + 1) / d) / math.pi, normexp)
    R = max(1, round(math.sqrt(3 * 1.1 * gh / b.ncols)))
    rng = random.Random(seed)
    v = lattice_point(b, [rng.randint(-3, 3) for _ in range(d)])
    target = [c + rng.randint(-R, R) for c in v]
    with PathSpy() as card:
        t0 = time.perf_counter()
        rc, printed = run_cli(cli, ["-a", "cvp"], text + "\n[" + " ".join(
            str(t) for t in target) + "]\n")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    dist_card = sum((t - c) ** 2 for t, c in zip(
        target, parse_vector(printed.strip())))
    # the host certificate takes the fast method: the proved one runs its
    # resets on the Python DFS when host-only, far too slow at this size
    with PathSpy() as host:
        t0 = time.perf_counter()
        st, x = closest_vector(b.copy(), target, method=0, backend="cpu")
        host_s = time.perf_counter() - t0
    dist_host = sum((t - c) ** 2 for t, c in zip(target, lattice_point(b, x)))
    rec = {"case": f"fplll -a cvp, latticegen r {d} {10 * d}, seed {seed}",
           "card": card.record(card_s), "host_fast_method": host.record(
               host_s), "dist_card": dist_card, "dist_host": dist_host,
           "offset_bound": R, "gaussian_heuristic": gh}
    log("surfaces " + json.dumps(rec))
    assert rc == st == 0 and dist_card == dist_host, rec
    assert set(card.launches) == {"f64"}, \
        f"fplll -a cvp launched {card.launches}, not f64"
    assert not host.launches, "the host certificate launched"
    out["cvp"] = rec
    return out


def pruner_kernel_checks(device, ds=GRAD_CHECK_DS) -> dict:
    """pruner_grad_kernel built from the checkout, then held against the
    plain version (torch.autograd) on the card and on CPU tensors: d in
    `ds` x both metrics x SVP/CVP symmetry, a profile whose top
    coefficient lies on the shell's clip (its gradient's 1/2 rule), a
    non-finite one (gradient() returns None on the card as on the CPU),
    and one whose tiny coefficient takes the kernel's backward to the full
    Horner length (non-finite entry by entry where the plain version
    is). Each case also goes through torchgrad.gradient on the card, the
    route the pruner takes (its staging buffers, one launch), against
    the plain version in gradient()'s convention."""
    import numpy as np
    import torch
    from fplll_tpu_torch.defs import PRUNER_CVP
    from fplll_tpu_torch.pruner import torchgrad

    cases = []
    for d in ds:
        for metric, label in metric_labels():
            for flags, sym in ((0, "svp"), (PRUNER_CVP, "cvp")):
                p, b = gradient_profile(d, metric, flags=flags)
                cases.append((f"d{d} {label} {sym}", p, b, label))
    metric, label = metric_labels()[0]
    p, b = gradient_profile(10, metric)
    cases.append(("d10 probability, top coefficients on the shell clip", p,
                  np.linspace(0.1, p.shell_ratio ** 2, 10), label))
    first_ms = None
    worst = {label: 0.0 for _, label in metric_labels()}
    max_abs = 0.0
    for name, p, b, label in cases:
        inp, consts = gradient_input(p, b, device)
        t0 = time.perf_counter()
        k = torchgrad.log_target_and_grad(inp, p.d, *consts).cpu()
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3
        for ref in (torchgrad.log_target_and_grad_plain(inp, p.d,
                                                        *consts).cpu(),
                    torchgrad.log_target_and_grad(inp.cpu(), p.d, *consts)):
            err = float(torch.linalg.norm(k[1:] - ref[1:]) /
                        torch.linalg.norm(ref[1:]))
            verr = abs(float(k[0] - ref[0])) / abs(float(ref[0]))
            worst[label] = max(worst[label], err)
            max_abs = max(max_abs, float((k - ref).abs().max()))
            assert err <= GRAD30_TOL[label] and verr <= GRAD_VALUE_RTOL, \
                (name, err, verr)
        launches = torchgrad.LAUNCHES
        g = torchgrad.gradient(p, b, device=device)
        assert torchgrad.LAUNCHES == launches + 1
        bn = np.asarray(b, dtype=np.float64)
        plain_g = torchgrad.log_target_and_grad_plain(
            inp, p.d, *consts).cpu().numpy()[1:]
        for ref in (-2.0 * bn * plain_g,
                    torchgrad.gradient(p, b, device="cpu")):
            ref[-1] = 0.0
            err = float(np.linalg.norm(g - ref) / np.linalg.norm(ref))
            worst[label] = max(worst[label], err)
            max_abs = max(max_abs, float(np.abs(g - ref).max()))
            assert err <= GRAD30_TOL[label], (name, "gradient()", err)
    p, b = gradient_profile(10, metric)
    b = np.zeros(10)
    inp, consts = gradient_input(p, b, device)
    k = torchgrad.log_target_and_grad(inp, 10, *consts).cpu().numpy()
    assert not np.isfinite(k[1:]).any(), k
    assert torchgrad.gradient(p, b, device=device) is None
    assert torchgrad.gradient(p, b, device="cpu") is None
    # a row whose abscissae reach 1e79: the kernel's backward takes the
    # full length there, non-finite where the plain version is
    b = np.linspace(0.3, 1.0, 10)
    b[2] = 1e-80
    inp, consts = gradient_input(p, b, device)
    k = torchgrad.log_target_and_grad(inp, 10, *consts).cpu()
    for ref in (torchgrad.log_target_and_grad_plain(inp, 10, *consts).cpu(),
                torchgrad.log_target_and_grad(inp.cpu(), 10, *consts)):
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(k), fin), (k, ref)
        assert float(torch.linalg.norm(k[fin][1:] - ref[fin][1:])) <= \
            GRAD30_TOL["probability"] * float(torch.linalg.norm(ref[fin][1:]))
    torch.cuda.synchronize()
    rec = {"first_call_ms": first_ms,
           "cases": len(cases) + 2, "worst_rel_diff": worst,
           "max_abs_err": max_abs}
    log("surfaces " + json.dumps({"case": "pruner_grad_kernel against the "
                                  "plain version on the card and on CPU "
                                  "tensors", **rec}))
    return rec


def pruner_kernel_timing(device, d=30, launches=200,
                         profile: bool = True) -> dict:
    """One d = 30 gradient per metric: the wrapper (torchgrad.gradient, the
    copies included, median of 20 after a warm call), the kernel alone
    (`kernel_ms`: CUDA events around `launches` back-to-back warm launches
    captured in one CUDA graph; `loop_kernel_ms`: the same launches from a
    Python loop, which the host's pace can set; `profiler_ms`: the device
    time of the kernel in one gradient() call, torch.profiler), the plain
    version on the card and on CPU tensors (median of 5), and what one
    call runs on the card, beside the operations and bytes bound. With
    `profile` (this checkout's kernel only) also the chain floor (the
    longest row's dependent operations at the measured latency of one),
    ns per dependent operation and the SM cycles per phase."""
    import torch
    from fplll_tpu_torch.pruner import torchgrad

    lib = torchgrad.build_kernel()
    if profile:
        clock = max_sm_clock_hz()
        latency_ns = fma_latency_ns()
        chain = gradient_chain(d)
    out = {}
    for metric, label in metric_labels():
        p, b = gradient_profile(d, metric)
        inp, consts = gradient_input(p, b, device)
        torchgrad.gradient(p, b, device=device)
        wrapper = []
        for _ in range(20):
            t0 = time.perf_counter()
            torchgrad.gradient(p, b, device=device)
            wrapper.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(launches):
            torchgrad.log_target_and_grad(inp, d, *consts)
        ev1.record()
        torch.cuda.synchronize()
        loop_ms = ev0.elapsed_time(ev1) / launches
        kernel_ms = graph_kernel_ms(
            lambda: torchgrad.log_target_and_grad(inp, d, *consts), launches)
        plain = {}
        for key, dev in (("card", device), ("cpu", "cpu")):
            x = inp.to(dev)
            torchgrad.log_target_and_grad_plain(x, d, *consts)
            secs = []
            for _ in range(5):
                _, dt = timed(lambda: torchgrad.log_target_and_grad_plain(
                    x, d, *consts), torch.cuda.synchronize)
                secs.append(dt)
            plain[key] = median_ms(secs)
        prob = consts[0] == metric_labels()[0][0]
        flops = gradient_flops(d, prob)
        nbytes = 8 * ((3 * d + 5) + (4 * d + 4) + (d + 1))
        ops_ms = flops / H100_F64_FLOPS * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES * 1e3
        card_run = gradient_kernels(
            lambda: torchgrad.gradient(p, b, device=device))
        r = out[label] = {
            "wrapper_ms": median_ms(wrapper), "kernel_ms": kernel_ms,
            "loop_kernel_ms": loop_ms,
            "profiler_ms": profiler_kernel_ms(card_run),
            "plain_card_ms": plain["card"], "plain_cpu_ms": plain["cpu"],
            "card_run": card_run,
            "plain_card_run_kernels": (gradient_kernels(
                lambda: torchgrad.log_target_and_grad_plain(
                    inp, d, *consts)) or {}).get("kernels"),
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "d": d, "rows": d + (1 if prob else 0),
            "smem_bytes": lib.pruner_grad_smem_bytes(d, int(prob))}
        if profile:
            r.update({
                "threads": lib.pruner_grad_threads(),
                # the longest row's dependent chain at the latency of one
                # dependent f64 multiply-add, measured on this card just
                # now
                "chain_ops": chain, "fma_latency_ns": latency_ns,
                "chain_floor_ms": chain * latency_ns * 1e-6,
                "ns_per_dependent_op": kernel_ms * 1e6 / chain,
                "max_sm_clock_mhz": clock / 1e6,
                "phase_cycles": pruner_kernel_phases(
                    inp, d, torchgrad.kernel_scalars(d, *consts))})
    log("surfaces " + json.dumps({"case": f"one d = {d} gradient, kernel "
                                  "and plain version", **out}))
    for label, r in out.items():
        run = r["card_run"]
        assert run is None or run["kernels"] == 1, (label, run)
    return out


def prune_cli_runs(text: str, end: int, case: str,
                   cost_rtol: float = PRU_RTOL) -> dict:
    """`fplll -a pru -pruend <end>` on the card, on CPU tensors and with the
    host numerical scheme; on the card every analytic gradient is one
    launch of pruner_grad_kernel (its count set to 0 just before the run
    and read just after)."""
    import numpy as np
    from fplll_tpu_torch.cli import main as cli
    from fplll_tpu_torch.pruner import pruner as pruner_mod
    from fplll_tpu_torch.pruner import torchgrad

    results = []
    orig_prune = pruner_mod.prune

    def prune(*a, **k):
        res = orig_prune(*a, **k)
        p = pruner_mod.Pruner(*a[:6])      # run_pruner's positional call
        results.append((res, p.repeated_enum_cost(res.coefficients)))
        return res

    runs = {}
    pruner_mod.prune = prune
    try:
        for name, env in (("card", {}),
                          ("cpu", {"FPLLL_TORCH_DEVICE": "cpu"}),
                          ("numerical", {"FPLLL_TPU_PRUNER_JAXGRAD": "0"})):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                with GradientSpy() as gs:
                    torchgrad.LAUNCHES = 0
                    t0 = time.perf_counter()
                    rc, _ = run_cli(cli, ["-a", "pru", "-pruend", str(end)],
                                    text)
                    wall = time.perf_counter() - t0
                    launches = torchgrad.LAUNCHES
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            res, cost = results[-1]
            assert rc == 0
            runs[name] = {"wall_s": wall, **gs.numbers(),
                          "kernel_launches": launches,
                          "repeated_cost": cost,
                          "expectation": res.expectation,
                          "coefficients": list(res.coefficients)}
    finally:
        pruner_mod.prune = orig_prune
    c, h = runs["card"], runs["cpu"]
    rec = {"case": case,
           "runs": {k: {k2: v2 for k2, v2 in r.items() if k2 != "coefficients"}
                    for k, r in runs.items()},
           "cost_rel_diff": abs(c["repeated_cost"] - h["repeated_cost"]) /
           h["repeated_cost"],
           "expectation_rel_diff": abs(c["expectation"] - h["expectation"]) /
           h["expectation"],
           "coefficients_max_abs_diff": float(np.max(np.abs(
               np.asarray(c["coefficients"]) - np.asarray(h["coefficients"]))))}
    log("surfaces " + json.dumps(rec))
    assert c["gradient_calls"] == c["on_card"] > 0, "no gradient on the card"
    assert c["kernel_launches"] == c["on_card"], \
        (c["kernel_launches"], c["on_card"])
    assert h["gradient_calls"] > 0 and h["on_card"] == 0
    assert h["kernel_launches"] == 0
    assert runs["numerical"]["gradient_calls"] == 0
    assert runs["numerical"]["kernel_launches"] == 0
    assert rec["cost_rel_diff"] <= cost_rtol, rec
    assert rec["expectation_rel_diff"] <= PRU_RTOL, rec
    return rec


def surfaces_pruner(device, basis=PRU_BASIS, ends=PRU_ENDS,
                    check_ds=GRAD_CHECK_DS) -> dict:
    """The pruner's gradient kernel against its plain version and timed at
    d = 30, then `fplll -a pru -pruend <end>` for each end (on the card,
    on CPU tensors and numerical)."""
    import torch
    from fplll_tpu_torch.ops.intmat import format_matrix

    checks = pruner_kernel_checks(device, check_ds)
    timing = pruner_kernel_timing(device, d=max(check_ds))
    text = format_matrix(intrel_basis(*basis))
    pru = {end: prune_cli_runs(
        text, end, f"fplll -a pru -pruend {end} (d = {end // 2}), BKZ-20 "
        f"gen_intrel({basis[0]}, {10 * basis[0]}), seed {basis[1]}",
        PRU30_COST_RTOL if end // 2 == 30 else PRU_RTOL) for end in ends}
    torch.cuda.synchronize()
    return {"checks": checks, "timing": timing, "pru": pru}


def surfaces_veneer(device, svp=CLI_SVP, norm=None,
                    radius=VENEER_RADIUS) -> dict:
    """fpylll's SVP.shortest_vector (proved) on the CLI's SVP basis (its
    squared norm must be `norm`, the CLI's certified answer, where given),
    Pruning.run on its GSO profile (d = n/2 <= 30: the gradient on the
    card), and Enumeration.enumerate with those coefficients, a pruned f32
    search at the Gaussian heuristic, certified by the C core."""
    import numpy as np
    import torch
    from fplll_tpu_torch import fpylll
    from fplll_tpu_torch.cli import latticegen
    from fplll_tpu_torch.enum.device import gh_tree_estimate
    from fplll_tpu_torch.native import native_enumerate
    from fplll_tpu_torch.ops.intmat import parse_matrix
    from fplll_tpu_torch.pruner import torchgrad

    d, seed = svp
    _, text = run_cli(latticegen, ["-randseed", str(seed), "r", str(d),
                                   str(10 * d)])
    A = fpylll.IntegerMatrix.from_matrix(parse_matrix(text))
    with PathSpy() as sv:
        t0 = time.perf_counter()
        v = fpylll.SVP.shortest_vector(A, method="proved")
        torch.cuda.synchronize()
        svp_s = time.perf_counter() - t0
    M = fpylll.GSO.Mat(A, update=True)
    r = [M.get_r(i, i) for i in range(d)]
    gh = radius * math.exp(sum(math.log(x) for x in r) / d - 2 * (
        (d / 2) * math.log(math.pi) - math.lgamma(d / 2 + 1)) / d)
    with GradientSpy() as gs:
        torchgrad.LAUNCHES = 0
        t0 = time.perf_counter()
        pp = fpylll.Pruning.run(gh, VENEER_PREPROC, r, VENEER_TARGET,
                                flags=fpylll.Pruning.GRADIENT |
                                fpylll.Pruning.NELDER_MEAD)
        prune_s = time.perf_counter() - t0
        launches = torchgrad.LAUNCHES
    mut, rdiag, normexp = gso_of(A)
    prune = np.asarray(pp.coefficients)
    est = gh_tree_estimate(rdiag, prune, math.ldexp(gh, -normexp))
    enum = fpylll.Enumeration(M, nr_solutions=1)
    # this step holds the pruned f32 form on the card: the facade's native
    # first pass, on by default, could finish the tree on the host, so it
    # is off for this call alone (logged as native_first_pass "off")
    with PathSpy() as en, HybridNodes(0):
        t0 = time.perf_counter()
        dist, coords = enum.enumerate(0, d, gh, 0, pruning=pp.coefficients)[0]
        torch.cuda.synchronize()
        enum_s = time.perf_counter() - t0
    exact = exact_norm(A, coords)
    cert = native_enumerate(mut, rdiag, prune, None,
                            math.ldexp(exact, -normexp) * 0.999, True, False,
                            False)
    rec = {"case": f"fpylll veneer on latticegen r {d} {10 * d}, seed {seed}",
           "svp": {**sv.record(svp_s), "norm": sum(x * x for x in v)},
           "pruning_run": {"wall_s": prune_s, **gs.numbers(),
                           "kernel_launches": launches,
                           "expectation": pp.expectation},
           "enumeration": {**en.record(enum_s), "native_first_pass": "off",
                           "tree_estimate": est,
                           "radius": gh, "dist": dist, "exact": exact,
                           "c_core_inside_0.999": float(cert[1])}}
    log("surfaces " + json.dumps(rec))
    assert set(sv.launches) == {"f64"}, \
        f"SVP.shortest_vector launched {sv.launches}, not f64"
    assert norm is None or rec["svp"]["norm"] == norm, (rec, norm)
    assert gs.calls and len(gs.on("cuda")) == len(gs.calls) == launches, rec
    # a pruned search: the f32 form
    assert set(en.launches) == {"single"}, \
        f"the pruned Enumeration launched {en.launches}, not single"
    assert abs(exact - dist) <= F32_DIST_TOL * exact, (exact, dist)
    assert math.isinf(cert[1]), \
        f"the C core found {cert[1]} inside the card's {exact}"
    return rec


def surfaces_gso(device, dims=GSO_DIMS) -> dict:
    """full_gso at d >= device_gso_dim() on the Gram of an unreduced
    gen_uniform basis with 10-bit entries (exact in f64): the card's
    Cholesky route against LAPACK on the host (r and mu), and against G
    itself (mu diag(r) mu^T)."""
    import numpy as np
    import torch
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops import blockgso
    from fplll_tpu_torch.ops.gen import gen_uniform

    recs = {}
    for d in dims:
        RandGen.init_with_seed(d)
        bf = np.array([[float(x) for x in row] for row in gen_uniform(d, 10).a])
        G = bf @ bf.T
        assert d >= blockgso.device_gso_dim()
        calls, orig = [], blockgso.device_chol_gso

        def spy(*a, **k):
            calls.append(a[0].shape[0])
            return orig(*a, **k)

        blockgso.device_chol_gso = spy
        try:
            card = [timed(lambda: blockgso.full_gso(G), torch.cuda.synchronize)
                    for _ in range(3)]
        finally:
            blockgso.device_chol_gso = orig
        host = [timed(lambda: blockgso.chol_gso(G), lambda: None)
                for _ in range(3)]
        Gt = torch.as_tensor(G, device=device)
        chol_ms = []
        for _ in range(3):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            torch.linalg.cholesky_ex(Gt)
            ev1.record()
            torch.cuda.synchronize()
            chol_ms.append(ev0.elapsed_time(ev1))
        (mu, r), (hmu, hr) = card[0][0], host[0][0]
        scale = float(np.abs(hr).max())
        # bound: d^3/3 operations, which cuSOLVER's potrf spends in its
        # trailing GEMM updates, at the f64 tensor-core rate, or reading G
        # and writing mu and r, whichever is longer
        flop_s = d ** 3 / 3 / H100_F64_TC_FLOPS
        byte_s = 3 * d * d * 8 / H100_HBM_BYTES
        rec = {"route_calls": len(calls),
               "card_ms": median_ms([s for _, s in card]),
               "cholesky_kernel_ms": float(np.median(chol_ms)),
               "host_ms": median_ms([s for _, s in host]),
               "r_err": float(np.abs(r - hr).max()) / scale,
               "mu_err": float(np.abs(mu - np.tril(hmu)).max() /
                               np.abs(hmu).max()),
               "backward_err": float(np.abs(
                   mu @ (np.diagonal(r)[:, None] * mu.T) - G).max() /
                   np.abs(G).max()),
               "bound_ms": max(flop_s, byte_s) * 1e3,
               "bound_by": "operations" if flop_s > byte_s else "bytes",
               "bound_rate_flops": H100_F64_TC_FLOPS}
        log("surfaces " + json.dumps({"case": f"device GSO d = {d}", **rec}))
        assert rec["route_calls"] == 3, rec
        assert rec["r_err"] <= GSO_RTOL and rec["mu_err"] <= GSO_MU_RTOL \
            and rec["backward_err"] <= GSO_BACKWARD_TOL, rec
        recs[d] = rec
    return recs


def phase_surfaces(device) -> dict:
    """Phase 6: the CLIs, the pruner, the fpylll veneer and the device
    GSO on the card, each answer certified by the port's host route in
    this process; each step's wall logged."""
    out, walls = {}, {}
    steps = (("cli", lambda: surfaces_cli(device)),
             ("pruner", lambda: surfaces_pruner(device)),
             ("veneer", lambda: surfaces_veneer(
                 device, norm=out["cli"]["svp"]["norm_card"])),
             ("gso", lambda: surfaces_gso(device)))
    for name, step in steps:
        t0 = time.perf_counter()
        out[name] = step()
        walls[name] = time.perf_counter() - t0
        log(f"phase 6 {name}: {walls[name]:.1f} s")
    out["walls_s"] = walls
    return out


def surface_launches(rec) -> dict:
    """Kernel launches per form on phase 6's path: the CLI's SVP and CVP
    and the veneer's SVP and Enumeration."""
    launches = {}
    spies = [rec["cli"]["svp"]["card"], rec["cli"]["cvp"]["card"],
             rec["veneer"]["svp"], rec["veneer"]["enumeration"]]
    for spy in spies:
        for form, n in spy["launches"].items():
            launches[form] = launches.get(form, 0) + n
    return launches


def surface_extended_launches(rec) -> int:
    """The extended instance's launches on phase 6's path (the spies of
    surface_launches)."""
    return sum(spy["extended_launches"] for spy in (
        rec["cli"]["svp"]["card"], rec["cli"]["cvp"]["card"],
        rec["veneer"]["svp"], rec["veneer"]["enumeration"]))


def phase6_numbers(surf, surface_counts) -> dict:
    """Phase 6's line: walls, launches per form, the CLI's and the veneer's
    times, the prune runs, and the X5 (gradient kernel) and X4 (device
    GSO) numbers with their bounds."""
    pr = surf["pruner"]
    return {
        "walls_s": surf["walls_s"],
        "launches": surface_counts,
        "svp": {k: surf["cli"]["svp"][k] for k in ("tree_estimate",
                                                   "norm_card")},
        "svp_card_s": surf["cli"]["svp"]["card"]["wall_s"],
        "svp_host_s": surf["cli"]["svp"]["host"]["wall_s"],
        "cvp_card_s": surf["cli"]["cvp"]["card"]["wall_s"],
        "cvp_host_fast_s": surf["cli"]["cvp"]["host_fast_method"]["wall_s"],
        "pipeline_s": surf["cli"].get("pipeline", {}).get("wall_s"),
        "pru": {end: r["runs"] for end, r in pr["pru"].items()},
        "pru_cost_rel_diff": {end: r["cost_rel_diff"]
                              for end, r in pr["pru"].items()},
        "veneer": {"svp_s": surf["veneer"]["svp"]["wall_s"],
                   "pruning_run": surf["veneer"]["pruning_run"],
                   "enumeration_s": surf["veneer"]["enumeration"]["wall_s"],
                   "enumeration_tree_estimate":
                       surf["veneer"]["enumeration"]["tree_estimate"]},
        "X5_gradient": {"checks": pr["checks"], **pr["timing"]},
        "X4_device_gso": surf["gso"]}


def pruner_entry(surf) -> dict:
    """The `kernels` line's entry of pruner_grad_kernel: its launches on
    phase 6's prune runs (both -a pru ends and the veneer's Pruning.run),
    its checks, and its d = 30 times (probability metric, 31 rows)
    beside the bounds."""
    pr = surf["pruner"]
    t = pr["timing"]["probability"]
    by_run = {f"-a pru -pruend {end}": r["runs"]["card"]["kernel_launches"]
              for end, r in pr["pru"].items()}
    by_run["Pruning.run"] = surf["veneer"]["pruning_run"]["kernel_launches"]
    return {
        "name": "pruner_grad_kernel",
        "route": "cuda",
        "source": "fplll_tpu_torch/csrc/pruner_grad.cu",
        "replaces": "fplll_tpu/pruner/jaxgrad.py:29",
        "replaces_sites": ["fplll_tpu/pruner/jaxgrad.py:29",
                           "fplll_tpu/pruner/jaxgrad.py:108"],
        "launches": sum(by_run.values()),
        "launches_by_run": by_run,
        "max_abs_err": pr["checks"]["max_abs_err"],
        "ms": t["kernel_ms"],
        "ms_by_metric": {k: v["kernel_ms"] for k, v in pr["timing"].items()},
        "wrapper_ms": t["wrapper_ms"],
        "plain_ms": t["plain_card_ms"],
        "plain_cpu_ms": t["plain_cpu_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "chain_ops": t["chain_ops"],
        "fma_latency_ns": t["fma_latency_ns"],
        "chain_floor_ms": t["chain_floor_ms"],
        "ns_per_dependent_op": t["ns_per_dependent_op"],
        "profiler_ms": t["profiler_ms"],
        "library_ms": None,
        "card_kernels_per_call": (t["card_run"] or {}).get("kernels"),
        "plain_card_kernels_per_call": t["plain_card_run_kernels"],
        "check": "pass",
        "tolerance": "gradient norm-relative "
                     f"{GRAD30_TOL['probability']} (probability) and "
                     f"{GRAD30_TOL['expected solutions']} (expected "
                     "solutions) against the plain version on the card and "
                     f"on CPU tensors at d in {list(GRAD_CHECK_DS)}, the "
                     f"log-target to {GRAD_VALUE_RTOL} relative; non-finite "
                     "where the plain version is",
        "shape": {"d": t["d"], "rows": t["rows"], "threads": t["threads"],
                  "smem_bytes": t["smem_bytes"]},
    }


# ---------------------------------------------------------------------------
# phase 7: the mesh (parallel/mesh.py) on the card
# ---------------------------------------------------------------------------
# shards: one per card where more than one is visible (at most four), else
# four sharing the one card, each on a stream of its own
MESH_SHARDS = 4
# roots per shard in a first sweep: the facade's batch_per_device at four
# cards, max(128, 1024 // 4)
MESH_BATCH = 256
# the count tree: phase 2's dim-56 window at 0.85 of its shortest vector;
# the falling-bound search: phase 2's shrink window (d = 40, 1.3 times)
MESH_COUNT = (56, 4, 0.85)
MESH_SEARCH = (40, 3, 1.3)
# the skewed tree: tests/test_mesh.py's q-ary shape at d = 40 and 1.2
# times its Gaussian-heuristic radius (5.7e7 nodes in the C core)
MESH_SKEW = (40, 9, 1.2)


def mesh_shards(shards=MESH_SHARDS) -> list:
    import torch
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(min(n, shards))]
    return [torch.device("cuda", 0)] * shards


def qary_window(d: int, seed: int, radius: float):
    """An LLL-reduced gen_qary_bits(d, d/2, 10) basis, its normalized
    (mu^T, r) and `radius` times its Gaussian-heuristic squared radius."""
    import numpy as np
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops import gen

    RandGen.init_with_seed(seed)
    b = gen.gen_qary_bits(d, d // 2, 10)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, d)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag)
    log_ball = d / 2 * math.log(math.pi) - math.lgamma(d / 2 + 1)
    gh2 = math.exp(float(np.mean(np.log(rdiag))) - 2.0 * log_ball / d)
    return b, mut, rdiag, radius * gh2


def overlapping(iv, distinct_cards: bool) -> bool:
    """Whether two of the (start, end, card) intervals overlap (on two
    different cards, with `distinct_cards`)."""
    return any(a[0] < b[1] and b[0] < a[1] and
               (not distinct_cards or a[2] != b[2])
               for k, a in enumerate(iv) for b in iv[k + 1:])


def sweep_stats(trace) -> dict:
    """What the recorder's sweeps hold (fplll_tpu_torch.trace, the
    snapshot's `sweeps`): sweeps and steals; per shard its launches
    per form, its launch-to-collect times (median and largest, ms, host
    clock) and its kernel ms (CUDA events); and, over the sweeps where two
    or more shards launched, in how many two shards' event intervals
    overlapped: `sweeps_with_launches_pending_together` (a shard's kernel
    was queued before another's had ended: the host did not serialize the
    launches; on one card the interval also holds the wait for SMs, so
    this is not concurrency there), and `sweeps_with_cards_busy_together`
    (two different cards ran their kernels at the same time; None where
    the shards share one card)."""
    import statistics
    per, multi, pending, busy, steals = {}, 0, 0, 0, 0
    cards = set()
    for sweep in trace:
        for r in sweep:
            steals += r["stole"]
            if "form" not in r:
                continue        # a shard that launched nothing but stole
            sh = per.setdefault(r["shard"], {"launches": {}, "l2c": [],
                                             "kernel_ms": 0.0})
            sh["launches"][r["form"]] = sh["launches"].get(r["form"], 0) + 1
            sh["l2c"].append(r["launch_to_collect_ms"])
            sh["kernel_ms"] += r.get("kernel_ms", 0.0)
        iv = [(r["start_s"], r["end_s"], r["device"]) for r in sweep
              if "start_s" in r]
        cards.update(c for *_, c in iv)
        if len(iv) > 1:
            multi += 1
            pending += overlapping(iv, False)
            busy += overlapping(iv, True)
    return {"sweeps": len(trace), "steals": steals,
            "shards": {f"shard{i}": {
                "launches": sh["launches"],
                "launch_to_collect_ms_median": statistics.median(sh["l2c"]),
                "launch_to_collect_ms_max": max(sh["l2c"]),
                "kernel_ms_sum": sh["kernel_ms"]}
                for i, sh in sorted(per.items())},
            "sweeps_with_several_launching": multi,
            "sweeps_with_launches_pending_together": pending,
            "sweeps_with_cards_busy_together":
                busy if len(cards) > 1 else None}


def on_mesh(fn, forms):
    """fn() with the recorder on and the launch counts zeroed just
    before it and read just after it, so that they are the mesh run's
    own: (its result, wall s, sweep_stats with `launches` per form). The
    run must have launched each of `forms`."""
    from fplll_tpu_torch import trace
    from fplll_tpu_torch.enum import kernels
    kernels.reset_launch_counts()
    trace.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    finally:
        snap = trace.stop()
    stats = sweep_stats(snap.sweeps)
    stats["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    stats["extended_launches"] = extended_launch_count()
    for form in forms:
        assert stats["launches"].get(form, 0) > 0, \
            f"the mesh run launched no {form} ({stats['launches']})"
    return out, wall, stats


def mesh_pair(name, mesh, device, batch, mut, rdiag, A, count_mode):
    """One f32 tree through ShardedEnumerator and through one card's
    DeviceEnumerator on the same roots (its batch is the mesh helper's):
    the record, both enumerators and both evaluators."""
    import numpy as np
    import torch
    from fplll_tpu_torch.enum.device import DeviceEnumerator
    from fplll_tpu_torch.enum.evaluator import FastEvaluator
    from fplll_tpu_torch.parallel.mesh import ShardedEnumerator

    cp0 = np.zeros(len(rdiag))
    se = ShardedEnumerator(mesh, batch_per_device=batch, dtype=torch.float32)
    ev_m, ev_s = FastEvaluator(), FastEvaluator()
    _, wall_m, stats = on_mesh(lambda: se.enumerate(
        mut, rdiag, None, cp0, A, True, ev_m, count_mode=count_mode),
        ("single",))
    single = DeviceEnumerator(batch=batch * mesh.size, device=device)
    t0 = time.perf_counter()
    single.enumerate(mut, rdiag, None, cp0, A, True, ev_s,
                     count_mode=count_mode)
    rec = {"case": name, "mesh_wall_s": wall_m,
           "single_card_wall_s": time.perf_counter() - t0,
           "nodes": int(se.nodes.sum()),
           "single_card_nodes": int(single.nodes.sum()), **stats}
    assert (stats["sweeps"], stats["steals"]) == (se.sweeps, se.last_steals)
    return rec, se, single, ev_m, ev_s


def phase_mesh(device, devices=None, batch=MESH_BATCH, count=MESH_COUNT,
               search=MESH_SEARCH, skew=MESH_SKEW, svp=(SVP_DIM, SVP_SEED),
               svp_norm=None, trials=(80, 60)) -> dict:
    """Phase 7: parallel/mesh.py over four shards (mesh_shards), each
    check beside the same work on one card: a count tree (the single
    card's solutions, its per-level nodes to assert_nodes_close's
    tolerance, since both launch donating kernels), a
    falling-bound search (the exact norm the single card and the C core
    find), a skewed count tree (the same, and at least one steal), phase
    5's proved SVP through the public function with the facade's mesh
    hook pointed at the shards (f64, the host route's exact norm
    `svp_norm`) and phase 2's grouped trials through mesh_enumerate_trials
    (f64, its default; union best: the C core's, certified).
    Launch counts are zeroed just before each mesh run and read just
    after it (on_mesh), so that `launches` sums the mesh runs alone, not
    the single-card comparisons. Sizes are parameters so that the phase
    can be rehearsed small on CPU shards."""
    import numpy as np
    from fplll_tpu_torch.algs.svpcvp import shortest_vector
    from fplll_tpu_torch.enum import device as device_mod
    from fplll_tpu_torch.native import native_enumerate
    from fplll_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_enum_mesh(devices=devices or mesh_shards())
    mesh_launches = tmesh.ShardedEnumerator.launches
    recs = []

    # the count tree: exactly the single card's counts
    _, mut, rdiag, _, A, _ = uniform_window(count[0], count[1], False,
                                            count[2])
    rec, se, single, ev_m, ev_s = mesh_pair(
        f"count d{count[0]} r{count[2]}", mesh, device, batch, mut, rdiag,
        A, True)
    rec.update(sol_count=ev_m.sol_count, single_card_sol_count=ev_s.sol_count,
               counts_equal=bool(np.array_equal(se.nodes, single.nodes)))
    log("mesh " + json.dumps(rec))
    assert_nodes_close(rec["case"], se.nodes, single.nodes)
    assert ev_m.sol_count == ev_s.sol_count, rec
    recs.append(rec)

    # the falling-bound search: the shortest vector's exact norm
    b, mut, rdiag, _, A, _ = uniform_window(search[0], search[1], False,
                                            search[2])
    rec, se, single, ev_m, ev_s = mesh_pair(
        f"search d{search[0]} r{search[2]}", mesh, device, batch, mut,
        rdiag, A, False)
    c_core = native_enumerate(mut, rdiag, None, None, A, True, False, False)
    rec.update(norm_mesh=exact_norm(b, ev_m.begin()[1]),
               norm_single_card=exact_norm(b, ev_s.begin()[1]),
               norm_c_core=exact_norm(b, c_core[2]))
    log("mesh " + json.dumps(rec))
    assert rec["norm_mesh"] == rec["norm_single_card"] == \
        rec["norm_c_core"] > 0, rec
    recs.append(rec)

    # the skewed tree: exact counts, and drained shards stole work
    _, mut, rdiag, A = qary_window(*skew)
    rec, se, single, ev_m, ev_s = mesh_pair(
        f"skewed q-ary count d{skew[0]} r{skew[2]}", mesh, device, batch,
        mut, rdiag, A, True)
    rec.update(sol_count=ev_m.sol_count,
               counts_equal=bool(np.array_equal(se.nodes, single.nodes)))
    log("mesh " + json.dumps(rec))
    assert_nodes_close(rec["case"], se.nodes, single.nodes)
    assert ev_m.sol_count == ev_s.sol_count, rec
    assert rec["steals"] >= 1, f"no shard stole work: {rec}"
    recs.append(rec)

    # phase 5's proved SVP through the public function, f64 over the mesh
    bs = intrel_basis(*svp)
    saved = device_mod._visible_mesh
    device_mod._visible_mesh = lambda dev: mesh
    try:
        (sm, xm), wall_m, stats = on_mesh(
            lambda: shortest_vector(bs.copy(), device=device), ("f64",))
    finally:
        device_mod._visible_mesh = saved
    saved = os.environ.get("FPLLL_TPU_MESH")
    os.environ["FPLLL_TPU_MESH"] = "0"     # one card, also among several
    try:
        t0 = time.perf_counter()
        ss, xs = shortest_vector(bs.copy(), device=device)
        wall_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["FPLLL_TPU_MESH"]
        else:
            os.environ["FPLLL_TPU_MESH"] = saved
    if svp_norm is None:
        svp_norm = sum(v * v for v in lattice_point(
            bs, shortest_vector(bs.copy(), backend="cpu")[1]))
    rec = {"case": f"proved SVP d{svp[0]} seed {svp[1]} (f64, facade)",
           "mesh_wall_s": wall_m, "single_card_wall_s": wall_s,
           "norm_mesh": sum(v * v for v in lattice_point(bs, xm)),
           "norm_single_card": sum(v * v for v in lattice_point(bs, xs)),
           "norm_host": svp_norm, "status": [sm, ss], **stats}
    log("mesh " + json.dumps(rec))
    assert sm == ss == 0 and rec["norm_mesh"] == rec["norm_single_card"] \
        == svp_norm > 0, rec
    assert stats["sweeps"] > 0, "the proved SVP did not reach the mesh"
    recs.append(rec)

    # phase 2's grouped trials, one per shard, the bound shared between
    # sweeps, in f64 as in the JAX package; the single card's grouped
    # launch (f32) beside it
    gt = grouped_trials(device, *trials)
    G = len(gt["bases"])
    maxd = np.full(G, gt["union_best_c"] * GROUPED_RADIUS)
    (dists, sols, nodes), wall_m, stats = on_mesh(
        lambda: tmesh.mesh_enumerate_trials(mesh, gt["muts"], gt["rdiags"],
                                            gt["prunes"], maxd), ("f64",))
    t0 = time.perf_counter()
    one = device_mod._grouped_device_windows(gt["muts"], gt["rdiags"],
                                             gt["prunes"], maxd, device)
    wall_s = time.perf_counter() - t0
    g = int(np.argmin(dists))
    exact = math.ldexp(exact_norm(gt["bases"][g], sols[g]), -gt["normexp"])
    c_best = gt["union_best_c"]
    rec = {"case": f"grouped trials G={G} block {trials[1]} (mesh_enumerate"
                   "_trials)", "mesh_wall_s": wall_m,
           "single_card_wall_s": wall_s, "union_best": float(dists[g]),
           "single_card_union_best": float(np.min(one[0])),
           "exact_norm": exact, "c_core_union_best": c_best,
           "certified_trials": gt["certified"], "nodes": int(nodes.sum()),
           **stats}
    log("mesh " + json.dumps(rec))
    assert math.isfinite(rec["union_best"]), rec
    assert abs(exact - c_best) <= 1e-9 * c_best, rec
    assert abs(rec["union_best"] - exact) <= 1e-9 * exact, rec
    recs.append(rec)

    launches = {}
    for r in recs:
        for form, n in r["launches"].items():
            launches[form] = launches.get(form, 0) + n
    out = {"shards": [str(d) for d in mesh.devices], "launches": launches,
           "extended_launches": sum(r["extended_launches"] for r in recs),
           "mesh_runs": tmesh.ShardedEnumerator.launches - mesh_launches,
           "checks": recs}
    return out


# ---------------------------------------------------------------------------
# phase 8: the variant reductions (self-dual BKZ, slide reduction, HKZ)
# ---------------------------------------------------------------------------
# the variant tours' block; slide reduction runs on gen_qary_bits(120, 60,
# 30), seed 11, LLL-reduced: a dimension the block divides, two primal
# windows and one dual window per loop
VARIANT_BLOCK, SLIDE_DIM = 60, 120
# the HKZ profile (r_ii of the exact Gram) against the host-only run's,
# relative: a generic lattice has one shortest vector up to sign, so an
# HKZ-reduced basis has one profile
HKZ_RTOL = 1e-9


class VariantSpy(WindowAnswers):
    """What one variant reduction did, through whichever route it took:
    WindowAnswers' card searches and answers; the windows the facade took
    (enum/device.py:device_external_enumerator not declining), primal and
    dual, and of those the ones it sent to the card (a card search ran)
    against the ones its native first pass finished; the launches per
    form; the nodes of the reduction (BKZReduction.bkz); and the seconds
    in the facade's enumerations."""

    def __enter__(self):
        import inspect

        from fplll_tpu_torch.algs.bkz import BKZReduction
        from fplll_tpu_torch.enum import api, device, kernels

        super().__enter__()
        kernels.reset_launch_counts()
        self.facade_windows = {"primal": 0, "dual": 0}
        self.card_windows = {"primal": 0, "dual": 0}
        self.facade_enum_s, self.nodes = 0.0, 0
        self._registered = api.registered_enumerator()
        facade = api.Enumeration.enumerate
        ext = device.device_external_enumerator
        bkz = BKZReduction.bkz
        self._saved += [(api.Enumeration, "enumerate", facade),
                        (device, "device_external_enumerator", ext),
                        (BKZReduction, "bkz", bkz)]
        ext_args = inspect.signature(ext).bind
        spy = self

        def facade_enumerate(*a, **kw):
            t0 = time.perf_counter()
            try:
                return facade(*a, **kw)
            finally:
                spy.facade_enum_s += time.perf_counter() - t0

        def external(*a, **kw):
            kind = "dual" if ext_args(*a, **kw).arguments["dual"] \
                else "primal"
            searches = spy.searches
            out = ext(*a, **kw)
            if out is not None:
                spy.facade_windows[kind] += 1
                spy.card_windows[kind] += spy.searches > searches
            return out

        def reduction(self_):
            try:
                return bkz(self_)
            finally:
                spy.nodes += int(self_.nodes)

        api.Enumeration.enumerate = facade_enumerate
        device.device_external_enumerator = external
        BKZReduction.bkz = reduction
        if self._registered is ext:
            api.set_external_enumerator(external)
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.enum import api, kernels

        super().__exit__(*exc)
        if api.get_external_enumerator() is not self._registered:
            api.set_external_enumerator(self._registered)
        self.launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        self.extended_launches = extended_launch_count()
        return False

    def record(self, wall_s: float) -> dict:
        return {"wall_s": wall_s, "launches": self.launches,
                "extended_launches": self.extended_launches,
                "route": "C tour" if self.c_tour_windows else
                "Python engine" if sum(self.facade_windows.values()) else
                "host",
                "facade_windows_to_card": self.card_windows,
                "facade_windows_native_first_pass": {
                    k: self.facade_windows[k] - self.card_windows[k]
                    for k in self.card_windows},
                "c_tour_windows_to_card": self.c_tour_windows,
                # nodes of the card searches (the kernel and its root
                # expansion) over those of the whole reduction
                "nodes": self.nodes, "card_search_nodes": self.search_nodes,
                "device_node_share": self.search_nodes / max(self.nodes, 1),
                # the Python engine's seconds in the facade's enumerations
                # (native first passes, card searches, host oracle) and
                # the rest of the wall: preprocessing, LLL, insertion
                "facade_enum_s": self.facade_enum_s,
                "card_search_s": self.search_s,
                "outside_enum_s": wall_s - self.facade_enum_s,
                "drift": self.drift()}


class HostOnly:
    """Every window on the host: the facade's backend declines every job
    (a user's set_external_enumerator; the host oracle, the native C core,
    takes it) and the C tour's crossover is 0, which hands it no window."""

    def __enter__(self):
        from fplll_tpu_torch.enum import api

        self._registered = api.registered_enumerator()
        api.set_external_enumerator(lambda *a, **kw: None)
        self._env = HybridNodes(0).__enter__()
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.enum import api

        api.set_external_enumerator(self._registered)
        self._env.__exit__(*exc)
        return False


def run_fplll(argv, b, codes=(0,)):
    """`fplll <argv>` in this process on basis b, whose exit code must be
    one of `codes`: the reduced basis."""
    from fplll_tpu_torch.cli import main as fplll
    from fplll_tpu_torch.ops.intmat import format_matrix, parse_matrix

    rc, out = run_cli(fplll, argv, format_matrix(b))
    assert rc in codes, (argv, rc, out[-500:])
    return parse_matrix(out)


# Phase 8's six legs (three reductions, each with the card and
# host-only) are CPU-bound Python (the variant tours run on the Python
# engine: SD-BKZ's one tour took 505-710 s with the card or without it
# on the card's machine), so each runs in a process of its own and the
# smoke's wall holds the longest leg, not their sum. The host-only legs
# start after phase 1 and run beside phases 2-7 on the CPU alone: they
# do not see the card (CUDA_VISIBLE_DEVICES empty, FPLLL_TORCH_DEVICE=
# cpu). Phase 2's kernel runs, whose times the kernels line reports,
# have the card to itself. SD-BKZ's card leg cannot follow phase 7
# within the smoke's limit (the smoke then ended 58-64 s short of it),
# nor follow the whole of phase 2 on a slow host (phase 2 took 112-203
# s, almost all of it plain-version runs, and on the host where it took
# 203 s the leg ran more than 900 s), so it starts once
# phase 2's kernels have run and runs beside phase 2's checks against
# the plain version and phases 3-7: its card searches take about 4 s of
# its wall, in about 60 launches, and the kernels line marks the plain
# versions' times and the gradient kernel's, from phase 6, as taken
# beside it. The other
# card legs start after phase 7. Phase 2's grouped plain check, two or
# three minutes of a host-bound loop of small launches, runs beside them
# once HKZ's reduction has ended (HKZ's card searches fill the card for
# seconds). A leg prints VARIANT_REDUCED when its reduction ends and
# VARIANT_LEG <json>, its record, when it is done; phase 8 reads the
# record.
VARIANT_RUNS = ("sd-bkz", "slide", "hkz")
# seconds from the smoke's start by which every leg must have ended (the
# smoke's own limit is 1200 s)
VARIANT_DEADLINE_S = 1150
SMOKE_T0 = time.perf_counter()


def variant_input(run, device, warm=(80, (40, 50)), slide_dim=SLIDE_DIM,
                  hkz_dim=SVP_DIM):
    """The input basis of one of phase 8's reductions: phase 3's warm-up
    basis (SD-BKZ), the LLL-reduced q-ary basis of `slide_dim` (slide)
    or phase 5's proved-SVP basis (HKZ); each made as its phase makes
    it, from its seed. Sizes are parameters only so the phase can be
    rehearsed small."""
    from fplll_tpu_torch.algs.wrapper import lll_reduction
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.gen import gen_qary_bits

    if run == "sd-bkz":
        return qary_warm_basis(device, *warm)
    if run == "slide":
        RandGen.init_with_seed(11)
        b = gen_qary_bits(slide_dim, slide_dim // 2, 30)
        lll_reduction(b)
        return b
    return intrel_basis(hkz_dim, SVP_SEED)


def variant_call(run, device, block=VARIANT_BLOCK):
    """(case name, call(b) -> reduced copy of b, forms the card's run
    must launch) of one of phase 8's reductions through the port's
    public entry points."""
    from fplll_tpu_torch.algs.bkz import bkz_reduction
    from fplll_tpu_torch.algs.bkz_param import BKZParam, load_strategies_json
    from fplll_tpu_torch.defs import (BKZ_GH_BND, BKZ_MAX_LOOPS,
                                      BKZ_SD_VARIANT, RED_BKZ_LOOPS_LIMIT)

    if run == "sd-bkz":
        strategies = load_strategies_json("default.json")

        def sd_bkz(b):
            b = b.copy()
            bkz_reduction(b, BKZParam(block, strategies, flags=BKZ_GH_BND |
                                      BKZ_MAX_LOOPS | BKZ_SD_VARIANT,
                                      max_loops=1), device=device)
            return b
        return (f"SD-BKZ block {block}, one tour", sd_bkz,
                ("single", "f32-dual"))
    if run == "slide":
        argv = ["-a", "sld", "-b", str(block), "-s", "default.json",
                "-bkzmaxloops", "1"]
        # one loop ends at the loop limit (exit code 8) unless it is clean
        return (f"slide block {block}, one loop",
                lambda b: run_fplll(argv, b, (0, RED_BKZ_LOOPS_LIMIT)),
                ("single", "f32-dual"))
    return "HKZ", lambda b: run_fplll(["-a", "hkz"], b), ("f64",)


def save_windows(path: str, windows) -> None:
    """WindowAnswers.windows into one .npz file (load_windows)."""
    import numpy as np
    np.savez(path, **{f"{i}_{j}": a for i, w in enumerate(windows)
                      for j, a in enumerate(w)})


def load_windows(path: str) -> list:
    import numpy as np
    with np.load(path) as z:
        n = len({k.split("_")[0] for k in z.files})
        return [tuple(z[f"{i}_{j}"] for j in range(5)) for i in range(n)]


class LaunchRecorder:
    """Inside the block, keeps the inputs and the answer of every launch
    of one form that DeviceEnumerator makes (through enum/device.py's
    enum_run): the packed tensors as numpy arrays, the root queue cut
    after its last live root (its padded length kept), the scalars, and
    the best distance, solution count and nodes that came back. `save`
    writes them into one .npz file (load_launches)."""

    def __init__(self, form: str):
        self.form, self.launches = form, []

    def __enter__(self):
        import numpy as np
        import torch
        from fplll_tpu_torch.enum import device, kernels

        self._saved = device.enum_run
        spy = self

        def enum_run(**kw):
            out = spy._saved(**kw)
            if kernels._form(kw["mut"].dtype, kw.get("dual", False),
                             kw.get("findsubsols", False)) != spy.form:
                return out
            rpd = kw["roots_pd"].cpu().numpy()
            live = int(np.flatnonzero(np.isfinite(rpd)).max(initial=-1)) + 1
            rec = {k: v.cpu().numpy()[:live] if k in (
                "roots_x", "roots_a", "roots_pd") else v.cpu().numpy()
                for k, v in kw.items() if isinstance(v, torch.Tensor)}
            rec["scalars"] = np.array(
                [kw["m"], kw["m_real"], kw["is_svp"], kw["count_mode"],
                 kw["dual"], kw["findsubsols"], len(rpd)], dtype=np.int64)
            rec["A0"] = np.array(float(kw["A0"]))
            rec["answer"] = np.array(
                [float(out["best_dist"][0]), float(out["sol_count"]),
                 float(out["nodes"].sum())])
            spy.launches.append(rec)
            return out

        device.enum_run = enum_run
        return self

    def __exit__(self, *exc):
        from fplll_tpu_torch.enum import device

        device.enum_run = self._saved
        return False

    def save(self, path: str) -> None:
        import numpy as np
        np.savez(path, **{f"{i}/{k}": v for i, rec in
                          enumerate(self.launches) for k, v in rec.items()})


def load_launches(path: str) -> list:
    """LaunchRecorder.save's launches: per launch the keyword arguments of
    kernels.enum_run (numpy arrays, the root queue padded back as the
    enumerator padded it) and the answer (best distance, solution count,
    nodes)."""
    import numpy as np
    out = {}
    with np.load(path) as z:
        for key in z.files:
            i, name = key.split("/")
            out.setdefault(int(i), {})[name] = z[key]
    launches = []
    for i in sorted(out):
        rec = out[i]
        m, m_real, is_svp, count_mode, dual, subsols, R = (
            int(v) for v in rec.pop("scalars"))
        for name in ("roots_x", "roots_a", "roots_pd"):
            if name in rec:
                a = rec[name]
                pad = np.full((R - len(a),) + a.shape[1:],
                              np.inf if name == "roots_pd" else 0.0,
                              dtype=a.dtype)
                rec[name] = np.concatenate([a, pad])
        launches.append({"kw": dict(
            {k: v for k, v in rec.items() if k not in ("A0", "answer")},
            A0=float(rec["A0"]), m=m, m_real=m_real, is_svp=bool(is_svp),
            count_mode=bool(count_mode), dual=bool(dual),
            findsubsols=bool(subsols)), "answer": rec["answer"]})
    return launches


def variant_leg(run, leg, device, **sizes) -> dict:
    """One leg of one of phase 8's reductions, in this process: with the
    card at the default crossovers (no FPLLL_TPU_HYBRID_NODES in the
    environment: the facade's 2M, the C tour's 60M) or host-only, from
    RandGen seed 12. Leg "repeat" is a second card leg, whose answers are
    not certified (HKZ's: its window lists against the first card leg's).
    Returns its record, with what the checks need of the input and the
    output: a digest of the input, LLL-reducedness and root-Hermite
    factors, the first vector's squared norm and the r_ii profile (exact
    Gram); a card leg of HKZ also writes the window lists the C tour
    handed to the card into a file (`windows_file`, load_windows), and
    SD-BKZ's card leg the inputs and answers of its `f32-dual` launches
    (`dual_launches_file`, load_launches)."""
    import contextlib
    import hashlib
    import tempfile

    import numpy as np
    import torch
    from fplll_tpu_torch.nr.rng import RandGen
    from fplll_tpu_torch.ops.intmat import format_matrix

    block = sizes.pop("block", VARIANT_BLOCK)
    start = variant_input(run, device, **sizes)
    case, call, forms = variant_call(run, device, block)
    os.environ.pop("FPLLL_TPU_HYBRID_NODES", None)
    RandGen.init_with_seed(12)
    recorder = LaunchRecorder("f32-dual") if (run, leg) == ("sd-bkz", "card") \
        else contextlib.nullcontext()
    with HostOnly() if leg == "host" else contextlib.nullcontext(), \
            VariantSpy() as spy, recorder:
        span = [time.time()]
        t0 = time.perf_counter()
        out = call(start)
        if leg != "host":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        span.append(time.time())
    print("VARIANT_REDUCED", flush=True)
    windows_file = None
    if run == "hkz" and leg != "host":
        fd, windows_file = tempfile.mkstemp(prefix="chip_smoke_hkz_windows_",
                                            suffix=".npz")
        os.close(fd)
        save_windows(windows_file, spy.windows)
        print(f"VARIANT_WINDOWS {windows_file}", flush=True)
    launches_file = None
    if isinstance(recorder, LaunchRecorder):
        fd, launches_file = tempfile.mkstemp(
            prefix="chip_smoke_sd_bkz_dual_", suffix=".npz")
        os.close(fd)
        recorder.save(launches_file)
    t0 = time.perf_counter()
    cert = spy.certify() if leg != "repeat" else {"answers": 0}
    cert["seconds"] = time.perf_counter() - t0
    _, rhf_start = gso_stats(start)
    red, rhf = gso_stats(out)
    _, r, e = gso_of(out)
    return {"case": f"{case}, dim {start.nrows}", "leg": leg,
            "forms": forms, **spy.record(wall), "f64_certificate": cert,
            # the reduction's start and end, seconds since the epoch
            "span": span,
            "start_digest": hashlib.sha256(
                format_matrix(start).encode()).hexdigest(),
            "lll_reduced": red, "rhf_start": rhf_start, "rhf": rhf,
            "norm_b1": sum(int(v) ** 2 for v in out.a[0]),
            "profile": [float(x) for x in np.ldexp(r, e)],
            "windows_file": windows_file, "dual_launches_file": launches_file}


def start_variant_leg(run, leg) -> dict:
    """One of phase 8's legs (card, repeat or host) in a process of its
    own running this script with --variant-leg, its output to a temporary
    file; numpy's and torch's thread pools held to one thread each, as a
    leg is one Python thread. A host-only leg runs on the CPU and does not
    see the card."""
    import tempfile

    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    device = "cuda"
    if leg == "host":
        env.update(CUDA_VISIBLE_DEVICES="", FPLLL_TORCH_DEVICE="cpu")
        device = "cpu"
    fd, path = tempfile.mkstemp(prefix=f"chip_smoke_{run}_{leg}_",
                                suffix=".txt")
    with os.fdopen(fd, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--variant-leg",
             run, leg, device], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT, env=env, start_new_session=True)
    log(f"phase 8: {run} {leg} leg started ({path})")
    return {"run": run, "leg": leg, "proc": proc, "path": path}


def leg_output(lg) -> str:
    with open(lg["path"]) as f:
        return f.read()


def leg_windows_file(lg) -> str:
    """The window-list file of an HKZ card leg, once it has written it
    (its VARIANT_WINDOWS line, printed before the leg certifies its
    answers)."""
    while True:
        text = leg_output(lg)
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("VARIANT_WINDOWS ")), None)
        if line is not None:
            return line[len("VARIANT_WINDOWS "):]
        assert lg["proc"].poll() is None, \
            f"phase 8: the {lg['run']} {lg['leg']} leg ended without its " \
            f"window lists\n{text[-3000:]}"
        assert time.perf_counter() - SMOKE_T0 < VARIANT_DEADLINE_S, \
            f"phase 8: the {lg['run']} {lg['leg']} leg did not end in time"
        time.sleep(0.5)


def start_card_legs(legs: list, runs) -> None:
    """Phase 8's card legs of `runs`, appended to `legs` as they start."""
    for run in runs:
        legs.append(start_variant_leg(run, "card"))


def wait_reduced(lg) -> None:
    """Until leg `lg` has printed VARIANT_REDUCED or ended."""
    while lg["proc"].poll() is None and \
            "VARIANT_REDUCED" not in leg_output(lg):
        assert time.perf_counter() - SMOKE_T0 < VARIANT_DEADLINE_S, \
            f"phase 8: the {lg['run']} {lg['leg']} leg did not end in time"
        time.sleep(0.5)


def stop_variant_legs(legs) -> None:
    """Kill every leg still running, with whatever it started."""
    import signal

    for lg in legs:
        if lg["proc"].poll() is None:
            os.killpg(lg["proc"].pid, signal.SIGKILL)
            lg["proc"].wait()


def collect_variant_legs(legs) -> dict:
    """Wait for the legs, each until VARIANT_DEADLINE_S after the smoke's
    start; {(run, leg): record}. A leg that fails, or prints no record,
    fails the phase with its output's tail."""
    recs = {}
    for lg in legs:
        left = VARIANT_DEADLINE_S - (time.perf_counter() - SMOKE_T0)
        try:
            rc = lg["proc"].wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        text = leg_output(lg)
        line = next((ln for ln in text.splitlines()
                     if ln.startswith("VARIANT_LEG ")), None)
        assert rc == 0 and line is not None, \
            f"phase 8 leg {lg['run']} {lg['leg']}: exit {rc}\n{text[-3000:]}"
        recs[(lg["run"], lg["leg"])] = json.loads(line[len("VARIANT_LEG "):])
    return recs


def phase_variants(legs, svp_norm) -> list:
    """Phase 8: self-dual BKZ (one tour at block 60 on phase 3's warm-up
    basis, bkz_reduction), slide reduction (one loop at block 60 on an
    LLL-reduced dim-120 q-ary basis, `fplll -a sld`) and HKZ (phase 5's
    proved-SVP basis, `fplll -a hkz`) through the port's public entry
    points, each with the card and host-only (the legs), from the same
    input. The card's runs launch their forms; SD-BKZ and slide keep 95%
    of the host-only run's root-Hermite gain (phase 3's gate); HKZ gives
    phase 5's proved norm and the host-only run's profile. Each record
    says how long its card and host-only legs ran at the same time: walls
    taken together are not compared."""
    import numpy as np

    recs = collect_variant_legs(legs)
    out = []
    for run in VARIANT_RUNS:
        card, host = recs[(run, "card")], recs[(run, "host")]
        (c0, c1), (h0, h1) = card["span"], host["span"]
        rec = {"case": card["case"],
               "card": {k: v for k, v in card.items() if k != "profile"},
               "host": {k: v for k, v in host.items() if k != "profile"},
               "legs_overlap_s": max(0.0, min(c1, h1) - max(c0, h0))}
        log("variant " + json.dumps(rec))
        assert card["start_digest"] == host["start_digest"], \
            f"{run}: the legs started from different bases"
        assert not host["launches"], f"{run}: the host-only run launched"
        for form in card["forms"]:
            assert card["launches"].get(form, 0) > 0, \
                f"{run}: no {form} launch on the card ({card['launches']})"
        # every f64 answer (an unpruned window's) at its f64 norm
        assert card["drift"]["f64"]["beyond_1e-9"] == 0, \
            (run, card["drift"])
        assert card["lll_reduced"] and host["lll_reduced"], \
            f"{run}: output not LLL-reduced"
        if run == "hkz":
            rc, rh = np.array(card["profile"]), np.array(host["profile"])
            rel = float(np.max(np.abs(rc - rh) / rh))
            rec.update(route=card["route"], proved_svp_norm=svp_norm,
                       profile_max_rel_diff=rel)
            log("variant-hkz " + json.dumps({
                "route": rec["route"], "norm_card": card["norm_b1"],
                "norm_host": host["norm_b1"], "proved_svp_norm": svp_norm,
                "profile_max_rel_diff": rel}))
            assert card["norm_b1"] == host["norm_b1"] == svp_norm, \
                (card["norm_b1"], host["norm_b1"], svp_norm)
            assert rel <= HKZ_RTOL, rel
            # HKZ's windows are unpruned: f64 only, and the f64 C core
            # finds no shorter vector behind any card answer
            assert set(card["launches"]) == {"f64"}, card["launches"]
            assert card["drift"]["f32"]["answers"] == 0 < \
                card["drift"]["f64"]["answers"], card["drift"]
            cert = card["f64_certificate"]
            assert cert["certified"] == cert["answers"] > 0, cert
            repeat = recs.get(("hkz", "repeat"))
            if repeat is not None:
                rec["window_lists"] = compare_window_lists(
                    load_windows(card["windows_file"]),
                    load_windows(repeat["windows_file"]))
                rec["window_lists"]["repeat_launches"] = repeat["launches"]
                log("variant-hkz-windows " + json.dumps(rec["window_lists"]))
                assert repeat["norm_b1"] == svp_norm, repeat["norm_b1"]
        else:
            r0, rc, rh = card["rhf_start"], card["rhf"], host["rhf"]
            rec["quality"] = {"rhf_start": r0, "rhf_card": rc,
                              "rhf_host": rh,
                              "gain_share": (r0 - rc) / (r0 - rh)
                              if r0 != rh else None}
            log(f"variant-quality {run} " + json.dumps(rec["quality"]))
            assert rh < r0, (run, rh, r0)
            assert rc - rh <= 0.05 * (r0 - rh), (run, rec["quality"])
        out.append(rec)
    return out


def compare_window_lists(a, b) -> dict:
    """Two HKZ legs' window lists (load_windows): their lengths, whether
    every list (muts, rdiags, prunes, maxdists) is equal bit for bit in
    the same order, and, where not, the first list that differs: its
    index, window dimension in each leg and which arrays differ."""
    import numpy as np
    names = ("mut", "rdiag", "prune", "maxdist")
    out = {"lists": [len(a), len(b)], "equal": True}
    for i in range(max(len(a), len(b))):
        wa = a[i] if i < len(a) else None
        wb = b[i] if i < len(b) else None
        differ = [n for n, x, y in zip(names, wa or (), wb or ())
                  if x.shape != y.shape or not np.array_equal(x, y)] \
            if wa is not None and wb is not None else list(names)
        if differ:
            out.update(equal=False, first_difference={
                "index": i, "arrays": differ,
                "dims": [None if w is None else int(w[1].shape[-1])
                         for w in (wa, wb)]})
            break
    out["dims"] = [int(w[1].shape[-1]) for w in a]
    return out


def replay_hkz_windows(windows, device,
                       turns=(False, True, True, False)) -> dict:
    """Phase 8's HKZ card leg's window lists (load_windows), handed to
    device_enumerate_windows again on this card, once per entry of
    `turns` (False: the f64 primal instance, True: the extended one), in
    that order: per turn the kernel ms of each list's f64 launches (CUDA
    events around the wrapper) and their sum, the launches and the
    longest work item's steps; every answer within F64_DIST_TOL of the
    leg's own, on both instances. Independent of how many windows a run
    sends: the same lists on both instances."""
    import numpy as np
    from fplll_tpu_torch.enum import device as device_mod

    out = {"lists": len(windows), "f64 primal": [], "extended": []}
    worst = 0.0
    for ext in turns:
        per, launches, steps = [], 0, []
        with OnInstance(ext) as inst:
            for muts, rdiags, prunes, maxd, leg_dists in windows:
                n = len(inst.ms)
                dists, _, _ = device_mod.device_enumerate_windows(
                    muts, rdiags, prunes, maxd, device=device)
                per.append(sum(inst.ms[n:]))
                steps.append(max(inst.root_steps[n:], default=0))
                launches += len(inst.ms) - n
                dists = np.asarray(dists, dtype=np.float64)
                assert np.array_equal(np.isfinite(dists),
                                      np.isfinite(leg_dists)), \
                    (dists, leg_dists)
                fin = np.isfinite(dists)
                if fin.any():
                    rel = float(np.max(np.abs(dists[fin] - leg_dists[fin]) /
                                       leg_dists[fin]))
                    assert rel <= F64_DIST_TOL, (ext, rel)
                    worst = max(worst, rel)
        out["extended" if ext else "f64 primal"].append({
            "kernel_ms_sum": sum(per), "kernel_ms_per_list": per,
            "launches": launches, "root_steps_per_list": steps,
            "other_forms": inst.other})
    out["largest_rel_diff_from_leg"] = worst
    return out


# relative difference of a replayed f32 answer from the leg's own: the
# f32 bound slack, the rule phase 8 holds f32 answers to
F32_REPLAY_RTOL = 1e-5


def replay_launches(launches, device, new,
                    turns=(False, True, True, False)) -> dict:
    """Launches recorded by LaunchRecorder (load_launches) made again on
    this card, once per entry of `turns` (False: the instance of their
    form, labelled `new`; True: the extended one, kernels._enum_run_extended),
    in that order: per turn the kernel ms of each launch (CUDA events
    around the wrapper) and their sum, and the longest work item's steps;
    every answer's best distance the leg's own to F32_REPLAY_RTOL (finite
    where the leg's was)."""
    import numpy as np
    import torch
    from fplll_tpu_torch.enum import kernels

    on_card = [{k: torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v
                for k, v in rec["kw"].items()} for rec in launches]
    out = {"launches": len(launches), new: [], "extended": []}
    worst = 0.0
    for ext in turns:
        run = kernels._enum_run_extended if ext else kernels.enum_run
        per, steps, skips = [], [], 0
        for kw, rec in zip(on_card, launches):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            res = run(**kw)
            t1.record()
            torch.cuda.synchronize()
            per.append(t0.elapsed_time(t1))
            steps.append(int(res.get("root_steps", 0)))
            skips += int(res["barren_skips"])
            got, leg = float(res["best_dist"][0]), float(rec["answer"][0])
            assert math.isfinite(got) == math.isfinite(leg), (ext, got, leg)
            if math.isfinite(leg):
                rel = abs(got - leg) / leg
                assert rel <= F32_REPLAY_RTOL, (ext, got, leg)
                worst = max(worst, rel)
        out["extended" if ext else new].append({
            "kernel_ms_sum": sum(per), "kernel_ms_per_launch": per,
            "root_steps_per_launch": steps, "barren_skips": skips})
    out["largest_rel_diff_from_leg"] = worst
    return out


def variant_numbers(recs) -> dict:
    """Phase 8's line: per run the walls and how long the two legs ran
    together, launches per form, the route, windows on the card against
    the native first pass, the device node share, the f32 drift and the
    f64 certificate."""
    keys = ("wall_s", "launches", "route", "facade_windows_to_card",
            "facade_windows_native_first_pass", "c_tour_windows_to_card",
            "device_node_share", "facade_enum_s", "card_search_s",
            "outside_enum_s", "drift", "f64_certificate", "process_s")
    return {r["case"]: {"card": {k: r["card"][k] for k in keys},
                        "host_wall_s": r["host"]["wall_s"],
                        "host_process_s": r["host"]["process_s"],
                        **{k: r[k] for k in ("legs_overlap_s", "quality",
                                             "profile_max_rel_diff",
                                             "window_lists")
                           if k in r}}
            for r in recs}


# ---------------------------------------------------------------------------
# registers of the six f32 instances of BKZ-2.0, (M, SMEM) -> registers,
# as the source compiles them (nvcc 12.9, the flags of
# kernels.build_kernel), with no stack frame and no spills: a change to
# the shared walk must leave them as they are, or re-pin them here and
# say why ((64, True) 77 -> 80 and (128, False) 100 -> 101 when the walk
# began to take the shared bound every 4 iterations from a load issued 4
# iterations earlier)
BKZ_F32_PTXAS = {(32, False): 73, (32, True): 64, (64, False): 80,
                 (64, True): 80, (128, False): 101, (128, True): 100}
# the walk of each templated instance (EnumWalk in csrc/enum_chunk.cu)
WALK_KERNELS = {"dual": "enum_chunk_dual_kernel",
                "subsols": "enum_chunk_subsols_kernel",
                "dual-subsols": "enum_chunk_dual_subsols_kernel",
                "extended": "enum_chunk_ext_kernel"}


def ptxas_instances(build_log: str) -> dict:
    """Per instance of enum_chunk_kernel (f32 primal),
    enum_chunk_f64_kernel (f64 primal), enum_chunk_dual_kernel,
    enum_chunk_subsols_kernel, enum_chunk_dual_subsols_kernel and
    enum_chunk_ext_kernel in nvcc's `-Xptxas -v` output: (element type,
    M, W, SMEM, walk: "primal", "dual", "subsols", "dual-subsols" or
    "extended") -> (registers, stack frame, spill stores, spill
    loads)."""
    out, key = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            t = re.match(r"_Z\d+enum_chunk_kernelILi(\d+)ELi(\d+)ELb([01])E",
                         m.group(1))
            f = re.match(r"_Z\d+enum_chunk_f64_kernelILi(\d+)ELi(\d+)E",
                         m.group(1))
            key = None
            if t is not None:
                key = ("float", int(t.group(1)), int(t.group(2)),
                       t.group(3) == "1", "primal")
            if f is not None:
                key = ("double", int(f.group(1)), int(f.group(2)), True,
                       "primal")
            for walk, name in WALK_KERNELS.items():
                e = re.match(rf"_Z\d+{name}I([fd])Li(\d+)ELi(\d+)E",
                             m.group(1))
                if e is not None:
                    key = ("double" if e.group(1) == "d" else "float",
                           int(e.group(2)), int(e.group(3)), True, walk)
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


def ptxas_function(build_log: str, name: str) -> tuple | None:
    """(registers, stack frame, spill stores, spill loads) of the one
    function whose mangled name contains `name` in nvcc's `-Xptxas -v`
    output."""
    out, inside = [None, None, None, None], False
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            inside = name in m.group(1)
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[0] = int(m.group(1))
    return tuple(out) if out[0] is not None else None


def f64_geometries(ms=(32, 64, 128)) -> dict:
    """Blocks per SM, grid and walkers of the launcher's persistent grid
    for both f64 instances, the f64 primal one and the extended one, at
    each height bucket (one problem, its shared memory)."""
    from fplll_tpu_torch.enum import kernels

    return walk_geometries((("f64 primal", "double", kernels.WALK_PRIMAL),
                            ("extended", "double", kernels.WALK_EXT)), ms)


def walk_geometries(instances, ms=(32, 64, 128)) -> dict:
    """The same for each (label, element type, walk) of `instances`."""
    import torch
    from fplll_tpu_torch.enum import kernels

    out = {}
    for name, elem, walk in instances:
        dtype = torch.float64 if elem == "double" else torch.float32
        for M in ms:
            g = kernels._geometry(M, 1, dtype, walk)
            out[f"{name} M={M}"] = {k: g[k] for k in (
                "blocks_per_sm", "grid", "walkers", "smem")}
    return out


def walk_instances():
    """(label, element type, walk code) of the dual, sub-solution,
    combined and extended instances of both element types, the label as
    the kernels line writes it ("f64-dual", "f64-dual-subsols",
    "f32-extended", ...)."""
    from fplll_tpu_torch.enum import kernels

    codes = {"dual": kernels.WALK_DUAL, "subsols": kernels.WALK_SUBSOLS,
             "dual-subsols": kernels.WALK_DUAL_SUBSOLS,
             "extended": kernels.WALK_EXT}
    return [(f"{'f64' if elem == 'double' else 'f32'}-{walk}", elem, code)
            for walk, code in codes.items() for elem in ("float", "double")]


def phase_build() -> dict:
    """Phase 1: build both kernels at once (one nvcc per source, started
    together), print every instance's registers, stack frame and spills,
    and assert the enumeration kernel's instance set (the six f32
    instances of BKZ-2.0, M x SMEM, the f64 primal instance per M, and
    the dual, sub-solution, combined and extended walks per element type
    and M), that none of them has a stack frame or spills, that the six
    f32 instances compile to the registers of BKZ_F32_PTXAS, and that the
    pruner's gradient kernel has no stack frame and no spills. Prints
    blocks per SM and walkers of both f64 instances and of the dual,
    sub-solution, combined and extended instances of both element types
    at M = 32, 64 and 128, and asserts at least two blocks per SM for the
    f64 primal, the f64 dual and the f64 combined instances at M = 32 and
    64."""
    from concurrent.futures import ThreadPoolExecutor

    from fplll_tpu_torch.enum import kernels
    from fplll_tpu_torch.pruner import torchgrad

    def build(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(build, fn) for fn in (
            kernels.build_kernel, torchgrad.build_kernel,
            pruner_profile_lib, fma_probe_lib)]
        build_s, pruner_s, profile_s, probe_s = (f.result() for f in futures)
    wall = time.perf_counter() - t0
    release = subprocess.run([kernels._nvcc(), "--version"],
                             capture_output=True, text=True).stdout
    log(f"build enum_chunk.cu and pruner_grad.cu together, with this "
        f"script's PRUNER_GRAD_PROFILE build and FMA probe (nvcc "
        f"{release.strip().splitlines()[-1]}): {wall:.3f} s "
        f"(enum_chunk {build_s:.3f} s, pruner_grad {pruner_s:.3f} s, "
        f"profile {profile_s:.3f} s, probe {probe_s:.3f} s)")
    for line in (kernels.BUILD_LOG + torchgrad.BUILD_LOG).strip().splitlines():
        log(f"  ptxas: {line.strip()}")
    inst = ptxas_instances(kernels.BUILD_LOG)
    log("ptxas: (type, M, W, SMEM, walk) -> (registers, stack frame, "
        "spill stores, spill loads): " + json.dumps(
            {str(k): v for k, v in sorted(inst.items())}))
    pruner_ptxas = ptxas_function(torchgrad.BUILD_LOG, "pruner_grad_kernel")
    log(f"ptxas: pruner_grad_kernel -> {pruner_ptxas} (the "
        "PRUNER_GRAD_PROFILE build: " + str(ptxas_function(
            pruner_profile_lib()[1], "pruner_grad_kernel")) + ")")
    assert pruner_ptxas is not None, "no pruner_grad_kernel in the build"
    assert pruner_ptxas[1:] == (0, 0, 0), \
        f"pruner_grad_kernel has a stack frame or spills: {pruner_ptxas}"
    bkz = {("float", M, 32, sm, "primal"): (regs, 0, 0, 0)
           for (M, sm), regs in BKZ_F32_PTXAS.items()}
    walks = {(t, M, 32, True, w) for t in ("float", "double")
             for M in (32, 64, 128) for w in WALK_KERNELS}
    f64 = {("double", M, 32, True, "primal") for M in (32, 64, 128)}
    assert set(inst) == set(bkz) | walks | f64, f"instances {sorted(inst)}"
    assert all(v[1] == v[2] == v[3] == 0 for v in inst.values()), \
        "an instance has a stack frame or spills"
    for k, v in bkz.items():
        assert inst[k] == v, f"{k}: {inst[k]} against {v}"
    f64_ptxas = {f"{name} M={M}": inst[("double", M, 32, True, w)]
                 for name, w in (("f64 primal", "primal"),
                                 ("extended", "extended"))
                 for M in (32, 64, 128)}
    geo = f64_geometries()
    log("f64 instances: (registers, stack frame, spill stores, spill "
        "loads) " + json.dumps(f64_ptxas) + "; persistent grid " +
        json.dumps(geo))
    for M in (32, 64):
        assert geo[f"f64 primal M={M}"]["blocks_per_sm"] >= 2, geo
    walk_ptxas = {f"{label} M={M}": inst[(elem, M, 32, True,
                                          label.split("-", 1)[1])]
                  for label, elem, _ in walk_instances()
                  for M in (32, 64, 128)}
    walk_geo = walk_geometries(walk_instances())
    log("walk instances: (registers, stack frame, spill stores, spill "
        "loads) " + json.dumps(walk_ptxas) + "; persistent grid " +
        json.dumps(walk_geo))
    for M in (32, 64):
        for label in ("f64-dual", "f64-dual-subsols"):
            assert walk_geo[f"{label} M={M}"]["blocks_per_sm"] >= 2, walk_geo
    return {"nvcc_s": build_s, "pruner_nvcc_s": pruner_s, "wall_s": wall,
            "instances": len(inst), "pruner_ptxas": pruner_ptxas,
            "f64_ptxas": f64_ptxas, "f64_geometry": geo,
            "walk_ptxas": walk_ptxas, "walk_geometry": walk_geo}


# the kernel each form of the proved solvers launches
KERNEL_OF = {"f64": "enum_chunk_f64_kernel<M, 32>",
             "f32-dual": "enum_chunk_dual_kernel<float, M, 32> f32-dual",
             "f64-dual": "enum_chunk_dual_kernel<double, M, 32> f64-dual",
             "f32-subsols":
             "enum_chunk_subsols_kernel<float, M, 32> f32-subsols",
             "f64-subsols":
             "enum_chunk_subsols_kernel<double, M, 32> f64-subsols",
             "f32-dual-subsols": "enum_chunk_dual_subsols_kernel<float, M, "
             "32> f32-dual-subsols",
             "f64-dual-subsols": "enum_chunk_dual_subsols_kernel<double, M, "
             "32> f64-dual-subsols"}


def extended_entries(ext_recs, svp_recs, path_counts, ext_path,
                     build_rec=None, replay=None,
                     dual_replay=None) -> list:
    """The `kernels` line's entry of each form of the proved solvers: its
    phase-2 numbers (count mode, and search mode where it ran) and its
    launches on phase 5's path and on phases 6-8 (`path_counts`). The
    `f64` form's entry is the f64 primal instance's, with the same trees
    on the extended instance beside it: phase 2's d = 40 tree, phase 5's
    proved SVP and phase 8's replayed HKZ windows (`replay`), and both
    instances' registers and geometry from phase 1 (`build_rec`). The
    dual, sub-solution and combined forms' entries are their instances',
    each with `ext_instances`: phase 2's tree on both, and for `f64-dual`
    phase 5's dual SVP, for `f64-dual-subsols` phase 5's dual SVP with
    sub-solutions, for `f32-dual` SD-BKZ's replayed launches
    (`dual_replay`). A last entry is the extended instance's, which runs
    the comparisons only: its launches on the paths, per phase in
    `ext_path`."""
    launches = dict(path_counts)
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
            "name": KERNEL_OF[form],
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
            "tolerance": "without donation: count mode's per-level "
                         "nodes, solution count and sub-solution distances "
                         "exactly equal, best distance bit-equal; with it: "
                         "solution count equal, nodes 1% in total and 2% "
                         "per level above 200, distances to "
                         f"{EXT_RTOL['f64' if elem == 'double' else 'f32']} "
                         "relative",
            "shape": {k: c[k] for k in ("dim", "m", "m_real", "nfix", "R",
                                        "R_real")},
            "geometry": {k: c[k] for k in (
                "walkers", "grid", "longest_walker_walk",
                "longest_item_walk", "busy_share", "donations",
                "barren_skips")},
        })
        if form == "f64":
            entries[-1]["f64_instances"] = f64_instance_numbers(
                by_mode, svp_recs, build_rec, replay)
        else:
            entries[-1]["ext_instances"] = ext_instance_numbers(
                form, by_mode, svp_recs, build_rec, dual_replay)
    entries.append(ext_kernel_entry(ext_recs, ext_path))
    return entries


def ext_instance_numbers(form, by_mode, svp_recs, build_rec,
                         dual_replay) -> dict:
    """A dual, sub-solution or combined entry's comparison of its
    instance with the extended one, each measured in this run on this
    card: phase 2's d = 40 tree (kernel ms in turns per mode, ns per step
    at a grid of one block, the latency floor, barren skips), for
    `f64-dual` phase 5's dual SVP and for `f64-dual-subsols` phase 5's
    dual SVP with sub-solutions (kernel ms and wall per call), for
    `f32-dual` SD-BKZ's replayed launches (kernel ms summed per turn),
    registers and geometry."""
    new = INSTANCE_OF[form]
    key = {"f64-dual": "dual_instances",
           "f64-dual-subsols": "dual_subsols_instances"}.get(form)
    dual = next((r[key] for r in svp_recs if key in r), None)
    out = {}
    for inst in (new, "extended"):
        label = f"{form[:3]}-{'extended' if inst == 'extended' else new}"
        rec = {
            "d40_kernel_ms": {m: r["instances"]["kernel_ms"][inst]
                              for m, r in by_mode.items()},
            "d40_count": by_mode["count"]["instances"][inst],
            "ptxas_M64": None if build_rec is None else
            build_rec["walk_ptxas"][f"{label} M=64"],
            "geometry": None if build_rec is None else
            {k: v for k, v in build_rec["walk_geometry"].items()
             if k.startswith(label + " ")}}
        if dual is not None:
            rec["dual_svp"] = dual["tree"]
            rec["dual_svp_kernel_ms"] = [r["kernel_ms"] for r in dual[inst]]
            rec["dual_svp_wall_s"] = [r["wall_s"] for r in dual[inst]]
        if form == "f32-dual" and dual_replay is not None:
            rec["sd_bkz_replay_kernel_ms"] = [
                r["kernel_ms_sum"] for r in dual_replay[inst]]
        out[inst] = rec
    return out


def ext_kernel_entry(ext_recs, ext_path) -> dict:
    """The extended instance's entry: comparisons only, its launches on
    the paths (`ext_path`, per phase; every form launches its own
    instance, so none), and its numbers from
    phase 2's comparisons, where it ran each f64, dual, sub-solution and
    combined tree beside the form's instance: the f64 dual d = 40 count
    tree's first kernel ms on it, that tree's plain version and bound,
    and its largest difference from the plain version over every
    comparison."""
    comps = [r for r in ext_recs if r["form"] in INSTANCE_OF]
    c = next(r for r in comps if (r["form"], r["mode"]) ==
             ("f64-dual", "count"))
    return {
        "name": "enum_chunk_ext_kernel<T, M, 32> (comparisons only)",
        "route": "cuda",
        "source": "fplll_tpu_torch/csrc/enum_chunk.cu",
        "replaces": "fplll_tpu/enum/tpu.py:213 (_enum_run, dual and "
                    "findsubsols as runtime flags)",
        "launches": sum(ext_path.values()),
        "launches_by_phase": ext_path,
        "max_abs_err": max(r["instances"]["extended_best_abs_err"]
                           for r in comps),
        "ms": c["instances"]["kernel_ms"]["extended"][0],
        "ms_tree": "the f64-dual d = 40 count tree",
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None,
        "check": "pass",
        "tolerance": "best and sub-solution distances to EXT_RTOL "
                     f"({EXT_RTOL}) of the plain version's, count mode's "
                     "nodes 1% in total and 2% per level above 200, the "
                     "solution count equal",
    }


def f64_instance_numbers(by_mode, svp_recs, build_rec, replay) -> dict:
    """The f64 entry's comparison of its two instances, each measured in
    this run on this card: phase 2's d = 40 tree (kernel ms in turns per
    mode, ns per step at a grid of one block, the latency floor), phase
    5's proved SVP (kernel ms and wall per call), phase 8's HKZ windows
    replayed (kernel ms summed per turn), registers and geometry."""
    out = {}
    for inst in ("f64 primal", "extended"):
        c = by_mode["count"]["instances"]
        svp = next((r["f64_instances"][inst] for r in svp_recs
                    if "f64_instances" in r), [])
        out[inst] = {
            "d40_kernel_ms": {m: r["instances"]["kernel_ms"][inst]
                              for m, r in by_mode.items()},
            "d40_count": c[inst],
            "proved_svp_kernel_ms": [r["kernel_ms"] for r in svp],
            "proved_svp_wall_s": [r["wall_s"] for r in svp],
            "hkz_replay_kernel_ms": None if replay is None else
            [r["kernel_ms_sum"] for r in replay[inst]],
            "ptxas_M64": None if build_rec is None else
            build_rec["f64_ptxas"][f"{inst} M=64"],
            "geometry": None if build_rec is None else
            {k: v for k, v in build_rec["f64_geometry"].items()
             if k.startswith(inst)}}
    return out


def mesh_numbers(rec) -> dict:
    """Phase 7's line: the shards, launches per form, and each check's
    walls on the mesh and on one card, sweeps, steals and per-shard
    launches."""
    keys = ("mesh_wall_s", "single_card_wall_s", "launches", "sweeps",
            "steals", "sweeps_with_several_launching",
            "sweeps_with_launches_pending_together",
            "sweeps_with_cards_busy_together", "shards")
    return {"shards": rec["shards"], "launches": rec["launches"],
            "mesh_runs": rec["mesh_runs"],
            "checks": {c["case"]: {k: c[k] for k in keys if k in c}
                       for c in rec["checks"]}}


def this_run_walls(main_rec, svp_recs, mesh_rec, var_recs) -> dict:
    """This run's walls under the keys of PR5_RECORDED_WALLS_S, and phase
    8's: [with the card, host-only, seconds the two legs ran together]."""
    walls = {"phase 3: block-60 tour with the card":
             main_rec["device_tour_wall_s"]}
    for r in svp_recs:
        if "card" in r and "host" in r:
            walls[f"phase 5: {r['case']}"] = r["card"]["wall_s"]
    for c in mesh_rec["checks"]:
        walls[f"phase 7: {c['case']}"] = [c["mesh_wall_s"],
                                          c["single_card_wall_s"]]
    for r in var_recs:
        walls[f"phase 8: {r['case']}"] = [r["card"]["wall_s"],
                                          r["host"]["wall_s"],
                                          r["legs_overlap_s"]]
    return walls


def contract_line() -> int:
    """The last line: what the run ran on."""
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# run by --pruner-ab in the checkout under test, whose package it imports:
# its kernel's build, then this script's checks and timing (argv[1]), one
# JSON line
PRUNER_AB_RUN = """
import importlib.util, json, sys
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
from fplll_tpu_torch.pruner import torchgrad
torchgrad.build_kernel()
ptxas = c.ptxas_function(torchgrad.BUILD_LOG, "pruner_grad_kernel")
checks = c.pruner_kernel_checks("cuda")
timing = c.pruner_kernel_timing("cuda", profile=False)
print("PRUNER_AB " + json.dumps({"ptxas": ptxas, "checks": checks,
                                 "timing": timing}), flush=True)
"""


def pruner_ab(others: list) -> int:
    """--pruner-ab: the gradient kernel of the `others` checkouts and of
    this one in turns (others, this, this, the others reversed), each a
    process of its own in its checkout, checked and timed by this
    script's pruner_kernel_checks and pruner_kernel_timing."""
    runs = []
    for tree in [*others, ROOT, ROOT, *others[::-1]]:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", PRUNER_AB_RUN,
                              os.path.abspath(__file__)],
                             cwd=tree, capture_output=True, text=True,
                             timeout=600)
        line = next((ln for ln in res.stdout.splitlines()
                     if ln.startswith("PRUNER_AB ")), None)
        if res.returncode != 0 or line is None:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(line[len("PRUNER_AB "):])
        runs.append({"tree": "this" if tree == ROOT else tree,
                     "wall_s": time.perf_counter() - t0,
                     "ptxas": rec["ptxas"],
                     "max_abs_err": rec["checks"]["max_abs_err"],
                     **{label: {k: v[k] for k in (
                         "kernel_ms", "profiler_ms", "loop_kernel_ms",
                         "wrapper_ms")}
                        for label, v in rec["timing"].items()}})
        log("pruner-ab " + json.dumps(runs[-1]))
    log(card_line())
    log(json.dumps({"pruner_ab": runs}))
    return 0


def proved_svp_norm(device) -> int:
    """Phase 5's proved SVP norm, from the card alone (phase 5 holds it
    equal to the host's): phase 8's HKZ check where phase 5 did not
    run."""
    from fplll_tpu_torch.algs.svpcvp import shortest_vector

    b = intrel_basis(SVP_DIM, SVP_SEED)
    status, x = shortest_vector(b.copy(), device=device)
    assert status == 0, status
    return sum(v * v for v in lattice_point(b, x))


def variant_leg_main(run: str, leg: str, device: str) -> int:
    """--variant-leg: one leg of phase 8 in this process (started by
    start_variant_leg), its record as one line."""
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rec = variant_leg(run, leg, device)
    rec["process_s"] = time.perf_counter() - t0
    print("VARIANT_LEG " + json.dumps(rec), flush=True)
    return 0


def main(mesh_only: bool = False, variants_only: bool = False) -> int:
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

    device = "cuda"
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- phase 1: build ----------------------------------------------------
    build_rec = phase_build()
    for name, get in (("enum_core", native.get_lib),
                      ("lll_core", native.get_lll_lib),
                      ("bkz_core", native.get_bkz_lib)):
        t0 = time.perf_counter()
        lib = get()
        assert lib is not None, f"native {name} did not load"
        log(f"build {name}.c (cc): {time.perf_counter() - t0:.3f} s")

    if mesh_only:
        # phase 7 alone, for a machine with several cards (the proved
        # SVP's norm then comes from the host route)
        log(f"{torch.cuda.device_count()} cards visible")
        t0 = time.perf_counter()
        mesh_rec = phase_mesh(device)
        log(f"phase 7 done in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"phase7": mesh_numbers(mesh_rec)}))
        log(card)
        return contract_line()

    # phase 8's host-only legs run beside phases 2-7 (or, with
    # --variants, beside the card legs), each in a process of its own
    legs = [start_variant_leg(run, "host") for run in VARIANT_RUNS]
    try:
        if variants_only:
            # phase 8 alone, on the inputs phases 3 and 5 would have made
            t0 = time.perf_counter()
            norm = proved_svp_norm(device)
            start_card_legs(legs, VARIANT_RUNS)
            var_recs = phase_variants(legs, norm)
            log(f"phase 8 done in {time.perf_counter() - t0:.1f} s")
            log(json.dumps({"phase8": variant_numbers(var_recs)}))
            log(card)
            return contract_line()
        return all_phases(device, card, legs, build_rec)
    finally:
        stop_variant_legs(legs)


def all_phases(device, card, legs, build_rec) -> int:
    """Phases 2-8 (phase 8's host-only legs already running; `legs`
    takes its card legs too, SD-BKZ's once phase 2's kernels have run,
    the others after phase 7, and HKZ's repeat leg once HKZ's card leg
    has reduced) and the last two lines."""
    from fplll_tpu_torch.enum import kernels

    # -- phase 2: kernel against plain version -----------------------------
    t0 = time.perf_counter()
    forms, plain_checks, timing, grouped_plain = phase_kernel_checks(device)
    ext_recs, ext_checks = phase_extended_checks(device)
    log(f"phase 2's kernel runs done in {time.perf_counter() - t0:.1f} s")
    # phase 8's longest leg, beside phase 2's plain-version checks and
    # phases 3-7 (VARIANT_RUNS' comment)
    start_card_legs(legs, ("sd-bkz",))
    max_err = max(check() for check in plain_checks)
    for check in ext_checks:
        check()
    log("phase-2 walks " + json.dumps({
        f"{r['form']} {r['mode']}": {k: r[k] for k in (
            "kernel_ms", "donations", "busy_share", "longest_item_walk",
            "longest_walker_walk", "barren_skips")}
        for r in forms + ext_recs}))
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

    # -- phase 6: the user surfaces ------------------------------------------
    t0 = time.perf_counter()
    surf = phase_surfaces(device)
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
    surface_counts = surface_launches(surf)

    # -- phase 7: the mesh ---------------------------------------------------
    t0 = time.perf_counter()
    mesh_rec = phase_mesh(device, svp_norm=svp_recs[0]["norm_host"])
    log(f"phase 7 done in {time.perf_counter() - t0:.1f} s")
    mesh_counts = mesh_rec["launches"]

    # -- phase 8: the variant reductions -------------------------------------
    t0 = time.perf_counter()
    start_card_legs(legs, ("slide", "hkz"))
    hkz_card = next(lg for lg in legs
                    if (lg["run"], lg["leg"]) == ("hkz", "card"))
    wait_reduced(hkz_card)
    repeat = start_variant_leg("hkz", "repeat")
    legs.append(repeat)
    max_err = max(max_err, grouped_plain())
    # HKZ's windows again on both f64 instances, once the repeat leg has
    # reduced: beside the SD-BKZ and slide card legs, whose card searches
    # take about 1% of their walls, and off the smoke's longest path (the
    # SD-BKZ card leg)
    wait_reduced(repeat)
    t1 = time.perf_counter()
    replay = replay_hkz_windows(load_windows(leg_windows_file(hkz_card)),
                                device)
    log(f"hkz-replay ({time.perf_counter() - t1:.1f} s) " +
        json.dumps(replay))
    var_recs = phase_variants(legs, svp_recs[0]["norm_host"])
    # SD-BKZ's f32-dual launches again on both f32 dual instances, once
    # its card leg (the last to end) has ended
    t1 = time.perf_counter()
    dual_replay = replay_launches(
        load_launches(var_recs[0]["card"]["dual_launches_file"]), device,
        "dual")
    log(f"sd-bkz-dual-replay ({time.perf_counter() - t1:.1f} s) " +
        json.dumps(dual_replay))
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s (the host-only "
        "legs ran beside phases 2-7, the SD-BKZ card leg beside phase 2's "
        "plain-version checks and phases 3-7, "
        "phase 2's grouped plain check beside the card legs and HKZ's "
        "repeat leg, the HKZ replay beside the SD-BKZ and slide card legs)")
    variant_counts = {}
    for r in var_recs:
        for form, n in r["card"]["launches"].items():
            variant_counts[form] = variant_counts.get(form, 0) + n
    path_counts = {k: surface_counts.get(k, 0) + mesh_counts.get(k, 0) +
                   variant_counts.get(k, 0)
                   for k in set(surface_counts) | set(mesh_counts) |
                   set(variant_counts)}
    # the extended instance's launches on the paths (the comparison turns
    # are not path runs): none, every form runs its own instance
    ext_path = {
        "phase3": main_rec["extended_launches"],
        "phase5": sum(r["card"]["extended_launches"] for r in svp_recs),
        "phase6": surface_extended_launches(surf),
        "phase7": mesh_rec["extended_launches"],
        "phase8": sum(r["card"]["extended_launches"] for r in var_recs)}
    assert not any(ext_path.values()), \
        f"the extended instance launched on a path: {ext_path}"

    grouped = next(f for f in forms if f["form"].startswith("grouped"))
    by_form = {"queue d56 count r0.7": timing["kernel_ms"],
               f"queue d56 count r{D56_KERNEL_RADIUS} (kernel alone)":
               timing[f"kernel_ms_at_{D56_KERNEL_RADIUS}"],
               f"{grouped['form']} search": grouped["kernel_ms"]}
    log("recorded times of the one-thread-per-lane kernel (PERF.md "
        "section 6, not measured in this run): "
        + json.dumps(LANE_KERNEL_RECORDED_MS))
    log(json.dumps({"phase6": phase6_numbers(surf, surface_counts)}))
    log(json.dumps({"phase7": mesh_numbers(mesh_rec)}))
    log(json.dumps({"phase8": variant_numbers(var_recs)}))
    log("walls of this run (s): " + json.dumps(this_run_walls(
        main_rec, svp_recs, mesh_rec, var_recs)))
    log("walls recorded for PR 5 (PERF.md, not measured in this run): "
        + json.dumps(PR5_RECORDED_WALLS_S))
    log(card)
    entries = [{
        "name": "enum_chunk_kernel",
        "route": "cuda",
        "source": "fplll_tpu_torch/csrc/enum_chunk.cu",
        "replaces": "fplll_tpu/enum/pallas_kernel.py:136",
        "replaces_sites": ["fplll_tpu/enum/pallas_kernel.py:728",
                           "fplll_tpu/enum/pallas_kernel.py:792",
                           "fplll_tpu/enum/pallas_kernel.py:925",
                           "fplll_tpu/enum/pallas_kernel.py:961"],
        "launches": sum(main_rec["launches"].values()) +
        path_counts.get("single", 0) + path_counts.get("grouped", 0),
        "launches_by_wrapper": main_rec["launches"],
        "launches_phase6": {k: surface_counts.get(k, 0)
                            for k in ("single", "grouped")},
        "launches_phase7": {k: mesh_counts.get(k, 0)
                            for k in ("single", "grouped")},
        "launches_phase8": {k: variant_counts.get(k, 0)
                            for k in ("single", "grouped")},
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
            "longest_walker_walk", "longest_item_walk", "busy_share",
            "donations", "barren_skips")},
    }] + extended_entries(ext_recs, svp_recs, path_counts, ext_path,
                          build_rec, replay, dual_replay) + \
        [pruner_entry(surf)]
    for e in entries:
        # the kernels' times come from phase 2's kernel runs, the plain
        # versions' from its checks, the gradient kernel's from phase 6
        # (VARIANT_RUNS' comment)
        e["measured_beside"] = (
            "phase 8's three host-only legs: single-thread CPU processes "
            "that do not see the card; plain_ms also beside phase 8's "
            "SD-BKZ card leg")
    entries[-1]["measured_beside"] += (
        "; and phase 8's SD-BKZ card leg, whose card searches took "
        f"{var_recs[0]['card']['card_search_s']:.2f} s of its "
        f"{var_recs[0]['card']['wall_s']:.1f} s wall")
    f64 = next(e for e in entries if "f64_instances" in e)
    f64["measured_beside"] += (
        "; its HKZ replay also beside phase 8's SD-BKZ and slide card "
        "legs, whose card searches took "
        f"{var_recs[0]['card']['card_search_s']:.2f} s and "
        f"{var_recs[1]['card']['card_search_s']:.2f} s of their walls")
    log(json.dumps({"kernels": entries}))
    return contract_line()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pruner-ab"] and len(sys.argv) >= 3:
        sys.exit(pruner_ab([os.path.abspath(a) for a in sys.argv[2:]]))
    if sys.argv[1:2] == ["--variant-leg"] and len(sys.argv) == 5:
        sys.exit(variant_leg_main(*sys.argv[2:5]))
    sys.exit(main(mesh_only=sys.argv[1:] == ["--mesh"],
                  variants_only=sys.argv[1:] == ["--variants"]))
