"""BKZ simulator: predicts the GSO profile of a BKZ-beta reduced basis.

The port's copy of the JAX package's algs/simulator.py (pure host
Python), reading the port's own copy of the calibrated tail,
strategies/hkz_tail.json.

Implements the Chen-Nguyen simulation algorithm ("BKZ 2.0: Better
Lattice Security Estimates", ASIACRYPT 2011, Algorithm 3): each tour
replaces the leading GSO log-norm of every block with the Gaussian
heuristic of the block's volume, and fixes the final tail to the
average profile of an HKZ-reduced random lattice.

The reference library ships no simulator (strategies/default.json is
produced offline by the external strategizer, fplll's NEWS:9-10
— tuned strategies to block 90); this module is the in-tree replacement
that lets tools/gen_strategies.py optimize pruning shapes for blocks
beyond the GSA regime (the GSA slope is a poor model of real profiles
above block ~70, where the head bulge and HKZ tail matter).

Tail averages: rather than hard-coding the CN11 experimental constants,
the tail profile is CALIBRATED with this framework's own HKZ engine
(tools/calibrate_simulator_tail.py HKZ-reduces seeded random lattices
and stores the averaged, volume-normalized log-norms in
strategies/hkz_tail.json).  When the artifact is absent the
tail falls back to a Gaussian-heuristic self-consistency recursion,
which matches the calibrated averages to ~2% except on the last ~10
indices.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Sequence, Tuple

__all__ = ["simulate", "hkz_tail_profile", "simulated_block_shape",
           "TAIL_DIM"]

TAIL_DIM = 45


def _unit_ball_log_vol(d: int) -> float:
    """log vol of the d-dim unit ball."""
    return (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)


def log_gh(d: int) -> float:
    """log of the Gaussian-heuristic radius of a unit-volume dim-d
    lattice: gh = vol(B_d(1))^(-1/d)."""
    return -_unit_ball_log_vol(d) / d


def _gh_tail(tau: int) -> List[float]:
    """Fallback tail: greedy GH self-consistency for an HKZ-reduced
    unit-volume dim-tau lattice — l_k = gh(tau-k) + mean of the
    remaining log-volume, front to back."""
    tail = [0.0] * tau
    rem = 0.0  # remaining log-volume (unit volume overall)
    for k in range(tau):
        d = tau - k
        tail[k] = log_gh(d) + rem / d
        rem -= tail[k]
    # normalize exactly to zero-sum (floating error accumulates)
    mean = sum(tail) / tau
    return [t - mean for t in tail]


_TAIL_CACHE: dict = {}


def hkz_tail_profile(tau: int = TAIL_DIM) -> List[float]:
    """Zero-sum log-norm profile (natural log of ||b_i*||) of an
    HKZ-reduced random unit-volume dim-tau lattice.  Prefers the
    calibrated artifact written by tools/calibrate_simulator_tail.py."""
    if tau in _TAIL_CACHE:
        return _TAIL_CACHE[tau]
    path = os.path.join(os.path.dirname(__file__), "..", "strategies",
                        "hkz_tail.json")
    tail = None
    try:
        with open(path) as f:
            data = json.load(f)
        stored = data.get(str(tau)) or data.get(tau)
        if stored and len(stored) == tau:
            tail = [float(x) for x in stored]
            mean = sum(tail) / tau
            tail = [t - mean for t in tail]
    except (OSError, ValueError):
        pass
    if tail is None:
        tail = _gh_tail(tau)
    _TAIL_CACHE[tau] = tail
    return tail


def simulate(r: Sequence[float], beta: int, max_tours: int = 20,
             tau: int = TAIL_DIM) -> Tuple[List[float], int]:
    """Simulate BKZ-beta tours over a GSO profile.

    `r` is the squared GSO norm profile (the diagonal r_ii in any
    consistent scale, as produced by MatGSO), `beta` the block size.
    Returns (simulated squared norms, tours actually run); stops early
    when a tour is a fixed point.  Mirrors the tour/window structure of
    the real driver (algs/bkz.py; reference bkz.cpp:360-441)
    but replaces every SVP call by the Gaussian heuristic of the
    window's volume — valid for beta >~ 45 where GH concentrates.
    """
    n = len(r)
    if beta < 2 or n < 2:
        return list(r), 0
    # work in natural-log norms l_i = log ||b_i*||
    l = [0.5 * math.log(x) for x in r]
    if beta >= n:
        # full HKZ: the profile IS the tail shape
        total = sum(l)
        tail = hkz_tail_profile(n) if n >= 4 else [0.0] * n
        l = [total / n + t for t in tail]
        return [math.exp(2.0 * x) for x in l], 1
    # the tail must leave at least one head index; for n <= tau the
    # standard 45-entry tail does not fit and a shorter tail is used
    # (small-d GH estimates are less accurate — CN11 proper assumes
    # n > 45 — but far better than predicting no progress at all)
    tau_eff = min(tau, n - 1)
    tail = hkz_tail_profile(tau_eff)
    ghd = [0.0] * (beta + 1)
    for d in range(1, beta + 1):
        ghd[d] = log_gh(d)
    total = sum(l)
    tours = 0
    head_end = n - tau_eff
    for _ in range(max_tours):
        tours += 1
        old = list(l)
        # prefix sums of the previous tour's values (CN11 Algorithm 3:
        # logV of block [k, f) = old_prefix(f) - new_prefix(k) — the
        # volume shed by already-updated head indices shifts into the
        # remaining blocks within the SAME tour)
        pre_old = [0.0] * (n + 1)
        for i in range(n):
            pre_old[i + 1] = pre_old[i] + old[i]
        new_head = 0.0
        phi = True  # "no change yet" flag: heads of already-reduced
        # blocks keep their value until the first actual improvement
        for k in range(head_end):
            d = min(beta, n - k)
            f = min(k + beta, n)
            log_v = pre_old[f] - new_head
            est = log_v / d + ghd[d]
            if phi:
                if est < l[k]:
                    l[k] = est
                    phi = False
            else:
                l[k] = est
            new_head += l[k]
        log_v = total - new_head
        for j in range(tau_eff):
            l[head_end + j] = log_v / tau_eff + tail[j]
        if all(abs(a - b) < 1e-12 for a, b in zip(l, old)):
            break
    return [math.exp(2.0 * x) for x in l], tours


def simulated_block_shape(beta: int, preproc_beta: int,
                          margin: int = TAIL_DIM + 15) -> List[float]:
    """Squared-norm shape of a dim-beta enumeration window whose basis
    was BKZ-preproc_beta reduced, predicted by the simulator.

    This is what the pruning optimizer should see for large blocks: the
    reference's shipped strategies come from profiles of actually
    preprocessed bases (strategizer), not from the GSA slope.  We embed
    the window at the head of a (beta + margin)-dim simulated basis so
    the HKZ tail sits outside the window, seed with an LLL-slope GSA
    profile, and run the simulator to convergence at the preprocessing
    block size."""
    n = beta + margin
    # LLL-reduced seed: GSA with the classical LLL root-Hermite ~1.0219
    ld = math.log(1.0219)
    seed = [math.exp(-4.0 * ld * i) for i in range(n)]
    if preproc_beta < 40:
        # below the GH-concentration regime the simulator is not
        # trustworthy; callers should use the GSA shape instead
        raise ValueError("simulated_block_shape needs preproc_beta >= 40")
    shape, _ = simulate(seed, preproc_beta, max_tours=50)
    head = shape[:beta]
    # normalize so the window determinant is 1 (scale cancels in the
    # pruner, but keep magnitudes tame)
    log_mean = sum(math.log(x) for x in head) / beta
    return [math.exp(math.log(x) - log_mean) for x in head]
