"""Proved/fast SVP and CVP solvers.

The port of the JAX package's algs/svpcvp.py. Re-design of
fplll/svpcvp.cpp: precision selection from
gso_min_prec (svpcvp.cpp:106-108), trimming of rows that cannot contain
the shortest vector (last_useful_index, svpcvp.cpp:32-43), initial bound
from the minimal basis norm plus an error margin (svpcvp.cpp:168-174),
iterated-Babai recentering for CVP (svpcvp.cpp:571-595) and the
max_indices reset machinery for proved CVP (svpcvp.cpp:609-634).

Candidate solutions are verified with exact integer arithmetic
(ErrorBoundedEvaluator), so accepted results are proved. Device-sized
trees run on the card's enumeration kernel (f64 for the error-bounded
evaluators, f32 for the dual and Gram-only pipelines); `device` is the
entry points' device (cuda unless the caller asks for the CPU,
torchsetup.resolve_device), `backend="cpu"` keeps every tree on the
host.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ..defs import (CVPM_PROVED, LLL_DEF_DELTA, LLL_DEF_ETA, RED_ENUM_FAILURE,
                    RED_SUCCESS, SVP_DUAL, SVP_OVERRIDE_BND, SVP_VERBOSE,
                    SVPM_FAST, SVPM_PROVED)
from ..nr.fctx import MPCtx, gso_min_prec
from ..core.gso import MatGSO, MatGSOInterface
from ..ops.intmat import IntMat
from ..enum.evaluator import (EVALMODE_SV, ErrorBoundedEvaluator,
                              EVALSTRATEGY_BEST_N_SOLUTIONS, FastEvaluator)
from ..enum.api import Enumeration
from ..torchsetup import resolve_device

__all__ = ["shortest_vector", "shortest_vector_pruning", "closest_vector",
           "shortest_vector_ex"]


def _last_useful_index(gso: MatGSOInterface) -> int:
    """Largest prefix that can contain the SVP solution (svpcvp.cpp:32-43)."""
    ctx = gso.ctx
    rmin2 = 2.0 * ctx.to_float(gso.get_r(0, 0))
    i = gso.d - 1
    while i > 0:
        if ctx.to_float(gso.get_r(i, i)) <= rmin2:
            break
        i -= 1
    return i + 1


def _get_basis_min(gso: MatGSOInterface, first: int, last: int) -> int:
    mn = gso.get_int_gram(first, first)
    for i in range(first + 1, last):
        v = gso.get_int_gram(i, i)
        if v < mn:
            mn = v
    return mn


def shortest_vector_ex(b_or_gso, method: int = SVPM_PROVED,
                       pruning: Sequence[float] = (), flags: int = 0,
                       eval_mode: int = EVALMODE_SV, max_aux_sols: int = 0,
                       find_subsols: bool = False, backend: str | None = None,
                       device=None):
    """Core SVP solver (svpcvp.cpp:84-241 / 277-480).

    Returns (status, sol_coord, evaluator, sol_count).
    """
    device = resolve_device(device) if backend != "cpu" else None
    if isinstance(b_or_gso, IntMat):
        b = b_or_gso
        d, n = b.nrows, b.ncols
        if d == 0 or n == 0:
            raise ValueError("shortest_vector: empty matrix")
        if d > n:
            raise ValueError("shortest_vector: more vectors than dimensions")
        min_prec, rho = gso_min_prec(d, LLL_DEF_DELTA, LLL_DEF_ETA, 0.01)
        prec = max(53, min_prec + 10)
        gso = MatGSO(b, flags=1, ctx=MPCtx(prec))  # GSO_INT_GRAM
    else:
        gso = b_or_gso
        b = getattr(gso, "b", None)
        d = gso.d
    gso.update_gso()

    sol_coord = [0] * d
    new_d = _last_useful_index(gso)
    if new_d < d:
        d = new_d

    dual = bool(flags & SVP_DUAL)
    if dual:
        v, e = gso.get_r_exp(d - 1, d - 1)
        max_dist = 1.0 / math.ldexp(gso.ctx.to_float(v), e)
        int_max_dist = None
    else:
        int_max_dist = _get_basis_min(gso, 0, d)
        max_dist = float(int_max_dist)

    if b is not None and not dual:
        evaluator = ErrorBoundedEvaluator(
            b, eval_mode=eval_mode, nr_solutions=max_aux_sols + 1,
            strategy=EVALSTRATEGY_BEST_N_SOLUTIONS, find_subsolutions=find_subsols)
    else:
        # Gram-only or dual pipelines: fall back to float verification
        evaluator = FastEvaluator(nr_solutions=max_aux_sols + 1,
                                  strategy=EVALSTRATEGY_BEST_N_SOLUTIONS,
                                  find_subsolutions=find_subsols)

    if not (flags & SVP_OVERRIDE_BND) and \
            (eval_mode == EVALMODE_SV or method == SVPM_PROVED):
        # widen the bound so fp rounding in the tree cannot miss the true
        # minimum; exact evaluation keeps the result proved
        # (role of get_max_error_aux, svpcvp.cpp:168-174)
        max_dist = max_dist * (1.0 + d * 2.0 ** -30) + 2.0 ** -20

    enumobj = Enumeration(gso, evaluator, backend=backend, device=device)
    enumobj.enumerate(0, d, max_dist, 0, pruning=list(pruning), dual=dual)

    result = RED_ENUM_FAILURE
    sol_count = 0
    if eval_mode != EVALMODE_SV:
        result = RED_SUCCESS
        sol_count = evaluator.sol_count * 2
    elif not evaluator.empty():
        _, best = evaluator.begin()
        for i in range(d):
            sol_coord[i] += int(round(best[i]))
        result = RED_SUCCESS
    return result, sol_coord, evaluator, sol_count


def shortest_vector(b: IntMat, method: int = SVPM_PROVED, flags: int = 0,
                    backend: str | None = None,
                    device=None) -> Tuple[int, List[int]]:
    """Returns (status, coefficient vector of the shortest vector)."""
    st, sol, _, _ = shortest_vector_ex(b, method, (), flags, backend=backend,
                                       device=device)
    return st, sol


def shortest_vector_pruning(b: IntMat, pruning: Sequence[float],
                            flags: int = 0, max_aux_sols: int = 0,
                            find_subsols: bool = False,
                            backend: str | None = None, device=None):
    st, sol, ev, _ = shortest_vector_ex(b, SVPM_FAST, pruning, flags,
                                        max_aux_sols=max_aux_sols,
                                        find_subsols=find_subsols,
                                        backend=backend, device=device)
    return st, sol, ev


def _get_gscoords(ctx, bf, mu, r, v) -> List:
    """Coordinates of vector v on the GSO basis (svpcvp.cpp:487-515)."""
    n = mu.shape[0]
    m = len(v)
    vcoord = [ctx.scalar(0)] * n
    for i in range(n):
        s = ctx.scalar(0)
        for j in range(m):
            s = s + v[j] * bf[i, j]
        for j in range(i):
            s = s - mu[i, j] * vcoord[j]
        vcoord[i] = s
    for i in range(n):
        vcoord[i] = vcoord[i] / r[i, i]
    return vcoord


def closest_vector(b: IntMat, int_target: Sequence[int], method: int = 0,
                   flags: int = 0, backend: str | None = None,
                   device=None) -> Tuple[int, List[int]]:
    """CVP solver (svpcvp.cpp:532-659). Returns (status, coefficients)."""
    device = resolve_device(device) if backend != "cpu" else None
    d, n = b.nrows, b.ncols
    if d == 0 or n == 0:
        raise ValueError("closest_vector: empty matrix")
    if d > n:
        raise ValueError("closest_vector: more vectors than dimensions")
    min_prec, rho = gso_min_prec(d, LLL_DEF_DELTA, LLL_DEF_ETA, 0.01)
    prec = max(53, min_prec + 10)
    ctx = MPCtx(prec)
    gso = MatGSO(b, flags=1, ctx=ctx)  # GSO_INT_GRAM
    gso.update_gso()
    sol_coord = [0] * d

    # float basis for coordinate computations
    bf = ctx.zeros((d, n))
    for i in range(d):
        for j in range(n):
            bf[i, j] = ctx.from_int(int(b.a[i, j]))

    int_new_target = [int(t) for t in int_target]
    with ctx.guard():
        loop_idx = 0
        while True:
            if loop_idx >= 0x100 and (loop_idx & (loop_idx - 1)) == 0:
                print("warning: possible infinite loop in Babai's algorithm")
            target = [ctx.from_int(t) for t in int_new_target]
            tc = _get_gscoords(ctx, bf, gso.mu, gso.r, target)
            # Babai rounding (svpcvp.cpp:518-530)
            babai_sol = list(tc)
            for i in range(d - 1, -1, -1):
                babai_sol[i] = ctx.rnd(babai_sol[i])
                for j in range(i):
                    babai_sol[j] = babai_sol[j] - gso.mu[i, j] * babai_sol[i]
            if all(-1 <= ctx.to_float(x) <= 1 for x in babai_sol):
                break
            for i in range(d):
                c = ctx.rnd_int(babai_sol[i])
                sol_coord[i] += c
                if c:
                    for j in range(n):
                        int_new_target[j] -= c * int(b.a[i, j])
            loop_idx += 1

        target = [ctx.from_int(t) for t in int_new_target]
        target_coord = [ctx.to_float(x) for x in
                        _get_gscoords(ctx, bf, gso.mu, gso.r, target)]

    max_dist = 0.0
    for i in range(1, d):
        v, e = gso.get_r_exp(i, i)
        max_dist += math.ldexp(ctx.to_float(v), e)

    max_indices: List[int] = []
    if method & CVPM_PROVED:
        # reset depths below the maximal r_i (svpcvp.cpp:609-634)
        max_indices = [0] * d
        previous_max_index = max_index = d - 1
        while max_index > 0:
            max_val = ctx.to_float(gso.get_r(max_index, max_index))
            for cur in range(previous_max_index - 1, -1, -1):
                rc = ctx.to_float(gso.get_r(cur, cur))
                if max_val <= rc:
                    max_val = rc
                    max_index = cur
            for cur in range(max_index, previous_max_index):
                max_indices[cur] = max_index
            max_indices[previous_max_index] = previous_max_index
            previous_max_index = max_index
            max_index -= 1

    evaluator = ErrorBoundedEvaluator(b, target=int_new_target,
                                      eval_mode=EVALMODE_SV)
    enumobj = Enumeration(gso, evaluator, max_indices, backend=backend,
                          device=device)
    enumobj.enumerate(0, d, max_dist, 0, target_coord=target_coord)

    result = RED_ENUM_FAILURE
    if not evaluator.empty():
        _, best = evaluator.begin()
        for i in range(d):
            sol_coord[i] += int(round(best[i]))
        result = RED_SUCCESS
    return result, sol_coord
