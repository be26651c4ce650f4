"""Sequential Kannan–Fincke–Pohst enumeration (host oracle).

Faithful re-expression of the reference's single-tree DFS
(fplll/enum/enumerate_base.{h,cpp}: iterative loop
enumerate_base.cpp:152-247, zig-zag sibling stepping + SVP symmetry
breaking enumerate_base.h:145-172; driver enumerate.cpp:58-260 with
normalization, dual transform, subtree preparation and the CVP "reset"
re-enumeration enumerate.cpp:23-56).

This is the correctness oracle and the driver for small dimensions; the
scale-out path is the batched device kernel in fplll_tpu_torch.enum.device, which
shares the exact same (mut, rdiag, pruning, evaluator) contract so the
two are interchangeable behind fplll_tpu_torch.enum.api.Enumeration — the
reproduction of the reference's external-enumerator seam
(enum/enumerate_ext_api.h:52-93).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from .evaluator import Evaluator, FastEvaluator

__all__ = ["EnumerationDyn", "_roundf"]

def _roundf(x: float) -> float:
    """C round(): nearest integer, halves away from zero (the reference's
    roundto, enumerate_base.h:33)."""
    return math.floor(x + 0.5) if x >= 0.0 else math.ceil(x - 0.5)




class EnumerationDyn:
    """Single-tree DFS enumerator over a GSO object block [first, last)."""

    def __init__(self, gso, evaluator: Evaluator,
                 max_indices: Optional[List[int]] = None, device=None):
        self._gso = gso
        self._evaluator = evaluator
        self._max_indices = max_indices or []
        # the device of the CVP reset's sub-enumerations (a resolved
        # torch.device); None keeps them on this host DFS
        self.device = device
        self.nodes: List[int] = []
        self.d = 0

    # -- public API ----------------------------------------------------------
    def get_nodes(self, level: int = -1) -> int:
        if level == -1:
            return sum(self.nodes)
        return self.nodes[level]

    def enumerate(self, first: int, last: int, fmaxdist: float,
                  fmaxdistexpo: int,
                  target_coord: Sequence[float] = (),
                  subtree: Sequence[float] = (),
                  pruning: Sequence[float] = (),
                  dual: bool = False, subtree_reset: bool = False,
                  node_budget: int = 0) -> float:
        """Runs the search; returns the final max_dist * 2^fmaxdistexpo
        convention of the reference (updated bound in caller scale).
        node_budget > 0 stops the walk early (used for bound-tightening
        dives before handing the tree to the batched device kernel)."""
        self.node_budget = node_budget
        gso = self._gso
        solvingsvp = len(target_coord) == 0
        if last == -1:
            last = gso.d
        d = self.d = last - first
        self.dual = dual
        self.pruning_bounds = list(pruning)
        self.target = list(target_coord)
        if dual and not solvingsvp:
            raise ValueError("CVP for dual not implemented")
        if dual and len(subtree):
            raise ValueError("subtree enumeration for dual not implemented")

        self.resetflag = bool(self._max_indices)
        self.reset_depth = (self._max_indices[last - len(subtree) - 1]
                            if self.resetflag else 0)

        # center partial sums start from the target (CVP) or zero (SVP)
        self.center_partsum = [0.0] * d
        if not solvingsvp:
            for i in range(d):
                self.center_partsum[i] = float(target_coord[i + first])

        # normalization exponent (enumerate.cpp:112-121)
        mut, rdiag, normexp = gso.export_mu_r(first, last)
        if dual:
            normexp = -normexp
            new_rdiag = [0.0] * d
            for i in range(d):
                new_rdiag[d - i - 1] = 1.0 / math.ldexp(rdiag[i], -2 * normexp)
            new_mut = [[0.0] * d for _ in range(d)]
            for i in range(d):
                for j in range(i + 1, d):
                    new_mut[d - j - 1][d - i - 1] = -mut[i][j]
            self.mut = new_mut
            self.rdiag = new_rdiag
        else:
            self.mut = [[mut[i][j] for j in range(d)] for i in range(d)]
            self.rdiag = [float(r) for r in rdiag]

        self.maxdist = math.ldexp(fmaxdist, fmaxdistexpo - normexp)
        self._evaluator.set_normexp(normexp)
        self.subsoldists = list(self.rdiag)
        self.nodes = [0] * d

        # native fast path: the C DFS core covers the common single-best
        # searches (no reset, no subtree, no subsolutions, best-1 bound
        # semantics); everything else runs the Python reference loop
        ev = self._evaluator
        from .evaluator import (CallbackEvaluator, EVALSTRATEGY_BEST_N_SOLUTIONS,
                                EVALMODE_COUNT)
        count_mode = getattr(ev, "eval_mode", 0) == EVALMODE_COUNT
        eligible = (
            not self.resetflag and not subtree and not subtree_reset
            and not ev.findsubsols and not isinstance(ev, CallbackEvaluator)
            and (count_mode or (ev.strategy == EVALSTRATEGY_BEST_N_SOLUTIONS
                                and ev.max_sols == 1))
        )
        if eligible:
            import numpy as _np
            from ..native import native_enumerate
            out = native_enumerate(
                _np.asarray(self.mut, dtype=_np.float64),
                _np.asarray(self.rdiag, dtype=_np.float64),
                _np.asarray(self.pruning_bounds, dtype=_np.float64)
                if self.pruning_bounds else None,
                _np.asarray(self.center_partsum, dtype=_np.float64)
                if not solvingsvp else None,
                self.maxdist, solvingsvp, dual, count_mode,
                node_budget=node_budget)
            if out is not None:
                new_max, best_dist, best_x, sol_count, cnodes, _ = out
                self.nodes = [int(v) for v in cnodes]
                if count_mode:
                    ev.sol_count += int(sol_count)
                elif best_x is not None:
                    self.maxdist = ev.eval_sol([float(v) for v in best_x],
                                               best_dist, new_max)
                result = math.ldexp(self.maxdist, normexp - fmaxdistexpo)
                if dual and not ev.empty():
                    for i, (dist, sol) in enumerate(ev.solutions):
                        ev.solutions[i] = (dist, sol[::-1])
                return result

        self.x = [0.0] * d
        self.dx = [0.0] * d
        self.ddx = [0.0] * d
        self.center = [0.0] * d
        self.alpha = [0.0] * d
        self.partdist = [0.0] * (d + 1)

        self._prepare(subtree, solvingsvp, subtree_reset)
        self._set_bounds()
        self._loop()

        # write back the shrunk bound in caller scale
        result = math.ldexp(self.maxdist, normexp - fmaxdistexpo)

        if dual and not self._evaluator.empty():
            for i, (dist, sol) in enumerate(self._evaluator.solutions):
                self._evaluator.solutions[i] = (dist, sol[::-1])
        return result

    # -- preparation (enumerate.cpp:160-213) ---------------------------------
    def _prepare(self, subtree: Sequence[float], solvingsvp: bool,
                 subtree_reset: bool) -> None:
        d = self.d
        self.is_svp = solvingsvp
        newdist = 0.0
        self.k_end = d - len(subtree)
        k = d - 1
        while k >= 0 and newdist <= self.maxdist:
            newcenter = self.center_partsum[k]
            if k >= self.k_end:
                self.x[k] = float(subtree[k - self.k_end])
                if self.x[k] != 0:
                    self.is_svp = False
                for j in range(k):
                    self.center_partsum[j] -= self.x[k] * self.mut[j][k]
            else:
                for j in range(k + 1, self.k_end):
                    if self.dual:
                        newcenter -= self.alpha[j] * self.mut[k][j]
                    else:
                        newcenter -= self.x[j] * self.mut[k][j]
                self.x[k] = _roundf(newcenter)
                self.center[k] = newcenter
                self.partdist[k] = newdist
                self.dx[k] = self.ddx[k] = 1.0 if newcenter >= self.x[k] else -1.0
            if not subtree_reset or k < self.k_end:
                self.alpha[k] = self.x[k] - newcenter
                newdist += self.alpha[k] * self.alpha[k] * self.rdiag[k]
            k -= 1
        if not self.is_svp:
            self.k_max = self.k_end
        else:
            self.k_max = 0
            self.x[0] = 1.0  # exclude the zero vector
        self.k = k + 1

    def _set_bounds(self) -> None:
        if not self.pruning_bounds:
            self.partdistbounds = [self.maxdist] * self.d
        else:
            self.partdistbounds = [self.pruning_bounds[i] * self.maxdist
                                   for i in range(self.d)]

    # -- solution hooks ------------------------------------------------------
    def _process_solution(self, newmaxdist: float) -> None:
        fx = [float(v) for v in self.x]
        self.maxdist = self._evaluator.eval_sol(fx, newmaxdist, self.maxdist)
        self._set_bounds()

    def _process_subsolution(self, offset: int, newdist: float) -> None:
        fx = [0.0] * offset + [float(v) for v in self.x[offset:]]
        self._evaluator.eval_sub_sol(offset, fx, newdist)

    def _reset(self, cur_dist: float, cur_depth: int) -> None:
        """CVP reset: re-enumerate the sublattice below the max-GS level
        (enumerate.cpp:23-56).  Large lower blocks without a nested reset
        level route to the batched device kernel (the subtree-fixed upper
        coordinates fold into the lower block's center partial sums, so
        the sub-search is an ordinary CVP over [0, new_dim))."""
        new_dim = cur_depth + 1
        if self._reset_on_device(cur_dist, new_dim):
            return
        partial_sol = [self.x[i] for i in range(cur_depth + 1, self.d)]
        new_dist = 0.0
        for i in range(new_dim):
            v, e = self._gso.get_r_exp(i, i)
            new_dist += math.ldexp(self._gso.ctx.to_float(v), e)
        new_evaluator = FastEvaluator()
        sub = EnumerationDyn(self._gso, new_evaluator, self._max_indices,
                             device=self.device)
        sub.enumerate(0, self.d, new_dist, 0, self.target, partial_sol,
                      self.pruning_bounds, False, True)
        if not new_evaluator.empty():
            dist, sol = new_evaluator.begin()
            sol_dist = math.ldexp(dist, -new_evaluator.normExp)
            if sol_dist + cur_dist < self.partdistbounds[0]:
                for i in range(new_dim):
                    self.x[i] = sol[i]
                self._process_solution(sol_dist + cur_dist)

    def _reset_on_device(self, cur_dist: float, new_dim: int) -> bool:
        """Budgeted hybrid for the reset machinery: when the lower block
        is device-sized and has no nested reset level of its own
        (max_indices[new_dim-1] == 0), run the sub-enumeration through
        the batched kernel, in f64, instead of a recursive host DFS.
        Returns True when the device handled it (including a
        no-improvement outcome). A failed build or launch raises: the
        host DFS never reruns a reset the device was given."""
        nested = (self._max_indices[new_dim - 1]
                  if new_dim - 1 < len(self._max_indices) else 0)
        if self.device is None or self.dual or nested != 0:
            return False
        from . import device as enum_device
        if new_dim < enum_device._MIN_TPU_DIM:
            return False
        import numpy as np
        mu = np.asarray(self.mut, dtype=np.float64)
        rdiag = np.asarray(self.rdiag[:new_dim], dtype=np.float64)
        fixed = np.asarray([self.x[j] for j in range(new_dim, self.d)])
        cp0 = np.asarray(self.target[:new_dim], dtype=np.float64)
        if len(fixed):
            cp0 = cp0 - mu[:new_dim, new_dim:self.d] @ fixed
        maxdist = float(rdiag.sum())   # sum r_ii, normalized scale
        prune = (np.asarray(self.pruning_bounds[:new_dim])
                 if self.pruning_bounds else None)
        ev = FastEvaluator()           # normExp 0: stays normalized
        enum = enum_device.DeviceEnumerator(batch=256, device=self.device,
                                            dtype=enum_device.torch.float64)
        enum.enumerate(mu[:new_dim, :new_dim], rdiag, prune, cp0, maxdist,
                       False, ev)
        if not ev.empty():
            sol_dist, sol = ev.begin()
            if sol_dist + cur_dist < self.partdistbounds[0]:
                for i in range(new_dim):
                    self.x[i] = sol[i]
                self._process_solution(sol_dist + cur_dist)
        return True

    # -- sibling stepping (enumerate_base.h:145-172) -------------------------
    def _next_pos_up(self) -> bool:
        self.k += 1
        k = self.k
        if self.partdist[k] != 0.0:
            self.x[k] += self.dx[k]
            self.ddx[k] = -self.ddx[k]
            self.dx[k] = self.ddx[k] - self.dx[k]
        else:
            if k >= self.k_end:
                return False
            self.k_max = k
            if self.is_svp:
                self.x[k] += 1
            else:
                self.x[k] += self.dx[k]
                self.ddx[k] = -self.ddx[k]
                self.dx[k] = self.ddx[k] - self.dx[k]
        return True

    # -- main DFS loop (enumerate_base.cpp:152-247) --------------------------
    def _loop(self) -> None:
        if self.k >= self.k_end:
            return
        d, k_end = self.d, self.k_end
        findsubsols = self._evaluator.findsubsols
        enable_reset = self.resetflag

        # lazy center partial sums
        self.center_partsum_begin = [0] + [k_end - 1] * k_end
        self.center_partsums = [[0.0] * (k_end + 1) for _ in range(k_end)]
        for i in range(k_end):
            self.center_partsums[i][k_end] = self.center_partsum[i]
        self.partdist[k_end] = 0.0
        for i in range(self.k + 1, k_end):
            self.nodes[i] -= 1
        self.k = k_end - 1

        x, dx, ddx = self.x, self.dx, self.ddx
        center, alpha, partdist = self.center, self.alpha, self.partdist
        mut, rdiag = self.mut, self.rdiag
        cps, cpb = self.center_partsums, self.center_partsum_begin

        budget = getattr(self, "node_budget", 0)
        nvisited = 0
        while True:
            if budget and nvisited >= budget:
                break
            nvisited += 1
            k = self.k
            alphak = x[k] - center[k]
            newdist = partdist[k] + alphak * alphak * rdiag[k]
            if newdist <= self.partdistbounds[k]:
                self.nodes[k] += 1
                alpha[k] = alphak
                if findsubsols and newdist < self.subsoldists[k] and newdist != 0.0:
                    self.subsoldists[k] = newdist
                    self._process_subsolution(k, newdist)
                self.k = k - 1
                if self.k < 0:
                    if newdist > 0.0 or not self.is_svp:
                        self._process_solution(newdist)
                    if self.maxdist < 0 or not self._next_pos_up():
                        break
                    continue
                k = self.k
                if enable_reset and k < self.reset_depth:
                    self._reset(newdist, k)
                    if self.maxdist < 0 or not self._next_pos_up():
                        break
                    continue
                if self.dual:
                    for j in range(cpb[k + 1], k, -1):
                        cps[k][j] = cps[k][j + 1] - alpha[j] * mut[k][j]
                else:
                    for j in range(cpb[k + 1], k, -1):
                        cps[k][j] = cps[k][j + 1] - x[j] * mut[k][j]
                cpb[k] = max(cpb[k], cpb[k + 1])
                cpb[k + 1] = k + 1
                newcenter = cps[k][k + 1]
                center[k] = newcenter
                partdist[k] = newdist
                x[k] = _roundf(newcenter)
                dx[k] = ddx[k] = 1.0 if newcenter >= x[k] else -1.0
            else:
                if not self._next_pos_up():
                    break
