"""Householder-based LLL (HLLL, [MSV'09]).

Re-design of fplll/hlll.{h,cpp}: main loop
(hlll.cpp:26-173), incomplete size reduction with the two-consecutive-
stops heuristic (hlll.cpp:262-400), Lovasz test on ||b_k||^2 - sum R^2
(hlll.cpp:175-241), norm-increase anomaly detection (RED_HLLL_NORM_
FAILURE) and the is_hlll_reduced verifier (hlll.cpp:507-552).
"""

from __future__ import annotations

import sys
import time

from ..defs import (HLLL_DEF_C, HLLL_DEF_THETA, RED_HLLL_FAILURE,
                    RED_HLLL_NORM_FAILURE, RED_HLLL_SR_FAILURE, RED_SUCCESS,
                    LLL_VERBOSE, get_red_status_str)
from ..core.householder import MatHouseholder

__all__ = ["HLLLReduction", "is_hlll_reduced"]


class HLLLReduction:
    def __init__(self, m: MatHouseholder, delta: float, eta: float,
                 theta: float = HLLL_DEF_THETA, c: float = HLLL_DEF_C,
                 flags: int = 0):
        self.m = m
        self.ctx = m.ctx
        self.delta = delta
        self.eta = eta
        self.theta = theta
        self.c = c
        self.verbose = bool(flags & LLL_VERBOSE)
        self.status = RED_SUCCESS
        d = m.get_d()
        self.dR = [None] * d  # delta * R(k,k)^2, scaled by 2^(2 row_expo[k])
        self.eR = [None] * d  # eta-ish * R(k,k), scaled by 2^row_expo[k]
        # 2^(-c*d): size-reduction progress threshold (hlll.cpp:300-320)
        self.sr = 2.0 ** (-c * d)

    def _compute_dR(self, k: int) -> None:
        with self.ctx.guard():
            v, _ = self.m.get_R(k, k)
            self.dR[k] = v * v * self.ctx.scalar(self.delta)

    def _compute_eR(self, k: int) -> None:
        with self.ctx.guard():
            v, _ = self.m.get_R(k, k)
            self.eR[k] = v * self.ctx.scalar(self.delta)

    def get_status(self) -> int:
        return self.status

    def set_status(self, s: int) -> bool:
        self.status = s
        if self.verbose:
            if s == RED_SUCCESS:
                print("End of HLLL: success", file=sys.stderr)
            else:
                print(f"End of HLLL: failure: {get_red_status_str(s)}",
                      file=sys.stderr)
        return s == RED_SUCCESS

    # -- main loop (hlll.cpp:26-173) -----------------------------------------
    def hlll(self) -> bool:
        m, ctx = self.m, self.ctx
        d = m.get_d()
        start_time = time.time()
        if self.verbose:
            print(f"Entering HLLL\ndelta = {self.delta}\neta = {self.eta}"
                  f"\ntheta = {self.theta}\nc = {self.c}"
                  f"\nprecision = {ctx.prec}", file=sys.stderr)
        m.refresh_R_bf(0)
        m.update_R_last(0)
        self._compute_dR(0)
        self._compute_eR(0)
        if d == 1:
            return self.set_status(RED_SUCCESS)

        k = 1
        k_max = 1
        prev_k = -1
        prev_R = [None] * d
        prev_expo = [0] * d
        m.refresh_R_bf(1)

        while True:
            self.size_reduction(k, k, 0)
            if not self.verify_size_reduction(k):
                return self.set_status(RED_HLLL_SR_FAILURE)

            if self.lovasz_test(k):
                m.update_R_last(k)
                self._compute_dR(k)
                self._compute_eR(k)
                # norm-increase anomaly check (hlll.cpp:95-110)
                if prev_k == k + 1:
                    with ctx.guard():
                        v, e = m.get_R(k, k)
                        prev = ctx.ldexp(prev_R[k], prev_expo[k] - e)
                        if v > prev:
                            return self.set_status(RED_HLLL_NORM_FAILURE)
                prev_k = k
                prev_R[k], prev_expo[k] = m.get_R(k, k)
                k += 1
                if k < d:
                    if k > k_max:
                        if self.verbose:
                            print(f"Discovering vector {k + 1}/{d} "
                                  f"cputime={time.time() - start_time:.2f}",
                                  file=sys.stderr)
                        k_max = k
                        m.refresh_R_bf(k)
                    else:
                        m.refresh_R(k)
                else:
                    return self.set_status(RED_SUCCESS)
            else:
                m.swap(k - 1, k)
                prev_k = k
                if k - 1 == 0:
                    m.refresh_R(0)
                    m.update_R_last(0)
                    self._compute_dR(0)
                    self._compute_eR(0)
                    m.refresh_R(1)
                    k = 1
                else:
                    k -= 1
                    m.recover_R(k)

    # -- Lovasz test (hlll.cpp:175-241) ---------------------------------------
    def lovasz_test(self, k: int) -> bool:
        m, ctx = self.m, self.ctx
        with ctx.guard():
            nb, e0 = m.get_norm_square_b(k)
            nr, e1 = m.norm_square_R_row(k, 0, k - 1)
            t = nb - nr  # same exponent: both rows share row_expo[k]
            e_prev = m.get_row_expo(k - 1)
            t = ctx.ldexp(t, e1 - 2 * e_prev)
            return self.dR[k - 1] <= t

    # -- incomplete size reduction (hlll.cpp:262-400) -------------------------
    def size_reduction(self, kappa: int, size_reduction_end: int,
                       size_reduction_start: int = 0) -> None:
        m, ctx = self.m, self.ctx
        approx = 0.1
        m.update_R(kappa, False)
        m.set_updated_R_false()
        prev_not_stop = True
        while True:
            reduced = m.size_reduce(kappa, size_reduction_end,
                                    size_reduction_start)
            if not reduced:
                return
            with ctx.guard():
                t_old, e0 = m.get_norm_square_b(kappa)
                m.refresh_R_bf(kappa)
                t_new, e1 = m.get_norm_square_b(kappa)
                thresh = ctx.ldexp(t_old * ctx.scalar(approx), e0 - e1)
                not_stop = t_new <= thresh
            m.update_R(kappa, False)
            if prev_not_stop or not_stop:
                prev_not_stop = not_stop
            else:
                return

    # -- weak size reduction check (hlll.cpp:404-500, default branch) --------
    def verify_size_reduction(self, kappa: int) -> bool:
        m, ctx = self.m, self.ctx
        if getattr(m, "_fast", False):
            import numpy as np
            rkk = float(np.sqrt(np.dot(m.R[kappa, kappa:], m.R[kappa, kappa:])))
            if kappa == 0:
                return True
            e1 = e0 = int(m.row_expo[kappa])
            v = np.abs(m.R[kappa, :kappa])
            rii = np.diagonal(m.R[:kappa, :kappa])
            e2 = m.row_expo[:kappa].astype(np.int64)
            with np.errstate(over="ignore", under="ignore"):
                rhs = np.ldexp(rii * self.eta, e2 - e0) + \
                    np.ldexp(rkk * self.theta, e1 - e0)
            bad = v > rhs
            if bad.any():
                i = int(np.argmax(bad))
                print(f"Anomaly: weak size reduction is not complete "
                      f"kappa = {kappa} and i = {i}", file=sys.stderr)
                return False
            return True
        with ctx.guard():
            rkk, e1 = m.norm_R_row(kappa, kappa, m.get_n())
            tRkk = rkk * ctx.scalar(self.theta)
            for i in range(kappa):
                v, e0 = m.get_R(kappa, i)
                v = abs(v)
                rii, e2 = m.get_R(i, i)
                bound = rii * ctx.scalar(self.eta)
                # |R(kappa,i)|*2^e0 <= eta*R(i,i)*2^e2 + theta*Rkk*2^e1
                rhs = ctx.ldexp(bound, e2 - e0) + ctx.ldexp(tRkk, e1 - e0)
                if v > rhs:
                    print(f"Anomaly: weak size reduction is not complete "
                          f"kappa = {kappa} and i = {i}", file=sys.stderr)
                    return False
        return True


def is_hlll_reduced(m: MatHouseholder, delta: float, eta: float,
                    theta: float = HLLL_DEF_THETA) -> int:
    """Verifier (hlll.cpp:507-560): weak size reduction
    |R(j,i)| <= eta R(i,i) + theta R(j,j) plus the Lovasz condition on
    the naively-recomputed R. Returns RED_SUCCESS or RED_HLLL_FAILURE."""
    ctx = m.ctx
    m.update_R_naively()
    with ctx.guard():
        for j in range(m.get_d()):
            for i in range(j):
                v, e0 = m.get_R_naively(j, i)
                v = abs(v)
                rjj, e1 = m.get_R_naively(j, j)
                rii, e2 = m.get_R_naively(i, i)
                rhs = rjj * ctx.scalar(theta) + \
                    ctx.ldexp(rii * ctx.scalar(eta), e2 - e0)
                if v > rhs:
                    return RED_HLLL_FAILURE
        # delta * R(i-1,i-1)^2 <= R(i,i-1)^2 + R(i,i)^2
        for i in range(1, m.get_d()):
            r10, e0 = m.get_R_naively(i, i - 1)
            r11, e1 = m.get_R_naively(i, i)
            prev, e2 = m.get_R_naively(i - 1, i - 1)
            lhs = prev * prev * ctx.scalar(delta)
            rhs = r10 * r10 + ctx.ldexp(r11 * r11, 0)
            rhs = ctx.ldexp(rhs, 2 * e0 - 2 * e2)
            if lhs > rhs:
                return RED_HLLL_FAILURE
    return RED_SUCCESS
