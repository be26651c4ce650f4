"""LLL reduction (the L2 algorithm with lazy size reduction).

Re-design of the reference's LLLReduction
(fplll/lll.{h,cpp}: main loop lll.cpp:44-163, lazy Babai
lll.cpp:166-224, verifier lll.cpp:226-258) over the TPU build's GSO
engines. Control flow is host-side (it is inherently sequential, see
SURVEY.md "hard parts"); the O(n^2) inner arithmetic is vectorized
through the GSO float context, and the blocked device path lives in
fplll_tpu_torch.ops.blockgso.
"""

from __future__ import annotations

import math
import sys
import time

from ..defs import (LLL_EARLY_RED, LLL_SIEGEL, LLL_VERBOSE, RED_BABAI_FAILURE,
                    RED_GSO_FAILURE, RED_LLL_FAILURE, RED_SUCCESS,
                    SIZE_RED_FAILURE_THRESH, get_red_status_str)
from ..core.gso import MatGSOInterface

__all__ = ["LLLReduction", "is_lll_reduced"]


def _is_power_of_2(x: int) -> bool:
    return (x & (x - 1)) == 0


class LLLReduction:
    def __init__(self, m: MatGSOInterface, delta: float, eta: float, flags: int = 0):
        # early reduction requires lazy gram rows: unavailable in proved
        # (int-gram) mode, as in the reference (lll.cpp:31-36)
        self.m = m
        self.ctx = m.ctx
        self.enable_early_red = bool(flags & LLL_EARLY_RED) and not m.enable_int_gram
        self.siegel = bool(flags & LLL_SIEGEL)
        self.verbose = bool(flags & LLL_VERBOSE)
        self.delta = delta
        self.eta = eta
        self.swap_threshold = delta - eta * eta if self.siegel else delta
        self.status = RED_SUCCESS
        self.final_kappa = 0
        self.last_early_red = 0
        self.zeros = 0
        self.n_swaps = 0
        from ..nr.fctx import F64Ctx
        self._fast = isinstance(self.ctx, F64Ctx)

    # -- native prereduction for the soft-float rungs ------------------------
    def _native_prereduce(self, kappa_min: int, kappa_start: int,
                          kappa_end: int) -> None:
        """Best-effort native double+row-expo prereduction before a
        soft-float (heuristic/proved) pass.

        The heuristic/proved rungs re-run the same L2 loop at higher
        precision; their guarantee comes from that pass alone, so any
        unimodular preprocessing is free (the wrapper-ladder design,
        fplll/wrapper.cpp:281-359, applied inside one
        rung). On a 30x2000 knapsack this removes ~84k of ~84k
        soft-float iterations: the certified pass then only verifies."""
        import os
        if self._fast or os.environ.get("FPLLL_TPU_NATIVE_LLL", "1") != "1":
            return
        m = self.m
        from ..core.gso import MatGSO
        if not isinstance(m, MatGSO) or \
                getattr(m, "u_inv_t", None) is not None:
            return
        if kappa_min != 0 or kappa_start != 0 or kappa_end != m.d:
            return
        from ..native import native_lll_fast
        u = m.u if m.enable_transform else None
        out = native_lll_fast(m.b, u, self.delta, self.eta,
                              report_changed=True)
        if out is None:
            return
        st, changed = out
        if not changed:
            return
        m.b.version += 1
        # the rewritten rows have new nonzero spans: refresh the lazy
        # column bookkeeping before any bf/gram recompute reads it
        m.init_row_size = [max(m.b.row_size_nz(i), 1) for i in range(m.d)]
        if m.n_known_rows > 0:
            m.n_known_cols = max(m.n_known_cols,
                                 max(m.init_row_size[:m.n_known_rows]))
        for i in range(m.d):
            m.invalidate_gso_row(i, 0)
        if m.enable_int_gram:
            for i in range(m.n_known_rows):
                for j in range(i + 1):
                    v = m.b.dot_rows(i, j, m.b.ncols)
                    m.g[i, j] = v
                    m.g[j, i] = v
        else:
            for i in range(m.d):
                m.update_bf(i)
                m.invalidate_gram_row(i)

    # -- main loop (lll.cpp:44-163) -----------------------------------------
    def lll(self, kappa_min: int = 0, kappa_start: int = 0, kappa_end: int = -1,
            size_reduction_start: int = 0) -> bool:
        m, ctx = self.m, self.ctx
        if kappa_end == -1:
            kappa_end = m.d
        self._native_prereduce(kappa_min, kappa_start, kappa_end)
        start_time = time.time()
        kappa = kappa_start + 1
        kappa_max = 0
        d = kappa_end - kappa_min
        self.zeros = 0
        self.n_swaps = 0
        self.final_kappa = 0

        while self.zeros < d and m.b_row_is_zero(kappa_min):
            m.move_row(kappa_min, kappa_end - 1 - self.zeros)
            self.zeros += 1

        if self.zeros < d:
            if kappa_start > 0 and not self.babai(kappa_start, kappa_start,
                                                  size_reduction_start):
                self.final_kappa = kappa_start
                return False
            if not m.update_gso_row(kappa_start):
                self.final_kappa = kappa_start
                return False

        max_iter = int(d - 2 * d * (d + 1) *
                       ((m.get_max_exp_of_b() + 3) / math.log(self.delta)))

        it = 0
        lovasz = [None] * (kappa_end + 1)
        while it < max_iter and kappa < kappa_end - self.zeros:
            it += 1
            if kappa > kappa_max:
                if self.verbose:
                    print(f"Discovering vector {kappa - kappa_min + 1 + self.zeros}"
                          f"/{d} cputime={time.time() - start_time:.2f}",
                          file=sys.stderr)
                kappa_max = kappa
                if self.enable_early_red and _is_power_of_2(kappa) and \
                        kappa > self.last_early_red:
                    if not self.early_reduction(kappa, size_reduction_start):
                        self.final_kappa = kappa
                        return False

            # lazy size reduction
            if not self.babai(kappa, kappa, size_reduction_start):
                self.final_kappa = kappa
                return False

            # Lovasz tests: lovasz[i] = ||pi_i(b_kappa)||^2 prefix chain
            # (lll.cpp:109-125)
            with ctx.guard():
                if self._fast:
                    import numpy as np
                    g0 = m.get_gram(kappa, kappa)
                    prods = m.mu[kappa, :kappa] * m.r[kappa, :kappa]
                    lv = np.empty(kappa + 1)
                    lv[0] = g0
                    np.subtract(g0, np.cumsum(prods), out=lv[1:])
                    lovasz[:kappa + 1] = list(lv)
                else:
                    native = getattr(ctx, "native_engine", None)
                    if native is not None and hasattr(native,
                                                      "lovasz_chain"):
                        lovasz[:kappa + 1] = native.lovasz_chain(
                            m.mu, m.r, kappa, kappa,
                            m.get_gram(kappa, kappa), ctx.kind_id)
                    else:
                        lovasz[0] = m.get_gram(kappa, kappa)
                        for i in range(1, kappa + 1):
                            mu_v, _ = m.get_mu_exp(kappa, i - 1)
                            r_v, _ = m.get_r_exp(kappa, i - 1)
                            lovasz[i] = lovasz[i - 1] - mu_v * r_v
                rkk, _ = m.get_r_exp(kappa - 1, kappa - 1)
                t = rkk * ctx.scalar(self.swap_threshold)
                if m.enable_row_expo:
                    t = ctx.ldexp(t, 2 * int(m.row_expo[kappa - 1] - m.row_expo[kappa]))

            if t > lovasz[kappa if self.siegel else kappa - 1]:
                self.n_swaps += 1
                # insertion index scan (lll.cpp:128-141)
                old_k = kappa
                kappa -= 1
                while kappa > kappa_min:
                    with ctx.guard():
                        rkk, _ = m.get_r_exp(kappa - 1, kappa - 1)
                        t = rkk * ctx.scalar(self.swap_threshold)
                        if m.enable_row_expo:
                            t = ctx.ldexp(t, 2 * int(m.row_expo[kappa - 1] -
                                                     m.row_expo[old_k]))
                    if t < lovasz[kappa if self.siegel else kappa - 1]:
                        break
                    kappa -= 1
                if lovasz[kappa] > 0:
                    m.move_row(old_k, kappa)
                else:
                    self.zeros += 1
                    m.move_row(old_k, kappa_end - self.zeros)
                    kappa = old_k
                    continue

            m.set_r(kappa, kappa, lovasz[kappa])
            kappa += 1

        if m.enable_int_gram:
            m.symmetrize_g()
        if kappa < kappa_end - self.zeros:
            return self.set_status(RED_LLL_FAILURE)
        return self.set_status(RED_SUCCESS)

    # -- lazy Babai size reduction (lll.cpp:166-224) --------------------------
    def _babai_f64(self, kappa: int, size_reduction_end: int,
                   size_reduction_start: int) -> bool:
        """Vectorized f64 fast path of the lazy size reduction."""
        import numpy as np
        from ..nr.fctx import round_mul_2exp
        m = self.m
        end, start = size_reduction_end, size_reduction_start
        max_expo = None
        it = 0
        expo_diff = (m.row_expo[kappa] - m.row_expo[:end]).astype(np.int64) \
            if m.enable_row_expo else np.zeros(end, dtype=np.int64)
        while True:
            if not m.update_gso_row(kappa, end - 1):
                return self.set_status(RED_GSO_FAILURE)
            mu_row = m.mu[kappa, :end]
            with np.errstate(over="ignore", under="ignore", invalid="ignore"):
                true_abs = np.abs(np.ldexp(mu_row[start:end],
                                           expo_diff[start:end]))
            if not (np.isnan(true_abs).any() or (true_abs > self.eta).any()):
                break
            if it >= 2:
                # exponent divergence detection (lll.cpp:187-195)
                mant, ex = np.frexp(mu_row[:end])
                ex = np.where(mu_row[:end] == 0.0, 0, ex)
                new_max_expo = int((ex + expo_diff[:end]).max())
                if max_expo is not None and \
                        new_max_expo > max_expo - SIZE_RED_FAILURE_THRESH:
                    return self.set_status(RED_BABAI_FAILURE)
                max_expo = new_max_expo
            it += 1
            babai_mu = mu_row.copy()
            m.row_op_begin(kappa, kappa + 1)
            for j in range(end - 1, start - 1, -1):
                v = babai_mu[j]
                e = int(expo_diff[j])
                # rnd_we: round v*2^e to an integer, keep stored scale
                if v == 0.0:
                    continue
                fm, fe = math.frexp(v)
                if fe + e >= 53:
                    mu_rnd = v
                else:
                    mu_rnd = math.ldexp(round(math.ldexp(v, e)), -e)
                if mu_rnd == 0.0:
                    continue
                if j > start:
                    babai_mu[start:j] -= mu_rnd * m.mu[j, start:j]
                m.row_addmul_we(kappa, j, -mu_rnd, e)
            m.row_op_end(kappa, kappa + 1)
            if m.enable_row_expo:
                expo_diff = (m.row_expo[kappa] - m.row_expo[:end]).astype(np.int64)
        return True

    def _babai_compiled(self, kappa: int, end: int, start: int,
                        native) -> bool:
        """Compiled-context lazy size reduction: per-row stats and the
        rounding pass run as single C calls over the fpnum object arrays
        (same semantics as the scalar loop in babai below)."""
        import numpy as np
        m, ctx = self.m, self.ctx
        max_expo = None
        it = 0
        while True:
            if not m.update_gso_row(kappa, end - 1):
                return self.set_status(RED_GSO_FAILURE)
            expo = (m.row_expo[kappa] - m.row_expo[:end]).astype(np.int64) \
                if m.enable_row_expo else None
            finite, max_abs, _ = native.mu_row_stats(
                m.mu, kappa, expo, start, end, ctx.kind_id)
            if finite and max_abs <= self.eta:
                break
            if it >= 2:
                # divergence detection by exponent non-decrease
                # (lll.cpp:187-195)
                _, _, new_max_expo = native.mu_row_stats(
                    m.mu, kappa, expo, 0, end, ctx.kind_id)
                if max_expo is not None and \
                        new_max_expo > max_expo - SIZE_RED_FAILURE_THRESH:
                    return self.set_status(RED_BABAI_FAILURE)
                max_expo = new_max_expo
            it += 1
            bmu = m.mu[kappa, :end].copy()
            m.row_op_begin(kappa, kappa + 1)
            pairs = native.babai_pass(m.mu, bmu, expo, start, end,
                                      ctx.prec, ctx.kind_id)
            for j, mu_rnd in pairs:
                m.row_addmul_we(kappa, j, -mu_rnd,
                                int(expo[j]) if expo is not None else 0)
            m.row_op_end(kappa, kappa + 1)
        return True

    def babai(self, kappa: int, size_reduction_end: int,
              size_reduction_start: int = 0) -> bool:
        m, ctx = self.m, self.ctx
        if self._fast:
            return self._babai_f64(kappa, size_reduction_end,
                                   size_reduction_start)
        native = getattr(ctx, "native_engine", None)
        if native is not None:
            return self._babai_compiled(kappa, size_reduction_end,
                                        size_reduction_start, native)
        max_expo = None
        it = 0
        while True:
            if not m.update_gso_row(kappa, size_reduction_end - 1):
                return self.set_status(RED_GSO_FAILURE)

            loop_needed = False
            for j in range(size_reduction_end - 1, size_reduction_start - 1, -1):
                v = m.get_mu(kappa, j)
                if not ctx.is_finite(v):
                    loop_needed = True
                    break
                if abs(ctx.to_float(v)) > self.eta or \
                        (ctx.to_float(v) != ctx.to_float(v)):
                    loop_needed = True
                    break
            if not loop_needed:
                break

            # divergence detection by exponent non-decrease (lll.cpp:187-195)
            if it >= 2:
                new_max_expo = m.get_max_mu_exp(kappa, size_reduction_end)
                if max_expo is not None and \
                        new_max_expo > max_expo - SIZE_RED_FAILURE_THRESH:
                    return self.set_status(RED_BABAI_FAILURE)
                max_expo = new_max_expo
            it += 1

            babai_mu = [None] * size_reduction_end
            babai_expo = [0] * size_reduction_end
            for j in range(size_reduction_start, size_reduction_end):
                babai_mu[j], babai_expo[j] = m.get_mu_exp(kappa, j)

            m.row_op_begin(kappa, kappa + 1)
            with ctx.guard():
                for j in range(size_reduction_end - 1, size_reduction_start - 1, -1):
                    # round the scaled mu so mu_rnd * 2^expo is an exact int
                    mu_rnd = self._rnd_we(babai_mu[j], babai_expo[j])
                    if mu_rnd == 0:
                        continue
                    for k in range(size_reduction_start, j):
                        mjk, _ = m.get_mu_exp(j, k)
                        babai_mu[k] = babai_mu[k] - mu_rnd * mjk
                    m.row_addmul_we(kappa, j, -mu_rnd, babai_expo[j])
            m.row_op_end(kappa, kappa + 1)
        return True

    def _rnd_we(self, v, expo: int):
        """FP_NR::rnd_we: round v*2^expo to an integer, result scaled back
        (nr_FP_d.inl:226-233)."""
        ctx = self.ctx
        if v == 0:
            return ctx.scalar(0)
        if ctx.exponent(v) + expo >= ctx.prec:
            return v
        return ctx.ldexp(ctx.rnd(ctx.ldexp(v, expo)), -expo)

    def size_reduction(self, kappa_min: int = 0, kappa_end: int = -1,
                       size_reduction_start: int = 0) -> bool:
        if kappa_end == -1:
            kappa_end = self.m.d
        for k in range(kappa_min, kappa_end):
            if (k > 0 and not self.babai(k, k, size_reduction_start)) or \
                    not self.m.update_gso_row(k):
                return False
        return self.set_status(RED_SUCCESS)

    def early_reduction(self, start: int, size_reduction_start: int = 0) -> bool:
        self.m.lock_cols()
        if self.verbose:
            print(f"Early reduction start={start + 1}", file=sys.stderr)
        for i in range(start, self.m.d):
            if not self.babai(i, start, size_reduction_start):
                return False
        self.m.unlock_cols()
        self.last_early_red = start
        return True

    def set_status(self, new_status: int) -> bool:
        self.status = new_status
        if self.verbose:
            if new_status == RED_SUCCESS:
                print("End of LLL: success", file=sys.stderr)
            else:
                print(f"End of LLL: failure: {get_red_status_str(new_status)}",
                      file=sys.stderr)
        return new_status == RED_SUCCESS


def is_lll_reduced(m: MatGSOInterface, delta: float, eta: float) -> bool:
    """Verifier (lll.cpp:226-258): |mu| <= eta and the Lovasz condition
    r_ii >= (delta - mu^2) r_(i-1)(i-1)."""
    ctx = m.ctx
    if not m.update_gso():
        return False
    with ctx.guard():
        for i in range(m.d):
            for j in range(i):
                if abs(ctx.to_float(m.get_mu(i, j))) > eta:
                    return False
        for i in range(1, m.d):
            mu = m.get_mu(i, i - 1)
            lhs = m.get_r(i, i)
            rhs = (ctx.scalar(delta) - mu * mu) * m.get_r(i - 1, i - 1)
            if lhs < rhs:
                return False
    return True
