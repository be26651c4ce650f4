"""Householder R-factor engine (for HLLL).

Re-design of the reference MatHouseholder
(fplll/householder.{h,cpp}): per-row reflector
computation `update_R_last` (householder.cpp:27-146), prefix application
with per-step snapshots into R_history (`update_R`,
householder.cpp:151-184; `recover_R` restores a prefix in O(n),
householder.h:597-608), weak size reduction (householder.cpp:400-452),
and the naive reference path `update_R_naively` used by verification
(householder.cpp:263-369).

Rows carry block-floating-point exponents (HOUSEHOLDER_ROW_EXPO), the
same layout as the GSO engine; vector inner loops run through the float
context so f64/soft-float backends share one implementation.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..defs import (HOUSEHOLDER_DEFAULT, HOUSEHOLDER_OP_FORCE_LONG,
                    HOUSEHOLDER_ROW_EXPO)
from ..nr.fctx import F64Ctx, int_to_f_exp
from ..ops.intmat import IntMat
from .gso import _mpf_to_int_mul_2exp
from ..nr.fctx import round_mul_2exp

__all__ = ["MatHouseholder"]


class MatHouseholder:
    def __init__(self, b: IntMat, u: Optional[IntMat] = None,
                 u_inv_t: Optional[IntMat] = None,
                 flags: int = HOUSEHOLDER_DEFAULT, ctx=None):
        self.ctx = ctx if ctx is not None else F64Ctx()
        self.b = b
        self.u = u
        self.u_inv_t = u_inv_t
        self.enable_transform = u is not None
        self.enable_inverse_transform = u_inv_t is not None
        self.enable_row_expo = bool(flags & HOUSEHOLDER_ROW_EXPO)
        self.row_op_force_long = bool(flags & HOUSEHOLDER_OP_FORCE_LONG)
        d, n = b.nrows, b.ncols
        self.d, self.n = d, n
        ctx = self.ctx
        self.R = ctx.zeros((d, n))
        self.V = ctx.zeros((d, n))
        self.bf = ctx.zeros((d, n))
        self.sigma = ctx.zeros(d)
        self.row_expo = np.zeros(d, dtype=np.int64)
        self.init_row_size = [max(b.row_size_nz(i), 1) for i in range(d)]
        self.n_known_rows = 0
        self.n_known_cols = 0
        self.updated_R = False
        self._fast = isinstance(self.ctx, F64Ctx)
        if self._fast:
            # f64 fast path keeps, per row, the application START state,
            # the reflector dot products t (the compact-WY solve output)
            # and the fully APPLIED row. Any intermediate prefix state
            # (what the reference snapshots into R_history,
            # householder.h:597-608) is then one GEMV:
            #   state_after_refl_{m}[c>=m] = start[c] - sum_{k<=m} t_k V[k,c]
            self.R_history = None
            self.R_start = np.zeros((d, n))
            self.tcoef = np.zeros((d, d))
            self.R_applied = np.zeros((d, n))
            # cached V V^T (strictly lower used) for the compact-WY
            # application; valid for reflector rows < _vvt_valid
            self._vvt = np.zeros((d, d))
            self._vvt_valid = 0
        else:
            # soft-float engines keep the reference's per-step snapshots
            # (exact arithmetic-order parity for proved rungs)
            self.R_history = [ctx.zeros((d, n)) for _ in range(d)]
            self.R_start = self.tcoef = self.R_applied = None
            self._vvt = None
            self._vvt_valid = 0
        self.norm_square_b = ctx.zeros(d)
        self.expo_norm_square_b = np.zeros(d, dtype=np.int64)
        # naive verification path state
        self.R_naively = ctx.zeros((d, n))
        self.V_naively = ctx.zeros((d, n))
        self.sigma_naively = ctx.zeros(d)
        self.row_expo_naively = np.zeros(d, dtype=np.int64)
        self.n_known_rows_naively = 0

    def get_d(self) -> int:
        return self.d

    def get_n(self) -> int:
        return self.n

    # -- float copies of b (householder.cpp:187-240) -------------------------
    def refresh_R_bf(self, i: int | None = None) -> None:
        if i is None:
            for k in range(self.d):
                self.refresh_R_bf(k)
            return
        ctx = self.ctx
        self.n_known_cols = max(self.n_known_cols, self.init_row_size[i])
        n = self.n_known_cols
        row = self.b.a[i]
        with ctx.guard():
            if self.enable_row_expo:
                pairs = [int_to_f_exp(int(row[j])) for j in range(n)]
                max_e = max((e for f, e in pairs if f != 0.0), default=0)
                self.row_expo[i] = max_e
                for j in range(n):
                    f, e = pairs[j]
                    self.bf[i, j] = ctx.ldexp(ctx.scalar(f), e - max_e) \
                        if f != 0.0 else ctx.scalar(0)
            else:
                for j in range(n):
                    self.bf[i, j] = ctx.from_int(int(row[j]))
            for j in range(n, self.n):
                self.bf[i, j] = ctx.scalar(0)
            self.R[i, :] = self.bf[i, :]
            ns = ctx.dot(self.bf[i], self.bf[i])
            self.norm_square_b[i] = ns
            self.expo_norm_square_b[i] = 2 * int(self.row_expo[i]) \
                if self.enable_row_expo else 0

    def refresh_R(self, i: int) -> None:
        """Copy bf[i] into R[i] (b unchanged since last refresh_R_bf)."""
        self.R[i, :] = self.bf[i, :]

    # -- reflector machinery -------------------------------------------------
    def update_R_last(self, i: int) -> None:
        """Compute the reflector for row i; R(i,i) becomes ||r||
        (householder.cpp:27-146)."""
        ctx = self.ctx
        n = self.n
        with ctx.guard():
            rii = self.R[i, i]
            self.sigma[i] = ctx.scalar(-1.0 if ctx.to_float(rii) < 0 else 1.0)
            tail = ctx.dot(self.R[i, i + 1:n], self.R[i, i + 1:n]) \
                if i + 1 < n else ctx.scalar(0)
            total = rii * rii + tail
            if total != 0:
                norm = ctx.sqrt(total)
                s = self.sigma[i] * norm
                denom = rii + s
                v1 = -tail / denom
                if v1 != 0:
                    scale = ctx.sqrt((-s) * v1)  # sqrt(-sigma*||r|| * v1) >= 0
                    self.V[i, i] = v1 / scale
                    self.R[i, i] = norm
                    for k in range(i + 1, n):
                        self.V[i, k] = self.R[i, k] / scale
                        self.R[i, k] = ctx.scalar(0)
                else:
                    self.V[i, i] = ctx.scalar(0)
                    if ctx.to_float(self.R[i, i]) < 0:
                        self.R[i, i] = -self.R[i, i]
                    for k in range(i + 1, n):
                        self.V[i, k] = ctx.scalar(0)
                        self.R[i, k] = ctx.scalar(0)
            else:
                self.R[i, i] = ctx.scalar(0)
                self.V[i, i] = ctx.scalar(0)
                for k in range(i + 1, n):
                    self.V[i, k] = ctx.scalar(0)
                    self.R[i, k] = ctx.scalar(0)
        self.n_known_rows = max(self.n_known_rows, i + 1)
        if self._fast and self._vvt_valid > i:
            self._vvt_valid = i  # reflector i changed; rows >= i are stale

    def _refresh_vvt(self, i: int) -> None:
        """Ensure the V V^T cache covers reflector rows 0..i-1."""
        V = self.V
        while self._vvt_valid < i:
            j = self._vvt_valid
            col = V[:j + 1] @ V[j]
            self._vvt[j, :j + 1] = col
            self._vvt[:j + 1, j] = col
            self._vvt_valid += 1

    def update_R(self, i: int, last_j: bool = True) -> None:
        """Apply reflectors 0..i-1 to row i (householder.cpp:151-184).

        f64 fast path: one compact-WY application (triangular solve + two
        GEMVs, ops/blockgso.wy_apply_row) instead of i sequential dot+axpy
        pairs; soft-float engines keep the reference's sequential order
        with per-step snapshots.
        """
        ctx = self.ctx
        n = self.n
        if not self.updated_R:
            if self._fast:
                from scipy.linalg import solve_triangular
                self.R_start[i, :] = self.R[i, :]
                if i > 0:
                    self._refresh_vvt(i)
                    Vp = self.V[:i]
                    c = Vp @ self.R[i, :]
                    t = solve_triangular(self._vvt[:i, :i], c, lower=True,
                                         unit_diagonal=True,
                                         check_finite=False)
                    r = self.R[i, :] - t @ Vp
                    r[:i] *= self.sigma[:i]
                    self.tcoef[i, :i] = t
                    self.R[i, :] = r
                self.R_applied[i, :] = self.R[i, :]
            else:
                with ctx.guard():
                    for j in range(i):
                        dotp = ctx.dot(self.V[j, j:n], self.R[i, j:n])
                        self.R[i, j:n] = self.R[i, j:n] - dotp * self.V[j, j:n]
                        self.R[i, j] = self.sigma[j] * self.R[i, j]
                        self.R_history[i][j, j:n] = self.R[i, j:n]
            if last_j:
                self.update_R_last(i)

    def update_R_all(self) -> None:
        for i in range(self.d):
            self.updated_R = False
            self.update_R(i, True)

    def recover_R(self, i: int) -> None:
        """Restore R[i] to its state after reflectors 0..i-1 in O(n·i)
        (householder.h:597-608: prefix columns take their final values,
        tail columns the snapshot after reflector i-1)."""
        if self._fast:
            self.R[i, :i - 1] = self.R_applied[i, :i - 1]
            tail = self.R_start[i, i - 1:] - \
                self.tcoef[i, :i] @ self.V[:i, i - 1:]
            tail[0] *= self.sigma[i - 1]
            self.R[i, i - 1:] = tail
        else:
            for k in range(i - 1):
                self.R[i, k] = self.R_history[i][k, k]
            self.R[i, i - 1:] = self.R_history[i][i - 1, i - 1:]
        self.updated_R = True

    def set_updated_R_false(self) -> None:
        self.updated_R = False

    def invalidate_row(self, k: int) -> None:
        if k < self.n_known_rows:
            self.n_known_rows = k
        if self._fast and k < self._vvt_valid:
            self._vvt_valid = k

    # -- accessors ------------------------------------------------------------
    def get_R(self, i: int, j: int) -> Tuple[object, int]:
        return self.R[i, j], int(self.row_expo[i])

    def get_R_naively(self, i: int, j: int) -> Tuple[object, int]:
        return self.R_naively[i, j], int(self.row_expo_naively[i])

    def get_row_expo(self, i: int) -> int:
        return int(self.row_expo[i])

    def get_norm_square_b(self, k: int) -> Tuple[object, int]:
        return self.norm_square_b[k], int(self.expo_norm_square_b[k])

    def norm_square_R_row(self, k: int, beg: int, end: int) -> Tuple[object, int]:
        """sum_{i in [beg,end)} R[k][i]^2, with exponent 2*row_expo[k]."""
        with self.ctx.guard():
            v = self.ctx.dot(self.R[k, beg:end], self.R[k, beg:end])
        return v, 2 * int(self.row_expo[k])

    def norm_R_row(self, k: int, beg: int, end: int) -> Tuple[object, int]:
        v, e = self.norm_square_R_row(k, beg, end)
        return self.ctx.sqrt(v), e // 2

    # -- exact basis row operations (householder.cpp:453-560) ----------------
    def _exact_mult(self, x, expo_add: int) -> int:
        if isinstance(x, (int, np.integer)):
            return int(x) << expo_add if expo_add >= 0 else int(x)
        if isinstance(x, (float, np.floating)):
            return round_mul_2exp(float(x), expo_add)
        return _mpf_to_int_mul_2exp(x, expo_add)

    def row_addmul_we(self, i: int, j: int, x, expo_add: int) -> None:
        """b[i] += (x*2^expo_add) b[j]; R[i] prefix updated approximately."""
        mult = self._exact_mult(x, expo_add)
        if mult:
            self.b.row_addmul(i, j, mult)
            if self.enable_transform:
                self.u.row_addmul(i, j, mult)
                if self.enable_inverse_transform:
                    self.u_inv_t.row_addmul(j, i, -mult)
        with self.ctx.guard():
            self.R[i, :i] = self.R[i, :i] + x * self.R[j, :i]

    def _size_reduce_f64(self, k: int, end: int, start: int) -> bool:
        """f64 sweep with the rnd_we rounding vectorized.

        The descending cascade only has a dependency through the prefix
        update R[k, :i] += x R[i, :i], and most candidate multipliers
        round to zero — so compute all rounded multipliers in one shot,
        apply the highest nonzero one (indices above it saw the same row
        state and stay zero), and recompute below it. Reduction decisions
        and exact basis updates match the scalar path."""
        if end <= start:
            return False
        R = self.R
        row = R[k]
        re_k = int(self.row_expo[k])
        diag = np.diagonal(R[:end, :end])
        ed = (re_k - self.row_expo[:end]).astype(np.int64)
        reduced = False
        i_hi = end
        while i_hi > start:
            with np.errstate(all="ignore"):
                q = row[start:i_hi] / diag[start:i_hi]
                e = ed[start:i_hi]
                scaled = np.ldexp(q, e)
                x = np.ldexp(np.rint(scaled), -e)
                fe = np.frexp(q)[1]
                finite = np.isfinite(q)
                big = (fe + e >= 53) & (q != 0.0) & finite
                x = np.where(big, q, x)
                x = np.where(finite, x, 0.0)
            nz = np.nonzero(x)[0]
            if len(nz) == 0:
                break
            j = int(nz[-1])
            i = start + j
            self.row_addmul_we(k, i, -float(x[j]), int(ed[i]))
            reduced = True
            i_hi = i
        if reduced:
            self.invalidate_row(k)
        return reduced

    def size_reduce(self, k: int, size_reduction_end: int,
                    size_reduction_start: int = 0) -> bool:
        """One weak-size-reduction sweep of row k (householder.cpp:400-452)."""
        if self._fast:
            return self._size_reduce_f64(k, size_reduction_end,
                                         size_reduction_start)
        ctx = self.ctx
        reduced = False
        with ctx.guard():
            for i in range(size_reduction_end - 1, size_reduction_start - 1, -1):
                q = self.R[k, i] / self.R[i, i]
                expo = int(self.row_expo[k] - self.row_expo[i])
                q = self._rnd_we(q, expo)
                q = -q
                if q != 0:
                    self.row_addmul_we(k, i, q, expo)
                    reduced = True
        if reduced:
            self.invalidate_row(k)
        return reduced

    def _rnd_we(self, v, expo: int):
        ctx = self.ctx
        if v == 0:
            return ctx.scalar(0)
        if ctx.exponent(v) + expo >= ctx.prec:
            return v
        return ctx.ldexp(ctx.rnd(ctx.ldexp(v, expo)), -expo)

    def swap(self, i: int, j: int) -> None:
        """Swap rows i < j with all bookkeeping (householder.cpp:372-398)."""
        self.invalidate_row(i)
        self.b.row_swap(i, j)
        self.bf[[i, j]] = self.bf[[j, i]]
        self.sigma[[i, j]] = self.sigma[[j, i]]
        self.row_expo[[i, j]] = self.row_expo[[j, i]]
        self.init_row_size[i], self.init_row_size[j] = \
            self.init_row_size[j], self.init_row_size[i]
        if self._fast:
            self.R_applied[[i, j]] = self.R_applied[[j, i]]
            self.R_start[[i, j]] = self.R_start[[j, i]]
            self.tcoef[[i, j]] = self.tcoef[[j, i]]
        else:
            self.R_history[i], self.R_history[j] = \
                self.R_history[j], self.R_history[i]
        if self.enable_transform:
            self.u.row_swap(i, j)
            if self.enable_inverse_transform:
                self.u_inv_t.row_swap(i, j)
        self.norm_square_b[[i, j]] = self.norm_square_b[[j, i]]
        self.expo_norm_square_b[[i, j]] = self.expo_norm_square_b[[j, i]]

    # -- naive reference computation (householder.cpp:263-369) ---------------
    def update_R_naively(self, i: int | None = None) -> None:
        if i is None:
            for k in range(self.d):
                self.update_R_naively(k)
            return
        ctx = self.ctx
        n = self.n
        row = self.b.a[i]
        with ctx.guard():
            if self.enable_row_expo:
                pairs = [int_to_f_exp(int(row[j])) for j in range(n)]
                max_e = max((e for f, e in pairs if f != 0.0), default=0)
                self.row_expo_naively[i] = max_e
                for j in range(n):
                    f, e = pairs[j]
                    self.R_naively[i, j] = ctx.ldexp(ctx.scalar(f), e - max_e) \
                        if f != 0.0 else ctx.scalar(0)
            else:
                for j in range(n):
                    self.R_naively[i, j] = ctx.from_int(int(row[j]))
            for j in range(i):
                dotp = ctx.dot(self.V_naively[j, j:n], self.R_naively[i, j:n])
                self.R_naively[i, j:n] = self.R_naively[i, j:n] - \
                    dotp * self.V_naively[j, j:n]
                self.R_naively[i, j] = self.sigma_naively[j] * self.R_naively[i, j]
            self.V_naively[i, i:n] = self.R_naively[i, i:n]
            self.sigma_naively[i] = ctx.scalar(
                -1.0 if ctx.to_float(self.R_naively[i, i]) < 0 else 1.0)
            total = ctx.dot(self.R_naively[i, i:n], self.R_naively[i, i:n])
            s = ctx.sqrt(total) * self.sigma_naively[i]
            denom = self.R_naively[i, i] + s
            if denom != 0:
                tail = ctx.dot(self.R_naively[i, i + 1:n],
                               self.R_naively[i, i + 1:n]) if i + 1 < n \
                    else ctx.scalar(0)
                if tail != 0:
                    v1 = -tail / denom
                    self.V_naively[i, i] = v1
                    scale = ctx.sqrt((-s) * v1)
                    self.V_naively[i, i:n] = self.V_naively[i, i:n] / scale
                    self.R_naively[i, i] = abs(s)
                    for j in range(i + 1, n):
                        self.R_naively[i, j] = ctx.scalar(0)
                else:
                    if ctx.to_float(self.R_naively[i, i]) < 0:
                        self.R_naively[i, i] = -self.R_naively[i, i]
                    self.V_naively[i, i] = ctx.scalar(0)
                    for k in range(i + 1, n):
                        self.V_naively[i, k] = ctx.scalar(0)
                        self.R_naively[i, k] = ctx.scalar(0)
            else:
                for k in range(i, n):
                    self.V_naively[i, k] = ctx.scalar(0)
                    self.R_naively[i, k] = ctx.scalar(0)
        self.n_known_rows_naively = max(self.n_known_rows_naively, i + 1)
