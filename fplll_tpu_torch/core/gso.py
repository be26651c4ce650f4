"""Lazy Gram–Schmidt orthogonalization engines.

TPU-native re-design of the reference's MatGSOInterface/MatGSO/MatGSOGram
(fplll/gso_interface.h:59, gso.h:33, gso_gram.h:34,
gso_interface.cpp:131-311, gso.cpp:24-479).

Host-side state machine over an exact integer basis with float mu/r kept
in a pluggable float context (float64 or soft-float; see
fplll_tpu_torch.nr.fctx). Row-exponent scaling (GSO_ROW_EXPO) stores
block-floating-point rows — the natural TPU data layout. The batched /
device-resident GSO path for large instances lives in
fplll_tpu_torch.ops.blockgso and shares the same interface concept.

Semantics deliberately preserved from the reference:
- lazy per-row validity (`gso_valid_cols`, `n_known_rows`) with
  invalidation on row ops (gso_interface.cpp:26-53),
- scaled storage under GSO_ROW_EXPO: stored mu(i,j) = true/2^(ei-ej),
  stored r(i,j) = true/2^(ei+ej) (gso.h:100-140 accessor contracts),
- exact integer Gram maintenance under GSO_INT_GRAM (gso.cpp:84-234).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from scipy.linalg import solve_triangular

from ..defs import GSO_DEFAULT, GSO_INT_GRAM, GSO_OP_FORCE_LONG, GSO_ROW_EXPO
from ..nr.fctx import F64Ctx, int_to_f_exp, round_mul_2exp
from ..ops.intmat import IntMat

__all__ = ["MatGSO", "MatGSOGram", "adjust_radius_to_gh_bound"]


def _mpf_to_int_mul_2exp(x, e: int) -> int:
    """Exact integer value of x * 2^e for a soft-float scalar (mpmath mpf
    or compiled dpe/dd/qd/dde/qde) known to be integral."""
    if not hasattr(x, "_mpf_"):
        f = getattr(x, "to_int_2exp", None)
        if f is not None:
            return f(e)
        from ..nr.fctx import comps_to_int_mul_2exp
        comps, off = x.parts()
        return comps_to_int_mul_2exp(comps, off + e)
    sign, man, exp, _ = x._mpf_
    if man == 0:
        return 0
    sh = exp + e
    v = man << sh if sh >= 0 else man >> (-sh)
    return -v if sign else v


class MatGSOInterface:
    """Shared lazy-GSO state machine (reference: gso_interface.h:59)."""

    def __init__(self, d: int, flags: int, ctx=None,
                 u: Optional[IntMat] = None, u_inv_t: Optional[IntMat] = None,
                 device=None):
        self.ctx = ctx if ctx is not None else F64Ctx()
        self.d = d
        # where a blocked full recompute at d >= device_gso_dim() runs;
        # resolved there (torchsetup.resolve_device), not here
        self.device = device
        self.enable_int_gram = bool(flags & GSO_INT_GRAM)
        self.enable_row_expo = bool(flags & GSO_ROW_EXPO)
        self.row_op_force_long = bool(flags & GSO_OP_FORCE_LONG)
        if self.enable_int_gram and self.enable_row_expo:
            raise ValueError("GSO_INT_GRAM and GSO_ROW_EXPO are exclusive")
        self.u = u
        self.u_inv_t = u_inv_t
        self.enable_transform = u is not None
        self.enable_inverse_transform = u_inv_t is not None

        self.mu = self.ctx.zeros((d, d))
        self.r = self.ctx.zeros((d, d))
        self.gso_valid_cols = [0] * d
        self.n_known_rows = 0
        self.n_source_rows = 0
        self.cols_locked = False
        self.row_expo = np.zeros(d, dtype=np.int64) if self.enable_row_expo else None

    # -- to be provided by concrete classes --------------------------------
    def discover_row(self) -> None:
        raise NotImplementedError

    def get_gram(self, i: int, j: int):
        """ctx scalar <b_i, b_j> (scaled by 2^-(ei+ej) under row_expo)."""
        raise NotImplementedError

    def get_int_gram(self, i: int, j: int) -> int:
        raise NotImplementedError

    def _row_addmul_exact(self, i: int, j: int, x: int) -> None:
        raise NotImplementedError

    def row_swap(self, i: int, j: int) -> None:
        raise NotImplementedError

    def _rotate_state_right(self, new_r: int, old_r: int) -> None:
        raise NotImplementedError

    def _rotate_state_left(self, old_r: int, new_r: int) -> None:
        raise NotImplementedError

    def b_row_is_zero(self, i: int) -> bool:
        raise NotImplementedError

    def get_max_exp_of_b(self) -> int:
        raise NotImplementedError

    # -- validity bookkeeping ----------------------------------------------
    def invalidate_gso_row(self, i: int, new_valid_cols: int = 0) -> None:
        self.gso_valid_cols[i] = min(self.gso_valid_cols[i], new_valid_cols)

    def row_op_begin(self, first: int, last: int) -> None:
        pass  # debug bookkeeping only in the reference

    def row_op_end(self, first: int, last: int) -> None:
        """Invalidate after in-place row updates (gso_interface.cpp:32-53)."""
        for i in range(first, last):
            self._after_row_op(i)
            self.invalidate_gso_row(i, 0)
        for i in range(last, self.n_known_rows):
            self.invalidate_gso_row(i, first)

    def _after_row_op(self, i: int) -> None:
        pass

    # -- the core recurrence ------------------------------------------------
    def get_gram_row(self, i: int, last_j: int):
        """All <b_i, b_j> for j <= last_j (vectorized where possible)."""
        return np.array([self.get_gram(i, j) for j in range(last_j + 1)],
                        dtype=self.ctx.dtype)

    def _update_gso_row_f64(self, i: int, last_j: int) -> bool:
        """Vectorized f64 fast path of the CGS recurrence.

        The column recurrence r(i,j) = g(i,j) - sum_{k<j} mu(j,k) r(i,k)
        is a unit-lower-triangular solve L r_i = g_i with L = I + strict
        lower mu — one BLAS call instead of a scalar loop (the panel/
        blocked re-expression promised in SURVEY §7).
        """
        j0 = max(0, self.gso_valid_cols[i])
        g_row = self.get_gram_row(i, last_j)
        mu_i = self.mu[i]
        r_i = self.r[i]
        n = last_j + 1
        ns = min(n, i)  # rows of L above i are the valid mu rows
        if ns - j0 > 12 and j0 == 0:
            with np.errstate(all="ignore"):
                sol = solve_triangular(self.mu[:ns, :ns], g_row[:ns],
                                       lower=True, unit_diagonal=True,
                                       check_finite=False)
                r_i[:ns] = sol
                mu_i[:ns] = sol / np.diagonal(self.r)[:ns]
            if not np.isfinite(mu_i[:ns]).all():
                return False
            if last_j >= i:
                r_i[i] = g_row[i] - float(np.dot(mu_i[:i], sol[:i]))
            self.gso_valid_cols[i] = n
            return True
        j = j0
        r = self.r
        mu = self.mu
        while j <= last_j:
            t = g_row[j] - float(np.dot(mu[j, :j], r_i[:j])) if j else g_row[j]
            r_i[j] = t
            if i > j:
                rjj = r[j, j]
                m = t / rjj if rjj != 0.0 else (math.nan if t == 0.0 else
                                                math.copysign(math.inf, t))
                mu_i[j] = m
                if not math.isfinite(m):
                    return False
            j += 1
        self.gso_valid_cols[i] = j
        return True

    def _native_gram_row(self, i: int, last_j: int):
        """1-d object array whose entries [0..last_j] are the Gram values
        in a form the compiled engine coerces exactly (raw Python ints
        for int-Gram, cached fpnum scalars otherwise), or None when the
        native row recurrence cannot be used."""
        return None

    def update_gso_row(self, i: int, last_j: int | None = None) -> bool:
        """One row of classical Gram-Schmidt (gso_interface.cpp:131-164):
        r(i,j) = <b_i,b_j> - sum_k<j mu(j,k) r(i,k);  mu(i,j) = r(i,j)/r(j,j).
        """
        if last_j is None:
            last_j = i
        if i >= self.n_known_rows:
            self.discover_row()
        if isinstance(self.ctx, F64Ctx):
            return self._update_gso_row_f64(i, last_j)
        native = getattr(self.ctx, "native_engine", None)
        j0 = max(0, self.gso_valid_cols[i])
        if native is not None and j0 <= last_j:
            grow = self._native_gram_row(i, last_j)
            if grow is not None:
                # whole-row recurrence in one C call (the compiled-engine
                # replacement of the per-scalar loop below)
                n = native.gso_row_update(self.mu, self.r, grow, i, j0,
                                          last_j, self.ctx.kind_id)
                if n <= last_j:
                    return False          # nonfinite mu at column n
                self.gso_valid_cols[i] = last_j + 1
                return True
        j = j0
        with self.ctx.guard():
            while j <= last_j:
                t = self.get_gram(i, j)
                if j > 0:
                    t = t - self.ctx.dot(self.mu[j, :j], self.r[i, :j])
                self.r[i, j] = t
                if i > j:
                    try:
                        with np.errstate(divide="ignore", invalid="ignore"):
                            m = t / self.r[j, j]
                    except ZeroDivisionError:
                        # soft-float 0/0: the mpfr backend would yield NaN
                        return False
                    self.mu[i, j] = m
                    if not self.ctx.is_finite(m):
                        return False
                j += 1
        self.gso_valid_cols[i] = j
        return True

    def update_gso(self) -> bool:
        if isinstance(self.ctx, F64Ctx) and self._try_block_update_gso():
            return True
        for i in range(self.d):
            if not self.update_gso_row(i):
                return False
        return True

    # -- blocked full recompute (ops/blockgso: Cholesky of the Gram) --------
    def _float_gram_full(self):
        """Full (d, d) float64 Gram in the stored scaling, or None when it
        cannot be formed (entries overflow f64)."""
        return None

    def _try_block_update_gso(self) -> bool:
        """Full-state GSO recompute as one blocked Cholesky when most rows
        are invalid (fresh objects, post-escalation restarts). Replaces d
        runs of the scalar recurrence with one LAPACK/XLA call; falls back
        to the lazy path on numerically indefinite Grams so divergence
        signalling matches the reference (gso_interface.cpp:156-158)."""
        d = self.d
        if d < 8 or self.cols_locked:
            return False
        n_valid = sum(1 for i in range(self.n_known_rows)
                      if self.gso_valid_cols[i] > i)
        if 2 * n_valid > d:
            return False
        while self.n_known_rows < d:
            self.discover_row()
        G = self._float_gram_full()
        if G is None:
            return False
        from ..ops.blockgso import full_gso
        out = full_gso(G, self.device)
        if out is None:
            return False
        mu, r = out
        np.fill_diagonal(mu, 0.0)
        self.mu = np.ascontiguousarray(mu)
        self.r = np.ascontiguousarray(r)
        for i in range(d):
            self.gso_valid_cols[i] = i + 1
        return True

    # -- accessors (gso.h:100-180 contracts) --------------------------------
    def get_mu_exp(self, i: int, j: int) -> Tuple[object, int]:
        expo = int(self.row_expo[i] - self.row_expo[j]) if self.enable_row_expo else 0
        return self.mu[i, j], expo

    def get_mu(self, i: int, j: int):
        v, e = self.get_mu_exp(i, j)
        return self.ctx.ldexp(v, e) if e else v

    def get_r_exp(self, i: int, j: int) -> Tuple[object, int]:
        expo = int(self.row_expo[i] + self.row_expo[j]) if self.enable_row_expo else 0
        return self.r[i, j], expo

    def get_r(self, i: int, j: int):
        v, e = self.get_r_exp(i, j)
        return self.ctx.ldexp(v, e) if e else v

    def set_r(self, i: int, j: int, value) -> None:
        self.r[i, j] = value
        if self.gso_valid_cols[i] == j:
            self.gso_valid_cols[i] = j + 1

    def get_max_mu_exp(self, i: int, n_columns: int) -> int:
        """max exponent over the true mu(i, 0..n_columns) (gso_interface.cpp:86)."""
        mx = None
        for j in range(n_columns):
            v, e = self.get_mu_exp(i, j)
            tot = self.ctx.exponent(v) + e
            mx = tot if mx is None else max(mx, tot)
        return mx if mx is not None else 0

    def get_max_bstar(self):
        with self.ctx.guard():
            vals = [self.get_r(i, i) for i in range(self.n_known_rows)]
            return max(vals) if vals else self.ctx.scalar(0)

    def get_max_gram(self) -> int:
        """max diagonal Gram entry (gso_interface.cpp:55-77)."""
        vals = [self.get_int_gram(i, i) for i in range(self.n_known_rows)]
        return max(vals) if vals else 0

    def apply_transform(self, transform, src_base: int,
                        target_base: int) -> None:
        """Replace rows [target_base, target_base+k) by transform applied
        to rows starting at src_base (gso_interface.cpp:174-196).

        transform is a list of integer coefficient rows.
        """
        target_size = len(transform)
        if target_size == 0:
            return
        old_d = self.d
        self.create_rows(target_size)
        for i in range(target_size):
            for j, c in enumerate(transform[i]):
                if c:
                    self._row_addmul_exact(old_d + i, src_base + j, int(c))
        self.row_op_begin(target_base, target_base + target_size)
        for i in range(target_size):
            self.row_swap(target_base + i, old_d + i)
        self.row_op_end(target_base, target_base + target_size)
        self.remove_last_rows(target_size)

    def create_rows(self, n: int) -> None:
        raise NotImplementedError

    def remove_last_rows(self, n: int) -> None:
        raise NotImplementedError

    # -- exact row operations ------------------------------------------------
    def row_addmul(self, i: int, j: int, x) -> None:
        self.row_addmul_we(i, j, x, 0)

    def row_addmul_we(self, i: int, j: int, x, expo_add: int) -> None:
        """b[i] += (x * 2^expo_add) * b[j], the multiplier being an exact
        integer by the caller's rnd_we rounding (gso.cpp:236-262)."""
        if isinstance(x, (int, np.integer)):
            mult = int(x) << expo_add if expo_add >= 0 else int(x)
        elif isinstance(x, (float, np.floating)):
            mult = round_mul_2exp(float(x), expo_add)
        else:  # mpmath soft float
            mult = _mpf_to_int_mul_2exp(x, expo_add)
        if mult != 0:
            self._row_addmul_exact(i, j, mult)

    def move_row(self, old_r: int, new_r: int) -> None:
        """Move a basis row, rotating all GSO state (gso.cpp:289-366)."""
        if self.cols_locked:
            raise RuntimeError("move_row with locked columns")
        if new_r < old_r:
            for i in range(new_r, self.n_known_rows):
                self.invalidate_gso_row(i, new_r)
            self._pylist_rotate_right(self.gso_valid_cols, new_r, old_r)
            self._mat_rotate_right(self.mu, new_r, old_r)
            self._mat_rotate_right(self.r, new_r, old_r)
            self._rotate_state_right(new_r, old_r)
        elif new_r > old_r:
            for i in range(old_r, self.n_known_rows):
                self.invalidate_gso_row(i, old_r)
            self._pylist_rotate_left(self.gso_valid_cols, old_r, new_r)
            self._mat_rotate_left(self.mu, old_r, new_r)
            self._mat_rotate_left(self.r, old_r, new_r)
            self._rotate_state_left(old_r, new_r)

    @staticmethod
    def _pylist_rotate_right(lst: List, first: int, last: int) -> None:
        lst[first:last + 1] = [lst[last]] + lst[first:last]

    @staticmethod
    def _pylist_rotate_left(lst: List, first: int, last: int) -> None:
        lst[first:last + 1] = lst[first + 1:last + 1] + [lst[first]]

    @staticmethod
    def _mat_rotate_right(a: np.ndarray, first: int, last: int) -> None:
        tmp = a[last].copy()
        a[first + 1:last + 1] = a[first:last]
        a[first] = tmp

    @staticmethod
    def _mat_rotate_left(a: np.ndarray, first: int, last: int) -> None:
        tmp = a[first].copy()
        a[first:last] = a[first + 1:last + 1]
        a[last] = tmp

    @staticmethod
    def _gram_rotate_right(g: np.ndarray, first: int, last: int) -> None:
        MatGSOInterface._mat_rotate_right(g, first, last)
        tmp = g[:, last].copy()
        g[:, first + 1:last + 1] = g[:, first:last]
        g[:, first] = tmp

    @staticmethod
    def _gram_rotate_left(g: np.ndarray, first: int, last: int) -> None:
        MatGSOInterface._mat_rotate_left(g, first, last)
        tmp = g[:, first].copy()
        g[:, first:last] = g[:, first + 1:last + 1]
        g[:, last] = tmp

    def lock_cols(self) -> None:
        self.cols_locked = True

    def unlock_cols(self) -> None:
        self.n_known_rows = self.n_source_rows
        self.cols_locked = False

    def symmetrize_g(self) -> None:
        pass  # full symmetric Gram storage: always symmetric

    # -- derived statistics (gso_interface.cpp:198-275) ----------------------
    def get_current_slope(self, start_row: int = 0, stop_row: int = -1) -> float:
        if stop_row == -1:
            stop_row = self.d
        n = stop_row - start_row
        v1, v2 = 0.0, (n + 1) * n * (n - 1) / 12.0
        weight = (1.0 - n) / 2.0
        for i in range(start_row, stop_row):
            self.update_gso_row(i)
            v, e = self.get_r_exp(i, i)
            fv = self.ctx.to_float(v)
            v1 += weight * (math.log(fv) + e * math.log(2.0))
            weight += 1.0
        return v1 / v2

    def get_log_det(self, start_row: int, end_row: int):
        start_row, end_row = max(0, start_row), min(self.d, end_row)
        with self.ctx.guard():
            s = self.ctx.scalar(0)
            for i in range(start_row, end_row):
                s = s + self.ctx.log(self.get_r(i, i))
            return s

    def get_root_det(self, start_row: int, end_row: int):
        start_row, end_row = max(0, start_row), min(self.d, end_row)
        h = end_row - start_row
        with self.ctx.guard():
            return self.ctx.pow(math.e, self.ctx.to_float(self.get_log_det(start_row, end_row)) / h)

    def get_slide_potential(self, start_row: int, end_row: int, block_size: int):
        p = (end_row - start_row) // block_size
        if (end_row - start_row) % block_size == 0:
            p -= 1
        with self.ctx.guard():
            s = self.ctx.scalar(0)
            for i in range(p):
                s = s + (p - i) * self.get_log_det(i * block_size, (i + 1) * block_size)
            return s

    # -- Babai nearest plane (gso_interface.cpp:277-311) ---------------------
    def babai(self, v: List, start: int = 0, dimension: int = -1,
              from_floats: bool = False) -> List[int]:
        """Nearest-plane: returns integer coefficient vector w such that
        sum w_i b_{start+i} is close to the input vector of coefficients."""
        if dimension == -1:
            dimension = self.d - start
        with self.ctx.guard():
            x = [self.ctx.scalar(t) if from_floats else self.ctx.from_int(int(t))
                 for t in v]
            for i in range(dimension - 1, -1, -1):
                x[i] = self.ctx.rnd(x[i])
                for j in range(i):
                    x[j] = x[j] - self.get_mu(start + i, start + j) * x[i]
            return [self.ctx.rnd_int(x[i]) for i in range(dimension)]

    # -- block export for enumeration / device kernels ----------------------
    def export_mu_r(self, first: int, last: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Export true mu^T and rdiag for rows [first, last) as float64,
        jointly normalized by 2^-normexp on rdiag (the extenum contract,
        reference: enum/enumerate_ext.cpp:67-78).

        Returns (mut, rdiag_scaled, normexp) where mut[i][j] = mu(first+j,
        first+i) for i<j (upper triangular with unit diagonal implied
        zero) and rdiag_scaled[i] = r(first+i, first+i) / 2^normexp.
        """
        k = last - first
        for i in range(first, last):
            self.update_gso_row(i)
        if isinstance(self.ctx, F64Ctx):
            # vectorized export: true values via per-row exponent outer sums
            mu_blk = np.asarray(self.mu[first:last, first:last],
                                dtype=np.float64)
            r_diag = np.array([self.r[first + i, first + i]
                               for i in range(k)], dtype=np.float64)
            if self.enable_row_expo:
                e = self.row_expo[first:last].astype(np.int64)
                with np.errstate(over="ignore", under="ignore"):
                    mu_true = np.ldexp(mu_blk, e[:, None] - e[None, :])
                r_e = 2 * e
            else:
                mu_true = mu_blk
                r_e = np.zeros(k, dtype=np.int64)
            mant, ex = np.frexp(r_diag)
            cur = r_e + np.where(r_diag == 0.0, 0, ex - 1)
            normexp = int(cur.max()) if k else 0
            normexp += normexp & 1
            with np.errstate(over="ignore", under="ignore"):
                rdiag = np.ldexp(r_diag, r_e - normexp)
            mut = np.zeros((k, k), dtype=np.float64)
            iu = np.triu_indices(k, 1)
            mut[iu] = mu_true.T[iu]
            return mut, rdiag, normexp
        # normexp = max over rows of r exponent (even), as in enumerate.cpp
        normexp = 0
        for i in range(first, last):
            v, e = self.get_r_exp(i, i)
            cur = e + max(0, self.ctx.exponent(v) - 1)
            normexp = max(normexp, cur) if i > first else cur
        normexp = normexp + (normexp & 1)  # keep even so sqrt scaling is exact
        rdiag = np.zeros(k, dtype=np.float64)
        mut = np.zeros((k, k), dtype=np.float64)
        for i in range(first, last):
            v, e = self.get_r_exp(i, i)
            rdiag[i - first] = self.ctx.to_float(self.ctx.ldexp(v, e - normexp))
            for j in range(first, i):
                mut[j - first, i - first] = self.ctx.to_float(self.get_mu(i, j))
        return mut, rdiag, normexp


def adjust_radius_to_gh_bound(max_dist: float, max_dist_expo: int, block_size: int,
                              root_det: float, gh_factor: float) -> float:
    """Clamp an enumeration radius to gh_factor * GH(block) where GH is the
    Gaussian heuristic (gso_interface.cpp:257-275); max_dist is scaled by
    2^max_dist_expo."""
    t = float(block_size) / 2.0 + 1
    t = math.lgamma(t)
    t = math.pow(math.e, t * 2.0 / float(block_size)) / math.pi
    f = t * float(root_det) * gh_factor
    f = math.ldexp(f, -max_dist_expo)
    return min(max_dist, f)


class MatGSO(MatGSOInterface):
    """Basis-backed GSO engine (reference: gso.h:33)."""

    def __init__(self, b: IntMat, u: Optional[IntMat] = None,
                 u_inv_t: Optional[IntMat] = None, flags: int = GSO_DEFAULT,
                 ctx=None, device=None):
        super().__init__(b.nrows, flags, ctx, u, u_inv_t, device)
        self.b = b
        d, cols = b.nrows, b.ncols
        self.n_known_cols = 0
        self.init_row_size = [max(b.row_size_nz(i), 1) for i in range(d)]
        if self.enable_int_gram:
            self.g = np.empty((d, d), dtype=object)
            self.g[...] = 0
            self.bf = None
            self.gf = None
        else:
            self.g = None
            self.bf = self.ctx.zeros((d, cols))
            self.gf = self.ctx.zeros((d, d))
            self.gf[...] = math.nan
            for i in range(d):
                self.update_bf(i)

    # -- float basis maintenance (gso.cpp:24-48) -----------------------------
    def update_bf(self, i: int) -> None:
        n = max(self.n_known_cols, self.init_row_size[i])
        row = self.b.a[i]
        fast = isinstance(self.ctx, F64Ctx)
        native = getattr(self.ctx, "native_engine", None)
        if not fast and native is not None:
            # whole-row conversion in one C call (gso.cpp:24-48)
            out, max_e = native.bf_row_from_ints(
                row, n, self.ctx.kind_id, 1 if self.enable_row_expo else 0)
            if self.enable_row_expo:
                self.row_expo[i] = max_e
            self.bf[i, :] = out
            return
        if self.enable_row_expo:
            if fast:
                # all-small rows (every |entry| <= 2^53): one vectorized
                # conversion — entries are exactly representable, so this
                # matches the per-entry int_to_f_exp path bit for bit
                try:
                    arr = row[:n].astype(np.float64)
                except (OverflowError, TypeError):
                    arr = None
                if arr is not None and \
                        np.all(np.abs(arr) < 9007199254740992.0):
                    nz = arr != 0.0
                    if nz.any():
                        max_e = int(np.frexp(arr[nz])[1].max())
                    else:
                        max_e = 0
                    self.row_expo[i] = max_e
                    with np.errstate(under="ignore"):
                        self.bf[i, :n] = np.ldexp(arr, -max_e)
                    self.bf[i, n:] = 0.0
                    return
                pairs = [int_to_f_exp(int(row[j])) for j in range(n)]
                fs = np.fromiter((p[0] for p in pairs), dtype=np.float64,
                                 count=n)
                es = np.fromiter((p[1] for p in pairs), dtype=np.int64,
                                 count=n)
                max_e = int(es[fs != 0.0].max()) if (fs != 0.0).any() else 0
                self.row_expo[i] = max_e
                with np.errstate(under="ignore"):
                    self.bf[i, :n] = np.ldexp(fs, es - max_e)
                self.bf[i, n:] = 0.0
                return
            fs, es = [], []
            max_e = None
            for j in range(n):
                f, e = int_to_f_exp(int(row[j]))
                fs.append(f)
                es.append(e)
                if f != 0.0:
                    max_e = e if max_e is None else max(max_e, e)
            if max_e is None:
                max_e = 0
            self.row_expo[i] = max_e
            with self.ctx.guard():
                for j in range(n):
                    self.bf[i, j] = self.ctx.ldexp(self.ctx.scalar(fs[j]), es[j] - max_e) \
                        if fs[j] != 0.0 else self.ctx.scalar(0)
                for j in range(n, self.bf.shape[1]):
                    self.bf[i, j] = self.ctx.scalar(0)
        else:
            with self.ctx.guard():
                for j in range(n):
                    self.bf[i, j] = self.ctx.from_int(int(row[j]))
                for j in range(n, self.bf.shape[1]):
                    self.bf[i, j] = self.ctx.scalar(0)

    def invalidate_gram_row(self, i: int) -> None:
        # full-symmetric storage: drop every pair involving row i
        if self.gf is not None:
            self.gf[i, :] = math.nan
            self.gf[:, i] = math.nan

    def _after_row_op(self, i: int) -> None:
        if not self.enable_int_gram:
            self.update_bf(i)
            self.invalidate_gram_row(i)

    # -- row discovery (gso.cpp:56-82) ---------------------------------------
    def discover_row(self) -> None:
        i = self.n_known_rows
        self.n_known_rows += 1
        if not self.cols_locked:
            self.n_source_rows = self.n_known_rows
            self.n_known_cols = max(self.n_known_cols, self.init_row_size[i])
        if self.enable_int_gram:
            for j in range(i + 1):
                v = self.b.dot_rows(i, j, self.n_known_cols)
                self.g[i, j] = v
                self.g[j, i] = v
        else:
            self.invalidate_gram_row(i)
        self.gso_valid_cols[i] = 0

    # -- gram access ---------------------------------------------------------
    def get_gram(self, i: int, j: int):
        if self.enable_int_gram:
            return self.ctx.from_int(int(self.g[i, j]))
        v = self.gf[i, j]
        if (isinstance(v, float) and math.isnan(v)) or \
           (not isinstance(v, float) and not self.ctx.is_finite(v)):
            with self.ctx.guard():
                n = self.n_known_cols if not self.cols_locked else self.bf.shape[1]
                v = self.ctx.dot(self.bf[i, :n], self.bf[j, :n])
            self.gf[i, j] = v
            self.gf[j, i] = v
        return v

    def get_int_gram(self, i: int, j: int) -> int:
        if self.enable_int_gram:
            return int(self.g[i, j])
        return self.b.dot_rows(i, j)

    def _native_gram_row(self, i: int, last_j: int):
        if self.enable_int_gram:
            return self.g[i, :last_j + 1]      # raw ints, coerced in C
        n = self.n_known_cols if not self.cols_locked else self.bf.shape[1]
        native = self.ctx.native_engine
        if hasattr(native, "gram_row_fill"):
            native.gram_row_fill(self.gf, self.bf, i, last_j, n,
                                 self.ctx.kind_id)
        else:
            for j in range(last_j + 1):
                self.get_gram(i, j)            # fill the fpnum cache
        return self.gf[i, :last_j + 1]

    def get_gram_row(self, i: int, last_j: int):
        if self.enable_int_gram or not isinstance(self.ctx, F64Ctx):
            return super().get_gram_row(i, last_j)
        # f64: fill every missing entry of the row with one matmul
        row = self.gf[i, :last_j + 1]
        nanmask = np.isnan(row)
        if nanmask.any():
            n = self.n_known_cols if not self.cols_locked else self.bf.shape[1]
            idx = np.where(nanmask)[0]
            vals = self.bf[idx, :n] @ self.bf[i, :n]
            self.gf[i, idx] = vals
            self.gf[idx, i] = vals
        return self.gf[i, :last_j + 1]

    def _float_gram_full(self):
        if self.enable_int_gram:
            try:
                return self.g[:self.d, :self.d].astype(np.float64)
            except OverflowError:
                return None
        n = self.n_known_cols if not self.cols_locked else self.bf.shape[1]
        from ..ops.blockgso import gram_from_basis
        G = gram_from_basis(self.bf, n)
        self.gf[:, :] = G  # the lazy-gram cache is now fully known
        return G

    # -- exact row ops -------------------------------------------------------
    def _row_addmul_exact(self, i: int, j: int, x: int) -> None:
        self.b.row_addmul(i, j, x)
        if self.enable_transform:
            self.u.row_addmul(i, j, x)
            if self.enable_inverse_transform:
                self.u_inv_t.row_addmul(j, i, -x)
        if self.enable_int_gram:
            nk = self.n_known_rows
            gii = self.g[i, i] + 2 * x * self.g[i, j] + x * x * self.g[j, j]
            new_row = self.g[i, :nk] + self.g[j, :nk] * x
            new_row[i] = gii
            self.g[i, :nk] = new_row
            self.g[:nk, i] = new_row

    def row_swap(self, i: int, j: int) -> None:
        if self.enable_inverse_transform:
            raise RuntimeError("row_swap is incompatible with inverse transform")
        self.b.row_swap(i, j)
        if self.enable_transform:
            self.u.row_swap(i, j)
        if self.enable_int_gram:
            self.g[[i, j], :] = self.g[[j, i], :]
            self.g[:, [i, j]] = self.g[:, [j, i]]
        else:
            self.bf[[i, j]] = self.bf[[j, i]]
            self.gf[[i, j], :] = self.gf[[j, i], :]
            self.gf[:, [i, j]] = self.gf[:, [j, i]]
        if self.enable_row_expo:
            self.row_expo[[i, j]] = self.row_expo[[j, i]]

    def negate_row(self, i: int) -> None:
        """b[i] := -b[i]; Gram rows/cols flip sign except g(i,i)."""
        self.b.row_negate(i)
        if self.enable_transform:
            self.u.row_negate(i)
            if self.enable_inverse_transform:
                self.u_inv_t.row_negate(i)
        if self.enable_int_gram:
            nk = self.n_known_rows
            self.g[i, :nk] = -self.g[i, :nk]
            self.g[:nk, i] = -self.g[:nk, i]
        else:
            self._after_row_op(i)

    # -- state rotation for move_row ----------------------------------------
    def _rotate_state_right(self, new_r: int, old_r: int) -> None:
        self.b.rotate_right(new_r, old_r)
        if self.enable_transform:
            self.u.rotate_right(new_r, old_r)
            if self.enable_inverse_transform:
                self.u_inv_t.rotate_right(new_r, old_r)
        if self.enable_int_gram:
            self._gram_rotate_right(self.g, new_r, old_r)
        else:
            self._gram_rotate_right(self.gf, new_r, old_r)
            self._mat_rotate_right(self.bf, new_r, old_r)
        if self.enable_row_expo:
            tmp = self.row_expo[old_r]
            self.row_expo[new_r + 1:old_r + 1] = self.row_expo[new_r:old_r]
            self.row_expo[new_r] = tmp

    def _rotate_state_left(self, old_r: int, new_r: int) -> None:
        self.b.rotate_left(old_r, new_r)
        if self.enable_transform:
            self.u.rotate_left(old_r, new_r)
            if self.enable_inverse_transform:
                self.u_inv_t.rotate_left(old_r, new_r)
        if old_r < self.n_known_rows - 1:
            lim = min(new_r, self.n_known_rows - 1)
            if self.enable_int_gram:
                self._gram_rotate_left(self.g, old_r, lim)
            else:
                self._gram_rotate_left(self.gf, old_r, lim)
        if not self.enable_int_gram:
            self._mat_rotate_left(self.bf, old_r, new_r)
        if self.enable_row_expo:
            tmp = self.row_expo[old_r]
            self.row_expo[old_r:new_r] = self.row_expo[old_r + 1:new_r + 1]
            self.row_expo[new_r] = tmp
        if new_r >= self.n_known_rows:
            self._pylist_rotate_left(self.init_row_size, old_r, new_r)
            if old_r < self.n_known_rows:
                self.n_known_rows -= 1
                self.n_source_rows = self.n_known_rows
                self.init_row_size[new_r] = max(self.b.row_size_nz(new_r), 1)

    # -- row creation/removal (gso_interface.h create_row/remove_last_rows) --
    def create_rows(self, n: int) -> None:
        d_new = self.d + n
        cols = self.b.ncols
        self.b.resize(d_new, cols)
        if self.enable_transform:
            self.u.resize(d_new, self.u.ncols)
        def grow(a, shape):
            out = self.ctx.zeros(shape)
            out[:a.shape[0], :a.shape[1]] = a
            return out
        self.mu = grow(self.mu, (d_new, d_new))
        self.r = grow(self.r, (d_new, d_new))
        if self.enable_int_gram:
            g_new = np.empty((d_new, d_new), dtype=object)
            g_new[...] = 0
            g_new[:self.d, :self.d] = self.g
            self.g = g_new
        else:
            self.bf = grow(self.bf, (d_new, cols))
            gf_new = self.ctx.zeros((d_new, d_new))
            gf_new[...] = math.nan
            gf_new[:self.d, :self.d] = self.gf
            self.gf = gf_new
        if self.enable_row_expo:
            self.row_expo = np.concatenate(
                [self.row_expo, np.zeros(n, dtype=np.int64)])
        self.gso_valid_cols += [0] * n
        self.init_row_size += [1] * n
        self.d = d_new
        # new zero rows are discovered immediately so row ops apply to them
        while self.n_known_rows < self.d:
            self.discover_row()

    def remove_last_rows(self, n: int) -> None:
        d_new = self.d - n
        self.b.resize(d_new, self.b.ncols)
        if self.enable_transform:
            self.u.resize(d_new, self.u.ncols)
        self.mu = self.mu[:d_new, :d_new]
        self.r = self.r[:d_new, :d_new]
        if self.enable_int_gram:
            self.g = self.g[:d_new, :d_new]
        else:
            self.bf = self.bf[:d_new]
            self.gf = self.gf[:d_new, :d_new]
        if self.enable_row_expo:
            self.row_expo = self.row_expo[:d_new]
        self.gso_valid_cols = self.gso_valid_cols[:d_new]
        self.init_row_size = self.init_row_size[:d_new]
        self.d = d_new
        self.n_known_rows = min(self.n_known_rows, d_new)
        self.n_source_rows = min(self.n_source_rows, d_new)

    # -- misc ----------------------------------------------------------------
    def b_row_is_zero(self, i: int) -> bool:
        return self.b.row_is_zero(i, self.n_known_cols if self.n_known_cols else None)

    def get_max_exp_of_b(self) -> int:
        return self.b.get_max_exp()

    # -- canonical coordinate maps (gso.cpp:405-479) -------------------------
    def to_canonical(self, v: List[float], start: int = 0) -> List[float]:
        """Map GSO coordinates to canonical coordinates."""
        with self.ctx.guard():
            x = [self.ctx.scalar(t) for t in v]
            dim = min(len(x), self.d - start)
            for i in range(dim - 1, -1, -1):
                for j in range(i + 1, dim):
                    x[i] = x[i] - self.get_mu(start + j, start + i) * x[j]
            cols = self.b.ncols
            w = []
            for j in range(cols):
                s = self.ctx.scalar(0)
                for i in range(dim):
                    f, e = int_to_f_exp(int(self.b.a[start + i, j]))
                    s = s + self.ctx.ldexp(self.ctx.scalar(f) * x[i], e)
                w.append(self.ctx.to_float(s))
            return w

    def from_canonical(self, w: List[float], start: int = 0,
                       dimension: int = -1) -> List[float]:
        dim = dimension if dimension != -1 else self.d - start
        with self.ctx.guard():
            x = []
            for i in range(start + dim):
                s = self.ctx.scalar(0)
                for j in range(self.b.ncols):
                    f, e = int_to_f_exp(int(self.b.a[i, j]))
                    s = s + self.ctx.ldexp(self.ctx.scalar(f) * self.ctx.scalar(w[j]), e)
                x.append(s)
            for i in range(start + dim):
                for j in range(i):
                    x[i] = x[i] - self.get_mu(i, j) * x[j]
            for i in range(dim):
                x[start + i] = x[start + i] / self.get_r(start + i, start + i)
            return [self.ctx.to_float(x[start + i]) for i in range(dim)]


class MatGSOGram(MatGSOInterface):
    """Gram-matrix-backed GSO engine (reference: gso_gram.h:34).

    Operates on a quadratic form G = B B^T without any basis; only
    GSO_INT_GRAM mode is supported (gso_gram.h:76-81).
    """

    def __init__(self, g: IntMat, u: Optional[IntMat] = None,
                 u_inv_t: Optional[IntMat] = None, flags: int = GSO_INT_GRAM,
                 ctx=None, device=None):
        if not (flags & GSO_INT_GRAM) or (flags & ~GSO_INT_GRAM):
            raise ValueError("MatGSOGram supports exactly GSO_INT_GRAM")
        super().__init__(g.nrows, GSO_INT_GRAM, ctx, u, u_inv_t, device)
        self.gmat = g
        self.g = g.a  # object ndarray, shared storage
        self.n_known_cols = g.ncols

    def discover_row(self) -> None:
        self.n_known_rows += 1
        if not self.cols_locked:
            self.n_source_rows = self.n_known_rows
        self.gso_valid_cols[self.n_known_rows - 1] = 0

    def _native_gram_row(self, i: int, last_j: int):
        return self.g[i, :last_j + 1]          # raw ints, coerced in C

    def get_gram(self, i: int, j: int):
        return self.ctx.from_int(int(self.g[i, j]))

    def get_int_gram(self, i: int, j: int) -> int:
        return int(self.g[i, j])

    def _float_gram_full(self):
        try:
            return self.g[:self.d, :self.d].astype(np.float64)
        except OverflowError:
            return None

    def _row_addmul_exact(self, i: int, j: int, x: int) -> None:
        if self.enable_transform:
            self.u.row_addmul(i, j, x)
            if self.enable_inverse_transform:
                self.u_inv_t.row_addmul(j, i, -x)
        n = self.g.shape[0]
        gii = self.g[i, i] + 2 * x * self.g[i, j] + x * x * self.g[j, j]
        new_row = self.g[i, :n] + self.g[j, :n] * x
        new_row[i] = gii
        self.g[i, :n] = new_row
        self.g[:n, i] = new_row

    def row_swap(self, i: int, j: int) -> None:
        if self.enable_inverse_transform:
            raise RuntimeError("row_swap is incompatible with inverse transform")
        if self.enable_transform:
            self.u.row_swap(i, j)
        self.g[[i, j], :] = self.g[[j, i], :]
        self.g[:, [i, j]] = self.g[:, [j, i]]

    def negate_row(self, i: int) -> None:
        if self.enable_transform:
            self.u.row_negate(i)
        n = self.g.shape[0]
        self.g[i, :n] = -self.g[i, :n]
        self.g[:n, i] = -self.g[:n, i]

    def _rotate_state_right(self, new_r: int, old_r: int) -> None:
        if self.enable_transform:
            self.u.rotate_right(new_r, old_r)
        self._gram_rotate_right(self.g, new_r, old_r)

    def _rotate_state_left(self, old_r: int, new_r: int) -> None:
        if self.enable_transform:
            self.u.rotate_left(old_r, new_r)
        self._gram_rotate_left(self.g, old_r, new_r)
        if new_r >= self.n_known_rows and old_r < self.n_known_rows:
            self.n_known_rows -= 1
            self.n_source_rows = self.n_known_rows

    def b_row_is_zero(self, i: int) -> bool:
        return int(self.g[i, i]) == 0

    def get_max_exp_of_b(self) -> int:
        mx = 0
        n = self.g.shape[0]
        for i in range(self.n_known_rows or n):
            bl = int(self.g[i, i]).bit_length()
            mx = max(mx, (bl + 1) // 2)
        return max(mx, 1)
