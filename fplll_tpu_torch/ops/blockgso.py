"""Blocked / device orthogonalization kernels (the SURVEY §7 centerpiece).

The reference computes GSO state with scalar recurrences — one row of
classical Gram-Schmidt at a time (fplll/
gso_interface.cpp:131-164) and one Householder reflector application at
a time (householder.cpp:151-184). This module re-expresses both as
blocked linear algebra so they run as a handful of BLAS-3/MXU calls:

- full-basis GSO = Cholesky of the Gram matrix: G = L L^T gives
  mu = L diag(L)^-1 and r = L diag(L) (i.e. G = mu D mu^T with
  D = diag(L)^2) — the "panel right-looking" form of the CGS recurrence;
- applying Householder reflectors 0..i-1 to one row = the compact-WY
  identity: with V the reflector panel and M the strictly-lower part of
  V V^T, the reflector dot products t solve (I + M) t = V r0, and the
  transformed row is r0 - t V (one triangular solve + two GEMVs instead
  of i sequential dot+axpy pairs).

The port keeps the host entry points (numpy/LAPACK) only. The JAX
package's jitted device Cholesky for large blocks (its
`ops/blockgso.py:jax_chol_gso`) waits for the device-GSO slice listed in
ROADMAP.md; until then `full_gso` always takes the host route. All
paths are numerically equivalent to the scalar recurrences up to f64
rounding order; the proved soft-float engines keep the sequential order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.linalg import cholesky as _spcholesky
from scipy.linalg import solve_triangular

__all__ = ["chol_gso", "gram_from_basis", "wy_apply_row", "full_gso"]


def gram_from_basis(bf: np.ndarray, ncols: Optional[int] = None) -> np.ndarray:
    """G = B B^T over the float basis rows (one GEMM)."""
    b = bf if ncols is None else bf[:, :ncols]
    return b @ b.T


def chol_gso(G: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Full GSO state from a Gram matrix via Cholesky.

    Returns (mu, r) with mu unit-lower (strictly lower part meaningful)
    and r lower-triangular where r[i][j] = <b_i, b*_j>; r[i][i] =
    ||b*_i||^2. Returns None when G is not numerically positive definite
    (dependent rows / precision exhausted) — callers fall back to the
    lazy scalar recurrence, which reproduces the reference's divergence
    signalling (gso_interface.cpp:156-158).
    """
    d = G.shape[0]
    if d == 0:
        return np.zeros((0, 0)), np.zeros((0, 0))
    try:
        L = _spcholesky(G, lower=True, check_finite=False)
    except Exception:
        return None
    dg = np.diagonal(L).copy()
    if not np.isfinite(L).all() or (dg <= 0).any():
        return None
    mu = L / dg[None, :]
    r = L * dg[None, :]
    return mu, r


def wy_apply_row(V: np.ndarray, sigma: np.ndarray, vvt: np.ndarray,
                 r0: np.ndarray, i: int) -> np.ndarray:
    """Apply Householder reflectors 0..i-1 to row r0 (compact-WY).

    V[j] is reflector j (support on columns j..n-1), sigma[j] the sign
    applied to column j after the reflection (householder.cpp:151-184
    semantics), vvt the cached V V^T. Returns the transformed row with
    prefix columns already sign-fixed.
    """
    if i == 0:
        return r0.copy()
    Vp = V[:i]
    c = Vp @ r0
    t = solve_triangular(vvt[:i, :i], c, lower=True, unit_diagonal=True,
                         check_finite=False)
    r = r0 - t @ Vp
    r[:i] *= sigma[:i]
    return r


def full_gso(G: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Full-basis GSO recompute on the host (the device route of the JAX
    package waits for the device-GSO slice, see ROADMAP.md)."""
    return chol_gso(G)
