"""Gram-Schmidt data of an integer basis, worked out from the basis alone.

Rows are the basis vectors b_0 .. b_{n-1}. With B^T = Q R (Householder
QR in float64), b_i = sum_j R[j, i] q_j, so the squared Gram-Schmidt
norms are r_i = R[i, i]^2 and mu[i][j] = R[j, i] / R[j, j] for j < i.
Entries of the pools stay far below 2^53, so the basis converts to
float64 exactly, and QR is backward stable: on an LLL-reduced basis the
relative error of r and mu is of the order of 1e-13, far below what the
comparisons resolve.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["gso", "window", "gh_radius", "window_radius", "projected_norm"]


def gso(basis) -> tuple:
    """(mu, r) of the rows of `basis`: mu (n, n) strictly lower triangular
    (the diagonal and above are 0), r (n,) the squared norms."""
    b = np.asarray(basis)
    if b.dtype.kind not in "iu" or np.abs(b).max() >= 2 ** 53:
        raise ValueError("gso: an integer basis with entries below 2^53")
    _, rr = np.linalg.qr(b.astype(np.float64).T)
    diag = np.diag(rr).copy()
    if np.any(diag == 0.0):
        raise ValueError("gso: the rows are linearly dependent")
    mu = np.tril((rr / diag[:, None]).T, -1)
    return mu, diag * diag


def window(mu: np.ndarray, r: np.ndarray, first: int, last: int) -> tuple:
    """(mu, r) of the projected block [first, last): the block's vectors
    projected orthogonally to b_0 .. b_{first-1}."""
    return mu[first:last, first:last].copy(), r[first:last].copy()


def gh_radius(r: np.ndarray) -> float:
    """The Gaussian heuristic of a block's shortest squared length:
    Gamma(n/2 + 1)^(2/n) / pi * det^(1/n), det the product of r."""
    n = len(r)
    return math.exp(math.lgamma(n / 2.0 + 1.0) * 2.0 / n) / math.pi * \
        math.exp(float(np.mean(np.log(r))))


def window_radius(r: np.ndarray, delta: float = 0.99,
                  gh_factor: float = 1.1) -> float:
    """BKZ-2.0's squared radius of one window: min(delta * r_first,
    gh_factor * GH), as svp_reduction sets it with BKZ_GH_BND."""
    return min(delta * float(r[0]), gh_factor * gh_radius(r))


def projected_norm(mu: np.ndarray, r: np.ndarray, coords) -> float:
    """Squared length of sum_i coords_i b_i in the block (mu, r): sum over
    i of r_i (x_i + sum_{j > i} mu[j][i] x_j)^2, in float64."""
    x = np.asarray(coords, dtype=np.float64)
    y = x + mu.T @ x
    return float(np.sum(r * y * y))
