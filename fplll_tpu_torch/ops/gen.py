"""Lattice instance generators (the 8 families of the reference).

Re-implementation of ZZ_mat<ZT>::gen_* from
fplll/nr/matrix.cpp:229-480 and the *_bits helpers of
matrix.h:280-347, over exact Python integers. Randomness comes from
``RandGen`` (deterministic under a seed, not GMP-bit-compatible).
"""

from __future__ import annotations

import math
from typing import Sequence

import sympy

from ..nr.rng import RandGen
from .intmat import IntMat

__all__ = [
    "gen_intrel", "gen_simdioph", "gen_uniform", "gen_ntrulike",
    "gen_ntrulike_bits", "gen_ntrulike2", "gen_ntrulike2_bits", "gen_qary",
    "gen_qary_bits", "gen_qary_prime", "gen_trg", "gen_trg2", "gen_q",
]


def gen_intrel(d: int, bits: int) -> IntMat:
    """Knapsack-style: [x_i | I_d], x_i uniform < 2^bits (matrix.cpp:229)."""
    m = IntMat.zeros(d, d + 1)
    for i in range(d):
        m.a[i, 0] = RandGen.randb(bits)
        m.a[i, i + 1] = 1
    return m


def gen_simdioph(d: int, bits: int, bits2: int) -> IntMat:
    """Simultaneous diophantine approximation basis (matrix.cpp:252).

    Note d here is the CLI's <d>+1 total dimension, as in latticegen.
    """
    m = IntMat.zeros(d, d)
    m.a[0, 0] = 1 << bits2
    for i in range(1, d):
        m.a[0, i] = RandGen.randb(bits)
        m.a[i, i] = 1 << bits
    return m


def gen_uniform(d: int, bits: int) -> IntMat:
    m = IntMat.zeros(d, d)
    for i in range(d):
        for j in range(d):
            m.a[i, j] = RandGen.randb(bits)
    return m


def _gen_h(d: int, q: int) -> list:
    """Vector h with h(1) = 0 mod q (matrix.cpp:295-310)."""
    h = [0] * d
    for i in range(1, d):
        h[i] = RandGen.randm(q)
        h[0] -= h[i]
        if h[0] < 0:
            h[0] += q
    return h


def gen_ntrulike(d: int, q: int) -> IntMat:
    """[[I, H], [0, qI]] with circulant H (matrix.cpp:288-352). 2d x 2d."""
    h = _gen_h(d, q)
    m = IntMat.zeros(2 * d, 2 * d)
    for i in range(d):
        m.a[i, i] = 1
        m.a[d + i, d + i] = q
        for j in range(d, 2 * d):
            k = (j - d - i) % d
            m.a[i, j] = h[k]
    return m


def gen_ntrulike2(d: int, q: int) -> IntMat:
    """[[qI, 0], [H, I]] variant (matrix.cpp:354-404)."""
    h = _gen_h(d, q)
    m = IntMat.zeros(2 * d, 2 * d)
    for i in range(d):
        m.a[i, i] = q
        m.a[d + i, d + i] = 1
        for j in range(d):
            k = (i) - j  # row d+i, col j: k = (i+d) - d - j
            m.a[d + i, j] = h[k % d]
    return m


def gen_q(bits: int) -> int:
    """Random q in [2^(bits-1), 2^bits) (matrix.h gen_q)."""
    return RandGen.randb(bits - 1) + (1 << (bits - 1))


def gen_ntrulike_bits(d: int, bits: int) -> IntMat:
    return gen_ntrulike(d, gen_q(bits))


def gen_ntrulike2_bits(d: int, bits: int) -> IntMat:
    return gen_ntrulike2(d, gen_q(bits))


def gen_qary(d: int, k: int, q: int) -> IntMat:
    """q-ary lattice [[I, H], [0, qI]] with random H, qI block size k
    (matrix.cpp:406-432)."""
    m = IntMat.zeros(d, d)
    for i in range(d - k):
        m.a[i, i] = 1
        for j in range(d - k, d):
            m.a[i, j] = RandGen.randm(q)
    for i in range(d - k, d):
        m.a[i, i] = q
    return m


def gen_qary_bits(d: int, k: int, bits: int) -> IntMat:
    return gen_qary(d, k, gen_q(bits))


def gen_qary_prime(d: int, k: int, bits: int) -> IntMat:
    return gen_qary(d, k, int(sympy.nextprime(gen_q(bits))))


def gen_trg(d: int, alpha: float) -> IntMat:
    """Lower-triangular with decaying diagonal 2^((2d-i)^alpha)
    (matrix.cpp:434-466)."""
    m = IntMat.zeros(d, d)
    for i in range(d):
        bits = int(math.pow(float(2 * d - i), alpha))
        diag_bound = (1 << bits) - 1
        m.a[i, i] = RandGen.randm(diag_bound) + 2
        half = int(m.a[i, i]) >> 1
        for j in range(i + 1, d):
            v = RandGen.randm(half) if half > 0 else 0
            if RandGen.randb(1) == 1:
                v = -v
            m.a[j, i] = v
    return m


def gen_trg2(w: Sequence[float]) -> IntMat:
    """Lower-triangular with prescribed diagonal w (matrix.cpp:468-498)."""
    d = len(w)
    m = IntMat.zeros(d, d)
    for i in range(d):
        m.a[i, i] = int(round(w[i]))
        half = (int(m.a[i, i]) >> 1) + 1
        for j in range(i + 1, d):
            v = RandGen.randm(half) if half > 0 else 0
            if RandGen.randb(1) == 1:
                v = -v
            m.a[j, i] = v
    return m
