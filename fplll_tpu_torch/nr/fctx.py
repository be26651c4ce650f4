"""Float backends ("dtype policies") for the host-side orchestration path.

The reference implements six float types behind ``FP_NR<F>``
(fplll/nr/nr_FP.inl:21 and nr_FP_*.inl). The TPU build
maps them onto two host representations plus device kernels:

- ``F64Ctx``    — hardware float64 (numpy scalars / arrays). Covers
                  FT_DOUBLE and, paired with per-row exponents
                  (GSO_ROW_EXPO), the role dpe plays for magnitude range.
- ``MPCtx(p)``  — p-bit-mantissa, unbounded-exponent soft float
                  (mpmath). Covers FT_DPE (p=53), FT_LONG_DOUBLE (p=64),
                  FT_DD (p=106), FT_QD (p=212) and FT_MPFR (p=user).

The port runs no double-double device kernels (CUDA has native f64; see
ROADMAP.md for the certified-tree slice).

Both contexts expose the same small protocol used by the GSO /
Householder engines; arrays are numpy ndarrays (float64 or object-mpf)
so vectorized expressions are shared between backends.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import mpmath
import numpy as np

from ..defs import (FT_DD, FT_DEFAULT, FT_DOUBLE, FT_DPE, FT_LONG_DOUBLE,
                    FT_MPFR, FT_QD, FloatType, PREC_DD, PREC_DOUBLE, PREC_QD)

__all__ = ["F64Ctx", "MPCtx", "CompiledCtx", "get_ctx",
           "float_ctx_from_name", "gso_min_prec", "l2_min_prec",
           "hlll_min_prec", "round_mul_2exp", "int_to_f_exp",
           "comps_to_int_mul_2exp"]


# ---------------------------------------------------------------------------
# Exact helpers shared by all backends
# ---------------------------------------------------------------------------
def int_to_f_exp(x: int) -> Tuple[float, int]:
    """Exact (mantissa, exponent) of an arbitrary-size int: x = f * 2^e,
    with f a float64 holding the top <=53 bits (reference: Z_NR::get_f_exp,
    nr_Z.inl:80)."""
    if x == 0:
        return 0.0, 0
    neg = x < 0
    ax = -x if neg else x
    bl = ax.bit_length()
    if bl <= 53:
        f, e = math.frexp(float(ax))
    else:
        sh = bl - 54
        top = (ax >> sh) + ((ax >> (sh - 1)) & 1 if sh >= 1 else 0)  # round
        f, e2 = math.frexp(float(top))
        e = e2 + sh
    return (-f if neg else f), e


def comps_to_int_mul_2exp(comps, expo: int) -> int:
    """Exact nearest-int (ties to even) of (sum of float comps) * 2^expo.

    Used to extract the exact integer multiplier from a compiled dpe/dd/qd
    scalar (its .parts() decomposition) the way _mpf_to_int_mul_2exp does
    for mpmath values (reference: FP_NR::rnd_we + row_addmul_we,
    gso.cpp:236-262)."""
    terms = []
    min_sh = None
    for f in comps:
        if f == 0.0 or not math.isfinite(f):
            continue
        m, fe = math.frexp(f)
        mant = int(m * (1 << 53))
        sh = fe - 53 + expo
        terms.append((mant, sh))
        min_sh = sh if min_sh is None else min(min_sh, sh)
    if not terms:
        return 0
    acc = 0
    for mant, sh in terms:
        acc += mant << (sh - min_sh)
    if min_sh >= 0:
        return acc << min_sh
    sh = -min_sh
    neg = acc < 0
    a = -acc if neg else acc
    if sh > a.bit_length() + 1:
        return 0
    q, r = divmod(a, 1 << sh)
    half = 1 << (sh - 1)
    if r > half or (r == half and (q & 1)):
        q += 1
    return -q if neg else q


def round_mul_2exp(m: float, expo: int) -> int:
    """Exact nearest-int (ties-to-even) of m * 2^expo for float64 m.

    Used to turn a stored scaled mu into the exact integer multiplier
    applied to the basis (reference: FP_NR::rnd_we + row_addmul_we,
    gso.cpp:236-262), without overflowing when expo is huge.
    """
    if m == 0.0 or not math.isfinite(m):
        return 0
    fm, fe = math.frexp(m)           # m = fm * 2^fe, 0.5 <= |fm| < 1
    mant = int(fm * (1 << 53))       # exact: 53-bit integer
    e = fe - 53 + expo               # value = mant * 2^e
    if e >= 0:
        return mant << e
    # round mant / 2^-e  to nearest, ties to even
    sh = -e
    if sh > mant.bit_length() + 1:
        return 0
    q, r = divmod(abs(mant), 1 << sh)
    half = 1 << (sh - 1)
    if r > half or (r == half and (q & 1)):
        q += 1
    return -q if mant < 0 else q


# ---------------------------------------------------------------------------
# float64 backend
# ---------------------------------------------------------------------------
class F64Ctx:
    """Hardware double backend (FT_DOUBLE)."""

    name = "double"
    prec = PREC_DOUBLE
    dtype = np.float64
    float_type = FT_DOUBLE

    def guard(self):
        import contextlib
        return contextlib.nullcontext()

    def zeros(self, shape):
        return np.zeros(shape, dtype=np.float64)

    def scalar(self, x) -> float:
        return float(x)

    def from_int(self, x: int) -> float:
        f, e = int_to_f_exp(int(x))
        return math.ldexp(f, e) if -1074 < e < 1024 else (math.inf if x > 0 else -math.inf)

    def to_float(self, x) -> float:
        return float(x)

    def dot(self, u, v):
        return float(np.dot(u, v))

    def is_finite(self, x) -> bool:
        return math.isfinite(x)

    def exponent(self, x) -> int:
        """frexp exponent: 2^(e-1) <= |x| < 2^e (FP_NR::exponent)."""
        if x == 0 or not math.isfinite(x):
            return 0
        return math.frexp(x)[1]

    def rnd(self, x) -> float:
        """Round to nearest integer, ties to even (rint semantics)."""
        return float(np.rint(x))

    def rnd_int(self, x) -> int:
        return round_mul_2exp(float(x), 0)

    def ldexp(self, x, e: int):
        try:
            return math.ldexp(float(x), int(e))
        except OverflowError:
            return math.inf if x > 0 else -math.inf

    def ldexp_arr(self, a, e: int):
        with np.errstate(over="ignore", under="ignore"):
            return np.ldexp(a, e)

    def sqrt(self, x):
        return math.sqrt(x) if x >= 0 else math.nan

    def log(self, x):
        return math.log(x) if x > 0 else (-math.inf if x == 0 else math.nan)

    def pow(self, x, y):
        return math.pow(x, y)


# ---------------------------------------------------------------------------
# mpmath soft-float backend
# ---------------------------------------------------------------------------
class MPCtx:
    """p-bit-mantissa unbounded-exponent backend (FT_DPE/DD/QD/MPFR roles)."""

    def __init__(self, prec: int, float_type: FloatType = FT_MPFR):
        self.prec = int(prec)
        self.float_type = float_type
        self.name = {FT_DPE: "dpe", FT_DD: "dd", FT_QD: "qd",
                     FT_LONG_DOUBLE: "long double"}.get(float_type, "mpfr")
        self.dtype = object

    def guard(self):
        return mpmath.workprec(self.prec)

    def zeros(self, shape):
        a = np.empty(shape, dtype=object)
        a[...] = mpmath.mpf(0)
        return a

    def scalar(self, x):
        with self.guard():
            return mpmath.mpf(x)

    def from_int(self, x: int):
        with self.guard():
            return mpmath.mpf(int(x))

    def to_float(self, x) -> float:
        return float(x)

    def dot(self, u, v):
        with self.guard():
            # sequential summation: deterministic, order-stable
            s = mpmath.mpf(0)
            for a, b in zip(u, v):
                s += a * b
            return s

    def is_finite(self, x) -> bool:
        return mpmath.isfinite(x)

    def exponent(self, x) -> int:
        if x == 0 or not mpmath.isfinite(x):
            return 0
        return int(mpmath.mag(x))

    def rnd(self, x):
        with self.guard():
            return mpmath.nint(x)

    def rnd_int(self, x) -> int:
        return int(mpmath.nint(x))

    def ldexp(self, x, e: int):
        with self.guard():
            return mpmath.ldexp(x, int(e))

    def ldexp_arr(self, a, e: int):
        with self.guard():
            out = np.empty_like(a)
            flat_in, flat_out = a.ravel(), out.ravel()
            for i in range(flat_in.size):
                flat_out[i] = mpmath.ldexp(flat_in[i], int(e))
            return out

    def sqrt(self, x):
        with self.guard():
            return mpmath.sqrt(x)

    def log(self, x):
        with self.guard():
            return mpmath.log(x)

    def pow(self, x, y):
        with self.guard():
            return mpmath.power(x, y)


_F64 = F64Ctx()


# ---------------------------------------------------------------------------
# Compiled scalar backend (native dpe / dd / qd, fplll_tpu_torch/native/fpnum.c)
# ---------------------------------------------------------------------------
class CompiledCtx:
    """Context over the compiled dpe/dd/qd/dde/qde scalar types.

    Same protocol as MPCtx, but every scalar operation runs in native code
    (error-free-transform double-double / quad-double, double+exponent
    dpe, and the dd/qd-mantissa + unbounded-exponent dde/qde pair that
    serves the mpfr role at 106/212 bits) instead of interpreted mpmath —
    the compiled high-precision tiers playing the role of libqd/dpe/mpfr
    in the reference (fplll/nr/nr_FP_dd.inl,
    nr_FP_qd.inl, nr/dpe.h, nr/nr_FP_mpfr.inl)."""

    dtype = object

    _PRECS = {"dpe": PREC_DOUBLE, "dd": PREC_DD, "qd": PREC_QD,
              "dde": PREC_DD, "qde": PREC_QD}
    _FTS = {"dpe": FT_DPE, "dd": FT_DD, "qd": FT_QD,
            "dde": FT_MPFR, "qde": FT_MPFR}
    _KIND_IDS = {"dpe": 0, "dd": 1, "qd": 2, "dde": 3, "qde": 4}

    def __init__(self, kind: str, mod):
        self._m = mod
        self.kind = kind
        self._mk = getattr(mod, kind)
        self.prec = self._PRECS[kind]
        self.float_type = self._FTS[kind]
        self.name = kind
        self.kind_id = self._KIND_IDS[kind]
        # numpy-object-array engine kernels (GSO row recurrence, Babai
        # pass, ...) — present in fresh builds of fpnum.c
        self.native_engine = mod if hasattr(mod, "gso_row_update") else None
        self._zero = self._mk(0.0)
        self._fpnum_t = type(self._zero)

    def guard(self):
        import contextlib
        return contextlib.nullcontext()

    def zeros(self, shape):
        a = np.empty(shape, dtype=object)
        a[...] = self._zero
        return a

    def scalar(self, x):
        if type(x) is self._fpnum_t:
            return x
        if isinstance(x, (np.floating, np.integer)):
            x = float(x)
        return self._mk(x)

    def from_int(self, x: int):
        if self.kind == "dpe":
            f, e = int_to_f_exp(int(x))
            return self._m.dpe_me(f, e)
        return self._mk(int(x))   # exact in C for dd/qd; top bits for dde/qde

    def to_float(self, x) -> float:
        return float(x)

    def dot(self, u, v):
        if len(u) == 0:
            return self._zero
        return self._m.dot(u, v)

    def is_finite(self, x) -> bool:
        if type(x) is self._fpnum_t:
            return bool(x.is_finite())
        return math.isfinite(float(x))

    def exponent(self, x) -> int:
        if type(x) is not self._fpnum_t:
            x = self.scalar(x)
        return int(x.exponent())

    def rnd(self, x):
        return self.scalar(x).nint()

    def rnd_int(self, x) -> int:
        comps, off = self.scalar(x).nint().parts()
        return comps_to_int_mul_2exp(comps, off)

    def ldexp(self, x, e: int):
        return self.scalar(x).ldexp(int(e))

    def ldexp_arr(self, a, e: int):
        if self.native_engine is not None:
            flat = np.ascontiguousarray(a.ravel())
            return self.native_engine.ldexp_arr(flat, int(e)).reshape(a.shape)
        out = np.empty_like(a)
        flat_in, flat_out = a.ravel(), out.ravel()
        for i in range(flat_in.size):
            flat_out[i] = flat_in[i].ldexp(int(e))
        return out

    def sqrt(self, x):
        return self.scalar(x).sqrt()

    def log(self, x):
        comps, off = self.scalar(x).parts()
        h = comps[0]
        if h == 0.0:
            return self._mk(-math.inf)
        if h < 0.0 or not math.isfinite(h):
            return self._mk(math.nan if h < 0 else h)
        m, e = math.frexp(h)
        corr = math.fsum(comps[1:]) / h if len(comps) > 1 else 0.0
        return self._mk(math.log(m) + (e + off) * math.log(2.0) +
                        math.log1p(corr))

    def pow(self, x, y):
        return self._mk(math.pow(float(x), float(y)))


_COMPILED_CACHE: dict = {}


def compiled_ctx(kind: str):
    """CompiledCtx for 'dpe'/'dd'/'qd', or None if the native build failed."""
    if kind not in _COMPILED_CACHE:
        from ..native import get_fpnum
        mod = get_fpnum()
        _COMPILED_CACHE[kind] = CompiledCtx(kind, mod) if mod else None
    return _COMPILED_CACHE[kind]


def get_ctx(float_type: FloatType | int, prec: int = 0):
    """Resolve a FloatType (+ precision for FT_MPFR) to a context.

    Mirrors the switch-ladders of wrapper.cpp:682-731. dpe/dd/qd resolve
    to the compiled native scalars when available, with the mpmath
    soft-float as fallback.
    """
    ft = FloatType(float_type)
    if ft in (FT_DOUBLE, FT_DEFAULT):
        return _F64
    if ft == FT_LONG_DOUBLE:
        return MPCtx(64, FT_LONG_DOUBLE)
    if ft == FT_DPE:
        return compiled_ctx("dpe") or MPCtx(PREC_DOUBLE, FT_DPE)
    if ft == FT_DD:
        return compiled_ctx("dd") or MPCtx(PREC_DD, FT_DD)
    if ft == FT_QD:
        return compiled_ctx("qd") or MPCtx(PREC_QD, FT_QD)
    if ft == FT_MPFR:
        p = prec if prec > 0 else PREC_DOUBLE
        # Serve the mpfr role with the compiled exponent-carrying EFT
        # scalars whenever the requested precision fits: dde/qde give
        # >= the requested mantissa bits AND the unbounded exponent range
        # mpfr has (huge-entry int-Gram values overflow plain dd/qd).
        # The soft float stays as the arbitrary-precision tail, the same
        # split the reference's wrapper makes between libqd tiers and
        # mpfr (fplll/wrapper.cpp:203-232).
        import os
        if os.environ.get("FPLLL_TPU_COMPILED_MPFR", "1") == "1":
            if p <= PREC_DD - 2:
                c = compiled_ctx("dde")
                if c is not None:
                    return c
            if p <= PREC_QD - 12:
                c = compiled_ctx("qde")
                if c is not None:
                    return c
        return MPCtx(p, FT_MPFR)
    raise ValueError(f"unsupported float type {float_type}")


_NAME2FT = {"": FT_DEFAULT, "default": FT_DEFAULT, "double": FT_DOUBLE,
            "long double": FT_LONG_DOUBLE, "ld": FT_LONG_DOUBLE,
            "dpe": FT_DPE, "dd": FT_DD, "qd": FT_QD, "mpfr": FT_MPFR}


def float_ctx_from_name(name: str, prec: int = 0):
    return get_ctx(_NAME2FT[name], prec)


# ---------------------------------------------------------------------------
# Precision bounds (reference: util.cpp:44-207)
# ---------------------------------------------------------------------------
def _compute_min_prec(d: int, delta: float, eta: float, epsilon: float,
                      l2: bool) -> Tuple[int, float]:
    with mpmath.workprec(53):
        f_eps = mpmath.mpf(epsilon)
        if l2:
            f_eps = min(f_eps, mpmath.mpf(eta) - mpmath.mpf("0.5"),
                        1 - mpmath.mpf(delta))
        num = (1 + mpmath.mpf(eta)) ** 2 + f_eps
        den = mpmath.mpf(delta) - mpmath.mpf(eta) ** 2
        if den <= 0:
            raise ValueError("invalid LLL parameters, eta must be < sqrt(delta)")
        rho = num / den
        val = (2 * mpmath.log(d) - mpmath.log(f_eps) + d * mpmath.log(rho)) \
            / mpmath.log(2)
        val += 10.0 if l2 else 5.0
        return int(mpmath.ceil(val)), float(rho)


def gso_min_prec(d: int, delta: float, eta: float, epsilon: float) -> Tuple[int, float]:
    """Minimum precision for a correct GSO at given params; returns
    (prec, rho) (util.cpp:99-102)."""
    return _compute_min_prec(d, delta, eta, epsilon, l2=False)


def l2_min_prec(d: int, delta: float, eta: float, epsilon: float) -> int:
    """Minimum proved precision for the L2 algorithm (util.cpp:104-108)."""
    return _compute_min_prec(d, delta, eta, epsilon, l2=True)[0]


def hlll_min_prec(d_i: int, n_i: int, delta: float, eta: float, theta: float,
                  c: float) -> int:
    """Proved precision bound for HLLL (util.cpp:110-207)."""
    if not (0.25 <= delta < 1.0):
        raise ValueError("delta must be in [1/4, 1)")
    if theta < 0 or eta < 0.5 or eta - theta <= 0.5:
        raise ValueError("need theta >= 0, eta >= 0.5, eta - theta > 0.5")
    with mpmath.workprec(53):
        d, n = mpmath.mpf(d_i), mpmath.mpf(n_i)
        delta_, eta_, theta_, c_ = (mpmath.mpf(x) for x in (delta, eta, theta, c))
        root = mpmath.sqrt((1 + theta_ ** 2) * delta_ - eta_ ** 2)
        alpha = (theta_ * eta_ + root) / (delta_ - eta_ ** 2)
        t0 = (1 + abs(1 - eta_ - theta_) * alpha) / \
             ((eta_ + theta_) * (-1 + mpmath.sqrt(mpmath.mpf(3) / 2)))
        t1 = 4 * mpmath.sqrt(6) / (1 + eta_) * mpmath.sqrt(1 + d * eta_ ** 2)
        c0 = max(t0, t1) * n * mpmath.sqrt(d)
        c1 = 8 * d * (n + 9) * c0
        rho = (1 + eta_ + theta_) * alpha
        phi = c1 * (1 + 1 / theta_) * rho ** (d_i + 1)
        p0 = mpmath.log(d ** 3 * phi * alpha ** d_i / theta_) / mpmath.log(2) \
            + 16 + c_ * d / 2
        p = p0 + 1 - mpmath.log(1 - delta_) / mpmath.log(2) \
            - mpmath.log(eta_ - theta_ - mpmath.mpf("0.5")) / mpmath.log(2)
        return int(mpmath.ceil(p))
