"""The port's number layer against the JAX package's (tests/test_nr.py).

`fplll_tpu_torch/nr/` is a copy of `fplll_tpu/nr/`: the exact integer
helpers, the float contexts behind FT_DOUBLE, DPE, DD, QD and MPFR (the
compiled dpe/dd/qd tiers where the precision fits, mpmath beyond) and the
minimum-precision formulas. Both packages get the same values, made from
one seed; every result must be equal bit for bit.
"""

import math
import random

import mpmath
import numpy as np
import pytest

from fplll_tpu.nr import fctx as jax_fctx
from fplll_tpu_torch.defs import FT_DD, FT_DOUBLE, FT_DPE, FT_MPFR, FT_QD
from fplll_tpu_torch.nr import fctx

PACKAGES = (jax_fctx, fctx)


def bits(x):
    """An exact, comparable picture of a scalar of any context: the
    components and offset of a compiled dpe/dd/qd value, the (sign,
    mantissa, exponent, bits) of an mpmath value, the hex of a float."""
    if hasattr(x, "parts"):
        comps, off = x.parts()
        return tuple(float(c).hex() for c in comps), off
    if isinstance(x, mpmath.mpf):
        return x._mpf_
    return float(x).hex()


def ints(seed, n=200):
    """Signed ints of 1 to 3000 bits, and the edge cases."""
    rng = random.Random(seed)
    out = [0, 1, -1, 7, -12345, 2 ** 52 + 1, 2 ** 53 + 1, -(2 ** 54 + 3),
           (1 << 3000) + (1 << 2950)]
    for _ in range(n):
        v = rng.getrandbits(rng.randint(1, 3000))
        out.append(-v if rng.random() < 0.5 else v)
    return out


def test_int_to_f_exp_matches_jax():
    for x in ints(1):
        f, e = fctx.int_to_f_exp(x)
        fj, ej = jax_fctx.int_to_f_exp(x)
        assert (f.hex(), e) == (fj.hex(), ej), x
        if x.bit_length() <= 53:
            assert math.ldexp(f, e) == float(x)


def test_round_mul_2exp_matches_jax():
    rng = random.Random(2)
    cases = [(1.25, 2), (-1.25, 2), (0.5, 0), (1.5, 0), (2.5, 0),
             (0.75, 1000), (1.0, -5), (0.0, 10)]
    cases += [(rng.uniform(-1e6, 1e6), rng.randint(-60, 400))
              for _ in range(300)]
    for m, e in cases:
        got = fctx.round_mul_2exp(m, e)
        assert got == jax_fctx.round_mul_2exp(m, e), (m, e)
    assert fctx.round_mul_2exp(2.5, 0) == 2       # ties to even


def test_comps_to_int_mul_2exp_matches_jax():
    rng = random.Random(3)
    cases = [((1.5,), 1), ((0.75,), 1), ((-0.75,), 1),
             ((float(2 ** 60), 3.0), 0), ((1.0,), 200)]
    for _ in range(200):
        hi = rng.uniform(-1e15, 1e15)
        cases.append(((hi, rng.uniform(-1, 1) * abs(hi) * 2.0 ** -53),
                      rng.randint(-40, 300)))
    for comps, e in cases:
        assert fctx.comps_to_int_mul_2exp(comps, e) == \
            jax_fctx.comps_to_int_mul_2exp(comps, e), (comps, e)


@pytest.mark.parametrize("ft,prec", [(FT_DOUBLE, 53), (FT_DPE, 53),
                                     (FT_DD, 106), (FT_QD, 212),
                                     (FT_MPFR, 150)],
                         ids=["double", "dpe", "dd", "qd", "mpfr150"])
def test_ctx_roundtrip_matches_jax(ft, prec):
    """get_ctx of each float type in both packages: the same kind of
    context at the same precision, and every operation of the protocol
    bit for bit on the same values."""
    cj, ct = jax_fctx.get_ctx(int(ft), prec), fctx.get_ctx(ft, prec)
    assert type(ct).__name__ == type(cj).__name__
    assert ct.prec == cj.prec >= prec
    rng = random.Random(4)
    for v in [12345, -7, 2 ** 200 + 17] + [rng.getrandbits(90)
                                           for _ in range(20)]:
        xj, xt = cj.from_int(v), ct.from_int(v)
        assert bits(xt) == bits(xj)
        assert ct.to_float(xt) == cj.to_float(xj)
        assert bits(ct.ldexp(xt, 10)) == bits(cj.ldexp(xj, 10))
        assert ct.is_finite(xt) and cj.is_finite(xj)
    for f in [2.6, -2.6, 0.5, 1.5, -2.5] + [rng.uniform(-1e9, 1e9)
                                            for _ in range(50)]:
        assert ct.rnd_int(ct.scalar(f)) == cj.rnd_int(cj.scalar(f)), f
        a, b = ct.scalar(f), ct.scalar(f / 3.0 + 1.0)
        c, d = cj.scalar(f), cj.scalar(f / 3.0 + 1.0)
        for op in (lambda x, y: x + y, lambda x, y: x - y,
                   lambda x, y: x * y, lambda x, y: x / y):
            assert bits(op(a, b)) == bits(op(c, d)), f


def test_mp_ctx_precision_matches_jax():
    big = (1 << 149) + 1
    for prec in (53, 150):
        xt = fctx.MPCtx(prec).from_int(big)
        xj = jax_fctx.MPCtx(prec).from_int(big)
        with mpmath.workprec(200):
            assert int(xt) == int(xj)
            assert (int(xt) == big) == (prec == 150)


def test_min_prec_formulas_match_jax():
    for d in (10, 55, 120, 400):
        for delta, eta in ((0.99, 0.51), (0.75, 0.6)):
            for eps in (0.01, 0.001):
                assert fctx.gso_min_prec(d, delta, eta, eps) == \
                    jax_fctx.gso_min_prec(d, delta, eta, eps)
                assert fctx.l2_min_prec(d, delta, eta, eps) == \
                    jax_fctx.l2_min_prec(d, delta, eta, eps)
    for args in ((20, 21, 0.99, 0.51, 0.001, 0.1),
                 (60, 60, 0.99, 0.52, 0.001, 0.2)):
        assert fctx.hlll_min_prec(*args) == jax_fctx.hlll_min_prec(*args)
    assert fctx.hlll_min_prec(20, 21, 0.99, 0.51, 0.001, 0.1) > 53


def test_dot_matches_jax():
    """ctx.dot in the multiprecision and f64 contexts on seeded vectors."""
    rng = np.random.default_rng(5)
    u, v = rng.integers(-1000, 1000, 12), rng.integers(-1000, 1000, 12)
    for prec in (60, 200):
        out = []
        for mod in PACKAGES:
            ctx = mod.MPCtx(prec)
            a = np.array([ctx.from_int(int(i)) for i in u], dtype=object)
            b = np.array([ctx.from_int(int(i)) for i in v], dtype=object)
            out.append(bits(ctx.dot(a, b)))
        assert out[0] == out[1]
    fu, fv = rng.standard_normal(40), rng.standard_normal(40)
    assert bits(fctx.F64Ctx().dot(fu, fv)) == \
        bits(jax_fctx.F64Ctx().dot(fu, fv))


def test_float_ctx_from_name_matches_jax():
    for name in ("double", "dpe", "dd", "qd", "mpfr", "long double"):
        prec = 120 if name == "mpfr" else 0
        try:
            cj = jax_fctx.float_ctx_from_name(name, prec)
        except Exception as e:      # both packages refuse alike
            with pytest.raises(type(e)):
                fctx.float_ctx_from_name(name, prec)
            continue
        ct = fctx.float_ctx_from_name(name, prec)
        assert type(ct).__name__ == type(cj).__name__
        assert ct.prec == cj.prec
