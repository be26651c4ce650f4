"""The port's compiled precision ladder against the JAX package's
(tests/test_fpnum.py).

`fplll_tpu_torch/native/fpnum.c` is a copy of `fplll_tpu/native/fpnum.c`:
the dpe, double-double and quad-double scalars behind FT_DPE, FT_DD and
FT_QD (and FT_MPFR where the precision fits). Each package builds its own
module from its own source; on the same operands, made from one seed,
every result must be equal bit for bit: the components and the offset of
`parts()`.
"""

import random
import time

import numpy as np
import pytest

from fplll_tpu.defs import FT_DD, FT_DPE
from fplll_tpu.nr import fctx as jax_fctx
from fplll_tpu_torch.native import get_fpnum
from fplll_tpu_torch.nr import fctx

KINDS = ("dpe", "dd", "qd")


def jax_fpnum(tries: int = 120, pause: float = 0.5):
    """The JAX package's module, looking again while another test process
    is still writing its shared object (its loader gives None then)."""
    import fplll_tpu.native as jn

    for _ in range(tries):
        mod = jn.get_fpnum()
        if mod is not None:
            return mod
        jn._FPNUM_TRIED = False
        time.sleep(pause)
    raise RuntimeError("fplll_tpu's fpnum never loaded")


@pytest.fixture(scope="module")
def fps():
    return jax_fpnum(), get_fpnum()


def bits(x):
    comps, off = x.parts()
    return tuple(float(c).hex() for c in comps), off


def test_port_builds_its_own_module(fps):
    fj, ft = fps
    assert ft is not None and ft is not fj
    assert ft.__file__ != fj.__file__


@pytest.mark.parametrize("kind", KINDS)
def test_arith_matches_jax(fps, kind):
    """add, sub, mul, div and sqrt of 200 seeded operand pairs."""
    mj, mt = (getattr(f, kind) for f in fps)
    rng = random.Random(1234)
    for _ in range(200):
        a = rng.uniform(-1e5, 1e5)
        b = rng.uniform(-1e5, 1e5) or 1.0
        xj, yj, xt, yt = mj(a), mj(b), mt(a), mt(b)
        for op in (lambda x, y: x + y, lambda x, y: x - y,
                   lambda x, y: x * y, lambda x, y: x / y,
                   lambda x, y: abs(x).sqrt()):
            assert bits(op(xt, yt)) == bits(op(xj, yj)), (kind, a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_cancellation_matches_jax(fps, kind):
    """(a + tiny) - a recovers tiny in both packages."""
    mj, mt = (getattr(f, kind) for f in fps)
    for tiny in (2.0 ** -50, 2.0 ** -80, 3.0 * 2.0 ** -100):
        gj = (mj(1.0) + mj(tiny)) - mj(1.0)
        gt = (mt(1.0) + mt(tiny)) - mt(1.0)
        assert bits(gt) == bits(gj)
    assert float((mt(1.0) + mt(2.0 ** -50)) - mt(1.0)) == 2.0 ** -50


def test_bigint_roundtrips_match_jax(fps):
    fj, ft = fps
    rng = random.Random(7)
    xs = [2 ** 100 + 12345, (2 ** 200 + 3) * 7 + (1 << 140) + 99]
    xs += [rng.getrandbits(rng.randint(60, 220)) for _ in range(50)]
    for x in xs:
        for kind in ("dd", "qd"):
            vt, vj = getattr(ft, kind)(x), getattr(fj, kind)(x)
            assert bits(vt) == bits(vj), (kind, x)
    v = ft.qd(xs[1])
    assert sum(int(c) for c in v.parts()[0]) == xs[1]


def test_dpe_unbounded_exponent_matches_jax(fps):
    fj, ft = fps
    vt, vj = ft.dpe(1.5).ldexp(100000), fj.dpe(1.5).ldexp(100000)
    assert bits(vt) == bits(vj)
    assert vt.exponent() == vj.exponent() == 100001
    assert (vt * vt).exponent() == (vj * vj).exponent() == 200002
    assert float(vt / vt) == float(vj / vj) == 1.0


def test_nint_ties_match_jax(fps):
    fj, ft = fps
    for kind in KINDS:
        for x in (2.5, 3.5, -2.5, 1.25, -0.5, 7.3):
            assert bits(getattr(ft, kind)(x).nint()) == \
                bits(getattr(fj, kind)(x).nint()), (kind, x)
    for lo in (1e-20, -1e-20):
        assert bits(ft.dd_pair(2.5, lo).nint()) == \
            bits(fj.dd_pair(2.5, lo).nint())
    assert float(ft.dd_pair(2.5, 1e-20).nint()) == 3.0


def test_division_by_zero_matches_jax(fps):
    fj, ft = fps
    for kind in KINDS:
        vt = getattr(ft, kind)(1.0) / getattr(ft, kind)(0.0)
        vj = getattr(fj, kind)(1.0) / getattr(fj, kind)(0.0)
        assert not vt.is_finite() and not vj.is_finite()
        assert bits(vt) == bits(vj)


def ctx_protocol(ctx):
    """zeros, from_int, exponent, dot, rnd_int and the numpy object-array
    broadcast of one context, as bits."""
    z = ctx.zeros((3, 3))
    z[0, 0] = ctx.scalar(2.0)
    v = ctx.from_int(2 ** 200 + 17)
    d = ctx.dot(ctx.zeros(4) + ctx.scalar(2.0),
                ctx.zeros(4) + ctx.scalar(3.0))
    a = ctx.zeros(5)
    a[...] = ctx.scalar(3.0)
    s = ctx.scalar(2.0)
    return (bits(z[0, 0] * z[0, 0]), bits(v), ctx.exponent(v), bits(d),
            ctx.rnd_int(ctx.scalar(7.3)), [bits(x) for x in a * s],
            [bits(x) for x in a - s * a])


def compiled_ctxs(fps, kind):
    """The JAX package's compiled context of `kind`, built from the
    module the `fps` fixture loaded (with its retry), and the port's
    compiled_ctx. Not the JAX package's compiled_ctx: it caches the
    first answer of its loader for the whole process, and that answer
    is None in a test process that loaded the module while another was
    still writing it."""
    return jax_fctx.CompiledCtx(kind, fps[0]), fctx.compiled_ctx(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_ctx_protocol_matches_jax(fps, kind):
    """The compiled context of each kind: zeros, from_int, exponent, dot,
    rnd_int and the numpy object-array broadcast, bit for bit."""
    cj, ct = compiled_ctxs(fps, kind)
    assert ct is not None
    out = [ctx_protocol(cj), ctx_protocol(ct)]
    assert out[0] == out[1]
    assert out[1][2] == 201 and out[1][4] == 7


def test_ctx_protocol_survives_a_poisoned_jax_loader(fps, monkeypatch):
    """The JAX package's state after the collection-time build race: its
    loader has given None (tried, no module), and get_ctx(FT_DPE) and
    get_ctx(FT_DD) have cached None for dpe and dd in its compiled_ctx
    cache. The contexts compared above still come from the loaded
    module, for every kind, and compare bit for bit. The JAX package's
    state is put back afterwards."""
    import fplll_tpu.native as jn

    monkeypatch.setattr(jn, "_FPNUM_TRIED", True)
    monkeypatch.setattr(jn, "_FPNUM", None)
    monkeypatch.setattr(jax_fctx, "_COMPILED_CACHE", {})
    for ft in (FT_DPE, FT_DD):
        jax_fctx.get_ctx(ft)
    assert jax_fctx._COMPILED_CACHE == {"dpe": None, "dd": None}
    assert jax_fctx.compiled_ctx("dpe") is None
    for kind in KINDS:
        cj, ct = compiled_ctxs(fps, kind)
        assert ctx_protocol(cj) == ctx_protocol(ct), kind


def test_random_chains_match_jax(fps):
    """Seeded chains of mixed operations across the three kinds, with
    int conversion at each step (the GSO's row_addmul_we pattern)."""
    fj, ft = fps
    rng = np.random.default_rng(11)
    for kind in KINDS:
        mj, mt = getattr(fj, kind), getattr(ft, kind)
        xj, xt = mj(1.0), mt(1.0)
        for step in range(300):
            f = float(rng.standard_normal()) * 10.0 ** int(rng.integers(-5, 6))
            op = int(rng.integers(4))
            if op == 0:
                xj, xt = xj + mj(f), xt + mt(f)
            elif op == 1:
                xj, xt = xj * mj(f), xt * mt(f)
            elif op == 2 and f != 0.0:
                xj, xt = xj / mj(f), xt / mt(f)
            else:
                xj, xt = xj - mj(f) * xj, xt - mt(f) * xt
            assert bits(xt) == bits(xj), (kind, step)
            comps, off = xt.parts()
            assert fctx.comps_to_int_mul_2exp(comps, off + 20) == \
                jax_fctx.comps_to_int_mul_2exp(xj.parts()[0],
                                               xj.parts()[1] + 20)
