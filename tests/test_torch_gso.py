"""The port's GSO engines against the JAX package's (tests/test_gso.py).

`fplll_tpu_torch/core/gso.py` and `core/householder.py` are copies of
`fplll_tpu/core/` (the port's `MatGSO` also takes the `device=` of its
blocked recompute, which these sizes do not reach). Both packages get the
same basis, made from one `RandGen` seed, and the same sequence of row
operations. Every mu and r must agree to 1e-12 relative in f64 and be
equal where both are exact (the integer Gram, the multiprecision
context); so must the slope, the log-determinant, the slide potential
(the slide tour's stop test), Babai's coefficients and Householder's R
(against each package's naive R too).
"""

import math

import numpy as np
import pytest

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.core.householder import MatHouseholder as JaxMatHouseholder
from fplll_tpu_torch.core.householder import MatHouseholder
from fplll_tpu_torch.defs import (GSO_INT_GRAM, GSO_ROW_EXPO,
                                  HOUSEHOLDER_ROW_EXPO)
from fplll_tpu_torch.interop import basis_from_rows

RTOL = 1e-12


def bases(kind, seed):
    """The JAX package's basis and the port's copy: uniform 10-bit, q-ary
    30-bit (LLL-reduced) or knapsack-style 3000-bit entries."""
    fl.RandGen.init_with_seed(seed)
    if kind == "uniform":
        bj = fl.gen.gen_uniform(12, 10)
    elif kind == "qary":
        bj = fl.gen.gen_qary_bits(30, 15, 30)
        fl.lll_reduction(bj)
    else:
        bj = fl.gen.gen_intrel(10, 3000)
    return bj, basis_from_rows(bj.a)


def value(v, e=0):
    """A context scalar times 2^e as a float (mpmath values exactly
    rounded)."""
    return math.ldexp(float(v), e)


def same(a, b, exact):
    if exact:
        assert a == b
    else:
        assert a == b or abs(a - b) <= RTOL * max(abs(a), abs(b)), (a, b)


def same_exp(pt, pj, exact):
    """Two (value, exponent) pairs of get_r_exp / get_mu_exp: equal
    exponents (the row exponents) and values."""
    (vt, et), (vj, ej) = pt, pj
    assert et == ej
    if exact:
        assert vt == vj
    else:
        same(float(vt), float(vj), False)


def assert_gso_equal(mj, mt, d, exact=False, rows=None):
    for i in (range(d) if rows is None else rows):
        same_exp(mt.get_r_exp(i, i), mj.get_r_exp(i, i), exact)
        for j in range(i):
            same_exp(mt.get_mu_exp(i, j), mj.get_mu_exp(i, j), exact)
            same_exp(mt.get_r_exp(i, j), mj.get_r_exp(i, j), exact)


@pytest.mark.parametrize("flags,kind,mp", [
    (0, "uniform", False), (GSO_ROW_EXPO, "uniform", False),
    (GSO_INT_GRAM, "uniform", False), (0, "qary", False),
    (GSO_ROW_EXPO, "knapsack", False), (GSO_INT_GRAM, "knapsack", True)],
    ids=["plain-uniform", "rowexpo-uniform", "intgram-uniform",
         "plain-qary", "rowexpo-knapsack", "intgram-mp-knapsack"])
def test_gso_matches_jax(flags, kind, mp):
    bj, bt = bases(kind, 7)
    mj = fl.MatGSO(bj, flags=flags, ctx=fl.MPCtx(200) if mp else None)
    mt = ft.MatGSO(bt, flags=flags, ctx=ft.MPCtx(200) if mp else None)
    ok = mt.update_gso()
    assert ok == mj.update_gso()
    valid = [i for i in range(bj.nrows) if mj.update_gso_row(i)]
    assert valid == [i for i in range(bt.nrows) if mt.update_gso_row(i)]
    # in f64 the unreduced knapsack basis loses its later rows in both
    # packages alike (LLL's row exponents carry it); every other case
    # is valid throughout
    assert ok or kind == "knapsack"
    assert_gso_equal(mj, mt, bj.nrows, exact=mp, rows=valid)
    if not ok:
        return
    if flags & GSO_INT_GRAM:
        assert [mt.get_int_gram(i, j) for i in range(bt.nrows)
                for j in range(i + 1)] == \
            [mj.get_int_gram(i, j) for i in range(bj.nrows)
             for j in range(i + 1)]
    (uj, rj, ej), (ut, rt, et) = (m.export_mu_r(0, bj.nrows)
                                  for m in (mj, mt))
    assert et == ej
    np.testing.assert_allclose(np.asarray(rt, float), np.asarray(rj, float),
                               rtol=RTOL)
    np.testing.assert_allclose(np.asarray(ut, float), np.asarray(uj, float),
                               rtol=RTOL, atol=1e-300)


def test_incremental_updates_match_jax():
    """Row operations and moves, then update_gso: the same state in both
    packages, and equal to a fresh recompute."""
    out = []
    for pkg in (fl, ft):
        pkg.RandGen.init_with_seed(11)
        b = pkg.gen.gen_uniform(10, 12)
        m = pkg.MatGSO(b, flags=GSO_ROW_EXPO)
        m.update_gso()
        m.row_op_begin(3, 4)
        m.row_addmul_we(3, 1, -2.0, 0)
        m.row_op_end(3, 4)
        m.move_row(5, 2)
        m.move_row(1, 6)
        m.row_op_begin(7, 8)
        m.row_addmul(7, 0, 3.0)
        m.row_op_end(7, 8)
        m.update_gso()
        fresh = pkg.MatGSO(b.copy(), flags=GSO_ROW_EXPO)
        fresh.update_gso()
        out.append((b, m, fresh))
    (bj, mj, fj), (bt, mt, ftr) = out
    assert bt.a.tolist() == bj.a.tolist()
    assert_gso_equal(mj, mt, 10)
    for i in range(10):
        for j in range(i):
            assert math.isclose(value(*mt.get_mu_exp(i, j)),
                                value(*ftr.get_mu_exp(i, j)),
                                rel_tol=1e-8, abs_tol=1e-9)


def test_gram_object_matches_jax():
    """MatGSOGram(B B^T) of both packages, and each equal to its MatGSO."""
    bj, bt = bases("uniform", 2)
    out = []
    for pkg, b in ((fl, bj), (ft, bt)):
        G = pkg.IntMat.from_rows(
            [[b.dot_rows(i, j) for j in range(b.nrows)]
             for i in range(b.nrows)])
        mg = pkg.MatGSOGram(G, flags=GSO_INT_GRAM)
        mb = pkg.MatGSO(b, flags=GSO_INT_GRAM)
        mg.update_gso()
        mb.update_gso()
        out.append((mg, mb))
    (gj, bj_), (gt, bt_) = out
    assert_gso_equal(gj, gt, 12)
    assert_gso_equal(bt_, gt, 12)


def test_slope_det_and_slide_potential_match_jax():
    """get_current_slope, get_log_det, get_root_det and
    get_slide_potential (the slide tour's stop test) at every block size
    that divides the q-ary basis' dimension, and at some that do not."""
    bj, bt = bases("qary", 4)
    mj, mt = fl.MatGSO(bj, flags=0), ft.MatGSO(bt, flags=0)
    mj.update_gso()
    mt.update_gso()
    d = bj.nrows
    for lo, hi in ((0, d), (3, 17), (10, d)):
        same(mt.get_current_slope(lo, hi), mj.get_current_slope(lo, hi),
             False)
        same(float(mt.get_log_det(lo, hi)), float(mj.get_log_det(lo, hi)),
             False)
        same(float(mt.get_root_det(lo, hi)), float(mj.get_root_det(lo, hi)),
             False)
    for block in (2, 3, 5, 6, 7, 10, 15, 30):
        pt = mt.ctx.to_float(mt.get_slide_potential(0, d, block))
        pj = mj.ctx.to_float(mj.get_slide_potential(0, d, block))
        same(pt, pj, False)
        assert math.isfinite(pt)


def test_babai_and_canonical_match_jax():
    out = []
    for pkg in (fl, ft):
        pkg.RandGen.init_with_seed(8)
        b = pkg.gen.gen_uniform(6, 8)
        pkg.lll_reduction(b)
        m = pkg.MatGSO(b, flags=0)
        m.update_gso()
        w = [3 * int(b.a[0][j]) - 2 * int(b.a[4][j]) for j in range(b.ncols)]
        v = m.from_canonical([float(x) for x in w])
        c = m.babai(v, from_floats=True)
        back = m.from_canonical(m.to_canonical([1.0, -2.0, 0.5, 0.0, 3.0,
                                                -1.0]))
        out.append((c, [float(x).hex() for x in v],
                    [float(x).hex() for x in back]))
    assert out[0] == out[1]
    assert out[1][0] == [3, 0, 0, 0, -2, 0]


def test_householder_matches_jax():
    """update_R row by row against update_R_naively in each package, and
    the two packages' R equal."""
    bj, bt = bases("uniform", 13)
    out = []
    for cls, b in ((JaxMatHouseholder, bj), (MatHouseholder, bt)):
        m = cls(b, flags=HOUSEHOLDER_ROW_EXPO)
        m.refresh_R_bf()
        for i in range(b.nrows):
            m.updated_R = False
            m.update_R(i, True)
        m.update_R_naively()
        R = [[value(*m.get_R(i, j)) for j in range(i + 1)]
             for i in range(b.nrows)]
        naive = [value(*m.get_R_naively(i, i)) for i in range(b.nrows)]
        for i in range(b.nrows):
            assert math.isclose(R[i][i], naive[i], rel_tol=1e-8)
        out.append(R)
    for rj, rt in zip(*out):
        for a, c in zip(rj, rt):
            same(c, a, False)
