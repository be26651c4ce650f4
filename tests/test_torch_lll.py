"""The port's LLL against the JAX package's (tests/test_lll.py).

`fplll_tpu_torch/algs/lll.py` and `algs/wrapper.py` are copies of
`fplll_tpu/algs/`: LLL under every method, float type and precision that
tests/test_lll.py parametrises (the wrapper's precision ladder, fast,
proved, heuristic, mpfr at 100 bits, dd), transform tracking, zero rows
and the Gram pipeline. Both packages reduce the same basis, made from one
`RandGen` seed; the reduced bases, the transforms and the statuses must
be equal as integers. The JAX tests on the reference fixtures
(example_in, dim55_in) skip where they are absent; generated knapsack-style
and q-ary bases of those kinds take their place.
"""

import pytest

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.wrapper import lll_reduction as jax_lll_reduction
from fplll_tpu_torch.algs.wrapper import lll_reduction
from fplll_tpu_torch.defs import (FT_DD, FT_DEFAULT, FT_DPE, FT_MPFR,
                                  GSO_INT_GRAM, GSO_ROW_EXPO, LM_FAST,
                                  LM_HEURISTIC, LM_PROVED, LM_WRAPPER,
                                  RED_SUCCESS)
from fplll_tpu_torch.interop import basis_from_rows


def rows(b):
    return [[int(v) for v in r] for r in b.a.tolist()]


def reduced(pkg, b, delta=0.99, eta=0.51):
    m = pkg.MatGSO(b.copy(), flags=GSO_INT_GRAM, ctx=pkg.MPCtx(120))
    return pkg.is_lll_reduced(m, delta, eta)


def both(make, seed, **kw):
    """LLL of the JAX package and of the port on one basis: (status, the
    JAX package's reduced basis, the port's)."""
    fl.RandGen.init_with_seed(seed)
    bj = make(fl.gen)
    bt = basis_from_rows(bj.a)
    assert not reduced(ft, bt)
    sj = jax_lll_reduction(bj, **{k: (int(v) if k in ("method",
                                                      "float_type") else v)
                                  for k, v in kw.items()})
    st = lll_reduction(bt, **kw)
    assert st == sj
    return st, bj, bt


METHODS = [(LM_WRAPPER, FT_DEFAULT, 0), (LM_FAST, FT_DEFAULT, 0),
           (LM_PROVED, FT_DEFAULT, 0), (LM_HEURISTIC, FT_DEFAULT, 0),
           (LM_PROVED, FT_MPFR, 100), (LM_FAST, FT_DD, 0)]
METHOD_IDS = ["wrapper", "fast", "proved", "heuristic", "proved-mpfr100",
              "fast-dd"]


@pytest.mark.parametrize("method,ftype,prec", METHODS, ids=METHOD_IDS)
def test_int_rel_matches_jax(method, ftype, prec):
    """Seeded knapsack bases (test_lll.cpp:140-148) across methods."""
    st, bj, bt = both(lambda g: g.gen_intrel(18, 40), 1337, method=method,
                      float_type=ftype, precision=prec)
    assert st == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert reduced(ft, bt)


@pytest.mark.parametrize("method,ftype,prec", [
    (LM_WRAPPER, FT_DEFAULT, 0), (LM_HEURISTIC, FT_DPE, 0),
    (LM_PROVED, FT_MPFR, 120)], ids=["wrapper", "heuristic-dpe",
                                     "proved-mpfr120"])
def test_large_entries_match_jax(method, ftype, prec):
    """A 10 x 11 knapsack basis of 3000-bit entries (the kind of the
    reference's example_in): the row-exponent and precision paths."""
    st, bj, bt = both(lambda g: g.gen_intrel(10, 3000), 1, method=method,
                      float_type=ftype, precision=prec)
    assert st == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert reduced(ft, bt)


def test_qary_dim55_matches_jax():
    """A dim-56 q-ary basis (the size of the reference's dim55_in)."""
    st, bj, bt = both(lambda g: g.gen_qary_bits(56, 28, 30), 55)
    assert st == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert reduced(ft, bt)


def test_transform_tracking_matches_jax():
    """u tracks the reduction (u b_in = b_out) and is the JAX package's."""
    fl.RandGen.init_with_seed(5)
    bj = fl.gen.gen_uniform(10, 14)
    bt = basis_from_rows(bj.a)
    b_in = bt.copy()
    uj, ut = fl.IntMat.identity(10), ft.IntMat.identity(10)
    assert jax_lll_reduction(bj, u=uj, method=int(LM_FAST)) == RED_SUCCESS
    assert lll_reduction(bt, u=ut, method=LM_FAST) == RED_SUCCESS
    assert rows(bt) == rows(bj) and rows(ut) == rows(uj)
    assert ((ut.a @ b_in.a) == bt.a).all()


def test_zero_rows_match_jax():
    data = [[0, 0, 0], [2, 4, 6], [1, 2, 3], [3, 6, 9], [1, 0, 5]]
    bj, bt = fl.IntMat.from_rows(data), ft.IntMat.from_rows(data)
    assert jax_lll_reduction(bj) == lll_reduction(bt) == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert bt.row_is_zero(0) and bt.row_is_zero(1) and bt.row_is_zero(2)
    assert not bt.row_is_zero(4)


def test_gram_pipeline_matches_jax():
    """Reducing G = B B^T (test_lll_gram.cpp) in both packages: equal
    Grams, and each equal to its own reduced basis' r."""
    out = []
    for pkg in (fl, ft):
        pkg.RandGen.init_with_seed(3)
        b = pkg.gen.gen_uniform(8, 15)
        G = pkg.IntMat.from_rows(
            [[b.dot_rows(i, j) for j in range(8)] for i in range(8)])
        mg = pkg.MatGSOGram(G, flags=GSO_INT_GRAM)
        assert pkg.LLLReduction(mg, 0.99, 0.51).lll()
        m3 = pkg.MatGSO(b, flags=GSO_INT_GRAM)
        assert pkg.LLLReduction(m3, 0.99, 0.51).lll()
        m3.update_gso()
        mg.update_gso()
        for i in range(8):
            a, c = float(m3.get_r(i, i)), float(mg.get_r(i, i))
            assert abs(a - c) <= 1e-6 * max(1.0, abs(c))
        out.append((rows(G), rows(b)))
    assert out[0] == out[1]


def test_lll_object_statistics_match_jax():
    """LLLReduction on a row-exponent GSO: swaps, final kappa and status
    as the JAX package's."""
    out = []
    for pkg in (fl, ft):
        pkg.RandGen.init_with_seed(17)
        b = pkg.gen.gen_qary_bits(30, 15, 30)
        m = pkg.MatGSO(b, flags=GSO_ROW_EXPO)
        lll = pkg.LLLReduction(m, 0.99, 0.51, 0)
        ok = lll.lll()
        out.append((ok, int(lll.status), lll.n_swaps, lll.final_kappa,
                    rows(b)))
    assert out[0] == out[1]
    assert out[1][0]


@pytest.mark.slow
def test_big_knapsack_matches_jax():
    """3000-bit knapsack entries at d = 20 (the row-expo scaling path)."""
    st, bj, bt = both(lambda g: g.gen_intrel(20, 3000), 1, method=LM_FAST)
    assert st == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert ft.is_lll_reduced(ft.MatGSO(bt, flags=GSO_ROW_EXPO), 0.99, 0.51)
