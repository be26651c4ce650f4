"""The port's HLLL against the JAX package's (tests/test_hlll.py).

`fplll_tpu_torch/algs/hlll.py` and `core/householder.py` are copies of
`fplll_tpu/`: Householder-based LLL through the wrapper (wrapper, fast
and proved methods), directly on a `MatHouseholder`, and the `-nolll`
verifier. Both packages reduce the same basis, made from one `RandGen`
seed; the reduced bases and statuses must be equal as integers. The JAX
test on the reference fixture example_in skips where it is absent; a
generated knapsack-style basis of 800-bit entries takes its place.
"""

import pytest

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.hlll import HLLLReduction as JaxHLLLReduction
from fplll_tpu.algs.wrapper import hlll_reduction as jax_hlll_reduction
from fplll_tpu.core.householder import MatHouseholder as JaxMatHouseholder
from fplll_tpu_torch.algs.hlll import HLLLReduction, is_hlll_reduced
from fplll_tpu_torch.algs.wrapper import hlll_reduction
from fplll_tpu_torch.core.householder import MatHouseholder
from fplll_tpu_torch.defs import (HOUSEHOLDER_OP_FORCE_LONG,
                                  HOUSEHOLDER_ROW_EXPO, LM_FAST, LM_PROVED,
                                  LM_WRAPPER, RED_SUCCESS)
from fplll_tpu_torch.interop import basis_from_rows


def rows(b):
    return [[int(v) for v in r] for r in b.a.tolist()]


def hlll_reduced(b):
    m = MatHouseholder(b.copy(), flags=HOUSEHOLDER_ROW_EXPO)
    return is_hlll_reduced(m, 0.99, 0.51) == RED_SUCCESS


# large entries only for the wrapper and the fast method: the proved
# method on 3000-bit entries takes more than four minutes on an x86-64 CPU
@pytest.mark.parametrize("method,bits", [
    (LM_WRAPPER, 30), (LM_FAST, 30), (LM_PROVED, 30), (LM_WRAPPER, 800),
    (LM_FAST, 800)], ids=["wrapper", "fast", "proved", "wrapper-800",
                          "fast-800"])
def test_hlll_methods_match_jax(method, bits):
    fl.RandGen.init_with_seed(3)
    bj = fl.gen.gen_intrel(14, bits)
    bt = basis_from_rows(bj.a)
    sj = jax_hlll_reduction(bj, method=int(method))
    st = hlll_reduction(bt, method=method)
    assert st == sj == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert hlll_reduced(bt)


def test_hlll_direct_matches_jax():
    fl.RandGen.init_with_seed(7)
    bj = fl.gen.gen_uniform(16, 14)
    bt = basis_from_rows(bj.a)
    flags = HOUSEHOLDER_ROW_EXPO | HOUSEHOLDER_OP_FORCE_LONG
    hj = JaxHLLLReduction(JaxMatHouseholder(bj, flags=int(flags)), 0.99,
                          0.51)
    ht = HLLLReduction(MatHouseholder(bt, flags=flags), 0.99, 0.51)
    assert hj.hlll() and ht.hlll()
    assert rows(bt) == rows(bj)
    assert hlll_reduced(bt)
    assert ft.is_lll_reduced(ft.MatGSO(bt, flags=ft.GSO_ROW_EXPO), 0.95,
                             0.56)


def test_hlll_nolll_verifier_matches_jax():
    """`fplll -a hlll -nolll`: verification only, before and after."""
    fl.RandGen.init_with_seed(9)
    bj = fl.gen.gen_uniform(10, 12)
    bt = basis_from_rows(bj.a)
    before = (jax_hlll_reduction(bj.copy(), nolll=True),
              hlll_reduction(bt.copy(), nolll=True))
    assert before[0] == before[1] != RED_SUCCESS
    assert jax_hlll_reduction(bj) == hlll_reduction(bt) == RED_SUCCESS
    assert rows(bt) == rows(bj)
    assert jax_hlll_reduction(bj, nolll=True) == \
        hlll_reduction(bt, nolll=True) == RED_SUCCESS
