"""The port's fpylll veneer against the JAX package's, on the CPU.

`fplll_tpu_torch.fpylll` is a copy of `fplll_tpu.fpylll` over the port's
modules. Each public class gets the same seed and input through both
veneers (the cases of tests/test_fpylll_compat.py): matrices and vectors
must be equal as integers, enumeration distances and simulated profiles
equal as floats, and pruning results equal within the tolerance of the
pruner's gradient (tests/test_torch_pruner.py).
"""

import math
import os

import pytest
import torch

import fplll_tpu.fpylll as jf
import fplll_tpu_torch.fpylll as tf
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

BOTH = (jf, tf)


def rows(A):
    return [[int(A[i, j]) for j in range(A.ncols)] for i in range(A.nrows)]


def each(fn, seed=None):
    """fn(veneer) through both veneers, each from the same seed."""
    out = []
    for v in BOTH:
        if seed is not None:
            v.FPLLL.set_random_seed(seed)
        out.append(fn(v))
    return out


@pytest.mark.parametrize("family,d,kw", [
    ("qary", 20, {"k": 10, "bits": 20}), ("uniform", 12, {"bits": 18}),
    ("intrel", 8, {"bits": 20}), ("ntrulike", 10, {"bits": 12}),
    ("simdioph", 6, {"bits": 10, "bits2": 5}), ("trg", 10, {"alpha": 1.2})])
def test_integer_matrix_random_matches_jax(family, d, kw):
    mj, mt = each(lambda v: v.IntegerMatrix.random(d, family, **kw), seed=1337)
    assert isinstance(mt, tf.IntegerMatrix) and rows(mt) == rows(mj)


def test_integer_matrix_constructors_match_jax():
    mj, mt = each(lambda v: v.IntegerMatrix.from_matrix([[1, 2], [3, 4]]))
    assert rows(mt) == rows(mj)
    assert rows(mt.transpose()) == rows(mj.transpose())
    assert mt.multiply_left([1, 1]) == mj.multiply_left([1, 1]) == (4, 6)
    assert rows(tf.IntegerMatrix.identity(4)) == \
        rows(jf.IntegerMatrix.identity(4))
    with pytest.raises(ValueError):
        tf.IntegerMatrix.random(8, "nope", bits=4)


def test_lll_and_gso_match_jax():
    def run(v):
        A = v.IntegerMatrix.random(25, "uniform", bits=25)
        v.LLL.reduction(A)
        M = v.GSO.Mat(A, flags=v.GSO.ROW_EXPO, update=True)
        return rows(A), v.LLL.is_reduced(A), M.get_current_slope(0, 25)
    (aj, rj, sj), (at, rt, st) = each(run, seed=7)
    assert at == aj and rt and rj
    assert st == pytest.approx(sj, rel=1e-12) and st < 0


def test_bkz_easyparam_matches_jax():
    def run(v):
        A = v.IntegerMatrix.random(30, "qary", k=15, bits=20)
        v.LLL.reduction(A)
        v.BKZ.reduction(A, v.BKZ.EasyParam(10, max_loops=2))
        return rows(A)
    aj, at = each(run, seed=11)
    assert at == aj


@pytest.mark.parametrize("method", ["fast", "proved"])
def test_svp_matches_jax(method):
    def run(v):
        A = v.IntegerMatrix.random(20, "qary", k=10, bits=15)
        return v.SVP.shortest_vector(A, method=method), rows(A)
    (vj, aj), (vt, at) = each(run, seed=23)
    assert at == aj and vt == vj and sum(x * x for x in vt) > 0


def test_cvp_matches_jax():
    def run(v):
        A = v.IntegerMatrix.random(20, "qary", k=10, bits=15)
        v.LLL.reduction(A)
        t = A.multiply_left([1] * A.nrows)
        off = [c + (3 if i % 2 else -2) for i, c in enumerate(t)]
        return (v.CVP.closest_vector(A, t), v.CVP.closest_vector(A, off),
                v.CVP.closest_vector(A, off, method="proved"), t)
    (*wj, tj), (*wt, tt) = each(run, seed=23)
    assert wt == wj and wt[0] == tuple(tt) == tuple(tj)


def test_enumeration_with_sub_solutions_matches_jax():
    def run(v):
        A = v.IntegerMatrix.random(20, "qary", k=10, bits=15)
        v.LLL.reduction(A)
        M = v.GSO.Mat(A, update=True)
        enum = v.Enumeration(M, nr_solutions=3, sub_solutions=True)
        val, e = M.get_r_exp(0, 0)
        r00 = M.ctx.to_float(val) * 2.0 ** e
        sols = enum.enumerate(0, 20, r00 * 1.001, 0)
        subs, nodes = enum.sub_solutions, enum.get_nodes()
        with pytest.raises(v.EnumerationError):
            enum.enumerate(0, 20, sols[0][0] * 1e-6, 0)
        return sols, subs, nodes
    (sj, subj, nj), (st, subt, nt) = each(run, seed=5)
    assert st == sj and 1 <= len(st) <= 3
    assert subt == subj and len(subt) > 0
    assert nt == nj > 0


def test_pruning_matches_jax():
    """Pruning.run on tests/test_fpylll_compat.py's profile cut to n = 24
    (d = 12, the analytic gradient on CPU tensors; n = 40 takes 14 s per
    package), LinearPruningParams and svp_probability."""
    r = [2.0 ** (-0.05 * i) for i in range(24)]
    gh = math.exp(sum(math.log(x) for x in r) / 24) * 1.1
    pj, pt = each(lambda v: v.Pruning.run(
        gh, 2.0 ** 20, r, 0.4, flags=v.Pruning.GRADIENT |
        v.Pruning.NELDER_MEAD))
    assert len(pt.coefficients) == 24
    assert all(0 < c <= 1.0 for c in pt.coefficients)
    assert pt.expectation == pytest.approx(pj.expectation, rel=1e-8)
    assert tf.Pruning.svp_probability(pt) == \
        pytest.approx(jf.Pruning.svp_probability(pj), rel=1e-8)
    lj, lt = each(lambda v: v.Pruning.LinearPruningParams(40, 20))
    assert lt.coefficients == lj.coefficients
    assert lt.expectation == lj.expectation
    assert tf.Pruning.svp_probability(lt) == jf.Pruning.svp_probability(lj)


def test_simulate_matches_jax():
    def run(v):
        A = v.IntegerMatrix.random(60, "qary", k=30, bits=20)
        v.LLL.reduction(A)
        prof, tours = v.simulate(A, v.BKZ.Param(40, max_loops=8))
        M = v.GSO.Mat(A, update=True)
        return prof, tours, v.simulate(M, v.BKZ.Param(40, max_loops=8))
    (pj, tj, mj), (pt, tt, mt) = each(run, seed=3)
    assert (pt, tt) == (pj, tj) and mt == mj and tt >= 1
