"""The port's integer matrices and lattice generators against the JAX
package's (tests/test_intmat.py).

`fplll_tpu_torch/ops/intmat.py` and `ops/gen.py` are copies of
`fplll_tpu/ops/`: the exact big-int matrix with fplll's text format, its
row operations, the f64 export with row exponents, and every generator of
`latticegen`. Both packages get the same input or the same `RandGen`
seed; every result must be equal as integers (and the f64 export bit for
bit). The JAX test that parses fplll's reference lattice files skips
where those files are absent; here a generated knapsack-style basis takes
its place.
"""

import random

import numpy as np
import pytest

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.ops import gen as jax_gen
from fplll_tpu.ops import intmat as jax_intmat
from fplll_tpu_torch.ops import gen, intmat

PACKAGES = ((fl, jax_gen, jax_intmat), (ft, gen, intmat))


def rows(m):
    return [[int(v) for v in r] for r in m.a.tolist()]


def test_parse_format_roundtrip_matches_jax():
    rng = random.Random(1)
    data = [[rng.randint(-2 ** 200, 2 ** 200) for _ in range(7)]
            for _ in range(5)]
    texts = [mod.format_matrix(mod.IntMat.from_rows(data))
             for _, _, mod in PACKAGES]
    assert texts[0] == texts[1]
    for _, _, mod in PACKAGES:
        assert rows(mod.parse_matrix(texts[0])) == data


def test_parse_generated_knapsack_matches_jax():
    """fplll's own text of a `latticegen r 10 3000`-style basis (what
    the reference fixture example_in holds) parses alike."""
    fl.RandGen.init_with_seed(3)
    text = jax_intmat.format_matrix(jax_gen.gen_intrel(10, 3000))
    bj, bt = jax_intmat.parse_matrix(text), intmat.parse_matrix(text)
    assert (bt.nrows, bt.ncols) == (bj.nrows, bj.ncols) == (10, 11)
    assert rows(bt) == rows(bj)
    assert intmat.format_matrix(bt) == text


def test_vector_io_matches_jax():
    rng = random.Random(2)
    v = [rng.randint(-10 ** 30, 10 ** 30) for _ in range(9)]
    sj, st = jax_intmat.format_vector(v), intmat.format_vector(v)
    assert st == sj
    assert intmat.parse_vector(st) == jax_intmat.parse_vector(sj) == v


def test_row_ops_match_jax():
    """A seeded sequence of every row operation on a big-int matrix."""
    rng = random.Random(4)
    data = [[rng.randint(-2 ** 90, 2 ** 90) for _ in range(6)]
            for _ in range(8)]
    mats = [mod.IntMat.from_rows(data) for _, _, mod in PACKAGES]
    for _ in range(300):
        i, j = rng.randrange(8), rng.randrange(8)
        op = rng.randrange(8)
        x = rng.randint(-2 ** 40, 2 ** 40)
        e = rng.randint(0, 70)
        lo, hi = sorted((i, j))
        for m in mats:
            if op == 0 and i != j:
                m.row_addmul(i, j, x)
            elif op == 1 and i != j:
                m.row_addmul_2exp(i, j, x, e)
            elif op == 2:
                m.row_swap(i, j)
            elif op == 3:
                m.rotate_right(lo, hi)
            elif op == 4:
                m.rotate_left(lo, hi)
            elif op == 5:
                m.row_negate(i)
            elif op == 6 and i != j:
                m.row_sub(i, j)
            elif op == 7 and i != j:
                m.row_add(i, j)
        assert rows(mats[1]) == rows(mats[0])
    a, b = mats
    assert [b.dot_rows(i, j) for i in range(8) for j in range(8)] == \
        [a.dot_rows(i, j) for i in range(8) for j in range(8)]
    assert [b.row_norm_sq(i) for i in range(8)] == \
        [a.row_norm_sq(i) for i in range(8)]
    assert (b.get_max_exp(), b.max_abs()) == (a.get_max_exp(), a.max_abs())


def test_big_int_exactness_matches_jax():
    big = 10 ** 100
    out = []
    for _, _, mod in PACKAGES:
        m = mod.IntMat.from_rows([[big, 1], [big + 1, 2]])
        m.row_sub(1, 0)
        out.append((rows(m), m.dot_rows(0, 0)))
    assert out[0] == out[1] == ([[big, 1], [1, 1]], big * big + 1)


def test_row_expo_export_matches_jax():
    """to_f64_with_expo (the GSO_ROW_EXPO input) and to_f64 bit for bit."""
    rng = random.Random(5)
    data = [[rng.randint(-2 ** rng.randint(1, 900), 2 ** 900)
             for _ in range(6)] for _ in range(6)]
    data[0] = [2 ** 200, 1, 0, 0, 0, 0]
    (fj, ej), (ft_, et) = (mod.IntMat.from_rows(data).to_f64_with_expo()
                           for _, _, mod in PACKAGES)
    assert np.array_equal(np.asarray(et), np.asarray(ej))
    assert np.asarray(ft_).tobytes() == np.asarray(fj).tobytes()
    assert et[0] == 201 and abs(ft_[0, 0] - 0.5) < 1e-15
    small = [[rng.randint(-1000, 1000) for _ in range(5)] for _ in range(4)]
    assert intmat.IntMat.from_rows(small).to_f64().tobytes() == \
        jax_intmat.IntMat.from_rows(small).to_f64().tobytes()


GENERATORS = {
    "intrel": lambda g: g.gen_intrel(10, 20),
    "intrel-3000": lambda g: g.gen_intrel(12, 3000),
    "simdioph": lambda g: g.gen_simdioph(11, 20, 30),
    "uniform": lambda g: g.gen_uniform(8, 10),
    "ntrulike": lambda g: g.gen_ntrulike(6, 97),
    "ntrulike2": lambda g: g.gen_ntrulike2(6, 97),
    "ntrulike-bits": lambda g: g.gen_ntrulike_bits(6, 10),
    "ntrulike2-bits": lambda g: g.gen_ntrulike2_bits(6, 10),
    "qary": lambda g: g.gen_qary(10, 5, 97),
    "qary-bits": lambda g: g.gen_qary_bits(40, 20, 30),
    "qary-prime": lambda g: g.gen_qary_prime(10, 5, 20),
    "trg": lambda g: g.gen_trg(8, 1.2),
    "trg2": lambda g: g.gen_trg2([10.0] * 8),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_matches_jax(name):
    """Every generator of ops/gen.py on seed 1: equal integer matrices."""
    out = []
    for pkg, g, _ in PACKAGES:
        pkg.RandGen.init_with_seed(1)
        out.append(GENERATORS[name](g))
    assert (out[1].nrows, out[1].ncols) == (out[0].nrows, out[0].ncols)
    assert rows(out[1]) == rows(out[0])


def test_generator_determinism_and_ntrulike_structure():
    ft.RandGen.init_with_seed(99)
    a = gen.gen_uniform(6, 20)
    ft.RandGen.init_with_seed(99)
    assert gen.gen_uniform(6, 20) == a
    ft.RandGen.init_with_seed(2)
    m = gen.gen_ntrulike(5, 127)
    fl.RandGen.init_with_seed(2)
    assert rows(m) == rows(jax_gen.gen_ntrulike(5, 127))
    for i in range(5):
        assert int(m.a[i, i]) == 1 and int(m.a[5 + i, 5 + i]) == 127
    assert sum(int(m.a[0, j]) for j in range(5, 10)) % 127 == 0
