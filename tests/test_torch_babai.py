"""The port's Babai nearest plane against the JAX package's
(tests/test_babai.py).

`MatGSO.babai` and `from_canonical` (`fplll_tpu_torch/core/gso.py`) are
copies of the JAX package's. Both packages encode the same lattice point
of the same basis, made from one `RandGen` seed, and ask Babai for its
coefficients: they must be equal, also where the float approximation
cannot recover the exact ones (an unreduced knapsack basis), and the CVP
driver's answer on a close target must be the JAX package's.
"""

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.svpcvp import closest_vector as jax_closest_vector
from fplll_tpu_torch.algs.svpcvp import closest_vector
from fplll_tpu_torch.interop import basis_from_rows


def roundtrip(pkg, b, coeffs):
    """Encode sum coeffs_i b_i, ask babai for the coefficients back."""
    m = pkg.MatGSO(b, flags=0)
    m.update_gso()
    w = [sum(c * int(b.a[i, j]) for i, c in enumerate(coeffs))
         for j in range(b.ncols)]
    v = m.from_canonical([float(x) for x in w])
    return m.babai(v, from_floats=True)


def both(make, seed, coeffs, reduce=True):
    fl.RandGen.init_with_seed(seed)
    bj = make(fl.gen)
    if reduce:
        fl.lll_reduction(bj)
    bt = basis_from_rows(bj.a)
    got = roundtrip(ft, bt, coeffs)
    assert got == roundtrip(fl, bj, coeffs)
    assert all(isinstance(c, int) for c in got)
    return got


def test_babai_recovers_small_coeffs_as_jax():
    coeffs = [1, -2, 0, 3, 0, 0, -1, 2]
    assert both(lambda g: g.gen_uniform(8, 10), 17, coeffs) == coeffs


def test_babai_intrel_reduced_as_jax():
    coeffs = [0, 1, 0, -1, 2, 0, 0, 1, 0, -2]
    assert both(lambda g: g.gen_intrel(10, 20), 18, coeffs) == coeffs


def test_babai_unreduced_knapsack_as_jax():
    """On an unreduced knapsack basis the coefficients need not round
    trip (the reference ships such expected-failure cases); the port's
    answer is still the JAX package's."""
    coeffs = [3, -7, 5, 1, -4, 2, 8, -1, 0, 6, -3, 2]
    got = both(lambda g: g.gen_intrel(12, 60), 19, coeffs, reduce=False)
    assert len(got) == 12


def test_cvp_driver_matches_jax():
    """closest_vector on a close target (one unit off a basis vector)."""
    fl.RandGen.init_with_seed(20)
    bj = fl.gen.gen_uniform(8, 8)
    fl.lll_reduction(bj)
    bt = basis_from_rows(bj.a)
    target = [int(bj.a[2, j]) + (1 if j == 0 else 0) for j in range(8)]
    sj, xj = jax_closest_vector(bj, target)
    st, xt = closest_vector(bt, target, backend="cpu")
    assert st == sj == ft.RED_SUCCESS
    assert list(xt) == list(xj)
    v = [sum(c * int(bt.a[i, j]) for i, c in enumerate(xt))
         for j in range(8)]
    assert sum((a - t) ** 2 for a, t in zip(v, target)) <= 1
