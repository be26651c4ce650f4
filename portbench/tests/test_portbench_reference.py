"""The reference against exact arithmetic and brute force, and beside
the port's C core on a pruned window."""

import itertools
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import portbench_support as sup  # noqa: F401
from portbench.reference import enum as ref_enum
from portbench.reference import gso as ref_gso


def _basis(n, seed, bits=8):
    rng = np.random.default_rng(seed)
    while True:
        b = rng.integers(-2 ** bits, 2 ** bits, size=(n, n + 2))
        if np.linalg.matrix_rank(b) == n:
            return b


def _exact_gso(b):
    rows = [[Fraction(int(v)) for v in row] for row in b]
    star, mu = [], [[Fraction(0)] * len(rows) for _ in rows]
    for i, v in enumerate(rows):
        w = list(v)
        for j in range(i):
            s = star[j]
            mu[i][j] = sum(a * c for a, c in zip(v, s)) / \
                sum(c * c for c in s)
            w = [a - mu[i][j] * c for a, c in zip(w, s)]
        star.append(w)
    return mu, [sum(c * c for c in s) for s in star]


def test_gso_matches_exact_rationals():
    b = _basis(7, 1)
    mu, r = ref_gso.gso(b)
    emu, er = _exact_gso(b)
    for i in range(7):
        assert abs(r[i] - float(er[i])) <= 1e-11 * float(er[i])
        for j in range(i):
            assert abs(mu[i, j] - float(emu[i][j])) <= 1e-10
    x = [3, -1, 0, 2, 1, 0, -2]
    v = np.asarray(x) @ b
    assert abs(ref_gso.projected_norm(mu, r, x) - float(v @ v)) <= \
        1e-11 * float(v @ v)
    mw, rw = ref_gso.window(mu, r, 2, 7)
    proj = sum(float(er[i]) * float(x[i] + sum(emu[j][i] * x[j]
                                               for j in range(i + 1, 7))) ** 2
               for i in range(2, 7))
    assert abs(ref_gso.projected_norm(mw, rw, x[2:]) - proj) <= 1e-10 * proj


def _brute(mu, r, prune, bound, span=4):
    n = len(r)
    best = None
    for x in itertools.product(range(-span, span + 1), repeat=n):
        if not any(x):
            continue
        ok, length = True, 0.0
        for k in range(n - 1, -1, -1):
            c = -sum(mu[j, k] * x[j] for j in range(k + 1, n))
            length += r[k] * (x[k] - c) ** 2
            if length > prune[k] * bound * (1 + 1e-12):
                ok = False
                break
        if ok and (best is None or length < best):
            best = length
    return best


@pytest.mark.parametrize("pruned", [False, True])
def test_shortest_matches_brute_force(pruned):
    b = _basis(5, 3, bits=4)
    mu, r = ref_gso.gso(b)
    prune = np.linspace(1.0, 0.4, 5) if pruned else np.ones(5)
    bound = 1.3 * float(r[0])
    want = _brute(mu, r, prune, bound)
    got, x, nodes = ref_enum.shortest(mu, r, prune, bound, chunk=7)
    assert nodes > 0
    if want is None:
        assert got is None
    else:
        assert abs(got - want) <= 1e-9 * want
        assert abs(ref_gso.projected_norm(mu, r, x) - got) <= 1e-9 * got


def test_shortest_matches_the_port_c_core_on_a_pruned_window():
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from fplll_tpu_torch.native import native_enumerate
    from portbench.harness.registry import load_cell

    cell = load_cell(sup.bench_json(), "svpchal80-bkz2.b60-windows")
    prune = np.asarray(load_strategies_json("default.json")[40]
                       .pruning_parameters[0].coefficients)
    mu, r = ref_gso.gso(cell.pool["bases"][2])
    mw, rw = ref_gso.window(mu, r, 38, 78)
    radius = ref_gso.window_radius(rw)
    out = native_enumerate(np.ascontiguousarray(mw.T), rw, prune, None,
                           radius, True, False, False)
    best = out[1]
    got, _, _ = ref_enum.shortest(mw, rw, prune, best * (1 + 1e-9))
    assert got is not None and abs(got - best) <= 1e-9 * best
    lower, _, _ = ref_enum.shortest(mw, rw, prune, best * (1 - 1e-9))
    assert lower is None


def test_lower_precision_walk_reports_rounded_lengths():
    b = _basis(6, 5, bits=6)
    mu, r = ref_gso.gso(b)
    bound = 1.2 * float(r[0])
    f64, x64, _ = ref_enum.shortest(mu, r, np.ones(6), bound)
    bf16, xb, _ = ref_enum.shortest(mu, r, np.ones(6), bound,
                                    dtype=torch.bfloat16)
    assert f64 is not None and bf16 is not None
    true = ref_gso.projected_norm(mu, r, xb)
    assert abs(bf16 - true) / true > 1e-5 or xb != x64
    assert math.isfinite(true)
