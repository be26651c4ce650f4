"""The port's pruner against the JAX package's, on the CPU.

`fplll_tpu_torch.pruner.torchgrad` is the port of `fplll_tpu.pruner.jaxgrad`:
the same log-target gradient, from torch.autograd on f64 tensors instead
of jax.grad under XLA. The even-simplex recurrence cancels catastrophically
as d grows, so the two agree only as far as their rounding lets them: the
tolerances below are norm-relative and grow with d (probability metric)
while the expected-solutions metric stays tight. The pruner, the linear
pruning parameters and the success probability are copies that must give
the same numbers.
"""

import math
import os

import numpy as np
import pytest
import torch

import fplll_tpu.pruner.pruner as jax_pruner
import fplll_tpu_torch as ft
import fplll_tpu_torch.pruner.pruner as port_pruner
from fplll_tpu.algs.bkz_param import PruningParams as JaxPruningParams
from fplll_tpu.pruner import jaxgrad
from fplll_tpu_torch.algs.bkz_param import PruningParams
from fplll_tpu_torch.defs import (PRUNER_CVP, PRUNER_GRADIENT,
                                  PRUNER_METRIC_EXPECTED_SOLUTIONS,
                                  PRUNER_METRIC_PROBABILITY_OF_SHORTEST,
                                  PRUNER_NELDER_MEAD)
from fplll_tpu_torch.pruner import torchgrad

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

PROB = PRUNER_METRIC_PROBABILITY_OF_SHORTEST
EXPECTED = PRUNER_METRIC_EXPECTED_SOLUTIONS

# norm-relative tolerance of the port's gradient against jaxgrad's, per
# metric and d. Measured worst case over both symmetry factors (an x86-64
# CPU, torch 2.13 against jax 0.9 on XLA:CPU): probability metric 5.9e-15
# (d 5), 9.1e-14 (d 10), 4.8e-11 (d 20), 4.2e-8 (d 30); expected solutions
# 5.8e-16 (d 5), 1.0e-14 (d 10), 2.8e-14 (d 20), 1.7e-12 (d 30)
TOL = {PROB: {5: 1e-11, 10: 1e-11, 20: 1e-8, 30: 1e-5},
       EXPECTED: {5: 1e-11, 10: 1e-11, 20: 1e-11, 30: 1e-11}}


def profile(d, metric, flags):
    """The profile of tests/test_pruner.py's gradient test at n = 2d
    (r_i = 1.012^(-4i), radius 1.1 GH), with both packages' pruners and
    b = linspace(0.3, 1, d) enforced."""
    n = 2 * d
    r = [math.exp(-4 * math.log(1.012) * i) for i in range(n)]
    gh = math.exp(sum(math.log(x) for x in r) / n -
                  2 * ((n / 2) * math.log(math.pi) - math.lgamma(n / 2 + 1))
                  / n)
    target = 0.5 if metric == PROB else 1.0
    jp = jax_pruner.Pruner(1.1 * gh, 1e10, r, target, metric, flags)
    tp = port_pruner.Pruner(1.1 * gh, 1e10, r, target, metric, flags,
                            device="cpu")
    b = np.linspace(0.3, 1.0, d)
    jp.enforce(b)
    return jp, tp, b


@pytest.mark.parametrize("flags", [0, PRUNER_CVP], ids=["svp", "cvp"])
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
@pytest.mark.parametrize("d", [5, 10, 20, 30])
def test_gradient_matches_jaxgrad(d, metric, flags):
    """The measured worst cases are in TOL's comment; the tolerances are
    the ones set before the port was written (about 100 times the
    differences a scratch port with unfused multiply-adds showed)."""
    jp, tp, b = profile(d, metric, flags)
    gj = jaxgrad.gradient(jp, b)
    gt = torchgrad.gradient(tp, b, device="cpu")
    assert gj is not None and gt is not None
    assert gt[-1] == gj[-1] == 0.0
    err = np.linalg.norm(gt - gj) / np.linalg.norm(gj)
    assert err <= TOL[metric][d], err


@pytest.mark.parametrize("case", ["short", "long", "d31", "zeros", "nan",
                                  "negative"])
def test_gradient_is_none_where_jaxgrad_is(case):
    """Wrong length and d > 30 before any device work, and a non-finite
    gradient (a zero, a NaN, coefficients below the clamps) after it."""
    d = 31 if case == "d31" else 10
    jp, tp, b = profile(d, PROB, 0)
    b = {"short": b[:-1], "long": np.append(b, 1.0), "d31": b,
         "zeros": np.zeros(d), "nan": np.full(d, np.nan),
         "negative": np.linspace(-1.0, 1.0, d)}[case]
    assert jaxgrad.gradient(jp, b) is None
    assert torchgrad.gradient(tp, b, device="cpu") is None


def test_gradient_matches_numerical_scheme(monkeypatch):
    """tests/test_pruner.py's check, for the port: the analytic gradient
    and the reference's numerical scheme agree in direction."""
    jp, tp, b = profile(20, PROB, 0)
    g = torchgrad.gradient(tp, b, device="cpu")
    monkeypatch.setenv("FPLLL_TPU_PRUNER_JAXGRAD", "0")
    g_num = tp._gradient(b.copy())
    cos = float(np.dot(g, g_num) / (np.linalg.norm(g) * np.linalg.norm(g_num)))
    assert cos > 0.999, cos


def test_device_error_propagates(monkeypatch):
    """A failure on the device raises out of gradient() and out of the
    pruner's descent: it never becomes the numerical scheme."""
    def broken(*args):
        def log_target(*a):
            raise RuntimeError("CUDA error: an illegal memory access")
        return log_target

    monkeypatch.setattr(torchgrad, "_build", broken)
    _, tp, b = profile(10, PROB, 0)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        torchgrad.gradient(tp, b, device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tp._gradient(b)


def test_descent_takes_the_gradient_on_the_pruner_device(monkeypatch):
    """Pruner._gradient hands its device to torchgrad; the JAX package's
    knob FPLLL_TPU_PRUNER_JAXGRAD=0 selects the numerical scheme."""
    seen = []
    orig = torchgrad.gradient

    def spy(pruner, b, device=None):
        seen.append(device)
        return orig(pruner, b, device=device)

    monkeypatch.setattr(torchgrad, "gradient", spy)
    _, tp, b = profile(10, PROB, 0)
    tp._gradient(b)
    assert seen == ["cpu"]
    monkeypatch.setenv("FPLLL_TPU_PRUNER_JAXGRAD", "0")
    tp._gradient(b)
    assert seen == ["cpu"]


@pytest.mark.parametrize("block,level", [(10, 5), (20, 8), (40, 20),
                                         (60, 60), (24, 0)])
def test_linear_pruning_params_match_jax(block, level):
    """The port raised NotImplementedError here; now the same coefficients
    and the same expectation as the JAX package."""
    jp = JaxPruningParams.LinearPruningParams(block, level)
    tp = PruningParams.LinearPruningParams(block, level)
    assert tp.coefficients == jp.coefficients
    assert tp.expectation == jp.expectation and tp.gh_factor == jp.gh_factor


def test_svp_probability_and_exports_match_jax():
    """svp_probability (half and full vectors) is the JAX package's, and
    the package exports the pruner as the JAX package does."""
    rng = np.random.default_rng(3)
    for n in (10, 21, 40):
        c = sorted(rng.uniform(0.2, 1.0, n), reverse=True)
        assert ft.svp_probability(c) == jax_pruner.svp_probability(c)
    assert ft.Pruner is port_pruner.Pruner and ft.prune is port_pruner.prune
    assert ft.run_pruner is port_pruner.run_pruner


@pytest.mark.parametrize("n,metric,target", [(20, PROB, 0.5),
                                             (30, EXPECTED, 1.0)])
def test_prune_matches_jax(n, metric, target):
    """prune with the descent and Nelder-Mead: the expectation agrees to
    1e-5, the gradient's loosest tolerance (measured: 1.2e-11 at n = 20,
    6.6e-14 at n = 30). The optimizer is chaotic
    in the coefficients (a gradient an ulp apart takes the descent down
    another path; with jaxgrad's gradient injected the port's coefficients
    are bit-equal), so they are compared by the run's repeated-enumeration
    cost, within 2% (measured: 1.1% at n = 20, 1.0% at n = 40), not one
    by one. The expected-solutions metric lands on the same coefficients
    to 7e-7."""
    gso = [1.05 ** -i for i in range(n)]
    gh = math.exp(sum(math.log(x) for x in gso) / n) * 1.1
    flags = PRUNER_GRADIENT | PRUNER_NELDER_MEAD
    rj = jax_pruner.prune(gh, 1e6, gso, target, metric, flags)
    rt = port_pruner.prune(gh, 1e6, gso, target, metric, flags,
                           device="cpu")
    assert len(rt.coefficients) == n and rt.coefficients[0] == 1.0
    assert rt.expectation == pytest.approx(rj.expectation, rel=1e-5)
    p = port_pruner.Pruner(gh, 1e6, gso, target, metric, flags)
    cj = p.repeated_enum_cost(rj.coefficients)
    ct = p.repeated_enum_cost(rt.coefficients)
    assert ct == pytest.approx(cj, rel=0.02)
