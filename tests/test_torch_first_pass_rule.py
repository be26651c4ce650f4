"""The facade's rule for its native first pass (enum/device.py:
skips_first_pass): on a card, a pruned search whose radius is already at
the window's Gaussian heuristic and whose tree is estimated past 2.5
times the first pass's budget goes straight to the card; everything else
keeps the pass.

On the CPU the rule is held to each of its three conditions and to the
device, and the facade is driven with the rule evaluated as on a card
(the plain version standing in for the kernel): each skip is counted
once as ``first_pass.skipped``, no ``facade.first_pass`` span is
recorded, and the answer is the JAX package's answer to the same window.
The card test takes some of the benchmark cell's block-60 windows
through the fpylll veneer at the card's default budget, and holds the
answers to the JAX package's (worked out on the CPU, where a test here
checks them), to the benchmark's plain reference and to the port's C
core's whole tree."""

import json
import os

import numpy as np
import pytest
import torch

from fplll_tpu_torch import trace
from fplll_tpu_torch.algs.bkz_param import load_strategies_json
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.fpylll import (LLL, GSO, Enumeration, EnumerationError,
                                    IntegerMatrix)
from fplll_tpu_torch.nr.rng import RandGen
from jax_reference import load_jax_native_cores

BLOCK = 28
KAPPAS = (0, 4, 8, 12)
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
# relative gap allowed between an f32 walk's reported squared length and
# the f64 C core's: the f32 bound's slack is 1e-5 and the benchmark's
# block-60 answers read up to 1.2e-5 off their true lengths
F32_SLACK = 1e-4


@pytest.fixture(autouse=True)
def recorder_off():
    assert not trace.on()
    yield
    if trace.on():
        trace.stop()


@pytest.fixture(scope="module")
def basis():
    RandGen.init_with_seed(7)
    A = IntegerMatrix.random(40, "qary", k=20, bits=20)
    LLL.reduction(A)
    return A


@pytest.fixture(scope="module")
def pruning():
    return [float(c) for c in load_strategies_json("default.json")[
        BLOCK].pruning_parameters[0].coefficients]


def window_rdiag(A, kappa=0):
    M = GSO.Mat(A)
    M.update_gso()
    return np.array([M.get_r(i, i) for i in range(kappa, kappa + BLOCK)])


@pytest.fixture(scope="module")
def window(basis, pruning):
    """(rdiag, prune, gh2, estimate at 1.1 GH) of the [0, 28) window."""
    rdiag = window_rdiag(basis)
    prune = np.asarray(pruning)
    gh2 = tdev.gh_squared(rdiag)
    return rdiag, prune, gh2, tdev.gh_tree_estimate(rdiag, prune, 1.1 * gh2)


# each case breaks one condition of the rule (or none): the estimate
# grows with the radius and without pruning, so only the named condition
# changes. The budget puts the estimate at 3 budgets ("past") or at 2
# ("under", below the rule's 2.5)
CASES = {
    "pruned_at_gh_past_the_crossover": ({}, True),
    "at_the_radius_limit": ({"radius": 1.25}, True),
    "unpruned": ({"prune": "none"}, False),
    "all_ones_pruning": ({"prune": "ones"}, False),
    "certified": ({"certified": True}, False),
    "four_times_gh": ({"radius": 4.0}, False),
    "just_past_the_radius_limit": ({"radius": 1.26}, False),
    "estimate_under_the_crossover": ({"budget": "under"}, False),
    "cpu_device": ({"device": CPU}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rule_holds_each_condition(window, case):
    rdiag, prune, gh2, est = window
    change, skips = CASES[case]
    budget = est / {"past": 3, "under": 2}[change.get("budget", "past")]
    p = {"keep": prune, "ones": np.ones_like(prune), "none": None}[
        change.get("prune", "keep")]
    got = tdev.skips_first_pass(change.get("device", CUDA), rdiag, p,
                                change.get("radius", 1.1) * gh2, gh2, budget,
                                change.get("certified", False))
    assert got is skips


def test_gh_squared_is_the_gaussian_heuristic(window):
    """gh2 is the squared Gaussian heuristic: the volume of the ball of
    squared radius gh2 in dimension d equals the window's volume."""
    from math import lgamma, log, pi
    rdiag, _, gh2, _ = window
    d = len(rdiag)
    ball = d / 2 * log(pi * gh2) - lgamma(d / 2 + 1)
    assert ball == pytest.approx(0.5 * np.sum(np.log(rdiag)), rel=1e-12)


def solve(A, kappa, radius, pruning):
    """(squared length, coordinates) of one window's answer through the
    veneer, or None for no vector in the bound."""
    M = GSO.Mat(A)
    M.update_gso()
    try:
        (dist, coords), = Enumeration(M).enumerate(kappa, kappa + BLOCK,
                                                   radius, 0,
                                                   pruning=pruning)
    except EnumerationError:
        return None
    return dist, coords


def recorded(fn):
    trace.start()
    try:
        out = fn()
    finally:
        snap = trace.stop()
    return out, snap


def rows(A):
    return [[int(A[i, j]) for j in range(A.ncols)] for i in range(A.nrows)]


def jax_solve(jf, M, kappa, block, radius, pruning):
    """The JAX package's answer to one window through its veneer: the
    squared length, or None for no vector in the bound."""
    try:
        (dist, _), = jf.Enumeration(M).enumerate(kappa, kappa + block,
                                                 radius, 0, pruning=pruning)
    except jf.EnumerationError:
        return None
    return dist


@pytest.fixture
def facade(monkeypatch, basis, pruning):
    """run(as_on_a_card) -> [(answer, snapshot)] over KAPPAS on the CPU
    at a first-pass budget of 50; the radius 1.1 GH of each window; and
    the JAX package's answers to the same windows."""
    import fplll_tpu.fpylll as jf
    load_jax_native_cores()
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 20)
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    radii = [1.1 * tdev.gh_squared(window_rdiag(basis, k)) for k in KAPPAS]
    M = jf.GSO.Mat(jf.IntegerMatrix.from_matrix(rows(basis)))
    M.update_gso()
    want = [jax_solve(jf, M, k, BLOCK, r, pruning)
            for k, r in zip(KAPPAS, radii)]
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    rule = tdev.skips_first_pass

    def run(as_on_a_card):
        if as_on_a_card:
            monkeypatch.setattr(
                tdev, "skips_first_pass",
                lambda dev, *a: rule(CUDA, *a))
        return [recorded(lambda: solve(basis, k, r, pruning))
                for k, r in zip(KAPPAS, radii)]
    return run, want


def test_cpu_keeps_the_pass_and_counts_no_skip(facade):
    run, _ = facade
    for _, snap in run(False):
        assert "first_pass.skipped" not in snap.counts
        assert snap.counts["first_pass.iters"] == 50
        assert len(snap.named("facade.first_pass")) == 1


def test_a_skip_is_counted_once_and_answers_as_the_jax_package(facade):
    run, jax = facade
    for (got, snap), want in zip(run(True), jax):
        launches = len(snap.named("kernels.run"))
        assert snap.counts["first_pass.skipped"] == 1
        assert snap.counts["enum.frontier.native"] == launches
        assert set(snap.counts) <= {"first_pass.skipped",
                                    "enum.frontier.native",
                                    "enum.stage.grown"}
        assert not snap.named("facade.first_pass")
        assert launches >= 1
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == pytest.approx(want, rel=F32_SLACK)
    assert sum(w is not None for w in jax) >= 2


# -- the benchmark cell's windows ---------------------------------------------

CELL = "svpchal80-bkz2.b60-windows"
# the JAX package's answers (squared length, or None for no vector in the
# bound) to some of the cell's windows, by row of its request table; row
# 152 is the one tree the first pass's budget finished on a card. The
# card test holds the port to them, and the CPU test below checks them
JAX_CELL = {0: None, 41: 1669715.3269185983, 83: 2065580.8407301928,
            118: 3125740.741160344, 152: 6222213.079604723,
            167: 2031702.3872455829}


def cell_of_the_benchmark(monkeypatch):
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    monkeypatch.syspath_prepend(root)
    from portbench.harness.registry import load_cell

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return load_cell(json.load(f), CELL)


def test_cell_answers_are_the_jax_packages(monkeypatch):
    """JAX_CELL is what the JAX package's veneer answers to those windows
    (its C core walks each whole tree within its CPU budget)."""
    import fplll_tpu.fpylll as jf
    load_jax_native_cores()
    cell = cell_of_the_benchmark(monkeypatch)
    block = int(cell.config["block_size"])
    sets = cell.config["pruning"]["sets"]
    for row, want in JAX_CELL.items():
        req = cell.table[row]
        M = jf.GSO.Mat(jf.IntegerMatrix.from_matrix(
            cell.pool["bases"][int(req["basis"])].tolist()))
        M.update_gso()
        got = jax_solve(jf, M, int(req["kappa"]), block, float(req["radius"]),
                        [float(c) for c in sets[int(req["prune"])][
                            "coefficients"]])
        assert (got is None) == (want is None), row
        if got is not None:
            assert got == pytest.approx(want, rel=1e-9), row


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cell_windows_skip_to_the_card(monkeypatch):
    """Those windows of the benchmark cell through the veneer at the
    card's default budget: each records one first_pass.skipped, no
    facade.first_pass span and one launch, and answers as the JAX package
    (JAX_CELL) and the C core's whole tree do, within the f32 slack; the
    benchmark's plain reference finds every answer sound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cell_of_the_benchmark(monkeypatch)
    from portbench.harness.registry import entry
    from portbench.reference import windows as ref_windows

    ent = entry(cell.spec["entry"])(cell.config, cell.pool, cell.table)
    cell_rows = list(JAX_CELL)
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", str(1 << 62))
    whole = [ent.solve(r) for r in cell_rows]
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cuda")
    monkeypatch.delenv("FPLLL_TPU_HYBRID_NODES")
    ent.solve(cell_rows[0])          # builds the kernel outside the record
    answered = []
    for row, core in zip(cell_rows, whole):
        got, snap = recorded(lambda: ent.solve(row))
        assert snap.counts.get("first_pass.skipped") == 1, row
        assert not snap.named("facade.first_pass"), row
        assert len(snap.named("kernels.run")) == 1, row
        want = JAX_CELL[row]
        assert (got is None) == (want is None) == (core is None), row
        if got is not None:
            assert got[0] == pytest.approx(want, rel=F32_SLACK), row
            assert got[0] == pytest.approx(core[0], rel=F32_SLACK), row
        answered.append((row, got))
    checks = ref_windows.judge(cell.pool, cell.config, cell.table, answered,
                               device="cuda")
    assert checks["bad_answers"] == 0
    assert checks["answer_err"] <= F32_SLACK
