"""The slice end to end on the CPU: BKZ-2.0 through both packages.

The same seed basis and the same strategy table go to the JAX package
and, through `fplll_tpu_torch.interop`, to the port. With the device
crossover off both tours run on the native C core; with it forced low
the device-sized windows go to each package's device path (the JAX
package's f32 XLA kernel, the port's kernel wrappers, whose plain
version runs on CPU tensors). Either way the reduced bases must be equal
as integers, and so must the node totals.
"""

import json
import os

import numpy as np
import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.bkz import BKZReduction as JaxBKZReduction
from fplll_tpu.algs.bkz_param import strategy_full_path
from fplll_tpu_torch.algs.bkz import BKZReduction
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.interop import basis_from_rows, strategies_from_json
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


def jax_basis(seed, d):
    fl.RandGen.init_with_seed(seed)
    b = fl.gen.gen_qary_bits(d, d // 2, 14)
    fl.lll_reduction(b)
    return b


def run(pkg, bkz_cls, b, strategies, block, seed):
    pkg.RandGen.init_with_seed(seed)
    p = pkg.BKZParam(block, strategies,
                     flags=pkg.BKZ_GH_BND | pkg.BKZ_MAX_LOOPS, max_loops=1)
    m = pkg.MatGSO(b, flags=pkg.GSO_ROW_EXPO)
    bkz = bkz_cls(m, pkg.LLLReduction(m, 0.99, 0.51, 0), p)
    bkz.bkz()
    return bkz


@pytest.fixture
def both_packages(monkeypatch):
    """One regime for both packages: single trials, one chip for JAX,
    128-lane batches."""
    from fplll_tpu.threads import set_threads as jax_set_threads
    from fplll_tpu_torch.threads import set_threads

    monkeypatch.setenv("FPLLL_TPU_TRIAL_BATCH", "1")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    jax_set_threads(128)
    set_threads(128)
    with open(strategy_full_path("default.json")) as f:
        js = json.load(f)
    yield fl.load_strategies_json("default.json"), strategies_from_json(js)
    jax_set_threads(-1)
    set_threads(-1)


@pytest.mark.parametrize("hybrid", [0, 50])
def test_bkz_tour_matches_jax_package(both_packages, monkeypatch, hybrid):
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device

    jax_strats, port_strats = both_packages
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", str(hybrid))
    # windows of dim >= 34 may go to the device (test_native_bkz.py)
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 34)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    d, block, seed = 40, 34, 13

    bj = jax_basis(seed, d)
    bt = basis_from_rows(bj.a)
    assert bt.a.tolist() == bj.a.tolist()
    kj = run(fl, JaxBKZReduction, bj, jax_strats, block, seed)
    runs = sum(kernels.PLAIN_RUNS.values())
    kt = run(ft, BKZReduction, bt, port_strats, block, seed)
    plain_runs = sum(kernels.PLAIN_RUNS.values()) - runs

    assert bt.a.tolist() == bj.a.tolist()
    assert kt.nodes == kj.nodes > 0
    assert getattr(kt, "dev_nodes", 0) == getattr(kj, "dev_nodes", 0)
    if hybrid:
        assert kt.dev_nodes > 0 and plain_runs > 0
    else:
        assert getattr(kt, "dev_nodes", 0) == 0 and plain_runs == 0
    assert ft.is_lll_reduced(ft.MatGSO(bt.copy()), 0.99, 0.51)


def test_failing_device_window_fails_the_tour(both_packages, monkeypatch):
    """A device window that raises must fail the reduction (the JAX
    package's callback returned -1 and the Python engines silently redid
    the tour)."""
    import fplll_tpu_torch.enum.device as port_device

    _, port_strats = both_packages
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(port_device, "device_enumerate_windows", broken)
    redo = []
    monkeypatch.setattr(BKZReduction, "trunc_tour",
                        lambda self, *a, **k: redo.append(1))
    bt = basis_from_rows(jax_basis(13, 40).a)
    with pytest.raises(RuntimeError, match="kernel fault"):
        run(ft, BKZReduction, bt, port_strats, 34, 13)
    assert not redo


def test_interop_basis_forms():
    rows = [[1, 2, 3], [4, 5, 2 ** 70]]
    a = basis_from_rows(rows)
    b = basis_from_rows(np.array(rows, dtype=object))
    assert a.a.tolist() == b.a.tolist() == rows
    assert isinstance(a.a[1, 2], int)
    with pytest.raises(ValueError):
        basis_from_rows(np.zeros(3, dtype=object))


def test_interop_strategies_equal_the_packaged_table():
    with open(strategy_full_path("default.json")) as f:
        js = json.load(f)
    mine = strategies_from_json(js)
    packaged = ft.load_strategies_json("default.json")
    assert len(mine) == len(packaged) > 60
    for s, t in zip(mine, packaged):
        assert s.preprocessing_block_sizes == t.preprocessing_block_sizes
        assert [p.coefficients for p in s.pruning_parameters] == \
            [p.coefficients for p in t.pruning_parameters]


def test_main_path_tour_hands_trials_in_different_scales(monkeypatch):
    """The block-60 tour of chip_smoke.py's main path hands the device
    grouped trials whose scales differ by powers of 4, which
    device_enumerate_windows brings to one scale (ROADMAP.md Queue 3).
    Replayed on the host: the C core answers each trial in place of the
    kernel, behind device_enumerate_windows' own scaling."""
    import math

    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu_torch.native import native_enumerate

    exps = []
    scale_exponents = port_device._scale_exponents

    def spy(rdiags):
        exps.append(scale_exponents(rdiags))
        return exps[-1]

    def c_core(muts, rdiags, prunes, maxdists, device):
        dists = np.full(len(muts), np.inf)
        sols = np.zeros(muts.shape[:2])
        nodes = 0.0
        for g in range(len(muts)):
            out = native_enumerate(muts[g], rdiags[g], prunes[g], None,
                                   maxdists[g], True, False, False)
            nodes += float(out[4].sum())
            if out[2] is not None and math.isfinite(out[1]):
                dists[g], sols[g] = out[1], out[2]
        return dists, sols, nodes

    monkeypatch.setattr(port_device, "_scale_exponents", spy)
    monkeypatch.setattr(port_device, "_grouped_device_windows", c_core)
    monkeypatch.setattr(port_device, "_trial_windows", c_core)
    ft.RandGen.init_with_seed(11)
    b = ft.gen.gen_qary_bits(80, 40, 30)
    ft.lll_reduction(b)
    strategies = ft.load_strategies_json("default.json")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    for warm in (40, 50):
        ft.bkz_reduction(b, ft.BKZParam(warm, strategies,
                                        flags=ft.BKZ_MAX_LOOPS | ft.BKZ_GH_BND,
                                        max_loops=1), device="cpu")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "2000000")
    ft.RandGen.init_with_seed(12)
    ft.bkz_reduction(b, ft.BKZParam(60, strategies,
                                    flags=ft.BKZ_MAX_LOOPS | ft.BKZ_GH_BND,
                                    max_loops=1), device="cpu")
    assert ft.is_lll_reduced(ft.MatGSO(b.copy()), 0.99, 0.51)
    shifted = [e for e in exps if np.any(e)]
    print(f"grouped launches {len(exps)}, in different scales "
          f"{len(shifted)}: {[e.tolist() for e in shifted]}")
    assert len(exps) >= 20 and shifted
