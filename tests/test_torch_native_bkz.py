"""The port's native BKZ tour engine against the JAX package's
(tests/test_native_bkz.py).

`fplll_tpu_torch/native/bkz_core.c` is a copy of the JAX package's C
tour; `algs/bkz.py:_native_tour` drives it in both. On the same seed both
packages must give the same reduced basis (equal as integers) and the
same node counts, with the C tour on and off, unpruned and pruned, and
when the C tour aborts mid-tour on its own (FPLLL_TPU_BKZ_FAULT), which
both packages redo on the Python engines.

Where they part on purpose: a device window that fails inside the C
tour's callback. The JAX package's callback returns -1 and the Python
engines redo the tour; the port stores the error, lets the C tour abort
and raises it (`algs/bkz.py:_make_native_enum_cb`, `_native_tour`).
"""

import json

import numpy as np
import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.bkz import BKZReduction as JaxBKZReduction
from fplll_tpu.algs.bkz_param import strategy_full_path
from fplll_tpu_torch.algs.bkz import BKZReduction
from fplll_tpu_torch.defs import GSO_ROW_EXPO
from fplll_tpu_torch.interop import strategies_from_json
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

torch.set_num_threads(2)

PACKAGES = ((fl, JaxBKZReduction), (ft, BKZReduction))


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")


def strategies():
    with open(strategy_full_path("default.json")) as f:
        js = json.load(f)
    return fl.load_strategies_json("default.json"), strategies_from_json(js)


def run_bkz(pkg, cls, seed, block, d, strat, max_loops=1):
    """One BKZ of `pkg` on gen_qary_bits(d, d / 2, 14), LLL-reduced, in
    f64 with row exponents; returns (basis, reduction)."""
    pkg.RandGen.init_with_seed(seed)
    b = pkg.gen.gen_qary_bits(d, d // 2, 14)
    pkg.lll_reduction(b)
    p = pkg.BKZParam(block, strat, flags=pkg.BKZ_GH_BND | pkg.BKZ_MAX_LOOPS)
    p.max_loops = max_loops
    m = pkg.MatGSO(b, flags=GSO_ROW_EXPO, ctx=pkg.get_ctx(pkg.FT_DOUBLE, 0))
    bkz = cls(m, pkg.LLLReduction(m, 0.99, 0.51, 0), p)
    bkz.bkz()
    return b, bkz


def run_both(seed, block, d, pruned):
    strat = strategies() if pruned else (None, None)
    (bj, kj), (bt, kt) = (run_bkz(pkg, cls, seed, block, d, s)
                          for (pkg, cls), s in zip(PACKAGES, strat))
    assert bt.a.tolist() == bj.a.tolist()
    assert kt.nodes == kj.nodes > 0
    assert ft.is_lll_reduced(ft.MatGSO(bt.copy(), flags=GSO_ROW_EXPO),
                             0.99, 0.51)
    return bt, kt


@pytest.mark.parametrize("native", ["0", "1"], ids=["python", "c-tour"])
def test_unpruned_tour_matches_jax(monkeypatch, native):
    """Block 20 unpruned on dim 44 (one deterministic trial a window):
    both packages alike, and the C tour visits the Python engines'
    trees."""
    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", native)
    bt, kt = run_both(23, 20, 44, pruned=False)
    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", "1" if native == "0" else "0")
    b2, k2 = run_bkz(ft, BKZReduction, 23, 20, 44, None)
    assert k2.nodes == kt.nodes
    assert np.linalg.norm(np.array(b2.a[0].tolist(), dtype=float)) == \
        np.linalg.norm(np.array(bt.a[0].tolist(), dtype=float))


@pytest.mark.parametrize("native", ["0", "1"], ids=["python", "c-tour"])
def test_pruned_tour_matches_jax(monkeypatch, native):
    """Block 30 with the shipped pruning on dim 56: rerandomized trials
    (splitmix64 in the C tour, RandGen in Python) alike in both."""
    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", native)
    run_both(31, 30, 56, pruned=True)


def spy_python_tours(monkeypatch):
    """The modules of the reductions whose Python engine ran a tour
    (trunc_tour), one entry a tour, in order."""
    calls = []
    for _, cls in PACKAGES:
        orig = cls.trunc_tour

        def spy(self, *a, _orig=orig, **kw):
            calls.append(type(self).__module__)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "trunc_tour", spy)
    return calls


def test_native_abort_is_redone_on_python_as_in_jax(monkeypatch):
    """FPLLL_TPU_BKZ_FAULT=3 aborts the C tour after three windows: both
    packages redo the tour on the Python engines from the partial basis,
    with the same result."""
    calls = spy_python_tours(monkeypatch)
    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", "1")
    run_both(7, 20, 44, pruned=False)
    assert not calls
    monkeypatch.setenv("FPLLL_TPU_BKZ_FAULT", "3")
    run_both(7, 20, 44, pruned=False)
    assert "fplll_tpu.algs.bkz" in calls
    assert "fplll_tpu_torch.algs.bkz" in calls


def test_callback_fault_mid_tour_raises(monkeypatch):
    """A device window that fails mid-tour (the second one the C tour
    hands over) fails the port's reduction, where the JAX package redoes
    the tour on the Python engines and returns a reduced basis."""
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu.threads import set_threads as jax_set_threads
    from fplll_tpu_torch.threads import set_threads

    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", "1")
    monkeypatch.setenv("FPLLL_TPU_TRIAL_BATCH", "1")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 34)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    redo = spy_python_tours(monkeypatch)
    for mod in (jax_tpu, port_device):
        windows = mod.device_enumerate_windows
        seen = []

        def second_fails(*a, _windows=windows, _seen=seen, **kw):
            _seen.append(1)
            if len(_seen) == 2:
                raise RuntimeError("kernel fault")
            return _windows(*a, **kw)

        monkeypatch.setattr(mod, "device_enumerate_windows", second_fails)
    jax_set_threads(128)
    set_threads(128)
    try:
        strat = strategies()
        bj, kj = run_bkz(fl, JaxBKZReduction, 13, 34, 40, strat[0])
        assert redo == ["fplll_tpu.algs.bkz"]
        assert fl.is_lll_reduced(fl.MatGSO(bj.copy(), flags=GSO_ROW_EXPO),
                                 0.99, 0.51)
        with pytest.raises(RuntimeError, match="kernel fault"):
            run_bkz(ft, BKZReduction, 13, 34, 40, strat[1])
        assert redo == ["fplll_tpu.algs.bkz"]
    finally:
        jax_set_threads(-1)
        set_threads(-1)
