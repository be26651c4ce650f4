"""HKZ's window list on one input, run twice.

`hkz_reduction` is one BKZ tour of block d, which the C tour runs. It
hands every window whose tree it prices above its device crossover to
`enum/device.py:device_enumerate_windows`; each answer it gets back
decides what it inserts, and so which windows come next. On the card an
HKZ run of one basis has handed 12 windows in one run and 20 in another;
if that list depended on the run, so would the reduced basis. Here the
same reduction runs twice on the CPU, with the crossover forced low
(FPLLL_TPU_HYBRID_NODES=50, `_MIN_TPU_DIM` 34, single trials, one
device, 1024-lane batches) so that the windows of dimension 34 and more
reach the device path, whose kernel wrappers run their plain version on
CPU tensors. Both runs must hand the same windows, bit for bit and in
the same order, and give the same basis.
"""

import os

import numpy as np
import pytest
import torch

import fplll_tpu_torch as ft
import fplll_tpu_torch.enum.device as port_device
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.threads import set_threads

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


@pytest.fixture
def device_route(monkeypatch):
    """Windows of dimension 34 and more on the device path."""
    monkeypatch.setenv("FPLLL_TPU_TRIAL_BATCH", "1")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    set_threads(1024)
    yield
    set_threads(-1)


@pytest.fixture
def windows(monkeypatch):
    """Every window list the C tour hands to device_enumerate_windows, as
    f64 copies of (muts, rdiags, prunes, maxdists)."""
    seen = []
    orig = port_device.device_enumerate_windows

    def spy(muts, rdiags, prunes, maxdists, device=None):
        seen.append(tuple(np.array(a, dtype=np.float64)
                          for a in (muts, rdiags, prunes, maxdists)))
        return orig(muts, rdiags, prunes, maxdists, device=device)

    monkeypatch.setattr(port_device, "device_enumerate_windows", spy)
    return seen


def intrel(d, seed):
    """gen_intrel(d, 10 d), LLL- then BKZ-20-reduced, as the smoke's HKZ
    input is made."""
    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_intrel(d, 10 * d)
    ft.lll_reduction(b)
    ft.bkz_reduction(b, 20, device="cpu")
    return b


def test_hkz_hands_the_same_windows_twice(device_route, windows):
    """hkz_reduction twice on one dim-36 basis (device="cpu"): the same
    window lists, each (mu, r, pruning, radius) equal bit for bit and in
    the same order, unpruned, answered by the f64 form; the same reduced
    basis."""
    start = intrel(36, 7)
    runs = []
    for _ in range(2):
        b = start.copy()
        ft.RandGen.init_with_seed(12)
        before = dict(kernels.PLAIN_RUNS)
        windows.clear()
        status = ft.hkz_reduction(b, device="cpu")
        grown = {k: v - before[k] for k, v in kernels.PLAIN_RUNS.items()
                 if v > before[k]}
        runs.append((status, b.a.tolist(), list(windows), grown))
    (s0, b0, w0, g0), (s1, b1, w1, g1) = runs
    assert s0 == s1 == ft.RED_SUCCESS
    assert len(w0) == len(w1) >= 3
    assert {len(w[1][0]) for w in w0} >= {36, 35, 34}
    for i, (a, b) in enumerate(zip(w0, w1)):
        for name, x, y in zip(("mut", "rdiag", "prune", "maxdist"), a, b):
            assert x.shape == y.shape and np.array_equal(x, y), (i, name)
        assert np.all(a[2] == 1.0), i
    assert b1 == b0
    assert g0 == g1 and g0.get("f64", 0) >= len(w0) and set(g0) == {"f64"}
