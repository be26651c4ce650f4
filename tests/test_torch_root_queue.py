"""The root queue of a launch, as DeviceEnumerator builds it, against the
queue of the earlier pipeline rebuilt here.

The enumerator expands the top of the tree in the C core
(`native_gen_roots`), sorts the frontier by partial distance and writes
it, with the tree's small arrays, into its device's staging buffer in the
kernel's layout and element type (`native_pack_roots`), then copies it to
the device in one copy. The earlier pipeline, rebuilt in `reference`:
the expansion of the JAX package's C core (the same C source before the
expansion kept parent indices instead of copied prefixes; the port's
NumPy level loop where the search takes it), a stable `np.argsort`,
`_pack_tree` and the float64 pad, then `torch.as_tensor` to the tree's
dtype. Every tensor `enum_run` receives must be equal, and so must the
expansion's node counts and the tree's heights, for: the windows of the
benchmark's small pool (dim-40 SVP-Challenge lattices, block-28 windows,
through the fpylll veneer), a pruned f32 tree, an unpruned f64 one, a
dual one (`roots_a`), one with sub-solutions (the NumPy level loop), and
one with the window path's geometry pins. A wide queue followed by a
narrow one in the same staging buffer leaves nothing of the first in the
second.
"""

import os

import numpy as np
import pytest
import torch

import fplll_tpu.native as jax_native
import fplll_tpu_torch as ft
from fplll_tpu_torch.defs import GSO_INT_GRAM
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.enum.evaluator import FastEvaluator
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")


class _Stop(Exception):
    """Raised by the spy in place of the launch."""


@pytest.fixture
def capture(monkeypatch):
    """Stops every search at its launch: a list of {enum, args, kw,
    nodes}, one per DeviceEnumerator.enumerate call, with the keyword
    arguments enum_run would have received and the enumerator's node
    counts at that point."""
    seen = []
    orig = tdev.DeviceEnumerator.enumerate

    def spy_run(**kw):
        seen[-1]["kw"] = kw
        raise _Stop

    def spy_enumerate(self, *args, **kw):
        rec = {"enum": self, "args": args, "opts": kw}
        seen.append(rec)
        with pytest.raises(_Stop):
            orig(self, *args, **kw)
        rec["nodes"] = self.nodes.copy()
        raise _Stop

    monkeypatch.setattr(tdev, "enum_run", spy_run)
    monkeypatch.setattr(tdev.DeviceEnumerator, "enumerate", spy_enumerate)
    return seen


def reference(enum, mut, rdiag, prune, cp0, maxdist, is_svp, evaluator,
              count_mode=False, dual=False):
    """The launch inputs of the earlier pipeline for one search of
    `enum`: (tensors, m, m_real, nodes)."""
    d = len(rdiag)
    mut = np.asarray(mut, dtype=np.float64)
    rdiag = np.asarray(rdiag, dtype=np.float64)
    prune = (np.ones(d) if prune is None or len(prune) == 0
             else np.asarray(prune, dtype=np.float64))
    cp0 = np.asarray(cp0, dtype=np.float64)
    A = float(maxdist)
    out = None
    if not evaluator.findsubsols:
        out = jax_native.native_gen_roots(
            mut, rdiag, prune, cp0, A, is_svp, dual, enum.max_device_levels,
            enum.target_root_factor * enum.batch)
    if out is not None:
        xs, als, pd, m_real, nodes = out
        nodes = nodes.astype(np.int64)
    else:
        fresh = tdev.DeviceEnumerator(batch=enum.batch, device="cpu",
                                      target_root_factor=enum
                                      .target_root_factor, dtype=enum.dtype)
        fresh.nodes = np.zeros(d, dtype=np.int64)
        xs, als, pd, m_real = fresh._gen_roots(
            mut, rdiag, prune, cp0, A, d, is_svp, dual=dual,
            subsols={} if evaluator.findsubsols else None)
        nodes = fresh.nodes
    order = np.argsort(pd, kind="stable")
    tree = enum._pack_tree(mut, rdiag, prune, cp0, d, m_real)
    m, nfix_pad = tree.pop("m"), tree.pop("nfix_pad")
    R, nfix = len(pd), d - m_real
    R_pad = max(1024, enum.pin_R)
    while R_pad < R:
        R_pad *= 2
    host = dict(tree, roots_x=np.zeros((R_pad, nfix_pad)),
                roots_pd=np.full(R_pad, np.inf))
    host["roots_x"][:R, :nfix] = xs[order]
    host["roots_pd"][:R] = pd[order]
    if dual:
        host["roots_a"] = np.zeros((R_pad, nfix_pad))
        host["roots_a"][:R, :nfix] = als[order]
    tensors = {k: torch.as_tensor(np.ascontiguousarray(a), dtype=enum.dtype)
               for k, a in host.items()}
    return tensors, m, min(m_real, m), nodes


def assert_same_launch(rec) -> dict:
    """The captured launch equals the earlier pipeline's, tensor for
    tensor; returns its tensors."""
    enum, kw = rec["enum"], rec["kw"]
    want, m, m_real, nodes = reference(enum, *rec["args"], **rec["opts"])
    got = {k: v for k, v in kw.items() if isinstance(v, torch.Tensor)}
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].device == t.device, k
        assert torch.equal(got[k], t), k
    assert kw["m"] == m and kw["m_real"] == m_real
    assert np.array_equal(rec["nodes"], nodes)
    return got


def problem(seed, d, factor):
    """An LLL-reduced q-ary basis' exact GSO and `factor` times its
    squared Gaussian heuristic."""
    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_qary_bits(d, d // 2, 12)
    ft.lll_reduction(b)
    gso = ft.MatGSO(b, flags=GSO_INT_GRAM, ctx=ft.MPCtx(90))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, d)
    rdiag = np.asarray(rdiag, dtype=np.float64)
    return np.asarray(mut, np.float64), rdiag, \
        factor * tdev.gh_squared(rdiag)


@pytest.fixture(scope="module")
def small_pool():
    """The benchmark's small pool (its tests' dim-40 SVP-Challenge
    lattices, block-28 windows), kappa 0-2 of seeds 3 and 4, with the
    block-28 strategy's pruning sets."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from portbench import make_data

    sets = [{"gh_factor": p.gh_factor,
             "coefficients": [float(c) for c in p.coefficients]}
            for p in load_strategies_json("default.json")[28]
            .pruning_parameters]
    pool = {"maker": "challenge_windows", "file": "qsmall.npz",
            "seeds": [3, 4], "generator": {"n": 40, "bits": 400},
            "block_size": 28, "kappa": [0, 2], "delta": 0.99,
            "gh_factor": 1.1}
    arrays, _ = make_data.challenge_windows(pool, sets)
    return arrays, sets


def pool_window(small_pool, row, monkeypatch):
    """One window of the small pool through the veneer, as the benchmark's
    entry calls it, on the device path without the first pass."""
    from fplll_tpu_torch.fpylll import GSO, Enumeration, IntegerMatrix

    arrays, sets = small_pool
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 20)
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    M = GSO.Mat(IntegerMatrix.from_matrix(
        arrays["bases"][int(arrays["win_basis"][row])].tolist()))
    M.update_gso()
    k = int(arrays["win_kappa"][row])
    with pytest.raises(_Stop):
        Enumeration(M).enumerate(
            k, k + 28, float(arrays["win_radius"][row]), 0,
            pruning=sets[int(arrays["win_prune"][row])]["coefficients"])


def direct(kind):
    """One search straight through a DeviceEnumerator."""
    d = 40
    mut, rdiag, A = problem(5, d, 1.2)
    prune = np.linspace(1.0, 0.3, d)
    enum = tdev.DeviceEnumerator(batch=128, device="cpu")
    ev = FastEvaluator()
    dual = False
    if kind == "f64-unpruned":
        enum = tdev.DeviceEnumerator(batch=128, device="cpu",
                                     dtype=torch.float64)
        prune = None
    elif kind == "dual":
        dual = True
    elif kind == "subsols":
        ev = FastEvaluator(find_subsolutions=True)
    elif kind == "pins":
        enum.pin_m, enum.pin_nfix, enum.pin_R = 64, 16, 32768
    with pytest.raises(_Stop):
        enum.enumerate(mut, rdiag, prune, np.zeros(d), A, True, ev,
                       dual=dual)


CASES = ["pool-0", "pool-1", "pool-2", "pool-3", "pool-4", "pool-5",
         "f32-pruned", "f64-unpruned", "dual", "subsols", "pins"]


@pytest.mark.parametrize("case", CASES)
def test_launch_inputs_equal_the_earlier_pipeline(case, capture, small_pool,
                                                  monkeypatch):
    if case.startswith("pool-"):
        pool_window(small_pool, int(case[5:]), monkeypatch)
    else:
        direct(case)
    rec, = capture
    got = assert_same_launch(rec)
    enum = rec["enum"]
    assert got["mut"].dtype == enum.dtype
    assert ("roots_a" in got) == (case == "dual")
    if case == "f64-unpruned":
        assert enum.dtype == torch.float64
    if case == "pins":
        assert got["roots_x"].shape[0] == 32768 and \
            got["roots_x"].shape[1] >= 16 and got["mut"].shape == (64, 64)


def test_a_narrow_queue_after_a_wide_one_holds_only_its_own_rows(capture):
    """About 44K roots, then about 1.2K, through the same staging buffer:
    the second queue has its own rows, +inf past them and zero pad
    columns and rows, as the earlier pipeline's."""
    ev = FastEvaluator()
    for d, target_factor in ((56, 32), (40, 1)):
        mut, rdiag, A = problem(1, d, 1.1)
        enum = tdev.DeviceEnumerator(batch=1024, device="cpu",
                                     target_root_factor=target_factor)
        with pytest.raises(_Stop):
            enum.enumerate(mut, rdiag, np.linspace(1.0, 0.25, d),
                           np.zeros(d), A, True, ev)
    wide, narrow = capture
    big = assert_same_launch(wide)
    got = assert_same_launch(narrow)
    R_wide = int(torch.isfinite(big["roots_pd"]).sum())
    R = int(torch.isfinite(got["roots_pd"]).sum())
    nfix = len(narrow["args"][1]) - narrow["kw"]["m_real"]
    assert R_wide > 40000 and 1000 < R < 2000
    assert big["roots_x"].shape[0] > got["roots_x"].shape[0]
    assert torch.isinf(got["roots_pd"][R:]).all()
    assert not got["roots_x"][R:].any() and not got["roots_x"][:, nfix:].any()
    assert torch.all(got["roots_pd"][:R].diff() >= 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_equal_distances_keep_their_expansion_order(dtype):
    """The queue's sort is stable: rows of equal pd (+0.0 and -0.0 among
    them) keep their order, as np.argsort(kind="stable") keeps it, in
    either element type, with the pad written whatever the buffer held."""
    from fplll_tpu_torch.native import native_pack_roots

    rng = np.random.default_rng(5)
    R, nfix, R_pad, nfix_pad = 3000, 5, 4096, 8
    pd = rng.choice([0.0, -0.0, 0.5, 1.0, 1.0 + 2 ** -40, 3.25], R)
    wide = rng.random(R) < 0.3
    pd[wide] = rng.random(int(wide.sum()))
    xs = rng.integers(-9, 10, (R, nfix)).astype(np.float64)
    als = xs - 0.25
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    out = {k: np.full(shape, 7.0, dtype=np_dtype) for k, shape in
           (("x", (R_pad, nfix_pad)), ("a", (R_pad, nfix_pad)),
            ("pd", (R_pad,)))}
    native_pack_roots(xs, als, pd, out["x"], out["a"], out["pd"])
    order = np.argsort(pd, kind="stable")
    for k, rows in (("x", xs), ("a", als)):
        want = torch.zeros((R_pad, nfix_pad), dtype=dtype)
        want[:R, :nfix] = torch.as_tensor(rows[order], dtype=dtype)
        assert torch.equal(torch.from_numpy(out[k]), want), k
    want = torch.full((R_pad,), float("inf"), dtype=dtype)
    want[:R] = torch.as_tensor(pd[order], dtype=dtype)
    assert torch.equal(torch.from_numpy(out["pd"]), want)
