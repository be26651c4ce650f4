"""The f32 tree's distance drift on the CPU, and the rule that repairs it.

The enumeration kernel's f32 walk (and the JAX package's f32 XLA walk,
whose arithmetic it repeats step for step) computes each candidate's
partial distances in f32 from centers that sum x_j mu_ij. Where those sums
cancel, two vectors whose norms are closer than the rounding can swap
places: the walk ranks them by their f32 distances, so it returns the
longer one, and the 1e-5 bound slack does nothing about that. On the
card, unpruned d = 56 windows of HKZ sat up to 5.4e-4 off their f64 norms.

The port now runs every unpruned search, and every certified one, in f64
(`enum/device.py:tree_dtype`); pruned searches, heuristic by design, keep
f32 and its slack. These tests show the lost vector on a window built to
show it, the drift on a window of the family HKZ reduces (a BKZ-20-reduced
`gen_intrel`), and the dtype each entry point now picks, read from the
plain version's counters.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from fplll_tpu.enum import tpu as jtpu
from fplll_tpu.enum.evaluator import FastEvaluator as JaxFastEvaluator
from fplll_tpu.jaxsetup import jnp
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.enum.evaluator import FastEvaluator
from fplll_tpu_torch.native import native_enumerate
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from test_torch_enum_kernel import EMU_THREADS, host_build  # noqa: F401

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64

# a two-level window built to show the fault: the basis rows (A, 0) and
# (C, E), so r_00 = A^2, mu_10 = C / A = 98765.45 and r_11 = E^2. A
# vector x has the integer norm (A x_0 + C x_1)^2 + E^2 x_1^2. The two
# shortest are SHORT (x_1 = 1, norm 267016) and LONG (x_1 = 2, norm
# 268064), 0.39% apart. In f32, mu_10 rounds to 98765.453125, and the
# residual of LONG at level 0, -0.1, becomes -0.09375: the f32 walk
# reports LONG at 266853, below SHORT.
A, C, E = 1000, 98765450, 254
SHORT, LONG = [-98765, 1], [-197531, 2]


def norm(x):
    return (A * int(x[0]) + C * int(x[1])) ** 2 + E * E * int(x[1]) ** 2


def built_window():
    """(mut, rdiag, maxdist) of the two-level window: maxdist is the
    first basis vector's squared norm, where an SVP search starts."""
    mut = np.array([[0.0, C / A], [0.0, 0.0]])
    rdiag = np.array([float(A * A), float(E * E)])
    return mut, rdiag, float(A * A)


def basis_rows():
    return [[A, 0], [C, E]]


def test_built_window_has_two_close_vectors():
    """SHORT and LONG are the two shortest vectors up to sign: every
    other vector inside the search radius (x_1 <= 3 there, x_0 within one
    of its center) is longer."""
    _, _, maxdist = built_window()
    assert norm(SHORT) == 267016 and norm(LONG) == 268064
    others = [norm((x0, x1)) for x1 in range(4)
              for x0 in range(-(x1 * C // A) - 2, -(x1 * C // A) + 3)
              if (x0, x1) != (0, 0) and [x0, x1] not in (SHORT, LONG)]
    assert min(others) > norm(LONG) and norm(LONG) < maxdist


def test_f32_walks_return_the_longer_vector(monkeypatch):
    """The port's f32 walk (DeviceEnumerator, the plain version on CPU
    tensors) and the JAX package's (TPUEnumerator's XLA walk, Pallas off)
    both return LONG, and report it shorter than SHORT is."""
    monkeypatch.setenv("FPLLL_TPU_PALLAS", "0")
    mut, rdiag, maxdist = built_window()
    ev = FastEvaluator()
    enum = tdev.DeviceEnumerator(batch=64, device="cpu", dtype=F32)
    runs = kernels.PLAIN_RUNS["single"]
    enum.enumerate(mut, rdiag, None, np.zeros(2), maxdist, True, ev)
    assert kernels.PLAIN_RUNS["single"] == runs + 1
    assert [int(v) for v in ev.begin()[1]] == LONG
    assert ev.begin()[0] < norm(SHORT) < norm(LONG)

    ev_j = JaxFastEvaluator()
    ej = jtpu.TPUEnumerator(batch=64, dtype=jnp.float32)
    ej.enumerate(mut, rdiag, None, np.zeros(2), maxdist, True, ev_j)
    assert [int(v) for v in ev_j.begin()[1]] == LONG
    assert ev_j.begin()[0] == ev.begin()[0]


def test_f64_walks_return_the_shorter_vector():
    """The C core, the port's f64 walk and the JAX package's f64 walk
    return SHORT at its exact norm."""
    mut, rdiag, maxdist = built_window()
    out = native_enumerate(mut, rdiag, None, None, maxdist, True, False,
                           False)
    assert [int(v) for v in out[2]] == SHORT
    assert out[1] == pytest.approx(norm(SHORT), rel=1e-9)

    ev = FastEvaluator()
    enum = tdev.DeviceEnumerator(batch=64, device="cpu", dtype=F64)
    runs = kernels.PLAIN_RUNS["f64"]
    enum.enumerate(mut, rdiag, None, np.zeros(2), maxdist, True, ev)
    assert kernels.PLAIN_RUNS["f64"] == runs + 1
    assert [int(v) for v in ev.begin()[1]] == SHORT
    assert ev.begin()[0] == pytest.approx(norm(SHORT), rel=1e-9)

    ev_j = JaxFastEvaluator()
    ej = jtpu.TPUEnumerator(batch=64, dtype=jnp.float64)
    ej.enumerate(mut, rdiag, None, np.zeros(2), maxdist, True, ev_j)
    assert [int(v) for v in ev_j.begin()[1]] == SHORT


@pytest.fixture
def device_route(monkeypatch):
    """Every tree of dimension 2 and more to the port's device path, with
    no native first pass, on one device."""
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 2)


def facade_search(pruning=()):
    """An SVP search through the port's enumeration facade (the fpylll
    veneer's Enumeration): the built basis, a FastEvaluator, the first
    basis vector's squared norm as the radius."""
    from fplll_tpu_torch import fpylll

    B = fpylll.IntegerMatrix.from_matrix(basis_rows())
    M = fpylll.GSO.Mat(B, update=True)
    dist, x = fpylll.Enumeration(M).enumerate(0, 2, float(A * A), 0,
                                              pruning=pruning)[0]
    return dist, [int(v) for v in x]


def test_entry_points_return_the_shorter_vector(device_route):
    """The facade (an unpruned FastEvaluator search, fpylll's
    Enumeration) and the C tour's window path (device_enumerate_windows,
    one window) run the f64 form and return SHORT."""
    runs = dict(kernels.PLAIN_RUNS)
    dist, x = facade_search()
    assert x == SHORT and dist == pytest.approx(norm(SHORT), rel=1e-9)
    assert kernels.PLAIN_RUNS["f64"] > runs["f64"]
    assert kernels.PLAIN_RUNS["single"] == runs["single"]

    mut, rdiag, maxdist = built_window()
    runs = dict(kernels.PLAIN_RUNS)
    dists, sols, _ = tdev.device_enumerate_windows(
        mut[None], rdiag[None], np.ones((1, 2)), np.array([maxdist]),
        device="cpu")
    assert [int(v) for v in sols[0]] == SHORT
    assert dists[0] == pytest.approx(norm(SHORT), rel=1e-9)
    assert kernels.PLAIN_RUNS["f64"] > runs["f64"]
    assert kernels.PLAIN_RUNS["single"] == runs["single"]


# ---------------------------------------------------------------------------
# a window of the family HKZ reduces
# ---------------------------------------------------------------------------
# gen_intrel(40, 400), seed 4, LLL- then BKZ-20-reduced; the window [2, 40)
# at HKZ's radius (r_kk), its device tree 34 levels tall (the roots of a
# 64-lane batch at root factor 1). Seeds 1-12 at d = 36 and 1-4 at d = 40
# (windows [0, d), [2, d), [4, d)) gave no lost vector; the drift of their
# f32 answers reached 2.4e-5, past the slack only where the f32 walk was
# 34 or more levels tall (PERF.md).
REAL_WINDOW = (40, 4, 2)


def real_window():
    import fplll_tpu_torch as ft
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx

    d, seed, k = REAL_WINDOW
    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_intrel(d, 10 * d)
    ft.lll_reduction(b)
    ft.bkz_reduction(b, 20, device="cpu")
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(120))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(k, d)
    mut = np.asarray(mut, dtype=np.float64)
    rdiag = np.asarray(rdiag, dtype=np.float64)
    return mut, rdiag, float(rdiag[0]) * 1.00001


def drift(dist, x, mut, rdiag):
    """The reported distance over the vector's norm from the window's f64
    GSO, less one (chip_smoke.py's WindowAnswers.drift)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    alpha = np.array([x[i] + float(np.dot(x[i + 1:], mut[i, i + 1:]))
                      for i in range(n)])
    return float(dist) / float(np.dot(rdiag, alpha ** 2)) - 1.0


def emulated_answer(lib, mut, rdiag, A, dtype):
    """The CUDA kernel's device code, compiled for the host, on the
    window packed as DeviceEnumerator packs it at 64 lanes and root
    factor 1, two blocks: (reported distance, coordinates, m_real)."""
    n = len(rdiag)
    enum = tdev.DeviceEnumerator(batch=64, target_root_factor=1,
                                 device="cpu", dtype=dtype)
    enum.nodes = np.zeros(n, dtype=np.int64)
    prune = np.ones(n)
    rx, _, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(n), A,
                                         n, True)
    pack = enum._pack(mut, rdiag, prune, np.zeros(n), n, rx, rpd, m_real)
    t = [pack[k][None].contiguous() for k in (
        "mut", "rdiag", "prune", "mut_fix", "cp0", "roots_x", "roots_pd")]
    a0 = torch.full((1,), A * enum.bound_slack, dtype=dtype)
    mr = torch.full((1,), pack["m_real"], dtype=torch.int32)
    grid = 2
    walkers = grid * EMU_THREADS // lib.enum_chunk_emulated_width()
    p, out = kernels._prepare(*t, a0, mr, G_real=1, walkers=walkers,
                              is_svp=True, count_mode=False,
                              max_steps=1 << 40)
    assert lib.enum_chunk_emulate(ctypes.byref(p), grid, EMU_THREADS) == 0
    res = kernels._finalize_single(out, pack["roots_x"], float(a0),
                                   count_mode=False, walkers=walkers,
                                   max_steps=1 << 40)
    bd = res["best_dist"].double().numpy()
    i = int(np.argmin(bd))
    x = np.concatenate([res["best_dev"][i].double().numpy()[:m_real],
                        res["best_root"][i].double().numpy()[:n - m_real]])
    return float(bd[i]), x, m_real


def test_real_window_drift(host_build):
    """On the BKZ-20-reduced gen_intrel window, the card's f32 walk (its
    device code, emulated) reports its answer more than the 1e-5 slack
    off the answer's f64 norm; its f64 walk, and the window path the C
    tour calls (f64 now), within 1e-9. All three return a vector of the
    C core's norm: no vector is lost on this window."""
    mut, rdiag, A = real_window()
    ref = native_enumerate(mut, rdiag, None, None, A, True, False, False)
    lib = host_build()

    dist, x, m_real = emulated_answer(lib, mut, rdiag, A, F32)
    assert m_real == 34
    assert drift(dist, x, mut, rdiag) > 1e-5
    dist, x, _ = emulated_answer(lib, mut, rdiag, A, F64)
    assert abs(drift(dist, x, mut, rdiag)) < 1e-9
    assert abs(dist / ref[1] - 1.0) < 1e-9

    runs = dict(kernels.PLAIN_RUNS)
    dists, sols, _ = tdev.device_enumerate_windows(
        mut[None], rdiag[None], np.ones((1, len(rdiag))), np.array([A]),
        device="cpu")
    assert kernels.PLAIN_RUNS["f64"] > runs["f64"]
    assert abs(drift(dists[0], sols[0], mut, rdiag)) < 1e-9
    assert abs(dists[0] / ref[1] - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# the dtype rule at every entry point
# ---------------------------------------------------------------------------
def small_window(d=24, seed=2):
    """An LLL-reduced gen_uniform window and its linear pruning (1 down
    to 0.5): the pruned and unpruned searches of the rule's tests."""
    from test_torch_device import window

    b, mut, rdiag, normexp, A = window(d, seed, 1.2)
    prune = np.linspace(1.0, 0.5, d)
    return b, mut, rdiag, A, prune


def port_basis(d=24, seed=2):
    """The port's copy of that LLL-reduced gen_uniform basis."""
    from fplll_tpu_torch.interop import basis_from_rows
    from test_torch_device import setup

    return basis_from_rows(setup(d, seed)[0].a)


def grown(before):
    return {k: v - before[k] for k, v in kernels.PLAIN_RUNS.items()
            if v != before[k]}


def facade(bt, walk, pruned):
    """One search through the facade: a FastEvaluator SVP search
    (Enumeration, primal or with sub-solutions) from 1.2 times the
    shortest basis vector, or the dual SVP (shortest_vector_ex with
    SVP_DUAL, a FastEvaluator search)."""
    from fplll_tpu_torch.algs.svpcvp import shortest_vector_ex
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM, SVP_DUAL, SVPM_FAST
    from fplll_tpu_torch.enum.api import Enumeration
    from fplll_tpu_torch.nr.fctx import MPCtx

    d = bt.nrows
    prune = list(np.linspace(1.0, 0.5, d)) if pruned else []
    if walk == "dual":
        st, _, _, _ = shortest_vector_ex(bt.copy(), SVPM_FAST, prune,
                                         SVP_DUAL)
        assert st == 0
        return
    gso = MatGSO(bt.copy(), flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso.update_gso()
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.2
    ev = FastEvaluator(find_subsolutions=walk == "subsols")
    Enumeration(gso, ev).enumerate(0, d, A0, 0, pruning=prune)
    assert not ev.empty()


@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("walk", ["primal", "dual", "subsols"])
def test_facade_tree_dtype_follows_the_pruning(device_route, pruned, walk):
    """The facade (device_external_enumerator) runs an unpruned
    FastEvaluator search in f64 and a pruned one in f32, primal, dual or
    with sub-solutions."""
    before = dict(kernels.PLAIN_RUNS)
    facade(port_basis(), walk, pruned)
    form = kernels._form(F32 if pruned else F64, walk == "dual",
                         walk == "subsols")
    assert set(grown(before)) == {form}


@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("G", [1, 3])
def test_window_tree_dtype_follows_the_pruning(monkeypatch, pruned, G):
    """The C tour's window path: one window, or G trials of one window,
    runs f64 unpruned (one trial after another) and f32 pruned (G trials
    in the grouped launch)."""
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_GROUP_BATCH", "128")
    _, mut, rdiag, A, prune = small_window()
    d = len(rdiag)
    prunes = np.array([prune if pruned else np.ones(d)] * G)
    before = dict(kernels.PLAIN_RUNS)
    dists, _, _ = tdev.device_enumerate_windows(
        np.array([mut] * G), np.array([rdiag] * G), prunes,
        np.full(G, A), device="cpu")
    assert np.isfinite(dists).sum() == 1
    if not pruned:
        assert set(grown(before)) == {"f64"} and grown(before)["f64"] >= G
    else:
        assert set(grown(before)) == {"single" if G == 1 else "grouped"}


def test_grouped_launch_refuses_unpruned_trials():
    _, mut, rdiag, A, _ = small_window()
    d = len(rdiag)
    with pytest.raises(ValueError, match="pruned trials only"):
        tdev._grouped_device_windows(
            np.array([mut] * 2), np.array([rdiag] * 2), np.ones((2, d)),
            np.full(2, A), "cpu")


@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
def test_mesh_tree_dtype_follows_the_pruning(monkeypatch, pruned):
    """With a mesh visible (four CPU shards), the facade's sharded
    enumerator takes the same rule."""
    from fplll_tpu_torch.parallel import mesh as tmesh

    cpu_mesh = tmesh.make_enum_mesh(devices=["cpu"] * 4)
    monkeypatch.setattr(tdev, "_visible_mesh", lambda device: cpu_mesh)
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    monkeypatch.delenv("FPLLL_TPU_MESH", raising=False)
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 12)
    launches = tmesh.ShardedEnumerator.launches
    before = dict(kernels.PLAIN_RUNS)
    facade(port_basis(), "primal", pruned)
    assert tmesh.ShardedEnumerator.launches > launches
    assert set(grown(before)) == {"single" if pruned else "f64"}
