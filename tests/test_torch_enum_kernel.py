"""The port's enumeration kernel module against the JAX package.

`fplll_tpu_torch.enum.kernels` holds the CUDA kernel's launch wrappers
and their plain PyTorch versions. On CPU tensors the wrappers run the
plain version, which is held here against the JAX package's f32 XLA
kernel (`tpu._enum_run`) on the padded problems of
tests/test_pallas_parity.py:pad_problem: equal solution counts, best
distances within 1e-5 relative and per-level node counts equal (both
walk the same lockstep steps in the same f32 arithmetic). The CUDA
kernel's device code is also compiled for the host and run against the
plain version; tests/test_torch_cuda.py runs the kernel itself on a card.
"""

import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fplll_tpu.enum.tpu import TPUEnumerator, _enum_run
from fplll_tpu.jaxsetup import jnp
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.native import native_enumerate
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from test_pallas_parity import build, linear_pruning, run_pallas

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("mut", "rdiag", "prune", "mut_fix", "cp0", "rx", "rpd")


def pad_problem(mut, rdiag, prune, A, batch=128, root_factor=32):
    """The padding of tests/test_pallas_parity.py:pad_problem, with
    the root factor as a parameter: the recipe's 32 roots per lane leave
    these small trees almost entirely to the host expansion, 1 gives the
    kernel most of the tree."""
    d = len(rdiag)
    enum = TPUEnumerator(batch=batch, dtype=np.float32)
    enum.target_root_factor = root_factor
    enum.nodes = np.zeros(d, dtype=np.int64)
    roots_x, _, roots_pd, m_real = enum._gen_roots(
        mut, rdiag, prune, np.zeros(d), A, d, True)
    order = np.argsort(roots_pd)
    roots_x, roots_pd = roots_x[order], roots_pd[order]
    nfix = d - m_real
    m = ((m_real + 7) // 8) * 8
    mut_pad = np.zeros((m, m))
    mut_pad[:m_real, :m_real] = mut[:m_real, :m_real]
    rdiag_pad = np.full(m, 1e30)
    rdiag_pad[:m_real] = rdiag[:m_real]
    prune_pad = np.ones(m)
    prune_pad[:m_real] = prune[:m_real]
    nfix_pad = 8 if nfix else 0
    while nfix_pad < nfix:
        nfix_pad *= 2
    mut_fix_pad = np.zeros((m, nfix_pad))
    mut_fix_pad[:m_real, :nfix] = mut[:m_real, m_real:d]
    R_pad = 1024
    while R_pad < len(roots_pd):
        R_pad *= 2
    rx_pad = np.zeros((R_pad, nfix_pad))
    rpd_pad = np.full(R_pad, np.inf)
    rx_pad[:len(roots_pd), :nfix] = roots_x
    rpd_pad[:len(roots_pd)] = roots_pd
    return dict(mut=mut_pad, rdiag=rdiag_pad, prune=prune_pad,
                mut_fix=mut_fix_pad, cp0=np.zeros(m), rx=rx_pad,
                rpd=rpd_pad, A=A, m=m, m_real=m_real, host_nodes=enum.nodes)


def one_root_problem(mut, rdiag, prune, A):
    """The whole tree under one zero-length root (nfix = 0, the
    _chunk_call form): every walker but the one that pops it gets its
    work by donation."""
    d = len(rdiag)
    m = ((d + 7) // 8) * 8
    mut_pad = np.zeros((m, m))
    mut_pad[:d, :d] = mut
    rdiag_pad = np.full(m, 1e30)
    rdiag_pad[:d] = rdiag
    prune_pad = np.ones(m)
    prune_pad[:d] = prune
    return dict(mut=mut_pad, rdiag=rdiag_pad, prune=prune_pad,
                mut_fix=np.zeros((m, 0)), cp0=np.zeros(m),
                rx=np.zeros((1, 0)), rpd=np.zeros(1), A=A, m=m, m_real=d)


def run_jax(prob, count_mode, batch=128):
    args = tuple(jnp.asarray(prob[k], jnp.float32) for k in
                 ("mut", "rdiag", "prune", "mut_fix", "cp0", "rx", "rx",
                  "rpd")) + (jnp.asarray(prob["A"], jnp.float32),)
    s = _enum_run(*args, m=prob["m"], is_svp=True, count_mode=count_mode,
                  max_steps=1 << 24, batch=batch)
    return {"sols": int(np.asarray(s["sol_count"]).sum()),
            "best": float(np.asarray(s["best_dist"]).min()),
            "nodes": np.asarray(s["nodes"]).astype(np.int64)}


def tensors(prob, device="cpu"):
    return {k: torch.as_tensor(np.ascontiguousarray(prob[k]),
                               dtype=torch.float32, device=device)
            for k in FIELDS}


def run_port(prob, count_mode, batch=128):
    t = tensors(prob)
    s = kernels.enum_run(t["mut"], t["rdiag"], t["prune"], t["mut_fix"],
                         t["cp0"], t["rx"], t["rpd"], float(prob["A"]),
                         m=prob["m"], is_svp=True, count_mode=count_mode,
                         max_steps=1 << 24, batch=batch)
    return {"sols": int(s["sol_count"]), "best": float(s["best_dist"][0]),
            "nodes": s["nodes"].numpy(), "raw": s}


def assert_best(a, b, rel):
    if math.isinf(a) or math.isinf(b):
        assert a == b
    else:
        assert abs(a - b) <= rel * abs(b), (a, b)


def assert_counts(kn, pn, ks, ps, donations):
    """Count mode against the plain version: exactly equal where the
    launch donated nothing; else the tolerance of
    tests/test_pallas_parity.py:164-175 (equal solution counts, total
    nodes to 1%, levels above 200 nodes to 2%), since an adoptee
    re-derives the f32 center sums below the donated level that the
    stepwise walk carried through its round trips."""
    assert int(ks) == int(ps)
    if donations == 0:
        np.testing.assert_array_equal(kn, pn)
        return
    kn, pn = np.asarray(kn, np.float64), np.asarray(pn, np.float64)
    assert abs(kn.sum() - pn.sum()) <= 0.01 * pn.sum()
    for lvl, (a, b) in enumerate(zip(kn, pn)):
        if max(a, b) > 200:
            assert abs(a - b) <= 0.02 * max(a, b), (lvl, a, b)


CASES = [(d, pruned, factor) for d in (10, 16, 20, 24, 30)
         for pruned in (False, True) for factor in (32, 1)]


@pytest.mark.parametrize("d,pruned,root_factor", CASES)
def test_plain_matches_jax_xla_kernel(d, pruned, root_factor):
    prune = linear_pruning(d, d // 2) if pruned else None
    mut, rdiag, prune_v, A = build(d, 1, prune)
    prob = pad_problem(mut, rdiag, prune_v, A, root_factor=root_factor)
    plain_runs = kernels.PLAIN_RUNS["single"]
    for count_mode in (True, False):
        jx = run_jax(prob, count_mode)
        pt = run_port(prob, count_mode)
        assert pt["sols"] == jx["sols"]
        assert_best(pt["best"], jx["best"], 1e-5)
        np.testing.assert_array_equal(pt["nodes"], jx["nodes"])
    assert kernels.PLAIN_RUNS["single"] == plain_runs + 2
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("d,pruned", [(24, False), (30, False), (30, True)])
def test_count_mode_solutions_match_native_core(d, pruned):
    """Count mode: the solutions inside the radius, as the port's native C
    enumeration counts them over the whole tree."""
    prune = linear_pruning(d, d // 2) if pruned else None
    mut, rdiag, prune_v, A = build(d, 1, prune)
    for radius in (1.0, 1.2):
        prob = pad_problem(mut, rdiag, prune_v, A * radius, root_factor=1)
        pt = run_port(prob, True)
        ref = native_enumerate(mut, rdiag, prune_v, None, A * radius, True,
                               False, True)
        assert pt["sols"] == int(ref[3])
        assert pt["sols"] > 0 or pruned


def test_best_root_and_coordinates_reproduce_the_distance():
    """The K best lanes carry device coordinates and root coordinates whose
    norm is the reported distance."""
    d = 30
    mut, rdiag, prune_v, A = build(d, 1)
    prob = pad_problem(mut, rdiag, prune_v, A * 1.5, root_factor=1)
    raw = run_port(prob, False)["raw"]
    m_real = prob["m_real"]
    x = np.concatenate([raw["best_dev"][0].numpy()[:m_real],
                        raw["best_root"][0].numpy()[:d - m_real]])
    mu = mut.T           # mu[i, j] for j < i
    dist = sum(rdiag[k] * (x[k] + sum(mu[j, k] * x[j]
                                      for j in range(k + 1, d))) ** 2
               for k in range(d))
    assert abs(dist - float(raw["best_dist"][0])) <= 1e-4 * dist


def rerandomized_windows(d, G, seed=1):
    """G bases of one lattice (an LLL-reduced basis and G-1 unimodular
    rerandomizations, re-LLL-reduced): normalized (mu^T, r), the same
    absolute radius in each basis' scale, and each scale's exponent."""
    import random

    import fplll_tpu_torch as ft
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx

    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_uniform(d, 12)
    ft.lll_reduction(b)
    A_abs = min(sum(int(v) * int(v) for v in b.a[i]) for i in range(d)) \
        * 1.00001
    rng = random.Random(seed)
    muts, rdiags, maxds, exps = [], [], [], []
    for g in range(G):
        bb = b.copy()
        if g:
            for _ in range(3 * d):
                i, j = rng.randrange(d), rng.randrange(d)
                if i != j:
                    bb.a[i] = bb.a[i] + rng.choice((1, -1)) * bb.a[j]
            ft.lll_reduction(bb)
        gso = ft.MatGSO(bb, flags=GSO_INT_GRAM, ctx=MPCtx(80))
        gso.update_gso()
        mut, rdiag, normexp = gso.export_mu_r(0, d)
        muts.append(np.asarray(mut))
        rdiags.append(np.asarray(rdiag))
        maxds.append(math.ldexp(A_abs, -normexp))
        exps.append(normexp)
    return (np.stack(muts), np.stack(rdiags), np.ones((G, d)),
            np.asarray(maxds), np.asarray(exps))


def test_grouped_plain_matches_jax_per_trial_windows(monkeypatch):
    """Three bases of one unpruned lattice: the port's grouped launch (plain
    version, one shared bound carried across the problems) finds the same
    union best as the JAX package's per-trial window loop."""
    from fplll_tpu.enum import tpu as jtpu
    from fplll_tpu_torch.enum import device as tdev

    monkeypatch.setenv("FPLLL_TPU_GROUPED_LAUNCH", "0")
    monkeypatch.setenv("FPLLL_TPU_MESH_TRIALS", "0")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_GROUP_BATCH", "128")
    muts, rdiags, prunes, maxds, exps = rerandomized_windows(30, 3)
    jd, jsol, _ = jtpu.device_enumerate_windows(muts, rdiags, prunes, maxds)
    monkeypatch.delenv("FPLLL_TPU_GROUPED_LAUNCH")
    grouped = kernels.PLAIN_RUNS["grouped"]
    td, tsol, tnodes = tdev.device_enumerate_windows(muts, rdiags, prunes,
                                                     maxds, device="cpu")
    assert kernels.PLAIN_RUNS["grouped"] == grouped + 1
    j_abs = np.ldexp(jd, exps)
    t_abs = np.ldexp(td, exps)
    assert np.isfinite(t_abs).any() and tnodes > 0
    assert_best(float(t_abs.min()), float(j_abs.min()), 1e-5)
    # each finite trial's coordinates reproduce its distance
    d = muts.shape[1]
    for g in np.where(np.isfinite(td))[0]:
        mu, r, x = muts[g].T, rdiags[g], tsol[g]
        dist = sum(r[k] * (x[k] + sum(mu[j, k] * x[j]
                                      for j in range(k + 1, d))) ** 2
                   for k in range(d))
        assert abs(dist - td[g]) <= 1e-4 * td[g]


@pytest.mark.parametrize("grouped_launch", ["1", "0"])
def test_grouped_trials_in_different_scales(monkeypatch, grouped_launch):
    """The C tour normalizes each trial by its own power of two, so trials
    of one window can arrive in scales that differ by powers of 4. The
    trials run in one scale (the shared bound compares their distances)
    and only the best trial reports, in its own scale: rescaling trials
    by powers of 4 changes nothing but the reported number's scale."""
    from fplll_tpu_torch.enum import device as tdev

    monkeypatch.setenv("FPLLL_TPU_GROUPED_LAUNCH", grouped_launch)
    monkeypatch.setenv("FPLLL_TPU_GROUP_BATCH", "128")
    muts, rdiags, prunes, maxds, _ = rerandomized_windows(30, 3)
    ref, ref_sol, _ = tdev.device_enumerate_windows(muts, rdiags, prunes,
                                                    maxds, device="cpu")
    f = np.array([1.0, 4.0, 0.0625])
    out, sol, _ = tdev.device_enumerate_windows(
        muts, rdiags * f[:, None], prunes, maxds * f, device="cpu")
    assert np.isfinite(ref).sum() == 1 and np.isfinite(out).sum() == 1
    np.testing.assert_array_equal(out / f, ref)
    g = int(np.argmin(out))
    np.testing.assert_array_equal(sol[g], ref_sol[g])
    with pytest.raises(ValueError, match="one lattice"):
        tdev.device_enumerate_windows(muts, rdiags * [[1.0], [3.0], [1.0]],
                                      prunes, maxds, device="cpu")


def test_wrapper_rejects_mismatched_inputs():
    mut, rdiag, prune_v, A = build(16, 1)
    prob = pad_problem(mut, rdiag, prune_v, A)
    t = tensors(prob)
    t["A0"] = torch.full((1,), float(A))
    t["m_real"] = torch.full((1,), prob["m_real"], dtype=torch.int32)
    args = [t[k][None] for k in FIELDS] + [t["A0"], t["m_real"]]
    kw = dict(G_real=1, walkers=128, is_svp=True, count_mode=True,
              max_steps=1 << 20)
    kernels._prepare(*args, **kw)
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(ValueError, match="rdiag"):
        kernels._prepare(*bad, **kw)
    bad = list(args)
    bad[-1] = torch.full((1,), prob["m"] + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="m_real"):
        kernels._prepare(*bad, **kw)


# ---------------------------------------------------------------------------
# the CUDA kernel's device code, compiled for the host
# ---------------------------------------------------------------------------
WIDTHS = (8, 16, 32)       # the walker widths the source can be built with
EMU_THREADS = 64           # threads per emulated block
EMU_SRC = os.path.join(ROOT, "tests", "enum_chunk_host", "emulate.cpp")
EMU_FLAGS = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared",
             "-fPIC", "-I", os.path.dirname(EMU_SRC)]


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """build(width) compiles tests/enum_chunk_host/emulate.cpp, and with it
    csrc/enum_chunk.cu's device code, with the host compiler at that
    walker width (-DENUM_WIDTH; None: the source's own), once per width:
    one fiber per CUDA thread, all blocks resident, warp-synchronous
    shuffles, no FMA contraction, so the walk can be checked without a
    card."""
    libs = {}
    out = tmp_path_factory.mktemp("enum_chunk_host")

    def build(width=None):
        if width not in libs:
            so = str(out / f"libemu_{width or 'default'}.so")
            flags = [f"-DENUM_WIDTH={width}"] if width else []
            res = subprocess.run(EMU_FLAGS + flags + ["-o", so, EMU_SRC],
                                 capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            lib = ctypes.CDLL(so)
            lib.enum_chunk_emulate.restype = ctypes.c_int
            lib.enum_chunk_emulate.argtypes = [
                ctypes.POINTER(kernels._EnumParams), ctypes.c_int,
                ctypes.c_int]
            lib.enum_chunk_emulated_width.restype = ctypes.c_int
            libs[width] = lib
        return libs[width]
    return build


@pytest.fixture(scope="module")
def host_kernel(host_build):
    """The emulation at the source's own walker width, the card's."""
    return host_build()


def run_host_kernel(lib, t, A0, m_real, *, count_mode, G_real=1, grid=2):
    """One emulated launch over stacked problems (leading G axis) on
    `grid` blocks of EMU_THREADS threads, walkers as wide as `lib` was
    built."""
    walkers = grid * EMU_THREADS // lib.enum_chunk_emulated_width()
    p, out = kernels._prepare(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"], t["rx"],
        t["rpd"], A0, m_real, G_real=G_real, walkers=walkers, is_svp=True,
        count_mode=count_mode, max_steps=1 << 40)
    assert lib.enum_chunk_emulate(ctypes.byref(p), grid, EMU_THREADS) == 0
    out["walkers"] = walkers
    return out


def small_problem(d, pruned, m=None, one_root=False):
    """The d-dimensional window of tests/test_pallas_parity.py with its
    roots at root factor 1 (or, with `one_root`, the whole tree under one
    root), and its stacked (G = 1) tensors; `m` pads the height to
    another bucket."""
    prune = linear_pruning(d, d // 2) if pruned else None
    mut, rdiag, prune_v, A = build(d, 1, prune)
    if one_root:
        prob = one_root_problem(mut, rdiag, prune_v, A)
    else:
        prob = pad_problem(mut, rdiag, prune_v, A, root_factor=1)
    if m is not None:
        m0 = prob["m"]
        for k, fill in (("mut", 0.0), ("rdiag", 1e30), ("prune", 1.0),
                        ("mut_fix", 0.0), ("cp0", 0.0)):
            a = prob[k]
            shape = (m, m) if k == "mut" else (m,) + a.shape[1:]
            b = np.full(shape, fill)
            b[tuple(slice(0, n) for n in a.shape)] = a
            prob[k] = b
        prob["m"] = m
        assert m > m0
    t = {k: v[None] for k, v in tensors(prob).items()}
    return prob, t


@pytest.mark.parametrize("d,pruned", [(24, False), (30, False), (30, True)])
def test_host_compiled_kernel_matches_plain(host_kernel, d, pruned):
    """Count mode: per-level node counts equal the plain version's exactly
    (the kernel repeats the stepwise walk's f32 arithmetic). Search mode:
    the same best distance; walkers share the bound asynchronously, so
    node counts may differ slightly."""
    prob, t = small_problem(d, pruned)
    A0 = float(np.float32(prob["A"]))
    mr = torch.full((1,), prob["m_real"], dtype=torch.int32)
    for count_mode in (True, False):
        ref = run_port(prob, count_mode)
        out = run_host_kernel(host_kernel, t, torch.full((1,), A0), mr,
                              count_mode=count_mode)
        res = kernels._finalize_single(out, t["rx"][0], A0,
                                       count_mode=count_mode,
                                       walkers=out["walkers"],
                                       max_steps=1 << 40)
        assert int(res["sol_count"]) == ref["sols"]
        assert_best(float(res["best_dist"][0]), ref["best"], 1e-6)
        kn = res["nodes"].numpy()[:prob["m_real"]]
        pn = ref["nodes"][:prob["m_real"]]
        if count_mode:
            assert_counts(kn, pn, res["sol_count"], ref["sols"],
                          int(res["donations"]))
        else:
            assert abs(int(kn.sum()) - int(pn.sum())) <= 0.01 * pn.sum()
    # the whole tree under one root: the other walkers work by donation
    prob, t = small_problem(d, pruned, one_root=True)
    pn, ps = plain_counts(d, pruned, one_root=True)
    out = run_host_kernel(host_kernel, t, torch.full((1,), A0),
                          torch.full((1,), d, dtype=torch.int32),
                          count_mode=True)
    assert int(out["donations"]) > 0
    assert_counts(out["nodes"].numpy()[0, :d], pn, out["sols"][0], ps,
                  int(out["donations"]))


_PLAIN_COUNTS = {}


def plain_counts(d, pruned, one_root=False):
    """(per-level nodes below m_real, solution count) of the plain
    version in count mode, once per problem; with `one_root`, of the
    whole tree: the host expansion's nodes above m_real."""
    if (d, pruned) not in _PLAIN_COUNTS:
        prob, _ = small_problem(d, pruned)
        ref = run_port(prob, True)
        mr = prob["m_real"]
        _PLAIN_COUNTS[d, pruned] = (ref["nodes"][:mr], ref["sols"],
                                    np.asarray(prob["host_nodes"])[mr:d])
    nodes, sols, host = _PLAIN_COUNTS[d, pruned]
    return (np.concatenate([nodes, host]) if one_root else nodes), sols


def emulated_counts(lib, prob, t, *, G_real=1, grid):
    """(per-level nodes below m_real per problem, solution counts,
    donations) of one emulated count-mode launch."""
    A0 = torch.full((t["mut"].shape[0],), float(np.float32(prob["A"])))
    mr = torch.full((t["mut"].shape[0],), prob["m_real"], dtype=torch.int32)
    out = run_host_kernel(lib, t, A0, mr, count_mode=True, G_real=G_real,
                          grid=grid)
    assert int(out["aborted"]) == 0
    assert 0 < int(out["root_steps"]) <= int(out["steps"]) <= \
        int(out["walk_steps"])
    return out["nodes"].numpy()[:, :prob["m_real"]], out["sols"].numpy(), \
        int(out["donations"])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("d,pruned", [(24, False), (24, True), (30, False),
                                      (30, True)])
def test_host_compiled_counts_exact_at_any_grid_and_width(
        host_build, d, pruned, grid, width):
    """Count mode at every walker width the source can be built with and
    at a grid of 1 and of 3 blocks, on the root queue and on the whole
    tree under one root: per-level node counts and the solution count
    equal the plain version's exactly where the launch donated nothing
    (a root's walk is the same f32 arithmetic whichever walker takes
    it), else to the Pallas kernel's tolerance; the one-root tree
    donates."""
    for one_root in (False, True):
        pn, ps = plain_counts(d, pruned, one_root)
        prob, t = small_problem(d, pruned, one_root=one_root)
        kn, ks, don = emulated_counts(host_build(width), prob, t, grid=grid)
        assert_counts(kn[0], pn, ks[0], ps, don)
    assert don > 0


@pytest.mark.parametrize("m", [40, 128])
def test_host_compiled_counts_exact_in_every_height_bucket(host_build, m):
    """The d = 30 tree padded to the M = 64 and M = 128 buckets (levels
    above m_real are bucket padding, which neither the walk nor a
    donation enters): the counts of the M = 32 run, on the root queue
    and under one root, which donates."""
    for one_root in (False, True):
        pn, ps = plain_counts(30, False, one_root)
        prob, t = small_problem(30, False, m=m, one_root=one_root)
        for width in WIDTHS:
            kn, ks, don = emulated_counts(host_build(width), prob, t, grid=2)
            assert_counts(kn[0], pn, ks[0], ps, don)
    assert don > 0


def test_host_compiled_counts_exact_from_global_memory(host_build):
    """Four real problems of height 128 do not fit in shared memory
    (4 x 67 KB), so the kernel reads mu, rdiag and prune from global
    memory; walkers move from problem to problem as queues drain, and
    donations carry their problem (eight walkers: four start idle on the
    one-root trees), and each problem's counts are the single problem's,
    on the root queue and under one root."""
    for one_root in (False, True):
        pn, ps = plain_counts(30, True, one_root)
        prob, t = small_problem(30, True, m=128, one_root=one_root)
        t4 = {k: v.expand(4, *v.shape[1:]).contiguous() for k, v in t.items()}
        kn, ks, don = emulated_counts(host_build(16), prob, t4, G_real=4,
                                      grid=2)
        for g in range(4):
            assert_counts(kn[g], pn, ks[g], ps, don)
    assert don > 0


def test_host_compiled_kernel_stops_at_the_step_cap(host_kernel):
    """A walker past max_steps (checked every 32 iterations) sets the
    abort flag, and the finalize raises instead of returning a partial
    count; also where the walkers donate (the whole tree under one root)
    and an idle walker must leave on the flag."""
    assert host_kernel.enum_chunk_emulated_width() == 32
    for one_root in (False, True):
        prob, t = small_problem(30, False, one_root=one_root)
        A0 = float(np.float32(prob["A"]))
        a0 = torch.full((1,), A0)   # held: the struct keeps only pointers
        mr = torch.full((1,), prob["m_real"], dtype=torch.int32)
        p, out = kernels._prepare(
            t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"],
            t["rx"], t["rpd"], a0, mr, G_real=1, walkers=2, is_svp=True,
            count_mode=True, max_steps=64)
        assert host_kernel.enum_chunk_emulate(ctypes.byref(p), 1,
                                              EMU_THREADS) == 0
        assert int(out["aborted"]) == 1 and int(out["steps"]) == 96
        assert (int(out["donations"]) > 0) == one_root
        with pytest.raises(RuntimeError, match="max_steps"):
            kernels._finalize_single(out, t["rx"][0], A0, count_mode=True,
                                     walkers=2, max_steps=64)


def test_host_emulation_refuses_a_geometry_the_source_lacks(host_kernel):
    """The source builds only at walker widths 8, 16 and 32 (a static
    assertion), and a launch whose walker count, grid or block does not
    match the geometry is refused."""
    for width in (4, 64):
        res = subprocess.run(EMU_FLAGS + [
            "-fsyntax-only", f"-DENUM_WIDTH={width}", EMU_SRC],
            capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert "walker width: 8, 16 or 32 threads" in res.stderr
    prob, t = small_problem(24, False)
    A0 = torch.full((1,), float(np.float32(prob["A"])))
    mr = torch.full((1,), prob["m_real"], dtype=torch.int32)
    for walkers, grid, threads in ((1, 1, EMU_THREADS), (2, 0, EMU_THREADS),
                                   (1, 1, 48), (64, 1, 2048)):
        p, _ = kernels._prepare(
            t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"],
            t["rx"], t["rpd"], A0, mr, G_real=1, walkers=walkers,
            is_svp=True, count_mode=True, max_steps=1 << 40)
        assert host_kernel.enum_chunk_emulate(ctypes.byref(p), grid,
                                              threads) == 1


def test_host_compiled_grouped_kernel_matches_plain(host_build):
    """Grouped form: four problems (three bases of one lattice and one
    padding problem) in one launch share the bound; the union best equals
    the plain grouped version's, and padding problems never write it, nor
    receive a donated sibling range."""
    from fplll_tpu_torch.enum.device import _pack_grouped

    muts, rdiags, prunes, maxds, _ = rerandomized_windows(30, 3)
    t, _, _ = _pack_grouped(muts, rdiags, prunes, maxds,
                            torch.device("cpu"), 128)
    plain = kernels.enum_run_grouped_plain(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"],
        t["roots_x"], t["roots_pd"], t["A0"], G_real=3, batch=128,
        is_svp=True, max_steps=1 << 30)
    tt = {"mut": t["mut"], "rdiag": t["rdiag"], "prune": t["prune"],
          "mut_fix": t["mut_fix"], "cp0": t["cp0"], "rx": t["roots_x"],
          "rpd": t["roots_pd"]}
    out = run_host_kernel(host_build(16), tt, t["A0"], t["m_real"],
                          count_mode=False, G_real=3, grid=3)
    res = kernels._finalize_grouped(out, t["roots_x"], t["A0"],
                                    walkers=out["walkers"],
                                    max_steps=1 << 40)
    assert_best(float(res["dist"].min()), float(plain["dist"].min()), 1e-6)
    assert math.isfinite(float(res["dist"].min()))
    assert math.isinf(float(res["dist"][3]))       # the padding problem
    assert float(out["bound"][0]) == float(res["dist"].min())
    assert float(res["bound"]) == float(res["dist"].min())
    assert float(plain["bound"]) == float(plain["dist"].min())
    # three copies of a one-root tree and a padding problem, in count
    # mode: walkers of one problem donate to walkers of any real problem,
    # each real problem counts its whole tree, the padding one nothing
    pn, ps = plain_counts(30, False, one_root=True)
    prob, t1 = small_problem(30, False, one_root=True)
    t4 = {k: v.expand(4, *v.shape[1:]).contiguous() for k, v in t1.items()}
    a0 = torch.tensor([float(np.float32(prob["A"]))] * 3 + [0.0])
    mr = torch.full((4,), prob["m_real"], dtype=torch.int32)
    out = run_host_kernel(host_build(16), t4, a0, mr, count_mode=True,
                          G_real=3, grid=3)
    assert int(out["donations"]) > 0
    for g in range(3):
        assert_counts(out["nodes"].numpy()[g], pn, out["sols"][g], ps,
                      int(out["donations"]))
    assert int(out["nodes"][3].sum()) == 0 and int(out["sols"][3]) == 0


# ---------------------------------------------------------------------------
# against the Pallas kernel in interpret mode (slow)
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("d,seed,pruned", [(34, 2, False), (40, 3, True)])
def test_plain_matches_pallas_interpret(d, seed, pruned):
    """The tolerances of tests/test_pallas_parity.py: the Pallas kernel's
    barren lookahead skips an f32 subtract/restore round trip, so marginal
    bound tests may flip at ULP level."""
    prune = linear_pruning(d, d // 2) if pruned else None
    mut, rdiag, prune_v, A = build(d, seed, prune)
    prob = pad_problem(mut, rdiag, prune_v, A)
    host = np.zeros(prob["m"])
    pal = run_pallas({k: prob[k] for k in ("mut", "rdiag", "prune",
                                           "mut_fix", "cp0", "rx", "rpd",
                                           "A", "m")}, host)
    pt = run_port(prob, True)
    assert pt["sols"] == pal["sols"]
    assert_best(pt["best"], pal["best"], 1e-4)
    tot_p, tot_t = pal["nodes"].sum(), pt["nodes"].sum()
    assert abs(tot_t - tot_p) <= 0.01 * tot_p
    for lvl in range(prob["m"]):
        a, b = pal["nodes"][lvl], pt["nodes"][lvl]
        if max(a, b) > 200:
            assert abs(a - b) <= 0.02 * max(a, b), (lvl, a, b)


@pytest.mark.slow
def test_grouped_plain_matches_pallas_grouped_interpret(monkeypatch,
                                                        tmp_path):
    """The two-basis grouped case of tests/test_pallas.py: the JAX
    package's grouped Pallas launch (interpret mode) and the port's
    grouped plain version find the brute-force minimum."""
    import test_pallas

    env = dict(os.environ)
    env.update({"FPLLL_TPU_PALLAS_INTERPRET": "1",
                "FPLLL_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
                "FPLLL_TPU_GROUP_BATCH": "128",
                "FPLLL_TPU_GROUP_ROOT_FACTOR": "2"})
    script = test_pallas._GROUPED_SCRIPT.replace(
        'print("RESULT "', 'np.savez(PROBS, muts=muts, rdiags=rdiags, '
        'prunes=prunes, maxd=maxd)\nprint("RESULT "').replace(
        "import json\n", "import json, sys\nPROBS = sys.argv[1]\n", 1)
    probs = str(tmp_path / "grouped.npz")
    res = subprocess.run([sys.executable, "-c", script, probs],
                         capture_output=True, text=True, timeout=900,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    jax_out = json.loads(line[len("RESULT "):])
    with np.load(probs) as f:
        muts, rdiags, prunes, maxd = (f[k] for k in ("muts", "rdiags",
                                                     "prunes", "maxd"))
    from fplll_tpu_torch.enum import device as tdev
    monkeypatch.setenv("FPLLL_TPU_GROUP_BATCH", "128")
    monkeypatch.setenv("FPLLL_TPU_GROUP_ROOT_FACTOR", "2")
    dists, _, nodes = tdev.device_enumerate_windows(muts, rdiags, prunes,
                                                    maxd, device="cpu")
    assert abs(float(np.min(dists)) - jax_out["brute"]) < 1e-4
    assert abs(float(np.min(dists)) - min(jax_out["dists"])) < 1e-4
    assert nodes > 0
