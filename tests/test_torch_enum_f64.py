"""The port's f64, dual and sub-solution trees against the JAX package.

`fplll_tpu_torch.enum.kernels.enum_run` takes float32 or float64 tensors,
the dual recurrence (`dual`, with the alpha values of the roots in
`roots_a`) and the per-level sub-solution records (`findsubsols`). On CPU
tensors it runs its plain version, held here against the JAX package's
XLA kernel `tpu._enum_run` in the same dtype: per-level node counts and
solution counts exactly equal, best distances bit-equal, the sub-solution
records equal per level. Both walk the same lockstep steps in the same
arithmetic, and both expand the roots with the same C code
(jax_reference.py). The plain f64 primal form walks with the
barren-descend lookahead, as the f32 primal form does and the CUDA
kernel's primal instances do; tpu._enum_run has none, and its counts are
matched step for step (a barren node's sibling step takes the lockstep
step of its failing child). The CUDA source's f64 primal and extended
instances are compiled for the host and held against the plain version;
`DeviceEnumerator` against
`TPUEnumerator`, including the deep-tree search for trees taller than the
kernel; and the plain f64 tree against the JAX package's TPU stand-in for
f64 (compensated f32 pairs, `dd_kernel._enum_run_dd`).
"""

import ctypes
import math
import os

import numpy as np
import pytest
import torch

from fplll_tpu.enum.evaluator import FastEvaluator as JaxFastEvaluator
from fplll_tpu.enum.tpu import TPUEnumerator, _enum_run
from fplll_tpu.jaxsetup import jnp
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.enum.device import DeviceEnumerator
from fplll_tpu_torch.enum.evaluator import FastEvaluator
from fplll_tpu_torch.native import native_enumerate
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from test_pallas_parity import build, linear_pruning
from test_torch_enum_kernel import (EMU_THREADS, WIDTHS,  # noqa: F401
                                    host_build)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
KEYS = ("mut", "rdiag", "prune", "mut_fix", "cp0", "rx", "ra", "rpd")


def dual_transform(mut, rdiag):
    """(mu, r) of the dual tree: reversed and inverted, as the facades
    transform a block for dual enumeration (enumerate.cpp:98-121)."""
    return np.triu(-(mut.T)[::-1, ::-1], 1), (1.0 / rdiag)[::-1].copy()


def problem(d, pruned, dual, radius=1.0, seed=1):
    """A padded single problem of the d-dimensional window of
    tests/test_pallas_parity.py at root factor 1 (128 roots for 128
    lanes): the primal tree at `radius` times the shortest basis vector,
    or the dual tree at `radius` times the longest 1/r_ii (a dual vector
    of that length exists). Padding: rdiag 1e300, roots pd inf."""
    prune = linear_pruning(d, d // 2) if pruned else None
    mut, rdiag, prune_v, A = build(d, seed, prune)
    A *= radius
    if dual:
        mut, rdiag = dual_transform(mut, rdiag)
        A = 1.00001 * float(rdiag.max()) * radius
    e = TPUEnumerator(batch=128, dtype=np.float64)
    e.target_root_factor = 1
    e.nodes = np.zeros(d, dtype=np.int64)
    rx, ra, rpd, m_real = e._gen_roots(mut, rdiag, prune_v, np.zeros(d), A,
                                       d, True, dual=dual)
    o = np.argsort(rpd)
    rx, ra, rpd = rx[o], ra[o], rpd[o]
    nfix, m = d - m_real, ((m_real + 7) // 8) * 8
    P = dict(mut=np.zeros((m, m)), rdiag=np.full(m, 1e300), prune=np.ones(m),
             cp0=np.zeros(m))
    P["mut"][:m_real, :m_real] = mut[:m_real, :m_real]
    P["rdiag"][:m_real] = rdiag[:m_real]
    P["prune"][:m_real] = prune_v[:m_real]
    nfp = 8 if nfix else 0
    while nfp < nfix:
        nfp *= 2
    P["mut_fix"] = np.zeros((m, nfp))
    P["mut_fix"][:m_real, :nfix] = mut[:m_real, m_real:d]
    R = 1024
    while R < len(rpd):
        R *= 2
    P["rx"], P["ra"] = np.zeros((R, nfp)), np.zeros((R, nfp))
    P["rpd"] = np.full(R, np.inf)
    P["rx"][:len(rpd), :nfix], P["ra"][:len(rpd), :nfix] = rx, ra
    P["rpd"][:len(rpd)] = rpd
    return dict(P=P, A=A, m=m, m_real=m_real, d=d, mu=mut, r=rdiag,
                prune=prune_v, host_nodes=np.asarray(e.nodes))


def one_root(prob):
    """The problem's whole tree under one zero-length root (nfix = 0):
    every walker but the one that pops it gets its work by donation."""
    d = prob["d"]
    m = ((d + 7) // 8) * 8
    P = dict(mut=np.zeros((m, m)), rdiag=np.full(m, 1e300), prune=np.ones(m),
             cp0=np.zeros(m), mut_fix=np.zeros((m, 0)), rx=np.zeros((1, 0)),
             ra=np.zeros((1, 0)), rpd=np.zeros(1))
    P["mut"][:d, :d] = prob["mu"]
    P["rdiag"][:d] = prob["r"]
    P["prune"][:d] = prob["prune"]
    return dict(prob, P=P, m=m, m_real=d)


def as_dtype(prob, dtype):
    """The problem's arrays in `dtype`, with the f32 rdiag sentinel
    where the padding must stay representable (tpu.py:642-643), and the
    bound with the dtype's slack (tpu.py:389-390)."""
    P = {k: np.array(v) for k, v in prob["P"].items()}
    if dtype == F32:
        P["rdiag"][prob["m_real"]:] = 1e30
    slack = 1.0 + 1e-5 if dtype == F32 else 1.0
    return P, prob["A"] * slack


def run_jax(prob, dtype, *, dual, findsubsols, count_mode):
    P, A0 = as_dtype(prob, dtype)
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    s = _enum_run(*[jnp.asarray(P[k], jdt) for k in KEYS],
                  jnp.asarray(A0, jdt), m=prob["m"], is_svp=True,
                  count_mode=count_mode, max_steps=1 << 24, batch=128,
                  dual=dual, findsubsols=findsubsols)
    return {k: np.asarray(v) for k, v in s.items()}


def port_tensors(prob, dtype):
    P, A0 = as_dtype(prob, dtype)
    return {k: torch.as_tensor(P[k], dtype=dtype) for k in KEYS}, A0


def run_plain(prob, dtype, *, dual, findsubsols, count_mode, ext=False):
    """The plain version of the form, or (`ext`) of the extended
    instance's f64 primal walk, without the lookahead."""
    t, A0 = port_tensors(prob, dtype)
    run = kernels._enum_run_extended if ext else kernels.enum_run
    return run(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"], t["rx"],
        t["rpd"], A0, m=prob["m"], is_svp=True, count_mode=count_mode,
        max_steps=1 << 24, batch=128, roots_a=t["ra"], dual=dual,
        findsubsols=findsubsols)


def partial_dist(x, mu, r, k, dual):
    """sum_{i >= k} r_i alpha_i^2 of the full coordinates x, recomputed in
    f64: alpha_i = x_i - c_i, c_i = -sum_{j > i} w_j mu[i, j] with w = x
    (primal) or alpha (the dual recurrence)."""
    d = len(x)
    alpha = np.zeros(d)
    dist = 0.0
    for i in range(d - 1, k - 1, -1):
        w = alpha if dual else x
        c = -float(np.dot(w[i + 1:], mu[i, i + 1:]))
        alpha[i] = x[i] - c
        dist += r[i] * alpha[i] ** 2
    return dist


def check_subsol_records(prob, out, dtype, dual):
    """Every record that fell below its start value r_kk is a passing
    node: its coordinates (device levels from the record, fixed levels
    from its root) give back its distance."""
    mr, d = prob["m_real"], prob["d"]
    rel = 1e-12 if dtype == F64 else 1e-5
    seen = 0
    for k in range(mr):
        dist = float(out["subsol_dist"][k])
        vec = np.asarray(out["subsol_vec"][k], dtype=np.float64)[:mr]
        root = np.asarray(out["subsol_root"][k], dtype=np.float64)[:d - mr]
        x = np.concatenate([vec, root])
        if not np.any(x):
            assert dist == float(prob["P"]["rdiag"][k]) or dtype == F32
            continue
        seen += 1
        assert np.all(x[:k] == 0)
        true = partial_dist(x, prob["mu"], prob["r"], k, dual)
        assert abs(true - dist) <= rel * true, (k, true, dist)
    assert seen > 0


# the sub-solution records of the two packages agree to an ulp, not
# bit for bit: XLA on the CPU may contract the reference's record
# distance (a separate expression from its bound test) into an FMA, which
# moves a record by one ulp while every bound test and count stays equal
RECORD_RTOL = {F64: 1e-12, F32: 1e-6}

# (d, pruned, radius) of the primal and of the dual trees; the unpruned
# ones hold solutions inside their bound, the linear pruning of
# test_pallas_parity.py cuts them all away
PROBLEMS = [(20, False, 1.3), (24, True, 1.6)]
EMU_PROBLEM = (24, False, 1.3)
_PROBS = {}


def cached_problem(d, pruned, radius, dual):
    key = (d, pruned, radius, dual)
    if key not in _PROBS:
        _PROBS[key] = problem(d, pruned, dual, radius)
    return _PROBS[key]


# the (dtype, dual, findsubsols, case) of test_plain_matches_jax_enum_run
# whose best distance the lookahead moves by an ulp: a skipped descend
# skips the subtract/restore round trip of the center sums, and under the
# dual recurrence the subtracted alpha_k * mu is not exact, so
# fl(fl(a - t) + t) == a does not hold everywhere. Their counts stay
# exactly equal; the best distance is held to RECORD_RTOL, well inside the
# Pallas tolerance (tests/test_pallas_parity.py:164-175, 1e-4)
ULP_DRIFT_CASES = {(F32, True, False, 0), (F64, True, False, 1)}


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("findsubsols", [False, True],
                         ids=["", "subsols"])
@pytest.mark.parametrize("case", [0, 1])
def test_plain_matches_jax_enum_run(dtype, dual, findsubsols, case):
    """Count and search mode: exactly equal per-level node counts and
    solution counts, bit-equal best distances (to RECORD_RTOL on the
    ULP_DRIFT_CASES), and in count mode the sub-solution records equal per
    level to RECORD_RTOL (their vectors may differ on ties), each valid to
    1e-12 relative in f64 (1e-5 in f32). Every form but the combined one
    (dual with sub-solutions, the extended instance's) skips barren
    descends here, where tpu._enum_run descends and restores; no skipped
    round trip moves a bound test in these cases, so their counts are
    exact too, not only within the Pallas tolerance
    (tests/test_pallas_parity.py:164-175) that such a round trip could
    need."""
    prob = cached_problem(*PROBLEMS[case], dual)
    form = kernels._form(dtype, dual, findsubsols)
    runs = kernels.PLAIN_RUNS[form]
    drift = (dtype, dual, findsubsols, case) in ULP_DRIFT_CASES
    for count_mode in (True, False):
        kw = dict(dual=dual, findsubsols=findsubsols, count_mode=count_mode)
        jx = run_jax(prob, dtype, **kw)
        pt = run_plain(prob, dtype, **kw)
        np.testing.assert_array_equal(pt["nodes"].numpy(),
                                      jx["nodes"].astype(np.int64))
        assert int(pt["sol_count"]) == int(jx["sol_count"].sum())
        pb, jb = float(pt["best_dist"][0]), float(jx["best_dist"].min())
        assert pb == jb or (drift and abs(pb - jb) <= RECORD_RTOL[dtype] * jb)
        if count_mode and not PROBLEMS[case][1]:
            assert int(pt["sol_count"]) > 0
        assert (pt["barren_skips"] > 0) == (not (dual and findsubsols))
        if findsubsols:
            mr = prob["m_real"]
            if count_mode:
                np.testing.assert_allclose(pt["subsol_dist"].numpy()[:mr],
                                           jx["subsol_dist"][:mr],
                                           rtol=RECORD_RTOL[dtype])
            check_subsol_records(prob, pt, dtype, dual)
    assert kernels.PLAIN_RUNS[form] == runs + 2
    assert sum(kernels.LAUNCHES.values()) == 0


def test_wrapper_form_names():
    assert kernels._form(F32, False, False) == "single"
    assert kernels._form(F64, False, False) == "f64"
    assert kernels._form(F32, True, True) == "f32-dual-subsols"
    assert set(kernels.LAUNCHES) == set(kernels.FORMS) == \
        set(kernels.PLAIN_RUNS)


def test_wrapper_rejects_mixed_dtypes():
    prob = cached_problem(*PROBLEMS[0], False)
    t, A0 = port_tensors(prob, F64)
    a = [t[k][None] for k in ("mut", "rdiag", "prune", "mut_fix", "cp0",
                               "rx", "rpd")]
    kw = dict(G_real=1, walkers=4, is_svp=True, count_mode=True,
              max_steps=1 << 20)
    mr = torch.full((1,), prob["m_real"], dtype=torch.int32)
    kernels._prepare(*a, torch.full((1,), A0, dtype=F64), mr, **kw)
    with pytest.raises(ValueError, match="A0"):
        kernels._prepare(*a, torch.full((1,), A0), mr, **kw)
    with pytest.raises(ValueError, match="roots_a"):
        kernels._prepare(*a, torch.full((1,), A0, dtype=F64), mr,
                         roots_a=t["ra"][None].float(), **kw)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels._prepare(*[v.half() for v in a],
                         torch.full((1,), A0).half(), mr, **kw)


# ---------------------------------------------------------------------------
# the new instances of the CUDA source, compiled for the host
# ---------------------------------------------------------------------------
def run_host(lib, prob, dtype, *, dual, findsubsols, count_mode, grid,
             ext=False):
    t, A0 = port_tensors(prob, dtype)
    t = {k: v[None].contiguous() for k, v in t.items()}
    a0 = torch.full((1,), A0, dtype=dtype)
    mr = torch.full((1,), prob["m_real"], dtype=torch.int32)
    walkers = grid * EMU_THREADS // lib.enum_chunk_emulated_width()
    p, out = kernels._prepare(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"], t["rx"],
        t["rpd"], a0, mr, G_real=1, walkers=walkers, is_svp=True,
        count_mode=count_mode, max_steps=1 << 40, roots_a=t["ra"],
        dual=dual, findsubsols=findsubsols, ext=ext)
    assert lib.enum_chunk_emulate(ctypes.byref(p), grid, EMU_THREADS) == 0
    return kernels._finalize_single(out, t["rx"][0], A0,
                                    count_mode=count_mode, walkers=walkers,
                                    max_steps=1 << 40)


def ref_nodes(prob, dtype, dual, ext=False):
    return run_plain(prob, dtype, dual=dual, findsubsols=False,
                     count_mode=True, ext=ext)["nodes"].numpy()


def ref_sols(prob, dtype, dual):
    return int(run_plain(prob, dtype, dual=dual, findsubsols=False,
                         count_mode=True)["sol_count"])


# (element type, dual, sub-solutions, extended instance by name): each
# form of the proved solvers on the instance it launches (the f64 primal,
# dual and sub-solution instances; the combined form on the extended
# one), and the same trees on the extended instance by name
EXT_FORMS = [(F64, False, False, False), (F64, False, False, True),
             (F64, True, False, False), (F64, True, False, True),
             (F64, False, True, False), (F64, False, True, True),
             (F64, True, True, False), (F32, True, False, False),
             (F32, True, False, True), (F32, False, True, False),
             (F32, False, True, True)]


def ext_form_id(dtype, dual, findsubsols, ext):
    return kernels._form(dtype, dual, findsubsols) + ("-extended" if ext
                                                      else "")


@pytest.mark.parametrize("dtype,dual,findsubsols,ext", EXT_FORMS,
                         ids=[ext_form_id(*f) for f in EXT_FORMS])
@pytest.mark.parametrize("width,grid", [(32, 1), (16, 3)])
def test_host_compiled_extended_instances_match_plain(
        host_build, dtype, dual, findsubsols, ext, width, grid):
    """Count mode: per-level node counts, the solution count and the
    sub-solution distances equal the plain version's exactly where the
    launch donated nothing (the walk repeats its arithmetic; level 0's
    record comes out of the absorbed leaf range), else counts to the
    Pallas kernel's tolerance and records to RECORD_RTOL. Search mode:
    the same best distance (unique here). The whole tree under one root
    donates, with the same counts and best as the root queue. Each form
    runs on its own instance, with the lookahead (the combined form on
    the extended instance, without it), and by name on the extended
    instance, without it, each against its own plain walk."""
    from test_torch_enum_kernel import assert_counts

    prob = cached_problem(*EMU_PROBLEM, dual)
    lib = host_build(width)
    mr = prob["m_real"]
    for count_mode in (True, False):
        kw = dict(dual=dual, findsubsols=findsubsols, count_mode=count_mode)
        ref = run_plain(prob, dtype, ext=ext, **kw)
        out = run_host(lib, prob, dtype, grid=grid, ext=ext, **kw)
        assert (int(out["barren_skips"]) > 0) == \
            (kernels._walk(dual, findsubsols, ext) != kernels.WALK_EXT)
        don = int(out["donations"])
        assert float(out["best_dist"][0]) == float(ref["best_dist"][0])
        if count_mode:
            assert_counts(out["nodes"].numpy()[:mr], ref["nodes"].numpy()[:mr],
                          out["sol_count"], ref["sol_count"], don)
            assert int(out["sol_count"]) > 0
            if findsubsols:
                np.testing.assert_allclose(
                    out["subsol_dist"].numpy()[:mr],
                    ref["subsol_dist"].numpy()[:mr],
                    rtol=0 if don == 0 else RECORD_RTOL[dtype])
        if findsubsols:
            check_subsol_records(prob, out, dtype, dual)
    one = run_host(lib, one_root(prob), dtype, grid=grid, dual=dual,
                   findsubsols=False, count_mode=True, ext=ext)
    assert int(one["donations"]) > 0
    full = np.concatenate([ref_nodes(prob, dtype, dual, ext)[:mr],
                           prob["host_nodes"][mr:]])
    assert_counts(one["nodes"].numpy(), full, one["sol_count"],
                  ref_sols(prob, dtype, dual), int(one["donations"]))


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("width", WIDTHS)
def test_host_compiled_f64_primal_instance_matches_plain(host_build, width,
                                                         grid):
    """The f64 primal instance (enum_chunk_f64_kernel) at every walker
    width and at grids 1 and 3, on the d = 24 window at 1.3 times its
    shortest vector (128 roots): count mode's per-level nodes and
    solutions the plain f64 form's, exactly where the launch donated
    nothing, else to the Pallas tolerance, and the same on the extended
    instance against its own plain walk; the primal instance skips
    barren descends, the extended one none, and the walk without the
    skips takes more iterations. Search mode: the best distance of both
    instances bit-equal to the plain version's."""
    from test_torch_enum_kernel import assert_counts

    prob = cached_problem(*EMU_PROBLEM, False)
    lib = host_build(width)
    mr = prob["m_real"]
    runs = {}
    for ext in (False, True):
        for count_mode in (True, False):
            kw = dict(dual=False, findsubsols=False, count_mode=count_mode)
            ref = run_plain(prob, F64, ext=ext, **kw)
            out = run_host(lib, prob, F64, grid=grid, ext=ext, **kw)
            assert float(out["best_dist"][0]) == float(ref["best_dist"][0])
            assert (int(out["barren_skips"]) > 0) == (not ext)
            if count_mode:
                assert_counts(out["nodes"].numpy()[:mr],
                              ref["nodes"].numpy()[:mr], out["sol_count"],
                              ref["sol_count"], int(out["donations"]))
                assert int(out["sol_count"]) > 0
                runs[ext] = out
    assert int(runs[False]["walk_steps"]) < int(runs[True]["walk_steps"])


# ---------------------------------------------------------------------------
# DeviceEnumerator against TPUEnumerator
# ---------------------------------------------------------------------------
def window(d, seed, radius, dual):
    from test_torch_device import window as primal_window
    _, mut, rdiag, normexp, A = primal_window(d, seed, radius)
    if dual:
        mut, rdiag = dual_transform(mut, rdiag)
        A = 1.00001 * float(rdiag.max()) * radius
    return mut, rdiag, A


# the forms whose reported best distance the lookahead moves by an ulp
# on test_enumerator_matches_jax_enumerator's tree (ULP_DRIFT_CASES'
# reason); the coordinates and the counts stay equal
ENUMERATOR_ULP_DRIFT = {"f64-dual"}


@pytest.mark.parametrize("dtype,dual,findsubsols",
                         [(F64, False, False), (F64, True, False),
                          (F64, False, True), (F32, True, True)],
                         ids=["f64", "f64-dual", "f64-subsols",
                              "f32-dual-subsols"])
def test_enumerator_matches_jax_enumerator(dtype, dual, findsubsols,
                                           monkeypatch):
    """One d = 24 tree through both enumerators (root factor 1, 128
    lanes): the same best coordinates and distance (to RECORD_RTOL in the
    ENUMERATOR_ULP_DRIFT forms), the same per-level nodes, and the same
    sub-solution distances (to RECORD_RTOL), device levels and
    host-expanded levels alike."""
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    d = 24
    mut, rdiag, A = window(d, 1, 1.3, dual)
    ev_j = JaxFastEvaluator(find_subsolutions=findsubsols)
    ej = TPUEnumerator(batch=128, dtype=jnp.float64 if dtype == F64
                       else jnp.float32)
    ej.target_root_factor = 1
    ej.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_j, dual=dual)

    ev_t = FastEvaluator(find_subsolutions=findsubsols)
    et = DeviceEnumerator(batch=128, target_root_factor=1, device="cpu",
                          dtype=dtype)
    form = kernels._form(dtype, dual, findsubsols)
    runs = kernels.PLAIN_RUNS[form]
    et.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_t, dual=dual)
    assert kernels.PLAIN_RUNS[form] == runs + 1

    assert not ev_t.empty()
    assert list(ev_t.begin()[1]) == list(ev_j.begin()[1])
    bt, bj = ev_t.begin()[0], ev_j.begin()[0]
    assert bt == bj or (form in ENUMERATOR_ULP_DRIFT and
                        abs(bt - bj) <= RECORD_RTOL[dtype] * bj)
    np.testing.assert_array_equal(et.nodes, ej.nodes)
    if findsubsols:
        t_ss = [(dist, list(v)) for dist, v in ev_t.sub_solutions]
        j_ss = [(dist, list(v)) for dist, v in ev_j.sub_solutions]
        np.testing.assert_allclose([s[0] for s in t_ss],
                                   [s[0] for s in j_ss],
                                   rtol=RECORD_RTOL[dtype])
        assert sum(1 for _, v in t_ss if v) > 0


def qary_gh_problem(d=36, seed=21):
    """The dim-36 q-ary problem of tests/test_enum.py's deep-tree test at
    1.1 times its Gaussian heuristic."""
    import fplll_tpu_torch as ft
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.nr.fctx import MPCtx

    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_qary_bits(d, d // 2, 10)
    ft.lll_reduction(b)
    gso = ft.MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(70))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, d)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag)
    log_ball = d / 2 * math.log(math.pi) - math.lgamma(d / 2 + 1)
    gh2 = math.exp(float(np.mean(np.log(rdiag))) - 2.0 * log_ball / d)
    return mut, rdiag, 1.1 * gh2


def test_deep_chunked_expansion_matches_native_core():
    """The port of tests/test_enum.py's chunked deep-tree test: a kernel
    height of 16 under a dim-36 tree sends it through _deep_enumerate
    (bounded host frontier, one launch per slice, the bound carried
    across slices); the f64 tree counts the C core's solutions and finds
    its best distance."""
    d = 36
    mut, rdiag, A = qary_gh_problem(d)
    ref = native_enumerate(mut, rdiag, None, None, A, True, False, True)
    runs = kernels.PLAIN_RUNS["f64"]
    enum = DeviceEnumerator(batch=128, max_device_levels=16, device="cpu",
                            dtype=F64)
    enum.deep_hard_cap = 4096     # a frontier cap that forces the slices
    ev = FastEvaluator()
    enum.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev,
                   count_mode=True)
    assert ev.sol_count == ref[3] > 0
    assert enum._deep_slices > 0
    assert kernels.PLAIN_RUNS["f64"] == runs + enum._deep_slices

    ref = native_enumerate(mut, rdiag, None, None, A, True, False, False)
    enum2 = DeviceEnumerator(batch=128, max_device_levels=16, device="cpu",
                             dtype=F64)
    enum2.deep_hard_cap = 4096
    ev2 = FastEvaluator()
    enum2.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev2)
    assert not ev2.empty()
    assert abs(ev2.begin()[0] - ref[1]) <= 1e-9 * ref[1]


@pytest.mark.slow
def test_deep_tree_solution_through_chunked_path():
    """The port of tests/test_enum.py's test of the same name: a dim-110
    profile whose shortest vectors are single +-1 coordinates in the top
    12 levels, far above a kernel height of 48, with a small frontier cap:
    the answer (distance exactly 1) survives slicing, re-expansion and the
    carried bound."""
    d, mdl = 110, 48
    mut = np.eye(d)
    rdiag = np.full(d, 50.0)
    rdiag[d - 12:] = 1.0
    rdiag[:mdl] = 1000.0
    enum = DeviceEnumerator(batch=128, max_device_levels=mdl, device="cpu",
                            dtype=F64)
    enum.deep_hard_cap = 2048
    ev = FastEvaluator(nr_solutions=1)
    enum.enumerate(mut, rdiag, None, np.zeros(d), 9.05, True, ev)
    assert enum._deep_slices > 0
    assert not ev.empty()
    dist, x = ev.begin()
    assert abs(dist - 1.0) < 1e-9, dist
    nz = [i for i, v in enumerate(x) if round(v) != 0]
    assert nz and all(i >= d - 12 for i in nz), nz


# ---------------------------------------------------------------------------
# the plain f64 tree against the TPU's compensated f32-pair tree
# ---------------------------------------------------------------------------
def dd_case(d, seed, radius, count_mode):
    """(port f64 evaluator and enumerator, JAX dd32 evaluator and
    enumerator) on the window of tests/test_dd_kernel.py."""
    from test_dd_kernel import run_kernel, setup

    b, gso = setup(d, seed)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * radius
    ev_dd, en_dd = run_kernel(gso, d, A0, "dd32", count_mode=count_mode)
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    ev = FastEvaluator()
    ev.set_normexp(normexp)
    if count_mode:
        ev.eval_mode = 1
    en = DeviceEnumerator(batch=128, device="cpu", dtype=F64)
    en.enumerate(np.asarray(mut), np.asarray(rdiag), None, np.zeros(d),
                 math.ldexp(A0, -normexp), True, ev, count_mode=count_mode)
    return b, (ev, en), (ev_dd, en_dd)


@pytest.mark.parametrize("d,seed", [(16, 2), (24, 1), (30, 5)])
def test_plain_f64_matches_dd_kernel_solution(d, seed):
    """tests/test_dd_kernel.py's solution cases: the same shortest
    vector's norm."""
    from test_dd_kernel import exact_norm

    b, (ev, _), (ev_dd, _) = dd_case(d, seed, 1.00001, False)
    assert not ev.empty() and not ev_dd.empty()
    assert exact_norm(b, ev.begin()[1]) == exact_norm(b, ev_dd.begin()[1])


@pytest.mark.parametrize("d,seed", [(20, 3), (26, 4)])
def test_plain_f64_matches_dd_kernel_counts(d, seed):
    """tests/test_dd_kernel.py's count cases: the same solution count and
    per-level nodes."""
    _, (ev, en), (ev_dd, en_dd) = dd_case(d, seed, 1.2, True)
    assert ev.sol_count == ev_dd.sol_count > 0
    np.testing.assert_array_equal(en.nodes, en_dd.nodes)
