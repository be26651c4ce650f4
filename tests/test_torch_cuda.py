"""The CUDA enumeration kernel on a card, against its plain version, the
pruner's gradient kernel against its plain version on the card and on CPU
tensors, and the device GSO on the card against CPU tensors.

Every test here needs a CUDA card and skips without one (the kernel has
no CPU build; tests/test_torch_enum_kernel.py checks its device code
compiled for the host). This file imports only the port, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from fplll_tpu_torch.algs.wrapper import lll_reduction
from fplll_tpu_torch.core.gso import MatGSO
from fplll_tpu_torch.defs import GSO_INT_GRAM
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.enum.device import DeviceEnumerator, _pack_grouped
from fplll_tpu_torch.nr.fctx import MPCtx
from fplll_tpu_torch.nr.rng import RandGen
from fplll_tpu_torch.ops import gen

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def window(d, seed, pruned=False, radius=1.0):
    """An LLL-reduced gen_uniform window, normalized (mu^T, r), a mild
    linear pruning taper and the squared radius radius * min ||b_i||^2
    (the recipe of tests/test_pallas_parity.py)."""
    RandGen.init_with_seed(seed)
    b = gen.gen_uniform(d, 12)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso.update_gso()
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.00001
    prune = np.ones(d)
    if pruned:
        for i in range(d // 2, d):
            prune[d - 1 - i] = max((d - i) / float(d), 0.6)
    return np.asarray(mut), np.asarray(rdiag), prune, \
        math.ldexp(A0 * radius, -normexp)


def packed(mut, rdiag, prune, A, device, root_factor=16):
    d = len(rdiag)
    enum = DeviceEnumerator(batch=1024, target_root_factor=root_factor,
                            device=device)
    enum.nodes = np.zeros(d, dtype=np.int64)
    rx, _, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d), A, d,
                                      True)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real)
    pack["A0"] = A * enum.bound_slack
    return pack


def assert_best(a, b):
    if math.isinf(a) or math.isinf(b):
        assert a == b
    else:
        assert abs(a - b) <= 1e-6 * abs(b), (a, b)


def assert_counts(k, pn, ps, mr):
    """Count mode, a kernel result against the plain version's per-level
    nodes and solutions: exactly equal where the launch donated nothing,
    else the tolerance of tests/test_pallas_parity.py:164-175 (an adoptee
    re-derives the center sums below its level, which the stepwise walk
    carried through its round trips)."""
    kn = k["nodes"].cpu().numpy()[:mr]
    pn = np.asarray(pn)[:mr]
    assert int(k["sol_count"]) == int(ps)
    if int(k["donations"]) == 0:
        np.testing.assert_array_equal(kn, pn)
        return
    kn, pn = kn.astype(np.float64), pn.astype(np.float64)
    assert abs(kn.sum() - pn.sum()) <= 0.01 * pn.sum()
    for lvl in range(mr):
        if max(kn[lvl], pn[lvl]) > 200:
            assert abs(kn[lvl] - pn[lvl]) <= 0.02 * max(kn[lvl], pn[lvl])


@pytest.mark.parametrize("d,seed,pruned", [(30, 1, False), (40, 3, True),
                                           (40, 3, False)])
def test_single_problem_kernel_matches_plain(card, d, seed, pruned):
    pack = packed(*window(d, seed, pruned), card)
    mr = pack["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    for count_mode in (True, False):
        kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                  max_steps=1 << 30)
        launches = kernels.LAUNCHES["single"]
        k = kernels.enum_run(**pack, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["single"] == launches + 1
        p = kernels.enum_run_plain(**plain_args, **kw)
        assert int(k["sol_count"]) == int(p["sol_count"])
        assert_best(float(k["best_dist"][0]), float(p["best_dist"][0]))
        kn = k["nodes"].cpu().numpy()[:mr]
        pn = p["nodes"].cpu().numpy()[:mr]
        if count_mode:
            assert_counts(k, pn, p["sol_count"], mr)
        else:
            assert abs(int(kn.sum()) - int(pn.sum())) <= 0.01 * pn.sum()


def test_single_root_form_matches_plain(card):
    """nfix = 0: the whole tree under one root (the TPU's _chunk_call),
    spread over the card's walkers by donation."""
    mut, rdiag, prune, A = window(24, 1)
    enum = DeviceEnumerator(batch=1024, device=card)
    pack = enum._pack(mut, rdiag, prune, np.zeros(24), 24, np.zeros((1, 0)),
                      np.zeros(1), 24)
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    k = kernels.enum_run(**pack, A0=A, **kw)
    p = kernels.enum_run_plain(**{k2: v for k2, v in pack.items()
                                  if k2 != "m_real"}, A0=A, **kw)
    assert int(k["donations"]) > 0
    assert_counts(k, p["nodes"].cpu().numpy(), p["sol_count"], 24)
    assert int(k["sol_count"]) > 0


def earlier_launch(enum, mut, rdiag, prune, A, dual):
    """The launch inputs the pipeline before the staging buffer built for
    one search of `enum`, on the CPU: the C expansion, a stable
    np.argsort, _pack_tree and the float64 pad, torch.as_tensor to the
    tree's dtype (tests/test_torch_root_queue.py holds the staging to it
    on CPU tensors)."""
    from fplll_tpu_torch.native import native_gen_roots

    d = len(rdiag)
    xs, als, pd, m_real, _ = native_gen_roots(
        mut, rdiag, prune, np.zeros(d), A, True, dual,
        enum.max_device_levels, enum.target_root_factor * enum.batch)
    order = np.argsort(pd, kind="stable")
    tree = enum._pack_tree(mut, rdiag, prune, np.zeros(d), d, m_real)
    tree.pop("m")
    nfix_pad = tree.pop("nfix_pad")
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
    return {k: torch.as_tensor(np.ascontiguousarray(a), dtype=enum.dtype)
            for k, a in host.items()}


def test_back_to_back_queues_arrive_whole(card):
    """Four launches' inputs staged one right after another on the card,
    each while the copy of the one before still waits behind a busy
    stream: a wide f32 queue, a narrow one, an f64 tree and a dual one.
    Each arrives as the earlier pipeline builds it, tensor for tensor:
    the staging buffer is written again only once the copy out of it has
    ended."""
    cases = [((56, 1, True), 32, torch.float32, False),
             ((40, 3, True), 1, torch.float32, False),
             ((40, 3, False), 16, torch.float64, False),
             ((40, 3, True), 16, torch.float32, True)]
    staged, want = [], []
    for (d, seed, pruned), factor, dtype, dual in cases:
        mut, rdiag, prune, A = window(d, seed, pruned)
        enum = DeviceEnumerator(batch=1024, target_root_factor=factor,
                                device=card, dtype=dtype)
        enum.nodes = np.zeros(d, dtype=np.int64)
        rx, ra, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d),
                                              A, d, True, dual=dual)
        staged.append((enum, (mut, rdiag, prune, np.zeros(d), d, rx, rpd,
                              m_real), ra if dual else None))
        want.append(earlier_launch(enum, mut, rdiag, prune, A, dual))
    torch.cuda.synchronize()
    got = []
    for enum, args, roots_a in staged:
        # the copy that _pack enqueues waits behind this on the stream,
        # about 25 ms, while the next _pack writes its inputs
        torch.cuda._sleep(50_000_000)
        got.append(enum._pack(*args, roots_a=roots_a))
    torch.cuda.synchronize()
    rows = [int(torch.isfinite(w["roots_pd"]).sum()) for w in want]
    assert rows[0] > 32768 > rows[1] >= 1024
    for pack, ref in zip(got, want):
        assert set(ref) <= set(pack) and ("roots_a" in pack) == \
            ("roots_a" in ref)
        for k, t in ref.items():
            assert pack[k].device.type == "cuda", k
            assert torch.equal(pack[k].cpu(), t), k


def test_grouped_kernel_matches_plain(card):
    """Three bases of one lattice and one padding problem in one launch:
    the union best equals the plain grouped version's, and the padding
    problem finds nothing."""
    import random

    RandGen.init_with_seed(3)
    d = 36
    b = gen.gen_uniform(d, 12)
    lll_reduction(b)
    A_abs = min(sum(int(v) * int(v) for v in b.a[i]) for i in range(d)) \
        * 1.00001
    rng = random.Random(5)
    muts, rdiags, maxds = [], [], []
    for g in range(3):
        bb = b.copy()
        if g:
            for _ in range(3 * d):
                i, j = rng.randrange(d), rng.randrange(d)
                if i != j:
                    bb.a[i] = bb.a[i] + rng.choice((1, -1)) * bb.a[j]
            lll_reduction(bb)
        gso = MatGSO(bb, flags=GSO_INT_GRAM, ctx=MPCtx(80))
        gso.update_gso()
        mut, rdiag, normexp = gso.export_mu_r(0, d)
        muts.append(np.asarray(mut))
        rdiags.append(np.asarray(rdiag))
        maxds.append(math.ldexp(A_abs, -normexp))
    t, _, _ = _pack_grouped(np.stack(muts), np.stack(rdiags),
                            np.ones((3, d)), np.asarray(maxds), card, 1024)
    kw = dict(G_real=3, batch=1024, is_svp=True, max_steps=1 << 30)
    launches = kernels.LAUNCHES["grouped"]
    k = kernels.enum_run_grouped(**t, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped"] == launches + 1
    p = kernels.enum_run_grouped_plain(
        **{k2: v for k2, v in t.items() if k2 != "m_real"}, **kw)
    assert_best(float(k["dist"].min()), float(p["dist"].min()))
    assert math.isfinite(float(k["dist"].min()))
    assert math.isinf(float(k["dist"][3]))


def test_counts_identical_at_any_grid(card):
    """One count-mode problem on the persistent grid (blocks per SM times
    SMs) and on a grid of one block: the same per-level node counts and
    solution counts, exactly where neither launch donated, else to the
    Pallas kernel's tolerance (tests/test_torch_enum_kernel.py holds the
    emulated kernel to this at every walker width the source can be
    built with, and tests/test_torch_donation.py to exact counts on
    dyadic trees)."""
    pack = packed(*window(40, 3), card)
    mr = pack["m_real"]
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    full = kernels.enum_run(**pack, **kw)
    one = kernels.enum_run(**pack, **kw, grid=1)
    geo = full["geometry"]
    assert geo["width"] == 32 and geo["grid"] == \
        geo["blocks_per_sm"] * geo["sms"]
    assert one["geometry"]["grid"] == 1
    donated = int(full["donations"]) + int(one["donations"])
    assert_counts(dict(full, donations=donated),
                  one["nodes"].cpu().numpy(), one["sol_count"], mr)


def dyadic_tree(d, seed):
    """tests/test_torch_donation.py's tree whose walk is exact in f32: mu
    in sixteenths of [-1/2, 1/2], rdiag powers of two from 4 to 1/4, the
    bound its Gaussian heuristic rounded up to eighths."""
    rng = np.random.default_rng(seed)
    mut = np.triu(rng.integers(-8, 9, (d, d)) / 16.0, 1)
    rdiag = np.ldexp(1.0, np.round(np.linspace(2, -2, d)).astype(int))
    gh = math.exp(float(np.mean(np.log(rdiag))) +
                  2 * math.lgamma(d / 2 + 1) / d) / math.pi
    return mut, rdiag, np.ones(d), math.ceil(8 * gh) / 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["single", "f64"])
def test_dyadic_tree_counts_exact_with_donation(card, dtype):
    """The whole dyadic d = 28 tree under one root, spread over the
    card's walkers by donation, with the lookahead of both primal
    instances (f32 and f64): every round trip is exact, so per-level
    nodes and solutions equal the plain version's on the root queue plus
    the host expansion's exactly, at the persistent grid and at one
    block."""
    d = 28
    mut, rdiag, prune, A = dyadic_tree(d, 1)
    enum = DeviceEnumerator(batch=1024, target_root_factor=1, device=card,
                            dtype=dtype)
    enum.nodes = np.zeros(d, dtype=np.int64)
    rx, _, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d), A,
                                         d, True)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real)
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    p = kernels.enum_run_plain(**{k: v for k, v in pack.items()
                                  if k != "m_real"}, A0=A, **kw)
    full = np.concatenate([p["nodes"].cpu().numpy()[:m_real],
                           enum.nodes[m_real:]])
    one = enum._pack(mut, rdiag, prune, np.zeros(d), d, np.zeros((1, 0)),
                     np.zeros(1), d)
    for grid in (0, 1):
        k = kernels.enum_run(**one, A0=A, **kw, grid=grid)
        assert int(k["donations"]) > 0
        np.testing.assert_array_equal(k["nodes"].cpu().numpy()[:d], full)
        assert int(k["sol_count"]) == int(p["sol_count"]) > 0
        assert int(k["barren_skips"]) > 0


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    pack = packed(*window(30, 1), card)
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    bad = dict(pack, rdiag=pack["rdiag"].double())
    with pytest.raises(ValueError, match="rdiag"):
        kernels.enum_run(**bad, **kw)
    bad = dict(pack, mut=pack["mut"].t())
    with pytest.raises(ValueError, match="mut"):
        kernels.enum_run(**bad, **kw)


# ---------------------------------------------------------------------------
# the f64, dual and sub-solution instances
# ---------------------------------------------------------------------------
EXT_FORMS = [(torch.float64, False, False), (torch.float32, True, False),
             (torch.float64, True, False), (torch.float32, False, True),
             (torch.float64, False, True), (torch.float32, True, True),
             (torch.float64, True, True)]


def ext_packed(d, seed, dtype, dual, device, radius=1.3):
    """The window at `radius` (primal), or its dual tree at `radius` times
    the longest 1/r_ii, packed as DeviceEnumerator packs it in `dtype`
    (the roots' alpha values ride along for dual)."""
    mut, rdiag, prune, A = window(d, seed, radius=radius)
    if dual:
        mut = np.triu(-(mut.T)[::-1, ::-1], 1)
        rdiag = (1.0 / rdiag)[::-1].copy()
        A = 1.00001 * float(rdiag.max()) * radius
    enum = DeviceEnumerator(batch=1024, target_root_factor=16, device=device,
                            dtype=dtype)
    enum.nodes = np.zeros(d, dtype=np.int64)
    rx, ra, rpd, m_real = enum._gen_roots(mut, rdiag, prune, np.zeros(d), A,
                                          d, True, dual=dual)
    pack = enum._pack(mut, rdiag, prune, np.zeros(d), d, rx, rpd, m_real,
                      ra if dual else None)
    pack["A0"] = A * enum.bound_slack
    return pack


@pytest.mark.parametrize("dtype,dual,findsubsols", EXT_FORMS,
                         ids=[kernels._form(*f) for f in EXT_FORMS])
def test_extended_instances_match_plain(card, dtype, dual, findsubsols):
    """Count mode: per-level node counts, the solution count and the
    sub-solution distances equal the plain version's, at the persistent
    grid and at one block: exactly where the launch donated nothing, else
    to the Pallas kernel's tolerance (records to 1e-12 in f64, 1e-6 in
    f32). Search mode: the same best distance."""
    pack = ext_packed(30, 1, dtype, dual, card)
    mr = pack["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    form = kernels._form(dtype, dual, findsubsols)
    for count_mode in (True, False):
        kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                  max_steps=1 << 30, dual=dual, findsubsols=findsubsols)
        launches = kernels.LAUNCHES[form]
        k = kernels.enum_run(**pack, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[form] == launches + 1
        p = kernels.enum_run_plain(**plain_args, **kw)
        assert float(k["best_dist"][0]) == float(p["best_dist"][0])
        assert math.isfinite(float(k["best_dist"][0]))
        if not count_mode:
            continue
        runs = [k, kernels.enum_run(**pack, **kw, grid=1)]
        for r in runs:
            assert_counts(r, p["nodes"].cpu().numpy(), p["sol_count"], mr)
            assert int(r["sol_count"]) > 0
            if findsubsols:
                np.testing.assert_allclose(
                    r["subsol_dist"].cpu().numpy()[:mr],
                    p["subsol_dist"].cpu().numpy()[:mr],
                    rtol=0 if int(r["donations"]) == 0 else
                    (1e-12 if dtype == torch.float64 else 1e-6))


def test_f64_tree_on_both_f64_instances(card):
    """The d = 30 f64 primal tree on the f64 primal instance (enum_run)
    and on the extended one (kernels._enum_run_extended): each against
    the plain version, count mode to the Pallas tolerance where it
    donated, both searches' best distance the plain version's to 1e-12;
    only the primal instance skips barren descends; the primal instance
    runs at least two blocks per SM at M = 32, and no fewer walkers than
    the extended one."""
    pack = ext_packed(30, 1, torch.float64, False, card)
    mr = pack["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    before = (kernels.LAUNCHES["f64"], kernels.EXTENDED["launches"]["f64"])
    for count_mode in (True, False):
        kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                  max_steps=1 << 30)
        p = kernels.enum_run_plain(**plain_args, **kw)
        new = kernels.enum_run(**pack, **kw)
        old = kernels._enum_run_extended(**pack, **kw)
        for r in (new, old):
            b = float(p["best_dist"][0])
            assert abs(float(r["best_dist"][0]) - b) <= 1e-12 * b
            if count_mode:
                assert_counts(r, p["nodes"].cpu().numpy(), p["sol_count"],
                              mr)
        assert int(new["barren_skips"]) > 0 == int(old["barren_skips"])
    assert (kernels.LAUNCHES["f64"], kernels.EXTENDED["launches"]["f64"]) == \
        (before[0] + 2, before[1] + 2)
    assert new["geometry"]["blocks_per_sm"] >= 2
    assert new["geometry"]["walkers"] >= old["geometry"]["walkers"]


# (dtype, dual, sub-solutions) of the forms whose instance is the dual,
# the sub-solution or the combined walk
WALK_FORMS = [(torch.float32, True, False), (torch.float64, True, False),
              (torch.float32, False, True), (torch.float64, False, True),
              (torch.float32, True, True), (torch.float64, True, True)]


@pytest.mark.parametrize("dtype,dual,findsubsols", WALK_FORMS,
                         ids=[kernels._form(*f) for f in WALK_FORMS])
def test_tree_on_both_designs(card, dtype, dual, findsubsols):
    """The d = 30 tree of a dual, sub-solution or combined form on its own
    instance (enum_run: enum_chunk_dual_kernel, enum_chunk_subsols_kernel
    or enum_chunk_dual_subsols_kernel) and on the extended one
    (kernels._enum_run_extended): each against the plain version, count
    mode to the Pallas tolerance where it donated and the sub-solution
    distances to 1e-12 in f64 (1e-6 in f32) there, both searches' best
    distance the plain version's to that tolerance; only the new
    instance skips barren descends; it runs no fewer walkers than the
    extended one, and each launch counts where it should."""
    pack = ext_packed(30, 1, dtype, dual, card)
    mr = pack["m_real"]
    plain_args = {k: v for k, v in pack.items() if k != "m_real"}
    form = kernels._form(dtype, dual, findsubsols)
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    before = (kernels.LAUNCHES[form], kernels.EXTENDED["launches"][form])
    for count_mode in (True, False):
        kw = dict(is_svp=True, count_mode=count_mode, batch=1024,
                  max_steps=1 << 30, dual=dual, findsubsols=findsubsols)
        p = kernels.enum_run_plain(**plain_args, **kw)
        new = kernels.enum_run(**pack, **kw)
        old = kernels._enum_run_extended(**pack, **kw)
        for r in (new, old):
            b = float(p["best_dist"][0])
            assert abs(float(r["best_dist"][0]) - b) <= rtol * b
            if count_mode:
                assert_counts(r, p["nodes"].cpu().numpy(), p["sol_count"],
                              mr)
                if findsubsols:
                    np.testing.assert_allclose(
                        r["subsol_dist"].cpu().numpy()[:mr],
                        p["subsol_dist"].cpu().numpy()[:mr], rtol=rtol)
        assert int(new["barren_skips"]) > 0 == int(old["barren_skips"])
    assert (kernels.LAUNCHES[form], kernels.EXTENDED["launches"][form]) == \
        (before[0] + 2, before[1] + 2)
    assert new["geometry"]["walkers"] >= old["geometry"]["walkers"]


@pytest.mark.parametrize("M", [32, 64, 128])
def test_walk_instances_geometry(card, M):
    """The launcher's persistent grid for the dual, sub-solution and
    combined instances of both element types and for the extended one at
    height bucket M: at least one block per SM each, and at least two for
    the f64 dual and f64 combined instances at M <= 64 (the f64 primal
    instance's bound)."""
    for dtype in (torch.float32, torch.float64):
        geo = {walk: kernels._geometry(M, 1, dtype, walk) for walk in (
            kernels.WALK_DUAL, kernels.WALK_SUBSOLS,
            kernels.WALK_DUAL_SUBSOLS, kernels.WALK_EXT)}
        assert all(g["blocks_per_sm"] >= 1 for g in geo.values()), geo
        if dtype == torch.float64 and M <= 64:
            assert geo[kernels.WALK_DUAL]["blocks_per_sm"] >= 2, geo
            assert geo[kernels.WALK_DUAL_SUBSOLS]["blocks_per_sm"] >= 2, \
                geo


@pytest.mark.parametrize("d", [10, 20, 30])
def test_pruner_gradient_on_card_matches_cpu(card, d):
    """The pruner's analytic gradient (torch.autograd, f64) on the card
    against the same on CPU tensors, both metrics, norm-relative: about
    100 times what an H100 measured at d = 30 (1.17e-11 and 9.4e-13), the
    d where the recurrence cancels most; tests/test_torch_pruner.py's
    looser per-d tolerances hold the port against jaxgrad."""
    from fplll_tpu_torch.defs import (PRUNER_METRIC_EXPECTED_SOLUTIONS,
                                      PRUNER_METRIC_PROBABILITY_OF_SHORTEST)
    from fplll_tpu_torch.pruner import torchgrad
    from fplll_tpu_torch.pruner.pruner import Pruner

    tol = {PRUNER_METRIC_PROBABILITY_OF_SHORTEST: 1e-9,
           PRUNER_METRIC_EXPECTED_SOLUTIONS: 1e-10}
    n = 2 * d
    r = [math.exp(-4 * math.log(1.012) * i) for i in range(n)]
    gh = math.exp(sum(math.log(x) for x in r) / n - 2 * (
        (n / 2) * math.log(math.pi) - math.lgamma(n / 2 + 1)) / n)
    for metric, target in ((PRUNER_METRIC_PROBABILITY_OF_SHORTEST, 0.5),
                           (PRUNER_METRIC_EXPECTED_SOLUTIONS, 1.0)):
        p = Pruner(1.1 * gh, 1e10, r, target, metric)
        b = np.linspace(0.3, 1.0, d)
        p.enforce(b)
        g_card = torchgrad.gradient(p, b, device=card)
        g_cpu = torchgrad.gradient(p, b, device="cpu")
        err = np.linalg.norm(g_card - g_cpu) / np.linalg.norm(g_cpu)
        assert err <= tol[metric], (metric, err)


def pruner_input(d, metric, flags=0):
    """The profile of test_pruner_gradient_on_card_matches_cpu with flags
    (SVP or CVP): (pruner, b, packed kernel input, consts)."""
    from fplll_tpu_torch.defs import PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    from fplll_tpu_torch.pruner import torchgrad
    from fplll_tpu_torch.pruner.pruner import Pruner

    n = 2 * d
    r = [math.exp(-4 * math.log(1.012) * i) for i in range(n)]
    gh = math.exp(sum(math.log(x) for x in r) / n - 2 * (
        (n / 2) * math.log(math.pi) - math.lgamma(n / 2 + 1)) / n)
    prob = metric == PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    p = Pruner(1.1 * gh, 1e10, r, 0.5 if prob else 1.0, metric, flags)
    b = np.linspace(0.3, 1.0, d)
    p.enforce(b)
    consts = (metric, float(p.symmetry_factor), float(p.shell_ratio))
    inp = torchgrad.pack(b, p.ipv[:n], float(p.normalized_radius),
                         float(p.target), float(p.preproc_cost), metric)
    return p, b, torch.from_numpy(inp), consts


PRUNER_KERNEL_TOL = {"prob": 1e-9, "expsol": 1e-10}


@pytest.mark.parametrize("flags", [0, 1], ids=["svp", "cvp"])
@pytest.mark.parametrize("d", [2, 5, 10, 20, 30])
def test_pruner_kernel_matches_plain_on_card(card, d, flags):
    """pruner_grad_kernel against the plain version (torch.autograd) on the
    card and on CPU tensors, both metrics, norm-relative: chip_smoke.py's
    GRAD30_TOL (the two plain versions differ by about 1e-11 at d = 30,
    and the emulated kernel is within 2e-12 of the CPU one)."""
    from fplll_tpu_torch.defs import (PRUNER_CVP,
                                      PRUNER_METRIC_EXPECTED_SOLUTIONS,
                                      PRUNER_METRIC_PROBABILITY_OF_SHORTEST)
    from fplll_tpu_torch.pruner import torchgrad

    for metric, label in ((PRUNER_METRIC_PROBABILITY_OF_SHORTEST, "prob"),
                          (PRUNER_METRIC_EXPECTED_SOLUTIONS, "expsol")):
        _, _, inp, consts = pruner_input(d, metric,
                                         PRUNER_CVP if flags else 0)
        k = torchgrad.log_target_and_grad(inp.to(card), d, *consts).cpu()
        for ref in (torchgrad.log_target_and_grad_plain(inp.to(card), d,
                                                        *consts).cpu(),
                    torchgrad.log_target_and_grad(inp, d, *consts)):
            err = float(torch.linalg.norm(k[1:] - ref[1:]) /
                        torch.linalg.norm(ref[1:]))
            assert err <= PRUNER_KERNEL_TOL[label], (label, err)
            assert abs(float(k[0] - ref[0])) <= 1e-12 * abs(float(ref[0]))


def test_pruner_kernel_same_bits_one_launch_a_call(card):
    """Two gradients of one input are the same bits (no atomics: the rows'
    contributions are summed in a fixed order), and each gradient on the
    card, through torchgrad.gradient and through the pruner's descent, is
    one launch of the kernel."""
    from fplll_tpu_torch.defs import PRUNER_METRIC_PROBABILITY_OF_SHORTEST
    from fplll_tpu_torch.pruner import torchgrad

    p, b, _, _ = pruner_input(30, PRUNER_METRIC_PROBABILITY_OF_SHORTEST)
    p.device = card
    n0 = torchgrad.LAUNCHES
    g1 = torchgrad.gradient(p, b, device=card)
    g2 = torchgrad.gradient(p, b, device=card)
    assert torchgrad.LAUNCHES == n0 + 2
    assert g1.tobytes() == g2.tobytes()
    g3 = p._gradient(b.copy())
    assert torchgrad.LAUNCHES == n0 + 3
    assert g3.tobytes() == g1.tobytes()


@pytest.mark.parametrize("d", [64, 400])
def test_device_gso_on_card_matches_host(card, monkeypatch, d):
    """full_gso's device route (an f64 Cholesky on the card) against
    LAPACK on the host: r within 1e-10 of max |r|, mu within 1e-8 of
    max |mu| (on this ill-conditioned Gram two f64 orders of the
    factorization part by 3.1e-10 at d = 400 on an H100), and
    mu diag(r) mu^T within 1e-12 of max |G| (1.3e-15 on an H100; an f32
    Cholesky would sit near f32's unit roundoff, 6e-8); an indefinite
    Gram gives None."""
    from fplll_tpu_torch.ops import blockgso

    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "8")
    RandGen.init_with_seed(d)
    bf = np.array([[float(x) for x in row] for row in gen.gen_uniform(d, 10).a])
    G = bf @ bf.T
    mu, r = blockgso.device_chol_gso(G, device=card)
    hmu, hr = blockgso.chol_gso(G)
    scale = np.abs(hr).max()
    assert np.abs(r - hr).max() <= 1e-10 * scale
    assert np.abs(mu - np.tril(hmu)).max() <= 1e-8 * np.abs(hmu).max()
    back = mu @ (np.diagonal(r)[:, None] * mu.T) - G
    assert np.abs(back).max() <= 1e-12 * np.abs(G).max()
    assert blockgso.device_chol_gso(np.array([[1.0, 2.0], [2.0, 1.0]]),
                                    device=card) is None


def mesh_shards(kind):
    if kind == "shared card":
        return [torch.device("cuda", 0)] * 4
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one card")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("kind", ["shared card", "one per card"])
def test_mesh_matches_single_card(card, kind):
    """ShardedEnumerator over four streams of one card, or over every
    card, against one card's DeviceEnumerator on the same roots: count
    mode gives its solutions, and its per-level nodes to the Pallas
    kernel's tolerance (both launch donating kernels); a search at 1.3
    times the shortest basis vector the same exact norm, which the C core
    finds too; mesh_enumerate_trials on three copies of the window finds
    that norm as well."""
    from fplll_tpu_torch.enum.evaluator import FastEvaluator
    from fplll_tpu_torch.native import native_enumerate
    from fplll_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_enum_mesh(devices=mesh_shards(kind))
    RandGen.init_with_seed(3)
    b = gen.gen_uniform(40, 12)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso.update_gso()
    mut, rdiag, normexp = gso.export_mu_r(0, 40)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag)
    A = math.ldexp(min(float(gso.get_int_gram(i, i)) for i in range(40)) *
                   1.3, -normexp)

    def norm(x):
        v = [sum(int(round(c)) * int(b.a[i, j]) for i, c in enumerate(x))
             for j in range(b.ncols)]
        return sum(t * t for t in v)

    launches = dict(kernels.LAUNCHES)
    for count_mode in (True, False):
        se = tmesh.ShardedEnumerator(mesh, batch_per_device=128,
                                     dtype=torch.float32)
        one = DeviceEnumerator(batch=128 * mesh.size, device=card)
        evs = [FastEvaluator(), FastEvaluator()]
        for enum, ev in zip((se, one), evs):
            enum.enumerate(mut, rdiag, None, np.zeros(40), A, True, ev,
                           count_mode=count_mode)
        if count_mode:
            # both donate inside their launches: the Pallas tolerance
            assert_counts({"nodes": torch.as_tensor(se.nodes),
                           "sol_count": evs[0].sol_count, "donations": 1},
                          one.nodes, evs[1].sol_count, len(one.nodes))
            assert evs[0].sol_count > 0
        else:
            c = native_enumerate(mut, rdiag, None, None, A, True, False,
                                 False)
            assert norm(evs[0].begin()[1]) == norm(evs[1].begin()[1]) == \
                norm(c[2])
    dists, sols, _ = tmesh.mesh_enumerate_trials(
        mesh, np.asarray([mut] * 3), np.asarray([rdiag] * 3),
        np.ones((3, 40)), np.full(3, A))
    g = int(np.argmin(dists))
    assert norm(sols[g]) == norm(c[2])
    assert kernels.LAUNCHES["single"] >= launches["single"] + mesh.size
