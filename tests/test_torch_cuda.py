"""The CUDA enumeration kernel on a card, against its plain version.

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
            np.testing.assert_array_equal(kn, pn)
        else:
            assert abs(int(kn.sum()) - int(pn.sum())) <= 0.01 * pn.sum()


def test_single_root_form_matches_plain(card):
    """nfix = 0: the whole tree under one root (the TPU's _chunk_call)."""
    mut, rdiag, prune, A = window(24, 1)
    enum = DeviceEnumerator(batch=1024, device=card)
    pack = enum._pack(mut, rdiag, prune, np.zeros(24), 24, np.zeros((1, 0)),
                      np.zeros(1), 24)
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    k = kernels.enum_run(**pack, A0=A, **kw)
    p = kernels.enum_run_plain(**{k2: v for k2, v in pack.items()
                                  if k2 != "m_real"}, A0=A, **kw)
    np.testing.assert_array_equal(k["nodes"].cpu().numpy(),
                                  p["nodes"].cpu().numpy()[:len(k["nodes"])])
    assert int(k["sol_count"]) == int(p["sol_count"]) > 0


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
    SMs) and on a grid of one block: identical per-level node counts and
    solution counts (tests/test_torch_enum_kernel.py holds the emulated
    kernel to this at every walker width the source can be built with)."""
    pack = packed(*window(40, 3), card)
    mr = pack["m_real"]
    kw = dict(is_svp=True, count_mode=True, batch=1024, max_steps=1 << 30)
    full = kernels.enum_run(**pack, **kw)
    one = kernels.enum_run(**pack, **kw, grid=1)
    geo = full["geometry"]
    assert geo["width"] == 32 and geo["grid"] == \
        geo["blocks_per_sm"] * geo["sms"]
    assert one["geometry"]["grid"] == 1
    np.testing.assert_array_equal(full["nodes"].cpu().numpy()[:mr],
                                  one["nodes"].cpu().numpy()[:mr])
    assert int(full["sol_count"]) == int(one["sol_count"])
    assert int(full["root_steps"]) == int(one["root_steps"])


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
    sub-solution distances equal the plain version's exactly, at the
    persistent grid and at one block. Search mode: the same best
    distance."""
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
            np.testing.assert_array_equal(r["nodes"].cpu().numpy()[:mr],
                                          p["nodes"].cpu().numpy()[:mr])
            assert int(r["sol_count"]) == int(p["sol_count"]) > 0
            if findsubsols:
                np.testing.assert_array_equal(
                    r["subsol_dist"].cpu().numpy()[:mr],
                    p["subsol_dist"].cpu().numpy()[:mr])
