"""The port's SVP/CVP solvers against the JAX package's, on the CPU.

`fplll_tpu_torch.algs.svpcvp` is the port of `fplll_tpu.algs.svpcvp`.
With the native first pass off (FPLLL_TPU_HYBRID_NODES=0) and the
device crossover lowered to dimension 12 (as tests/test_enum.py lowers
it), both packages send every search tree to their device path: the
JAX package's XLA kernel, the port's kernel wrappers, whose plain version
runs on CPU tensors (f64 trees for the error-bounded evaluators of the
proved solvers, for the unpruned dual trees and for the sub-solution
trees). The JAX package runs its unpruned FastEvaluator trees, the dual
ones, in f32; `jax_tree_dtype_rule` switches them to its f64 walk at run
time, the port's rule. Both must return the same status and the same
exact answer; the port's counters show that its kernel route ran.
"""

import os

import numpy as np
import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.svpcvp import shortest_vector_ex as jax_shortest_vector_ex
from fplll_tpu_torch.algs.svpcvp import shortest_vector_ex
from fplll_tpu_torch.defs import CVPM_PROVED, SVP_DUAL
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.interop import basis_from_rows
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from jax_reference import jax_tree_dtype_rule  # noqa: F401

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


@pytest.fixture
def device_route(monkeypatch, jax_tree_dtype_rule):
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device

    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 12)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 12)


# gen_uniform (10-bit entries) and gen_intrel (fplll's `latticegen r`),
# LLL-reduced; both with their largest r_ii first, so that the proved
# CVP's reset below the top level has no nested reset and goes to the
# device path (cpu.py:_reset_on_device)
CASES = [("uniform", 34, 3), ("intrel", 34, 11), ("uniform", 40, 5)]
IDS = [f"{k}{d}" for k, d, _ in CASES]
# the dual trees of the intrel seed-11 basis are far larger: another seed
DUAL_CASES = [("uniform", 34, 3), ("intrel", 34, 1)]


def bases(kind, d, seed):
    """The JAX package's basis and the port's copy of it."""
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_uniform(d, 10) if kind == "uniform" else \
        fl.gen.gen_intrel(d, 10 * d)
    fl.lll_reduction(bj)
    bt = basis_from_rows(bj.a)
    assert bt.a.tolist() == bj.a.tolist()
    return bj, bt


def point(b, coeffs):
    return [sum(int(c) * int(b.a[i, j]) for i, c in enumerate(coeffs))
            for j in range(b.ncols)]


def norm(b, coeffs):
    return sum(v * v for v in point(b, coeffs))


def ran(form):
    """A context that asserts the port's wrappers ran `form`."""
    class Ran:
        def __enter__(self):
            self.runs = kernels.PLAIN_RUNS[form]

        def __exit__(self, *exc):
            assert exc[0] is not None or kernels.PLAIN_RUNS[form] > self.runs
            return False
    return Ran()


@pytest.mark.parametrize("kind,d,seed", CASES, ids=IDS)
def test_proved_svp_matches_jax(device_route, kind, d, seed):
    """The same status, the same exact minimum norm, and the same
    coefficient vector up to sign (the minimum is unique up to sign
    here)."""
    bj, bt = bases(kind, d, seed)
    sj, xj = fl.shortest_vector(bj)
    with ran("f64"):
        st, xt = ft.shortest_vector(bt)
    assert st == sj == 0
    assert norm(bt, xt) == norm(bj, xj) > 0
    assert xt in (list(xj), [-v for v in xj])


@pytest.mark.parametrize("kind,d,seed", CASES[:2], ids=IDS[:2])
def test_svp_subsolutions_match_jax(device_route, kind, d, seed):
    """shortest_vector_pruning(find_subsols=True), no pruning: the same
    answer, and per level the same sub-solution distance (to 1e-9
    relative: f64 trees, whose records may differ in the last bits) and
    the same coordinates where the distance is the same."""
    bj, bt = bases(kind, d, seed)
    sj, xj, ej = fl.shortest_vector_pruning(bj, [], find_subsols=True)
    with ran("f64-subsols"):
        st, xt, et = ft.shortest_vector_pruning(bt, [], find_subsols=True)
    assert st == sj == 0 and norm(bt, xt) == norm(bj, xj)
    js, ts = ej.sub_solutions, et.sub_solutions
    assert len(ts) == len(js) and sum(1 for _, v in ts if v) > 0
    for (dt, vt), (dj, vj) in zip(ts, js):
        assert dt == pytest.approx(dj, rel=1e-9)
        assert bool(vt) == bool(vj)


@pytest.mark.parametrize("kind,d,seed", DUAL_CASES, ids=IDS[:2])
def test_dual_svp_matches_jax(device_route, kind, d, seed):
    """SVP_DUAL (an unpruned tree: f64 in both packages): the same
    shortest dual length to 1e-9 relative and the same dual coefficients
    up to sign."""
    bj, bt = bases(kind, d, seed)
    sj, xj, ej, _ = jax_shortest_vector_ex(bj, flags=SVP_DUAL)
    with ran("f64-dual"):
        st, xt, et, _ = shortest_vector_ex(bt, flags=SVP_DUAL)
    assert st == sj == 0
    assert et.begin()[0] == pytest.approx(ej.begin()[0], rel=1e-9)
    assert xt in (list(xj), [-v for v in xj])


@pytest.mark.parametrize("method", [0, CVPM_PROVED], ids=["fast", "proved"])
@pytest.mark.parametrize("kind,d,seed", CASES[:2], ids=IDS[:2])
def test_closest_vector_matches_jax(device_route, kind, d, seed, method):
    """closest_vector, fast and proved, to a lattice vector plus a small
    integer offset: the same status and the same closest vector."""
    bj, bt = bases(kind, d, seed)
    rng = np.random.default_rng(seed)
    target = [c + int(o) for c, o in zip(
        point(bj, rng.integers(-3, 4, d)), rng.integers(-40, 41, bj.ncols))]
    sj, xj = fl.closest_vector(bj, target, method=method)
    with ran("f64"):
        st, xt = ft.closest_vector(bt, target, method=method)
    assert st == sj == 0
    assert xt == list(xj)


def test_proved_cvp_device_reset_matches_host(monkeypatch):
    """The port of tests/test_svp_cvp.py's test of the same name (seed 21,
    d = 38, target [3] * 38): the proved CVP's reset below the top level
    is device-sized, so the card's kernel (its plain version here) handles
    it, at least once; the answer equals the host-only walk's and the JAX
    package's."""
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.cpu as cpumod
    import fplll_tpu_torch.enum.device as port_device

    hits = {"card": 0}
    orig = cpumod.EnumerationDyn._reset_on_device

    def spy(self, cur_dist, new_dim):
        handled = orig(self, cur_dist, new_dim)
        hits["card"] += bool(handled)
        return handled

    monkeypatch.setattr(cpumod.EnumerationDyn, "_reset_on_device", spy)

    def bases21():
        fl.RandGen.init_with_seed(21)
        b = fl.gen.gen_uniform(38, 10)
        fl.lll_reduction(b)
        return b, basis_from_rows(b.a)

    bj, bt = bases21()
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 34)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    sj, xj = fl.closest_vector(bj, [3] * 38, method=CVPM_PROVED)
    with ran("f64"):
        st, xt = ft.closest_vector(bt, [3] * 38, method=CVPM_PROVED)
    assert hits["card"] >= 1
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 10_000)
    hits["card"] = 0
    sh, xh = ft.closest_vector(basis_from_rows(bj.a), [3] * 38,
                               method=CVPM_PROVED)
    assert hits["card"] == 0
    assert st == sh == sj == 0
    assert xt == xh == list(xj)


def test_reset_on_device_raises_instead_of_rerunning_on_the_host(
        monkeypatch):
    """A failed launch in a CVP reset fails the call: the host DFS never
    reruns a reset the card was given (the JAX package warned once and
    reran it)."""
    import fplll_tpu_torch.enum.device as port_device

    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(port_device, "enum_run", broken)
    fl.RandGen.init_with_seed(21)
    b = fl.gen.gen_uniform(38, 10)
    fl.lll_reduction(b)
    with pytest.raises(RuntimeError, match="kernel fault"):
        ft.closest_vector(basis_from_rows(b.a), [3] * 38,
                          method=CVPM_PROVED)


def test_host_only_backend_launches_nothing(device_route):
    """backend="cpu" keeps every tree on the host, CVP resets included."""
    bj, bt = bases("uniform", 34, 3)
    before = dict(kernels.PLAIN_RUNS)
    st, xt = ft.shortest_vector(bt, backend="cpu")
    sc, xc = ft.closest_vector(bt, [3] * 34, method=CVPM_PROVED,
                               backend="cpu")
    assert kernels.PLAIN_RUNS == before
    assert st == sc == 0
    assert norm(bt, xt) == norm(bj, fl.shortest_vector(bj)[1])


def test_self_dual_bkz_tour_matches_jax(monkeypatch):
    """One self-dual BKZ tour (block 34 on a dim-40 q-ary basis, seed 13,
    as tests/test_torch_bkz.py sets it up) with the device crossover
    forced low: the dual windows go to each package's device path, and
    the reduced bases are equal as integers."""
    import json

    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu.algs.bkz import BKZReduction as JaxBKZReduction
    from fplll_tpu.algs.bkz_param import strategy_full_path
    from fplll_tpu.threads import set_threads as jax_set_threads
    from fplll_tpu_torch.algs.bkz import BKZReduction
    from fplll_tpu_torch.interop import strategies_from_json
    from fplll_tpu_torch.threads import set_threads

    monkeypatch.setenv("FPLLL_TPU_TRIAL_BATCH", "1")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 34)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    jax_set_threads(128)
    set_threads(128)
    with open(strategy_full_path("default.json")) as f:
        js = json.load(f)
    strategies = (fl.load_strategies_json("default.json"),
                  strategies_from_json(js))
    d, block, seed = 40, 34, 13
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_qary_bits(d, d // 2, 14)
    fl.lll_reduction(bj)
    bt = basis_from_rows(bj.a)
    try:
        out = []
        for pkg, cls, b, strat in ((fl, JaxBKZReduction, bj, strategies[0]),
                                   (ft, BKZReduction, bt, strategies[1])):
            pkg.RandGen.init_with_seed(seed)
            p = pkg.BKZParam(block, strat, flags=pkg.BKZ_GH_BND |
                             pkg.BKZ_MAX_LOOPS | pkg.BKZ_SD_VARIANT,
                             max_loops=1)
            m = pkg.MatGSO(b, flags=pkg.GSO_ROW_EXPO)
            bkz = cls(m, pkg.LLLReduction(m, 0.99, 0.51, 0), p)
            runs = kernels.PLAIN_RUNS["f32-dual"]
            bkz.bkz()
            out.append((bkz, kernels.PLAIN_RUNS["f32-dual"] - runs))
    finally:
        jax_set_threads(-1)
        set_threads(-1)
    (kj, _), (kt, dual_runs) = out
    assert dual_runs > 0
    assert bt.a.tolist() == bj.a.tolist()
    assert kt.nodes == kj.nodes > 0
    assert ft.is_lll_reduced(ft.MatGSO(bt.copy()), 0.99, 0.51)


# (route, seed, d) of the proved CVP whose facade node counts both
# packages report: resets on each package's device path (the crossover
# forced to dimension 34, as test_proved_cvp_device_reset_matches_host
# forces it) and on the host alone
NODE_CASES = [("device", 21, 38), ("device", 25, 38), ("device", 30, 38),
              ("host", 21, 38)]


@pytest.mark.parametrize("route,seed,d", NODE_CASES,
                         ids=[f"{r}-{s}-{d}" for r, s, d in NODE_CASES])
def test_proved_cvp_facade_nodes_match_jax(monkeypatch, route, seed, d):
    """The proved CVP's facade node counts (Enumeration.get_nodes(), in
    total and per level) are the JAX package's, call for call, on the
    device route and on the host alone, and both are negative: the
    facade's DFS subtracts one node per level above its start before the
    loop (enum/cpu.py's _loop, as fplll_tpu/enum/cpu.py and
    fplll_tpu/native/enum_core.c do), and each reset below the top level
    enumerates in a sub-enumeration that keeps its own nodes, so the top
    level's loop counts none of them. The negative counts a run reports
    are the reference's, not a fault of the port."""
    import fplll_tpu.enum.api as jax_api
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.api as port_api
    import fplll_tpu_torch.enum.device as port_device

    low = 34 if route == "device" else 10_000
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", low)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", low)
    counts = {"jax": [], "port": []}
    for name, api in (("jax", jax_api), ("port", port_api)):
        def spy(self, *a, _orig=api.Enumeration.enumerate, _name=name, **kw):
            out = _orig(self, *a, **kw)
            counts[_name].append((self.get_nodes(), [
                self.get_nodes(level) for level in range(d)]))
            return out
        monkeypatch.setattr(api.Enumeration, "enumerate", spy)
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_uniform(d, 10)
    fl.lll_reduction(bj)
    bt = basis_from_rows(bj.a)
    sj, xj = fl.closest_vector(bj, [3] * d, method=CVPM_PROVED)
    runs = dict(kernels.PLAIN_RUNS)
    st, xt = ft.closest_vector(bt, [3] * d, method=CVPM_PROVED)
    assert st == sj == 0 and xt == list(xj)
    assert (kernels.PLAIN_RUNS["f64"] > runs["f64"]) == (route == "device")
    assert counts["port"] == counts["jax"] and counts["port"]
    assert all(total < 0 for total, _ in counts["port"])
