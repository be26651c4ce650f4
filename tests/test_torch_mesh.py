"""The port's sharded enumeration against the JAX package's, on the CPU.

`fplll_tpu_torch.parallel.mesh` drives the enumeration kernel's wrappers
once per shard and sweep (their plain version on CPU tensors); shards
here are four CPU devices, `make_enum_mesh(devices=["cpu"] * 4)`. The
JAX package's mesh runs on four devices of the 8-device virtual CPU mesh
of tests/conftest.py (`make_enum_mesh(4)`), so that both deal over the
same number of shards. Tolerances:

- steal plans, count-mode solution counts and the port's per-level nodes
  against its single-device DeviceEnumerator: exactly equal (every root's
  subtree is walked once, with the same arithmetic);
- per-level nodes against the JAX mesh: the tolerances of
  tests/test_pallas_parity.py:164-175 (XLA sums the root's center
  contributions in another order);
- unpruned search answers: the exact integer norm of the oracle's;
- distances of f32 trees against their vector's exact norm: 2e-4
  relative (the kernel's f32 drift, chip_smoke.F32_DIST_TOL); f64 trees:
  1e-9.
"""

import math
import os

import numpy as np
import pytest
import torch

from fplll_tpu.algs.wrapper import lll_reduction as j_lll
from fplll_tpu.core.gso import MatGSO as JMatGSO
from fplll_tpu.defs import GSO_INT_GRAM as J_INT_GRAM
from fplll_tpu.enum.evaluator import FastEvaluator as JFastEvaluator
from fplll_tpu.nr.fctx import MPCtx as JMPCtx
from fplll_tpu.nr.rng import RandGen as JRandGen
from fplll_tpu.ops import gen as jgen
from fplll_tpu.parallel import mesh as jmesh
from fplll_tpu_torch.algs.wrapper import lll_reduction
from fplll_tpu_torch.core.gso import MatGSO
from fplll_tpu_torch.defs import GSO_INT_GRAM
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.enum.cpu import EnumerationDyn
from fplll_tpu_torch.enum.evaluator import FastEvaluator
from fplll_tpu_torch.native import native_enumerate
from fplll_tpu_torch.nr.fctx import MPCtx
from fplll_tpu_torch.nr.rng import RandGen
from fplll_tpu_torch.ops import gen
from fplll_tpu_torch.parallel import mesh as tmesh
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

SHARDS = 4
F32_TOL = 2e-4


@pytest.fixture(scope="module")
def cpu_mesh():
    return tmesh.make_enum_mesh(devices=["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_enum_mesh(SHARDS)


def exact_norm(b, coords):
    v = [sum(int(round(c)) * int(b.a[i, j]) for i, c in enumerate(coords))
         for j in range(b.ncols)]
    return sum(x * x for x in v)


def uniform_basis(d, seed, bits=12):
    """The port's LLL-reduced gen_uniform basis and its exact-Gram GSO."""
    RandGen.init_with_seed(seed)
    b = gen.gen_uniform(d, bits)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(70))
    gso.update_gso()
    return b, gso


def qary_tree(d, seed, radius):
    """(mu^T, r) of an LLL-reduced gen_qary_bits(d, d/2, 10) basis and
    `radius` times its Gaussian-heuristic squared radius (the skewed
    trees of tests/test_mesh.py)."""
    RandGen.init_with_seed(seed)
    b = gen.gen_qary_bits(d, d // 2, 10)
    lll_reduction(b)
    gso = MatGSO(b, flags=GSO_INT_GRAM, ctx=MPCtx(70))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, d)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag)
    log_ball = d / 2 * math.log(math.pi) - math.lgamma(d / 2 + 1)
    gh2 = math.exp(float(np.mean(np.log(rdiag))) - 2.0 * log_ball / d)
    return mut, rdiag, radius * gh2


def assert_nodes_close(port, jax):
    """tests/test_pallas_parity.py:164-175."""
    port, jax = np.asarray(port, np.float64), np.asarray(jax, np.float64)
    assert abs(port.sum() - jax.sum()) <= 0.01 * jax.sum()
    for p, j in zip(port, jax):
        if max(p, j) > 200:
            assert abs(p - j) <= 0.02 * max(p, j)


# ---------------------------------------------------------------------------
# the mesh object
# ---------------------------------------------------------------------------
def test_make_enum_mesh_devices(monkeypatch):
    m = tmesh.make_enum_mesh(devices=["cpu"] * 3)
    assert m.size == 3 and all(d.type == "cpu" for d in m.devices)
    assert tmesh.make_enum_mesh(2, devices=["cpu"] * 3).size == 2
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    assert tmesh.make_enum_mesh(4).devices == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_enum_mesh(devices=["cuda"] * 2)
        monkeypatch.delenv("FPLLL_TORCH_DEVICE")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_enum_mesh()
    with pytest.raises(ValueError):
        tmesh.make_enum_mesh(devices=[])


def test_launch_then_collect_is_enum_run():
    """enum_run is enum_launch followed by enum_collect; on CPU tensors
    the launch runs the plain version."""
    _, gso = uniform_basis(16, 2)
    mut, rdiag, _ = gso.export_mu_r(0, 16)
    A = float(rdiag[0]) * 1.5
    enum = tdev.DeviceEnumerator(batch=64, target_root_factor=4,
                                 device="cpu")
    enum.nodes = np.zeros(16, dtype=np.int64)
    rx, _, rpd, m_real = enum._gen_roots(np.asarray(mut), np.asarray(rdiag),
                                         np.ones(16), np.zeros(16), A, 16,
                                         True)
    pack = enum._pack(np.asarray(mut), np.asarray(rdiag), np.ones(16),
                      np.zeros(16), 16, rx, rpd, m_real)
    kw = dict(pack, A0=A * enum.bound_slack, is_svp=True, count_mode=True,
              batch=64)
    runs = kernels.PLAIN_RUNS["single"]
    a = kernels.enum_run(**kw)
    b = kernels.enum_collect(kernels.enum_launch(**kw))
    assert kernels.PLAIN_RUNS["single"] == runs + 2
    assert torch.equal(a["nodes"], b["nodes"])
    assert int(a["sol_count"]) == int(b["sol_count"]) > 0


# ---------------------------------------------------------------------------
# the steal plan
# ---------------------------------------------------------------------------
_PLAN_FNS = {}


def jax_steal_plan(cursor, end, n_dead):
    """The JAX package's _steal_plan, run under shard_map over one shard
    per entry, on the virtual CPU mesh."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from fplll_tpu.jaxsetup import jax, jnp

    n = len(cursor)
    if n not in _PLAN_FNS:
        def body(c, e, k):
            nc, ne, st = jmesh._steal_plan(c[0], e[0], k[0])
            return nc[None], ne[None], st[None]

        _PLAN_FNS[n] = jax.jit(shard_map(
            body, mesh=jmesh.make_enum_mesh(n), in_specs=(P("enum"),) * 3,
            out_specs=(P("enum"),) * 3, check_vma=False))
    out = _PLAN_FNS[n](*(jnp.asarray(np.asarray(v, np.int32))
                         for v in (cursor, end, n_dead)))
    return [np.asarray(v) for v in out]


def plan_cases():
    """200 random (cursor, end, n_dead) vectors over 2, 4 and 8 shards,
    with empty ranges, remainders about the 64-root threshold and ties,
    then the edge cases."""
    rng = np.random.default_rng(5)
    cases = []
    for i in range(200):
        n = (2, 4, 8)[i % 3]
        cursor = rng.integers(0, 4096, n)
        rem = rng.choice([0, 0, 1, 31, 63, 64, 65, 100, 128, 500, 3000], n)
        dead = rng.choice([0, 1, 8, 256], n)
        cases.append((cursor, cursor + rem, dead))
    cases += [
        ([0, 100, 200, 300], [90, 190, 290, 390], [8] * 4),    # no thief
        ([50, 100, 200, 300], [50, 100, 200, 500], [8] * 4),   # 3 thieves,
        ([50, 100, 200, 300], [50, 100, 263, 500], [8] * 4),   # 1 victim
        ([0, 10, 20, 30], [0, 10, 83, 93], [8, 0, 8, 8]),      # < 64 left
        ([0, 10, 20, 30], [128, 10, 148, 158], [8, 8, 8, 8]),  # ties
        ([0, 0, 0, 0, 0, 0, 0, 0], [0, 200, 0, 200, 0, 200, 0, 200],
         [1] * 8),
        ([5, 5], [5, 5], [8, 8]),                              # all drained
    ]
    return cases


def test_steal_plan_matches_jax():
    steals = 0
    for cursor, end, dead in plan_cases():
        ours = tmesh._steal_plan(cursor, end, dead)
        theirs = jax_steal_plan(cursor, end, dead)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))
        steals += int(ours[2].sum())
    assert steals > 50       # the cases exercise the stealing branch


# ---------------------------------------------------------------------------
# ShardedEnumerator against the JAX mesh and the single device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,seed", [(20, 2), (26, 4)])
def test_sharded_search_matches_jax_and_oracle(cpu_mesh, jax_mesh, d, seed):
    b, gso = uniform_basis(d, seed)
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.00001
    A = math.ldexp(A0, -normexp)
    ev_c = FastEvaluator()
    EnumerationDyn(gso, ev_c).enumerate(0, d, A0, 0)
    cnorm = exact_norm(b, ev_c.begin()[1])

    ev = FastEvaluator()
    ev.set_normexp(normexp)
    se = tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=64)
    launches = tmesh.ShardedEnumerator.launches
    runs = kernels.PLAIN_RUNS["f64"]
    se.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev)
    assert tmesh.ShardedEnumerator.launches == launches + 1
    assert kernels.PLAIN_RUNS["f64"] > runs
    assert se.sweeps >= 1 and se.nodes.sum() > 0
    assert not ev.empty() and exact_norm(b, ev.begin()[1]) == cnorm

    ev_j = JFastEvaluator()
    ev_j.set_normexp(normexp)
    jmesh.ShardedEnumerator(jax_mesh, batch_per_device=64).enumerate(
        mut, rdiag, None, np.zeros(d), A, True, ev_j)
    assert exact_norm(b, ev_j.begin()[1]) == cnorm
    assert abs(ev.begin()[0] - ev_j.begin()[0]) <= 1e-9 * ev_j.begin()[0]


def test_trace_records_every_sweep_and_steal(cpu_mesh, monkeypatch):
    """mesh.TRACE holds one entry per sweep and every steal the
    enumerator counts, also a steal by a shard that launched nothing in
    that sweep (drained earlier; chip_smoke.py phase 7 holds the trace to
    the counters). Such a steal is forced by a steal plan that also flags
    every drained shard as a thief while leaving the ranges as they are."""
    plan = tmesh._steal_plan

    def plan_with_idle_thieves(cursor, own_end, n_dead):
        cur, end, stole = plan(cursor, own_end, n_dead)
        drained = np.asarray(cursor) >= np.asarray(own_end)
        return cur, end, stole | (drained & (cur >= end))

    monkeypatch.setattr(tmesh, "_steal_plan", plan_with_idle_thieves)
    mut, rdiag, A = qary_tree(30, 9, 1.3)
    monkeypatch.setattr(tmesh, "TRACE", [])
    se = tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=8,
                                 steps_per_sweep=64)
    se.enumerate(mut, rdiag, None, np.zeros(30), A, True, FastEvaluator(),
                 count_mode=True)
    trace = tmesh.TRACE
    idle = [r for sweep in trace for r in sweep if "form" not in r]
    assert len(trace) == se.sweeps
    assert sum(r["stole"] for sweep in trace for r in sweep) == \
        se.last_steals
    assert idle and all(r["stole"] for r in idle)


def test_sharded_count_steals_and_matches_single_device(cpu_mesh, jax_mesh):
    """tests/test_mesh.py's skewed q-ary tree (d = 30 at 1.3 GH, 8 roots
    per shard and sweep): the solution count is the JAX mesh's and the C
    core's, the per-level nodes over four shards exactly the single
    device's on the same roots, and drained shards stole work."""
    mut, rdiag, A = qary_tree(30, 9, 1.3)
    ev = FastEvaluator()
    se = tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=8,
                                 steps_per_sweep=64)
    se.enumerate(mut, rdiag, None, np.zeros(30), A, True, ev,
                 count_mode=True)
    assert se.last_steals >= 1, "no shard ever stole work"

    ref = native_enumerate(mut, rdiag, None, None, A, True, False, True)
    assert ev.sol_count == int(ref[3]) > 0
    # the single device on the same roots: the helper's batch (8 per
    # shard times 4) and root factor
    ev_s = FastEvaluator()
    single = tdev.DeviceEnumerator(batch=8 * SHARDS, device="cpu",
                                   dtype=torch.float64)
    single.enumerate(mut, rdiag, None, np.zeros(30), A, True, ev_s,
                     count_mode=True)
    np.testing.assert_array_equal(se.nodes, single.nodes)
    assert ev_s.sol_count == ev.sol_count

    ev_j = JFastEvaluator()
    sj = jmesh.ShardedEnumerator(jax_mesh, batch_per_device=8,
                                 steps_per_sweep=64)
    sj.enumerate(mut, rdiag, None, np.zeros(30), A, True, ev_j,
                 count_mode=True)
    assert ev_j.sol_count == ev.sol_count
    assert_nodes_close(se.nodes, sj.nodes)


def dual_tree(gso, d):
    """The dual tree's (mu^T, r) and normexp, as the facade builds it."""
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    normexp_d = -normexp
    rd = np.asarray(rdiag, dtype=np.float64)
    mu = np.asarray(mut, dtype=np.float64)
    rdiag_d = (1.0 / (rd * 2.0 ** (-2 * normexp_d)))[::-1].copy()
    return np.triu(-(mu.T)[::-1, ::-1], 1), rdiag_d, normexp_d


def test_sharded_f64_dual_and_subsols(cpu_mesh, jax_mesh):
    """tests/test_mesh.py's dd32 dual tree with sub-solutions: the JAX
    package's compensated pairs are the card's f64. The dual search finds
    the oracle's distance (1e-9; the JAX mesh's to 1e-6, its pairs'
    precision) and records sub-solutions; in count mode, where they do
    not depend on the order of the walk, the per-level records over four
    shards are exactly the single device's."""
    d = 18
    _, gso = uniform_basis(d, 6, bits=10)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.00001
    ev_c = FastEvaluator(find_subsolutions=True)
    EnumerationDyn(gso, ev_c).enumerate(0, d, A0, 0, dual=True)
    assert not ev_c.empty()
    mut_d, rdiag_d, normexp_d = dual_tree(gso, d)
    A = math.ldexp(ev_c.begin()[0], -normexp_d) * 1.000001
    dist_c = math.ldexp(ev_c.begin()[0], -ev_c.normExp)

    ev = FastEvaluator(find_subsolutions=True)
    ev.set_normexp(normexp_d)
    runs = kernels.PLAIN_RUNS["f64-dual-subsols"]
    tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=64,
                            dtype="dd32").enumerate(
        mut_d, rdiag_d, None, np.zeros(d), A, True, ev, dual=True)
    assert kernels.PLAIN_RUNS["f64-dual-subsols"] > runs
    assert not ev.empty() and ev.sub_solutions
    assert abs(math.ldexp(ev.begin()[0], -normexp_d) - dist_c) <= \
        1e-9 * dist_c

    ev_j = JFastEvaluator(find_subsolutions=True)
    ev_j.set_normexp(normexp_d)
    jmesh.ShardedEnumerator(jax_mesh, batch_per_device=64,
                            dtype="dd32").enumerate(
        mut_d, rdiag_d, None, np.zeros(d), A, True, ev_j, dual=True)
    assert abs(math.ldexp(ev_j.begin()[0], -normexp_d) -
               math.ldexp(ev.begin()[0], -normexp_d)) <= 1e-6 * dist_c

    records = []
    for enum in (tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=16),
                 tdev.DeviceEnumerator(batch=16 * SHARDS, device="cpu",
                                       dtype=torch.float64)):
        ev_n = FastEvaluator(find_subsolutions=True)
        ev_n.eval_mode = 1          # EVALMODE_COUNT
        enum.enumerate(mut_d, rdiag_d, None, np.zeros(d), A, True, ev_n,
                       count_mode=True, dual=True)
        records.append(list(ev_n.sub_solutions))
        assert ev_n.sol_count > 0
    assert records[0] == records[1] and any(v for _, v in records[0])


def test_deep_tree_slices_over_the_mesh(cpu_mesh):
    """A tree taller than the kernel (max_device_levels 16) runs its
    chunked slices over the mesh: the C core's solution count and best
    distance (tests/test_mesh.py's deep tree)."""
    mut, rdiag, A = qary_tree(36, 21, 1.1)
    ref = native_enumerate(mut, rdiag, None, None, A, True, False, True)
    se = tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=128,
                                 max_device_levels=16)
    se.deep_hard_cap = 4096      # a frontier cap that forces the slices
    launches = tmesh.ShardedEnumerator.launches
    ev = FastEvaluator()
    se.enumerate(mut, rdiag, None, np.zeros(36), A, True, ev,
                 count_mode=True)
    assert se._helper._deep_slices >= 1
    assert tmesh.ShardedEnumerator.launches == \
        launches + se._helper._deep_slices
    assert ev.sol_count == int(ref[3])
    ev2 = FastEvaluator(nr_solutions=1)
    se2 = tmesh.ShardedEnumerator(cpu_mesh, batch_per_device=128,
                                  max_device_levels=16)
    se2.deep_hard_cap = 4096
    se2.enumerate(mut, rdiag, None, np.zeros(36), A, True, ev2)
    assert se2._helper._deep_slices >= 1
    assert not ev2.empty()
    assert abs(ev2.begin()[0] - ref[1]) <= 1e-9 * ref[1]


# ---------------------------------------------------------------------------
# grouped trials, one per shard
# ---------------------------------------------------------------------------
def rerandomized_trials(d, seed, G):
    """G rerandomized LLL-reduced bases of one gen_uniform lattice (the
    recipe of tests/test_mesh.py), for both packages, with their (mu^T,
    r) in trial 0's scale; returns the JAX bases, the stacked arrays, the
    radius, trial 0's normexp and lambda_1^2 from the C core."""
    JRandGen.init_with_seed(seed)
    b0 = jgen.gen_uniform(d, 12)
    j_lll(b0)
    bases = [b0]
    for t in range(1, G):
        bt = b0.copy()
        rng = np.random.default_rng(100 + t)
        for _ in range(3 * d):
            i, j = rng.integers(0, d, size=2)
            if i != j:
                bt.row_addmul(int(i), int(j), int(rng.integers(-2, 3)))
        j_lll(bt)
        bases.append(bt)
    muts, rdiags, exps = [], [], []
    for bt in bases:
        g = JMatGSO(bt, flags=J_INT_GRAM, ctx=JMPCtx(70))
        g.update_gso()
        mut, rdiag, normexp = g.export_mu_r(0, d)
        muts.append(np.asarray(mut))
        rdiags.append(np.asarray(rdiag))
        exps.append(normexp)
    rdiags = [r * math.ldexp(1.0, e - exps[0]) for r, e in zip(rdiags, exps)]
    g0 = JMatGSO(b0, flags=J_INT_GRAM, ctx=JMPCtx(70))
    g0.update_gso()
    A_abs = min(float(g0.get_int_gram(i, i)) for i in range(d)) * 1.00001
    best = native_enumerate(muts[0], rdiags[0], None, None,
                            math.ldexp(A_abs, -exps[0]), True, False, False)
    lam2 = exact_norm(b0, best[2])
    return bases, np.asarray(muts), np.asarray(rdiags), \
        math.ldexp(A_abs, -exps[0]), exps[0], lam2


@pytest.mark.parametrize("dtype", [None, "dd32"])
def test_mesh_trials_match_jax(cpu_mesh, jax_mesh, dtype):
    """G = 4 trials on 4 shards: the union finds lambda_1^2, every
    reported vector is one of its own basis with its exact norm to 1e-9,
    as on the JAX mesh: the default (dtype None) runs the f64 tree in
    both packages, as "dd32" does; G = 5 raises MeshDecline, a
    ValueError."""
    d, G = 24, 4
    bases, muts, rdiags, A, ref, lam2 = rerandomized_trials(d, 9, G)
    prunes, maxd = np.ones((G, d)), np.full(G, A)
    tol, form = 1e-9, "f64"
    for name, run in (("port", lambda: tmesh.mesh_enumerate_trials(
                          cpu_mesh, muts, rdiags, prunes, maxd,
                          batch_per_device=64, sync_steps=256,
                          dtype=dtype)),
                      ("jax", lambda: jmesh.mesh_enumerate_trials(
                          jax_mesh, muts, rdiags, prunes, maxd,
                          batch_per_device=64, sync_steps=256,
                          dtype=dtype))):
        runs = kernels.PLAIN_RUNS[form]
        dists, sols, nodes = run()
        if name == "port":
            assert kernels.PLAIN_RUNS[form] >= runs + G
        found = np.where(np.isfinite(dists))[0]
        assert len(found), f"{name}: no trial found a vector"
        for t in found:
            exact = exact_norm(bases[t], sols[t])
            assert abs(exact - math.ldexp(dists[t], ref)) <= tol * exact
            assert nodes[t] > 0
        assert min(exact_norm(bases[t], sols[t]) for t in found) == lam2
    with pytest.raises(ValueError, match="trials"):
        tmesh.mesh_enumerate_trials(cpu_mesh, np.concatenate([muts,
                                                              muts[:1]]),
                                    np.concatenate([rdiags, rdiags[:1]]),
                                    np.ones((G + 1, d)), np.full(G + 1, A))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.fixture
def four_cpu_shards(monkeypatch, cpu_mesh):
    """The facade and the window path see a mesh of four CPU shards."""
    monkeypatch.setattr(tdev, "_visible_mesh", lambda device: cpu_mesh)


def test_make_enumerator_picks_the_mesh(four_cpu_shards, monkeypatch):
    monkeypatch.delenv("FPLLL_TPU_MESH", raising=False)
    enum = tdev._make_enumerator(device="cpu", dtype=torch.float64)
    assert isinstance(enum, tmesh.ShardedEnumerator)
    assert enum.batch_per_device == 256 and enum.dtype == torch.float64
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    assert isinstance(tdev._make_enumerator(device="cpu"),
                      tdev.DeviceEnumerator)


def test_facade_routes_through_the_mesh(four_cpu_shards, monkeypatch):
    """svpcvp.shortest_vector at d = 30 through the facade over four CPU
    shards: the JAX facade's norm through its mesh, and the port's
    sharded enumerator launched."""
    import fplll_tpu.enum.tpu as jtpu
    from fplll_tpu.algs.svpcvp import shortest_vector as j_svp
    from fplll_tpu_torch.algs.svpcvp import shortest_vector
    from fplll_tpu_torch.interop import basis_from_rows

    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    monkeypatch.delenv("FPLLL_TPU_MESH", raising=False)
    monkeypatch.setattr(jtpu, "_MIN_TPU_DIM", 12)
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 12)
    j_make = jmesh.make_enum_mesh
    monkeypatch.setattr(jmesh, "make_enum_mesh",
                        lambda n=None: j_make(SHARDS))
    JRandGen.init_with_seed(3)
    bj = jgen.gen_uniform(30, 10)
    j_lll(bj)
    bt = basis_from_rows(bj.a)

    launches = tmesh.ShardedEnumerator.launches
    st, x = shortest_vector(bt.copy(), device="cpu")
    assert tmesh.ShardedEnumerator.launches > launches
    j_launches = jmesh.ShardedEnumerator.launches
    sj, xj = j_svp(bj.copy())
    assert jmesh.ShardedEnumerator.launches > j_launches
    assert st == sj == 0
    assert exact_norm(bt, x) == exact_norm(bj, xj) > 0


def window_trials(d, G, seed):
    b, gso = uniform_basis(d, seed)
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    A = math.ldexp(min(float(gso.get_int_gram(i, i)) for i in range(d)) *
                   1.00001, -normexp)
    return b, normexp, (np.asarray([mut] * G), np.asarray([rdiag] * G),
                        np.ones((G, d)), np.full(G, A))


def test_grouped_windows_route_through_the_mesh(four_cpu_shards,
                                                monkeypatch):
    """Where the grouped launch declines, device_enumerate_windows runs
    the G trials one per shard (tests/test_mesh.py's case): one call of
    mesh_enumerate_trials, and the reported vector has its exact norm."""
    calls = []
    orig = tmesh.mesh_enumerate_trials

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tmesh, "mesh_enumerate_trials", spy)
    monkeypatch.setattr(tdev, "_grouped_device_windows",
                        lambda *a, **k: None)
    b, normexp, trials = window_trials(24, 3, 31)
    dists, sols, total_nodes = tdev.device_enumerate_windows(*trials,
                                                             device="cpu")
    assert calls == [1], "the grouped windows did not route via the mesh"
    assert np.isfinite(dists).sum() == 1 and total_nodes > 0
    g = int(np.argmin(dists))
    exact = exact_norm(b, sols[g])
    assert abs(exact - math.ldexp(dists[g], normexp)) <= F32_TOL * exact

    monkeypatch.setenv("FPLLL_TPU_MESH_TRIALS", "0")
    tdev.device_enumerate_windows(*trials, device="cpu")
    assert calls == [1]


def test_mesh_failure_raises(four_cpu_shards, monkeypatch):
    """The documented refusal declines to the trial loop; any other
    failure in the mesh raises (the JAX package warns and falls back)."""
    monkeypatch.setattr(tdev, "_grouped_device_windows",
                        lambda *a, **k: None)
    b, normexp, trials = window_trials(20, 2, 3)

    def decline(*a, **k):
        raise tmesh.MeshDecline("window taller than the kernel")

    monkeypatch.setattr(tmesh, "mesh_enumerate_trials", decline)
    dists, _, _ = tdev.device_enumerate_windows(*trials, device="cpu")
    assert np.isfinite(dists).any()

    def broken(*a, **k):
        raise RuntimeError("shard lost")

    monkeypatch.setattr(tmesh, "mesh_enumerate_trials", broken)
    with pytest.raises(RuntimeError, match="shard lost"):
        tdev.device_enumerate_windows(*trials, device="cpu")
