"""The donation and the barren-descend lookahead of the enumeration kernel.

`csrc/enum_chunk.cu` hands the sibling ranges of a busy walker's top
level to idle walkers once the root queues have drained (the Pallas
kernel's top-sibling donation), and its instances of the primal, dual
and sub-solution walks (f32 and f64) skip a descend whose nearest child
already fails (the barren-descend lookahead); the plain version's forms
run the same lookahead. The extended instance, which runs the combined
forms (dual with sub-solutions) and to which any tree can still be sent
by name (`kernels._enum_run_extended`), has none. An adoptee re-derives the center sums below the donated level
from its root, and a skipped descend skips an f32 subtract/restore round
trip, so on realistic trees counts may move at ULP level (the tolerance
of tests/test_pallas_parity.py). On the dyadic trees here every sum and
product of the walk is exact in f32, so every round trip is exact: the
emulated kernel must give the plain version's counts, and the JAX
package's `tpu._enum_run`'s, exactly, at every walker width and grid, in
every instance and height bucket, which shows that no subtree is lost or
walked twice.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from fplll_tpu.enum.tpu import TPUEnumerator, _enum_run
from fplll_tpu.jaxsetup import jnp
from fplll_tpu_torch.enum import kernels
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from test_torch_enum_kernel import EMU_THREADS, WIDTHS, host_build  # noqa: F401

torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
KEYS = ("mut", "rdiag", "prune", "mut_fix", "cp0", "rx", "ra", "rpd")


def dyadic_tree(d, seed, pruned=False, dual=False, radius=1.0):
    """(mut, rdiag, prune, A) of a tree whose walk is exact in f32: mu
    multiples of 1/16 in [-1/2, 1/2] (integers in [-1, 1] for the dual
    recurrence, whose alpha would gain bits at every level), rdiag powers
    of two from 4 down to 1/4, pruning in eighths, and the bound `radius`
    times the Gaussian heuristic rounded up to eighths."""
    rng = np.random.default_rng(seed)
    if dual:
        mut = np.triu(rng.integers(-1, 2, (d, d)).astype(np.float64), 1)
    else:
        mut = np.triu(rng.integers(-8, 9, (d, d)) / 16.0, 1)
    rdiag = np.ldexp(1.0, np.round(np.linspace(2, -2, d)).astype(int))
    prune = np.ones(d)
    if pruned:
        for i in range(d // 2, d):
            prune[d - 1 - i] = np.ceil(8 * max((d - i) / d, 0.6)) / 8
    gh = math.exp(float(np.mean(np.log(rdiag))) +
                  2 * math.lgamma(d / 2 + 1) / d) / math.pi
    return mut, rdiag, prune, math.ceil(8 * radius * gh) / 8


def padded(tree, dual=False, root_factor=1, single_root=False, m=None):
    """The tree as the enumerators pad it (tests/test_torch_enum_f64.py):
    f64 arrays of height m (the next multiple of 8 unless given), roots
    expanded by the JAX package's host code at `root_factor` roots per
    lane of 128, or one zero-length root over the whole tree;
    host_nodes, the nodes the host expansion counted per level."""
    mut, rdiag, prune, A = tree
    d = len(rdiag)
    host_nodes = np.zeros(d, dtype=np.int64)
    if single_root:
        rx = ra = np.zeros((1, 0))
        rpd, m_real = np.zeros(1), d
    else:
        e = TPUEnumerator(batch=128, dtype=np.float64)
        e.target_root_factor = root_factor
        e.nodes = host_nodes
        rx, ra, rpd, m_real = e._gen_roots(mut, rdiag, prune, np.zeros(d), A,
                                           d, True, dual=dual)
        o = np.argsort(rpd)
        rx, ra, rpd = rx[o], ra[o], rpd[o]
    nfix = d - m_real
    m = m or ((m_real + 7) // 8) * 8
    P = dict(mut=np.zeros((m, m)), rdiag=np.full(m, 1e30), prune=np.ones(m),
             cp0=np.zeros(m))
    P["mut"][:m_real, :m_real] = mut[:m_real, :m_real]
    P["rdiag"][:m_real] = rdiag[:m_real]
    P["prune"][:m_real] = prune[:m_real]
    nfp = 0 if nfix == 0 else 8
    while nfp < nfix:
        nfp *= 2
    P["mut_fix"] = np.zeros((m, nfp))
    P["mut_fix"][:m_real, :nfix] = mut[:m_real, m_real:d]
    R = 1 if single_root else 1024
    while R < len(rpd):
        R *= 2
    P["rx"], P["ra"] = np.zeros((R, nfp)), np.zeros((R, nfp))
    P["rpd"] = np.full(R, np.inf)
    P["rx"][:len(rpd), :nfix], P["ra"][:len(rpd), :nfix] = rx, ra
    P["rpd"][:len(rpd)] = rpd
    return dict(P=P, A=A, m=m, m_real=m_real, host_nodes=e.nodes if not
                single_root else host_nodes)


def tensors(prob, dtype):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in prob["P"].items()}


def run_plain(prob, dtype, *, dual=False, findsubsols=False,
              count_mode=True, ext=False):
    t = tensors(prob, dtype)
    run = kernels._enum_run_extended if ext else kernels.enum_run
    return run(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"], t["rx"],
        t["rpd"], prob["A"], m=prob["m"], is_svp=True, count_mode=count_mode,
        max_steps=1 << 26, batch=128, roots_a=t["ra"], dual=dual,
        findsubsols=findsubsols)


def run_jax(prob, dtype, *, dual=False, findsubsols=False, count_mode=True):
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    s = _enum_run(*[jnp.asarray(prob["P"][k], jdt) for k in KEYS],
                  jnp.asarray(prob["A"], jdt), m=prob["m"], is_svp=True,
                  count_mode=count_mode, max_steps=1 << 24, batch=128,
                  dual=dual, findsubsols=findsubsols)
    return {k: np.asarray(v) for k, v in s.items()}


def run_host(lib, prob, dtype, *, grid, dual=False, findsubsols=False,
             count_mode=True, G=1, G_real=1, max_steps=1 << 40,
             threads=EMU_THREADS, ext=False):
    """One emulated launch over G copies of the problem (the first G_real
    real, the rest padding with bound 0), on the extended instance where
    `ext` names it; returns the raw outputs."""
    t = {k: v[None].expand(G, *v.shape).contiguous()
         for k, v in tensors(prob, dtype).items()}
    a0 = torch.tensor([prob["A"]] * G_real + [0.0] * (G - G_real),
                      dtype=dtype)
    mr = torch.full((G,), prob["m_real"], dtype=torch.int32)
    walkers = grid * threads // lib.enum_chunk_emulated_width()
    p, out = kernels._prepare(
        t["mut"], t["rdiag"], t["prune"], t["mut_fix"], t["cp0"], t["rx"],
        t["rpd"], a0, mr, G_real=G_real, walkers=walkers, is_svp=True,
        count_mode=count_mode, max_steps=max_steps, roots_a=t["ra"],
        dual=dual, findsubsols=findsubsols, ext=ext)
    assert lib.enum_chunk_emulate(ctypes.byref(p), grid, threads) == 0
    out["walkers"] = walkers
    return out


_TREES = {}


def tree_problem(d, seed, pruned=False, dual=False, radius=1.0, **kw):
    key = (d, seed, pruned, dual, radius, tuple(sorted(kw.items())))
    if key not in _TREES:
        _TREES[key] = padded(dyadic_tree(d, seed, pruned, dual, radius), dual,
                             **kw)
    return _TREES[key]


# (name, element type, dual, sub-solutions, extended instance by name):
# every instance of the kernel, each form on the instance it launches
# (the combined form on the extended one), and the f64 primal, dual and
# sub-solution trees also on the extended instance ("-extended", named
# through EnumParams.ext); every instance but the extended one has the
# lookahead
INSTANCES = [("single", F32, False, False, False),
             ("f64", F64, False, False, False),
             ("f64-extended", F64, False, False, True),
             ("f32-dual", F32, True, False, False),
             ("f32-dual-extended", F32, True, False, True),
             ("f64-dual", F64, True, False, False),
             ("f64-dual-extended", F64, True, False, True),
             ("f32-subsols", F32, False, True, False),
             ("f32-subsols-extended", F32, False, True, True),
             ("f64-subsols", F64, False, True, False),
             ("f64-subsols-extended", F64, False, True, True),
             ("f64-dual-subsols", F64, True, True, False)]
IDS = [i[0] for i in INSTANCES]


def has_lookahead(dual, subsols, ext) -> bool:
    """Whether the instance of a launch skips barren descends: all but the
    extended one."""
    return kernels._walk(dual, subsols, ext) != kernels.WALK_EXT
# (d, seed, pruned, radius): the primal trees, about 1e4 nodes each; the
# dual recurrence runs on the d = 20 tree of its own mu, pruned (6,404
# nodes): its integer mu keep every center an integer, so in an unpruned
# tree a child's nearest integer always passes and no descend is barren,
# while the pruned one's falling coefficients give the lookahead work
PRIMAL, DUAL = (24, 1, False, 1.0), (20, 1, True, 1.25)


def instance_tree(dual, **kw):
    d, seed, pruned, radius = DUAL if dual else PRIMAL
    return tree_problem(d, seed, pruned, dual, radius, **kw)


def full_counts(dual, dtype):
    """Per-level nodes of the whole tree and its solution count: the
    plain version's device levels of the rooted form, the host
    expansion's above them."""
    prob = instance_tree(dual)
    ref = run_plain(prob, dtype, dual=dual)
    mr = prob["m_real"]
    nodes = np.concatenate([ref["nodes"].numpy()[:mr],
                            np.asarray(prob["host_nodes"])[mr:]])
    return nodes, int(ref["sol_count"])


@pytest.mark.parametrize("tree", [(24, 1, False, 1.0), (24, 2, True, 1.0),
                                  (20, 1, False, 1.25)])
def test_dyadic_trees_are_exact_in_f32(tree):
    """The premise of the exact tests: the plain version counts the same
    per-level nodes and solutions in f32 and in f64, both with the
    lookahead (which skips barren descends here), and in both without it
    (the extended instance's walk), and so does the dual recurrence on
    its tree."""
    for dual, prob in ((False, tree_problem(*tree[:3], False, tree[3])),
                       (True, instance_tree(True))):
        runs = [run_plain(prob, dt, dual=dual, ext=ext)
                for ext in (False, True) for dt in (F32, F64)]
        for r in runs[1:]:
            np.testing.assert_array_equal(runs[0]["nodes"].numpy(),
                                          r["nodes"].numpy())
            assert int(runs[0]["sol_count"]) == int(r["sol_count"])
        assert [r["barren_skips"] > 0 for r in runs] == \
            [True, True, False, False]


@pytest.mark.parametrize("name,dtype,dual,subsols,ext", INSTANCES, ids=IDS)
def test_plain_matches_jax_on_dyadic_trees(name, dtype, dual, subsols, ext):
    """Every form of the plain version, and each walk without the
    lookahead, against tpu._enum_run (whose XLA walk has no
    lookahead) on the dyadic trees, count and search mode: per-level
    nodes, solution count, best distance and sub-solution distances
    exactly equal (a barren node's sibling step takes the lockstep step
    of its failing child, so a search's bound falls at the same steps)."""
    prob = instance_tree(dual)
    assert kernels._form(dtype, dual, subsols) == name.replace("-extended",
                                                               "")
    for count_mode in (True, False):
        kw = dict(dual=dual, findsubsols=subsols, count_mode=count_mode)
        pt = run_plain(prob, dtype, ext=ext, **kw)
        jx = run_jax(prob, dtype, **kw)
        assert float(pt["best_dist"][0]) == float(jx["best_dist"].min())
        np.testing.assert_array_equal(pt["nodes"].numpy(),
                                      jx["nodes"].astype(np.int64))
        assert int(pt["sol_count"]) == int(jx["sol_count"].sum())
        assert float(pt["best_dist"][0]) == float(jx["best_dist"].min())
        if subsols and count_mode:
            mr = prob["m_real"]
            np.testing.assert_array_equal(pt["subsol_dist"].numpy()[:mr],
                                          jx["subsol_dist"][:mr])
        assert (pt["barren_skips"] > 0) == has_lookahead(dual, subsols, ext)


@pytest.mark.parametrize("single_root", [False, True],
                         ids=["queue", "one-root"])
@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name,dtype,dual,subsols,ext", INSTANCES, ids=IDS)
def test_host_kernel_exact_on_dyadic_trees(host_build, name, dtype, dual,
                                           subsols, ext, width, grid,
                                           single_root):
    """Count mode, every instance at every walker width and grid, the
    root queue and one root over the whole tree (where every walker but
    the first gets its work by donation): per-level nodes and solutions
    exactly the plain version's (and so tpu._enum_run's), and the
    sub-solution distances too on the queue form; every instance but the
    extended one skips barren descends."""
    prob = instance_tree(dual, single_root=single_root)
    out = run_host(host_build(width), prob, dtype, grid=grid, dual=dual,
                   findsubsols=subsols, ext=ext)
    assert int(out["aborted"]) == 0
    nodes, sols = full_counts(dual, dtype)
    mr = prob["m_real"]
    np.testing.assert_array_equal(out["nodes"].numpy()[0, :mr], nodes[:mr])
    assert int(out["sols"][0]) == sols
    if single_root:
        assert int(out["donations"]) > 0
    if subsols and not single_root:
        ref = run_plain(prob, dtype, dual=dual, findsubsols=True)
        np.testing.assert_array_equal(out["ss_dist"].numpy()[0, :mr],
                                      ref["subsol_dist"].numpy()[:mr])
    assert (int(out["barren_skips"]) > 0) == has_lookahead(dual, subsols,
                                                            ext)
    assert int(out["walk_steps"]) >= int(out["steps"]) >= \
        int(out["root_steps"]) > 0


@pytest.mark.parametrize("name,dtype,dual,subsols,ext", INSTANCES, ids=IDS)
def test_host_kernel_exact_on_dyadic_trees_in_a_taller_bucket(
        host_build, name, dtype, dual, subsols, ext):
    """The one-root trees padded to the M = 64 bucket (levels above
    m_real are padding, which neither the walk nor a donation enters):
    the counts of the M = 32 runs."""
    prob = instance_tree(dual, single_root=True, m=64)
    out = run_host(host_build(16), prob, dtype, grid=2, dual=dual,
                   findsubsols=subsols, ext=ext)
    nodes, sols = full_counts(dual, dtype)
    mr = prob["m_real"]
    np.testing.assert_array_equal(out["nodes"].numpy()[0, :mr], nodes[:mr])
    assert int(out["sols"][0]) == sols and int(out["donations"]) > 0


def test_donation_shortens_the_longest_walk(host_build):
    """One walker walks the one-root tree alone (no donation); 24 walkers
    share it by donation with the same counts, and the longest walk of a
    walker falls well below the lone walker's, as does the longest work
    item's."""
    prob = instance_tree(False, single_root=True)
    one = run_host(host_build(32), prob, F32, grid=1, threads=32)
    many = run_host(host_build(8), prob, F32, grid=3)
    assert (one["walkers"], many["walkers"]) == (1, 24)
    assert int(one["donations"]) == 0 and int(many["donations"]) > 0
    np.testing.assert_array_equal(many["nodes"].numpy(), one["nodes"].numpy())
    assert int(many["sols"][0]) == int(one["sols"][0])
    assert int(one["steps"]) == int(one["root_steps"]) == \
        int(one["walk_steps"])
    assert int(many["steps"]) < int(one["steps"]) / 4
    assert int(many["root_steps"]) <= int(many["steps"])


def test_donation_under_an_all_zero_svp_prefix(host_build):
    """The one root has partial distance 0, so the first donation gives
    away the top level under an all-zero prefix: stopped at the step cap
    right after it, the first mailbox holds the top level, x = 0 and
    pd = 0. The adoptee must continue at x + 1 (the zig-zag would walk
    the negated vectors a second time), which the exact counts of the
    whole run show."""
    prob = instance_tree(False, single_root=True)
    mr, m = prob["m_real"], prob["m"]
    first = run_host(host_build(32), prob, F32, grid=1, max_steps=40)
    assert int(first["aborted"]) == 1 and int(first["donations"]) == 1
    assert int(first["mailbox"][0, 3]) == mr - 1
    assert float(first["mail"][0, mr - 1]) == float(first["mail"][0, 2 * m])
    assert float(first["mail"][0, 2 * m]) == 0.0
    out = run_host(host_build(32), prob, F32, grid=1)
    assert int(out["donations"]) > 0
    nodes, sols = full_counts(False, F32)
    np.testing.assert_array_equal(out["nodes"].numpy()[0, :mr], nodes[:mr])
    assert int(out["sols"][0]) == sols


def test_grouped_donation_gives_padding_problems_no_work(host_build):
    """Three real copies of the one-root tree and one padding problem in
    one grouped launch: each real problem counts the whole tree exactly,
    with donations carrying their problem; the padding problem gets no
    node and no best."""
    prob = instance_tree(False, single_root=True)
    out = run_host(host_build(16), prob, F32, grid=3, G=4, G_real=3)
    nodes, sols = full_counts(False, F32)
    mr = prob["m_real"]
    assert int(out["donations"]) > 0
    for g in range(3):
        np.testing.assert_array_equal(out["nodes"].numpy()[g, :mr],
                                      nodes[:mr])
        assert int(out["sols"][g]) == sols
    assert int(out["nodes"][3].sum()) == 0 and int(out["sols"][3]) == 0
    walkers = out["walkers"]
    assert torch.isinf(out["bdist"][3 * walkers:]).all()
    assert int(out["bdist"][:3 * walkers].isfinite().sum()) > 0
