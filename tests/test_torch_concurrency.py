"""Thread safety of the port's native cores and of its loader
(tests/test_concurrency.py).

The port loads its own copies of the C cores through its own loader
(`fplll_tpu_torch/native/__init__.py`: its own cache, a build to a
private name renamed into place, a raise on failure). ctypes releases the
GIL inside the native calls, so global mutable state in a core would
corrupt concurrent runs. Each workload runs single-threaded first, where
it must equal the JAX package's, then in two threads at once, where every
thread's result must equal the single-thread result. The bases are made
before the threads start: the process-global `RandGen` is not seeded from
two threads (ROADMAP.md, "Not faults").
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

import fplll_tpu as fl
import fplll_tpu.native as jax_native
import fplll_tpu_torch as ft
import fplll_tpu_torch.native as native
from fplll_tpu_torch.interop import basis_from_rows
from jax_reference import jax_native_cores  # noqa: F401 (autouse)


def problem(seed, d=24):
    """An LLL-reduced q-ary basis' exact GSO and 1.2 times its Gaussian
    heuristic radius."""
    from fplll_tpu_torch.defs import GSO_INT_GRAM

    ft.RandGen.init_with_seed(seed)
    b = ft.gen.gen_qary_bits(d, d // 2, 12)
    ft.lll_reduction(b)
    gso = ft.MatGSO(b, flags=GSO_INT_GRAM, ctx=ft.MPCtx(90))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, d)
    log_ball = (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)
    gh2 = math.exp(float(np.mean(np.log(rdiag))) - 2.0 * log_ball / d)
    return np.asarray(mut), np.asarray(rdiag), 1.2 * gh2


def race(work, threads=2):
    """work(tid) in `threads` threads at once; re-raises the first
    error."""
    errs = []

    def run(tid):
        try:
            work(tid)
        except BaseException as exc:    # noqa: BLE001 - re-raised below
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def same_enum(a, b):
    # (maxdist, best_dist, best_x, sol_count, nodes, visited)
    assert a[0] == b[0] and a[1] == b[1]
    assert np.array_equal(a[2], b[2])
    assert np.array_equal(a[4], b[4]) and a[5] == b[5]


def test_concurrent_native_enumeration():
    probs = [problem(seed) for seed in (11, 29, 47, 83)]
    expected = [native.native_enumerate(mut, rdiag, None, None, A, True,
                                        False, False)
                for mut, rdiag, A in probs]
    for exp, (mut, rdiag, A) in zip(expected, probs):
        same_enum(exp, jax_native.native_enumerate(mut, rdiag, None, None,
                                                   A, True, False, False))
    results = [[None] * len(probs) for _ in range(2)]

    def work(tid):
        for _ in range(6):
            for i, (mut, rdiag, A) in enumerate(probs):
                results[tid][i] = native.native_enumerate(
                    mut, rdiag, None, None, A, True, False, False)

    race(work)
    for tid in range(2):
        for got, exp in zip(results[tid], expected):
            same_enum(got, exp)


def test_concurrent_native_lll():
    seeds = (5, 17, 31)
    inputs = {}
    for s in seeds:
        fl.RandGen.init_with_seed(s)
        inputs[s] = fl.gen.gen_uniform(20, 30)
    expected = {}
    for s in seeds:
        bj, bt = inputs[s].copy(), basis_from_rows(inputs[s].a)
        assert jax_native.native_lll_fast(bj) == 0
        assert native.native_lll_fast(bt) == 0
        assert bt.a.tolist() == bj.a.tolist()
        expected[s] = bt.a.tolist()

    def work(tid):
        for _ in range(4):
            for s in seeds:
                b = basis_from_rows(inputs[s].a)
                assert native.native_lll_fast(b) == 0
                assert b.a.tolist() == expected[s]

    race(work)


def test_concurrent_root_expansion():
    """native_gen_roots shares scratch buffers across calls; the lock must
    keep concurrent expansions from racing on them."""
    probs = [problem(seed, d=30) for seed in (7, 13)]
    cp0 = np.zeros(30)
    expected = [native.native_gen_roots(mut, rdiag, None, cp0, A, True,
                                        False, 20, 256)
                for mut, rdiag, A in probs]
    for exp, (mut, rdiag, A) in zip(expected, probs):
        ref = jax_native.native_gen_roots(mut, rdiag, None, cp0, A, True,
                                          False, 20, 256)
        assert exp[3] == ref[3]
        for k in (0, 2, 4):
            assert np.array_equal(exp[k], ref[k])
    results = [[None, None] for _ in range(2)]

    def work(tid):
        for _ in range(20):
            for i, (mut, rdiag, A) in enumerate(probs):
                results[tid][i] = native.native_gen_roots(
                    mut, rdiag, None, cp0, A, True, False, 20, 256)

    race(work)
    for tid in range(2):
        for got, exp in zip(results[tid], expected):
            assert got[3] == exp[3]
            for k in (0, 2, 4):
                assert np.array_equal(got[k], exp[k])


def test_concurrent_root_queues():
    """DeviceEnumerator's frontier and queue (the native expansion, the
    sort and write into the device's one staging buffer, the copy out of
    it) in more threads than cores at once, switching often, on two
    problems, primal and dual: every thread gets the single-thread
    tensors."""
    from fplll_tpu_torch.enum.device import DeviceEnumerator

    probs = [problem(seed, d=30) for seed in (7, 13)]
    cp0 = np.zeros(30)

    def queue(i):
        mut, rdiag, A = probs[i]
        enum = DeviceEnumerator(batch=64, device="cpu")
        enum.nodes = np.zeros(30, dtype=np.int64)
        dual = i == 1
        xs, als, pd, m = enum._gen_roots(mut, rdiag, np.ones(30), cp0, A,
                                         30, True, dual=dual)
        out = enum._pack(mut, rdiag, np.ones(30), cp0, 30, xs, pd, m,
                         als if dual else None)
        return out, enum.nodes.copy()

    expected = [queue(i) for i in range(2)]
    assert "roots_a" in expected[1][0] and "roots_a" not in expected[0][0]
    threads = (os.cpu_count() or 1) + 1
    results = [[None, None] for _ in range(threads)]

    def work(tid):
        for _ in range(10):
            for i in (tid % 2, 1 - tid % 2):
                results[tid][i] = queue(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        race(work, threads=threads)
    finally:
        sys.setswitchinterval(interval)
    for tid in range(threads):
        for (got, nodes), (want, want_nodes) in zip(results[tid], expected):
            assert np.array_equal(nodes, want_nodes)
            assert got.keys() == want.keys()
            for k, t in want.items():
                if isinstance(t, torch.Tensor):
                    assert torch.equal(got[k], t), k
                else:
                    assert got[k] == t, k


def test_concurrent_builds_rename_into_place(tmp_path, monkeypatch):
    """Four threads build the enumeration core into one empty cache at
    once: each gets a whole shared object (built to a private name and
    renamed), no private file is left behind, and each loads and
    enumerates as the shared build does."""
    import ctypes

    monkeypatch.setenv("FPLLL_TORCH_NATIVE_CACHE", str(tmp_path))
    paths = [None] * 4

    def work(tid):
        paths[tid] = native._compile("enum_core.c", "enum_core.so")

    race(work, threads=4)
    assert len(set(paths)) == 1
    assert os.listdir(tmp_path) == ["enum_core.so"]
    lib = ctypes.CDLL(paths[0])
    assert hasattr(lib, "enum_run") and hasattr(lib, "enum_gen_roots")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises (the port never goes on
    without a core) and leaves nothing in the cache."""
    monkeypatch.setenv("FPLLL_TORCH_NATIVE_CACHE", str(tmp_path))
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.c").write_text("int f( {\n")
    monkeypatch.setattr(native, "_HERE", str(src))
    with pytest.raises(RuntimeError, match="native build of broken.c"):
        native._compile("broken.c", "broken.so")
    assert sorted(os.listdir(tmp_path)) == ["src"]
