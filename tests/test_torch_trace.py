"""The port's recorder (fplll_tpu_torch.trace): spans, counters and
launch records, off and on.

Off, a span costs one read of a module global: a solve records nothing,
reads no clock and makes no CUDA event. On, one solve of a pruned
window through the fpylll veneer, with the facade's smallest device
dimension and its first pass lowered so that the window takes the
device path (the plain version on the CPU), gives one request's tree of
spans: facade.enumerate over facade.first_pass, enum.roots (over
enum.roots.native), enum.pack (over enum.pack.h2d) and kernels.run. The
card test holds each launch's CUDA-event interval, placed on the host
clock, inside its kernels.run span and before the end of its wait."""

import inspect
import threading

import numpy as np
import pytest
import torch

import fplll_tpu_torch as ft
from fplll_tpu_torch import native, trace
from fplll_tpu_torch.algs.bkz_param import load_strategies_json
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.fpylll import LLL, GSO, Enumeration, IntegerMatrix
from fplll_tpu_torch.nr.rng import RandGen

BLOCK = 28
TREE = ("facade.first_pass", "enum.roots", "enum.pack", "kernels.run")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    assert not trace.on()
    yield
    if trace.on():
        trace.stop()


@pytest.fixture
def window(monkeypatch):
    """solve(): one pruned block-28 window of an LLL-reduced q-ary basis
    through the veneer, on the device path (the first pass cut to 50
    iterations, the smallest device dimension to 20)."""
    monkeypatch.setattr(tdev, "_MIN_TPU_DIM", 20)
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    RandGen.init_with_seed(7)
    A = IntegerMatrix.random(40, "qary", k=20, bits=20)
    LLL.reduction(A)
    pruning = [float(c) for c in load_strategies_json("default.json")[
        BLOCK].pruning_parameters[0].coefficients]

    def solve(device):
        monkeypatch.setenv("FPLLL_TORCH_DEVICE", device)
        M = GSO.Mat(A)
        M.update_gso()
        return Enumeration(M).enumerate(0, BLOCK, 1.01 * M.get_r(0, 0), 0,
                                        pruning=pruning)
    return solve


class _NoClock:
    @staticmethod
    def perf_counter_ns():
        raise AssertionError("a span read the clock with the recorder off")


def test_off_solve_records_nothing(window, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event with the recorder off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(trace, "time", _NoClock)
    plain = sum(kernels.PLAIN_RUNS.values())
    assert window("cpu")
    assert sum(kernels.PLAIN_RUNS.values()) == plain + 1
    monkeypatch.undo()
    trace.start()
    snap = trace.stop()
    assert snap.spans == [] and snap.counts == {} and snap.launches == []


def test_on_solve_gives_one_request_tree(window, monkeypatch):
    seen = []
    monkeypatch.setattr(tdev, "_STAGING", {})   # a staging buffer to grow

    def spy(*a, **k):
        out = native_enumerate(*a, **k)
        seen.append(out)
        return out
    native_enumerate = native.native_enumerate
    monkeypatch.setattr(native, "native_enumerate", spy)
    trace.start()
    try:
        assert window("cpu")
    finally:
        snap = trace.stop()
    by_id = {s.id: s for s in snap.spans}
    root, = snap.named("facade.enumerate")
    assert root.parent is None
    assert {s.request for s in snap.spans} == {root.request}
    for s in snap.spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    kids = {s.name: s for s in snap.spans if s.parent == root.id}
    assert set(TREE) <= set(kids)
    for child, parent in (("enum.roots.native", "enum.roots"),
                          ("enum.pack.h2d", "enum.pack")):
        s, = snap.named(child)
        assert s.parent == kids[parent].id
    # no launch on the CPU: the wrappers ran the plain version
    assert snap.launches == [] and not snap.named("kernels.wait")
    (_, _, _, _, cnodes, visited), = seen
    assert snap.counts == {"first_pass.iters": visited,
                           "first_pass.nodes": int(np.sum(cnodes)),
                           "enum.frontier.native": 1,
                           "enum.stage.grown": 1}
    assert visited == 50


@pytest.mark.parametrize("subsols", [False, True])
def test_frontier_counters_name_the_expansion(subsols, monkeypatch):
    """A search counts the expansion that built each launch's frontier:
    the C core's once per launch, the NumPy level loop's (sub-solutions)
    once per frontier it builds; a staging buffer large enough already
    is not grown again."""
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.enum.evaluator import FastEvaluator

    RandGen.init_with_seed(3)
    b = ft.gen.gen_qary_bits(30, 15, 12)
    ft.lll_reduction(b)
    gso = ft.MatGSO(b, flags=GSO_INT_GRAM, ctx=ft.MPCtx(90))
    gso.update_gso()
    mut, rdiag, _ = gso.export_mu_r(0, 30)
    mut, rdiag = np.asarray(mut), np.asarray(rdiag, dtype=np.float64)
    radius = 1.1 * tdev.gh_squared(rdiag)
    launches = []
    monkeypatch.setattr(tdev, "enum_run", lambda **kw: launches.append(
        kw) or kernels.enum_run(**kw))
    ev = FastEvaluator(find_subsolutions=subsols)
    enum = tdev.DeviceEnumerator(batch=64, device="cpu")
    prune = np.linspace(1.0, 0.3, 30)
    enum.enumerate(mut, rdiag, prune, np.zeros(30), radius, True,
                   ev)      # grows the staging buffer if it must
    trace.start()
    try:
        enum.enumerate(mut, rdiag, prune, np.zeros(30), radius, True, ev)
    finally:
        snap = trace.stop()
    name = "enum.frontier.python" if subsols else "enum.frontier.native"
    assert len(launches) == 2
    assert snap.counts == {name: 1}


def test_spans_nest_per_thread_and_count():
    def work():
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("n", 2)
    trace.start()
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    work()
    snap = trace.stop()
    outer = snap.named("outer")
    assert len(outer) == 5 and len({s.request for s in outer}) == 5
    for s in snap.named("inner"):
        p, = [o for o in outer if o.id == s.parent]
        assert p.request == s.request
    assert snap.counts == {"n": 10}
    assert snap.seconds("outer") >= snap.seconds("inner") > 0


@pytest.mark.parametrize("call", ["stop", "start"])
def test_start_and_stop_refuse_out_of_turn(call):
    if call == "start":
        trace.start()
    with pytest.raises(RuntimeError):
        getattr(trace, call)()


def test_spanned_keeps_the_signature():
    """The benchmark's spans bind the wrappers' arguments by signature."""
    assert inspect.signature(kernels.enum_run).parameters["A0"]
    assert "hard_cap" in inspect.signature(
        tdev.DeviceEnumerator._gen_roots).parameters
    assert kernels.enum_run.__name__ == "enum_run"


class _FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_stop_resolves_launches_and_sweeps():
    """A launch record's events become kernel_ms (and a host interval
    where its card had a reference event); a sweep's shard record takes
    its launch's device and kernel_ms."""
    trace.start()
    with trace.span("kernels.run"):
        rec = trace.record_launch({"form": "single", "device": 0,
                                   "events": (_FakeEvent(1.0),
                                              _FakeEvent(3.5))})
    trace.record_sweep([{"shard": 0, "launch": rec, "stole": False},
                        {"shard": 1, "stole": True}])
    snap = trace.stop()
    ln, = snap.launches
    assert ln["kernel_ms"] == 2.5 and "events" not in ln
    assert ln["span"] == snap.named("kernels.run")[0].id
    first, idle = snap.sweeps[0]
    assert first["device"] == "cuda:0" and first["kernel_ms"] == 2.5
    assert "launch" not in first and idle == {"shard": 1, "stole": True}


@pytest.mark.cuda
def test_launch_interval_lies_inside_its_run_and_wait(window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    window("cuda")      # builds the kernel outside the recording
    trace.start()
    try:
        window("cuda")
    finally:
        snap = trace.stop()
    by_id = {s.id: s for s in snap.spans}
    assert snap.launches
    for ln in snap.launches:
        s = by_id[ln["span"]]
        while s.name != "kernels.run":
            s = by_id[s.parent]
        wait, = [w for w in snap.named("kernels.wait") if w.parent == s.id]
        assert s.start_ns <= ln["start_ns"] < ln["end_ns"] <= wait.end_ns
        assert 0 < ln["walk_steps"] <= ln["walkers"] * ln["steps"]
