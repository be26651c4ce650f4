"""A traced CPU run with the port's recorder on over the window
(``harness.program.recorded``, as ``trace_program.py`` runs it): the
recorder's metrics that have data on the CPU read it (the stage there
is the plain version's run), those of the card (the wait for a launch,
its finalize, the launch records, the card's timeline) read None, and
the benchmark's own per-layer metrics are those of a run without the
recorder."""

import time

import pytest

import portbench_support as sup
from portbench.harness import program
from portbench.harness.runner import run_cell

CPU = {"first_pass_iters_per_node", "roots_native_ms_per_launch",
       "pack_h2d_ms_per_launch", "wrapper_stage_ms_per_launch"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("program")
    bench_dir = sup.copy_benchmark(str(tmp))
    work = sup.add_small_cell(bench_dir)
    return sup.small_bench(work), bench_dir


@pytest.fixture
def traced(small, monkeypatch):
    bench, bench_dir = small
    from fplll_tpu_torch.enum import device
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", sup.HYBRID_NODES)
    monkeypatch.setattr(device, "_MIN_TPU_DIM", int(sup.MIN_DIM))

    def run(seed):
        return run_cell(bench, sup.SMALL, seed, 1.0, True, "cpu",
                        time.perf_counter(), bench_dir)
    return run


def test_recorder_metrics_on_the_cpu(traced):
    from fplll_tpu_torch import trace
    with program.recorded() as views:
        out = traced(5)
    assert not trace.on()
    view, = views
    assert out["correct"], out["checks"]
    snap = view.program
    assert len(snap.named("facade.enumerate")) == out["attempted"]
    got = program.read_all(view)
    assert set(got) == CPU
    assert got["first_pass_iters_per_node"]["value"] >= 1.0
    for name in set(program.METRICS) - CPU:
        assert program.reader(name)(view) is None
    plain = traced(5)
    assert set(out["metrics"]) == set(plain["metrics"])


def test_recorder_metrics_without_a_recorder():
    """A program without the recorder (no snapshot) reads None in every
    one of them, and raises nothing."""
    view = program.ProgramView()
    for name in program.METRICS:
        assert program.reader(name)(view) is None
