"""A whole run on the CPU (the look for a card skipped, the port's plain
versions in place of the kernel) with the timed path broken underneath
sees ``correct`` come out false, once for each fault a window can have:
a search that returns its state unchanged, half of its roots left out,
and an answer altered where the kernel produces it. (One card holds the
cell, so there is no exchange between chips to leave out.)"""

import time

import pytest
import torch

import portbench_support as sup
from portbench.harness.runner import run_cell


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    bench_dir = sup.copy_benchmark(str(tmp))
    work = sup.add_small_cell(bench_dir)
    return sup.small_bench(work), bench_dir


@pytest.fixture
def cpu_run(small, monkeypatch):
    bench, bench_dir = small
    from fplll_tpu_torch.enum import device
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    # every window past a few nodes goes to the (plain) kernel path
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", sup.HYBRID_NODES)
    monkeypatch.setattr(device, "_MIN_TPU_DIM", int(sup.MIN_DIM))

    def run(seed):
        return run_cell(bench, sup.SMALL, seed, 1.0, False, "cpu",
                        time.perf_counter(), bench_dir)
    return run


def _unchanged(orig):
    def run(**kw):
        kw["roots_pd"] = torch.full_like(kw["roots_pd"], float("inf"))
        return orig(**kw)
    return run


def _half_roots(orig):
    def run(**kw):
        pd = kw["roots_pd"].clone()
        pd[0::2] = float("inf")     # the first root, and every other
        kw["roots_pd"] = pd
        return orig(**kw)
    return run


def _altered(orig):
    def run(**kw):
        out = orig(**kw)
        out["best_dev"] = out["best_dev"].clone()
        out["best_dev"][:, 0] += 1
        return out
    return run


def test_sound_run_is_correct(cpu_run):
    out = cpu_run(11)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3 and out["failed"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _half_roots, _altered])
def test_fault_is_caught(cpu_run, monkeypatch, fault):
    from fplll_tpu_torch.enum import device
    monkeypatch.setattr(device, "enum_run", fault(device.enum_run))
    out = cpu_run(11)
    assert not out["correct"], out["checks"]
