"""Shared pieces of the benchmark's tests: a copy of the benchmark in a
temporary folder, and a small cell (dim-40 lattices of the SVP
Challenge's form, block-28 windows) that runs on the CPU with the port's plain versions in place of
the kernel, once the facade's smallest device dimension is lowered to
MIN_DIM and its first pass to HYBRID_NODES."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

SMALL = "qsmall.w28"
MIN_DIM = "20"
HYBRID_NODES = "50"
SMALL_CONFIG = {
    "name": "qsmall",
    "block_size": 28,
    "radius": {"delta": 0.99, "gh_factor": 1.1},
    "reduced": ["n", "det_bits"],
    "pool": {"maker": "challenge_windows", "file": "qsmall.npz",
             "seeds": [3, 4], "generator": {"n": 40, "bits": 400},
             "block_size": 28, "kappa": [0, 5], "delta": 0.99,
             "gh_factor": 1.1}}
SMALL_TRAFFIC = {"name": "w28", "table": "win", "rounds_over": "kappa",
                 "spread_over": "lattice", "warmup": [0]}


def card():
    """Skip the calling test unless a CUDA card is present (decided when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def bench_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def copy_benchmark(dst: str) -> str:
    """A checkout-like copy under `dst`: BENCHMARK.json and portbench/
    (without its tests). Returns the copy's portbench folder."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    out = os.path.join(dst, "portbench")
    shutil.copytree(BENCH_DIR, out, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    return out


def add_small_cell(bench_dir: str, sample: int = 50) -> dict:
    """Write the small cell's config, traffic, cell file and pool under
    `bench_dir` (pool made by make_data on the CPU); returns the cell's
    BENCHMARK.json workload entry."""
    from fplll_tpu_torch.algs.bkz_param import load_strategies_json
    from portbench import make_data

    strategies = load_strategies_json("default.json")
    cfg = dict(SMALL_CONFIG, pruning={"sets": [
        {"gh_factor": p.gh_factor,
         "coefficients": [float(c) for c in p.coefficients]}
        for p in strategies[28].pruning_parameters]})
    old = {k: os.environ.get(k) for k in ("FPLLL_TORCH_DEVICE",
                                          "FPLLL_TPU_HYBRID_NODES")}
    os.environ["FPLLL_TORCH_DEVICE"] = "cpu"
    os.environ["FPLLL_TPU_HYBRID_NODES"] = str(1 << 62)
    try:
        arrays, prov = make_data.challenge_windows(cfg["pool"],
                                                   cfg["pruning"]["sets"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    make_data.write_pool(bench_dir, "qsmall", cfg["pool"], arrays, prov)
    for sub, name, obj in (("configs", "qsmall", cfg),
                           ("traffic", "w28", SMALL_TRAFFIC),
                           ("cells", SMALL, {
                               "name": SMALL, "config": "qsmall",
                               "traffic": "w28", "entry": "fpylll_window",
                               "judge": "windows", "sample": sample,
                               "limits": {"failed": 0, "bad_answers": 0,
                                          "answer_err": 3e-3},
                               "control": {"dtype": "bfloat16"}})):
        with open(os.path.join(bench_dir, sub, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return {"name": SMALL, "config": "qsmall", "traffic": "w28",
            "chips": 1, "why": "test"}


def small_bench(work: dict) -> dict:
    """BENCHMARK.json with the small cell added."""
    bench = bench_json()
    bench["workloads"].append(work)
    bench["configs"].append({"name": "qsmall", "source": "test",
                             "file": "portbench/configs/qsmall.json",
                             "reduced": [], "why": "test"})
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"].append(SMALL)
    return bench
