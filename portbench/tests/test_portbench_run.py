"""run.py refuses to run without a card: no result line, a non-zero
exit, and never a fall-back to the CPU."""

import json
import os
import subprocess
import sys

import portbench_support as sup

CELL = "svpchal80-bkz2.b60-windows"


def _run(cwd, env_extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **env_extra)
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_run_without_a_card_prints_no_result_and_fails():
    out = _run(sup.ROOT, {})
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "CUDA card" in out.stderr


def test_run_in_a_folder_of_only_the_benchmark_fails(tmp_path):
    sup.copy_benchmark(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["BENCHMARK.json", "portbench"]
    out = _run(str(tmp_path), {"FPLLL_TORCH_DEVICE": "cpu"})
    assert out.returncode != 0
    assert not _has_result(out.stdout)
