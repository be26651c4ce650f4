"""The control at a size a test run holds: the reference's own pruned
search, in place of the program and computed in bfloat16 (the precision
below the float32 the windows' trees state), must come out as not
correct, and the same search in float64 as correct. On the card, at the
cell's own size, portbench/readings.py reads the control over several
seeds."""

import pytest
import torch

import portbench_support as sup
from portbench.harness.registry import load_cell
from portbench.reference import judge, windows


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("control")
    bench_dir = sup.copy_benchmark(str(tmp))
    work = sup.add_small_cell(bench_dir)
    return load_cell(sup.small_bench(work), sup.SMALL, bench_dir)


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False),
                                           (torch.float64, True)])
def test_control_in_lower_precision_is_not_correct(small_cell, dtype,
                                                   correct):
    c = small_cell
    rows = list(range(len(c.table)))
    answered = windows.control(c.pool, c.config, c.table, rows, dtype)
    nums = windows.judge(c.pool, c.config, c.table, answered)
    nums["failed"] = 0.0
    ver = judge.verdict(nums, c.spec["limits"])
    assert ver["correct"] is correct, ver["checks"]
