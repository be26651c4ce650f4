"""On the card: one short run of the window cell through run.py, whose
result line carries every key a benchmark result holds and whose answers hold
against the reference. Skips without a card (decided in the fixture)."""

import json
import os
import subprocess
import sys

import pytest

import portbench_support as sup


@pytest.fixture
def card():
    sup.card()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_window_cell_runs_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "svpchal80-bkz2.b60-windows", "--seed", str(2 ** 31 + 17 + trace),
         "--seconds", "5", "--trace", str(trace)],
        cwd=sup.ROOT, env=dict(os.environ), capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    bench = sup.bench_json()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if "svpchal80-bkz2.b60-windows" in m.get("workloads", [
                "svpchal80-bkz2.b60-windows"])}
    assert set(res["metrics"]) <= want
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert 0 < res["metrics"]["enum_roofline_pct"]["value"] <= 100
    else:
        assert set(res["metrics"]) == want
