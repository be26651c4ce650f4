"""The harness finds a cell, a configuration, a mix and a metric added as
new files, with no file of the benchmark edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import portbench_support as sup


def _files(top):
    out = {}
    for dp, _, fs in os.walk(top):
        if "__pycache__" not in dp:
            for f in fs:
                path = os.path.join(dp, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, top)] = fh.read()
    return out


def test_cell_added_as_new_files_is_found(tmp_path):
    bench_dir = sup.copy_benchmark(str(tmp_path))
    before = _files(bench_dir)
    for sub, old, new in (("configs", "svpchal80-bkz2", "svpchal80-copy"),
                          ("traffic", "b60-windows", "b60-copy")):
        shutil.copy(os.path.join(bench_dir, sub, f"{old}.json"),
                    os.path.join(bench_dir, sub, f"{new}.json"))
    with open(os.path.join(bench_dir, "cells",
                           "svpchal80-bkz2.b60-windows.json")) as f:
        spec = json.load(f)
    spec.update(name="svpchal80-copy.b60", config="svpchal80-copy",
                traffic="b60-copy")
    with open(os.path.join(bench_dir, "cells", "svpchal80-copy.b60.json"),
              "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench_dir, "metrics", "twice_rate.py"), "w") as f:
        f.write("def read(run):\n    return 2 * len(run.latencies)\n")
    bench = sup.bench_json()
    bench["configs"].append(dict(bench["configs"][0], name="svpchal80-copy"))
    bench["workloads"].append({"name": "svpchal80-copy.b60",
                               "config": "svpchal80-copy",
                               "traffic": "b60-copy", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "twice_rate", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "solves_per_s",
                               "workloads": ["svpchal80-copy.b60"]})
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    script = (
        "import json, sys\n"
        "from portbench.harness import registry\n"
        "from portbench.harness.runner import RunView\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "cell = registry.load_cell(bench, 'svpchal80-copy.b60')\n"
        "names = registry.metric_names(bench, 'svpchal80-copy.b60', "
        "'per_layer')\n"
        "view = RunView(0.0, 1.0, [0.1, 0.2], [True, True])\n"
        "print(json.dumps({'rows': len(cell.table), 'names': names,"
        " 'twice': registry.reader('twice_rate')(view),"
        " 'file': registry.HERE}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rows"] == 168
    assert "twice_rate" in got["names"] and "solve_p50_ms" in got["names"]
    assert "first_pass_done_pct" not in got["names"]
    assert got["twice"] == 4
    assert got["file"] == bench_dir
    after = _files(bench_dir)
    assert all(after[p] == b for p, b in before.items())


def test_traffic_key_that_no_code_reads_is_refused(tmp_path):
    bench_dir = sup.copy_benchmark(str(tmp_path))
    path = os.path.join(bench_dir, "traffic", "b60-windows.json")
    with open(path) as f:
        mix = json.load(f)
    mix["clients"] = 4
    with open(path, "w") as f:
        json.dump(mix, f)
    from portbench.harness import registry
    with pytest.raises(ValueError, match="clients"):
        registry.load_cell(sup.bench_json(), "svpchal80-bkz2.b60-windows",
                           bench_dir)
