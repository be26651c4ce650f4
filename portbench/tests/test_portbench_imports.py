"""No run of the benchmark loads JAX or the JAX package, and the
reference imports nothing of the port: top-level module names are
compared whole, since the port's name begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import portbench_support as sup
from portbench.harness.imports import forbidden_loaded, top_level

PORT = "fplll_tpu_torch"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    top = os.path.join(sup.BENCH_DIR, sub)
    for dp, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def _small_env(tmp_path):
    """The environment of a small CPU run in a process of its own."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), sup.ROOT]),
               FPLLL_TORCH_DEVICE="cpu", FPLLL_TPU_HYBRID_NODES=sup.HYBRID_NODES,
               FPLLL_TPU_MIN_ENUM_DIM=sup.MIN_DIM,
               FPLLL_TORCH_NATIVE_CACHE=os.path.join(sup.ROOT, "build",
                                                     "native"))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_whole_top_level_names_are_compared():
    names = ["fplll_tpu_torch", "fplll_tpu_torch.enum.kernels", "jaxtyping",
             "fplll_tpu", "fplll_tpu.enum", "jax", "jaxlib.xla_client",
             "flax.linen", "fplll_tpux"]
    assert forbidden_loaded(names) == ["flax.linen", "fplll_tpu",
                                       "fplll_tpu.enum", "jax",
                                       "jaxlib.xla_client"]
    assert top_level("fplll_tpu_torch.enum") == "fplll_tpu_torch"


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    bad = [(p, m) for p in _sources() for m in _imports(p)
           if forbidden_loaded([m])]
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_port():
    srcs = list(_sources("reference"))
    assert len(srcs) >= 4
    bad = [(p, m) for p in srcs for m in _imports(p)
           if top_level(m) == PORT or forbidden_loaded([m])]
    assert not bad, bad


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole run of the small cell on the CPU, in a process of its own:
    afterwards sys.modules holds the port and nothing of JAX."""
    bench_dir = sup.copy_benchmark(str(tmp_path))
    work = sup.add_small_cell(bench_dir, sample=2)
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(sup.small_bench(work), f)
    script = (
        "import time; t = time.perf_counter()\n"
        "import json, sys\n"
        "from portbench.harness.imports import forbidden_loaded\n"
        "from portbench.harness.runner import run_cell\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        f"out = run_cell(bench, {sup.SMALL!r}, 5, 0.5, False, 'cpu', t)\n"
        "print(json.dumps({'correct': out['correct'],"
        " 'leaked': forbidden_loaded(),"
        " 'port': 'fplll_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=_small_env(tmp_path), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "leaked": [], "port": True}


def test_a_reader_that_loads_jax_gives_no_result(tmp_path):
    """A metric reader whose import loads JAX (here a module planted
    under the name, as a library would load it) is imported after the
    window has closed: the run raises and gives no result."""
    bench_dir = sup.copy_benchmark(str(tmp_path))
    work = sup.add_small_cell(bench_dir, sample=2)
    with open(os.path.join(bench_dir, "metrics", "leaky.py"), "w") as f:
        f.write("import sys\nimport types\n\n"
                "sys.modules.setdefault('jax', types.ModuleType('jax'))\n\n\n"
                "def read(run):\n    return 1.0\n")
    bench = sup.small_bench(work)
    bench["end_to_end"].append({"name": "leaky", "unit": "s",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": [sup.SMALL]})
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    script = (
        "import time; t = time.perf_counter()\n"
        "import json\n"
        "from portbench.harness.runner import run_cell\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        f"out = run_cell(bench, {sup.SMALL!r}, 5, 0.5, False, 'cpu', t)\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         env=_small_env(tmp_path), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "modules of JAX or the JAX package are loaded: jax" in out.stderr
