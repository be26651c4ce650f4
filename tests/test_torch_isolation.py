"""The PyTorch port stands alone: it never imports JAX or the JAX
package, and its entry points refuse to run on the CPU unless asked to.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fplll_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "fplll_tpu")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path):
    """Every module a file names in an import statement or in a call of
    __import__ / importlib.import_module with a literal argument."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            if name in ("__import__", "import_module") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def test_static_scan_finds_no_jax_or_jax_package_import():
    sources = _port_sources()
    assert len(sources) > 20, sources
    rel = {os.path.relpath(p, PORT) for p in sources}
    for must in ("cli/main.py", "cli/latticegen.py", "cli/llldiff.py",
                 "pruner/pruner.py", "pruner/torchgrad.py",
                 "utils/checkpoint.py", "algs/simulator.py", "fpylll.py"):
        assert must in rel, must
    bad = [f"{os.path.relpath(p, ROOT)}:{line}: {mod}"
           for p in sources for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, "the port imports JAX or the JAX package:\n" + \
        "\n".join(bad)


_RUN = textwrap.dedent(r"""
    import json, sys
    import fplll_tpu_torch as ft
    import fplll_tpu_torch.cli.main, fplll_tpu_torch.fpylll  # noqa: E401
    from fplll_tpu_torch.enum import kernels

    ft.RandGen.init_with_seed(3)
    b = ft.gen.gen_qary_bits(36, 18, 12)
    ft.lll_reduction(b)
    assert ft.is_lll_reduced(ft.MatGSO(b.copy()), 0.99, 0.51)
    strategies = ft.load_strategies_json("default.json")
    ft.bkz_reduction(b, ft.BKZParam(20, strategies,
                                    flags=ft.BKZ_MAX_LOOPS | ft.BKZ_GH_BND,
                                    max_loops=1))
    assert ft.is_lll_reduced(ft.MatGSO(b.copy()), 0.99, 0.51)
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "fplll_tpu"))
    print("RESULT " + json.dumps({"mods": mods,
                                  "plain": sum(kernels.PLAIN_RUNS.values())}))
""")


def test_port_runs_lll_and_bkz_without_loading_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "FPLLL_TPU"))}
    env.update({"FPLLL_TORCH_DEVICE": "cpu", "PYTHONPATH": ROOT,
                # windows of dim >= 16 over 50 estimated nodes go to the
                # plain version of the kernel, so it runs here too
                "FPLLL_TPU_MIN_ENUM_DIM": "16",
                "FPLLL_TPU_HYBRID_NODES": "50"})
    res = subprocess.run([sys.executable, "-c", _RUN], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    out = __import__("json").loads(line[-1][len("RESULT "):])
    assert out["mods"] == [], out["mods"]
    assert out["plain"] > 0, "no window reached the kernel's plain version"


@pytest.fixture
def no_card(monkeypatch):
    """A process without a CUDA card that did not ask for the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FPLLL_TORCH_DEVICE", raising=False)


def test_entry_points_raise_without_card(no_card):
    import fplll_tpu_torch as ft
    from fplll_tpu_torch.enum.device import (DeviceEnumerator,
                                             device_enumerate_windows)
    from fplll_tpu_torch.torchsetup import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceEnumerator()
    import numpy as np
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_enumerate_windows(np.zeros((1, 4, 4)), np.ones((1, 4)),
                                 np.ones((1, 4)), np.ones(1))
    ft.RandGen.init_with_seed(1)
    b = ft.gen.gen_qary_bits(20, 10, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.bkz_reduction(b, ft.BKZParam(10))


def test_user_surfaces_raise_without_card(no_card, monkeypatch):
    """The pruner with its analytic gradient (d <= 30), the GSO at
    d >= device_gso_dim(), the fplll CLI's `-a svp` on a basis above the
    device crossover, and the fpylll veneer's SVP all reach the device,
    so they raise without a card when the CPU was not asked for."""
    import io

    import numpy as np

    import fplll_tpu_torch as ft
    from fplll_tpu_torch import fpylll
    from fplll_tpu_torch.cli import main as cli_main
    from fplll_tpu_torch.ops.blockgso import device_gso_dim, full_gso

    gso = [1.05 ** -i for i in range(40)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.prune(0.9 * gso[0], 1e4, gso, target=0.5,
                 flags=ft.PRUNER_GRADIENT)
    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "16")
    assert device_gso_dim() == 16
    G = np.eye(16) * 2.0 + 0.1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_gso(G)
    ft.RandGen.init_with_seed(2)
    basis = ft.format_matrix(ft.gen.gen_intrel(40, 400))
    monkeypatch.setattr("sys.stdin", io.StringIO(basis))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["-a", "svp"])
    fpylll.FPLLL.set_random_seed(3)
    A = fpylll.IntegerMatrix.random(20, "qary", k=10, bits=15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fpylll.SVP.shortest_vector(A)


def test_host_only_queries_run_without_card(no_card, tmp_path, capsys):
    """svp_probability, LinearPruningParams, the pruner's cost calls (and a
    prune without the gradient), the simulator, full_gso below the
    threshold, llldiff and latticegen touch no device: they run with no
    card and no FPLLL_TORCH_DEVICE."""
    import numpy as np

    import fplll_tpu_torch as ft
    from fplll_tpu_torch import fpylll
    from fplll_tpu_torch.algs.simulator import simulate
    from fplll_tpu_torch.cli import latticegen, llldiff
    from fplll_tpu_torch.ops.blockgso import full_gso

    lp = ft.PruningParams.LinearPruningParams(30, 10)
    assert 0 < lp.expectation <= 1
    assert ft.svp_probability(lp) == fpylll.Pruning.svp_probability(lp)
    gso = [1.05 ** -i for i in range(30)]
    p = ft.Pruner(0.9 * gso[0], 1e4, gso, 0.5)
    assert p.single_enum_cost(lp.coefficients) > 0
    assert 0 < p.measure_metric(lp.coefficients) <= 1
    assert p.repeated_enum_cost(lp.coefficients) > 0
    assert ft.prune(0.9 * gso[0], 1e4, gso, target=0.5, flags=0).coefficients
    prof, tours = simulate([1.02 ** -(4 * i) for i in range(60)], 30)
    assert len(prof) == 60 and tours >= 1
    assert full_gso(np.eye(20) * 2.0 + 0.1) is not None
    assert latticegen.main(["-randseed", "1", "u", "6", "8"]) == 0
    path = tmp_path / "b.txt"
    path.write_text(capsys.readouterr().out)
    assert llldiff.main([str(path), str(path)]) == 0


def test_gso_recompute_follows_the_device_argument(no_card, monkeypatch):
    """With no card and no FPLLL_TORCH_DEVICE, at d >= device_gso_dim(),
    bkz_reduction(device="cpu") hands its device to the GSO objects it
    builds (the LLL wrapper's and BKZ's), so their blocked recompute runs
    on the CPU; shortest_vector(backend="cpu") runs too (its GSO is
    multiprecision, which the blocked route never takes)."""
    import fplll_tpu_torch as ft
    from fplll_tpu_torch.ops import blockgso

    seen = []
    real = blockgso.device_chol_gso

    def spy(G, device=None):
        seen.append(device)
        return real(G, device)

    monkeypatch.setattr(blockgso, "device_chol_gso", spy)
    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "16")
    ft.RandGen.init_with_seed(1)
    b = ft.gen.gen_qary_bits(20, 10, 10)
    assert ft.bkz_reduction(b, 10, device="cpu") == ft.RED_SUCCESS
    assert seen and all(str(dev) == "cpu" for dev in seen), seen
    seen.clear()
    st, sol = ft.shortest_vector(b, backend="cpu")
    assert st == ft.RED_SUCCESS and any(sol)
    assert seen == []
    m = ft.MatGSO(b.copy(), device="cpu")
    assert m.update_gso() and [str(dev) for dev in seen] == ["cpu"]


def test_cpu_is_taken_only_when_asked(no_card, monkeypatch):
    from fplll_tpu_torch.torchsetup import resolve_device

    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("FPLLL_TORCH_DEVICE", "cpu")
    assert resolve_device().type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_full_precision_f32_is_pinned():
    import torch

    import fplll_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_bkz_facade_windows_follow_the_device_argument(no_card, monkeypatch):
    """BKZ's facade windows run on the device given to bkz_reduction, with
    no card and no FPLLL_TORCH_DEVICE: the Python tour sends each window
    through the facade, whose default backend gets that device bound in.
    BKZ-20 without strategies prunes nothing, so they run in f64."""
    import fplll_tpu_torch as ft
    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu_torch.enum import kernels

    monkeypatch.setenv("FPLLL_TPU_NATIVE_BKZ", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 16)
    kernels.reset_launch_counts()
    ft.RandGen.init_with_seed(3)
    b = ft.gen.gen_qary_bits(30, 15, 12)
    ft.lll_reduction(b)
    ft.bkz_reduction(b, ft.BKZParam(20, flags=ft.BKZ_MAX_LOOPS,
                                    max_loops=1), device="cpu")
    assert ft.is_lll_reduced(ft.MatGSO(b.copy()), 0.99, 0.51)
    assert kernels.PLAIN_RUNS["f64"] > 0
    assert sum(kernels.LAUNCHES.values()) == 0
