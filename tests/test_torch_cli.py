"""The port's CLIs against the JAX package's, on the CPU.

`fplll_tpu_torch.cli` holds copies of `fplll_tpu.cli`'s `fplll`,
`latticegen` and `llldiff`. Both packages' `main(argv)` run in this
process on the same input, stdin swapped, from the same random state:
their standard output and exit codes must be identical for every action
and output format of tests/test_cli.py. One subprocess pipeline checks
`python -m fplll_tpu_torch.cli...` itself.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.cli import latticegen as jax_latticegen
from fplll_tpu.cli import llldiff as jax_llldiff
from fplll_tpu.cli import main as jax_main
from fplll_tpu_torch.cli import latticegen, llldiff
from fplll_tpu_torch.cli import main as port_main
from fplll_tpu_torch.enum import kernels
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ((fl, {"main": jax_main, "latticegen": jax_latticegen,
              "llldiff": jax_llldiff}),
        (ft, {"main": port_main, "latticegen": latticegen,
              "llldiff": llldiff}))


def call(monkeypatch, capsys, pkg, mods, tool, argv, inp=""):
    """One in-process run from a fresh random state: (rc or the exception
    raised, stdout, stderr)."""
    pkg.RandGen.init_with_seed(0)
    pkg.RandGenInt.init(0)
    monkeypatch.setattr(sys, "stdin", io.StringIO(inp))
    try:
        rc = mods[tool].main(list(argv))
    except Exception as e:          # both packages must fail alike
        rc = f"{type(e).__name__}: {e}"
    out, err = capsys.readouterr()
    return rc, out, err


def both(monkeypatch, capsys, tool, argv, inp=""):
    """The JAX package's run and the port's; asserts they are the same."""
    (rj, oj, ej), (rt, ot, et) = (call(monkeypatch, capsys, pkg, mods, tool,
                                       argv, inp) for pkg, mods in PKGS)
    assert ot == oj
    assert rt == rj, (ej, et)
    return rt, ot, et


@pytest.fixture
def basis(monkeypatch, capsys):
    rc, out, _ = both(monkeypatch, capsys, "latticegen",
                      ["-randseed", "21", "u", "10", "10"])
    assert rc == 0 and out.startswith("[[")
    return out


# every action and output format of tests/test_cli.py, and the actions it
# leaves out (hkz, sdb, sld)
CASES = {
    "lll": ["-a", "lll"],
    "lll-of-but": ["-a", "lll", "-of", "but"],
    "lll-of-bk": ["-a", "lll", "-of", "bk"],
    "lll-of-uvk": ["-a", "lll", "-of", "uvk"],
    "lll-fast": ["-a", "lll", "-m", "fast"],
    "lll-proved": ["-a", "lll", "-m", "proved"],
    "lll-heuristic-dpe": ["-a", "lll", "-m", "heuristic", "-f", "dpe"],
    "lll-proved-p80": ["-a", "lll", "-m", "proved", "-p", "80"],
    "lll-wrapper-dpe": ["-a", "lll", "-f", "dpe"],
    "lll-delta-eta": ["-a", "lll", "-d", "0.75", "-e", "0.6"],
    "bkz-no-block": ["-a", "bkz"],
    "bkz-strategies": ["-a", "bkz", "-b", "5", "-s", "default.json",
                       "-bkzmaxloops", "1", "-of", "t"],
    "bkz-of-bu": ["-a", "bkz", "-b", "4", "-of", "bu"],
    "hkz": ["-a", "hkz"],
    "sdb": ["-a", "sdb", "-b", "4", "-bkzmaxloops", "2"],
    "sld": ["-a", "sld", "-b", "5", "-bkzmaxloops", "2"],
    "svp-of-s": ["-a", "svp", "-of", "s"],
    "svp-of-cst": ["-a", "svp", "-of", "cst"],
    "cvp": ["-a", "cvp"],
    "cvp-of-c": ["-a", "cvp", "-of", "cs"],
    "hlll": ["-a", "hlll"],
    "pru-minprob": ["-a", "pru", "-pruminprob", "0.5"],
    "pru-expected": ["-a", "pru"],
    "invalid-action": ["-a", "nonsense"],
    "invalid-option": ["-q"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_main_matches_jax(monkeypatch, capsys, basis, case):
    argv = CASES[case]
    inp = basis + "\n[1 2 3 4 5 6 7 8 9 10]\n" if "cvp" in case else basis
    rc, out, err = both(monkeypatch, capsys, "main", argv, inp)
    if case == "bkz-no-block":
        assert rc == 1 and "-b" in err
    elif case.startswith("invalid"):
        assert rc == 1 and "invalid" in err
    elif case == "lll-wrapper-dpe":
        assert rc != 0
    elif case.startswith("pru"):
        assert rc == 0 and "pruning coefficients" in out
    else:
        assert rc in (0, 8) and out


@pytest.mark.parametrize("argv", [["-randseed", "5", "r", "6", "20"],
                                  ["-randseed", "3", "q", "8", "4", "10", "b"],
                                  ["-randseed", "9", "n", "6", "10", "b"],
                                  ["-randseed", "4", "s", "5", "10", "5"],
                                  ["-randseed", "2", "t", "6", "1.5"],
                                  ["r", "6"], ["--help"]],
                         ids=["intrel", "qary", "ntrulike", "simdioph", "trg",
                              "missing-args", "help"])
def test_latticegen_matches_jax(monkeypatch, capsys, argv):
    both(monkeypatch, capsys, "latticegen", argv)


def test_llldiff_matches_jax(monkeypatch, capsys, basis, tmp_path):
    _, red, _ = both(monkeypatch, capsys, "main", ["-a", "lll"], basis)
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text(red)
    b.write_text(basis)
    rc, out, _ = both(monkeypatch, capsys, "llldiff", [str(a), str(a)])
    assert rc == 0 and "equal" in out
    rc, out, _ = both(monkeypatch, capsys, "llldiff", [str(a), str(b)])
    assert rc == 1 and "differ" in out
    rc, _, _ = both(monkeypatch, capsys, "llldiff", [str(a)])
    assert rc == 2


def test_version_names_the_port(capsys):
    assert port_main.main(["--version"]) == 0
    assert latticegen.main(["--version"]) == 0
    assert capsys.readouterr().out.split("\n")[:2] == [
        "fplll (fplll_tpu_torch) 1.0.0", "latticegen (fplll_tpu_torch) 1.0.0"]


@pytest.fixture
def device_route(monkeypatch):
    """Every search tree of dimension >= 12 to each package's device path,
    with no native first pass (as tests/test_torch_svpcvp.py sets it)."""
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device

    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 12)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 12)


@pytest.mark.parametrize("action", ["svp", "cvp"])
def test_device_route_matches_jax(monkeypatch, capsys, device_route, action):
    """`-a svp` and `-a cvp` (the proved methods) on a dim-30 gen_intrel
    basis with the device route forced: the port's kernel wrappers ran
    (their plain version on CPU tensors), and the printed vector, whose
    exact norm or distance is the answer, is the JAX package's."""
    _, basis, _ = both(monkeypatch, capsys, "latticegen",
                       ["-randseed", "11", "r", "30", "300"])
    inp = basis
    if action == "cvp":
        inp += "\n[" + " ".join(str(7 * i - 100) for i in range(31)) + "]\n"
    runs = kernels.PLAIN_RUNS["f64"]
    rc, out, _ = both(monkeypatch, capsys, "main", ["-a", action, "-of", "s"],
                      inp)
    assert rc == 0 and kernels.PLAIN_RUNS["f64"] > runs
    assert out.startswith("[") and len(out.split()) == 31


def test_subprocess_pipeline_prints_the_in_process_answer(monkeypatch,
                                                          capsys):
    """python -m fplll_tpu_torch.cli.latticegen ... |
    python -m fplll_tpu_torch.cli.main -a svp, on the CPU."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(FPLLL_TORCH_DEVICE="cpu", PYTHONPATH=ROOT)
    gen = subprocess.run([sys.executable, "-m", "fplll_tpu_torch.cli."
                          "latticegen", "-randseed", "21", "u", "10", "10"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    svp = subprocess.run([sys.executable, "-m", "fplll_tpu_torch.cli.main",
                          "-a", "svp"], input=gen.stdout, capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert gen.returncode == svp.returncode == 0, svp.stderr[-2000:]
    _, basis, _ = both(monkeypatch, capsys, "latticegen",
                       ["-randseed", "21", "u", "10", "10"])
    assert gen.stdout == basis
    _, out, _ = both(monkeypatch, capsys, "main", ["-a", "svp"], basis)
    assert svp.stdout == out
