"""The port's BKZ checkpoints against the JAX package's, on the CPU.

`BKZParam.checkpoint_file` made the port's bkz_reduction import a module
it did not have (`fplll_tpu_torch.utils.checkpoint`); the port now keeps
its own copy, which writes what the JAX package writes.
"""

import json
import os

import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.utils import checkpoint as jax_checkpoint
from fplll_tpu_torch.interop import basis_from_rows
from fplll_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


@pytest.mark.parametrize("block,loops", [(10, 2), (5, 1)])
def test_bkz_checkpoint_matches_jax(tmp_path, block, loops):
    """The same seed through both packages' bkz_reduction with a
    checkpoint file: the same basis and the same meta (loop, nodes,
    algorithm), elapsed aside; the checkpoint holds the returned basis."""
    out = {}
    for name, pkg in (("jax", fl), ("port", ft)):
        pkg.RandGen.init_with_seed(30)
        b = pkg.gen.gen_qary_bits(30, 15, 20)
        param = pkg.BKZParam(block, None, flags=pkg.BKZ_MAX_LOOPS,
                             max_loops=loops)
        param.checkpoint_file = str(tmp_path / f"{name}.ckpt")
        pkg.bkz_reduction(b, param)
        with open(param.checkpoint_file) as f:
            out[name] = (json.load(f), b.a.tolist())
    (pj, bj), (pt, bt) = out["jax"], out["port"]
    assert bt == bj
    assert pt["basis"] == pj["basis"] == [[str(x) for x in r] for r in bt]
    mj = {k: v for k, v in pj["meta"].items() if k != "elapsed"}
    mt = {k: v for k, v in pt["meta"].items() if k != "elapsed"}
    assert mt == mj and mt["loop"] >= 1
    assert pt["format_version"] == pj["format_version"] and pt["u"] is None


def test_checkpoint_resume(tmp_path):
    """tests/test_bkz.py's resume case through the port: a run continued
    from the checkpointed basis succeeds."""
    ft.RandGen.init_with_seed(50)
    b = ft.gen.gen_uniform(14, 12)
    param = ft.BKZParam(5, None, flags=ft.BKZ_MAX_LOOPS, max_loops=2)
    param.checkpoint_file = str(tmp_path / "bkz.ckpt")
    ft.bkz_reduction(b, param)
    b2, u2, meta = load_checkpoint(param.checkpoint_file)
    assert meta["loop"] >= 1 and b2.nrows == 14 and u2 is None
    param2 = ft.BKZParam(5, None, flags=ft.BKZ_MAX_LOOPS, max_loops=1)
    assert ft.bkz_reduction(b2, param2) in (ft.RED_SUCCESS,
                                            ft.RED_BKZ_LOOPS_LIMIT)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_roundtrip_bigints(tmp_path, writer):
    """Big integers and a transform round-trip, and each package reads the
    other's file."""
    rows = [[10 ** 90, -3], [7, 10 ** 80 + 1]]
    u_rows = [[1, -(2 ** 70)], [0, 1]]
    path = str(tmp_path / "c.json")
    if writer == "port":
        save_checkpoint(path, basis_from_rows(rows), basis_from_rows(u_rows),
                        meta={"x": 1})
    else:
        jax_checkpoint.save_checkpoint(path, fl.IntMat.from_rows(rows),
                                       fl.IntMat.from_rows(u_rows),
                                       meta={"x": 1})
    b2, u2, meta = load_checkpoint(path)
    assert b2.a.tolist() == rows and u2.a.tolist() == u_rows
    assert meta == {"x": 1}
    bj, uj, mj = jax_checkpoint.load_checkpoint(path)
    assert bj.a.tolist() == rows and uj.a.tolist() == u_rows and mj == meta
