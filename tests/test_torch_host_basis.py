"""The host's reduced basis of the smoke's exact searches, through both
packages on one machine.

`chip_smoke.py` phases 5 and 8 start from `intrel_basis(d, seed)`:
`gen_intrel(d, 10 d)` from `RandGen` seed `seed`, LLL- then
BKZ-20-reduced on the host. Two H100 machines made different bases from
the same code (PERF.md section 7). On one machine the port and the JAX
package must give the same basis, as integers, from the same steps: the
difference across machines is then a reproducibility limit of the host's
arithmetic, not a fault of the port.
"""

import os

import pytest
import torch

import fplll_tpu as fl
from fplll_tpu_torch.algs.bkz import bkz_reduction
from fplll_tpu_torch.algs.wrapper import lll_reduction
from fplll_tpu_torch.nr.rng import RandGen
from fplll_tpu_torch.ops.gen import gen_intrel
from fplll_tpu.ops.intmat import format_matrix as jax_format_matrix
from fplll_tpu_torch.ops.intmat import format_matrix
from jax_reference import jax_native_cores  # noqa: F401 (autouse)

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

# (d, seed): phase 5's proved-SVP basis, which phase 8's HKZ reduces, and
# phase 5's CVP, dual-SVP and sub-solution basis
BASES = [(56, 29), (50, 2)]


@pytest.mark.parametrize("d,seed", BASES, ids=[f"d{d}-seed{s}"
                                                for d, s in BASES])
def test_intrel_basis_matches_jax(d, seed):
    """The smoke's intrel_basis steps through the port (BKZ-20 with
    device="cpu", as the smoke runs it) and through the JAX package: the
    same basis, entry for entry, and the same text (whose sha256 is the
    smoke's start_digest)."""
    RandGen.init_with_seed(seed)
    bt = gen_intrel(d, 10 * d)
    lll_reduction(bt)
    bkz_reduction(bt, 20, device="cpu")
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_intrel(d, 10 * d)
    fl.lll_reduction(bj)
    fl.bkz_reduction(bj, 20)
    assert bt.a.tolist() == bj.a.tolist()
    assert format_matrix(bt) == jax_format_matrix(bj)
