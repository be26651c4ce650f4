"""The port's device enumerator against the JAX package's, on the CPU.

`fplll_tpu_torch.enum.device` drives the enumeration kernel (its plain
version on CPU tensors); `fplll_tpu.enum.tpu` drives the JAX package's
f32 XLA kernel. Given the same (mu, r) both must return the same best
coordinates and the same node totals: the host expansion is the same
native code and the two lockstep walks do the same f32 arithmetic.
"""

import math
import os

import numpy as np
import pytest
import torch

from fplll_tpu.enum import tpu as jtpu
from fplll_tpu.enum.evaluator import FastEvaluator as JaxFastEvaluator
from fplll_tpu.jaxsetup import jnp
from fplll_tpu_torch.enum import device as tdev
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.enum.evaluator import FastEvaluator
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from test_enum import exact_norm, setup

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


def window(d, seed, radius):
    b, gso = setup(d, seed)
    A0 = min(float(gso.get_int_gram(i, i)) for i in range(d)) * 1.00001
    mut, rdiag, normexp = gso.export_mu_r(0, d)
    return b, np.asarray(mut), np.asarray(rdiag), normexp, \
        math.ldexp(A0 * radius, -normexp)


@pytest.mark.parametrize("d,seed", [(10, 1), (16, 2), (20, 3), (24, 1)])
@pytest.mark.parametrize("radius", [1.0, 1.5])
def test_enumerator_matches_jax_enumerator(d, seed, radius, monkeypatch):
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    b, mut, rdiag, normexp, A = window(d, seed, radius)

    ev_j = JaxFastEvaluator()
    ev_j.set_normexp(normexp)
    ej = jtpu.TPUEnumerator(batch=128, dtype=jnp.float32)
    ej.target_root_factor = 1
    ej.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_j)

    ev_t = FastEvaluator()
    ev_t.set_normexp(normexp)
    et = tdev.DeviceEnumerator(batch=128, target_root_factor=1,
                               device="cpu")
    runs = kernels.PLAIN_RUNS["single"]
    et.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_t)
    assert kernels.PLAIN_RUNS["single"] == runs + 1

    assert not ev_t.empty() and not ev_j.empty()
    assert list(ev_t.begin()[1]) == list(ev_j.begin()[1])
    assert ev_t.begin()[0] == ev_j.begin()[0]
    np.testing.assert_array_equal(et.nodes, ej.nodes)
    assert et.nodes.sum() > 0


def test_count_mode_matches_jax_enumerator(monkeypatch):
    from fplll_tpu.enum.evaluator import EVALMODE_COUNT as J_COUNT
    from fplll_tpu_torch.enum.evaluator import EVALMODE_COUNT

    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    d = 24
    _, mut, rdiag, normexp, A = window(d, 1, 1.5)
    ev_j = JaxFastEvaluator()
    ev_j.eval_mode = J_COUNT
    ej = jtpu.TPUEnumerator(batch=128, dtype=jnp.float32)
    ej.target_root_factor = 1
    ej.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_j,
                 count_mode=True)
    ev_t = FastEvaluator()
    ev_t.eval_mode = EVALMODE_COUNT
    et = tdev.DeviceEnumerator(batch=128, target_root_factor=1,
                               device="cpu")
    et.enumerate(mut, rdiag, None, np.zeros(d), A, True, ev_t,
                 count_mode=True)
    assert ev_t.sol_count == ev_j.sol_count > 0
    np.testing.assert_array_equal(et.nodes, ej.nodes)


def test_window_path_g1_matches_jax(monkeypatch):
    """device_enumerate_windows with one problem: the window pins (root
    factor 16, m/nfix/R buckets) and GH deepening of both packages."""
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    d = 30
    _, mut, rdiag, _, A = window(d, 1, 1.2)
    args = (mut[None], rdiag[None], np.ones((1, d)), np.array([A]))
    jd, jsol, jnodes = jtpu.device_enumerate_windows(*args)
    td, tsol, tnodes = tdev.device_enumerate_windows(*args, device="cpu")
    assert np.isfinite(td[0])
    assert td[0] == jd[0]
    np.testing.assert_array_equal(tsol, jsol)
    assert tnodes == jnodes


def test_facade_device_backend_matches_jax(monkeypatch):
    """A dim-34 search through each package's Enumeration facade with the
    native first pass off, so both hand the whole tree to their device
    kernel: the same vector and the same node count."""
    from fplll_tpu.enum.api import Enumeration as JaxEnumeration
    from fplll_tpu_torch.core.gso import MatGSO
    from fplll_tpu_torch.defs import GSO_INT_GRAM
    from fplll_tpu_torch.enum.api import Enumeration
    from fplll_tpu_torch.interop import basis_from_rows
    from fplll_tpu_torch.nr.fctx import MPCtx

    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "0")
    d = 34
    b, gso_j = setup(d, 2)
    A0 = min(float(gso_j.get_int_gram(i, i)) for i in range(d)) * 1.00001
    ev_j = JaxFastEvaluator()
    ej = JaxEnumeration(gso_j, ev_j)
    ej.enumerate(0, d, A0, 0)

    bt = basis_from_rows(b.a)
    gso_t = MatGSO(bt, flags=GSO_INT_GRAM, ctx=MPCtx(80))
    gso_t.update_gso()
    ev_t = FastEvaluator()
    et = Enumeration(gso_t, ev_t)
    runs = kernels.PLAIN_RUNS["single"]
    et.enumerate(0, d, A0, 0)
    assert kernels.PLAIN_RUNS["single"] > runs

    assert list(ev_t.begin()[1]) == list(ev_j.begin()[1])
    assert exact_norm(b, ev_t.begin()[1]) > 0
    assert et.get_nodes() == ej.get_nodes()


def test_taller_tree_than_the_kernel_raises():
    """The kernel holds at most MAX_LEVELS levels: its wrapper refuses a
    taller tree. DeviceEnumerator never hands it one: a tree taller than
    max_device_levels goes through the chunked deep-tree search
    (tests/test_torch_enum_f64.py)."""
    m, nfix, R = kernels.MAX_LEVELS + 8, 8, 16

    def z(*shape):
        return torch.zeros(shape)

    with pytest.raises(ValueError, match="tree height"):
        kernels._prepare(z(1, m, m), z(1, m), z(1, m), z(1, m, nfix),
                         z(1, m), z(1, R, nfix), z(1, R), z(1),
                         torch.full((1,), m, dtype=torch.int32), G_real=1,
                         walkers=8, is_svp=True, count_mode=True,
                         max_steps=1 << 20)
