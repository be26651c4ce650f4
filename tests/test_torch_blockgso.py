"""The port's device GSO route against the JAX package's, on the CPU.

`fplll_tpu_torch.ops.blockgso.device_chol_gso` is the port of the JAX
package's `jax_chol_gso`: one f64 Cholesky of the Gram on the device and
the scaling mu = L / diag(L), r = L * diag(L). `full_gso` takes it at
d >= device_gso_dim() (FPLLL_TPU_DEVICE_GSO_DIM, default 400), here forced
down to 8 so that CPU tensors take it.
"""

import os

import numpy as np
import pytest
import torch

import fplll_tpu.ops.blockgso as jax_blockgso
import fplll_tpu_torch.ops.blockgso as port_blockgso
from fplll_tpu_torch.core.gso import MatGSO
from fplll_tpu_torch.defs import GSO_DEFAULT, GSO_INT_GRAM, GSO_ROW_EXPO
from fplll_tpu_torch.nr.rng import RandGen
from fplll_tpu_torch.ops import gen

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


def gram(d, bits, seed):
    RandGen.init_with_seed(seed)
    b = gen.gen_uniform(d, bits)
    m = MatGSO(b, flags=GSO_DEFAULT)
    for i in range(d):
        m.update_gso_row(i)
    return port_blockgso.gram_from_basis(m.bf, m.n_known_cols)


@pytest.mark.parametrize("d,bits,seed", [(12, 10, 15), (24, 12, 11),
                                         (40, 10, 3)])
def test_device_route_matches_jax_chol_gso(monkeypatch, d, bits, seed):
    """The forced device route on CPU tensors against jax_chol_gso on
    JAX's CPU: r equal to 1e-12 relative to max |r| (measured: at most
    1.6e-14), mu to 1e-11 relative to max |mu| (measured: 8.6e-15,
    1.2e-12 and 7.0e-14 on these Grams, whose condition numbers are 2e3,
    4e5 and 9e4: torch's LAPACK blocks the factorization otherwise than
    the one under scipy and XLA, which agree exactly), upper triangles
    zero."""
    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "8")
    G = gram(d, bits, seed)
    calls = []
    orig = port_blockgso.device_chol_gso

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(port_blockgso, "device_chol_gso", spy)
    mu, r = port_blockgso.full_gso(G, device="cpu")
    assert calls == [d]
    jmu, jr = jax_blockgso.jax_chol_gso(G)
    scale = np.abs(jr).max()
    assert np.abs(r - jr).max() <= 1e-12 * scale
    assert np.abs(mu - jmu).max() <= 1e-12 * scale
    assert np.abs(mu - jmu).max() <= 1e-11 * np.abs(jmu).max()
    assert not np.triu(mu, 1).any() and not np.triu(r, 1).any()


def test_indefinite_gram_gives_none_on_both():
    """Dependent rows: jnp's Cholesky gives NaN columns, torch's
    cholesky_ex an `info`; both routes return None, and full_gso falls
    through to the host route, which refuses it as well."""
    rows = np.array([[1.0, 2, 3], [2, 4, 6], [1, 0, 0]])
    G = rows @ rows.T
    assert jax_blockgso.jax_chol_gso(G) is None
    assert port_blockgso.device_chol_gso(G, device="cpu") is None
    assert port_blockgso.full_gso(G, device="cpu") is None
    G = np.array([[1.0, 2.0], [2.0, 1.0]])       # indefinite, full rank
    assert jax_blockgso.jax_chol_gso(G) is None
    assert port_blockgso.device_chol_gso(G, device="cpu") is None


def test_threshold_and_host_route(monkeypatch):
    """device_gso_dim reads the JAX package's knob with its default;
    below it full_gso never calls the device route."""
    monkeypatch.delenv("FPLLL_TPU_DEVICE_GSO_DIM", raising=False)
    assert port_blockgso.device_gso_dim() == jax_blockgso.device_gso_dim() \
        == 400
    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "30")
    assert port_blockgso.device_gso_dim() == 30

    def refuse(*a, **k):
        raise AssertionError("the device route ran below the threshold")

    monkeypatch.setattr(port_blockgso, "device_chol_gso", refuse)
    G = gram(20, 10, 5)
    mu, r = port_blockgso.full_gso(G)
    hmu, hr = port_blockgso.chol_gso(G)
    assert np.array_equal(r, hr) and np.array_equal(mu, hmu)


@pytest.mark.parametrize("flags", [GSO_DEFAULT, GSO_ROW_EXPO, GSO_INT_GRAM])
def test_update_gso_takes_the_device_route(monkeypatch, flags):
    """MatGSO.update_gso on a fresh d >= 8 object recomputes through the
    device route and agrees with the scalar recurrence (the checks of
    tests/test_blockgso.py)."""
    monkeypatch.setenv("FPLLL_TPU_DEVICE_GSO_DIM", "8")
    calls = []
    orig = port_blockgso.device_chol_gso

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(port_blockgso, "device_chol_gso", spy)
    RandGen.init_with_seed(13)
    b = gen.gen_uniform(20, 14)
    m = MatGSO(b.copy(), flags=flags)
    assert m.update_gso()
    assert calls == [20]
    lazy = MatGSO(b.copy(), flags=flags)
    for i in range(20):
        assert lazy.update_gso_row(i)
    for i in range(20):
        for j in range(i + 1):
            a, c = float(m.get_r(i, j)), float(lazy.get_r(i, j))
            assert abs(a - c) <= 1e-7 * max(1.0, abs(c))
