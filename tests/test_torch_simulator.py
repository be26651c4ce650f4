"""The port's BKZ simulator against the JAX package's, on the CPU.

`fplll_tpu_torch.algs.simulator` is a copy of `fplll_tpu.algs.simulator`
(pure host Python) that reads the port's own copy of the calibrated HKZ
tail (`fplll_tpu_torch/strategies/hkz_tail.json`): every profile must be
the JAX package's, float for float.
"""

import json
import math
import os

import pytest

import fplll_tpu.algs.simulator as jax_sim
import fplll_tpu_torch.algs.simulator as port_sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lll_profile(n, slope=1.0219):
    ld = math.log(slope)
    return [math.exp(-4.0 * ld * i) for i in range(n)]


@pytest.mark.parametrize("n,beta,tours", [(140, 55, 20), (150, 46, 40),
                                          (150, 60, 40), (150, 80, 40),
                                          (120, 60, 40), (30, 20, 20),
                                          (40, 40, 20), (60, 70, 8)])
def test_simulate_matches_jax(n, beta, tours):
    """The cases of tests/test_simulator.py, a short basis whose tail is
    cut to n - 1, and full HKZ (beta >= n)."""
    r = lll_profile(n)
    assert port_sim.simulate(r, beta, tours) == jax_sim.simulate(r, beta,
                                                                  tours)


def test_fixed_point_and_block_shape_match_jax():
    s1, _ = port_sim.simulate(lll_profile(120), 60, max_tours=40)
    assert port_sim.simulate(s1, 60, max_tours=40) == \
        jax_sim.simulate(s1, 60, max_tours=40)
    for beta, pre in ((80, 52), (60, 40), (90, 60)):
        assert port_sim.simulated_block_shape(beta, pre) == \
            jax_sim.simulated_block_shape(beta, pre)
    with pytest.raises(ValueError):
        port_sim.simulated_block_shape(80, 30)


@pytest.mark.parametrize("tau", [4, 20, 29, 39, 45, 59])
def test_hkz_tail_profile_matches_jax(tau):
    assert port_sim.hkz_tail_profile(tau) == jax_sim.hkz_tail_profile(tau)


def test_the_ports_artifact_is_the_one_read(monkeypatch):
    """The port's hkz_tail.json is the JAX package's byte for byte, it is
    the file hkz_tail_profile opens, and hkz_tail_profile(45) is that
    artifact's (zero-summed) profile, not the Gaussian-heuristic fallback
    _gh_tail."""
    port_path = os.path.join(ROOT, "fplll_tpu_torch", "strategies",
                             "hkz_tail.json")
    opened = []

    def spy(path, *a, **k):
        opened.append(os.path.realpath(path))
        return open(path, *a, **k)

    monkeypatch.setattr(port_sim, "open", spy, raising=False)
    with open(port_path, "rb") as f, \
            open(os.path.join(ROOT, "fplll_tpu", "strategies",
                              "hkz_tail.json"), "rb") as g:
        assert f.read() == g.read()
    with open(port_path) as f:
        stored = json.load(f)[str(port_sim.TAIL_DIM)]
    mean = sum(stored) / len(stored)
    port_sim._TAIL_CACHE.clear()
    tail = port_sim.hkz_tail_profile(port_sim.TAIL_DIM)
    assert opened == [os.path.realpath(port_path)]
    assert tail == [float(x) - mean for x in stored]
    assert tail != port_sim._gh_tail(port_sim.TAIL_DIM)
