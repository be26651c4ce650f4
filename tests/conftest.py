"""Test configuration: force the CPU backend with an 8-device virtual mesh
(the multi-host-emulation layer replacing the reference CI's
--with-max-parallel-enum-dim trick, SURVEY.md §4)."""

import os

os.environ.setdefault("FPLLL_TPU_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = \
        flags + " --xla_force_host_platform_device_count=8"

import pytest  # noqa: E402

REFERENCE_LATTICES = "/root/reference/tests/lattices"


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def lattice_dir():
    if not os.path.isdir(REFERENCE_LATTICES):
        pytest.skip("reference fixture lattices not available")
    return REFERENCE_LATTICES
