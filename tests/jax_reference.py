"""Shared set-up of the port's tests that hold it against the JAX package.

The JAX package builds its C cores (fplll_tpu/native/*.c) on first use into
a cache shared by every process, and the compiler writes each shared object
in place. When several pytest-xdist workers start from an empty cache, they
build at once, and a worker that finds the file while another one is still
writing it fails to load it. The JAX package then quietly goes on without
that core for the rest of the process: without enum_core it expands the top
of the tree with its numpy loop, whose node counts differ from the C
expansion's (34709 against 34694 nodes on the window of
test_torch_device.py::test_window_path_g1_matches_jax), so an exact
comparison with the port, which always uses its own C expansion, fails.

`jax_native_cores`, an autouse fixture for the modules that import it,
waits until every C core of the JAX package has loaded, so both packages
run the same host code around their device walks.
"""

import time

import pytest


def load_jax_native_cores(tries: int = 120, pause: float = 0.5) -> None:
    """Load the JAX package's enum, LLL and BKZ C cores, looking again
    while another process is still writing one; raises if one never
    loads."""
    import fplll_tpu.native as jn

    cores = (("get_lib", "_TRIED"), ("get_lll_lib", "_LLL_TRIED"),
             ("get_bkz_lib", "_BKZ_TRIED"))
    for getter, tried in cores:
        for _ in range(tries):
            if getattr(jn, getter)() is not None:
                break
            setattr(jn, tried, False)   # not loaded: build or load again
            time.sleep(pause)
        else:
            raise RuntimeError(f"fplll_tpu.native.{getter} never loaded")


@pytest.fixture(autouse=True)
def jax_native_cores():
    load_jax_native_cores()
