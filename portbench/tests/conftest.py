"""The benchmark's tests: the ``cuda`` marker names the tests that need a
card (each skips without one, decided when it runs)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
