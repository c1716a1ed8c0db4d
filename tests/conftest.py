import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — tests must see the 1 real CPU
# device; only launch/dryrun.py forces 512 placeholder devices.


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where there is none)")
