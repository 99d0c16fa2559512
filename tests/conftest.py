import os

# Tests run on the default single CPU device (the dry-run alone uses the
# 512-device override, per the assignment). Sharding tests spawn
# subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips with the reason stated where there is none")
