"""Shared set-up of the PyTorch port's tests.

The suite runs several pytest-xdist workers on a few cores, so each worker
keeps torch to one thread.  Where JAX is installed, the parity tests hold
the port against it in float64 on the CPU; ``tests/conftest.py`` sets that
up for the whole suite, and this file does the same when it is not loaded
(``--confcutdir=tests/port``).
"""
import os

import pytest
import torch

torch.set_num_threads(1)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
try:
    import jax
except ImportError:
    jax = None
if jax is not None:
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def cuda_device():
    """The CUDA card; tests that take it skip when there is none (decided
    here, while the test runs, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
