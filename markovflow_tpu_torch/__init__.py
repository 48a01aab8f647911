"""markovflow_tpu_torch — the PyTorch / CUDA port of markovflow_tpu.

Mirrors the JAX package's module names so each counterpart is easy to find.
This slice covers exact GP regression serving on a uniform time grid:
``GaussianProcessRegression.log_likelihood()`` / ``loss()`` and
``kalman.posterior_marginals()``, which on a CUDA device run two CUDA
kernels written for Hopper (:mod:`markovflow_tpu_torch.ops.cuda_scan`).
On CPU tensors every path runs the plain PyTorch versions.
"""
from . import config
from .utils.module import Parameter

__version__ = "0.1.0"
