"""markovflow_tpu_torch — the PyTorch / CUDA port of markovflow_tpu.

Mirrors the JAX package's module names so each counterpart is easy to find.
It covers exact GP regression on any time grid, serving and training:
``GaussianProcessRegression.log_likelihood()`` / ``loss()``, its Koopman
gradient, ``kalman.posterior_marginals()`` and
:func:`markovflow_tpu_torch.training.fit`, which on a CUDA device run CUDA
kernels written for Hopper (:mod:`markovflow_tpu_torch.ops.cuda_scan`,
:mod:`markovflow_tpu_torch.ops.adjoint`).  On CPU tensors every path runs
the plain PyTorch versions.
"""
from . import config
from .utils.module import Parameter

__version__ = "0.1.0"
