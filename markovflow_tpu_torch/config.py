"""Numerical constants (counterpart of ``markovflow_tpu/config.py``).

The JAX package invents a dtype from ``jax_enable_x64``; the port never
does: every constructor takes an explicit ``dtype``, and dtype-dependent
constants are functions of that dtype.  Constructors build on the CUDA
card unless they are given another ``device`` (the tests pass
``device="cpu"``).
"""
from __future__ import annotations

import torch

#: Stand-in for an infinite time delta: the phantom neighbours of a new
#: time point outside the conditioning points sit this far away.
APPROX_INF = 1e10

#: Default jitter added to covariance diagonals for numerical stability.
DEFAULT_JITTER = 1e-6


def default_jitter(dtype: torch.dtype) -> float:
    """Jitter magnitude appropriate for ``dtype``."""
    return 1e-10 if dtype == torch.float64 else 1e-6
