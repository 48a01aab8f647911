"""Numerical constants (counterpart of ``markovflow_tpu/config.py``).

The JAX package invents a dtype from ``jax_enable_x64``; the port never
does: every constructor takes an explicit ``dtype`` and ``device``, and
dtype-dependent constants are functions of that dtype.
"""
from __future__ import annotations

import torch

#: Default jitter added to covariance diagonals for numerical stability.
DEFAULT_JITTER = 1e-6


def default_jitter(dtype: torch.dtype) -> float:
    """Jitter magnitude appropriate for ``dtype``."""
    return 1e-10 if dtype == torch.float64 else 1e-6
