"""Build the port's models from the JAX package's parameters, given as
numpy arrays, so that both packages compute the same thing."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import kernels
from .models import GaussianProcessRegression

__all__ = ["gpr_from_numpy"]

_KERNELS = {"Matern12": kernels.Matern12, "Matern32": kernels.Matern32,
            "Matern52": kernels.Matern52}


def gpr_from_numpy(params: Dict[str, np.ndarray], time_points: np.ndarray,
                   observations: np.ndarray, *, device, dtype: torch.dtype,
                   kernel: str = "Matern32") -> GaussianProcessRegression:
    """A :class:`GaussianProcessRegression` from numpy parameters under the
    JAX model's attribute paths: ``kernel.lengthscale`` and
    ``kernel.variance`` (UNCONSTRAINED values) and ``chol_obs_covariance``.
    ``kernel`` names the kernel class.  The time points, on any grid, are
    checked, and the grid's uniformity detected, on the host before they
    move to ``device``.  Training (:func:`markovflow_tpu_torch.training.fit`)
    starts from these parameter values."""
    k = _KERNELS[kernel](dtype=dtype, device=device)
    with torch.no_grad():
        for name in ("lengthscale", "variance"):
            key = f"kernel.{name}"
            if key in params:
                getattr(k, name).unconstrained.copy_(
                    torch.as_tensor(np.asarray(params[key]), dtype=dtype))
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    # numpy time points: the model checks them on the host, then moves them
    return GaussianProcessRegression(
        input_data=(np.asarray(time_points), as_t(observations)), kernel=k,
        chol_obs_covariance=as_t(params["chol_obs_covariance"]))
