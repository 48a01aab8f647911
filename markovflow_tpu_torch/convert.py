"""Build the port's models from the JAX package's parameters, given as
numpy arrays, so that both packages compute the same thing."""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from . import kernels
from .models import GaussianProcessRegression

__all__ = ["gpr_from_numpy"]

_KERNELS = {"Matern12": kernels.Matern12, "Matern32": kernels.Matern32,
            "Matern52": kernels.Matern52}


def _kernel(name: str, params, prefix: str, dtype, device):
    """A Matern kernel whose UNCONSTRAINED lengthscale and variance are
    taken from ``params[prefix + name]`` where present."""
    k = _KERNELS[name](dtype=dtype, device=device)
    with torch.no_grad():
        for p in ("lengthscale", "variance"):
            if prefix + p in params:
                getattr(k, p).unconstrained.copy_(
                    torch.as_tensor(np.asarray(params[prefix + p]), dtype=dtype))
    return k


def gpr_from_numpy(params: Dict[str, np.ndarray], time_points: np.ndarray,
                   observations: np.ndarray, *, dtype: torch.dtype,
                   device="cuda", kernel: Union[str, Sequence[str]] = "Matern32"
                   ) -> GaussianProcessRegression:
    """A :class:`GaussianProcessRegression` from numpy parameters under the
    JAX model's attribute paths: ``kernel.lengthscale`` and
    ``kernel.variance`` (UNCONSTRAINED values) and ``chol_obs_covariance``,
    on ``device`` (the CUDA card unless the caller names another).
    ``kernel`` names the kernel class, or is a sequence of names for a
    :class:`~markovflow_tpu_torch.kernels.Sum` of those kernels, whose
    parameters are ``kernel.kernels[i].lengthscale`` and so on, as in a JAX
    ``Sum([...])``.  The time points, on any grid, are checked, and the
    grid's uniformity detected, on the host before they move to ``device``.
    Training (:func:`markovflow_tpu_torch.training.fit`) starts from these
    parameter values."""
    if isinstance(kernel, str):
        k = _kernel(kernel, params, "kernel.", dtype, device)
    else:
        k = kernels.Sum([_kernel(name, params, f"kernel.kernels[{i}].", dtype,
                                 device) for i, name in enumerate(kernel)])
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    # numpy time points: the model checks them on the host, then moves them
    return GaussianProcessRegression(
        input_data=(np.asarray(time_points), as_t(observations)), kernel=k,
        chol_obs_covariance=as_t(params["chol_obs_covariance"]))
