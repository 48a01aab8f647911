"""Build the port's models from the JAX package's parameters, given as
numpy arrays, so that both packages compute the same thing."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import kernels, likelihoods, mean_function as mf
from .kalman_filter import UnivariateGaussianSitesNat
from .models import (CVIGaussianProcess, GaussianProcessRegression,
                     SparseVariationalGaussianProcess, VariationalGaussianProcess)
from .state_space_model import StateSpaceModel

__all__ = ["gpr_from_numpy", "cvi_from_numpy", "vgp_from_numpy", "svgp_from_numpy",
           "ssm_from_numpy"]

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


def _model_kernel(kernel: Union[str, Sequence[str]], params, dtype, device):
    """The model's kernel: the Matern ``kernel`` under ``kernel.*``, or a
    Sum of the named kernels under ``kernel.kernels[i].*``."""
    if isinstance(kernel, str):
        return _kernel(kernel, params, "kernel.", dtype, device)
    return kernels.Sum([_kernel(name, params, f"kernel.kernels[{i}].", dtype,
                                device) for i, name in enumerate(kernel)])


def _mean_function(name: Optional[str], params, k, dtype, device):
    """The mean function ``name`` ("Zero", "Linear", "Impulse", "Step" or
    None) from ``params["mean_function.*"]``, the JAX model's attribute
    paths (``coefficient``; ``action_times`` and ``state_perturbations``)."""
    if name is None:
        return None
    if name == "Zero":
        return mf.ZeroMeanFunction()
    if name == "Linear":
        return mf.LinearMeanFunction(np.asarray(params["mean_function.coefficient"]),
                                     dtype=dtype, device=device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    cls = {"Impulse": mf.ImpulseMeanFunction, "Step": mf.StepMeanFunction}[name]
    return cls(as_t(params["mean_function.action_times"]),
               as_t(params["mean_function.state_perturbations"]), k)


def gpr_from_numpy(params: Dict[str, np.ndarray], time_points: np.ndarray,
                   observations: np.ndarray, *, dtype: torch.dtype,
                   device="cuda", kernel: Union[str, Sequence[str]] = "Matern32",
                   mean_function: Optional[str] = None
                   ) -> GaussianProcessRegression:
    """A :class:`GaussianProcessRegression` from numpy parameters under the
    JAX model's attribute paths: ``kernel.lengthscale`` and
    ``kernel.variance`` (UNCONSTRAINED values) and ``chol_obs_covariance``,
    on ``device`` (the CUDA card unless the caller names another).
    ``kernel`` names the kernel class, or is a sequence of names for a
    :class:`~markovflow_tpu_torch.kernels.Sum` of those kernels, whose
    parameters are ``kernel.kernels[i].lengthscale`` and so on, as in a JAX
    ``Sum([...])``.  ``mean_function`` names the mean function ("Zero",
    "Linear", "Impulse" or "Step"; the last two respond through the
    model's kernel), whose arrays are ``params["mean_function.*"]``.  The
    time points, on any grid, are checked, and the
    grid's uniformity detected, on the host before they move to ``device``.
    Training (:func:`markovflow_tpu_torch.training.fit`) starts from these
    parameter values."""
    k = _model_kernel(kernel, params, dtype, device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    # numpy time points: the model checks them on the host, then moves them
    return GaussianProcessRegression(
        input_data=(np.asarray(time_points), as_t(observations)), kernel=k,
        chol_obs_covariance=as_t(params["chol_obs_covariance"]),
        mean_function=_mean_function(mean_function, params, k, dtype, device))


def _likelihood(name: str, params, dtype, device):
    """The likelihood ``name`` ("Gaussian", "Bernoulli", "Poisson" or
    "StudentT", each with its defaults) with its UNCONSTRAINED
    ``likelihood.variance`` or ``likelihood.scale`` where present."""
    if name == "Bernoulli":
        return likelihoods.Bernoulli()
    if name == "Poisson":
        return likelihoods.Poisson()
    if name == "Gaussian":
        lik, key = likelihoods.Gaussian(dtype=dtype, device=device), "variance"
    elif name == "StudentT":
        lik, key = likelihoods.StudentT(dtype=dtype, device=device), "scale"
    else:
        raise ValueError(f"unknown likelihood {name!r}")
    if f"likelihood.{key}" in params:
        with torch.no_grad():
            getattr(lik, key).unconstrained.copy_(torch.as_tensor(
                np.asarray(params[f"likelihood.{key}"]), dtype=dtype))
    return lik


def cvi_from_numpy(params: Dict[str, np.ndarray], time_points: np.ndarray,
                   observations: np.ndarray, *, dtype: torch.dtype,
                   device="cuda", kernel: Union[str, Sequence[str]] = "Matern32",
                   likelihood: str = "Gaussian", learning_rate: float = 0.1,
                   mean_function: Optional[str] = None) -> CVIGaussianProcess:
    """A :class:`CVIGaussianProcess` from numpy parameters under the JAX
    model's attribute paths, on ``device`` (the CUDA card unless the caller
    names another): the kernel and mean function as in
    :func:`gpr_from_numpy`, the likelihood named by ``likelihood`` with its
    parameters under ``likelihood.*``, and, where present, the sites'
    naturals ``sites.nat1`` [..., N, 1] and ``sites.nat2`` [..., N, 1, 1]
    (the JAX initial sites otherwise).  The time points are checked, and
    the grid's uniformity detected, on the host."""
    k = _model_kernel(kernel, params, dtype, device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    sites = None
    if "sites.nat1" in params:
        sites = UnivariateGaussianSitesNat(as_t(params["sites.nat1"]),
                                           as_t(params["sites.nat2"]))
    return CVIGaussianProcess(
        input_data=(np.asarray(time_points), as_t(observations)), kernel=k,
        likelihood=_likelihood(likelihood, params, dtype, device),
        mean_function=_mean_function(mean_function, params, k, dtype, device),
        learning_rate=learning_rate, sites=sites)


def ssm_from_numpy(fields: Sequence[np.ndarray], *, dtype: torch.dtype,
                   device="cuda") -> StateSpaceModel:
    """A :class:`StateSpaceModel` of plain tensors from the JAX
    ``StateSpaceModel``'s fields as numpy arrays, in its order:
    (initial_mean, cholesky_initial_covariance, state_transitions,
    state_offsets, cholesky_process_covariances)."""
    return StateSpaceModel(*(torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
                             for x in fields))


def vgp_from_numpy(params: Dict[str, np.ndarray], time_points: np.ndarray,
                   observations: np.ndarray, *, dtype: torch.dtype, device="cuda",
                   kernel: Union[str, Sequence[str]] = "Matern32",
                   likelihood: str = "Bernoulli",
                   dist_q: Optional[Sequence[np.ndarray]] = None,
                   mean_function: Optional[str] = None) -> VariationalGaussianProcess:
    """A :class:`VariationalGaussianProcess` from numpy parameters under the
    JAX model's attribute paths, on ``device`` (the CUDA card unless the
    caller names another): the kernel, likelihood and mean function as in
    :func:`cvi_from_numpy`, and q from ``dist_q``, the JAX model's
    ``dist_q`` fields (:func:`ssm_from_numpy`), or the prior."""
    k = _model_kernel(kernel, params, dtype, device)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    init = None if dist_q is None else ssm_from_numpy(dist_q, dtype=dtype, device=device)
    return VariationalGaussianProcess(
        (np.asarray(time_points), as_t(observations)), k,
        _likelihood(likelihood, params, dtype, device),
        mean_function=_mean_function(mean_function, params, k, dtype, device),
        initial_distribution=init)


def svgp_from_numpy(params: Dict[str, np.ndarray], inducing_points: np.ndarray, *,
                    dtype: torch.dtype, device="cuda",
                    kernel: Union[str, Sequence[str]] = "Matern32",
                    likelihood: str = "Gaussian", num_data: Optional[int] = None,
                    dist_q: Optional[Sequence[np.ndarray]] = None,
                    mean_function: Optional[str] = None
                    ) -> SparseVariationalGaussianProcess:
    """A :class:`SparseVariationalGaussianProcess` over ``inducing_points``
    [M] from numpy parameters as :func:`vgp_from_numpy`'s, on ``device``."""
    k = _model_kernel(kernel, params, dtype, device)
    init = None if dist_q is None else ssm_from_numpy(dist_q, dtype=dtype, device=device)
    return SparseVariationalGaussianProcess(
        k, _likelihood(likelihood, params, dtype, device),
        torch.as_tensor(np.asarray(inducing_points), dtype=dtype, device=device),
        mean_function=_mean_function(mean_function, params, k, dtype, device),
        num_data=num_data, initial_distribution=init)
