"""Scalar likelihoods (counterpart of ``markovflow_tpu/likelihoods/scalar.py``;
``Gaussian`` only so far).  f_means and f_covariances are [..., N, 1],
y [..., N, 1]; log-densities are [..., N]."""
from __future__ import annotations

import math

import torch

from ..utils.bijectors import positive
from ..utils.module import Parameter
from .base import Likelihood

__all__ = ["Gaussian"]

_LOG_2PI = math.log(2.0 * math.pi)


class Gaussian(Likelihood):
    """y = f + eps, eps ~ N(0, variance); analytic throughout."""

    def __init__(self, variance=1.0, *, dtype: torch.dtype, device="cuda"):
        super().__init__()
        self.variance = Parameter(variance, transform=positive(), dtype=dtype,
                                  device=device)

    @property
    def obs_dim(self) -> int:
        return 1

    def log_probability_density(self, f, y):
        var = self.variance.value
        return (-0.5 * ((y - f) ** 2 / var + torch.log(var) + _LOG_2PI))[..., 0]

    def variational_expectations(self, f_means, f_covariances, y):
        var = self.variance.value
        return (-0.5 * (((y - f_means) ** 2 + f_covariances) / var
                        + torch.log(var) + _LOG_2PI))[..., 0]

    def predict_density(self, f_means, f_covariances, y):
        var = self.variance.value + f_covariances
        return (-0.5 * ((y - f_means) ** 2 / var + torch.log(var) + _LOG_2PI))[..., 0]

    def predict_mean_and_var(self, f_means, f_covariances):
        return f_means, f_covariances + self.variance.value
