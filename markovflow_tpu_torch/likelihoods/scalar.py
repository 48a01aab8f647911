"""Scalar likelihoods (counterpart of ``markovflow_tpu/likelihoods/scalar.py``):
Gaussian, Bernoulli (probit), Poisson and Student-t.  f_means and
f_covariances are [..., N, 1], y [..., N, 1]; log-densities are [..., N].
Analytic where the JAX package is, Gauss-Hermite quadrature otherwise."""
from __future__ import annotations

import math

import torch

from ..utils.bijectors import positive
from ..utils.module import Parameter
from .base import Likelihood, gauss_hermite

__all__ = ["Gaussian", "Bernoulli", "Poisson", "StudentT", "inv_probit"]

_LOG_2PI = math.log(2.0 * math.pi)


def inv_probit(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF squeezed into (jitter, 1 - jitter), jitter
    1e-3 (as in gpflow), so that log p and log(1 - p) stay finite."""
    jitter = 1e-3
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0))) * (1 - 2 * jitter) + jitter


def _bernoulli_log(p, y):
    return torch.where(y > 0.5, torch.log(p), torch.log1p(-p))[..., 0]


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


class Bernoulli(Likelihood):
    """y in {0, 1} with the probit inverse link ``inv_probit``: closed-form
    predictive moments, Gauss-Hermite variational expectations.  It holds
    no parameter, so it takes no dtype or device."""

    def log_probability_density(self, f, y):
        return _bernoulli_log(inv_probit(f), y)

    def variational_expectations(self, f_means, f_covariances, y):
        return gauss_hermite(lambda f: self.log_probability_density(f, y),
                             f_means, f_covariances)

    def predict_mean_and_var(self, f_means, f_covariances):
        p = inv_probit(f_means / torch.sqrt(1.0 + f_covariances))
        return p, p - p ** 2

    def predict_density(self, f_means, f_covariances, y):
        p, _ = self.predict_mean_and_var(f_means, f_covariances)
        return _bernoulli_log(p, y)


class Poisson(Likelihood):
    """y ~ Poisson(binsize exp(f)): analytic variational expectations for
    the exp link.  It holds no parameter (``binsize`` is a float)."""

    def __init__(self, binsize: float = 1.0):
        super().__init__()
        self.binsize = binsize

    def log_probability_density(self, f, y):
        lam = torch.exp(f) * self.binsize
        return (y * torch.log(lam) - lam - torch.lgamma(y + 1.0))[..., 0]

    def variational_expectations(self, f_means, f_covariances, y):
        lam_bar = torch.exp(f_means + 0.5 * f_covariances) * self.binsize
        return (y * (f_means + math.log(self.binsize)) - lam_bar
                - torch.lgamma(y + 1.0))[..., 0]

    def predict_mean_and_var(self, f_means, f_covariances):
        mean = torch.exp(f_means + 0.5 * f_covariances) * self.binsize
        return mean, mean + (torch.exp(f_covariances) - 1.0) * mean ** 2

    def predict_density(self, f_means, f_covariances, y):
        return torch.log(gauss_hermite(
            lambda f: torch.exp(self.log_probability_density(f, y)),
            f_means, f_covariances))


class StudentT(Likelihood):
    """y = f + eps with Student-t noise of ``df`` degrees of freedom (a
    float) and a positive, trainable ``scale`` (robust regression)."""

    def __init__(self, scale=1.0, df: float = 3.0, *, dtype: torch.dtype,
                 device="cuda"):
        super().__init__()
        self.scale = Parameter(scale, transform=positive(), dtype=dtype,
                               device=device)
        self.df = df

    def log_probability_density(self, f, y):
        nu = self.df
        s = self.scale.value
        z = (y - f) / s
        const = (math.lgamma((nu + 1) / 2) - math.lgamma(nu / 2)
                 - 0.5 * math.log(nu * math.pi))
        return (const - torch.log(s) - (nu + 1) / 2 * torch.log1p(z ** 2 / nu))[..., 0]

    def variational_expectations(self, f_means, f_covariances, y):
        return gauss_hermite(lambda f: self.log_probability_density(f, y),
                             f_means, f_covariances)

    def predict_mean_and_var(self, f_means, f_covariances):
        var = self.scale.value ** 2 * self.df / (self.df - 2.0)
        return f_means, f_covariances + var

    def predict_density(self, f_means, f_covariances, y):
        return torch.log(gauss_hermite(
            lambda f: torch.exp(self.log_probability_density(f, y)),
            f_means, f_covariances))
