"""Likelihood interface and Gauss-Hermite quadrature (counterpart of
``markovflow_tpu/likelihoods/base.py``)."""
from __future__ import annotations

import abc

import numpy as np
import torch
from torch import nn

__all__ = ["Likelihood", "gauss_hermite"]

DEFAULT_NUM_GAUSS_HERMITE = 20


def gauss_hermite(fn, means: torch.Tensor, variances: torch.Tensor,
                  num_points: int = DEFAULT_NUM_GAUSS_HERMITE) -> torch.Tensor:
    """E_{f ~ N(means, variances)}[fn(f)] elementwise, by Gauss-Hermite
    quadrature with ``num_points`` nodes; ``fn`` broadcasts over a leading
    nodes axis."""
    xs, ws = np.polynomial.hermite.hermgauss(num_points)
    kw = dict(dtype=means.dtype, device=means.device)
    xs = torch.as_tensor(xs, **kw).reshape((num_points,) + (1,) * means.dim())
    ws = torch.as_tensor(ws / np.sqrt(np.pi), **kw)
    vals = fn(means[None] + torch.sqrt(2.0 * variances)[None] * xs)
    return torch.tensordot(ws, vals, dims=([0], [0]))


class Likelihood(nn.Module, abc.ABC):
    """A likelihood p(y | f) over f = H x."""

    @abc.abstractmethod
    def log_probability_density(self, f, y):
        """log p(y | f), [..., N]."""

    @abc.abstractmethod
    def variational_expectations(self, f_means, f_covariances, y):
        """E_{q(f)}[log p(y | f)] with q = N(f_means, f_covariances), [..., N]."""

    @abc.abstractmethod
    def predict_density(self, f_means, f_covariances, y):
        """log of the integral of p(y | f) q(f) df, [..., N]."""

    @abc.abstractmethod
    def predict_mean_and_var(self, f_means, f_covariances):
        """Moments of p(y) = integral of p(y | f) q(f) df."""
