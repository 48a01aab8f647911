"""Stochastic differential equations dx = f(x, t) dt + l(x, t) dB
(counterpart of ``markovflow_tpu/sde/sde.py``).  The drift's gradient comes
from ``torch.func``; expectations under Gaussians use a product
Gauss-Hermite grid (:func:`mvnquad`)."""
from __future__ import annotations

import abc
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils.bijectors import positive
from ..utils.linalg import small_cholesky
from ..utils.module import Parameter

__all__ = ["SDE", "OrnsteinUhlenbeckSDE", "DoubleWellSDE", "Gaussian", "mvnquad"]


class Gaussian(NamedTuple):
    """A marginal Gaussian path: mu [..., N, d], cov [..., N, d, d]."""

    mu: torch.Tensor
    cov: torch.Tensor


def mvnquad(fn, means: torch.Tensor, covs: torch.Tensor, h: int = 10) -> torch.Tensor:
    """E_{x ~ N(means_n, covs_n)}[fn(x)_n] by a product Gauss-Hermite grid
    of h^d nodes.  means [N, d], covs [N, d, d]; ``fn`` maps the flattened
    evaluation points [N h^d, d] to [N h^d, out].  Returns [N, out]."""
    d = means.shape[-1]
    xs, ws = np.polynomial.hermite.hermgauss(h)
    grids = list(itertools.product(*([range(h)] * d)))
    kw = dict(dtype=means.dtype, device=means.device)
    pts = torch.as_tensor(np.array([[xs[i] for i in g] for g in grids]) * math.sqrt(2.0), **kw)
    wts = torch.as_tensor(np.array([np.prod([ws[i] for i in g]) for g in grids])
                          / math.pi ** (d / 2.0), **kw)
    chol = small_cholesky(covs)
    # evaluation points [N, h^d, d], products summed over the state (no matmul)
    x_eval = means[:, None, :] + (chol[:, None, :, :] * pts[None, :, None, :]).sum(-1)
    n, k = x_eval.shape[:2]
    vals = fn(x_eval.reshape(n * k, d)).reshape(n, k, -1)
    return (wts[None, :, None] * vals).sum(1)


class SDE(nn.Module, abc.ABC):
    """An SDE with a drift f(x, t) [..., d] and a diffusion l(x, t)
    [..., d, d] (the Cholesky factor of the noise rate)."""

    @property
    @abc.abstractmethod
    def state_dim(self) -> int:
        ...

    @abc.abstractmethod
    def drift(self, x, t):
        """f(x, t): [..., d] -> [..., d]."""

    @abc.abstractmethod
    def diffusion(self, x, t):
        """l(x, t): [..., d] -> [..., d, d]."""

    def gradient_drift(self, x, t=None):
        """df/dx elementwise (the diagonal of the Jacobian, summed over the
        outputs as in the JAX package), [..., d], by
        ``torch.func.vmap(torch.func.grad(...))`` over the points."""
        if t is None:
            t = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)

        def scalar_drift(xi):
            return self.drift(xi[None, :], t.reshape(-1, t.shape[-1])[:1]).sum()

        flat = x.reshape(-1, x.shape[-1])
        return torch.func.vmap(torch.func.grad(scalar_drift))(flat).reshape(x.shape)

    def expected_drift(self, q_mean, q_covar):
        """E_q[f(x)] under q = N(q_mean [B, N, d], q_covar [B, N, d, d])."""
        b, n, d = q_mean.shape

        def fn(x):
            return self.drift(x, torch.zeros((x.shape[0], 1), dtype=x.dtype,
                                             device=x.device))
        return mvnquad(fn, q_mean.reshape(-1, d), q_covar.reshape(-1, d, d)).reshape(b, n, d)

    def expected_gradient_drift(self, q_mean, q_covar):
        """E_q[df/dx] under q = N(q_mean [B, N, d], q_covar [B, N, d, d])."""
        b, n, d = q_mean.shape
        return mvnquad(self.gradient_drift, q_mean.reshape(-1, d),
                       q_covar.reshape(-1, d, d)).reshape(b, n, d)


def _scaled_eye(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    return (torch.sqrt(q) * eye).expand(x.shape[:-1] + (d, d))


class OrnsteinUhlenbeckSDE(SDE):
    """dx = -decay x dt + dB, Var(dB) = q dt; ``decay`` a positive,
    trainable parameter, ``q`` a buffer."""

    def __init__(self, decay: float = 1.0, q: float = 1.0, *,
                 dtype: torch.dtype, device="cuda"):
        super().__init__()
        self.decay = Parameter(decay, transform=positive(), dtype=dtype,
                               device=device)
        self.register_buffer("q", torch.as_tensor(q, dtype=dtype, device=device))

    @property
    def state_dim(self) -> int:
        return 1

    def drift(self, x, t):
        return -self.decay.value * x

    def diffusion(self, x, t):
        return _scaled_eye(self.q, x)


class DoubleWellSDE(SDE):
    """dx = 4 x (1 - x^2) dt + dB, Var(dB) = q dt; ``q`` a buffer."""

    def __init__(self, q: float = 1.0, *, dtype: torch.dtype, device="cuda"):
        super().__init__()
        self.register_buffer("q", torch.as_tensor(q, dtype=dtype, device=device))

    @property
    def state_dim(self) -> int:
        return 1

    def drift(self, x, t):
        return 4.0 * x * (1.0 - x ** 2)

    def diffusion(self, x, t):
        return _scaled_eye(self.q, x)
