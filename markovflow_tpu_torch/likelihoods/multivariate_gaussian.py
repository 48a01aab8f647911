"""Multivariate Gaussian likelihood (counterpart of
``markovflow_tpu/likelihoods/multivariate_gaussian.py``): y = f + eps,
eps ~ N(0, L L^T) with a trainable lower-triangular Cholesky L.  f_means and
y are [..., N, o]; f_covariances are FULL [..., N, o, o]; log-densities are
[..., N]."""
from __future__ import annotations

import torch

from ..utils.bijectors import triangular
from ..utils.linalg import mvn_logpdf, small_cholesky, small_mm, tlt
from ..utils.module import Parameter
from .base import Likelihood

__all__ = ["MultivariateGaussian"]


class MultivariateGaussian(Likelihood):
    #: ``posterior.predict_y`` passes full [o, o] covariances of f
    needs_full_cov = True

    def __init__(self, chol_covariance, *, dtype: torch.dtype, device="cuda"):
        """``chol_covariance`` [o, o], lower triangular: a Parameter through
        the FillTriangular bijector (the JAX ``triangular()``)."""
        super().__init__()
        self.chol_covariance = Parameter(chol_covariance, transform=triangular(),
                                         dtype=dtype, device=device)

    @property
    def obs_dim(self) -> int:
        return self.chol_covariance.value.shape[-1]

    def _covariance(self) -> torch.Tensor:
        chol = self.chol_covariance.value
        return small_mm(chol, tlt(chol))

    def log_probability_density(self, f, y):
        return mvn_logpdf(y, f, self.chol_covariance.value)

    def variational_expectations(self, f_means, f_covariances, y):
        """log N(y; mu, Sigma) - Tr(Sigma^-1 S) / 2, the trace by two
        triangular solves."""
        chol = self.chol_covariance.value
        chol_b = chol.expand(f_covariances.shape)
        x = torch.linalg.solve_triangular(chol_b, f_covariances, upper=False)
        x = torch.linalg.solve_triangular(tlt(chol_b), x, upper=True)
        return (mvn_logpdf(y, f_means, chol)
                - 0.5 * torch.diagonal(x, dim1=-2, dim2=-1).sum(-1))

    def predict_mean_and_var(self, f_means, f_covariances):
        return f_means, f_covariances + self._covariance()

    def predict_density(self, f_means, f_covariances, y):
        return mvn_logpdf(y, f_means, small_cholesky(f_covariances + self._covariance()))
