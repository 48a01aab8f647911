"""Kalman filter classes (counterpart of ``markovflow_tpu/kalman_filter.py``:
``BaseKalmanFilter``, ``KalmanFilter``, the Gaussian sites and the filters
with time-varying and with sparse sites; ``condense`` and the posterior
state-space model are not ported yet).

Two engines, each through the kernel wrappers of :mod:`.ops.cuda_scan`
and :mod:`.ops.adjoint`, which launch the CUDA kernels on CUDA tensors and
run the plain versions on CPU tensors:

* the uniform-grid path, given ``prior_const_tl`` (constant prior steps):
  the uniform filter and smoother, and the uniform Koopman backward;
* the general path, given ``prior_tl`` (per-step prior arrays, any grid):
  the general filter, the smoother scan, and the general Koopman backward.

The filters take the port's ``prior_tl`` / ``prior_const_tl`` in place of
the JAX package's ``StateSpaceModel``.
"""
from __future__ import annotations

import abc

import torch
from torch import nn

from .emission_model import EmissionModel
from .ops.adjoint import log_likelihood_koopman, log_likelihood_koopman_uniform
from .ops.cuda_scan import (filter_pipeline, filter_pipeline_uniform,
                            smoother_pipeline_uniform, smoother_scan)
from .ops.kalman import smoother_elements_tl
from .utils.linalg import small_solve, tlt
from .utils.module import Parameter

__all__ = ["BaseKalmanFilter", "KalmanFilter", "GaussianSites",
           "UnivariateGaussianSitesNat", "KalmanFilterWithSites",
           "KalmanFilterWithSparseSites"]


class GaussianSites(nn.Module, abc.ABC):
    """Gaussian pseudo-observation factors exp(-0.5 f^T Lam f + nu^T f)."""

    @property
    @abc.abstractmethod
    def means(self) -> torch.Tensor:
        ...

    @property
    @abc.abstractmethod
    def precisions(self) -> torch.Tensor:
        ...

    @property
    @abc.abstractmethod
    def natural_parameters(self):
        """(nu [..., N, o], Lam [..., N, o, o])."""


class UnivariateGaussianSitesNat(GaussianSites):
    """Univariate sites in natural form: nat1 = Lam mu [..., N, 1],
    nat2 = -Lam / 2 [..., N, 1, 1], log_norm [..., N, 1].  nat1 and nat2
    are tensors or :class:`~markovflow_tpu_torch.utils.module.Parameter`s."""

    def __init__(self, nat1, nat2, log_norm=None):
        super().__init__()
        self.nat1 = nat1
        self.nat2 = nat2
        self.log_norm = (log_norm if log_norm is not None
                         else torch.zeros_like(self._v(nat1)))

    @staticmethod
    def _v(x):
        return x.value if isinstance(x, Parameter) else x

    @property
    def means(self):
        return -0.5 * self._v(self.nat1) / self._v(self.nat2)[..., 0]

    @property
    def precisions(self):
        return -2.0 * self._v(self.nat2)

    @property
    def natural_parameters(self):
        return self._v(self.nat1), -2.0 * self._v(self.nat2)

    def replace_nats(self, nat1, nat2) -> "UnivariateGaussianSitesNat":
        return UnivariateGaussianSitesNat(nat1, nat2, self.log_norm)


def _sites_tl(nu, lam):
    """nu [..., N, o], lam [..., N, o, o] -> [..., o, 1, N], [..., o, o, N]."""
    return nu[..., None].movedim(-3, -1), lam.movedim(-3, -1)


class BaseKalmanFilter(abc.ABC):
    """Shared machinery: build site arrays, run filter and smoother."""

    def __init__(self, emission_model: EmissionModel, prior_tl=None,
                 prior_const_tl=None):
        """``prior_tl``: (F [..., d, d, N], c [..., d, 1, N], Q [..., d, d, N])
        from ``StationaryKernel.prior_arrays_tl``.  ``prior_const_tl``:
        (Fc, cc, Qc, mu0, P0) from ``StationaryKernel.prior_const_tl`` for a
        uniform grid with a time-constant emission.  One of them is given."""
        if (prior_tl is None) == (prior_const_tl is None):
            raise ValueError("give exactly one of prior_tl and prior_const_tl")
        self.emission = emission_model
        self.prior_tl = prior_tl
        self.prior_const_tl = prior_const_tl

    @abc.abstractmethod
    def _site_nats_tl(self):
        """(nu [..., o, 1, N], lam [..., o, o, N], mask [..., N] or None)."""

    def _emission_tl(self) -> torch.Tensor:
        """[..., N, o, d] -> [..., o, d, N]."""
        return self.emission.emission_matrix.movedim(-3, -1)

    def _const_emission_tl(self) -> torch.Tensor:
        return self.emission.emission_matrix[..., :1, :, :].movedim(-3, -1)

    def _filter_tl(self, nu, lam, mask):
        """The filtered moments (m_f [..., d, 1, N], P_f [..., d, d, N]):
        the uniform filter kernel for constant prior steps, the general one
        otherwise."""
        maskf = None if mask is None else mask.to(nu.dtype)[..., None, None, :]
        if self.prior_const_tl is not None:
            Fc, cc, Qc, mu0, P0 = self.prior_const_tl
            m_f, p_f, _ = filter_pipeline_uniform(
                Fc, cc, Qc, mu0, P0, self._const_emission_tl(), nu, lam, maskf)
        else:
            F, c, Q = self.prior_tl
            m_f, p_f, _ = filter_pipeline(F, c, Q, self._emission_tl(), nu,
                                          lam, maskf)
        return m_f, p_f

    def forward_filter(self):
        """Filtered means and covariances at every time point
        ([..., N, d], [..., N, d, d])."""
        m_f, p_f = self._filter_tl(*self._site_nats_tl())
        return m_f[..., 0, :].movedim(-1, -2), p_f.movedim(-1, -3)

    def log_likelihood(self) -> torch.Tensor:
        """log p(Y) of the (pseudo-)observation model."""
        nu, lam, mask = self._site_nats_tl()
        if self.prior_const_tl is not None:
            Fc, cc, Qc, mu0, P0 = self.prior_const_tl
            return log_likelihood_koopman_uniform(
                Fc, cc, Qc, mu0, P0, self._const_emission_tl(), nu, lam, mask)
        F, c, Q = self.prior_tl
        return log_likelihood_koopman(F, c, Q, self._emission_tl(), nu, lam,
                                      mask)

    def posterior_marginals(self):
        """Smoothed means and covariances ([..., N, d], [..., N, d, d])."""
        m_f, p_f = self._filter_tl(*self._site_nats_tl())
        if self.prior_const_tl is not None:
            Fc, cc, Qc, _, _ = self.prior_const_tl
            m_s, p_s = smoother_pipeline_uniform(Fc, cc, Qc, m_f, p_f)
        else:
            F, c, Q = self.prior_tl
            e, g, ell, _ = smoother_elements_tl(F, c, Q, m_f, p_f)
            m_s, p_s = smoother_scan(e, g, ell)
        return m_s[..., 0, :].movedim(-1, -2), p_s.movedim(-1, -3)


class KalmanFilter(BaseKalmanFilter):
    """Dense Gaussian observations with a constant noise Cholesky."""

    def __init__(self, emission_model, observations, chol_obs_covariance,
                 prior_tl=None, prior_const_tl=None):
        """observations [..., N, o]; chol_obs_covariance [o, o]."""
        super().__init__(emission_model, prior_tl, prior_const_tl)
        self.observations = observations
        self.chol_obs_covariance = chol_obs_covariance

    def _r_inv(self) -> torch.Tensor:
        chol = self.chol_obs_covariance
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        return small_solve(chol @ tlt(chol), eye)

    def _site_nats_tl(self):
        r_inv = self._r_inv()
        o = r_inv.shape[-1]
        y = self.observations.movedim(-2, -1)                      # [..., o, N]
        # nu = R^-1 y as products summed over o (no matmul, so no TF32)
        nu = (r_inv[..., :, :, None] * y[..., None, :, :]).sum(-2)[..., :, None, :]
        lam = r_inv[..., None].expand(y.shape[:-2] + (o, o, y.shape[-1]))
        return nu, lam, None


class KalmanFilterWithSites(BaseKalmanFilter):
    """Time-varying Gaussian sites at every time point."""

    def __init__(self, emission_model: EmissionModel, sites: GaussianSites,
                 prior_tl=None, prior_const_tl=None):
        super().__init__(emission_model, prior_tl, prior_const_tl)
        self.sites = sites

    def _site_nats_tl(self):
        return _sites_tl(*self.sites.natural_parameters) + (None,)


class KalmanFilterWithSparseSites(BaseKalmanFilter):
    """Sites on a subset of a larger time grid: ``observations_index`` [M]
    holds the positions of the M sites among the ``num_grid_points`` grid
    points.  The other steps carry no site (nu = 0, Lam = 0) and are masked
    out of the likelihood and its site gradients."""

    def __init__(self, emission_model: EmissionModel, sites: GaussianSites,
                 num_grid_points: int, observations_index, observations,
                 prior_tl=None, prior_const_tl=None):
        super().__init__(emission_model, prior_tl, prior_const_tl)
        self.sites = sites
        self.num_grid_points = num_grid_points
        self.observations_index = observations_index
        self.observations = observations

    def _site_nats_tl(self):
        nu_obs, lam_obs = self.sites.natural_parameters
        o, n = nu_obs.shape[-1], self.num_grid_points
        kw = dict(dtype=nu_obs.dtype, device=nu_obs.device)
        idx = torch.as_tensor(self.observations_index, device=nu_obs.device)
        nu = torch.zeros(nu_obs.shape[:-2] + (n, o), **kw).index_copy(-2, idx, nu_obs)
        lam = torch.zeros(lam_obs.shape[:-3] + (n, o, o), **kw).index_copy(-3, idx, lam_obs)
        mask = torch.zeros((n,), dtype=torch.bool, device=nu_obs.device)
        mask[idx] = True
        return _sites_tl(nu, lam) + (mask,)
