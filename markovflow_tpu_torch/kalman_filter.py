"""Kalman filter classes (counterpart of ``markovflow_tpu/kalman_filter.py``:
``BaseKalmanFilter`` and ``KalmanFilter``).

Two engines, each through the kernel wrappers of :mod:`.ops.cuda_scan`
and :mod:`.ops.adjoint`, which launch the CUDA kernels on CUDA tensors and
run the plain versions on CPU tensors:

* the uniform-grid path, given ``prior_const_tl`` (constant prior steps):
  the uniform filter and smoother, and the uniform Koopman backward;
* the general path, given ``prior_tl`` (per-step prior arrays, any grid):
  the general filter and the smoother scan, which also serves the general
  Koopman backward.
"""
from __future__ import annotations

import abc

import torch

from .emission_model import EmissionModel
from .ops.adjoint import log_likelihood_koopman, log_likelihood_koopman_uniform
from .ops.cuda_scan import (filter_pipeline, filter_pipeline_uniform,
                            smoother_pipeline_uniform, smoother_scan)
from .ops.kalman import smoother_elements_tl
from .utils.linalg import small_solve, tlt

__all__ = ["BaseKalmanFilter", "KalmanFilter"]


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
        nu, lam, mask = self._site_nats_tl()
        maskf = None if mask is None else mask.to(nu.dtype)[..., None, None, :]
        if self.prior_const_tl is not None:
            Fc, cc, Qc, mu0, P0 = self.prior_const_tl
            m_f, p_f, _ = filter_pipeline_uniform(
                Fc, cc, Qc, mu0, P0, self._const_emission_tl(), nu, lam, maskf)
            m_s, p_s = smoother_pipeline_uniform(Fc, cc, Qc, m_f, p_f)
        else:
            F, c, Q = self.prior_tl
            m_f, p_f, _ = filter_pipeline(F, c, Q, self._emission_tl(), nu,
                                          lam, maskf)
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
