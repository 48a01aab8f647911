"""Kalman filter classes (counterpart of ``markovflow_tpu/kalman_filter.py``:
``BaseKalmanFilter`` with the posterior state-space model, ``KalmanFilter``,
the Gaussian sites and the filters with time-varying and with sparse sites,
and ``condense``).

Two engines, each through the kernel wrappers of :mod:`.ops.cuda_scan`
and :mod:`.ops.adjoint`, which launch the CUDA kernels on CUDA tensors and
run the plain versions on CPU tensors:

* the uniform-grid path, given ``prior_const_tl`` (constant prior steps)
  and an emission that is the same at every step: the uniform filter and
  smoother, and the uniform Koopman backward;
* the general path, given ``prior_tl`` (per-step prior arrays, any grid),
  or ``prior_const_tl`` with an emission that changes with the step (the
  constant steps materialised): the general filter, the smoother scan,
  and the general Koopman backward.  The JAX package's uniform path reads
  step 0's emission at every step (``markovflow_tpu/kalman_filter.py``'s
  ``hc``); the port does not copy that.

The filters take the port's ``prior_tl`` / ``prior_const_tl`` in place of
the JAX package's ``StateSpaceModel``.
"""
from __future__ import annotations

import abc

import torch
from torch import nn

from .emission_model import EmissionModel, time_constant
from .ops.adjoint import log_likelihood_koopman, log_likelihood_koopman_uniform
from .ops.cuda_scan import (MULTI_OUTPUT_MAX_STATE_DIM, UNIFORM_MAX_OUTPUT_DIM,
                            filter_pipeline, filter_pipeline_uniform,
                            smoother_pipeline_uniform, smoother_scan)
from .ops.kalman import (_materialize_uniform, _posterior_ssm_tl, rts_gains_tl,
                         smoother_elements_tl)
from .ops.scans import segmented_affine_cov_scan_tl
from .state_space_model import StateSpaceModel
from .utils.linalg import psd_cholesky, small_solve, tlt
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
        uniform grid.  One of them is given.  The route is chosen here, once,
        on the emission tensor itself: constant prior steps take the uniform
        kernels only where the emission is the same at every step
        (:func:`~markovflow_tpu_torch.emission_model.time_constant`) and
        has at most ``UNIFORM_MAX_OUTPUT_DIM`` rows, or one row above state
        dim ``MULTI_OUTPUT_MAX_STATE_DIM`` (as the JAX package's
        ``_uniform_engine`` routes it: its uniform kernels stop at d = 6,
        and its materialised route takes the general ones), and are
        materialised to per-step arrays, for the general kernels,
        otherwise."""
        if (prior_tl is None) == (prior_const_tl is None):
            raise ValueError("give exactly one of prior_tl and prior_const_tl")
        self.emission = emission_model
        h = emission_model.emission_matrix
        o, d = h.shape[-2:]
        if prior_const_tl is not None and (
                o > UNIFORM_MAX_OUTPUT_DIM or (o > 1 and d > MULTI_OUTPUT_MAX_STATE_DIM)
                or not time_constant(h)):
            f_tl, c_tl, q_tl, _ = _materialize_uniform(
                *prior_const_tl, self._const_emission_tl(), h.shape[-3])
            prior_tl, prior_const_tl = (f_tl, c_tl, q_tl), None
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

    def _smoothed_tl(self, with_gains: bool = False):
        """The smoothed moments (m_s [..., d, 1, N], P_s [..., d, d, N]): the
        filter kernel, then the uniform smoother kernel for constant prior
        steps or the smoother-scan kernel of the RTS elements otherwise;
        with ``with_gains`` also the RTS gains [..., d, d, N-1] (on the
        uniform path elementwise from the constant steps and P_f)."""
        m_f, p_f = self._filter_tl(*self._site_nats_tl())
        if self.prior_const_tl is not None:
            Fc, cc, Qc, _, _ = self.prior_const_tl
            m_s, p_s = smoother_pipeline_uniform(Fc, cc, Qc, m_f, p_f)
            gains = rts_gains_tl(Fc, Qc, p_f[..., :-1]) if with_gains else None
        else:
            F, c, Q = self.prior_tl
            e, g, ell, gains = smoother_elements_tl(F, c, Q, m_f, p_f)
            m_s, p_s = smoother_scan(e, g, ell)
        return m_s, p_s, gains

    def posterior_marginals(self):
        """Smoothed means and covariances ([..., N, d], [..., N, d, d])."""
        m_s, p_s, _ = self._smoothed_tl()
        return m_s[..., 0, :].movedim(-1, -2), p_s.movedim(-1, -3)

    def posterior_state_space_model(self) -> StateSpaceModel:
        """The posterior over the states as a forward state-space model:
        one filter and one smoother launch, then the posterior's (A, b, Q)
        from the smoothed moments and the RTS gains.  ``psd_cholesky``
        factors P0 and Q: Q = P_{k+1} - A Cov(x_k, x_{k+1}) cancels for
        near-coincident points and can come out a roundoff below zero.
        The model carries the smoother's moments and Cov(x_{k+1}, x_k) =
        (G_k P_{k+1})^T, which its marginals read: rebuilt from the clamped
        factors they drift (the JAX package's rebuild, at d = 9, T = 1e5,
        float64, is 249 times off the smoother's covariances; ROADMAP
        queue 3)."""
        m_s, p_s, gains = self._smoothed_tl(with_gains=True)
        a_post, b_post, q_post, cross = _posterior_ssm_tl(m_s, p_s, gains)
        from_tl = lambda x: x.movedim(-1, -3)  # noqa: E731
        return StateSpaceModel(m_s[..., 0, 0], psd_cholesky(p_s[..., 0]),
                               from_tl(a_post), from_tl(b_post)[..., 0],
                               psd_cholesky(from_tl(q_post)),
                               moments_tl=(m_s, p_s, cross.transpose(-3, -2)))


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

    def condense(self) -> KalmanFilterWithSites:
        """An equivalent filter on the M observed points alone: each
        unobserved stretch of the grid collapses into one transition, the
        composition of its grid steps, by one segmented affine scan of the
        prior steps (independent of the sites).  Its ``log_likelihood``
        equals this filter's; its posterior lives on the observed points."""
        if self.prior_tl is not None:
            f_tl, c_tl, q_tl = self.prior_tl
        else:
            f_tl, c_tl, q_tl, _ = _materialize_uniform(
                *self.prior_const_tl, self._const_emission_tl(), self.num_grid_points)
        n = f_tl.shape[-1]
        idx = torch.as_tensor(self.observations_index, device=f_tl.device)
        # segments restart at 0 (the prior element) and after each observation
        start = torch.zeros((n + 1,), dtype=torch.bool, device=f_tl.device)
        start[0] = True
        start[idx + 1] = True
        fc, cc, qc = segmented_affine_cov_scan_tl(f_tl, c_tl, q_tl, start[:n])
        fc, cc, qc = (x.index_select(-1, idx) for x in (fc, cc, qc))
        h_m = self.emission.emission_matrix.index_select(-3, idx)
        return KalmanFilterWithSites(EmissionModel(h_m), self.sites,
                                     prior_tl=(fc, cc, qc))
