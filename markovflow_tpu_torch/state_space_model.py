"""Discrete linear-Gaussian state-space model (counterpart of
``markovflow_tpu/state_space_model.py``).

For states x_0 .. x_T (T = num_transitions):

    x_0 ~ N(mu0, P0),   x_{k+1} = A_k x_k + b_k + q_k,  q_k ~ N(0, Q_k)

held as (mu0 [..., d], chol_P0 [..., d, d], A [..., T, d, d], b [..., T, d],
chol_Q [..., T, d, d]), each a tensor or a
:class:`~markovflow_tpu_torch.utils.module.Parameter`.  Marginals and
sampling run as affine prefix scans (:mod:`.ops.scans`) in time-last
layout; every small-matrix product is elementwise (no matmul, so no TF32
on the card).  A model whose moments are known exactly (the posterior
SSM, from the smoother) carries them, and its marginals read them
instead of rebuilding them from the factors by a scan.  Sampling takes a
``torch.Generator``, and its affine map of the standard-normal draw is
:meth:`StateSpaceModel.sample_from_normals`.  ``precision()`` is the
block-tridiagonal K^-1 (:mod:`.block_tri_diag`).
"""
from __future__ import annotations

import math

import torch

from .gauss_markov import GaussMarkovDistribution, check_compatible
from .ops.kalman import _cat, _inv_tl, _no_tf32, _to_tl
from .ops.scans import (_combine_affine, _mm_tl, _sym_tl, _t_tl, affine_cov_scan_tl,
                        scan_tl)
from .utils.bijectors import triangular
from .utils.linalg import (cholesky_or_zero, mvn_logpdf, small_inv, small_mm, small_mv,
                           symmetrize, tlt)
from .utils.module import Parameter

__all__ = ["StateSpaceModel", "state_space_model_from_covariances"]


def _v(x):
    return x.value if isinstance(x, Parameter) else x


class StateSpaceModel(GaussMarkovDistribution):
    def __init__(self, initial_mean, chol_initial_covariance, state_transitions,
                 state_offsets, chol_process_covariances, moments_tl=None):
        """Shapes: mu0 [..., d]; chol_P0 [..., d, d]; A [..., T, d, d];
        b [..., T, d]; chol_Q [..., T, d, d].  ``moments_tl``: the exact
        (means [..., d, 1, T+1], covariances [..., d, d, T+1],
        Cov(x_{k+1}, x_k) [..., d, d, T]) in time-last layout, where the
        caller has them.  The rebuild from the factors loses them where
        Q's factor is clamped: the posterior's Q = P_{k+1} - A Cov(x_k,
        x_{k+1}) is roundoff-indefinite at near-deterministic steps."""
        super().__init__()
        self._mu0 = initial_mean
        self._chol_P0 = chol_initial_covariance
        self._A_s = state_transitions
        self._b_s = state_offsets
        self._chol_Q_s = chol_process_covariances
        self._moments_tl = moments_tl

    # --- raw accessors ---------------------------------------------------
    @property
    def initial_mean(self):
        return _v(self._mu0)

    @property
    def cholesky_initial_covariance(self):
        return _v(self._chol_P0)

    @property
    def state_transitions(self):
        return _v(self._A_s)

    @property
    def state_offsets(self):
        return _v(self._b_s)

    @property
    def cholesky_process_covariances(self):
        return _v(self._chol_Q_s)

    @property
    def initial_covariance(self):
        l0 = self.cholesky_initial_covariance
        return small_mm(l0, tlt(l0))

    @property
    def process_covariances(self):
        lq = self.cholesky_process_covariances
        return small_mm(lq, tlt(lq))

    # --- shapes -----------------------------------------------------------
    @property
    def state_dim(self) -> int:
        return self.state_transitions.shape[-1]

    @property
    def num_transitions(self) -> int:
        return self.state_transitions.shape[-3]

    @property
    def batch_shape(self):
        return tuple(self.initial_mean.shape[:-1])

    @property
    def event_shape(self):
        return (self.num_transitions + 1, self.state_dim)

    @property
    def dtype(self):
        return self.initial_mean.dtype

    @property
    def device(self):
        return self.initial_mean.device

    # --- affine-scan elements, time-last -------------------------------
    def _prefix_elements_tl(self):
        """(F [..., d, d, T+1], c [..., d, 1, T+1], chol [..., d, d, T+1])
        with element 0 the initial distribution (F_0 = 0, c_0 = mu0,
        chol_0 = chol_P0)."""
        a_tl = _to_tl(self.state_transitions)
        f_tl = torch.cat([torch.zeros_like(a_tl[..., :1]), a_tl], dim=-1)
        c_tl = _cat([self.initial_mean[..., None, None],
                     _to_tl(self.state_offsets[..., None])], dim=-1)
        chols = _cat([self.cholesky_initial_covariance[..., None],
                      _to_tl(self.cholesky_process_covariances)], dim=-1)
        return f_tl, c_tl, chols

    def prior_tl(self):
        """(F [..., d, d, T+1], c [..., d, 1, T+1], Q [..., d, d, T+1]), the
        filters' per-step prior: element 0 the initial distribution
        (F_0 = 0, c_0 = mu0, Q_0 = P0), then (A_k, b_k, Q_k)."""
        f_tl, c_tl, chols = self._prefix_elements_tl()
        return f_tl, c_tl, _mm_tl(chols, _t_tl(chols))

    def marginals_tl(self):
        """(means [..., d, 1, T+1], covs [..., d, d, T+1]) in time-last
        layout: the known moments, or one affine covariance scan."""
        if self._moments_tl is not None:
            return self._moments_tl[:2]
        return self.rebuilt_marginals_tl()

    def rebuilt_marginals_tl(self):
        """:meth:`marginals_tl` by the affine covariance scan of the
        factors, whether or not the moments are known."""
        return affine_cov_scan_tl(*self.prior_tl())

    def subsequent_covariances_tl(self, covs_tl=None) -> torch.Tensor:
        """Cov(x_{k+1}, x_k) [..., d, d, T]: the known one, or A_k P_k from
        the time-last covariances ``covs_tl`` (default the marginals')."""
        if self._moments_tl is not None and covs_tl is None:
            return self._moments_tl[2]
        if covs_tl is None:
            covs_tl = self.marginals_tl()[1]
        return _mm_tl(_to_tl(self.state_transitions), covs_tl[..., :-1])

    @property
    def marginals(self):
        ms, ps = self.marginals_tl()
        return ms[..., 0, :].movedim(-1, -2), ps.movedim(-1, -3)

    @property
    def marginal_means(self) -> torch.Tensor:
        """[..., T+1, d]."""
        return self.marginals[0]

    @property
    def marginal_covariances(self) -> torch.Tensor:
        """[..., T+1, d, d]."""
        return self.marginals[1]

    def subsequent_covariances(self, marginal_covariances=None) -> torch.Tensor:
        """Cov(x_{k+1}, x_k) = A_k P_k, [..., T, d, d] (the known one when
        no covariances are given)."""
        if marginal_covariances is None:
            return self.subsequent_covariances_tl().movedim(-1, -3)
        return small_mm(self.state_transitions, marginal_covariances[..., :-1, :, :])

    def covariance_blocks(self):
        return self.marginal_covariances, self.subsequent_covariances()

    # --- sampling ----------------------------------------------------------
    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        """Draws [sample_shape..., batch..., T+1, d]: standard normals from
        ``generator`` (a ``torch.Generator`` on the model's device, or the
        default one) through :meth:`sample_from_normals`."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = torch.randn(shape, generator=generator, dtype=self.dtype,
                          device=self.device)
        return self.sample_from_normals(eps)

    def sample_from_normals(self, eps: torch.Tensor) -> torch.Tensor:
        """The affine map of standard normals eps [..., batch..., T+1, d] to
        states: x_0 = mu0 + L0 eps_0, x_{k+1} = A_k x_k + b_k + L_k eps_{k+1},
        by an affine prefix scan."""
        f_tl, c_tl, chols = self._prefix_elements_tl()
        noise = _mm_tl(chols, eps[..., None].movedim(-3, -1))
        _, xs = scan_tl(_combine_affine, (f_tl, c_tl + noise))
        return xs[..., 0, :].movedim(-1, -2)

    # --- densities -----------------------------------------------------------
    @property
    def log_det_precision(self) -> torch.Tensor:
        """log |K^-1| = -log|P0| - sum_k log|Q_k|."""
        l0 = self.cholesky_initial_covariance
        lq = self.cholesky_process_covariances
        ld0 = 2.0 * torch.log(torch.abs(torch.diagonal(l0, dim1=-2, dim2=-1))).sum(-1)
        ldq = 2.0 * torch.log(torch.abs(torch.diagonal(lq, dim1=-2, dim2=-1))).sum((-1, -2))
        return -(ld0 + ldq)

    def log_pdf(self, states: torch.Tensor) -> torch.Tensor:
        """log p(x_0..x_T) for states [sample..., batch..., T+1, d]."""
        _no_tf32(states)
        lp0 = mvn_logpdf(states[..., 0, :], self.initial_mean,
                         self.cholesky_initial_covariance)
        pred = small_mv(self.state_transitions, states[..., :-1, :]) + self.state_offsets
        lpt = mvn_logpdf(states[..., 1:, :], pred, self.cholesky_process_covariances)
        return lp0 + lpt.sum(-1)

    def kl_divergence(self, other: "StateSpaceModel", marginals_tl=None) -> torch.Tensor:
        """KL[self || other] in closed form from the marginal and pairwise
        statistics of self, elementwise d x d algebra over the transitions.
        ``marginals_tl``: ``self.marginals_tl()`` when the caller has it."""
        check_compatible(self, other)
        _no_tf32(self.initial_mean)
        q, p = self, other
        n_states = q.num_transitions + 1
        d = q.state_dim
        log2pi = math.log(2.0 * math.pi)
        mq, pq = marginals_tl if marginals_tl is not None else q.marginals_tl()
        cq = q.subsequent_covariances_tl(None if marginals_tl is None else pq)
        e_log_q = 0.5 * q.log_det_precision - 0.5 * n_states * d * (log2pi + 1.0)
        # the initial term
        l0p = p.cholesky_initial_covariance
        term0 = mvn_logpdf(mq[..., 0, 0], p.initial_mean, l0p)
        x = torch.linalg.solve_triangular(l0p.expand(pq[..., 0].shape), pq[..., 0],
                                          upper=False)
        x = torch.linalg.solve_triangular(tlt(l0p).expand(x.shape), x, upper=True)
        term0 = term0 - 0.5 * torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)
        # the transition terms
        ap_tl = _to_tl(p.state_transitions)
        bp_tl = _to_tl(p.state_offsets[..., None])
        lqp_tl = _to_tl(p.cholesky_process_covariances)
        r_mean = mq[..., 1:] - _mm_tl(ap_tl, mq[..., :-1]) - bp_tl
        ap_cq_t = _mm_tl(ap_tl, _t_tl(cq))
        r_cov = (pq[..., 1:] - ap_cq_t - _t_tl(ap_cq_t)
                 + _mm_tl(ap_tl, _mm_tl(pq[..., :-1], _t_tl(ap_tl))))
        qp_inv = _inv_tl(_sym_tl(_mm_tl(lqp_tl, _t_tl(lqp_tl))))
        maha = (r_mean * _mm_tl(qp_inv, r_mean)).sum((-3, -2))
        diag_lqp = torch.stack([lqp_tl[..., i, i, :] for i in range(d)], dim=-2)
        log_det_qp = 2.0 * torch.log(torch.abs(diag_lqp)).sum(-2)
        term_t = -0.5 * (maha + log_det_qp + d * log2pi)
        term_t = term_t - 0.5 * (qp_inv * _sym_tl(r_cov)).sum((-3, -2))
        e_log_p = term0 + term_t.sum(-1)
        return e_log_q - e_log_p

    # --- precision space -------------------------------------------------
    def precision(self):
        """The joint precision K^-1 = A^-T Q^-1 A^-1, block-tridiagonal: the
        diagonal blocks Q_k^-1 + A_k^T Q_{k+1}^-1 A_k (P0^-1 first), the
        block (k+1, k) -Q_{k+1}^-1 A_k."""
        from .block_tri_diag import SymmetricBlockTriDiagonal

        def inv_from_chol(l):
            return small_inv(symmetrize(l @ tlt(l)))

        a = self.state_transitions
        p0_inv = inv_from_chol(self.cholesky_initial_covariance)
        q_inv = inv_from_chol(self.cholesky_process_covariances)
        at_qinv_a = (tlt(a) @ q_inv) @ a
        diag_first = (p0_inv + at_qinv_a[..., 0, :, :])[..., None, :, :]
        diag = torch.cat([diag_first, q_inv[..., :-1, :, :] + at_qinv_a[..., 1:, :, :],
                          q_inv[..., -1:, :, :]], dim=-3)
        return SymmetricBlockTriDiagonal(symmetrize(diag), -(q_inv @ a))

    @property
    def normalizer(self) -> torch.Tensor:
        """The log-partition of the Gaussian in natural form,
        0.5 (mu^T K^-1 mu + (T+1) d log 2pi - log|K^-1|)."""
        means = self.marginal_means
        quad = (means * self.precision().block_mult_vector(means)).sum((-1, -2))
        n_states = self.num_transitions + 1
        return 0.5 * (quad + n_states * self.state_dim * math.log(2.0 * math.pi)
                      - self.log_det_precision)

    # --- trainability ------------------------------------------------------
    def trainable_copy(self) -> "StateSpaceModel":
        """A copy whose five fields are trainable Parameters (the Cholesky
        factors through ``triangular()``)."""
        kw = dict(dtype=self.dtype, device=self.device)
        tri = triangular()
        return StateSpaceModel(
            Parameter(self.initial_mean, **kw),
            Parameter(self.cholesky_initial_covariance, transform=tri, **kw),
            Parameter(self.state_transitions, **kw),
            Parameter(self.state_offsets, **kw),
            Parameter(self.cholesky_process_covariances, transform=tri, **kw))

    def non_trainable_copy(self) -> "StateSpaceModel":
        """A copy of the current values (and known moments) as plain
        tensors, detached."""
        moments = (None if self._moments_tl is None
                   else tuple(x.detach() for x in self._moments_tl))
        return StateSpaceModel(*(x.detach() for x in (
            self.initial_mean, self.cholesky_initial_covariance,
            self.state_transitions, self.state_offsets,
            self.cholesky_process_covariances)), moments_tl=moments)


def state_space_model_from_covariances(initial_mean, initial_covariance,
                                       state_transitions, state_offsets,
                                       process_covariances) -> StateSpaceModel:
    """An SSM from covariances (not their Cholesky factors); exactly-zero
    covariance blocks map to zero factors."""
    return StateSpaceModel(initial_mean, cholesky_or_zero(initial_covariance),
                           state_transitions, state_offsets,
                           cholesky_or_zero(process_covariances))
