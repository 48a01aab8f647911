"""Posterior processes: prediction and sampling at any time points
(counterpart of ``markovflow_tpu/posterior.py``; the importance-weighted
posterior of IWVI is not ported yet).

A posterior process wraps a Gauss-Markov distribution over the states at
the conditioning points and extends it to the whole line through the
Markov conditionals (:mod:`.conditionals`).  Sampling takes an explicit
``torch.Generator`` (on the model's device) in place of a PRNG key.
"""
from __future__ import annotations

import abc

import torch
from torch import nn

from .conditionals import conditional_predict_tl, conditional_statistics
from .gauss_markov import GaussMarkovDistribution
from .utils.linalg import small_mv, take_rows

__all__ = ["PosteriorProcess", "ConditionalProcess", "AnalyticPosteriorProcess"]


class PosteriorProcess(nn.Module, abc.ABC):
    @abc.abstractmethod
    def predict_state(self, new_time_points):
        ...

    @abc.abstractmethod
    def predict_f(self, new_time_points, full_output_cov: bool = False):
        ...

    @abc.abstractmethod
    def sample_state(self, new_time_points, sample_shape, generator=None):
        ...

    def sample_f(self, new_time_points, sample_shape, generator=None):
        """Draws of f at ``new_time_points``: [sample_shape..., batch...,
        N*, o]."""
        samples = self.sample_state(new_time_points, sample_shape, generator)
        em = self.kernel.generate_emission_model(new_time_points)
        return em.project_state_to_f(samples)


class ConditionalProcess(PosteriorProcess):
    """q(s(.)) = integral of p(s(.) | s(Z)) q(s(Z)) dZ: closed-form
    marginals and pathwise-conditioned sampling."""

    def __init__(self, posterior_dist: GaussMarkovDistribution, kernel,
                 conditioning_time_points):
        super().__init__()
        self.dist = posterior_dist
        self.kernel = kernel
        self.conditioning_time_points = conditioning_time_points

    def predict_state(self, new_time_points):
        """Marginal state means [..., N*, d] and covariances
        [..., N*, d, d] at the new points, from the time-last core."""
        means_tl, covs_tl = conditional_predict_tl(
            new_time_points, self.conditioning_time_points, self.kernel, self.dist)
        return means_tl[..., 0, :].movedim(-1, -2), covs_tl.movedim(-1, -3)

    def predict_f(self, new_time_points, full_output_cov: bool = False):
        means, covs = self.predict_state(new_time_points)
        em = self.kernel.generate_emission_model(new_time_points)
        return em.project_state_marginals_to_f(means, covs, full_output_cov)

    def sample_state(self, new_time_points, sample_shape, generator=None):
        """Joint posterior draws of the states at the new points, by
        pathwise conditioning (:meth:`sample_state_trajectories`)."""
        s, _ = self.sample_state_trajectories(new_time_points, sample_shape,
                                              generator)
        return s

    def sample_state_trajectories(self, new_time_points, sample_shape,
                                  generator=None):
        """Joint draws (s at the new points, u at the conditioning points)
        from q(u) p(s | u): u first, then the prior trajectory, both from
        ``generator``."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        u_o = self.dist.sample(sample_shape, generator)
        s = self._sample_states_given_u(new_time_points, u_o, generator)
        return s, u_o

    def _sample_states_given_u(self, t_new, u_o, generator=None):
        """A prior trajectory over [Z, t_new], corrected pathwise to hit the
        draws u_o at Z: s(t) = s_p(t) - P (u_p - u_o) of t's adjacent pair."""
        z = self.conditioning_time_points
        n_z = z.shape[-1]
        sample_shape = u_o.shape[: u_o.dim() - 2 - len(self.dist.batch_shape)]
        lead = torch.broadcast_shapes(z.shape[:-1], t_new.shape[:-1])
        all_times = torch.cat([z.expand(lead + z.shape[-1:]),
                               t_new.expand(lead + t_new.shape[-1:])], dim=-1)
        order = torch.argsort(all_times, dim=-1, stable=True)
        sorted_times = torch.gather(all_times, -1, order)
        inv_order = torch.argsort(order, dim=-1, stable=True)
        s_p = self.kernel.state_space_model(sorted_times).sample(sample_shape,
                                                                  generator)
        u_p = take_rows(s_p, inv_order[..., :n_z])
        s_p_new = take_rows(s_p, inv_order[..., n_z:])
        v = u_p - u_o
        zeros = torch.zeros_like(v[..., :1, :])
        v_ext = torch.cat([zeros, v, zeros], dim=-2)
        pair_v = torch.cat([v_ext[..., :-1, :], v_ext[..., 1:, :]], dim=-1)
        p_proj, _, _, indices = conditional_statistics(t_new, z, self.kernel)
        return s_p_new - small_mv(p_proj, take_rows(pair_v, indices))


class AnalyticPosteriorProcess(ConditionalProcess):
    """A :class:`ConditionalProcess` with a likelihood, for ``predict_y``,
    and the model's mean function, added to f."""

    def __init__(self, posterior_dist, kernel, conditioning_time_points,
                 likelihood, mean_function=None):
        super().__init__(posterior_dist, kernel, conditioning_time_points)
        self.likelihood = likelihood
        self.mean_function = mean_function

    def predict_f(self, new_time_points, full_output_cov: bool = False):
        means, covs = super().predict_f(new_time_points, full_output_cov)
        if self.mean_function is not None:
            means = means + self.mean_function(new_time_points)
        return means, covs

    def predict_y(self, new_time_points):
        """Means and variances of y at the new points."""
        full = getattr(self.likelihood, "needs_full_cov", False)
        f_means, f_covs = self.predict_f(new_time_points, full_output_cov=full)
        return self.likelihood.predict_mean_and_var(f_means, f_covs)
