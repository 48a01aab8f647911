"""Conditional (off-grid) prediction for Markovian GPs (counterpart of
``markovflow_tpu/conditionals.py``; the ``cyclic_reduction_*`` functions
are not ported yet).

For a new time point t* between existing points t- < t* <= t+ the Markov
property gives p(x* | x-, x+) = N(P [x-; x+] + o, T), from the transition
statistics of the two sub-intervals.  Points before the first or after the
last existing point take a phantom neighbour at -/+ ``APPROX_INF``; a new
point equal to an existing one (``dt2 == 0``) is that point's state
exactly.  The core runs in time-last layout ([..., d, d, N*]) with
elementwise d x d algebra over the new points, and gathers the adjacent
pair moments along the time axis; the standard-layout functions are views
of it.
"""
from __future__ import annotations

import torch

from .config import APPROX_INF
from .ops.kalman import _cat, _eye_tl, _inv_tl, _to_tl
from .ops.scans import _mm_tl, _sym_tl, _t_tl
from .utils.linalg import searchsorted, small_mm, small_mv, take_last, take_rows

__all__ = ["pairwise_marginals", "conditional_statistics",
           "base_conditional_predict", "conditional_predict",
           "conditional_predict_tl"]


def _pairwise_marginals_tl(dist, initial_mean, initial_covariance):
    """:func:`pairwise_marginals` in time-last layout: (means
    [..., 2d, 1, T+2], covs [..., 2d, 2d, T+2]), from the moments of
    ``dist`` (a StateSpaceModel: the known ones, or one affine covariance
    scan)."""
    ms, ps = dist.marginals_tl()
    sub = dist.subsequent_covariances_tl()                    # Cov(x_{k+1}, x_k)
    im = initial_mean[..., :, None, None]
    ic = initial_covariance[..., None]
    ext_m = _cat([im, ms, im], dim=-1)
    ext_c = _cat([ic, ps, ic], dim=-1)
    zero = torch.zeros_like(ic)
    ext_sub = _cat([zero, sub, zero], dim=-1)
    means = torch.cat([ext_m[..., :-1], ext_m[..., 1:]], dim=-3)
    top = torch.cat([ext_c[..., :-1], _t_tl(ext_sub)], dim=-2)
    bottom = torch.cat([ext_sub, ext_c[..., 1:]], dim=-2)
    return means, torch.cat([top, bottom], dim=-3)


def pairwise_marginals(dist, initial_mean, initial_covariance):
    """Joint mean and covariance of each consecutive pair of states of
    ``dist``, extended by the prior (``initial_mean`` [..., d],
    ``initial_covariance`` [..., d, d], independent of its neighbour) at
    both ends.  Returns (means [..., T+2, 2d], covs [..., T+2, 2d, 2d])."""
    means, covs = _pairwise_marginals_tl(dist, initial_mean, initial_covariance)
    return means[..., 0, :].movedim(-1, -2), covs.movedim(-1, -3)


def _conditional_statistics_tl(a1, q1, b1, a2, q2, b2):
    """Time-last statistics of p(x* | x-, x+) where x* = A1 x- + b1 +
    N(0, Q1) and x+ = A2 x* + b2 + N(0, Q2): (D, E, offset, T) with
    p(x* | x-, x+) = N(D x- + E x+ + offset, T); A, Q [..., d, d, N*],
    b [..., d, 1, N*]."""
    q1_inv = _inv_tl(_sym_tl(q1))
    q2_inv_a2 = _mm_tl(_inv_tl(_sym_tl(q2)), a2)
    t_inv = q1_inv + _mm_tl(_t_tl(a2), q2_inv_a2)
    t_cov = _sym_tl(_inv_tl(_sym_tl(t_inv)))
    tq1 = _mm_tl(t_cov, q1_inv)
    d_proj = _mm_tl(tq1, a1)                       # weight on x-
    e_proj = _mm_tl(t_cov, _t_tl(q2_inv_a2))       # weight on x+
    offset = _mm_tl(tq1, b1) - _mm_tl(e_proj, b2)
    return d_proj, e_proj, offset, t_cov


def _conditional_statistics_from_transitions(a1, q1, b1, a2, q2, b2):
    """The standard-layout statistics: A, Q [..., N*, d, d], b [..., N*, d].
    Returns (P [..., N*, d, 2d], offset [..., N*, d], T [..., N*, d, d])."""
    vec = lambda b: _to_tl(b[..., None])  # noqa: E731
    d_proj, e_proj, offset, t_cov = _conditional_statistics_tl(
        _to_tl(a1), _to_tl(q1), vec(b1), _to_tl(a2), _to_tl(q2), vec(b2))
    p_proj = torch.cat([d_proj, e_proj], dim=-2)
    return (p_proj.movedim(-1, -3), offset[..., 0, :].movedim(-1, -2),
            t_cov.movedim(-1, -3))


def _projections_tl(new_time_points, existing_time_points, kernel):
    """(P [..., d, 2d, N*], offset [..., d, 1, N*], T [..., d, d, N*],
    indices [..., N*]) of each new point against its neighbours among the
    existing points; ``indices[i]`` is the insertion index of new point i
    (0: before the first, whose left neighbour is the phantom prior)."""
    inf = torch.full_like(existing_time_points[..., :1], APPROX_INF)
    padded = torch.cat([-inf, existing_time_points, inf], dim=-1)
    indices = searchsorted(existing_time_points, new_time_points, side="left")
    t_minus = take_last(padded, indices)
    t_plus = take_last(padded, indices + 1)
    dt1 = torch.clamp(new_time_points - t_minus, 0.0, APPROX_INF)
    dt2 = torch.clamp(t_plus - new_time_points, 0.0, APPROX_INF)
    exact = dt2 <= 0.0
    dt2_safe = torch.where(exact, torch.ones_like(dt2), dt2)
    a1, q1 = kernel.transition_statistics(t_minus, dt1)
    a2, q2 = kernel.transition_statistics(new_time_points, dt2_safe)
    b1 = kernel.state_offsets(a1, dt1, transition_times=t_minus)
    b2 = kernel.state_offsets(a2, dt2_safe, transition_times=new_time_points)
    vec = lambda b: _to_tl(b[..., None])  # noqa: E731
    d_proj, e_proj, offset, t_cov = _conditional_statistics_tl(
        _to_tl(a1), _to_tl(q1), vec(b1), _to_tl(a2), _to_tl(q2), vec(b2))
    # exact hits (dt2 == 0): x* = x+
    ex = exact[..., None, None, :]
    zero = torch.zeros((), dtype=t_cov.dtype, device=t_cov.device)
    d_proj = torch.where(ex, zero, d_proj)
    e_proj = torch.where(ex, _eye_tl(t_cov.shape[-3], t_cov), e_proj)
    offset = torch.where(ex, zero, offset)
    t_cov = torch.where(ex, zero, t_cov)
    return torch.cat([d_proj, e_proj], dim=-2), offset, t_cov, indices


def conditional_statistics(new_time_points, existing_time_points, kernel):
    """(P [..., N*, d, 2d], offset [..., N*, d], T [..., N*, d, d],
    indices [..., N*]) for each new point against its existing neighbours;
    outside points use the -/+ APPROX_INF phantom neighbours."""
    p_tl, offset, t_cov, indices = _projections_tl(
        new_time_points, existing_time_points, kernel)
    return (p_tl.movedim(-1, -3), offset[..., 0, :].movedim(-1, -2),
            t_cov.movedim(-1, -3), indices)


def base_conditional_predict(conditional_projections, conditional_offsets,
                             conditional_covariances, adjacent_means,
                             pairwise_covariances=None):
    """Marginals p(x*) = N(P m + o, T + P S P^T), standard layout."""
    means = small_mv(conditional_projections, adjacent_means) + conditional_offsets
    covs = conditional_covariances
    if pairwise_covariances is not None:
        p = conditional_projections
        covs = covs + small_mm(small_mm(p, pairwise_covariances), p.transpose(-1, -2))
    return means, covs


def _prior_ends(kernel, existing_time_points):
    return (kernel.initial_mean(tuple(existing_time_points.shape[:-1])),
            kernel.initial_covariance(existing_time_points[..., :1]))


def conditional_predict(new_time_points, existing_time_points, kernel, dist):
    """Marginal means [..., N*, d] and covariances [..., N*, d, d] of the
    states at ``new_time_points`` given ``dist`` over the states at
    ``existing_time_points``, in the standard layout."""
    p_proj, offset, t_cov, indices = conditional_statistics(
        new_time_points, existing_time_points, kernel)
    pair_means, pair_covs = pairwise_marginals(
        dist, *_prior_ends(kernel, existing_time_points))
    adj_means = take_rows(pair_means, indices)
    adj_covs = take_rows(pair_covs.flatten(-2), indices).unflatten(-1, pair_covs.shape[-2:])
    return base_conditional_predict(p_proj, offset, t_cov, adj_means, adj_covs)


def conditional_predict_tl(new_time_points, existing_time_points, kernel, dist):
    """Time-last :func:`conditional_predict`: (means [..., d, 1, N*],
    covs [..., d, d, N*]).  The pair moments [..., 2d, *, T+2] are gathered
    along their (last) time axis."""
    p_tl, offset, t_cov, indices = _projections_tl(
        new_time_points, existing_time_points, kernel)
    pm_tl, pc_tl = _pairwise_marginals_tl(dist, *_prior_ends(kernel,
                                                             existing_time_points))
    idx = indices[..., None, None, :]
    adj_m = take_last(pm_tl, idx)                       # [..., 2d, 1, N*]
    adj_c = take_last(pc_tl, idx)                       # [..., 2d, 2d, N*]
    means = _mm_tl(p_tl, adj_m) + offset
    covs = t_cov + _mm_tl(p_tl, _mm_tl(adj_c, _t_tl(p_tl)))
    return means, covs
