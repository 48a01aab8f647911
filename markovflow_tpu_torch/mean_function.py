"""Mean functions (counterpart of ``markovflow_tpu/mean_function.py``).

A mean function maps time points [..., N] to means [..., N, obs_dim].  Its
arrays are buffers, not parameters: the JAX package does not train them
either.  The impulse and step responses' coefficient recursions run as
affine prefix scans (:func:`.ops.scans.affine_scan`).
"""
from __future__ import annotations

import abc

import torch
from torch import nn

from .ops.scans import affine_scan
from .utils.linalg import searchsorted, small_mv, take_last, take_rows, to_delta_time

__all__ = ["MeanFunction", "ZeroMeanFunction", "LinearMeanFunction",
           "ImpulseMeanFunction", "StepMeanFunction"]


def _before_first_is_zero(deltas, indices):
    """Time deltas with those before the first action time set to 0.  The
    state there is 0 whatever A(delta) is, but a delta far below 0 makes
    A overflow, and inf * 0 is NaN (the JAX package returns NaN there)."""
    return torch.where(indices == 0, torch.zeros_like(deltas), deltas)


def _transitions_between(kernel, times, u):
    """[..., M, d, d]: 0 at step 0, then A(t_k - t_{k-1})."""
    d = u.shape[-1]
    if times.shape[-1] > 1:
        a_s = kernel.state_transitions(to_delta_time(times))
        return torch.cat([torch.zeros_like(a_s[..., :1, :, :]), a_s], dim=-3)
    return u.new_zeros(u.shape[:-2] + (1, d, d))


class MeanFunction(nn.Module, abc.ABC):
    @abc.abstractmethod
    def forward(self, time_points: torch.Tensor) -> torch.Tensor:
        ...


class ZeroMeanFunction(MeanFunction):
    def __init__(self, obs_dim: int = 1):
        super().__init__()
        self.obs_dim = obs_dim

    def forward(self, time_points):
        return time_points.new_zeros(time_points.shape + (self.obs_dim,))


class LinearMeanFunction(MeanFunction):
    """mu(t) = coefficient * t."""

    def __init__(self, coefficient, obs_dim: int = 1, *, dtype: torch.dtype,
                 device="cuda"):
        super().__init__()
        self.register_buffer("coefficient",
                             torch.as_tensor(coefficient, dtype=dtype, device=device))
        self.obs_dim = obs_dim

    def forward(self, time_points):
        out = self.coefficient * time_points[..., None]
        return out.expand(time_points.shape + (self.obs_dim,))


class ImpulseMeanFunction(MeanFunction):
    """The mean response of the kernel's SDE to impulses u_k delta(t - t_k):
    mu(t) = exp(F (t - t_k)) a_k for t_k < t <= t_{k+1}, with
    a_k = A_k a_{k-1} + u_k and A_k = exp(F (t_k - t_{k-1}))."""

    def __init__(self, action_times, state_perturbations, kernel):
        """action_times [..., M], state_perturbations [..., M, d] (tensors in
        the kernel's dtype and on its device)."""
        super().__init__()
        self.register_buffer("action_times", action_times)
        self.register_buffer("state_perturbations", state_perturbations)
        self.kernel = kernel

    def _coefficients(self):
        """[..., M+1, d]: a_{-1} = 0 first."""
        u = self.state_perturbations
        a_k = affine_scan(_transitions_between(self.kernel, self.action_times, u), u)
        return torch.cat([torch.zeros_like(a_k[..., :1, :]), a_k], dim=-2)

    def forward(self, time_points):
        # the governing impulse; 0 = before the first one
        indices = searchsorted(self.action_times, time_points)
        padded = torch.cat([self.action_times[..., :1] - 1e-6, self.action_times],
                           dim=-1)
        deltas = _before_first_is_zero(time_points - take_last(padded, indices),
                                       indices)
        a_k = take_rows(self._coefficients(), indices)
        state_mean = small_mv(self.kernel.state_transitions(deltas), a_k)
        em = self.kernel.generate_emission_model(time_points)
        return em.project_state_to_f(state_mean)


class StepMeanFunction(MeanFunction):
    """The mean response to a piecewise-constant input u(t) = u_k on
    (t_k, t_{k+1}]: mu(t) = a_k + exp(F (t - t_k)) b_k, with a_k = -F^-1 u_k
    and b_k = A_k b_{k-1} + a_{k-1} - a_k."""

    def __init__(self, action_times, state_perturbations, kernel):
        super().__init__()
        self.register_buffer("action_times", action_times)
        self.register_buffer("state_perturbations", state_perturbations)
        self.kernel = kernel

    def _coefficients(self):
        u = self.state_perturbations
        f_mat = self.kernel.feedback_matrix
        # F broadcast over the M steps: [..., M, d, d] (the JAX package
        # broadcasts it to [..., M, d], which fails unless M == d or d == 1)
        f_inv_u = torch.linalg.solve(f_mat.expand(u.shape[:-1] + f_mat.shape[-2:]),
                                     u[..., None])[..., 0]
        a_k = torch.cat([torch.zeros_like(f_inv_u[..., :1, :]), -f_inv_u], dim=-2)
        a_diff = a_k[..., :-1, :] - a_k[..., 1:, :]
        b_k = affine_scan(_transitions_between(self.kernel, self.action_times, u),
                          a_diff)
        return a_k, torch.cat([torch.zeros_like(b_k[..., :1, :]), b_k], dim=-2)

    def forward(self, time_points):
        indices = searchsorted(self.action_times, time_points)
        padded = torch.cat([self.action_times[..., :1], self.action_times], dim=-1)
        deltas = _before_first_is_zero(time_points - take_last(padded, indices),
                                       indices)
        a_all, b_all = self._coefficients()
        a_k, b_k = take_rows(a_all, indices), take_rows(b_all, indices)
        state_mean = a_k + small_mv(self.kernel.state_transitions(deltas), b_k)
        em = self.kernel.generate_emission_model(time_points)
        return em.project_state_to_f(state_mean)
