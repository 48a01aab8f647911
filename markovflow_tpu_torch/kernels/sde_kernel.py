"""SDE kernels discretised to prior steps (counterpart of
``markovflow_tpu/kernels/sde_kernel.py``).

The time-last methods (``transition_statistics_tl``, ``prior_arrays_tl``,
``prior_const_tl``) feed the filters; the standard-layout ones
(``transition_statistics``, ``state_space_model``, ...) are views of the
same closed forms, for the state-space model, the conditionals and the
mean functions.

Every tensor is built in the dtype and on the device of the kernel's
parameters or of the time points it is given; nothing falls back to a
global default dtype.  A kernel's parameters live on the CUDA card unless
its constructor is given another ``device``; a :class:`Sum` holds no
parameters of its own and lives where its children do.
"""
from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..emission_model import EmissionModel
from ..state_space_model import StateSpaceModel
from ..utils.linalg import block_diag, cholesky_or_zero, small_mv, to_delta_time
from ..utils.module import Parameter
from .kernel import Kernel

__all__ = ["SDEKernel", "StationaryKernel", "ConcatKernel", "Sum"]


def _mat_vec_tl(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [..., d, d, N] times a constant vector m [..., d] -> [..., d, N]."""
    return (a * m[..., None, :, None]).sum(-2)


class SDEKernel(Kernel, abc.ABC):
    """Base for kernels that are LTI SDEs dx = F x dt + L dW."""

    def __init__(self, output_dim: int = 1, jitter: float = 0.0):
        super().__init__()
        self._output_dim = output_dim
        self._jitter = jitter

    @property
    def output_dim(self) -> int:
        return self._output_dim

    @property
    @abc.abstractmethod
    def state_dim(self) -> int:
        ...

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """H = [1 0 ... 0] per output at every time point, as an expanded
        view [..., N, o, d] in the time points' dtype and device."""
        n = time_points.shape[-1]
        h_row = torch.zeros(self.output_dim, self.state_dim,
                            dtype=time_points.dtype, device=time_points.device)
        h_row[:, 0] = 1.0
        shape = tuple(time_points.shape[:-1]) + (n, self.output_dim,
                                                 self.state_dim)
        return EmissionModel(h_row.expand(shape))

    def __add__(self, other: "SDEKernel") -> "Sum":
        return Sum([self, other])

    @abc.abstractmethod
    def transition_statistics(self, transition_times, time_deltas):
        """(A [..., N, d, d], Q [..., N, d, d]) of transitions that start at
        ``transition_times`` and last ``time_deltas`` [..., N]."""

    @abc.abstractmethod
    def initial_mean(self, batch_shape=()) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def initial_covariance(self, initial_time_point) -> torch.Tensor:
        """P0 at the first time point, [..., d, d]."""

    @abc.abstractmethod
    def state_offsets(self, state_transitions, time_deltas,
                      transition_times=None) -> torch.Tensor:
        """b [..., N, d] of the transitions."""

    def transition_statistics_from_time_points(self, time_points):
        return self.transition_statistics(time_points[..., :-1],
                                          to_delta_time(time_points))

    def state_space_model(self, time_points: torch.Tensor) -> StateSpaceModel:
        """The prior over the states at ``time_points`` [..., N]."""
        a_s, q_s = self.transition_statistics_from_time_points(time_points)
        b_s = self.state_offsets(a_s, to_delta_time(time_points),
                                 transition_times=time_points[..., :-1])
        mu0 = self.initial_mean(tuple(time_points.shape[:-1]))
        p0 = self.initial_covariance(time_points[..., :1])
        return StateSpaceModel(mu0, cholesky_or_zero(p0), a_s, b_s,
                               cholesky_or_zero(q_s))

    def build_finite_distribution(self, time_points: torch.Tensor) -> StateSpaceModel:
        return self.state_space_model(time_points)


class StationaryKernel(SDEKernel, abc.ABC):
    """Stationary kernels: fixed feedback matrix F and steady state P_inf,
    Q_k = P_inf - A_k P_inf A_k^T."""

    def __init__(self, output_dim: int = 1, jitter: float = 0.0, *,
                 dtype: torch.dtype, device="cuda"):
        super().__init__(output_dim, jitter)
        self._state_mean = Parameter(np.zeros((self.state_dim,)),
                                     trainable=False, dtype=dtype,
                                     device=device)

    @property
    def state_mean(self) -> torch.Tensor:
        return self._state_mean.value

    @property
    @abc.abstractmethod
    def steady_state_covariance(self) -> torch.Tensor:
        """P_inf [d, d]."""

    @property
    @abc.abstractmethod
    def feedback_matrix(self) -> torch.Tensor:
        """F in dx = F x dt + L dW, [d, d]."""

    @abc.abstractmethod
    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        """A(dt) = expm(F dt) in time-last layout [..., d, d, N]."""

    def state_transitions(self, time_deltas: torch.Tensor) -> torch.Tensor:
        """A(dt) [..., N, d, d]."""
        return self.state_transitions_tl(time_deltas).movedim(-1, -3)

    def transition_statistics(self, transition_times, time_deltas):
        """(A, Q) [..., N, d, d]: a view of :meth:`transition_statistics_tl`
        (the transition times do not matter to a stationary kernel)."""
        a, q = self.transition_statistics_tl(time_deltas)
        return a.movedim(-1, -3), q.movedim(-1, -3)

    def initial_mean(self, batch_shape=()) -> torch.Tensor:
        return self.state_mean.expand(tuple(batch_shape) + (self.state_dim,))

    def initial_covariance(self, initial_time_point) -> torch.Tensor:
        """P0 = P_inf + jitter I, [..., d, d] for the time point [..., 1]."""
        p0 = self._p0(self.state_mean.dtype)[..., 0]
        return p0.expand(tuple(initial_time_point.shape[:-1]) + p0.shape[-2:])

    def state_offsets(self, state_transitions, time_deltas,
                      transition_times=None) -> torch.Tensor:
        """b_k = (I - A_k) m, which keeps the stationary mean m."""
        m = self.state_mean
        return m - small_mv(state_transitions, m)

    def _p0(self, dtype) -> torch.Tensor:
        """P0 = P_inf + jitter I, [d, d, 1]."""
        eye = torch.eye(self.state_dim, dtype=dtype,
                        device=self.state_mean.device)
        return (self.steady_state_covariance + self._jitter * eye)[..., None]

    def transition_statistics_tl(self, time_deltas: torch.Tensor):
        """(A, Q) in time-last layout [..., d, d, N]."""
        a = self.state_transitions_tl(time_deltas)
        p = self.steady_state_covariance
        ap = (a[..., :, :, None, :] * p[..., None, :, :, None]).sum(-3)
        apa = (ap[..., :, None, :, :] * a[..., None, :, :, :]).sum(-2)
        q = p[..., None] - apa
        q = 0.5 * (q + q.transpose(-3, -2))
        if self._jitter:
            q = q + self._jitter * torch.eye(
                self.state_dim, dtype=q.dtype, device=q.device)[..., None]
        return a, q

    def prior_arrays_tl(self, time_points: torch.Tensor):
        """(F [..., d, d, N], c [..., d, 1, N], Q [..., d, d, N]) with
        element 0 encoding the initial distribution."""
        a, q = self.transition_statistics_tl(torch.diff(time_points, dim=-1))
        edge = a.shape[:-1] + (1,)
        f_tl = torch.cat([torch.zeros(edge, dtype=a.dtype, device=a.device),
                          a], dim=-1)
        q_tl = torch.cat([self._p0(a.dtype).expand(edge), q], dim=-1)
        m = self.state_mean
        b = m[..., None] - _mat_vec_tl(a, m)        # b_k = (I - A_k) m
        c0 = m[..., None].expand(b.shape[:-1] + (1,))
        c_tl = torch.cat([c0, b], dim=-1)[..., :, None, :]
        return f_tl, c_tl, q_tl

    def prior_const_tl(self, dt: torch.Tensor):
        """Constant prior steps for a UNIFORM grid with time delta ``dt``
        [..., 1]: every transition k >= 1 shares (Fc, cc, Qc) and element 0
        is the prior (mu0, P0).

        Returns (Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1],
        mu0 [..., d, 1, 1], P0 [..., d, d, 1]).
        """
        a, q = self.transition_statistics_tl(dt)
        d = self.state_dim
        m = self.state_mean
        cc = (m[..., None] - _mat_vec_tl(a, m))[..., :, None, :]
        mu0 = m[..., None, None].expand(m.shape[:-1] + (d, 1, 1))
        return a, cc, q, mu0, self._p0(a.dtype)


class ConcatKernel(StationaryKernel, abc.ABC):
    """State concatenation of stationary child kernels: block-diagonal A and
    P_inf, concatenated state mean.  The process noise is the generic
    Q = P_inf - A P_inf A^T of the whole state, not the children's own
    forms, as in the JAX package (it cancels in float32 at small steps)."""

    def __init__(self, kernels: Sequence[StationaryKernel], jitter: float = 0.0,
                 output_dim: Optional[int] = None):
        kernels = list(kernels)
        out = output_dim if output_dim is not None else kernels[0].output_dim
        SDEKernel.__init__(self, out, jitter)   # the state mean is the children's
        self.kernels = nn.ModuleList(kernels)

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.kernels)

    @property
    def state_mean(self) -> torch.Tensor:
        return torch.cat([k.state_mean for k in self.kernels], dim=-1)

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return block_diag([k.steady_state_covariance for k in self.kernels])

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return block_diag([k.feedback_matrix for k in self.kernels])

    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        blocks = [k.state_transitions_tl(time_deltas).movedim(-1, -3)
                  for k in self.kernels]
        return block_diag(blocks).movedim(-3, -1)


class Sum(ConcatKernel):
    """f = sum_i f_i: H is the horizontal concatenation of the children's."""

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """The children's rows side by side, as an expanded view
        [..., N, o, d] in the time points' dtype and device."""
        h = torch.cat([k.generate_emission_model(time_points).emission_matrix[..., :1, :, :]
                       for k in self.kernels], dim=-1)
        return EmissionModel(h.expand(h.shape[:-3] + time_points.shape[-1:] + h.shape[-2:]))
