"""SDE kernels discretised to time-last prior steps (counterpart of
``markovflow_tpu/kernels/sde_kernel.py``, the time-last methods only).

Every tensor is built in the dtype and on the device of the kernel's
parameters or of the time points it is given; nothing falls back to a
global default dtype.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from ..emission_model import EmissionModel
from ..utils.module import Parameter
from .kernel import Kernel

__all__ = ["SDEKernel", "StationaryKernel"]


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


class StationaryKernel(SDEKernel, abc.ABC):
    """Stationary kernels: fixed feedback matrix F and steady state P_inf,
    Q_k = P_inf - A_k P_inf A_k^T."""

    def __init__(self, output_dim: int = 1, jitter: float = 0.0, *,
                 dtype: torch.dtype, device=None):
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

    @abc.abstractmethod
    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        """A(dt) = expm(F dt) in time-last layout [..., d, d, N]."""

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
