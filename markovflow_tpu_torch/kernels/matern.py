"""Matern-family kernels (counterpart of ``markovflow_tpu/kernels/matern.py``,
time-last methods only).

A(dt) = expm(F dt) is expanded in closed form, and the process noise of
Matern12 and Matern32 keeps the JAX package's stable forms: the generic
P_inf - A P_inf A^T cancels catastrophically in float32 for small steps.
"""
from __future__ import annotations

import torch

from ..utils.bijectors import positive
from ..utils.module import Parameter
from .sde_kernel import StationaryKernel

__all__ = ["Matern12", "Matern32", "Matern52"]

SQRT3 = 1.7320508075688772
SQRT5 = 2.23606797749979


class _Matern(StationaryKernel):
    def __init__(self, lengthscale: float = 1.0, variance: float = 1.0,
                 output_dim: int = 1, jitter: float = 0.0, *,
                 dtype: torch.dtype, device="cuda"):
        super().__init__(output_dim, jitter, dtype=dtype, device=device)
        self.lengthscale = Parameter(lengthscale, transform=positive(),
                                     dtype=dtype, device=device)
        self.variance = Parameter(variance, transform=positive(),
                                  dtype=dtype, device=device)


class Matern12(_Matern):
    """k(r) = sigma^2 exp(-r / ell); state dim 1, A(dt) = exp(-dt / ell)."""

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def steady_state_covariance(self):
        return self.variance.value[..., None, None]

    def state_transitions_tl(self, time_deltas):
        return torch.exp(-time_deltas / self.lengthscale.value)[..., None, None, :]

    def transition_statistics_tl(self, time_deltas):
        """Q = -sigma^2 expm1(-2 dt / ell), stable for small dt."""
        a = self.state_transitions_tl(time_deltas)
        q = -self.variance.value * torch.expm1(
            -2.0 * time_deltas / self.lengthscale.value)
        return a, q[..., None, None, :] + self._jitter


class Matern32(_Matern):
    """k(r) = sigma^2 (1 + lam r) exp(-lam r), lam = sqrt(3) / ell;
    state (f, f'), A(dt) = exp(-lam dt) (I + (lam I + F) dt)."""

    @property
    def state_dim(self) -> int:
        return 2

    @property
    def _lambda(self):
        return SQRT3 / self.lengthscale.value

    @property
    def steady_state_covariance(self):
        lam = self._lambda
        var = self.variance.value
        z = torch.zeros_like(lam)
        return torch.stack([torch.stack([var, z], -1),
                            torch.stack([z, var * lam**2], -1)], -2)

    def _a_entries(self, dt):
        lam = self._lambda
        decay = torch.exp(-lam * dt)
        return (decay * (1.0 + lam * dt), decay * dt,
                decay * (-(lam**2) * dt), decay * (1.0 - lam * dt))

    def _q_entries(self, dt):
        """a = lam dt, e2 = exp(-2a):
        Q11 = sigma^2 (1 - e2 (1 + 2a + 2a^2)), Q12 = sigma^2 lam 2a^2 e2,
        Q22 = sigma^2 lam^2 (1 - e2 (1 - 2a + 2a^2)).  Q11 ~ (4/3) a^3 for
        small a, so a series takes over below a dtype-dependent cutoff."""
        lam = self._lambda
        var = self.variance.value
        a = lam * dt
        e2 = torch.exp(-2.0 * a)
        q11_direct = 1.0 - e2 * (1.0 + 2.0 * a + 2.0 * a**2)
        q11_series = a**3 * (4.0 / 3.0 + a * (-2.0 + a * (
            8.0 / 5.0 + a * (-8.0 / 9.0 + a * (
                8.0 / 21.0 + a * (-2.0 / 15.0))))))
        cutoff = 0.02 if a.dtype == torch.float64 else 0.2
        q11 = torch.where(a < cutoff, q11_series, q11_direct)
        q12 = 2.0 * a**2 * e2
        q22 = 1.0 - e2 * (1.0 - 2.0 * a + 2.0 * a**2)
        return var * q11, var * lam * q12, var * lam**2 * q22

    def state_transitions_tl(self, time_deltas):
        a00, a01, a10, a11 = self._a_entries(time_deltas)
        return torch.stack([torch.stack([a00, a01], -2),
                            torch.stack([a10, a11], -2)], -3)

    def transition_statistics_tl(self, time_deltas):
        a_tl = self.state_transitions_tl(time_deltas)
        q11, q12, q22 = self._q_entries(time_deltas)
        q_tl = torch.stack([torch.stack([q11, q12], -2),
                            torch.stack([q12, q22], -2)], -3)
        if self._jitter:
            q_tl = q_tl + self._jitter * torch.eye(
                2, dtype=q_tl.dtype, device=q_tl.device)[..., None]
        return a_tl, q_tl


class Matern52(_Matern):
    """k(r) = sigma^2 (1 + lam r + lam^2 r^2 / 3) exp(-lam r),
    lam = sqrt(5) / ell; state (f, f', f'')."""

    @property
    def state_dim(self) -> int:
        return 3

    @property
    def _lambda(self):
        return SQRT5 / self.lengthscale.value

    @property
    def steady_state_covariance(self):
        lam = self._lambda
        var = self.variance.value
        z = torch.zeros_like(lam)
        k2 = var * lam**2 / 3.0
        return torch.stack([
            torch.stack([var, z, -k2], -1),
            torch.stack([z, k2, z], -1),
            torch.stack([-k2, z, var * lam**4], -1),
        ], -2)

    def state_transitions_tl(self, time_deltas):
        lam = self._lambda
        dt = time_deltas
        decay = torch.exp(-lam * dt)
        l2, l3 = lam**2, lam**3
        dt2 = dt**2
        rows = [
            [decay * (1.0 + lam * dt + 0.5 * l2 * dt2),
             decay * (dt + lam * dt2),
             decay * 0.5 * dt2],
            [decay * (-0.5 * l3 * dt2),
             decay * (1.0 + lam * dt - l2 * dt2),
             decay * (dt - 0.5 * lam * dt2)],
            [decay * (l3 * dt * (0.5 * lam * dt - 1.0)),
             decay * (l2 * dt * (lam * dt - 3.0)),
             decay * (1.0 - 2.0 * lam * dt + 0.5 * l2 * dt2)],
        ]
        return torch.stack([torch.stack(r, -2) for r in rows], -3)
