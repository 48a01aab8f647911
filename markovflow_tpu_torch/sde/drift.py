"""Linear drift and state-space model conversions (counterpart of
``markovflow_tpu/sde/drift.py``)."""
from __future__ import annotations

import torch

from ..state_space_model import StateSpaceModel

__all__ = ["LinearDrift"]


class LinearDrift:
    """f(x, t) = A_t x + b_t with A [..., N, d, d] and b [..., N, d].  The
    conversions return new objects."""

    def __init__(self, A=None, b=None):
        self.A = A
        self.b = b

    @classmethod
    def from_ssm(cls, ssm: StateSpaceModel, dt: float) -> "LinearDrift":
        """The first-order inverse of the discretisation:
        A = (A_ssm - I) / dt, b = b_ssm / dt."""
        eye = torch.eye(ssm.state_dim, dtype=ssm.dtype, device=ssm.device)
        return cls(A=(ssm.state_transitions - eye) / dt, b=ssm.state_offsets / dt)

    def to_ssm(self, q, transition_times, initial_mean,
               initial_chol_covariance) -> StateSpaceModel:
        """The first-order discretisation on ``transition_times`` [N + 1]:
        A_ssm = I + A dt, b_ssm = b dt, chol Q = q sqrt(dt), with q
        [..., N, d, d] the diffusion's Cholesky factor."""
        if self.A is None or self.b is None:
            raise ValueError("LinearDrift is empty; cannot build an SSM")
        deltas = torch.diff(transition_times, dim=-1)[..., :, None]
        eye = torch.eye(self.A.shape[-1], dtype=self.A.dtype, device=self.A.device)
        return StateSpaceModel(
            initial_mean, initial_chol_covariance, self.A * deltas[..., None] + eye,
            self.b * deltas, q * torch.sqrt(deltas[..., None]))
