"""Emission models: f = H x (counterpart of ``markovflow_tpu/emission_model.py``,
``EmissionModel``).  The projections are elementwise products summed over
the state (no matmul, so no TF32 on the card)."""
from __future__ import annotations

import torch

__all__ = ["EmissionModel"]


class EmissionModel:
    """Linear emission f = H x; ``emission_matrix`` is [..., N, o, d]
    (an expanded view when H is the same at every step)."""

    def __init__(self, emission_matrix: torch.Tensor):
        self.emission_matrix = emission_matrix

    def project_state_to_f(self, state: torch.Tensor) -> torch.Tensor:
        """[..., N, d] -> [..., N, o]."""
        return (self.emission_matrix * state[..., None, :]).sum(-1)

    def project_state_covariance_to_f(self, covariance: torch.Tensor,
                                      full_output_cov: bool = False) -> torch.Tensor:
        """[..., N, d, d] -> [..., N, o, o], or its diagonal [..., N, o]."""
        h = self.emission_matrix
        hp = (h[..., :, :, None] * covariance[..., None, :, :]).sum(-2)   # H P
        if full_output_cov:
            return (hp[..., :, None, :] * h[..., None, :, :]).sum(-1)
        return (hp * h).sum(-1)

    def project_state_marginals_to_f(self, means, covariances,
                                     full_output_cov: bool = False):
        return (self.project_state_to_f(means),
                self.project_state_covariance_to_f(covariances, full_output_cov))
