"""Emission models: f = H x (counterpart of ``markovflow_tpu/emission_model.py``,
``EmissionModel`` and ``ComposedPairEmissionModel``).  The projections are
elementwise products summed over the state (no matmul, so no TF32 on the
card)."""
from __future__ import annotations

import torch

__all__ = ["EmissionModel", "ComposedPairEmissionModel", "time_constant"]


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


def time_constant(h: torch.Tensor) -> bool:
    """Whether the emission matrix ``h`` [..., N, o, d] is the same at every
    step: its time axis has stride 0 (an expanded view) or one step, or,
    failing that, every step equals step 0 (compared on ``h``'s device,
    one read back to the host)."""
    if h.shape[-3] <= 1 or h.stride(-3) == 0:
        return True
    return bool(torch.equal(h, h[..., :1, :, :].expand(h.shape)))


class ComposedPairEmissionModel(EmissionModel):
    """H = H_outer H_inner [..., N, o, d], with the projections to the
    intermediate space g = H_inner x (the latents of
    ``kernels.FactorAnalysisKernel``).  Where both factors are the same at
    every step (stride 0 along time) H is their product at one step,
    expanded, so that the filters see a constant emission."""

    def __init__(self, outer_emission: EmissionModel, inner_emission: EmissionModel):
        self.outer = outer_emission
        self.inner = inner_emission
        ho, hi = outer_emission.emission_matrix, inner_emission.emission_matrix
        lead = torch.broadcast_shapes(ho.shape[:-2], hi.shape[:-2])
        if ho.stride(-3) == 0 and hi.stride(-3) == 0:
            h = (ho[..., :1, :, :, None] * hi[..., :1, None, :, :]).sum(-2)
            h = h.expand(lead + h.shape[-2:])
        else:
            h = (ho[..., :, :, None] * hi[..., None, :, :]).sum(-2)
        super().__init__(h)

    def project_state_to_g(self, state: torch.Tensor) -> torch.Tensor:
        """[..., N, d] -> [..., N, n_latents]."""
        return self.inner.project_state_to_f(state)

    def project_state_covariance_to_g(self, covariance: torch.Tensor,
                                      full_output_cov: bool = False) -> torch.Tensor:
        """[..., N, d, d] -> [..., N, n_latents, n_latents], or its diagonal."""
        return self.inner.project_state_covariance_to_f(covariance, full_output_cov)
