"""Uniform-grid log marginal likelihood (counterpart of
``markovflow_tpu/ops/adjoint.py::log_likelihood_koopman_uniform``, forward
only).

The JAX package differentiates this likelihood with the analytic Koopman
score, computed on the TPU by ``pallas_adjoint_pipeline_uniform``.  That
backward kernel is not ported yet: on CUDA tensors the forward runs the
filter kernel inside an ``autograd.Function`` whose backward raises.  On CPU
tensors the plain path stays differentiable by autograd.  The plain
expansion of the constant steps, ``_materialize_uniform``, lives in
:mod:`markovflow_tpu_torch.ops.kalman` beside the pipelines that use it.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda_scan import filter_pipeline_uniform

__all__ = ["log_likelihood_koopman_uniform"]


class _KoopmanUniform(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf):
        return filter_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                       maskf)[2]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "gradients of the uniform-grid log-likelihood on CUDA need the "
            "Koopman backward kernel (the port of pallas_adjoint_pipeline_uniform), "
            "which is not ported yet")


def log_likelihood_koopman_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                   mask: Optional[torch.Tensor] = None):
    """Site-form log marginal likelihood on a uniform grid from CONSTANT prior
    steps: Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1] for every
    k >= 1, the prior mu0 [..., d, 1, 1], P0 [..., d, d, 1] at step 0, a
    constant emission Hc [..., o, d, 1]; per-step sites nu [..., o, 1, N],
    lam [..., o, o, N] and an optional boolean mask [..., N].  No [d, d, N]
    array is materialised on CUDA.  Returns loglik [...]."""
    n = nu.shape[-1]
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in
                                    (Fc, cc, Qc, mu0, P0, Hc, nu, lam)))
    o = lam.shape[-3]
    nu = nu.expand(lead + (o, 1, n))
    lam = lam.expand(lead + (o, o, n))
    maskf = None
    if mask is not None:
        maskf = mask.expand(lead + (n,)).to(nu.dtype)[..., None, None, :]
    if nu.is_cuda:
        return _KoopmanUniform.apply(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf)
    return filter_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf)[2]
