"""Log marginal likelihood with the analytic Koopman score as its gradient
(counterpart of ``markovflow_tpu/ops/adjoint.py``).

The gradient of the site-form log-likelihood is the prediction-error /
disturbance-smoother score (Koopman 1992; Durbin & Koopman 7.3.3): one
reverse scan with the smoothing composition over the elements
(E = L^T, g = H^T e, ell = H^T S^-1 H), then closed-form gradients.  The
derivation is in the JAX module's docstring.

* :func:`log_likelihood_koopman_uniform` (uniform grid, constant prior
  steps): for d <= 6 the forward is the uniform filter kernel, the backward
  the port of ``pallas_adjoint_pipeline_uniform``
  (:func:`adjoint_pipeline_uniform`), which sums the constant inputs'
  gradients on the device; for d > 6 the prior steps are materialised and
  take the general route below, as in the JAX package.
* :func:`log_likelihood_koopman` (any grid, per-step prior steps): the
  forward is the general filter kernel; the backward is the port of
  ``pallas_adjoint_pipeline`` (:func:`adjoint_pipeline`), which builds the
  elements (stage 1), scans them and assembles the per-step gradients
  (stage 2) in one kernel.  The JAX package keeps the split form (XLA
  stages around ``pallas_smoother_scan``), which the plain version
  :func:`adjoint_pipeline_plain` computes.

Both are ``torch.autograd.Function``s on every device: CPU tensors run the
plain forward and backward, as the JAX ``custom_vjp`` does on every backend.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_scan as cs
from .kalman import (_cat, _eye_tl, _inv_tl, _materialize_uniform, _mm_tl,
                     _no_tf32, _sym_tl, _t_tl, smoother_scan_tl)

__all__ = ["log_likelihood_koopman_uniform", "log_likelihood_koopman",
           "adjoint_pipeline_uniform", "adjoint_pipeline_uniform_plain",
           "adjoint_pipeline", "adjoint_pipeline_plain",
           "adjoint_scan_elements", "adjoint_grads_from_scan",
           "UNIFORM_ADJOINT_MAX_STATE_DIM"]


# ---------------------------------------------------------------------------
# Plain stages (time-last, elementwise products: no matmul, no TF32)
# ---------------------------------------------------------------------------
def adjoint_scan_elements(F, c, Q, H, nu, lam, m_prev, p_prev, f_next):
    """Stage 1: predicted moments and the reverse-scan elements.

    ``m_prev``/``p_prev`` are the filtered moments shifted right by one
    (zeros at step 0); ``f_next`` is F shifted left by one (zeros at the
    last step).  Returns (a, pp, e, l_mat, g_elem, v_elem)."""
    mm, t = _mm_tl, _t_tl
    d, o = F.shape[-3], lam.shape[-3]
    a = mm(F, m_prev) + c                           # a_0 = c_0 (F_0 = 0)
    pp = _sym_tl(mm(F, mm(p_prev, t(F))) + Q)       # Pp_0 = Q_0
    hpht = mm(H, mm(pp, t(H)))                      # [o, o, N]
    zt = _inv_tl(_eye_tl(o, F) + mm(lam, hpht))     # (I + Lam H Pp H^T)^-1
    w = _sym_tl(mm(zt, lam))                        # S^-1
    e = mm(zt, nu - mm(lam, mm(H, a)))              # [o, 1, N]
    kh = mm(pp, mm(t(H), mm(w, H)))                 # K H
    l_mat = mm(f_next, _eye_tl(d, F) - kh)          # L_k = F_{k+1} (I - K H)
    g_elem = mm(t(H), e)                            # H^T e
    v_elem = _sym_tl(mm(t(H), mm(w, H)))            # H^T S^-1 H
    return a, pp, e, l_mat, g_elem, v_elem


def adjoint_grads_from_scan(F, c, Q, H, nu, lam, maskf, m_prev, p_prev,
                            a, pp, r, ndk):
    """Stage 2: the six gradients (F, c, Q, H, nu, lam) from the adjoint
    scan's results r [..., d, 1, N] and NDK [..., d, d, N]; ``maskf`` is a
    float mask [..., N] (masked steps get zero observation gradients)."""
    mm, t = _mm_tl, _t_tl
    o = lam.shape[-3]
    n_mat = 0.5 * (mm(r, t(r)) - ndk)               # dL/dPp_k
    g_q = n_mat
    g_c = r
    g_f = mm(r, t(m_prev)) + 2.0 * mm(n_mat, mm(F, p_prev))
    # observation-side gradients through the smoothed moments
    m_s = a + mm(pp, r)
    p_s = _sym_tl(pp - mm(pp, mm(ndk, pp)))
    keep = maskf[..., None, None, :] > 0.5
    lam_safe = torch.where(keep, lam, _eye_tl(o, F))
    lam_inv = _inv_tl(lam_safe)
    y = mm(lam_inv, nu)
    a_k = p_s + mm(m_s, t(m_s))
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    g_nu = torch.where(keep, mm(H, m_s) - y, zero)
    g_lam = torch.where(
        keep, 0.5 * (mm(y, t(y)) - mm(H, mm(a_k, t(H))) + lam_inv), zero)
    g_h = torch.where(keep, mm(nu, t(m_s)) - mm(lam, mm(H, a_k)), zero)
    return g_f, g_c, g_q, g_h, g_nu, g_lam


def _adjoint_grads(F, c, Q, H, nu, lam, maskf, m_f, p_f):
    """All six gradients from the saved filter results, through the plain
    reverse scan."""
    def zpad(x):
        return _cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    m_prev, p_prev = zpad(m_f), zpad(p_f)           # (m, P)_{k-1}, 0 at k = 0
    f_next = _cat([F[..., 1:], torch.zeros_like(F[..., :1])], dim=-1)
    a, pp, _, l_mat, g_elem, v_elem = adjoint_scan_elements(
        F, c, Q, H, nu, lam, m_prev, p_prev, f_next)
    r, ndk = smoother_scan_tl(_t_tl(l_mat), g_elem, v_elem)
    return adjoint_grads_from_scan(F, c, Q, H, nu, lam, maskf, m_prev, p_prev,
                                   a, pp, r, ndk)


# ---------------------------------------------------------------------------
# Kernel 3: the uniform-grid Koopman backward
# ---------------------------------------------------------------------------
#: the state dims of the uniform backward kernel, as the JAX package routes
#: it (``_uniform_engine``); a larger d takes the materialised general route
UNIFORM_ADJOINT_MAX_STATE_DIM = 6


def adjoint_pipeline_uniform_plain(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf,
                                   m_f, p_f, gscale):
    """Plain PyTorch version of :func:`adjoint_pipeline_uniform`: the
    materialised prior steps through the plain stages and the plain reverse
    scan, then the broadcast sums (JAX ``ops/adjoint.py:244-258``)."""
    _no_tf32(Fc)
    n = nu.shape[-1]
    F, c, Q, H = _materialize_uniform(Fc, cc, Qc, mu0, P0, Hc, n)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in
                                    (F, c, Q, H, nu, lam, m_f)))
    if maskf is None:
        mk = torch.ones(lead + (n,), dtype=nu.dtype, device=nu.device)
    else:
        mk = maskf[..., 0, 0, :]
    g_f, g_c, g_q, g_h, g_nu, g_lam = _adjoint_grads(
        F, c, Q, H, nu, lam, mk, m_f, p_f)
    gg = torch.as_tensor(gscale, dtype=nu.dtype,
                         device=nu.device)[..., None, None, None]

    def red(x):
        return (gg * x).sum(-1, keepdim=True)
    return (red(g_f[..., 1:]), red(g_c[..., 1:]), red(g_q[..., 1:]),
            gg * g_c[..., :1], gg * g_q[..., :1], red(g_h),
            gg * g_nu, gg * g_lam)


def adjoint_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf, m_f,
                             p_f, gscale, site_grads: bool = True,
                             hc_grad: bool = True):
    """Koopman backward on a uniform grid (the port of
    ``pallas_adjoint_pipeline_uniform``).

    Inputs as :func:`ops.cuda_scan.filter_pipeline_uniform`, plus its
    outputs m_f [..., d, 1, N], P_f [..., d, d, N] and the per-row
    cotangent ``gscale`` [...].  Returns (gFc, gcc, gQc, gmu0, gP0, gHc,
    gnu, glam), all scaled by ``gscale``: the constant inputs' gradients are
    sums over their steps (k >= 1 for Fc, cc, Qc; step 0 for mu0, P0; all
    steps for Hc), shaped [..., d1, d2, 1]; gnu [..., o, 1, N] and
    glam [..., o, o, N] are per step.  With ``site_grads=False`` a call
    returns None for gnu and glam, with ``hc_grad=False`` None for gHc: a
    CUDA call does not compute them (at o = 1 it sums gHc all the same).
    """
    if nu.device.type == "cpu":
        out = adjoint_pipeline_uniform_plain(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                             maskf, m_f, p_f, gscale)
        return (out[:5] + (out[5] if hc_grad else None,)
                + (out[6:] if site_grads else (None, None)))
    if nu.device.type != "cuda":
        raise ValueError(f"no kernel for device {nu.device}")
    d, o, n = Fc.shape[-3], lam.shape[-3], nu.shape[-1]
    inputs = [Fc, cc, Qc, mu0, P0, Hc, nu, lam, m_f, p_f]
    if maskf is not None:
        inputs.append(maskf)
    sfx = cs._check_cuda(inputs + [gscale], d, o, UNIFORM_ADJOINT_MAX_STATE_DIM)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in inputs),
                                  gscale.shape)
    B = math.prod(lead)
    cs._check_grid(B, n)
    consts = cs._flat_consts(
        lead, B, (Fc, (d, d, 1)), (cc, (d, 1, 1)), (Qc, (d, d, 1)),
        (mu0, (d, 1, 1)), (P0, (d, d, 1)), (Hc, (o, d, 1)))
    sites, site_strides = cs._site_views(lead, B, o, n, nu, lam, maskf)
    m_b = m_f.expand(lead + (d, 1, n)).reshape(B, d, 1, n).contiguous()
    p_b = p_f.expand(lead + (d, d, n)).reshape(B, d, d, n).contiguous()
    gs = gscale.expand(lead).reshape(B).contiguous()
    kw = dict(dtype=nu.dtype, device=nu.device)
    gnu = torch.empty((B, o, 1, n), **kw) if site_grads else None
    glam = torch.empty((B, o, o, n), **kw) if site_grads else None
    gm0 = torch.empty((B, d, 1, 1), **kw)
    gp0 = torch.empty((B, d, d, 1), **kw)
    # the summed gradients, one row per series: Fc, cc, Qc, Hc
    gsums = torch.empty((B, 2 * d * d + d + o * d), **kw)
    scratch = cs._scratch("adjoint", sfx, (d, o, int(hc_grad or site_grads)), B, n, nu)
    with torch.cuda.device(nu.device):
        err = getattr(cs.build_kernels(), f"mf_uniform_adjoint_{sfx}")(
            *(x.data_ptr() for x in consts), *sites,
            cs._strides(*site_strides), m_b.data_ptr(), p_b.data_ptr(),
            gs.data_ptr(), None if gnu is None else gnu.data_ptr(),
            None if glam is None else glam.data_ptr(), gm0.data_ptr(),
            gp0.data_ptr(), gsums.data_ptr(), int(hc_grad), scratch.data_ptr(),
            B, n, d, o, cs._stream(nu.device))
    cs._raise_on(err, "adjoint_pipeline_uniform")
    adjoint_pipeline_uniform.launches += 1
    gfc, gcc, gqc, ghc = torch.split(gsums, [d * d, d, d * d, o * d], dim=1)
    out = (gfc.reshape(lead + (d, d, 1)), gcc.reshape(lead + (d, 1, 1)),
           gqc.reshape(lead + (d, d, 1)), gm0.reshape(lead + (d, 1, 1)),
           gp0.reshape(lead + (d, d, 1)),
           ghc.reshape(lead + (o, d, 1)) if hc_grad else None)
    if not site_grads:
        return out + (None, None)
    return out + (gnu.reshape(lead + (o, 1, n)), glam.reshape(lead + (o, o, n)))


adjoint_pipeline_uniform.launches = 0


# ---------------------------------------------------------------------------
# Kernel 7: the general-grid Koopman backward
# ---------------------------------------------------------------------------
def adjoint_pipeline_plain(F, c, Q, H, nu, lam, maskf, m_f, p_f, gscale):
    """Plain PyTorch version of :func:`adjoint_pipeline`: the plain stages
    around the plain reverse scan (the JAX package's split form,
    ``ops/adjoint.py:123-143``), scaled by ``gscale``.  Returns all six
    gradients."""
    _no_tf32(F)
    n = F.shape[-1]
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in
                                    (F, c, Q, H, nu, lam, m_f)),
                                  torch.as_tensor(gscale).shape)
    mk = (torch.ones(lead + (n,), dtype=F.dtype, device=F.device)
          if maskf is None else maskf[..., 0, 0, :])
    gg = torch.as_tensor(gscale, dtype=F.dtype,
                         device=F.device)[..., None, None, None]
    return tuple(gg * g for g in
                 _adjoint_grads(F, c, Q, H, nu, lam, mk, m_f, p_f))


def adjoint_pipeline(F, c, Q, H, nu, lam, maskf, m_f, p_f, gscale,
                     needs=(True,) * 6):
    """Koopman backward for per-step prior steps on any grid (the port of
    ``pallas_adjoint_pipeline``).

    Inputs as :func:`ops.cuda_scan.filter_pipeline` (any strides), plus its
    outputs m_f [..., d, 1, N], P_f [..., d, d, N] and the per-row cotangent
    ``gscale`` [...].  Returns the per-step gradients (gF [..., d, d, N],
    gc [..., d, 1, N], gQ [..., d, d, N], gH [..., o, d, N],
    gnu [..., o, 1, N], glam [..., o, o, N]), scaled by ``gscale``; masked
    steps (maskf <= 0.5) get zero gH, gnu and glam.  A CUDA call writes only
    the gradients whose entry of ``needs`` is true and returns None for the
    others; a CPU call returns all six.
    """
    if F.device.type == "cpu":
        return adjoint_pipeline_plain(F, c, Q, H, nu, lam, maskf, m_f, p_f,
                                      gscale)
    if F.device.type != "cuda":
        raise ValueError(f"no kernel for device {F.device}")
    d, o, n = F.shape[-3], lam.shape[-3], F.shape[-1]
    inputs = [F, c, Q, H, nu, lam, m_f, p_f]
    if maskf is not None:
        inputs.append(maskf)
    sfx = cs._check_cuda(inputs + [gscale], d, o)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in inputs),
                                  gscale.shape)
    B = math.prod(lead)
    cs._check_grid(B, n)
    ptrs, strides = cs._general_views(lead, B, F, c, Q, H, nu, lam, maskf)
    m_b = m_f.expand(lead + (d, 1, n)).reshape(B, d, 1, n).contiguous()
    p_b = p_f.expand(lead + (d, d, n)).reshape(B, d, d, n).contiguous()
    gs = gscale.expand(lead).reshape(B).contiguous()
    kw = dict(dtype=F.dtype, device=F.device)
    shapes = ((d, d, n), (d, 1, n), (d, d, n), (o, d, n), (o, 1, n), (o, o, n))
    grads = [torch.empty((B,) + shape, **kw) if need else None
             for shape, need in zip(shapes, needs)]
    scratch = cs._scratch("general_adjoint", sfx, (d, o, int(any(needs[3:]))), B, n, F)
    with torch.cuda.device(F.device):
        err = getattr(cs.build_kernels(), f"mf_general_adjoint_{sfx}")(
            *ptrs, strides, m_b.data_ptr(), p_b.data_ptr(), gs.data_ptr(),
            *(None if g is None else g.data_ptr() for g in grads),
            scratch.data_ptr(), B, n, d, o, cs._stream(F.device))
    cs._raise_on(err, "adjoint_pipeline")
    adjoint_pipeline.launches += 1
    return tuple(None if g is None else g.reshape(lead + shape)
                 for g, shape in zip(grads, shapes))


adjoint_pipeline.launches = 0


# ---------------------------------------------------------------------------
# The likelihoods
# ---------------------------------------------------------------------------
def _reduce_to(grad, like):
    """The gradient of a broadcast input: summed over the broadcast axes."""
    return None if grad is None else grad.sum_to_size(like.shape)


class _KoopmanUniform(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf):
        m_f, p_f, ll = cs.filter_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu,
                                                  lam, maskf)
        ctx.save_for_backward(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf, m_f, p_f)
        return ll

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad
        if not any(needs[:8]):
            return (None,) * 9
        inputs = ctx.saved_tensors
        grads = adjoint_pipeline_uniform(*inputs, grad,
                                         site_grads=needs[6] or needs[7],
                                         hc_grad=needs[5])
        return tuple(_reduce_to(g, x) if need else None
                     for g, x, need in zip(grads, inputs, needs)) + (None,)


class _Koopman(torch.autograd.Function):
    @staticmethod
    def forward(ctx, F, c, Q, H, nu, lam, maskf):
        m_f, p_f, ll = cs.filter_pipeline(F, c, Q, H, nu, lam, maskf)
        ctx.save_for_backward(F, c, Q, H, nu, lam, maskf, m_f, p_f)
        return ll

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad
        if not any(needs[:6]):
            return (None,) * 7
        inputs = ctx.saved_tensors
        grads = adjoint_pipeline(*inputs, grad, needs=needs[:6])
        return tuple(_reduce_to(g, x) if need else None
                     for g, x, need in zip(grads, inputs, needs)) + (None,)


def _float_mask(mask, lead, n, dtype):
    if mask is None:
        return None
    return mask.expand(lead + (n,)).to(dtype)[..., None, None, :]


def log_likelihood_koopman_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                   mask: Optional[torch.Tensor] = None):
    """Site-form log marginal likelihood on a uniform grid from CONSTANT prior
    steps: Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1] for every
    k >= 1, the prior mu0 [..., d, 1, 1], P0 [..., d, d, 1] at step 0, a
    constant emission Hc [..., o, d, 1]; per-step sites nu [..., o, 1, N],
    lam [..., o, o, N] and an optional boolean mask [..., N].  Its gradient
    is the Koopman score.  Up to state dim
    :data:`UNIFORM_ADJOINT_MAX_STATE_DIM` no [d, d, N] array is materialised
    on CUDA; above it, as in the JAX package, the prior steps are
    materialised and take :func:`log_likelihood_koopman` (the general filter
    and general backward kernels), whose per-step gradients autograd sums
    back onto the constants.  Returns loglik [...]."""
    n = nu.shape[-1]
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in
                                    (Fc, cc, Qc, mu0, P0, Hc, nu, lam)))
    o = lam.shape[-3]
    nu = nu.expand(lead + (o, 1, n))
    lam = lam.expand(lead + (o, o, n))
    maskf = _float_mask(mask, lead, n, nu.dtype)
    if Fc.shape[-3] > UNIFORM_ADJOINT_MAX_STATE_DIM:
        if o > 1 and nu.device.type == "cuda":
            raise NotImplementedError(
                f"o = {o} at state dim {Fc.shape[-3]}: the CUDA kernels take "
                f"o > 1 only at state dims 1..{cs.MULTI_OUTPUT_MAX_STATE_DIM}")
        F, c, Q, H = _materialize_uniform(Fc, cc, Qc, mu0, P0, Hc, n)
        return _Koopman.apply(F, c, Q, H, nu, lam, maskf)
    return _KoopmanUniform.apply(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf)


def log_likelihood_koopman(F, c, Q, H, nu, lam,
                           mask: Optional[torch.Tensor] = None):
    """Site-form log marginal likelihood for any grid, from per-step prior
    steps F [..., d, d, N], c [..., d, 1, N], Q [..., d, d, N] (step 0 is
    the prior), emission H [..., o, d, N] and sites nu [..., o, 1, N],
    lam [..., o, o, N], with an optional boolean mask [..., N].  Its
    gradient is the Koopman score (one reverse scan, gain form only).
    Returns loglik [...]."""
    n = F.shape[-1]
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in
                                    (F, c, Q, H, nu, lam)))
    return _Koopman.apply(F, c, Q, H, nu, lam,
                          _float_mask(mask, lead, n, F.dtype))
