"""Parallel-in-time Kalman filter and smoother in time-last layout
(counterpart of ``markovflow_tpu/ops/kalman.py``, the time-last core).

Plain PyTorch: these are the reference versions that the CUDA kernels of
:mod:`markovflow_tpu_torch.ops.cuda_scan` are held against, and the path
every CPU tensor takes.

Conventions: N states; the prior-step arrays (F, c, Q) hold the initial
distribution at element 0 (F_0 = 0, c_0 = mu0, Q_0 = P0) and the transition
x_k = F_k x_{k-1} + c_k + N(0, Q_k) at k >= 1.  Matrices are [..., d1, d2, N]
with any leading batch shape; sites enter in natural form (nu, lam).

The JAX package's public time-middle API ([..., N, d, d] arrays:
:class:`FilterElements`, :func:`make_filter_elements`,
:func:`parallel_filter`, :func:`parallel_smoother`, ...) sits at the end of
the module, on top of the time-last core.  Its two scans run through the
kernel wrappers :func:`ops.cuda_scan.filter_scan` and
:func:`ops.cuda_scan.smoother_scan`: the CUDA kernels on CUDA tensors, the
plain scans here on CPU tensors.  The ``sequential_*`` versions compose one
step after another, in plain torch: they are the test oracles.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .scans import _mm_tl, _sym_tl, _t_tl, scan_tl

__all__ = ["make_filter_elements_tl", "filter_scan_tl", "filter_pipeline_tl",
           "rts_gains_tl", "smoother_elements_tl", "smoother_scan_tl", "smoother_pipeline_tl",
           "posterior_ssm_params_tl",
           "FilterElements", "make_filter_elements", "parallel_filter",
           "sequential_filter", "predicted_moments", "log_likelihood_sites",
           "SmootherElements", "parallel_smoother", "sequential_smoother",
           "posterior_ssm_params"]


def _no_tf32(x: torch.Tensor) -> None:
    """The plain versions are float32 references on the card: no TF32."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _eye_tl(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)[..., None]


def _cat(blocks, dim):
    """Concatenate blocks whose leading batch shapes broadcast."""
    lead = torch.broadcast_shapes(*(b.shape[:-3] for b in blocks))
    return torch.cat([b.expand(lead + b.shape[-3:]) for b in blocks], dim=dim)


def _gauss_jordan_tl(m):
    """Inverse and determinant of [..., d, d, N] by Gauss-Jordan elimination
    on [m | I] with partial pivoting, unrolled over d.  The pivot search
    swaps row j with each later row whose entry in column j is larger in
    magnitude (selects, no gathers); any row order gives the same inverse.
    The CUDA kernels' device ``gauss_jordan`` (``ops/csrc/small_linalg.cuh``)
    does the same operations in the same order."""
    d = m.shape[-3]
    eye = _eye_tl(d, m).expand(m.shape)
    rows = [torch.cat([m[..., i, :, :], eye[..., i, :, :]], dim=-2)
            for i in range(d)]                      # each [..., 2d, N]
    det = torch.ones_like(m[..., 0, 0, :])
    for j in range(d):
        for i in range(j + 1, d):
            swap = rows[i][..., j, :].abs() > rows[j][..., j, :].abs()
            s = swap[..., None, :]
            rows[j], rows[i] = (torch.where(s, rows[i], rows[j]),
                                torch.where(s, rows[j], rows[i]))
            det = torch.where(swap, -det, det)
        piv = rows[j][..., j, :]
        det = det * piv
        rows[j] = rows[j] * (1.0 / piv)[..., None, :]
        for i in range(d):
            if i != j:
                rows[i] = rows[i] - rows[i][..., j:j + 1, :] * rows[j]
    return torch.stack([r[..., d:, :] for r in rows], dim=-3), det


def _inv_tl(m):
    """Inverse over the leading matrix dims of [..., d, d, N]: closed forms
    for d <= 3, pivoted Gauss-Jordan for d <= 12 (the CUDA kernels' device
    functions compute the same), LU above."""
    d = m.shape[-3]
    if d == 1:
        return 1.0 / m
    if d == 2:
        det = m[..., 0, 0, :] * m[..., 1, 1, :] - m[..., 0, 1, :] * m[..., 1, 0, :]
        adj = torch.stack([
            torch.stack([m[..., 1, 1, :], -m[..., 0, 1, :]], -2),
            torch.stack([-m[..., 1, 0, :], m[..., 0, 0, :]], -2)], -3)
        return adj / det[..., None, None, :]
    if d == 3:
        def c(i1, j1, i2, j2):
            return (m[..., i1, j1, :] * m[..., i2, j2, :]
                    - m[..., i1, j2, :] * m[..., i2, j1, :])
        det = (m[..., 0, 0, :] * c(1, 1, 2, 2) - m[..., 0, 1, :] * c(1, 0, 2, 2)
               + m[..., 0, 2, :] * c(1, 0, 2, 1))
        adj = torch.stack([
            torch.stack([c(1, 1, 2, 2), -c(0, 1, 2, 2), c(0, 1, 1, 2)], -2),
            torch.stack([-c(1, 0, 2, 2), c(0, 0, 2, 2), -c(0, 0, 1, 2)], -2),
            torch.stack([c(1, 0, 2, 1), -c(0, 0, 2, 1), c(0, 0, 1, 1)], -2),
        ], -3)
        return adj / det[..., None, None, :]
    if d <= 12:
        return _gauss_jordan_tl(m)[0]
    return torch.linalg.inv(m.movedim(-1, -3)).movedim(-3, -1)


def _det_tl(m):
    """Determinant over the leading matrix dims of [..., d, d, N] (same
    forms as :func:`_inv_tl`)."""
    d = m.shape[-3]
    if d == 1:
        return m[..., 0, 0, :]
    if d == 2:
        return m[..., 0, 0, :] * m[..., 1, 1, :] - m[..., 0, 1, :] * m[..., 1, 0, :]
    if d == 3:
        def c(i1, j1, i2, j2):
            return (m[..., i1, j1, :] * m[..., i2, j2, :]
                    - m[..., i1, j2, :] * m[..., i2, j1, :])
        return (m[..., 0, 0, :] * c(1, 1, 2, 2) - m[..., 0, 1, :] * c(1, 0, 2, 2)
                + m[..., 0, 2, :] * c(1, 0, 2, 1))
    if d <= 12:
        return _gauss_jordan_tl(m)[1]
    return torch.linalg.det(m.movedim(-1, -3))


def make_filter_elements_tl(F, c, Q, H, nu, lam) -> Tuple[torch.Tensor, ...]:
    """Associative filtering elements (A, b, C, J, eta) (Sarkka &
    Garcia-Fernandez 2021, eq. 10) from prior steps and sites.

    F [..., d, d, N]; c [..., d, 1, N]; Q [..., d, d, N]; H [..., o, d, N];
    nu [..., o, 1, N]; lam [..., o, o, N].
    """
    o = lam.shape[-3]
    d = F.shape[-3]
    qht = _mm_tl(Q, _t_tl(H))                       # [d, o, N]
    hqht = _mm_tl(H, qht)                           # [o, o, N]
    z = _inv_tl(_eye_tl(o, F) + _mm_tl(hqht, lam))
    lam_z = _sym_tl(_mm_tl(lam, z))                 # S^{-1}
    gain = _mm_tl(qht, lam_z)                       # [d, o, N]
    i_gh = _eye_tl(d, F) - _mm_tl(gain, H)
    a_e = _mm_tl(i_gh, F)
    b_e = _mm_tl(i_gh, c) + _mm_tl(qht, _mm_tl(_t_tl(z), nu))
    c_e = _sym_tl(_mm_tl(i_gh, Q))
    hc = _mm_tl(H, c)                               # [o, 1, N]
    resid = _mm_tl(_t_tl(z), nu) - _mm_tl(lam_z, hc)
    eta = _mm_tl(_t_tl(F), _mm_tl(_t_tl(H), resid))
    hf = _mm_tl(H, F)                               # [o, d, N]
    j_e = _sym_tl(_mm_tl(_t_tl(hf), _mm_tl(lam_z, hf)))
    return a_e, b_e, c_e, j_e, eta


def _combine_filter_tl(x, y):
    """Filtering composition, x earlier and y later (Lemma 8)."""
    xa, xb, xc, xj, xe = x
    ya, yb, yc, yj, ye = y
    m_inv = _inv_tl(_eye_tl(xa.shape[-3], xa) + _mm_tl(xc, yj))
    m_inv_t = _t_tl(m_inv)
    a = _mm_tl(ya, _mm_tl(m_inv, xa))
    b = _mm_tl(ya, _mm_tl(m_inv, xb + _mm_tl(xc, ye))) + yb
    c = _mm_tl(ya, _mm_tl(_mm_tl(m_inv, xc), _t_tl(ya))) + yc
    eta = _mm_tl(_t_tl(xa), _mm_tl(m_inv_t, ye - _mm_tl(yj, xb))) + xe
    j = _mm_tl(_t_tl(xa), _mm_tl(m_inv_t, _mm_tl(yj, xa))) + xj
    return a, b, _sym_tl(c), _sym_tl(j), eta


def _combine_smoother_tl(later, earlier):
    """Smoothing composition (reverse scan): ``later`` is the suffix."""
    le, lg, ll = later
    ee, eg, el = earlier
    e = _mm_tl(ee, le)
    g = _mm_tl(ee, lg) + eg
    ell = _mm_tl(ee, _mm_tl(ll, _t_tl(ee))) + el
    return e, g, _sym_tl(ell)


def filter_scan_tl(A, b, C, J, eta):
    """Prefix scan of filtering elements A [..., d, d, N], b [..., d, 1, N],
    C [..., d, d, N], J [..., d, d, N], eta [..., d, 1, N] with the filtering
    composition.  Returns the b and C legs of every prefix: the filtered
    moments (m_f [..., d, 1, N], P_f [..., d, d, N]) for the elements of
    :func:`make_filter_elements_tl`."""
    _no_tf32(A)
    _, m_f, p_f, _, _ = scan_tl(_combine_filter_tl, (A, b, C, J, eta))
    return m_f, p_f


def _predicted_moments_tl(F, c, Q, m_f, p_f):
    """One-step-ahead predictive moments of every step from the filtered
    ones; index 0 is the prior (c_0, Q_0)."""
    fm = _mm_tl(F[..., 1:], m_f[..., :-1]) + c[..., 1:]
    fp = _mm_tl(F[..., 1:], _mm_tl(p_f[..., :-1], _t_tl(F[..., 1:]))) + Q[..., 1:]
    m_pred = _cat([c[..., :1], fm], dim=-1)
    p_pred = _sym_tl(_cat([Q[..., :1], fp], dim=-1))
    return m_pred, p_pred


def filter_pipeline_tl(F, c, Q, H, nu, lam,
                       mask: Optional[torch.Tensor] = None):
    """Elements -> parallel filter -> predicted moments -> site
    log-likelihood.  Inputs as :func:`make_filter_elements_tl`; ``mask``
    is a boolean [..., N] or None (masked steps add 0 to the likelihood).

    Returns (m_f [..., d, 1, N], P_f [..., d, d, N], loglik [...]).
    """
    _no_tf32(F)
    m_f, p_f = filter_scan_tl(*make_filter_elements_tl(F, c, Q, H, nu, lam))
    m_pred, p_pred = _predicted_moments_tl(F, c, Q, m_f, p_f)
    return m_f, p_f, _log_likelihood_sites_tl(H, nu, lam, m_pred, p_pred, mask)


def _log_likelihood_sites_tl(H, nu, lam, m_pred, p_pred, mask=None):
    """Sum over steps of log N(y_k; H m_k|k-1, H P_k|k-1 H^T + lam^-1) in
    lam form (y = lam^-1 nu); masked steps add 0."""
    o = lam.shape[-3]
    hm = _mm_tl(H, m_pred)                          # [o, 1, N]
    hpht = _mm_tl(H, _mm_tl(p_pred, _t_tl(H)))      # [o, o, N]
    w = nu - _mm_tl(lam, hm)
    m_mat = lam + _mm_tl(lam, _mm_tl(hpht, lam))
    eye_o = _eye_tl(o, lam)
    lam_safe = lam
    if mask is not None:
        keep = mask[..., None, None, :]
        m_mat = torch.where(keep, m_mat, eye_o)
        lam_safe = torch.where(keep, lam, eye_o)
    quad = (w * _mm_tl(_inv_tl(m_mat), w)).sum(dim=(-3, -2))
    log_det_s = (torch.log(torch.abs(_det_tl(eye_o + _mm_tl(hpht, lam_safe))))
                 - torch.log(torch.abs(_det_tl(lam_safe))))
    ll = -0.5 * (quad + log_det_s + o * math.log(2.0 * math.pi))
    if mask is not None:
        ll = torch.where(mask, ll, torch.zeros((), dtype=ll.dtype,
                                               device=ll.device))
    return ll.sum(-1)


def rts_gains_tl(F, Q, p_f):
    """RTS gains G_k = P_k F^T (F P_k F^T + Q)^-1 [..., d, d, N-1] from the
    filtered covariances P_k (k < N - 1) and the steps (F, Q) of k + 1,
    elementwise d x d algebra over the steps.  F and Q may be one constant
    step [..., d, d, 1] (a uniform grid), broadcast against P_k."""
    p_pred = _sym_tl(_mm_tl(F, _mm_tl(p_f, _t_tl(F))) + Q)
    pft = _mm_tl(p_f, _t_tl(F))
    return _t_tl(_mm_tl(_inv_tl(p_pred), _t_tl(pft)))


def smoother_elements_tl(F, c, Q, m_f, p_f):
    """RTS smoothing elements (E, g, L) of every step from the filtered
    moments: E_k = P_k F^T Pp^-1 (the gain), g_k = m_k - E_k (F m_k + c),
    L_k = sym(P_k - E_k F P_k) with (F, c, Q) of step k + 1, and the
    boundary element (0, m_f[N-1], P_f[N-1]) at the last step.  Element 0 of
    (F, c, Q), the prior, is never read.

    Returns (E [..., d, d, N], g [..., d, 1, N], L [..., d, d, N],
    gains [..., d, d, N-1]).
    """
    fn, cn, qn = F[..., 1:], c[..., 1:], Q[..., 1:]
    mk, pk = m_f[..., :-1], p_f[..., :-1]
    gains = rts_gains_tl(fn, qn, pk)
    g = mk - _mm_tl(gains, _mm_tl(fn, mk) + cn)
    ell = _sym_tl(pk - _mm_tl(gains, _mm_tl(fn, pk)))
    e_all = _cat([gains, torch.zeros_like(p_f[..., -1:])], dim=-1)
    g_all = _cat([g, m_f[..., -1:]], dim=-1)
    l_all = _cat([ell, p_f[..., -1:]], dim=-1)
    return e_all, g_all, l_all, gains


def smoother_scan_tl(E, g, L):
    """Reverse (suffix) scan of smoothing elements E [..., d, d, N],
    g [..., d, 1, N], L [..., d, d, N] with the smoothing composition.
    Returns the g and L legs of every suffix: (m_s [..., d, 1, N],
    P_s [..., d, d, N]) for RTS elements, (r, NDK) for Koopman adjoint
    elements."""
    _no_tf32(E)
    _, m_s, p_s = scan_tl(_combine_smoother_tl, (E, g, L), reverse=True)
    return m_s, p_s


def smoother_pipeline_tl(F, c, Q, m_f, p_f):
    """RTS smoother from the filtered moments.

    Returns (m_s [..., d, 1, N], P_s [..., d, d, N], gains [..., d, d, N-1]).
    """
    _no_tf32(F)
    e_all, g_all, l_all, gains = smoother_elements_tl(F, c, Q, m_f, p_f)
    m_s, p_s = smoother_scan_tl(e_all, g_all, l_all)
    return m_s, p_s, gains


def _materialize_uniform(Fc, cc, Qc, mu0, P0, Hc, n: int):
    """Expand the constant uniform-grid representation to full time-last
    arrays: F = [0, Fc, Fc, ...], c = [mu0, cc, ...], Q = [P0, Qc, ...],
    H broadcast to all n steps."""
    def rep(x):
        return x.expand(x.shape[:-1] + (n - 1,))
    F = _cat([torch.zeros_like(Fc), rep(Fc)], dim=-1)
    c = _cat([mu0, rep(cc)], dim=-1)
    Q = _cat([P0, rep(Qc)], dim=-1)
    H = Hc.expand(Hc.shape[:-1] + (n,))
    return F, c, Q, H


def _posterior_ssm_tl(m_s, p_s, gains):
    """(A, b, Q) of the smoothing posterior's forward SSM over the
    transitions, and Cov(x_k, x_{k+1}) = G_k P^s_{k+1}."""
    cross = _mm_tl(gains, p_s[..., 1:])
    a_post = _t_tl(_mm_tl(_inv_tl(p_s[..., :-1]), cross))
    b_post = m_s[..., 1:] - _mm_tl(a_post, m_s[..., :-1])
    q_post = _sym_tl(p_s[..., 1:] - _mm_tl(a_post, cross))
    return a_post, b_post, q_post, cross


def posterior_ssm_params_tl(m_s, p_s, gains):
    """Time-last :func:`posterior_ssm_params`: m_s [..., d, 1, N],
    p_s [..., d, d, N], gains [..., d, d, N-1].  Returns (mu0 [..., d, 1],
    P0 [..., d, d], A [..., d, d, N-1], b [..., d, 1, N-1],
    Q [..., d, d, N-1])."""
    a_post, b_post, q_post, _ = _posterior_ssm_tl(m_s, p_s, gains)
    return m_s[..., 0], p_s[..., 0], a_post, b_post, q_post


# ---------------------------------------------------------------------------
# The time-middle API (counterpart of markovflow_tpu/ops/kalman.py:436-700)
# ---------------------------------------------------------------------------
def _to_tl(x):
    """[..., N, d1, d2] -> [..., d1, d2, N]."""
    return x.movedim(-3, -1)


def _from_tl(x):
    return x.movedim(-1, -3)


def _vec_to_tl(x):
    """[..., N, d] -> [..., d, 1, N]."""
    return _to_tl(x[..., None])


def _vec_from_tl(x):
    """[..., d, 1, N] -> [..., N, d]."""
    return x[..., 0, :].movedim(-1, -2)


class FilterElements(NamedTuple):
    """Associative filtering elements (Sarkka & Garcia-Fernandez 2021,
    eq. 10), time-middle."""

    A: torch.Tensor    # [..., N, d, d]
    b: torch.Tensor    # [..., N, d, 1]
    C: torch.Tensor    # [..., N, d, d]
    J: torch.Tensor    # [..., N, d, d]
    eta: torch.Tensor  # [..., N, d, 1]


class SmootherElements(NamedTuple):
    """Associative RTS smoothing elements, time-middle."""

    E: torch.Tensor  # [..., N, d, d]
    g: torch.Tensor  # [..., N, d, 1]
    L: torch.Tensor  # [..., N, d, d]


def make_filter_elements(F, c, Q, H, nu, lam) -> FilterElements:
    """Per-step filtering elements from prior steps and sites, in lam form
    (exact for a singular lam): F [..., N, d, d], c [..., N, d],
    Q [..., N, d, d]; H [..., N, o, d] (N may be 1, broadcast over the
    steps), nu [..., N, o], lam [..., N, o, o]."""
    elems = make_filter_elements_tl(_to_tl(F), _vec_to_tl(c), _to_tl(Q),
                                    _to_tl(H), _vec_to_tl(nu), _to_tl(lam))
    return FilterElements(*(_from_tl(x) for x in elems))


def parallel_filter(elems: FilterElements):
    """Filtered means and covariances ([..., N, d], [..., N, d, d]) by the
    prefix scan of the elements: on CUDA tensors the filter-scan kernel
    (:func:`ops.cuda_scan.filter_scan`), on CPU tensors its plain version."""
    from .cuda_scan import filter_scan
    m_f, p_f = filter_scan(*(_to_tl(x) for x in elems))
    return _vec_from_tl(m_f), _from_tl(p_f)


def sequential_filter(elems: FilterElements):
    """The same result as :func:`parallel_filter` by composing the
    elements one step after another (O(N) depth; the test oracle)."""
    tl = tuple(_to_tl(x) for x in elems)
    acc = tuple(x[..., :1] for x in tl)
    ms, ps = [acc[1]], [acc[2]]
    for k in range(1, tl[0].shape[-1]):
        acc = _combine_filter_tl(acc, tuple(x[..., k:k + 1] for x in tl))
        ms.append(acc[1])
        ps.append(acc[2])
    return _vec_from_tl(_cat(ms, dim=-1)), _from_tl(_cat(ps, dim=-1))


def predicted_moments(F, c, Q, m_f, P_f):
    """One-step-ahead predictive moments m_k|k-1 [..., N, d] and
    P_k|k-1 [..., N, d, d] for every k; index 0 is the prior (c_0 = mu0,
    Q_0 = P0)."""
    m_pred, p_pred = _predicted_moments_tl(_to_tl(F), _vec_to_tl(c), _to_tl(Q),
                                           _vec_to_tl(m_f), _to_tl(P_f))
    return _vec_from_tl(m_pred), _from_tl(p_pred)


def log_likelihood_sites(H, nu, lam, m_pred, p_pred, mask=None):
    """Sum over k of log N(y_k; H m_k|k-1, H P_k|k-1 H^T + lam^-1) with
    y = lam^-1 nu, in lam form: H [..., N, o, d], nu [..., N, o],
    lam [..., N, o, o], the predictive moments of :func:`predicted_moments`
    and an optional boolean ``mask`` [..., N] (masked steps add 0)."""
    return _log_likelihood_sites_tl(_to_tl(H), _vec_to_tl(nu), _to_tl(lam),
                                    _vec_to_tl(m_pred), _to_tl(p_pred), mask)


def _smoother_elements(F, c, Q, m_f, P_f):
    """Time-middle inputs -> time-last (E, g, L, gains) of
    :func:`smoother_elements_tl`."""
    return smoother_elements_tl(_to_tl(F), _vec_to_tl(c), _to_tl(Q),
                                _vec_to_tl(m_f), _to_tl(P_f))


def parallel_smoother(F, c, Q, m_f, P_f):
    """Smoothed means and covariances and the RTS gains by the reverse scan
    of the smoothing elements: on CUDA tensors the smoother-scan kernel
    (:func:`ops.cuda_scan.smoother_scan`), on CPU tensors its plain version.
    F [..., N, d, d], c [..., N, d], Q [..., N, d, d], m_f [..., N, d],
    P_f [..., N, d, d].  Returns (m_s [..., N, d], P_s [..., N, d, d],
    gains [..., N-1, d, d])."""
    from .cuda_scan import smoother_scan
    e, g, ell, gains = _smoother_elements(F, c, Q, m_f, P_f)
    m_s, p_s = smoother_scan(e, g, ell)
    return _vec_from_tl(m_s), _from_tl(p_s), _from_tl(gains)


def sequential_smoother(F, c, Q, m_f, P_f):
    """The same result as :func:`parallel_smoother` by the backward RTS
    recursion, one step after another (the test oracle)."""
    e, g, ell, gains = _smoother_elements(F, c, Q, m_f, P_f)
    elems = SmootherElements(e, g, ell)
    acc = tuple(x[..., -1:] for x in elems)
    ms, ps = [acc[1]], [acc[2]]
    for k in range(e.shape[-1] - 2, -1, -1):
        acc = _combine_smoother_tl(acc, tuple(x[..., k:k + 1] for x in elems))
        ms.append(acc[1])
        ps.append(acc[2])
    return (_vec_from_tl(_cat(ms[::-1], dim=-1)), _from_tl(_cat(ps[::-1], dim=-1)),
            _from_tl(gains))


def posterior_ssm_params(m_s, P_s, gains):
    """Forward-SSM parameters of the smoothing posterior, from the smoothed
    moments m_s [..., N, d], P_s [..., N, d, d] and the RTS gains
    [..., N-1, d, d]: with Cov(x_k, x_{k+1} | Y) = G_k P^s_{k+1},
    A_k = (P^s_k^-1 G_k P^s_{k+1})^T, b_k = m^s_{k+1} - A_k m^s_k and
    Q_k = P^s_{k+1} - A_k G_k P^s_{k+1}.  Returns (mu0 [..., d],
    P0 [..., d, d], A, b [..., N-1, d], Q, and the cross covariances
    transposed, Cov(x_k, x_{k+1})^T [..., N-1, d, d])."""
    a_post, b_post, q_post, cross = _posterior_ssm_tl(
        _vec_to_tl(m_s), _to_tl(P_s), _to_tl(gains))
    return (m_s[..., 0, :], P_s[..., 0, :, :], _from_tl(a_post),
            _vec_from_tl(b_post), _from_tl(q_post), _from_tl(_t_tl(cross)))
