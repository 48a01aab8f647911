"""Transformations between SSM, expectation and natural parameterisations
(counterpart of ``markovflow_tpu/ssm_gaussian_transformations.py``).

* SSM: (mu0, chol_P0, A_s, b_s, chol_Q_s).
* Expectations eta: (eta_linear = the marginal means [..., N+1, d];
  eta_diag = Sigma_k + mu_k mu_k^T; eta_subdiag = E[x_{k+1} x_k^T]).
* Naturals theta: the linear term K^-1 mu and the block-tridiagonal
  -1/2 precision: theta_diag = -1/2 (Q_k^-1 + A_{k+1}^T Q_{k+1}^-1 A_{k+1}),
  theta_subdiag = Q_k^-1 A_k.
* Naturals without smoothing (Lin, Khan & Schmidt 2019): theta_diag =
  -1/2 Q_k^-1, theta_subdiag = Q_k^-1 A_k, theta_linear = Q_k^-1 b_k.

The cores (``*_tl``) work in time-last layout [..., d, d, N] with
elementwise d x d algebra, as in the JAX package; the public functions
convert at the boundary.  The natural-gradient optimiser
(:mod:`.ssm_natgrad`) calls the cores.

naturals -> SSM has two engines.  :func:`naturals_to_ssm_params` is the
backward UDU factorisation of the precision (a loop over the blocks, for
small N).  :func:`naturals_to_ssm_params_parallel` runs the Kalman filter
and smoother of a synthetic model with the same precision: on CUDA tensors
through the general filter kernel at o = d (identity emission, full and in
general indefinite site precisions) and the smoother-scan kernel, as
``kalman_filter.py`` calls them.
"""
from __future__ import annotations

import torch

from .block_tri_diag import SymmetricBlockTriDiagonal
from .ops import cuda_scan
from .ops.kalman import (_eye_tl, _from_tl, _inv_tl, _to_tl, posterior_ssm_params_tl,
                         smoother_elements_tl)
from .ops.scans import _mm_tl, _sym_tl, _t_tl, affine_scan
from .state_space_model import StateSpaceModel
from .utils.linalg import small_cholesky, small_inv, symmetrize, tlt

__all__ = [
    "ssm_to_expectations", "expectations_to_ssm_params", "expectations_to_ssm",
    "ssm_to_naturals", "ssm_to_naturals_no_smoothing", "naturals_to_ssm_params",
    "naturals_to_ssm_params_parallel", "naturals_to_ssm",
    "naturals_to_ssm_params_no_smoothing",
]


def _chol_tl(m):
    """Cholesky over the matrix dims of [..., d, d, N]."""
    return _to_tl(small_cholesky(_from_tl(m)))


def _ssm_fields_tl(ssm: StateSpaceModel):
    """(a [..., d, d, N], b [..., d, 1, N], l0 [..., d, d, 1],
    lq [..., d, d, N], mu0 [..., d, 1, 1]) in time-last layout."""
    return (_to_tl(ssm.state_transitions), _to_tl(ssm.state_offsets[..., None]),
            ssm.cholesky_initial_covariance[..., None],
            _to_tl(ssm.cholesky_process_covariances),
            ssm.initial_mean[..., None, None])


def ssm_to_expectations_tl(ssm: StateSpaceModel):
    """(eta_linear [..., d, 1, N+1], eta_diag [..., d, d, N+1],
    eta_subdiag [..., d, d, N]) from the SSM's marginals."""
    a_tl = _to_tl(ssm.state_transitions)
    means, covs = ssm.marginals_tl()
    eta_diag = covs + _mm_tl(means, _t_tl(means))
    eta_subdiag = (_mm_tl(a_tl, covs[..., :-1])
                   + _mm_tl(means[..., 1:], _t_tl(means[..., :-1])))
    return means, eta_diag, eta_subdiag


def expectations_to_ssm_params_tl(eta_linear, eta_diag, eta_subdiag):
    """Time-last inverse of :func:`ssm_to_expectations_tl`:
    (a [..., d, d, N], b [..., d, 1, N], chol_p0 [..., d, d, 1],
    chol_q [..., d, d, N], mu0 [..., d, 1, 1])."""
    means = eta_linear
    covs = eta_diag - _mm_tl(means, _t_tl(means))
    # Cov(x_k, x_{k+1}) = eta_subdiag^T - mu_k mu_{k+1}^T
    cov_right = _t_tl(eta_subdiag) - _mm_tl(means[..., :-1], _t_tl(means[..., 1:]))
    chols = _chol_tl(_sym_tl(covs))
    a_s = _t_tl(_mm_tl(_inv_tl(_sym_tl(covs[..., :-1])), cov_right))
    b_s = means[..., 1:] - _mm_tl(a_s, means[..., :-1])
    q_s = covs[..., 1:] - _mm_tl(a_s, _mm_tl(covs[..., :-1], _t_tl(a_s)))
    return a_s, b_s, chols[..., :1], _chol_tl(_sym_tl(q_s)), means[..., :1]


def ssm_to_naturals_tl(ssm: StateSpaceModel):
    """(theta_linear [..., d, 1, N+1], theta_diag [..., d, d, N+1],
    theta_subdiag [..., d, d, N])."""
    a_tl, b_tl, l0_tl, lq_tl, mu0_tl = _ssm_fields_tl(ssm)
    chols = torch.cat([l0_tl, lq_tl], dim=-1)
    q_inv = _inv_tl(_sym_tl(_mm_tl(chols, _t_tl(chols))))   # index 0: P0^-1
    qinv_a = _mm_tl(q_inv[..., 1:], a_tl)
    at_qinv_a = _mm_tl(_t_tl(a_tl), qinv_a)
    theta_diag = -0.5 * (q_inv + torch.cat([at_qinv_a, torch.zeros_like(q_inv[..., :1])],
                                           dim=-1))
    qinv_b = _mm_tl(q_inv, torch.cat([mu0_tl, b_tl], dim=-1))
    at_qinv_b_next = _mm_tl(_t_tl(a_tl), qinv_b[..., 1:])
    theta_linear = torch.cat([qinv_b[..., :-1] - at_qinv_b_next, qinv_b[..., -1:]], dim=-1)
    return theta_linear, theta_diag, qinv_a


def ssm_to_expectations(ssm: StateSpaceModel):
    """(eta_linear [..., N+1, d], eta_diag [..., N+1, d, d],
    eta_subdiag [..., N, d, d])."""
    eta_linear, eta_diag, eta_subdiag = ssm_to_expectations_tl(ssm)
    return _from_tl(eta_linear)[..., 0], _from_tl(eta_diag), _from_tl(eta_subdiag)


def expectations_to_ssm_params(eta_linear, eta_diag, eta_subdiag):
    """Inverse of :func:`ssm_to_expectations`: (A_s, b_s, chol_P0,
    chol_Q_s, mu0)."""
    a_s, b_s, chol_p0, chol_q_s, mu0 = expectations_to_ssm_params_tl(
        _to_tl(eta_linear[..., None]), _to_tl(eta_diag), _to_tl(eta_subdiag))
    return (_from_tl(a_s), _from_tl(b_s)[..., 0], chol_p0[..., 0], _from_tl(chol_q_s),
            mu0[..., 0, 0])


def expectations_to_ssm(eta_linear, eta_diag, eta_subdiag) -> StateSpaceModel:
    return StateSpaceModel(*_reorder(expectations_to_ssm_params(
        eta_linear, eta_diag, eta_subdiag)))


def _reorder(params):
    """(A_s, b_s, chol_P0, chol_Q_s, mu0) in StateSpaceModel's order."""
    a_s, b_s, chol_p0, chol_q_s, mu0 = params
    return mu0, chol_p0, a_s, b_s, chol_q_s


def ssm_to_naturals(ssm: StateSpaceModel):
    """(theta_linear [..., N+1, d], theta_diag [..., N+1, d, d],
    theta_subdiag [..., N, d, d])."""
    theta_linear, theta_diag, theta_subdiag = ssm_to_naturals_tl(ssm)
    return _from_tl(theta_linear)[..., 0], _from_tl(theta_diag), _from_tl(theta_subdiag)


def naturals_to_ssm_params(theta_linear, theta_diag, theta_subdiag):
    """Inverse of :func:`ssm_to_naturals` by the backward UDU factorisation
    of the precision (-2 theta_diag on the diagonal, -theta_subdiag below
    it) and two affine scans for the means: (A_s, b_s, chol_P0, chol_Q_s,
    mu0).  A loop over the N + 1 blocks."""
    precision = SymmetricBlockTriDiagonal(symmetrize(-2.0 * theta_diag), -theta_subdiag)
    u_off, d_chol = precision.upper_diagonal_lower()
    # A_{k+1} = -U_k^T; Q_{k+1} = D_{k+1}^-1; P0 = D_0^-1
    a_s = -tlt(u_off)
    cov_all = symmetrize(small_inv(symmetrize(d_chol @ tlt(d_chol))))
    chol_cov_all = small_cholesky(cov_all)
    # the means, mu = U^-T D^-1 U^-1 theta_linear: backward affine scan
    # z_N = th_N, z_k = th_k + A_{k+1}^T z_{k+1}, then forward
    # mu_0 = w_0, mu_k = w_k + A_k mu_{k-1} with w = D^-1 z
    at_rev = torch.flip(tlt(a_s), dims=(-3,))
    f_rev = torch.cat([torch.zeros_like(at_rev[..., :1, :, :]), at_rev], dim=-3)
    z = torch.flip(affine_scan(f_rev, torch.flip(theta_linear, dims=(-2,))), dims=(-2,))
    w = (cov_all * z[..., None, :]).sum(-1)
    f_fwd = torch.cat([torch.zeros_like(a_s[..., :1, :, :]), a_s], dim=-3)
    mu = affine_scan(f_fwd, w)
    b_s = mu[..., 1:, :] - (a_s * mu[..., :-1, None, :]).sum(-1)
    return a_s, b_s, chol_cov_all[..., 0, :, :], chol_cov_all[..., 1:, :, :], mu[..., 0, :]


def naturals_to_ssm(theta_linear, theta_diag, theta_subdiag) -> StateSpaceModel:
    return StateSpaceModel(*_reorder(naturals_to_ssm_params(
        theta_linear, theta_diag, theta_subdiag)))


def naturals_to_ssm_params_parallel(theta_linear, theta_diag, theta_subdiag):
    """:func:`naturals_to_ssm_params` by the synthetic model of
    :func:`naturals_to_ssm_params_parallel_tl`."""
    a_tl, b_tl, chol_p0, chol_q_tl, mu0_tl = naturals_to_ssm_params_parallel_tl(
        _to_tl(theta_linear[..., None]), _to_tl(theta_diag), _to_tl(theta_subdiag))
    return (_from_tl(a_tl), _from_tl(b_tl)[..., 0], chol_p0[..., 0], _from_tl(chol_q_tl),
            mu0_tl[..., 0, 0])


def synthetic_filter_inputs_tl(th_lin, th_diag, th_sub):
    """The Kalman filter's inputs (F, c, Q, H, nu, lam), time-last, of the
    synthetic model whose posterior precision is the natural precision
    J = blocktridiag(-2 th_diag, -th_sub) of (th_lin [..., d, 1, N+1],
    th_diag [..., d, d, N+1], th_sub [..., d, d, N]): process precisions
    Q_k^-1 = -th_diag_k, transitions A_{k+1} = Q_{k+1} th_sub_k (J's
    off-diagonal exactly), c = 0, identity emissions (one, expanded), site
    precisions lam_k = -th_diag_k - th_sub_k^T Q_{k+1} th_sub_k
    (indefinite in general) and site naturals nu_k = th_lin_k."""
    d = th_diag.shape[-3]
    q_tl = _inv_tl(-th_diag)
    f_tl = torch.cat([torch.zeros_like(th_diag[..., :1]),
                      _mm_tl(q_tl[..., 1:], th_sub)], dim=-1)
    sqs = _mm_tl(_t_tl(th_sub), _mm_tl(q_tl[..., 1:], th_sub))
    lam_tl = -th_diag - torch.cat([sqs, torch.zeros_like(th_diag[..., :1])], dim=-1)
    return (f_tl, torch.zeros_like(th_lin), q_tl, _eye_tl(d, th_diag).expand(th_diag.shape),
            th_lin, lam_tl)


def naturals_to_ssm_params_parallel_tl(th_lin, th_diag, th_sub):
    """The unique forward SSM with naturals (th_lin [..., d, 1, N+1],
    th_diag [..., d, d, N+1], th_sub [..., d, d, N]) as the posterior of
    the synthetic model of :func:`synthetic_filter_inputs_tl`: one filter
    (the general filter at o = d) and one smoother scan, then the
    posterior's forward SSM.  Returns (a [..., d, d, N], b [..., d, 1, N],
    chol_p0 [..., d, d, 1], chol_q [..., d, d, N], mu0 [..., d, 1, 1])."""
    f_tl, c_tl, q_tl, h_tl, nu_tl, lam_tl = synthetic_filter_inputs_tl(th_lin, th_diag, th_sub)
    # the filter's log-likelihood is not needed (and a singular lam makes it
    # infinite); the moments never read it
    m_f, p_f, _ = cuda_scan.filter_pipeline(f_tl, c_tl, q_tl, h_tl, nu_tl, lam_tl)
    e_tl, g_tl, l_tl, gains = smoother_elements_tl(f_tl, c_tl, q_tl, m_f, p_f)
    m_s, p_s = cuda_scan.smoother_scan(e_tl, g_tl, l_tl)
    mu0_tl, p0_tl, a_tl, b_tl, qp_tl = posterior_ssm_params_tl(m_s, p_s, gains)
    chol_p0 = _chol_tl(_sym_tl(p0_tl[..., None]))
    return a_tl, b_tl, chol_p0, _chol_tl(_sym_tl(qp_tl)), mu0_tl[..., None]


def ssm_to_naturals_no_smoothing(ssm: StateSpaceModel):
    """(theta_linear [..., N+1, d], theta_diag [..., N+1, d, d],
    theta_subdiag [..., N, d, d]) without smoothing."""
    a_tl, b_tl, l0_tl, lq_tl, mu0_tl = _ssm_fields_tl(ssm)
    chols = torch.cat([l0_tl, lq_tl], dim=-1)
    q_inv = _inv_tl(_sym_tl(_mm_tl(chols, _t_tl(chols))))
    theta_linear = _mm_tl(q_inv, torch.cat([mu0_tl, b_tl], dim=-1))
    return (_from_tl(theta_linear)[..., 0], _from_tl(-0.5 * q_inv),
            _from_tl(_mm_tl(q_inv[..., 1:], a_tl)))


def naturals_to_ssm_params_no_smoothing(theta_linear, theta_diag, theta_subdiag):
    """Inverse of :func:`ssm_to_naturals_no_smoothing`: (A_s, b_s, chol_P0,
    chol_Q_s, mu0)."""
    th_lin = _to_tl(theta_linear[..., None])
    q_all = _sym_tl(_inv_tl(_sym_tl(-2.0 * _to_tl(theta_diag))))
    chol_all = _chol_tl(q_all)
    a_s = _from_tl(_mm_tl(q_all[..., 1:], _to_tl(theta_subdiag)))
    b_all = _mm_tl(q_all, th_lin)
    return (a_s, _from_tl(b_all[..., 1:])[..., 0], chol_all[..., 0],
            _from_tl(chol_all[..., 1:]), b_all[..., 0, 0])
