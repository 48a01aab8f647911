"""SDE utilities: simulation, statistical linearisation and the drift
difference along a Gaussian path (counterpart of
``markovflow_tpu/sde/sde_utils.py``)."""
from __future__ import annotations

import torch

from ..state_space_model import StateSpaceModel
from ..utils.linalg import small_cholesky
from .drift import LinearDrift
from .sde import SDE, Gaussian, mvnquad

__all__ = ["euler_maruyama", "euler_maruyama_from_normals", "linearize_sde",
           "squared_drift_difference_along_Gaussian_path"]


def euler_maruyama_from_normals(sde: SDE, x0: torch.Tensor,
                                time_grid: torch.Tensor,
                                normals: torch.Tensor) -> torch.Tensor:
    """Euler-Maruyama steps of dx = f dt + l dB on a homogeneous grid from
    the standard normals ``normals`` [N - 1, batch, d]: x0 [batch, d],
    time_grid [N] -> [batch, N, d] with x0 at index 0.  This makes data,
    outside any timed step, so it loops over the steps in Python (a few
    small launches a step on the card)."""
    batch = x0.shape[0]
    dt = time_grid[1] - time_grid[0]
    xs = [x0]
    for k in range(time_grid.shape[-1] - 1):
        x = xs[-1]
        tb = time_grid[k].expand(batch, 1)
        diff = sde.diffusion(x, tb) * torch.sqrt(dt)
        xs.append(x + sde.drift(x, tb) * dt + (diff * normals[k][:, None, :]).sum(-1))
    return torch.stack(xs, dim=1)


def euler_maruyama(sde: SDE, x0: torch.Tensor, time_grid: torch.Tensor,
                   generator: torch.Generator = None) -> torch.Tensor:
    """:func:`euler_maruyama_from_normals` with normals drawn from
    ``generator`` (on x0's device, or the default one)."""
    normals = torch.randn((time_grid.shape[-1] - 1,) + tuple(x0.shape),
                          generator=generator, dtype=x0.dtype, device=x0.device)
    return euler_maruyama_from_normals(sde, x0, time_grid, normals)


def linearize_sde(sde: SDE, transition_times: torch.Tensor,
                  linearization_path: Gaussian,
                  initial_state: Gaussian) -> StateSpaceModel:
    """Statistical linearisation of a state-dim-1 SDE along a Gaussian path
    of N points (mu [B, N, 1] or [N, 1], cov [B, N, 1, 1] or [N, 1, 1]) on
    ``transition_times`` [N + 1]:

        A*_i = E_q[df/dx] dt + I,   b*_i = (E_q[f] - E_q[df/dx] E_q[x]) dt,

    with the diffusion at the transitions' start times and
    chol Q = l sqrt(dt)."""
    if sde.state_dim != 1:
        raise NotImplementedError("linearize_sde takes state dim 1 only")
    q_mean = torch.atleast_3d(linearization_path.mu)
    q_covar = linearization_path.cov
    if q_covar.dim() == 3:
        q_covar = q_covar[None]
    initial_mean = torch.atleast_2d(initial_state.mu)
    init_cov = initial_state.cov
    if init_cov.dim() == 2:
        init_cov = init_cov[None]
    e_f = sde.expected_drift(q_mean, q_covar)
    a = sde.expected_gradient_drift(q_mean, q_covar)
    b = e_f - a * q_mean
    eye = torch.eye(sde.state_dim, dtype=a.dtype, device=a.device)
    q_diff = sde.diffusion(q_mean, transition_times[:-1])
    return LinearDrift(A=a[..., None] * eye, b=b).to_ssm(
        q=q_diff, transition_times=transition_times, initial_mean=initial_mean,
        initial_chol_covariance=small_cholesky(init_cov))


def squared_drift_difference_along_Gaussian_path(
        sde_p: SDE, linear_drift: LinearDrift, q: Gaussian, dt,
        quadrature_pnts: int = 20) -> torch.Tensor:
    """0.5 E_q ||f_L(x) - f_p(x)||^2 / sigma dt, summed over the path: the
    KL[q || p] when the linear drift is q's.  State dim 1, unbatched:
    q.mu [N, 1], q.cov [N, 1, 1], A [N, 1], b [N, 1]."""
    if sde_p.state_dim != 1:
        raise NotImplementedError("the drift difference takes state dim 1 only")
    m = q.mu.reshape(-1, 1)
    s = q.cov.reshape(-1, 1, 1)
    a = linear_drift.A.reshape(-1, 1)
    b = linear_drift.b.reshape(-1, 1)

    def fn(x):
        # x arrives flattened [N H, 1]: point n's nodes are rows n H .. n H + H - 1
        n_pts = x.shape[0] // m.shape[0]
        lin = torch.repeat_interleave(a, n_pts, dim=0) * x \
            + torch.repeat_interleave(b, n_pts, dim=0)
        return (lin - sde_p.drift(x, torch.zeros_like(x))) ** 2 / sde_p.q

    return 0.5 * mvnquad(fn, m, s, h=quadrature_pnts).sum() * dt
