"""Batched small-matrix helpers (counterpart of ``markovflow_tpu/utils/linalg.py``)."""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["tlt", "symmetrize", "small_det", "small_inv", "small_solve",
           "block_diag", "batched_kron", "small_cholesky", "psd_cholesky", "cholesky_or_zero",
           "to_delta_time", "solve_from_chol", "mvn_logpdf", "small_mm", "small_mv",
           "searchsorted", "take_last", "take_rows"]


def tlt(x: torch.Tensor) -> torch.Tensor:
    """Transpose the last two axes."""
    return x.transpose(-1, -2)


def small_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m, k] @ [..., k, n] as elementwise products summed over k: no
    matmul, so no TF32 on the card.  Batch shapes broadcast."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def small_mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., m, k] times [..., k] -> [..., m], elementwise as
    :func:`small_mm`."""
    return (a * x[..., None, :]).sum(-1)


def block_diag(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Batched block-diagonal: [..., d_i, e_i] blocks -> [..., sum d, sum e].
    Batch shapes broadcast; the blocks share one dtype and device."""
    batch = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
    rows = sum(m.shape[-2] for m in mats)
    cols = sum(m.shape[-1] for m in mats)
    out = mats[0].new_zeros(batch + (rows, cols))
    r = c = 0
    for m in mats:
        dr, dc = m.shape[-2], m.shape[-1]
        out[..., r:r + dr, c:c + dc] = m
        r += dr
        c += dc
    return out


def batched_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product of [..., m, n] and [..., p, q] ->
    [..., m p, n q] (elementwise products: no matmul).  Batch shapes
    broadcast."""
    m, n = a.shape[-2:]
    p, q = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * p, n * q))


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + tlt(x))


def small_det(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., d, d], closed forms for d <= 3."""
    d = m.shape[-1]
    if d == 1:
        return m[..., 0, 0]
    if d == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if d == 3:
        return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                                - m[..., 1, 2] * m[..., 2, 1])
                - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                                  - m[..., 1, 2] * m[..., 2, 0])
                + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                                  - m[..., 1, 1] * m[..., 2, 0]))
    return torch.linalg.det(m)


def small_inv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., d, d] via the adjugate for d <= 3, LU otherwise."""
    d = m.shape[-1]
    if d == 1:
        return 1.0 / m
    if d == 2:
        adj = torch.stack([
            torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
            torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1),
        ], -2)
        return adj / small_det(m)[..., None, None]
    if d == 3:
        def c(i1, j1, i2, j2):
            return m[..., i1, j1] * m[..., i2, j2] - m[..., i1, j2] * m[..., i2, j1]
        adj = torch.stack([
            torch.stack([c(1, 1, 2, 2), -c(0, 1, 2, 2), c(0, 1, 1, 2)], -1),
            torch.stack([-c(1, 0, 2, 2), c(0, 0, 2, 2), -c(0, 0, 1, 2)], -1),
            torch.stack([c(1, 0, 2, 1), -c(0, 0, 2, 1), c(0, 0, 1, 1)], -1),
        ], -2)
        return adj / small_det(m)[..., None, None]
    return torch.linalg.inv(m)


def small_solve(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``m @ x = rhs`` for tiny ``m`` (closed-form inverse), LU otherwise."""
    if m.shape[-1] <= 3:
        return small_inv(m) @ rhs
    return torch.linalg.solve(m, rhs)


def small_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of [..., d, d]: unrolled closed forms for d <= 3
    (elementwise ops, differentiable), ``torch.linalg.cholesky`` above."""
    d = mat.shape[-1]
    if d == 1:
        return torch.sqrt(mat)
    if d == 2:
        a = torch.sqrt(mat[..., 0, 0])
        b = mat[..., 1, 0] / a
        c = torch.sqrt(mat[..., 1, 1] - b * b)
        z = torch.zeros_like(a)
        return torch.stack([torch.stack([a, z], -1),
                            torch.stack([b, c], -1)], -2)
    if d == 3:
        l11 = torch.sqrt(mat[..., 0, 0])
        l21 = mat[..., 1, 0] / l11
        l31 = mat[..., 2, 0] / l11
        l22 = torch.sqrt(mat[..., 1, 1] - l21 * l21)
        l32 = (mat[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(mat[..., 2, 2] - l31 * l31 - l32 * l32)
        z = torch.zeros_like(l11)
        return torch.stack([torch.stack([l11, z, z], -1),
                            torch.stack([l21, l22, z], -1),
                            torch.stack([l31, l32, l33], -1)], -2)
    return torch.linalg.cholesky(mat)


def psd_cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of [..., d, d], unrolled over d, whose negative
    pivots clamp to zero instead of giving NaN.

    Exact for PSD input.  For input whose negative part is roundoff it is
    the factor of the nearest-in-pivot PSD matrix: the posterior SSM's
    ``Q_post = P_{k+1} - A Cov(x_k, x_{k+1})`` cancels for near-coincident
    time points (its true value ~dt^3 lies below the roundoff of its O(1)
    operands), and ``torch.linalg.cholesky`` raises on it.  The clamp is a
    double ``where`` (the inner one keeps the primal of ``sqrt`` strictly
    positive), so value and gradient stay finite where a pivot clamps."""
    d = mat.shape[-1]
    lower = [[None] * d for _ in range(d)]
    one = torch.ones((), dtype=mat.dtype, device=mat.device)
    zero = torch.zeros((), dtype=mat.dtype, device=mat.device)
    for j in range(d):
        s = mat[..., j, j]
        for k in range(j):
            s = s - lower[j][k] * lower[j][k]
        pos = s > 0.0
        piv = torch.where(pos, torch.sqrt(torch.where(pos, s, one)), zero)
        lower[j][j] = piv
        nonzero = piv > 0.0
        safe = torch.where(nonzero, piv, one)
        for i in range(j + 1, d):
            s2 = mat[..., i, j]
            for k in range(j):
                s2 = s2 - lower[i][k] * lower[j][k]
            lower[i][j] = torch.where(nonzero, s2 / safe, zero)
    z = torch.zeros_like(mat[..., 0, 0])
    return torch.stack([torch.stack([lower[i][j] if j <= i else z
                                     for j in range(d)], -1)
                        for i in range(d)], -2)


def cholesky_or_zero(mat: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of PSD [..., d, d] blocks; a block whose diagonal is
    all zero maps to the zero factor (deterministic transitions, Q = 0)."""
    d = mat.shape[-1]
    diag = torch.diagonal(mat, dim1=-2, dim2=-1)
    is_zero = torch.all(diag == 0.0, dim=-1)[..., None, None]
    eye = torch.eye(d, dtype=mat.dtype, device=mat.device)
    chol = small_cholesky(torch.where(is_zero, eye, mat))
    return torch.where(is_zero, torch.zeros_like(chol), chol)


def to_delta_time(time_points: torch.Tensor) -> torch.Tensor:
    """Differences of successive time points, [..., N] -> [..., N-1]."""
    return torch.diff(time_points, dim=-1)


def solve_from_chol(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = rhs given the lower-triangular ``chol``, batched."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(tlt(chol), y, upper=True)


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor,
               chol_cov: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, L L^T) over the last axis, batched (shapes
    broadcast)."""
    d = x.shape[-1]
    diff = (x - mean)[..., None]
    chol_cov = chol_cov.expand(diff.shape[:-2] + chol_cov.shape[-2:])
    alpha = torch.linalg.solve_triangular(chol_cov, diff, upper=False)[..., 0]
    maha = torch.sum(alpha ** 2, dim=-1)
    log_det = 2.0 * torch.sum(torch.log(torch.abs(
        torch.diagonal(chol_cov, dim1=-2, dim2=-1))), dim=-1)
    return -0.5 * (maha + log_det + d * math.log(2.0 * math.pi))


def searchsorted(sorted_points: torch.Tensor, points: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """Insertion indices of ``points`` [..., K] into ``sorted_points``
    [..., M] along the last axis, the leading shapes broadcast (as
    ``jnp.searchsorted`` over a batch).  ``side="left"``: the first index
    whose point is >= the new one."""
    if sorted_points.dim() == 1:
        return torch.searchsorted(sorted_points.contiguous(), points.contiguous(),
                                  side=side)
    lead = torch.broadcast_shapes(sorted_points.shape[:-1], points.shape[:-1])
    return torch.searchsorted(
        sorted_points.expand(lead + sorted_points.shape[-1:]).contiguous(),
        points.expand(lead + points.shape[-1:]).contiguous(), side=side)


def take_last(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather ``x`` [..., M] at ``indices`` [..., K] along the last axis,
    the leading shapes broadcast (``take_along_axis(x, indices, -1)``)."""
    lead = torch.broadcast_shapes(x.shape[:-1], indices.shape[:-1])
    return torch.gather(x.expand(lead + x.shape[-1:]), -1,
                        indices.expand(lead + indices.shape[-1:]))


def take_rows(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` [..., M, d] at ``indices`` [..., K] -> [..., K, d], the
    leading shapes broadcast."""
    lead = torch.broadcast_shapes(x.shape[:-2], indices.shape[:-1])
    idx = indices.expand(lead + indices.shape[-1:])[..., None]
    return torch.gather(x.expand(lead + x.shape[-2:]), -2,
                        idx.expand(idx.shape[:-1] + x.shape[-1:]))
