"""Batched small-matrix helpers (counterpart of ``markovflow_tpu/utils/linalg.py``)."""
from __future__ import annotations

import torch

__all__ = ["tlt", "symmetrize", "small_det", "small_inv", "small_solve"]


def tlt(x: torch.Tensor) -> torch.Tensor:
    """Transpose the last two axes."""
    return x.transpose(-1, -2)


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
