"""Block-tridiagonal linear algebra (counterpart of
``markovflow_tpu/block_tri_diag.py``, the part the natural-gradient family
needs).

A symmetric block-tridiagonal matrix over N states of dim d is held
block-first, ``(diag [..., N, d, d], lower [..., N-1, d, d])`` with
``lower[k]`` the block (k+1, k).  The sequential recursions (block Cholesky,
substitution, the sparse inverse, the UDU factorisation) are Python loops
over the blocks, the JAX package's ``engine="scan"``: O(N) launches, for
small N and for the sequential natural-gradient engine.  The cyclic
reduction (``cr_*``), the band layouts and the host C++ engine
(``engine="native"``) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from .utils.linalg import symmetrize, tlt

__all__ = ["SymmetricBlockTriDiagonal", "LowerTriangularBlockTriDiagonal"]


def _solve_lower(l, rhs):
    """L^-1 rhs for lower-triangular l [..., d, d], rhs [..., d, m]."""
    return torch.linalg.solve_triangular(l, rhs, upper=False)


def _solve_upper(u, rhs):
    return torch.linalg.solve_triangular(u, rhs, upper=True)


def _stack(blocks, empty):
    """The blocks stacked on axis -3, or ``empty`` (N - 1 = 0 blocks)."""
    return torch.stack(blocks, dim=-3) if blocks else empty


def _mv(m, v):
    return (m * v[..., None, :]).sum(-1)


def _mtv(m, v):
    """m^T v over the last two axes of m."""
    return (m * v[..., :, None]).sum(-2)


class _BlockTriDiagonal:
    def __init__(self, diag: torch.Tensor, lower: Optional[torch.Tensor] = None):
        self.diag = diag
        self.lower = lower
        if lower is not None:
            assert lower.shape[-1] == diag.shape[-1]
            assert lower.shape[-3] == diag.shape[-3] - 1

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    @property
    def num_blocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def batch_shape(self):
        return tuple(self.diag.shape[:-3])

    @property
    def outer_dim(self) -> int:
        return self.num_blocks * self.block_dim

    def to_dense(self) -> torch.Tensor:
        """[..., N d, N d] (tests and tiny problems only)."""
        n, d = self.num_blocks, self.block_dim
        out = self.diag.new_zeros(self.batch_shape + (n * d, n * d))
        for k in range(n):
            out[..., k * d:(k + 1) * d, k * d:(k + 1) * d] = self.diag[..., k, :, :]
        if self.lower is not None:
            for k in range(n - 1):
                blk = self.lower[..., k, :, :]
                out[..., (k + 1) * d:(k + 2) * d, k * d:(k + 1) * d] = blk
                if isinstance(self, SymmetricBlockTriDiagonal):
                    out[..., k * d:(k + 1) * d, (k + 1) * d:(k + 2) * d] = tlt(blk)
        return out

    def block_mult_vector(self, vec: torch.Tensor) -> torch.Tensor:
        """The product with a block vector [..., N, d] -> [..., N, d]."""
        out = _mv(self.diag, vec)
        if self.lower is not None:
            lo = _mv(self.lower, vec[..., :-1, :])
            out = torch.cat([out[..., :1, :], out[..., 1:, :] + lo], dim=-2)
            if isinstance(self, SymmetricBlockTriDiagonal):
                up = _mtv(self.lower, vec[..., 1:, :])
                out = torch.cat([out[..., :-1, :] + up, out[..., -1:, :]], dim=-2)
        return out


class LowerTriangularBlockTriDiagonal(_BlockTriDiagonal):
    """Block-bidiagonal lower-triangular matrix (a block Cholesky factor)."""

    def solve(self, rhs: torch.Tensor, transpose_left: bool = False) -> torch.Tensor:
        """L x = rhs (or L^T x = rhs) for rhs [..., N, d], by block
        substitution."""
        col = rhs[..., None]
        if self.lower is None:
            if transpose_left:
                return _solve_upper(tlt(self.diag), col)[..., 0]
            return _solve_lower(self.diag, col)[..., 0]
        n = self.num_blocks
        xs = [None] * n
        if not transpose_left:
            xs[0] = _solve_lower(self.diag[..., 0, :, :], col[..., 0, :, :])[..., 0]
            for k in range(1, n):
                resid = rhs[..., k, :] - _mv(self.lower[..., k - 1, :, :], xs[k - 1])
                xs[k] = _solve_lower(self.diag[..., k, :, :], resid[..., None])[..., 0]
        else:
            xs[-1] = _solve_upper(tlt(self.diag[..., -1, :, :]), col[..., -1, :, :])[..., 0]
            for k in range(n - 2, -1, -1):
                resid = rhs[..., k, :] - _mtv(self.lower[..., k, :, :], xs[k + 1])
                xs[k] = _solve_upper(tlt(self.diag[..., k, :, :]), resid[..., None])[..., 0]
        return torch.stack(xs, dim=-2)

    def abs_log_det(self) -> torch.Tensor:
        """log |det L|."""
        diags = torch.diagonal(self.diag, dim1=-2, dim2=-1)
        return torch.log(torch.abs(diags)).sum((-1, -2))

    def block_diagonal_of_inverse(self) -> torch.Tensor:
        """The block diagonal [..., N, d, d] of (L L^T)^-1."""
        return self.sparse_inverse_band()[0]

    def sparse_inverse_band(self):
        """The band (diag, subdiag) of Z = (L L^T)^-1, by the backward
        Takahashi recursion:
          Z_NN = D_N^-T D_N^-1,  Z_{k+1,k} = -Z_{k+1,k+1} L_{k+1,k} D_k^-1,
          Z_kk = D_k^-T D_k^-1 - Z_{k+1,k}^T L_{k+1,k} D_k^-1."""
        eye = torch.eye(self.block_dim, dtype=self.diag.dtype,
                        device=self.diag.device).expand(self.diag.shape)
        d_inv = _solve_lower(self.diag, eye)
        dtd = tlt(d_inv) @ d_inv
        if self.lower is None:
            return dtd, None
        n = self.num_blocks
        z_diag, z_off = [None] * n, [None] * (n - 1)
        z_diag[-1] = z_next = dtd[..., -1, :, :]
        for k in range(n - 2, -1, -1):
            ld = self.lower[..., k, :, :] @ d_inv[..., k, :, :]
            z_off[k] = -(z_next @ ld)
            z_diag[k] = dtd[..., k, :, :] - tlt(z_off[k]) @ ld
            z_next = symmetrize(z_diag[k])   # the recursion carries it symmetrised
        return torch.stack(z_diag, dim=-3), _stack(z_off, self.lower)


class SymmetricBlockTriDiagonal(_BlockTriDiagonal):
    """Symmetric block-tridiagonal matrix (an SSM precision)."""

    def __add__(self, other: "SymmetricBlockTriDiagonal") -> "SymmetricBlockTriDiagonal":
        if other.lower is None:
            lower = self.lower
        elif self.lower is None:
            lower = other.lower
        else:
            lower = self.lower + other.lower
        return SymmetricBlockTriDiagonal(self.diag + other.diag, lower)

    def add_block_diagonal(self, blocks: torch.Tensor) -> "SymmetricBlockTriDiagonal":
        return SymmetricBlockTriDiagonal(self.diag + blocks, self.lower)

    def cholesky(self) -> LowerTriangularBlockTriDiagonal:
        """Block Cholesky L (P = L L^T), block-bidiagonal:
        L_0 = chol(P_00); C_k = P_{k,k-1} L_{k-1}^-T,
        L_k = chol(P_kk - C_k C_k^T)."""
        if self.lower is None:
            return LowerTriangularBlockTriDiagonal(torch.linalg.cholesky(self.diag))
        n = self.num_blocks
        ls, cs = [torch.linalg.cholesky(self.diag[..., 0, :, :])], []
        for k in range(1, n):
            c_k = tlt(_solve_lower(ls[-1], tlt(self.lower[..., k - 1, :, :])))
            s_k = self.diag[..., k, :, :] - c_k @ tlt(c_k)
            ls.append(torch.linalg.cholesky(symmetrize(s_k)))
            cs.append(c_k)
        return LowerTriangularBlockTriDiagonal(torch.stack(ls, dim=-3),
                                               _stack(cs, self.lower))

    def upper_diagonal_lower(self):
        """P = U D U^T with U unit upper block-bidiagonal and D block
        diagonal, by the backward recursion
          D_N = P_NN,  D_k = P_kk - P_{k+1,k}^T D_{k+1}^-1 P_{k+1,k},
          U_k = P_{k+1,k}^T D_{k+1}^-1 (the block (k, k+1) of U).
        Returns (u_off [..., N-1, d, d], d_chol [..., N, d, d]), the
        Cholesky factors of the D blocks."""
        if self.lower is None:
            return None, torch.linalg.cholesky(self.diag)
        n = self.num_blocks
        d_all, u_offs = [None] * n, [None] * (n - 1)
        d_all[-1] = self.diag[..., -1, :, :]
        for k in range(n - 2, -1, -1):
            chol_next = torch.linalg.cholesky(symmetrize(d_all[k + 1]))
            y = _solve_lower(chol_next, self.lower[..., k, :, :])
            d_all[k] = self.diag[..., k, :, :] - tlt(y) @ y
            u_offs[k] = tlt(_solve_upper(tlt(chol_next), y))
        d_chol = torch.linalg.cholesky(symmetrize(torch.stack(d_all, dim=-3)))
        return _stack(u_offs, self.lower), d_chol
