"""The port's block-tridiagonal algebra against dense numpy and against the
JAX package's (float64, CPU), as tests/unit/test_block_tri_diag.py holds
the JAX one: the same matrices from one numpy seed, within 1e-10 (1e-9
for the sparse inverse and the UDU round trip, products of inverses)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu import block_tri_diag as jb  # noqa: E402
from markovflow_tpu_torch import block_tri_diag as tb  # noqa: E402

ATOL = 1e-10
ATOL_INV = 1e-9


def _spd(n, d, batch=(), seed=0):
    """A well-conditioned symmetric block-tridiagonal matrix's (diag,
    lower) as numpy arrays."""
    rng = np.random.default_rng(seed + 7 * n + d)
    diag = rng.standard_normal(batch + (n, d, d))
    diag = diag @ np.swapaxes(diag, -1, -2) + 5.0 * d * np.eye(d)
    return diag, 0.3 * rng.standard_normal(batch + (n - 1, d, d))


def _pair(n, d, batch=(), seed=0):
    diag, lower = _spd(n, d, batch, seed)
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    return (tb.SymmetricBlockTriDiagonal(t(diag), t(lower)),
            jb.SymmetricBlockTriDiagonal(jnp.asarray(diag), jnp.asarray(lower)))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_cholesky_matches_dense_and_jax(n, d, batch):
    tm, jm = _pair(n, d, batch)
    dense = _np(tm.to_dense())
    np.testing.assert_allclose(dense, _np(jm.to_dense()), atol=0)
    chol = tm.cholesky()
    np.testing.assert_allclose(_np(chol.to_dense()), np.linalg.cholesky(dense), atol=ATOL)
    np.testing.assert_allclose(_np(chol.to_dense()), _np(jm.cholesky().to_dense()), atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_solve_matches_dense(transpose):
    n, d = 5, 3
    tm, jm = _pair(n, d, (2,))
    rhs = np.random.default_rng(1).standard_normal((2, n, d))
    got = _np(tm.cholesky().solve(torch.as_tensor(rhs), transpose_left=transpose))
    want = _np(jm.cholesky().solve(jnp.asarray(rhs), transpose_left=transpose))
    np.testing.assert_allclose(got, want, atol=ATOL)
    dense_l = np.linalg.cholesky(_np(tm.to_dense()))
    mat = np.swapaxes(dense_l, -1, -2) if transpose else dense_l
    np.testing.assert_allclose(got.reshape(2, -1),
                               np.linalg.solve(mat, rhs.reshape(2, -1, 1))[..., 0], atol=ATOL)


def test_abs_log_det():
    tm, jm = _pair(4, 2)
    got = float(tm.cholesky().abs_log_det())
    np.testing.assert_allclose(got, 0.5 * np.linalg.slogdet(_np(tm.to_dense()))[1], atol=ATOL)
    np.testing.assert_allclose(got, float(jm.cholesky().abs_log_det()), atol=ATOL)


def test_block_diagonal_of_inverse():
    n, d = 6, 2
    tm, jm = _pair(n, d)
    chol = tm.cholesky()
    z_diag, z_off = chol.sparse_inverse_band()
    inv = np.linalg.inv(_np(tm.to_dense()))
    for k in range(n):
        np.testing.assert_allclose(_np(z_diag)[k], inv[k * d:(k + 1) * d, k * d:(k + 1) * d],
                                   atol=ATOL_INV)
    for k in range(n - 1):
        np.testing.assert_allclose(_np(z_off)[k],
                                   inv[(k + 1) * d:(k + 2) * d, k * d:(k + 1) * d],
                                   atol=ATOL_INV)
    np.testing.assert_allclose(_np(chol.block_diagonal_of_inverse()),
                               _np(jm.cholesky().block_diagonal_of_inverse()), atol=ATOL_INV)


@pytest.mark.parametrize("d", [2, 3])
def test_upper_diagonal_lower(d):
    n = 5
    tm, jm = _pair(n, d)
    u_off, d_chol = tm.upper_diagonal_lower()
    ju, jd = jm.upper_diagonal_lower()
    np.testing.assert_allclose(_np(u_off), _np(ju), atol=ATOL_INV)
    np.testing.assert_allclose(_np(d_chol), _np(jd), atol=ATOL_INV)
    u = np.eye(n * d)
    dd = np.zeros((n * d, n * d))
    for k in range(n):
        if k < n - 1:
            u[k * d:(k + 1) * d, (k + 1) * d:(k + 2) * d] = _np(u_off)[k]
        dc = _np(d_chol)[k]
        dd[k * d:(k + 1) * d, k * d:(k + 1) * d] = dc @ dc.T
    np.testing.assert_allclose(u @ dd @ u.T, _np(tm.to_dense()), atol=ATOL_INV)


def test_block_mult_vector_add_and_block_diagonal():
    n, d = 5, 3
    tm, jm = _pair(n, d, (2,))
    tm2, jm2 = _pair(n, d, (2,), seed=3)
    vec = np.random.default_rng(2).standard_normal((2, n, d))
    got = _np(tm.block_mult_vector(torch.as_tensor(vec)))
    np.testing.assert_allclose(
        got, (_np(tm.to_dense()) @ vec.reshape(2, -1, 1)).reshape(2, n, d), atol=ATOL)
    np.testing.assert_allclose(got, _np(jm.block_mult_vector(jnp.asarray(vec))), atol=ATOL)
    np.testing.assert_allclose(_np((tm + tm2).to_dense()), _np((jm + jm2).to_dense()),
                               atol=0)
    blocks = np.random.default_rng(4).standard_normal((2, n, d, d))
    np.testing.assert_allclose(
        _np(tm.add_block_diagonal(torch.as_tensor(blocks)).to_dense()),
        _np(jm.add_block_diagonal(jnp.asarray(blocks)).to_dense()), atol=0)
