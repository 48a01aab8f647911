"""The port's plain scan engine against sequential recursions (numpy-free
references in torch float64; no JAX needed)."""
import pytest
import torch

from markovflow_tpu_torch.ops import cuda_scan as ops
from markovflow_tpu_torch.ops.kalman import _inv_tl, _det_tl
from markovflow_tpu_torch.ops.scans import scan_tl


def _affine(acc, new):
    """x_k = F_k x_{k-1} + c_k composed: acc earlier, new later."""
    f1, c1 = acc
    f2, c2 = new
    return ((f2[..., :, :, None, :] * f1[..., None, :, :, :]).sum(-3),
            (f2[..., :, :, None, :] * c1[..., None, :, :, :]).sum(-3) + c2)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 101])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_scan_tl_matches_sequential(n, reverse):
    g = torch.Generator().manual_seed(n)
    f = 0.5 * torch.randn(3, 2, 2, n, generator=g, dtype=torch.float64)
    c = torch.randn(3, 2, 1, n, generator=g, dtype=torch.float64)
    got_f, got_c = scan_tl(_affine, (f, c), reverse=reverse)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc = None
    for k in order:
        e = (f[..., k:k + 1], c[..., k:k + 1])
        acc = e if acc is None else _affine(acc, e)
        # sequential composition, 1e-12: same products, other bracketing
        torch.testing.assert_close(got_f[..., k:k + 1], acc[0], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_c[..., k:k + 1], acc[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d", list(range(1, 13)))
def test_inverse_and_determinant_closed_forms(d):
    """The closed forms and the pivoted Gauss-Jordan elimination that the
    kernels' device functions mirror, against LU (float64,
    well-conditioned matrices)."""
    g = torch.Generator().manual_seed(d)
    a = torch.randn(5, d, d, generator=g, dtype=torch.float64)
    m = a @ a.transpose(-1, -2) + d * torch.eye(d, dtype=torch.float64)
    m_tl = m.movedim(0, -1)
    torch.testing.assert_close(_inv_tl(m_tl).movedim(-1, 0), torch.linalg.inv(m),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(_det_tl(m_tl), torch.linalg.det(m), rtol=1e-12,
                               atol=0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(ValueError):
        ops.filter_pipeline_uniform(meta, meta, meta, meta, meta, meta,
                                    meta, meta)
    with pytest.raises(ValueError):
        ops.smoother_pipeline_uniform(meta, meta, meta, meta, meta)


@pytest.mark.parametrize("d", [4, 5, 6, 7, 9, 12])
def test_pivoted_inverse_with_a_near_singular_leading_block(d):
    """d = 4..12 invert by pivoted Gauss-Jordan.  The leading d // 2 block of
    these matrices is near singular (rank one plus 1e-13), and the unpivoted
    one-level Schur reduction (the JAX package's Pallas ``_inv``) divides by
    its inverse: it loses every digit here, the pivoted form none."""
    k = d // 2
    g = torch.Generator().manual_seed(d)
    m = torch.randn(2, d, d, 5, generator=g, dtype=torch.float64)
    u = torch.randn(2, k, 5, generator=g, dtype=torch.float64)
    m[:, :k, :k] = (u[:, :, None] * u[:, None, :]) + 1e-13 * torch.eye(
        k, dtype=torch.float64)[..., None]
    want = torch.linalg.inv(m.movedim(-1, -3)).movedim(-3, -1)
    got = _inv_tl(m)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9
    det = torch.linalg.det(m.movedim(-1, -3))
    assert float(((_det_tl(m) - det) / det).abs().max()) < 1e-9


@pytest.mark.parametrize("d", [5, 9, 12])
def test_rts_gains_with_a_near_singular_leading_block(d):
    """The RTS element inverts Pp = sym(F P F^T + Q).  With F = I, c = 0,
    Q = 0 every gain is P P^-1 = I, so every smoothed moment is the last
    filtered one.  P is symmetric and well conditioned, but its leading
    d // 2 block is rank one plus 1e-13: the pivoted inverse keeps the
    identity to roundoff of P's condition number (the same check runs the
    CUDA kernels in test_torch_cuda.py at d = 9)."""
    k = d // 2
    g = torch.Generator().manual_seed(d)
    a = torch.randn(d, d, generator=g, dtype=torch.float64)
    p = a + a.T + 2.0 * d * torch.eye(d, dtype=torch.float64)
    u = torch.randn(k, generator=g, dtype=torch.float64)
    p[:k, :k] = torch.outer(u, u) + 1e-13 * torch.eye(k, dtype=torch.float64)
    m_f = torch.randn(d, 1, 16, generator=g, dtype=torch.float64)
    p_f = p[..., None].expand(d, d, 16).contiguous()
    fc = torch.eye(d, dtype=torch.float64)[..., None]
    m_s, p_s = ops.smoother_pipeline_uniform(fc, torch.zeros(d, 1, 1, dtype=torch.float64),
                                             0.0 * fc, m_f, p_f)
    assert float((m_s - m_f[..., -1:]).abs().max() / m_f[..., -1].abs().max()) < 1e-9
    assert float((p_s - p_f[..., -1:]).abs().max() / p.abs().max()) < 1e-9
