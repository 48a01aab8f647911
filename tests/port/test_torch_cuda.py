"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips without a CUDA card.  On the card run them
with

    python -m pytest tests/port/test_torch_cuda.py -q --confcutdir=tests/port

(``--confcutdir`` keeps pytest from loading tests/conftest.py, which needs
JAX; these tests need only torch).
"""
import numpy as np
import pytest
import torch

from markovflow_tpu_torch.convert import gpr_from_numpy
from markovflow_tpu_torch.ops import cuda_scan as ops

pytestmark = pytest.mark.cuda

# float64: the kernels compose in another order than the plain scans;
# measured differences on an H100 were below 1e-12 of the largest entry
F64_TOL = 1e-9


def _problem(d, n, batch, device, dtype=torch.float64, masked=True, seed=0):
    """A random stable constant SSM with one output and per-step sites.

    F is scaled to spectral radius <= 0.95, as every SDE prior's transition
    is a contraction.  With an unstable F (radius 1.12 at d = 5) the
    unpivoted Schur inverse of I + C J, which the kernels share with the
    JAX package's Pallas kernels at d >= 4, loses up to 1e-4 relative in
    float64 for some bracketings (ROADMAP.md, queue 3)."""
    rng = np.random.default_rng(seed + 10 * d)
    f = 0.8 * np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    f *= 0.95 / max(np.abs(np.linalg.eigvals(f)).max(), 0.95)
    lq = 0.2 * rng.standard_normal((d, d)) + np.eye(d)
    arrays = [
        f[..., None],
        0.1 * rng.standard_normal((d, 1, 1)),
        (lq @ lq.T)[..., None],
        rng.standard_normal((d, 1, 1)),
        (1.5 * np.eye(d))[..., None],
        rng.standard_normal((1, d, 1)),
        rng.standard_normal(batch + (1, 1, n)),
        2.0 + rng.random(batch + (1, 1, n)),
        (rng.random(batch + (1, 1, n)) > 0.3).astype(float) if masked else None,
    ]
    return [None if a is None else torch.as_tensor(a, dtype=dtype, device=device)
            for a in arrays]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("n", [1, 37, 4099])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6])
def test_kernels_match_plain_float64(cuda_device, d, n):
    args = _problem(d, n, (2,), cuda_device)
    fc, cc, qc = args[:3]
    m_k, p_k, ll_k = ops.filter_pipeline_uniform(*args)
    m_p, p_p, ll_p = ops.filter_pipeline_uniform_plain(*args)
    ms_k, ps_k = ops.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
    ms_p, ps_p = ops.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
    torch.cuda.synchronize()
    for got, want in ((m_k, m_p), (p_k, p_p), (ms_k, ms_p), (ps_k, ps_p)):
        assert _rel(got, want) <= F64_TOL
    np.testing.assert_allclose(ll_k.cpu().numpy(), ll_p.cpu().numpy(), rtol=F64_TOL)


def test_kernels_match_plain_float32(cuda_device):
    """float32 at d = 2, N = 1e5: the two bracketings differ by float32
    roundoff amplified through the compositions' inverses (1e-3 of the
    largest entry; the likelihood, a sum of N terms, to 1e-4)."""
    args = _problem(2, 100_000, (), cuda_device, dtype=torch.float32,
                    masked=False)
    fc, cc, qc = args[:3]
    m_k, p_k, ll_k = ops.filter_pipeline_uniform(*args)
    m_p, p_p, ll_p = ops.filter_pipeline_uniform_plain(*args)
    ms_k, ps_k = ops.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
    ms_p, ps_p = ops.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
    for got, want in ((m_k, m_p), (p_k, p_p), (ms_k, ms_p), (ps_k, ps_p)):
        assert _rel(got, want) <= 1e-3
    assert _rel(ll_k, ll_p) <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    args = _problem(2, 64, (), cuda_device)
    with pytest.raises(TypeError):
        ops.filter_pipeline_uniform(*[None if a is None else a.half() for a in args])
    with pytest.raises(ValueError):
        ops.filter_pipeline_uniform(args[0].cpu(), *args[1:])
    big = _problem(7, 64, (), cuda_device)
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline_uniform(*big)
    two_out = list(args)
    two_out[5] = torch.ones((2, 2, 1), dtype=args[0].dtype, device=cuda_device)
    two_out[7] = args[7].expand(2, 2, 64)
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline_uniform(*two_out)
    with pytest.raises(NotImplementedError):    # the batch is grid axis y
        ops.filter_pipeline_uniform(*_problem(2, 1, (65536,), cuda_device,
                                              masked=False))
    m_f, p_f, _ = ops.filter_pipeline_uniform(*args)
    with pytest.raises(ValueError):
        ops.smoother_pipeline_uniform(*args[:3], m_f, p_f.transpose(-3, -2))


def test_gpr_requests_run_through_the_kernels(cuda_device):
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 2000)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(x.shape))[:, None]
    params = {"kernel.lengthscale": np.asarray(0.0),
              "kernel.variance": np.asarray(0.5),
              "chol_obs_covariance": np.asarray([[0.2]])}
    gpu = gpr_from_numpy(params, x, y, device=cuda_device, dtype=torch.float64)
    cpu = gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64)
    before = (ops.filter_pipeline_uniform.launches,
              ops.smoother_pipeline_uniform.launches)
    with torch.no_grad():
        loss = gpu.loss()
        means, covs = gpu.kalman.posterior_marginals()
        want_means, want_covs = cpu.kalman.posterior_marginals()
        want_loss = cpu.loss()
    assert (ops.filter_pipeline_uniform.launches - before[0],
            ops.smoother_pipeline_uniform.launches - before[1]) == (2, 1)
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-10)
    np.testing.assert_allclose(means.cpu().numpy(), want_means.numpy(), atol=1e-10)
    np.testing.assert_allclose(covs.cpu().numpy(), want_covs.numpy(), atol=1e-10)


def test_gradient_on_cuda_raises_until_the_adjoint_kernel_lands(cuda_device):
    x = np.linspace(0.0, 10.0, 100)
    params = {"kernel.lengthscale": np.asarray(0.0),
              "kernel.variance": np.asarray(0.5),
              "chol_obs_covariance": np.asarray([[0.2]])}
    gpu = gpr_from_numpy(params, x, np.sin(x)[:, None], device=cuda_device,
                         dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="pallas_adjoint_pipeline_uniform"):
        gpu.loss().backward()
