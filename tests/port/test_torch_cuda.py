"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips without a CUDA card.  On the card run them
with

    python -m pytest tests/port/test_torch_cuda.py -q --confcutdir=tests/port

(``--confcutdir`` keeps pytest from loading tests/conftest.py, which needs
JAX; these tests need only torch).
"""
import math

import numpy as np
import pytest
import torch

from markovflow_tpu_torch import training
from markovflow_tpu_torch.convert import gpr_from_numpy
from markovflow_tpu_torch.ops import adjoint as adj
from markovflow_tpu_torch.ops import cuda_scan as ops
from markovflow_tpu_torch.ops.kalman import smoother_elements_tl

pytestmark = pytest.mark.cuda

# float64: the kernels compose in another order than the plain scans;
# measured differences on an H100 were below 1e-12 of the largest entry
F64_TOL = 1e-9


def _problem(d, n, batch, device, dtype=torch.float64, masked=True, seed=0,
             radius=0.95):
    """A random constant SSM with one output and per-step sites.

    F is scaled to spectral radius <= ``radius``: 0.95, as every SDE prior's
    transition is a contraction, or None to keep the draw as it is (1.12
    at d = 5, where the unpivoted Schur inverse of I + C J that the JAX
    package's Pallas kernels use at d >= 4 lost 3.4e-4; the pivoted
    Gauss-Jordan inverse does not)."""
    rng = np.random.default_rng(seed + 10 * d)
    f = 0.8 * np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    if radius is not None:
        f *= radius / max(np.abs(np.linalg.eigvals(f)).max(), radius)
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


def _general(d, n, batch, device, dtype=torch.float64, masked=True, seed=0):
    """Per-step prior steps of a random contraction SSM (F_0 = 0: the prior
    row), one emission row expanded over the steps, and per-step sites."""
    rng = np.random.default_rng(seed + 7 * d)
    f = 0.8 * np.eye(d) + 0.3 * rng.standard_normal(batch + (n, d, d)) / np.sqrt(d)
    f *= 0.95 / np.maximum(np.abs(np.linalg.eigvals(f)).max(-1), 0.95)[..., None, None]
    lq = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    q = lq @ np.swapaxes(lq, -1, -2)
    f[..., 0, :, :] = 0.0
    q[..., 0, :, :] = 1.5 * np.eye(d)
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype, device=device)
    h = t(rng.standard_normal((1, d, 1))).expand(batch + (1, d, n))
    return [t(np.moveaxis(f, -3, -1)), t(0.1 * rng.standard_normal(batch + (d, 1, n))),
            t(np.moveaxis(q, -3, -1)), h, t(rng.standard_normal(batch + (1, 1, n))),
            t(2.0 + rng.random(batch + (1, 1, n))),
            t((rng.random(batch + (1, 1, n)) > 0.3).astype(float) if masked else None)]


def _check_all_kernels(args, gargs, tol, tol_ll):
    """Every kernel against its plain version on one uniform problem and one
    general problem; the smoothers and the adjoint read the plain filter's
    moments, so each kernel is held on its own."""
    fc, cc, qc = args[:3]
    m_k, p_k, ll_k = ops.filter_pipeline_uniform(*args)
    m_p, p_p, ll_p = ops.filter_pipeline_uniform_plain(*args)
    ms_k, ps_k = ops.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
    ms_p, ps_p = ops.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
    gs = torch.linspace(0.5, -1.5, math.prod(m_p.shape[:-3]), dtype=m_p.dtype,
                        device=m_p.device).reshape(m_p.shape[:-3])
    adj_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gs)
    adj_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gs)
    gm_k, gp_k, gll_k = ops.filter_pipeline(*gargs)
    gm_p, gp_p, gll_p = ops.filter_pipeline_plain(*gargs)
    elems = smoother_elements_tl(*gargs[:3], gm_p, gp_p)[:3]
    sm_k, sp_k = ops.smoother_scan(*elems)
    sm_p, sp_p = ops.smoother_scan_plain(*elems)
    torch.cuda.synchronize()
    pairs = [(m_k, m_p), (p_k, p_p), (ms_k, ms_p), (ps_k, ps_p),
             *zip(adj_k, adj_p), (gm_k, gm_p), (gp_k, gp_p), (sm_k, sm_p),
             (sp_k, sp_p)]
    for i, (got, want) in enumerate(pairs):
        assert _rel(got, want) <= tol, (i, _rel(got, want))
    for got, want in ((ll_k, ll_p), (gll_k, gll_p)):
        assert _rel(got, want) <= tol_ll


@pytest.mark.parametrize("n", [1, 37, 4099])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6])
def test_kernels_match_plain_float64(cuda_device, d, n):
    _check_all_kernels(_problem(d, n, (2,), cuda_device),
                       _general(d, n, (2,), cuda_device), F64_TOL, F64_TOL)


def test_unstable_transition_at_d5_float64(cuda_device):
    """The case that the unpivoted Schur inverse failed (3.4e-4): d = 5,
    N = 4099, batch (2,), F of spectral radius 1.12."""
    args = _problem(5, 4099, (2,), cuda_device, radius=None)
    _check_all_kernels(args, _general(5, 4099, (2,), cuda_device), F64_TOL,
                       F64_TOL)


def test_kernels_match_plain_float32(cuda_device):
    """float32 at d = 2, N = 1e5: the two bracketings differ by float32
    roundoff amplified through the compositions' inverses (1e-3 of the
    largest entry; the likelihood, a sum of N terms, to 1e-4).  The
    adjoint's outputs are sums or products of the scan's legs: 1e-3."""
    _check_all_kernels(
        _problem(2, 100_000, (), cuda_device, dtype=torch.float32, masked=False),
        _general(2, 100_000, (), cuda_device, dtype=torch.float32, masked=False),
        1e-3, 1e-4)


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
    gs = torch.ones((), dtype=args[0].dtype, device=cuda_device)
    with pytest.raises(NotImplementedError):
        adj.adjoint_pipeline_uniform(*big, *ops.filter_pipeline_uniform_plain(*big)[:2], gs)


def test_general_pair_raises_above_d6(cuda_device):
    gargs = _general(7, 64, (), cuda_device)
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline(*gargs)
    d7 = torch.eye(7, dtype=torch.float64, device=cuda_device)[..., None].expand(7, 7, 64)
    with pytest.raises(NotImplementedError):
        ops.smoother_scan(d7, d7[:, :1], d7)


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


def _gpr_pair(uniform, device, n=300):
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 10.0, n)
    if not uniform:
        x = x + 0.4 * (x[1] - x[0]) * rng.uniform(-1.0, 1.0, n)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    params = {"kernel.lengthscale": np.asarray(0.0),
              "kernel.variance": np.asarray(0.5),
              "chol_obs_covariance": np.asarray([[0.2]])}
    return [gpr_from_numpy(params, x, y, device=dev, dtype=torch.float64)
            for dev in (device, "cpu")]


@pytest.mark.parametrize("uniform", [True, False])
def test_gradients_on_cuda_match_cpu(cuda_device, uniform):
    """loss().backward() on CUDA runs the adjoint kernel (uniform grid) or
    the general filter and smoother-scan kernels (irregular grid), and gives
    the CPU's Koopman gradients."""
    gpu, cpu = _gpr_pair(uniform, cuda_device)
    assert gpu._uniform_grid == uniform
    before = (adj.adjoint_pipeline_uniform.launches, ops.filter_pipeline.launches,
              ops.smoother_scan.launches)
    loss = gpu.loss()
    loss.backward()
    cpu_loss = cpu.loss()
    cpu_loss.backward()
    after = (adj.adjoint_pipeline_uniform.launches, ops.filter_pipeline.launches,
             ops.smoother_scan.launches)
    want = (1, 0, 0) if uniform else (0, 1, 1)
    assert tuple(a - b for a, b in zip(after, before)) == want
    np.testing.assert_allclose(loss.item(), cpu_loss.item(), rtol=1e-10)
    for name in ("lengthscale", "variance"):
        got = getattr(gpu.kernel, name).unconstrained.grad.cpu().numpy()
        ref = getattr(cpu.kernel, name).unconstrained.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("uniform", [True, False])
def test_fit_on_cuda_matches_cpu(cuda_device, uniform):
    gpu, cpu = _gpr_pair(uniform, cuda_device)
    _, losses = training.fit(gpu, num_steps=3)
    _, cpu_losses = training.fit(cpu, num_steps=3)
    np.testing.assert_allclose(losses.cpu().numpy(), cpu_losses.numpy(), rtol=1e-9)
    assert losses[-1] < losses[0]
