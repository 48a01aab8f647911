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

import chip_smoke
from markovflow_tpu_torch import kalman_filter as kf
from markovflow_tpu_torch import training
from markovflow_tpu_torch.convert import gpr_from_numpy
from markovflow_tpu_torch.emission_model import EmissionModel
from markovflow_tpu_torch.ops import adjoint as adj
from markovflow_tpu_torch.ops import cuda_scan as ops
from markovflow_tpu_torch.ops import kalman
from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                             smoother_elements_tl)

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
    general problem (the uniform adjoint up to its largest state dim, 6);
    the smoothers and the adjoints read the plain filter's moments and the
    filter scan the general problem's elements, so each kernel is held on
    its own."""
    fc, cc, qc = args[:3]
    m_k, p_k, ll_k = ops.filter_pipeline_uniform(*args)
    m_p, p_p, ll_p = ops.filter_pipeline_uniform_plain(*args)
    ms_k, ps_k = ops.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
    ms_p, ps_p = ops.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
    adj_k = adj_p = ()
    if fc.shape[-3] <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM:
        gs = torch.linspace(0.5, -1.5, math.prod(m_p.shape[:-3]), dtype=m_p.dtype,
                            device=m_p.device).reshape(m_p.shape[:-3])
        adj_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gs)
        adj_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gs)
    gm_k, gp_k, gll_k = ops.filter_pipeline(*gargs)
    gm_p, gp_p, gll_p = ops.filter_pipeline_plain(*gargs)
    elems = smoother_elements_tl(*gargs[:3], gm_p, gp_p)[:3]
    sm_k, sp_k = ops.smoother_scan(*elems)
    sm_p, sp_p = ops.smoother_scan_plain(*elems)
    felems = make_filter_elements_tl(*gargs[:6])
    fs_k, fs_p = ops.filter_scan(*felems), ops.filter_scan_plain(*felems)
    gs = torch.linspace(0.5, -1.5, math.prod(gm_p.shape[:-3]), dtype=gm_p.dtype,
                        device=gm_p.device).reshape(gm_p.shape[:-3])
    gadj_k = adj.adjoint_pipeline(*gargs, gm_p, gp_p, gs)
    gadj_p = adj.adjoint_pipeline_plain(*gargs, gm_p, gp_p, gs)
    torch.cuda.synchronize()
    pairs = [(m_k, m_p), (p_k, p_p), (ms_k, ms_p), (ps_k, ps_p),
             *zip(adj_k, adj_p), (gm_k, gm_p), (gp_k, gp_p), (sm_k, sm_p),
             (sp_k, sp_p), *zip(fs_k, fs_p), *zip(gadj_k, gadj_p)]
    for i, (got, want) in enumerate(pairs):
        assert _rel(got, want) <= tol, (i, _rel(got, want))
    for got, want in ((ll_k, ll_p), (gll_k, gll_p)):
        assert _rel(got, want) <= tol_ll


@pytest.mark.parametrize("n", [1, 37, 4099])
@pytest.mark.parametrize("d", list(range(1, ops.MAX_STATE_DIM + 1)))
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


def test_kernels_match_plain_float32_at_d9(cuda_device):
    """float32 at d = 9 (the state dim of a Sum of three Matern52), N = 1e5,
    through the d = 7..12 kernels, at the tolerances of the d = 2 case."""
    _check_all_kernels(
        _problem(9, 100_000, (), cuda_device, dtype=torch.float32, masked=False),
        _general(9, 100_000, (), cuda_device, dtype=torch.float32, masked=False),
        1e-3, 1e-4)


@pytest.mark.parametrize("d, n, batch, masked, dtype", [
    # 2,084 warp totals: five levels of pass 2 (float32:
    # test_kernels_match_plain_float32_at_d9)
    (9, 100_000, (), False, torch.float64),
    # seven totals: a full and a partial group
    (9, 50, (), False, torch.float64), (9, 50, (), False, torch.float32),
    (7, 4099, (3,), True, torch.float64), (7, 4099, (3,), True, torch.float32),
    (12, 4099, (3,), True, torch.float64), (12, 4099, (3,), True, torch.float32),
])
def test_wide_kernels_across_the_levels_of_pass_2(cuda_device, d, n, batch, masked, dtype):
    """The d = 7..12 kernels (csrc/wide_scan.cuh, csrc/general_adjoint.cuh)
    at the shapes of the multi-level scan of the warp totals, against their
    plain versions: float64 within F64_TOL, float32 at the tolerances of
    test_kernels_match_plain_float32."""
    tol, tol_ll = (F64_TOL, F64_TOL) if dtype == torch.float64 else (1e-3, 1e-4)
    _check_all_kernels(_problem(d, n, batch, cuda_device, dtype=dtype, masked=masked),
                       _general(d, n, batch, cuda_device, dtype=dtype, masked=masked),
                       tol, tol_ll)


@pytest.mark.parametrize("d, n, batch, dtype", [
    # 8 steps a warp at these N, chunks of 4 (float32) or 2 (float64) steps:
    # one step; a run that ends inside a chunk; a second warp of one step;
    # six and seven warps
    *[(9, n, (), dtype) for n in (1, 5, 9, 47, 50)
      for dtype in (torch.float64, torch.float32)],
    # the most shared memory a warp
    (12, 50, (3,), torch.float64),
])
def test_wide_kernels_at_the_chunk_edges_of_the_staged_passes(cuda_device, d, n, batch,
                                                              dtype):
    """The staged passes of the filter scan and the smoothers (chunks of
    steps fetched and stored a chunk at a time, moments-only pass 3) where
    a warp's run ends inside a chunk or N is below a chunk, against the
    plain versions."""
    tol, tol_ll = (F64_TOL, F64_TOL) if dtype == torch.float64 else (1e-3, 1e-4)
    _check_all_kernels(_problem(d, n, batch, cuda_device, dtype=dtype, masked=False),
                       _general(d, n, batch, cuda_device, dtype=dtype, masked=False),
                       tol, tol_ll)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_general_pair_at_the_run_warp_and_block_edges(cuda_device, n, d, dtype):
    """The d <= 6 general filter and Koopman backward where a thread's run
    of steps (8 at d <= 2), a warp's (256) or a block's (2,048 in float32)
    ends, and across those of d = 3 and 6, with batch (3,), a mask and the
    emission row and lam expanded over the steps (stride 0, as GPR passes
    them), against their plain versions: float64 within F64_TOL, float32 at
    the tolerances of test_kernels_match_plain_float32."""
    tol, tol_ll = (F64_TOL, F64_TOL) if dtype == torch.float64 else (1e-3, 1e-4)
    gargs = _general(d, n, (3,), cuda_device, dtype=dtype)
    gargs[5] = gargs[5][..., :1].expand(gargs[5].shape)  # lam, stride 0
    m_k, p_k, ll_k = ops.filter_pipeline(*gargs)
    m_p, p_p, ll_p = ops.filter_pipeline_plain(*gargs)
    gs = torch.linspace(0.5, -1.5, 3, dtype=dtype, device=cuda_device)
    got = adj.adjoint_pipeline(*gargs, m_p, p_p, gs)
    want = adj.adjoint_pipeline_plain(*gargs, m_p, p_p, gs)
    torch.cuda.synchronize()
    for g, w in [(m_k, m_p), (p_k, p_p), *zip(got, want)]:
        assert _rel(g, w) <= tol, _rel(g, w)
    assert _rel(ll_k, ll_p) <= tol_ll


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_uniform_filter_at_the_run_warp_and_block_edges(cuda_device, n, d, dtype):
    """The d <= 6 uniform filter (staged sites, stored in-block prefix,
    moments-only pass 3) where a thread's run of steps (8 at d <= 2), a
    warp's (256) or a block's (2,048 in float32) ends, and across those of
    d = 3 and 6, with batch (3,), a mask and lam expanded over the steps
    (stride 0, as GPR passes it), against its plain version: float64 within
    F64_TOL, float32 at the tolerances of test_kernels_match_plain_float32."""
    tol, tol_ll = (F64_TOL, F64_TOL) if dtype == torch.float64 else (1e-3, 1e-4)
    args = _problem(d, n, (3,), cuda_device, dtype=dtype)
    args[7] = args[7][..., :1].expand(args[7].shape)  # lam, stride 0
    got = ops.filter_pipeline_uniform(*args)
    want = ops.filter_pipeline_uniform_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) <= tol, _rel(g, w)
    assert _rel(got[2], want[2]) <= tol_ll


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_uniform_smoother_and_backward_at_the_run_warp_and_block_edges(cuda_device, n, d,
                                                                        dtype):
    """The d <= 6 uniform smoother and Koopman backward (staged steps, stored
    in-block suffix, output passes that carry only the g and L legs) where a
    thread's run of steps (8 at d <= 2), a warp's (256) or a block's (2,048)
    ends, and across those of d = 3 and 6, with batch (3,), a mask and lam
    expanded over the steps (stride 0, as GPR passes it), from the plain
    filter's moments, against their plain versions: float64 within F64_TOL,
    float32 within 1e-3; the backward with and without the site gradients,
    its sums against the magnitudes of their terms
    (chip_smoke.adjoint_sum_scales)."""
    tol = F64_TOL if dtype == torch.float64 else 1e-3
    args = _problem(d, n, (3,), cuda_device, dtype=dtype)
    args[7] = args[7][..., :1].expand(args[7].shape)  # lam, stride 0
    m_p, p_p, _ = ops.filter_pipeline_uniform_plain(*args)
    gs = torch.linspace(0.5, -1.5, 3, dtype=dtype, device=cuda_device)
    got_s = ops.smoother_pipeline_uniform(*args[:3], m_p, p_p)
    want_s = ops.smoother_pipeline_uniform_plain(*args[:3], m_p, p_p)
    got = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gs)
    got0 = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gs, site_grads=False)
    want = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gs)
    scales = chip_smoke.adjoint_sum_scales(adj, args, m_p, p_p, gs) + (None, None)
    torch.cuda.synchronize()
    assert got0[6] is None and got0[7] is None
    for g, w in zip(got_s, want_s):
        assert _rel(g, w) <= tol, _rel(g, w)
    for out in (got, got0[:6]):
        for i, (g, w, sc) in enumerate(zip(out, want, scales)):
            err = chip_smoke.rel_diff(g, w, sc)
            assert err <= tol, (i, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_filter_scan_at_the_run_warp_and_block_edges(cuda_device, n, d, dtype):
    """The d <= 6 filter scan (staged elements to d = 3, read where they lie
    at d = 4 and 6) at the run, warp and block edges, batch (3,), on random
    prebuilt elements (nonzero A and J at step 0), against its plain
    version: float64 within F64_TOL, float32 within 1e-3."""
    tol = F64_TOL if dtype == torch.float64 else 1e-3
    elems = chip_smoke.random_filter_elements(d, n, (3,), dtype, cuda_device)
    got, want = ops.filter_scan(*elems), ops.filter_scan_plain(*elems)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol, _rel(g, w)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_smoother_scan_at_the_run_warp_and_block_edges(cuda_device, n, d, dtype):
    """The d <= 6 smoother scan (stored in-block suffix, moments-only pass 3;
    passes 1 and 3 staged to d = 4, 160 threads a block there in float64,
    and read where the steps lie at d = 5 and 6) at the run, warp and block
    edges, batch (3,), on the RTS elements of chip_smoke.general_problem's
    problem and on random prebuilt elements, against its plain version:
    float64 within chip_smoke.TOL_F64, float32 within
    chip_smoke.TOL_F32_MOMENTS."""
    chip_smoke.smoother_scan_edges_case(ops, n, d, dtype)


@pytest.mark.parametrize("d, n, batch", [(2, 4099, (3,)), (3, 4099, (3,)), (6, 4099, (3,)),
                                         (7, 4099, (3,)), (9, 4099, (3,)),
                                         (12, 4099, (3,)), (9, 47, ())])
def test_filter_scan_of_random_elements(cuda_device, d, n, batch):
    """The filter scan's pass 3 carries only the b and C legs of the prefix,
    which hold for any prebuilt elements: random A, C, J, b, eta at every
    step, float64, against the plain scan."""
    elems = chip_smoke.random_filter_elements(d, n, batch, torch.float64, cuda_device)
    got, want = ops.filter_scan(*elems), ops.filter_scan_plain(*elems)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= F64_TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_kernels_with_sparse_sites(cuda_device, dtype):
    """lam = 0 and nu = 0 at the masked steps (KalmanFilterWithSparseSites'
    sites), d = 9: the rank-one site step degenerates to a pure prediction."""
    args = _problem(9, 4099, (2,), cuda_device, dtype=dtype)
    gargs = _general(9, 4099, (2,), cuda_device, dtype=dtype)
    for a in (args, gargs):
        a[-3], a[-2] = a[-3] * a[-1], a[-2] * a[-1]
    tol, tol_ll = (F64_TOL, F64_TOL) if dtype == torch.float64 else (1e-3, 1e-4)
    _check_all_kernels(args, gargs, tol, tol_ll)


def _near_singular_moments(d, n, device):
    """Symmetric, well-conditioned P [d, d] whose leading d // 2 block is
    rank one plus 1e-13 (as test_pivoted_inverse_with_a_near_singular_leading_block
    builds it), repeated over n steps, and random means."""
    k = d // 2
    g = torch.Generator().manual_seed(d)
    a = torch.randn(d, d, generator=g, dtype=torch.float64)
    p = a + a.T + 2.0 * d * torch.eye(d, dtype=torch.float64)
    u = torch.randn(k, generator=g, dtype=torch.float64)
    p[:k, :k] = torch.outer(u, u) + 1e-13 * torch.eye(k, dtype=torch.float64)
    m = torch.randn(d, 1, n, generator=g, dtype=torch.float64)
    return (m.to(device), p[..., None].expand(d, d, n).contiguous().to(device))


def test_pivoted_inverse_with_a_near_singular_leading_block_at_d9(cuda_device):
    """The RTS element inverts Pp = sym(F P F^T + Q); with F = I, Q = 0 and
    c = 0 every gain is P P^-1 = I, so the smoothed moments of every step
    are the last filtered ones.  The leading 4 x 4 block of P is near
    singular: the device's pivoted Gauss-Jordan inverse (d = 7..12) keeps
    every step exact to roundoff of P's condition number."""
    d, n = 9, 64
    m_f, p_f = _near_singular_moments(d, n, cuda_device)
    fc = torch.eye(d, dtype=torch.float64, device=cuda_device)[..., None]
    zeros = torch.zeros((d, 1, 1), dtype=torch.float64, device=cuda_device)
    m_s, p_s = ops.smoother_pipeline_uniform(fc, zeros, 0.0 * fc, m_f, p_f)
    torch.cuda.synchronize()
    assert _rel(m_s, m_f[..., -1:].expand_as(m_s)) < 1e-9
    assert _rel(p_s, p_f[..., -1:].expand_as(p_s)) < 1e-9


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    args = _problem(2, 64, (), cuda_device)
    with pytest.raises(TypeError):
        ops.filter_pipeline_uniform(*[None if a is None else a.half() for a in args])
    with pytest.raises(ValueError):
        ops.filter_pipeline_uniform(args[0].cpu(), *args[1:])
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline_uniform(*_problem(13, 64, (), cuda_device))
    big = _problem(7, 64, (), cuda_device)
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
    with pytest.raises(NotImplementedError):   # the uniform adjoint: d <= 6
        adj.adjoint_pipeline_uniform(*big, *ops.filter_pipeline_uniform_plain(*big)[:2], gs)
    m13 = torch.zeros((13, 1, 64), dtype=torch.float64, device=cuda_device)
    p13 = torch.eye(13, dtype=torch.float64, device=cuda_device)[..., None].expand(13, 13, 64)
    with pytest.raises(NotImplementedError):
        ops.smoother_pipeline_uniform(p13[..., :1], m13[..., :1], p13[..., :1], m13,
                                      p13.contiguous())


def test_general_pair_raises_above_d12(cuda_device):
    gargs = _general(13, 64, (), cuda_device)
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline(*gargs)
    d13 = torch.eye(13, dtype=torch.float64, device=cuda_device)[..., None].expand(13, 13, 64)
    with pytest.raises(NotImplementedError):
        ops.smoother_scan(d13, d13[:, :1], d13)
    with pytest.raises(NotImplementedError):
        ops.filter_scan(d13, d13[:, :1], d13, d13, d13[:, :1])
    gs = torch.ones((), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        adj.adjoint_pipeline(*gargs, d13[:, :1], d13, gs)


def test_filter_scan_raises_on_a_second_column(cuda_device):
    felems = make_filter_elements_tl(*_general(2, 64, (), cuda_device)[:6])
    two = [x.expand(x.shape[:-2] + (2, x.shape[-1])) if x.shape[-2] == 1 else x
           for x in felems]
    with pytest.raises(NotImplementedError):
        ops.filter_scan(*two)


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
    """loss().backward() on CUDA runs the uniform filter and adjoint kernels
    (uniform grid) or the general filter and general adjoint kernels
    (irregular grid), and gives the CPU's Koopman gradients."""
    gpu, cpu = _gpr_pair(uniform, cuda_device)
    assert gpu._uniform_grid == uniform
    before = _launches()
    loss = gpu.loss()
    loss.backward()
    got = {k: v - before[k] for k, v in _launches().items()}
    cpu_loss = cpu.loss()
    cpu_loss.backward()
    want = dict.fromkeys(got, 0)
    want.update({"filter_pipeline_uniform": 1, "adjoint_pipeline_uniform": 1}
                if uniform else {"filter_pipeline": 1, "adjoint_pipeline": 1})
    assert got == want
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


#: the composite model: Matern52(0.5, 1) + Matern52(2, 0.5) + Matern52(8, 0.25)
D9 = ((0.5, 1.0), (2.0, 0.5), (8.0, 0.25))


def _d9_pair(uniform, device, n=300):
    """The d = 9 Sum-of-three-Matern52 GPR on CUDA and on the CPU (float64),
    from one set of parameters."""
    from markovflow_tpu_torch.utils.bijectors import positive

    rng = np.random.default_rng(2)
    x = np.linspace(0.0, 10.0, n)
    if not uniform:
        x = x + 0.4 * (x[1] - x[0]) * rng.uniform(-1.0, 1.0, n)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    params = {"chol_obs_covariance": np.asarray([[0.2]])}
    for i, (ell, var) in enumerate(D9):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    return [gpr_from_numpy(params, x, y, device=dev, dtype=torch.float64,
                           kernel=("Matern52",) * 3) for dev in (device, "cpu")]


def _launches():
    return {"filter_pipeline_uniform": ops.filter_pipeline_uniform.launches,
            "smoother_pipeline_uniform": ops.smoother_pipeline_uniform.launches,
            "adjoint_pipeline_uniform": adj.adjoint_pipeline_uniform.launches,
            "filter_pipeline": ops.filter_pipeline.launches,
            "smoother_scan": ops.smoother_scan.launches,
            "filter_scan": ops.filter_scan.launches,
            "adjoint_pipeline": adj.adjoint_pipeline.launches}


@pytest.mark.parametrize("uniform", [True, False])
def test_d9_loss_backward_and_marginals_on_cuda(cuda_device, uniform):
    """d = 9: loss().backward() takes the general filter and general adjoint
    kernels on both grids (above d = 6 the uniform grid's prior steps are
    materialised, as in the JAX package); posterior_marginals() takes the
    uniform filter and smoother on a uniform grid, the general filter and
    smoother scan otherwise.  Values and gradients are the CPU's."""
    gpu, cpu = _d9_pair(uniform, cuda_device)
    assert gpu.kernel.state_dim == 9 and gpu._uniform_grid == uniform
    before = _launches()
    loss = gpu.loss()
    loss.backward()
    with torch.no_grad():
        means, covs = gpu.kalman.posterior_marginals()
    got = {k: v - before[k] for k, v in _launches().items()}
    want = {"filter_pipeline_uniform": int(uniform),
            "smoother_pipeline_uniform": int(uniform),
            "adjoint_pipeline_uniform": 0,
            "filter_pipeline": 1 + int(not uniform),
            "smoother_scan": int(not uniform),
            "filter_scan": 0,
            "adjoint_pipeline": 1}
    assert got == want
    cpu_loss = cpu.loss()
    cpu_loss.backward()
    with torch.no_grad():
        want_means, want_covs = cpu.kalman.posterior_marginals()
    np.testing.assert_allclose(loss.item(), cpu_loss.item(), rtol=1e-10)
    np.testing.assert_allclose(means.cpu().numpy(), want_means.numpy(), atol=1e-10)
    np.testing.assert_allclose(covs.cpu().numpy(), want_covs.numpy(), atol=1e-10)
    for i in range(3):
        for name in ("lengthscale", "variance"):
            g = getattr(gpu.kernel.kernels[i], name).unconstrained.grad.cpu().numpy()
            r = getattr(cpu.kernel.kernels[i], name).unconstrained.grad.numpy()
            np.testing.assert_allclose(g, r, rtol=1e-9, err_msg=f"{i} {name}")


@pytest.mark.parametrize("d", [2, 9])
def test_ops_filter_api_runs_the_filter_scan_kernel(cuda_device, d):
    """ops.kalman.parallel_filter launches the filter-scan kernel once and
    gives the CPU's filtered moments, which the general filter kernel gives
    too (one function, two kernels); parallel_smoother launches the
    smoother scan."""
    F, c, Q, H, nu, lam, _ = _general(d, 500, (2,), cuda_device, masked=False)
    tm = [x.movedim(-1, -3) for x in (F, Q, H, lam)]
    args = (tm[0], c[..., 0, :].movedim(-1, -2), tm[1], tm[2],
            nu[..., 0, :].movedim(-1, -2), tm[3])
    before = _launches()
    m_f, p_f = kalman.parallel_filter(kalman.make_filter_elements(*args))
    m_s, p_s, _ = kalman.parallel_smoother(args[0], args[1], args[2], m_f, p_f)
    got = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    assert got == {"filter_scan": 1, "smoother_scan": 1}
    cpu = [x.cpu() for x in args]
    want_m, want_p = kalman.parallel_filter(kalman.make_filter_elements(*cpu))
    want_ms, want_ps, _ = kalman.parallel_smoother(cpu[0], cpu[1], cpu[2], want_m,
                                                   want_p)
    gm, gp, _ = ops.filter_pipeline(F, c, Q, H, nu, lam)
    for got_x, want_x in ((m_f, want_m), (p_f, want_p), (m_s, want_ms), (p_s, want_ps),
                          (gm[..., 0, :].movedim(-1, -2), want_m),
                          (gp.movedim(-1, -3), want_p)):
        assert _rel(got_x.cpu(), want_x) <= F64_TOL


def test_sparse_sites_gradients_on_cuda_match_cpu(cuda_device):
    """KalmanFilterWithSparseSites with 30% of a jittered grid unobserved:
    -log_likelihood().backward() runs the general filter and the general
    adjoint kernel once each, with the mask, and gives the CPU's value and
    gradients (prior hyperparameters and the sites' naturals)."""
    from markovflow_tpu_torch import kernels
    rng = np.random.default_rng(3)
    n = 400
    x = np.linspace(0.0, 10.0, n)
    x = x + 0.4 * (x[1] - x[0]) * rng.uniform(-1.0, 1.0, n)
    idx = np.sort(rng.choice(n, int(0.7 * n), replace=False))
    y = np.sin(2.0 * x[idx]) + 0.2 * rng.standard_normal(idx.size)

    def run(device):
        k = kernels.Matern32(lengthscale=0.7, variance=1.3, dtype=torch.float64,
                             device=device)
        tp = torch.as_tensor(x, device=device)
        nat1 = torch.as_tensor(y[:, None] / 0.04, device=device).requires_grad_(True)
        nat2 = torch.full((idx.size, 1, 1), -0.5 / 0.04, dtype=torch.float64,
                          device=device).requires_grad_(True)
        f = kf.KalmanFilterWithSparseSites(
            k.generate_emission_model(tp), kf.UnivariateGaussianSitesNat(nat1, nat2),
            n, torch.as_tensor(idx, device=device), None,
            prior_tl=k.prior_arrays_tl(tp))
        loss = -f.log_likelihood()
        loss.backward()
        grads = [k.lengthscale.unconstrained.grad, k.variance.unconstrained.grad,
                 nat1.grad, nat2.grad]
        return loss.item(), [g.cpu().numpy() for g in grads]

    before = _launches()
    val, grads = run(cuda_device)
    got = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    assert got == {"filter_pipeline": 1, "adjoint_pipeline": 1}
    want_val, want_grads = run("cpu")
    np.testing.assert_allclose(val, want_val, rtol=1e-10)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the posterior and prediction path
# ---------------------------------------------------------------------------
POSTERIOR_KERNELS = {1: "Matern12", 2: "Matern32", 3: "Matern52", 6: ("Matern52", "Matern52")}


def _posterior_model(d, n, uniform, dtype, device):
    """A GPR of state dim d on n points of [0, 10] (jittered unless
    ``uniform``), and new points: inner, exact hits at the first and last
    points, and points past either end; with the slice of the hits and
    ends."""
    rng = np.random.default_rng(n + 10 * d)
    x = np.linspace(0.0, 10.0, n)
    if not uniform:
        x = x + 0.4 * (10.0 / max(n - 1, 1)) * rng.uniform(-1.0, 1.0, n)
        x.sort()
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    kernel = POSTERIOR_KERNELS[d]
    params = {"chol_obs_covariance": np.asarray([[0.2]])}
    names = (kernel,) if isinstance(kernel, str) else kernel
    for i, _ in enumerate(names):
        path = "kernel" if isinstance(kernel, str) else f"kernel.kernels[{i}]"
        params[f"{path}.lengthscale"] = np.asarray(0.5 * i - 0.5)
        params[f"{path}.variance"] = np.asarray(0.5)
    model = gpr_from_numpy(params, x, y, device=device, dtype=dtype, kernel=kernel)
    pts = np.concatenate([rng.uniform(0.0, 10.0, 64), x[[0, -1]], [-3.0, -1e-3],
                          [x[-1] + 1e-3, 14.0]])
    return model, torch.as_tensor(pts, dtype=dtype, device=device), slice(64, None)


def _prediction_outputs(model, tn):
    with torch.no_grad():
        post = model.posterior
        (f_mean, f_var), (_, y_var) = post.predict_f(tn), post.predict_y(tn)
        m_tl, p_tl = post.dist.marginals_tl()
    return {"m_s": m_tl, "P_s": p_tl, "A": post.dist.state_transitions,
            "f mean": f_mean, "f var": f_var, "y var": y_var}


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "jittered"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", sorted(POSTERIOR_KERNELS))
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_posterior_path_kernels_match_plain(cuda_device, n, d, dtype, uniform):
    """gpr.posterior (one filter and one smoother launch), predict_f and
    predict_y on the kernel path against the plain path: float64 within
    F64_TOL; float32 within chip_smoke's tolerance of the plain path or no
    less accurate than it against float64 (chip_smoke.check_f32_wide).  At
    every point for d <= 2; for the Matern52 kernels (d = 3, 6), whose
    generic process noise loses its digits at sub-grid steps (ROADMAP
    queue 3), at the exact hits and the points past either end."""
    model, tn, held = _posterior_model(d, n, uniform, dtype, cuda_device)
    before = {k: getattr(ops, k).launches for k in
              ("filter_pipeline_uniform", "smoother_pipeline_uniform", "filter_pipeline",
               "smoother_scan")}
    got = _prediction_outputs(model, tn)
    after = {k: getattr(ops, k).launches - v for k, v in before.items()}
    on_uniform = model._uniform_grid
    assert after == {"filter_pipeline_uniform": int(on_uniform),
                     "smoother_pipeline_uniform": int(on_uniform),
                     "filter_pipeline": int(not on_uniform),
                     "smoother_scan": int(not on_uniform)}
    with chip_smoke.plain_path(ops, adj, kf):
        want = _prediction_outputs(model, tn)
    keys = ("f mean", "f var", "y var")
    pick = (lambda v: v) if d <= 2 else (lambda v: v[held])  # noqa: E731
    assert all(torch.isfinite(pick(got[k])).all() for k in keys)
    if dtype == torch.float64:
        for key in got:
            g, w = (got[key], want[key]) if key not in keys else (pick(got[key]),
                                                                  pick(want[key]))
            assert g.numel() == 0 or _rel(g, w) <= F64_TOL, key
        return
    model64, tn64, _ = _posterior_model(d, n, uniform, torch.float64, cuda_device)
    ref = _prediction_outputs(model64, tn64)
    chip_smoke.check_f32_wide(f"N={n} d={d}", {k: (pick(got[k]), pick(want[k]), pick(ref[k]))
                                               for k in keys},
                              dict.fromkeys(keys, chip_smoke.TOL_F32_MOMENTS))


@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52", "d9"])
def test_extrapolation_and_exact_hits_are_finite_in_float32_on_cuda(cuda_device, name):
    """The phantom neighbours at -/+ 1e10 and exact hits in float32 on the
    card: every prediction finite, and given the prior as the
    distribution, the prior's marginal past either end and at the hits."""
    from markovflow_tpu_torch import conditionals, kernels, state_space_model

    def kernel(dtype):
        if name == "d9":
            return kernels.Sum([kernels.Matern52(lengthscale=e, variance=v, dtype=dtype,
                                                 device=cuda_device)
                                for e, v in chip_smoke.D9])
        return getattr(kernels, name)(lengthscale=0.5, variance=1.0, dtype=dtype,
                                      device=cuda_device)
    x = torch.linspace(0.0, 10.0, 1001, dtype=torch.float64, device=cuda_device)
    with torch.no_grad():
        prior = kernel(torch.float64).state_space_model(x)
        prior32 = state_space_model.StateSpaceModel(*(v.float() for v in (
            prior.initial_mean, prior.cholesky_initial_covariance,
            prior.state_transitions, prior.state_offsets,
            prior.cholesky_process_covariances)))
        k32, x32 = kernel(torch.float32), x.float()
        xs = torch.cat([torch.tensor([-1e6, -50.0], device=cuda_device), x32[[0, 500, -1]],
                        torch.tensor([60.0, 1e6], device=cuda_device)])
        means, covs = conditionals.conditional_predict_tl(xs, x32, k32, prior32)
        p_inf = k32.steady_state_covariance[..., None].expand(covs.shape)
    assert torch.isfinite(means).all() and torch.isfinite(covs).all()
    scale = float(p_inf.abs().max())
    assert float((covs - p_inf).abs().max()) <= 2e-6 * scale
    assert float(means.abs().max()) <= 2e-6 * scale ** 0.5


# ---------------------------------------------------------------------------
# CVI and the SDE tools
# ---------------------------------------------------------------------------
def _cvi(n, uniform, dtype, likelihood, device):
    """chip_smoke's CVI (Matern32(0.5, 1), learning rate 0.5) on n points
    of [0, 10], jittered unless ``uniform``."""
    from markovflow_tpu_torch.convert import cvi_from_numpy
    from markovflow_tpu_torch.utils.bijectors import positive

    rng = np.random.default_rng(n)
    x = np.linspace(0.0, 10.0, n)
    if not uniform:
        x = x + 0.4 * (10.0 / max(n - 1, 1)) * rng.uniform(-1.0, 1.0, n)
        x.sort()
    params = {**chip_smoke.flagship_params(),
              "likelihood.variance": positive().inverse(np.asarray(0.04))}
    return cvi_from_numpy(params, x, chip_smoke.cvi_targets(x, likelihood, rng),
                          dtype=dtype, device=device, likelihood=likelihood,
                          learning_rate=0.5)


def _cvi_outputs(n, uniform, dtype, likelihood, device):
    """Two CVI iterations: the ELBOs, the kernel's gradients and the
    sites, stacked."""
    model = _cvi(n, uniform, dtype, likelihood, device)
    elbos, grads, sites = chip_smoke.cvi_iterations(model, 2)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    return model, {"ELBO": as_t(elbos), "gradients": as_t([list(g.values()) for g in grads]),
                   "nat1": sites[0], "lam": sites[1]}


@pytest.mark.parametrize("likelihood", ["Gaussian", "Bernoulli"])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "jittered"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_cvi_iterations_kernels_match_plain(cuda_device, n, dtype, uniform, likelihood):
    """Two CVI iterations (update_sites(), loss().backward()) on the kernel
    path against the plain path: the ELBOs, the kernel's gradients and the
    sites; float64 within F64_TOL, float32 by chip_smoke.check_f32_wide's
    rule.  Each iteration launches the filter twice, the smoother and the
    Koopman backward once (the uniform kernels on a uniform grid)."""
    before = _launches()
    model, got = _cvi_outputs(n, uniform, dtype, likelihood, cuda_device)
    launched = {k: v - before[k] for k, v in _launches().items()}
    on_uniform = model._uniform_grid
    want = dict.fromkeys(launched, 0)
    want.update({"filter_pipeline_uniform": 4, "smoother_pipeline_uniform": 2,
                 "adjoint_pipeline_uniform": 2} if on_uniform else
                {"filter_pipeline": 4, "smoother_scan": 2, "adjoint_pipeline": 2})
    assert launched == want
    with chip_smoke.plain_path(ops, adj, kf):
        _, plain = _cvi_outputs(n, uniform, dtype, likelihood, cuda_device)
    if dtype == torch.float64:
        for key in got:
            assert _rel(got[key], plain[key]) <= F64_TOL, key
        return
    _, ref = _cvi_outputs(n, uniform, torch.float64, likelihood, cuda_device)
    chip_smoke.check_f32_wide(f"N={n} CVI", {k: (got[k], plain[k], ref[k]) for k in got},
                              {"ELBO": chip_smoke.TOL_F32_LOGLIK,
                               "gradients": chip_smoke.TOL_F32_VS_F64_GRAD,
                               "nat1": chip_smoke.TOL_F32_MOMENTS,
                               "lam": chip_smoke.TOL_F32_MOMENTS})


def test_cvi_classic_elbo_on_cuda_has_a_value_and_no_gradient(cuda_device):
    """classic_elbo on the card equals the CPU's; its backward raises (the
    smoother kernels have no backward)."""
    from markovflow_tpu_torch.convert import cvi_from_numpy

    gpu = _cvi(500, True, torch.float64, "Bernoulli", cuda_device).update_sites()
    x, y = gpu.time_points.cpu().numpy(), gpu.observations.cpu().numpy()
    cpu = cvi_from_numpy({**chip_smoke.flagship_params(),
                          "sites.nat1": gpu.sites.nat1.cpu().numpy(),
                          "sites.nat2": gpu.sites.nat2.cpu().numpy()}, x, y,
                         dtype=torch.float64, device="cpu", likelihood="Bernoulli")
    value = gpu.classic_elbo()
    np.testing.assert_allclose(value.item(), cpu.classic_elbo().item(), rtol=1e-10)
    with pytest.raises(NotImplementedError):
        value.backward()


def _sde_outputs(prob):
    kl, path = chip_smoke.sde_iteration(kf, prob, prob["path"])
    return {"KL": kl, "mean": path.mu, "var": path.cov}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
# dt = 8 / n: the double well's Euler-Maruyama diverges at steps near 1
@pytest.mark.parametrize("n", [257, 2049, 4099])
def test_sde_iteration_kernels_match_plain(cuda_device, n, dtype):
    """One VI iteration of bench config 5 at d = 1 (linearize_sde, the
    Kalman filter of the linearised prior and its posterior state-space
    model: one general filter and one smoother-scan launch) on the kernel
    path against the plain path; float64 within F64_TOL, float32 by
    chip_smoke.check_f32_wide's rule."""
    prob = chip_smoke.sde_problem(dtype, n)
    before = _launches()
    with torch.no_grad():
        got = _sde_outputs(prob)
        launched = {k: v - before[k] for k, v in _launches().items()}
        with chip_smoke.plain_path(ops, adj, kf):
            plain = _sde_outputs(prob)
    want = dict.fromkeys(launched, 0)
    want.update({"filter_pipeline": 1, "smoother_scan": 1})
    assert launched == want
    if dtype == torch.float64:
        for key in got:
            assert _rel(got[key], plain[key]) <= F64_TOL, key
        return
    with torch.no_grad():
        ref = _sde_outputs(chip_smoke.sde_problem(torch.float64, n))
    chip_smoke.check_f32_wide(f"N={n} SDE", {k: (got[k], plain[k], ref[k]) for k in got},
                              {"KL": chip_smoke.TOL_SDE_F32_KL,
                               "mean": chip_smoke.TOL_F32_MOMENTS,
                               "var": chip_smoke.TOL_F32_MOMENTS})


@pytest.mark.parametrize("const_sites", [False, True], ids=["per-step", "stride-0"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d, o", [(d, o) for d in range(2, 7) for o in range(2, d + 1)])
@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_general_filter_at_o_sites_at_the_run_warp_and_block_edges(cuda_device, n, d, o,
                                                                   dtype, const_sites):
    """Kernel 4 at o x o sites (o = 2..d) against its plain version at the
    edges of a thread's, a warp's and a block's run of steps, batch (3,),
    masked, with H and lam stored at every step or stride 0: float64
    within F64_TOL (chip_smoke.TOL_F64), float32 on its benign sites by
    chip_smoke.check_f32_wide's rule (chip_smoke.multi_output_case)."""
    chip_smoke.multi_output_case(ops, n, (3,), d, o, dtype, const_sites)


@pytest.mark.parametrize("n", list(chip_smoke.EDGE_NS))
def test_general_filter_on_the_natgrad_inversions_indefinite_sites(cuda_device, n):
    """Kernel 4 at o = d = 2 on the synthetic model of the natural-gradient
    inversion (lam indefinite, ~dt^-3), float64: within F64_TOL, or within
    chip_smoke.COND_FACTOR times the plain version's own change under a
    one-ulp perturbation of its inputs (chip_smoke.natgrad_filter_case)."""
    chip_smoke.natgrad_filter_case(ops, n, (3,), 2)


@pytest.mark.parametrize("config", ["vgp", "svgp"])
def test_natgrad_step_kernels_match_plain(cuda_device, config):
    """One natural-gradient step of bench config 2 (VGP) or 3 (SVGP) at
    N = 4096 (M = 512), float64: kernels 4 (o = 2) and 5 once each, and the
    new q within chip_smoke.TOL_NG of the plain path's (the ELBO within
    TOL_NG_ELBO)."""
    model, loss_of = (chip_smoke.vgp_config2(4096) if config == "vgp"
                      else chip_smoke.svgp_config3(4096, 512))
    before = _launches()
    got = chip_smoke.natgrad_steps(model, loss_of, 1)[0]
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _launches().items()}
    want = dict.fromkeys(launched, 0)
    want.update({"filter_pipeline": 1, "smoother_scan": 1})
    assert launched == want
    with chip_smoke.plain_path(ops, adj, kf):
        plain = chip_smoke.natgrad_steps(model, loss_of, 1)[0]
    for key, val in chip_smoke.ssm_diffs(got, plain).items():
        assert val <= chip_smoke.TOL_NG, key
    e_k, e_p = (chip_smoke.elbo_of(model, loss_of, s) for s in (got, plain))
    assert abs(e_k - e_p) <= chip_smoke.TOL_NG_ELBO * abs(e_p)


def test_wrappers_raise_at_o_sites_they_have_no_kernel_for(cuda_device):
    """o > 1 runs only in the general filter at d <= 6, o <= d: it raises
    at d = 7..12, at o > d, and in kernels 1, 3 and 7."""
    kw = dict(dtype=torch.float64, device=cuda_device)
    for d, o in ((7, 2), (9, 9), (3, 4)):
        eye = torch.eye(d, **kw)[..., None].expand(d, d, 64)
        with pytest.raises(NotImplementedError):
            ops.filter_pipeline(0.5 * eye, torch.zeros((d, 1, 64), **kw), eye,
                                torch.ones((o, d, 64), **kw), torch.zeros((o, 1, 64), **kw),
                                torch.eye(o, **kw)[..., None].expand(o, o, 64))
    uni = _problem(3, 64, (), cuda_device)
    two = list(uni)
    two[5] = torch.ones((2, 3, 1), dtype=torch.float64, device=cuda_device)
    two[6] = uni[6].expand(2, 1, 64)
    two[7] = uni[7].expand(2, 2, 64)
    with pytest.raises(NotImplementedError):
        ops.filter_pipeline_uniform(*two)
    m_f, p_f, _ = ops.filter_pipeline_uniform_plain(*uni)
    gs = torch.ones((), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        adj.adjoint_pipeline_uniform(*two, m_f, p_f, gs)
    gargs = chip_smoke.multi_output_problem(3, 2, 64, (), torch.float64, seed=0)
    m_g, p_g, _ = ops.filter_pipeline_plain(*gargs)
    with pytest.raises(NotImplementedError):
        adj.adjoint_pipeline(*gargs, m_g, p_g, gs)
