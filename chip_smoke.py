"""Drive the PyTorch port's GPR serving and training paths once on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: a CUDA card must be present (no CPU fallback); print its name and
   power limit as nvidia-smi reports them;
2. build the CUDA kernels from the sources in the checkout (one nvcc unit
   per kernel family, dtype and state dim 1..6, and one per family and
   dtype for d = 7..12, compiled in parallel);
3. hold each of the seven kernels against its plain PyTorch version on the
   card: N in {4099, 1e6}, batch () and (3,), d in {1, 2, 3}
   (Matern12/32/52), float64 and float32, plus one masked case; the uniform
   kernels on a uniform grid, the general ones (filter, smoother scan,
   filter scan, general Koopman backward) on a jittered grid.  Then the
   same at d = 7..12 (Sums of Matern kernels, the d = 7..12 kernels of
   csrc/wide_scan.cuh and csrc/general_adjoint.cuh): float64 at N = 4099,
   batch (3,), and float32 at d = 9, N = 1e5 (the uniform Koopman backward
   takes d <= 6 only); and the shapes of the multi-level scan of the warp
   totals, in float64: d = 9 at N = 1e5 (2,084 totals, five levels) and at
   N = 50 (seven totals: a full and a partial group), d = 7 and d = 12 with
   batch (3,) and a mask; then the chunk edges of the staged passes (d = 9
   at N = 1, 5, 9, 47, 50 in float64 and float32; d = 12 at N = 50 in
   float64, batch (3,)) and the filter scan on random prebuilt elements
   (nonzero A and J at step 0; d = 7, 9, 12, float64); then the general
   filter and the general Koopman backward at d = 1, 2, 3, 6 (a Sum of two
   Matern52 at d = 6), N in EDGE_NS (the edges of a thread's run of steps,
   of a warp's and of a block's at d <= 2: 1, 7, 8, 9, 255, 256, 257, 2047,
   2048, 2049, 4099), batch (3,), a mask and GPR's stride-0 emission row
   and lam, in float64 and float32; and beside them, at the same N, batch
   and dtypes, the uniform filter at d = 1, 2, 3, 6 with a mask and GPR's
   stride-0 lam, the uniform smoother and Koopman backward (the latter with
   and without the site gradients) on the same problems, the filter scan
   on random prebuilt elements at d = 1, 2, 3, 4, 6 (d = 4 above its
   staged tile), and the smoother scan at d = 1..6 (d = 5, 6 above its
   staged tile) on the general problems' RTS elements and on random
   prebuilt elements;
4. the slice at full size, T = 1e6, float32, flagship GPR (Matern32(0.5,
   1.0), noise Cholesky 0.2), each path with the launch counters set to 0
   just before it and read just after:
   a. serving on a uniform grid: loss() three times and
      posterior_marginals() twice (filter and smoother kernels), against
      float64 and against the sequential numpy oracle at N = 500;
   b. training on a uniform grid: 5 Adam steps of training.fit (one filter
      and one adjoint launch a step), decreasing losses, float32 gradients
      against float64, and float64 gradients at N = 500 against central
      finite differences of the numpy oracle's log-likelihood;
   c. an irregular grid (linspace(0, 100, T) jittered by up to 0.4 of the
      spacing): loss(), posterior_marginals() and 5 fit steps through the
      general filter, the smoother scan (marginals) and the general Koopman
      backward (one launch a step), against float64, and at N = 500 against
      the numpy oracle (value, marginals, finite-difference gradients);
   d. the composite model (bench.py's d9 config: Matern52(0.5, 1) +
      Matern52(2, 0.5) + Matern52(8, 0.25), state dim 9, noise Cholesky
      0.2) at T = 1e5, float32: serving on a uniform grid (loss() through
      the general filter, as the JAX package routes d > 6;
      posterior_marginals() through the uniform filter and smoother), 5
      fit steps (general filter, general Koopman backward), and
      loss().backward() and posterior_marginals() on the jittered grid;
      float32 against float64 (kernel path and plain path) within the
      measured d9 bounds, and at N = 500 float64 against the numpy oracle
      and central differences;
   e. the ops filter API on the jittered grid (the flagship at T = 1e6, the
      d9 model at T = 1e5): make_filter_elements from the model's prior
      steps and sites, then parallel_filter (the filter-scan kernel),
      against the general filter kernel's moments on the same inputs and
      against float64; and KalmanFilterWithSparseSites with 30% of the
      flagship's grid points unobserved: -log_likelihood().backward()
      through the general filter and the general Koopman backward with
      that mask, against float64;
5. times, kernel path against plain path, with CUDA events after a warm-up
   (median of several runs): serving requests, training steps on both
   grids, general-grid requests, the d9 requests and training step; each
   kernel's device time per call from a torch.profiler trace (the wrapper's
   call time also holds its host work), at the flagship's d = 2 and at the
   d9 model's d = 9, beside its bound: the least time an H100 needs for
   the bytes the call must move (each input read once, each output written
   once) or for the operations of the sequential Kalman recursion it
   computes, whichever is larger; and each kernel route's device time per
   pass (the profiler's rows under ``mf::``, one JSON line).

The plain path swaps every kernel wrapper for its plain version
(``plain_path``).  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_FULL = 1_000_000
T_D9 = 100_000
FIT_STEPS = 5
#: the d9 model's children, (lengthscale, variance) of each Matern52
D9 = ((0.5, 1.0), (2.0, 0.5), (8.0, 0.25))
# float64: the kernels and the plain versions compose the same elements in
# different orders, so they agree to a few hundred ulps of the largest entry.
TOL_F64 = 1e-9
# float32: the two bracketings of ~log2(N) compositions, each with a d x d
# inverse of (I + C J), differ by float32 roundoff amplified by those
# inverses; the likelihood is a sum of N terms and is compared relatively.
TOL_F32_MOMENTS = 1e-3
TOL_F32_LOGLIK = 1e-4
# The adjoint's summed gradients (Fc, cc, Qc, Hc over N steps) are compared
# against the sum of their terms' magnitudes, the scale that bounds a sum's
# error: each term carries the scan's differences (TOL_F32_MOMENTS), and
# the terms' signs cancel in the sum.  Per-step outputs are normwise.
# f32 kernel path against the f64 kernel path for the T = 1e6 GPR loss; the
# JAX package measured 9.6e-7 for the same comparison on its own kernels.
TOL_F32_VS_F64_LOSS = 1e-5
# f32 hyperparameter gradients against f64; the JAX package's parity run
# measured 2.0e-6 for its f32 kernels (BENCH_r05.json).
TOL_F32_VS_F64_GRAD = 1e-4
# float32 at d = 9 (phase 3): the d9 model's filtered covariances are ill
# conditioned at dt = 1e-3 (the lengthscale-8 block is nearly
# deterministic), so two float32 bracketings may differ by more than
# TOL_F32_MOMENTS.  There each output of a kernel passes if it is within the
# tolerance of its plain version or, against float64, no less accurate than
# the plain version up to this factor.
F32_NO_WORSE = 2.0
# float64 gradients against central differences (h = 1e-5) of the numpy
# oracle's log-likelihood: truncation ~h^2, roundoff ~1e-16 |ll| / h.
TOL_FD = 1e-6
FD_STEP = 1e-5
# The d9 model in float32 against float64 at T = 1e5.  Its process noise is
# the generic Q = P_inf - A P_inf A^T (as in the JAX package), which loses
# Q[0, 0] of the lengthscale-0.5 block in float32 at dt = 1e-3 (about
# 5e-13 of P_inf[0, 0]); the JAX package's own XLA path differs from its
# float64 by 3.7e-5 in the loss.  Measured on an H100 (PERF.md), kernel
# path / plain path: loss 2.4e-5 / 2.2e-5 (uniform grid), 1.2e-6 / 1.8e-6
# (jittered); marginals up to 5.3e-3 / 7.0e-3; gradients 3.8e-4 / 3.9e-4
# normwise (the lengthscale-8 child's variance 2.3e-2 on its own).  The
# bounds are about 4x the largest of these.
TOL_D9_F32_VS_F64_LOSS = 1e-4
TOL_D9_F32_VS_F64_GRAD = 2e-3
TOL_D9_F32_MOMENTS = 3e-2
#: phase-3 step counts at the chunk edges of the staged d = 7..12 passes
#: (8 steps a warp at these N): one step; a run that ends inside a chunk;
#: a second warp of one step; runs of six and seven warps
CHUNK_EDGES = (1, 5, 9, 47, 50)
KERNEL_NAMES = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
#: phase-3 step counts at the edges of the d <= 6 passes of the general
#: filter and Koopman backward: a thread's run of 8 steps, a warp's 256 and
#: a block's 2,048 at d <= 2 in float32, and two blocks
EDGE_NS = (1, 7, 8, 9, 255, 256, 257, 2047, 2048, 2049, 4099)
#: children past the d9 model's Matern52s for the phase-3 Sums at d = 4..12
SUM_EXTRA = {4: ("Matern12",), 5: ("Matern32",), 6: ("Matern52",), 7: ("Matern12",),
             8: ("Matern32",), 9: (), 10: ("Matern12",), 11: ("Matern32",),
             12: ("Matern52",)}
DEVICE = torch.device("cuda")
#: the H100's memory rate and float32 rate outside the tensor cores
#: (NVIDIA's data sheet, SXM part, at a 700 W power limit)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
#: the launch counters the paths read: (module, wrapper name)
COUNTED = (("cs", "filter_pipeline_uniform"), ("cs", "smoother_pipeline_uniform"),
           ("adj", "adjoint_pipeline_uniform"), ("cs", "filter_pipeline"),
           ("cs", "smoother_scan"), ("cs", "filter_scan"),
           ("adj", "adjoint_pipeline"))
#: the gradients the GPR backward asks of the general Koopman backward
GPR_NEEDS = (True, True, True, False, False, False)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_diff(got: torch.Tensor, want: torch.Tensor, scale=None) -> float:
    """max |got - want| over max |want|, or over max ``scale`` (normwise, so
    near-zero entries do not dominate)."""
    ref = want if scale is None else scale
    den = ref.abs().max().clamp_min(torch.finfo(want.dtype).tiny)
    return float((got - want).abs().max() / den)


def check(tag: str, diffs: dict, tols: dict) -> None:
    log(f"  {tag}: max rel diff "
        + " ".join(f"{k}={v:.3e}" for k, v in diffs.items()))
    for key, val in diffs.items():
        if not (np.isfinite(val) and val <= tols[key]):
            raise AssertionError(f"{tag}: {key} differs by {val:.3e} > {tols[key]:g}")


def check_f32_wide(tag: str, outs: dict, tols: dict) -> None:
    """outs: name -> (kernel output, plain output, float64 reference of the
    plain version on the same inputs).  Each output passes within its
    tolerance of the plain version, or if its error against float64 is at
    most F32_NO_WORSE times the plain version's."""
    diffs = {k: rel_diff(kk, pp) for k, (kk, pp, _) in outs.items()}
    errs = {k: (rel_diff(kk.double(), rr), rel_diff(pp.double(), rr))
            for k, (kk, pp, rr) in outs.items()}
    log(f"  {tag}: max rel diff "
        + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
        + "; against float64, kernel / plain: "
        + " ".join(f"{k}={a:.3e}/{b:.3e}" for k, (a, b) in errs.items()))
    for key, val in diffs.items():
        err_k, err_p = errs[key]
        if not (val <= tols[key] or err_k <= F32_NO_WORSE * err_p):
            raise AssertionError(f"{tag}: {key} differs by {val:.3e} > {tols[key]:g} "
                                 f"and its float64 error {err_k:.3e} exceeds "
                                 f"{F32_NO_WORSE:g} x the plain version's {err_p:.3e}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def modules():
    from markovflow_tpu_torch import kalman_filter, training
    from markovflow_tpu_torch.ops import adjoint, cuda_scan
    return cuda_scan, adjoint, kalman_filter, training


def counted(cs, adj):
    """The wrappers whose launch counters the paths read, by kernel name."""
    mods = {"cs": cs, "adj": adj}
    return {name: getattr(mods[mod], name) for mod, name in COUNTED}


@contextlib.contextmanager
def launches_of(cs, adj, out: dict):
    """Set every launch counter to 0, run the block, store the counts."""
    wrappers = counted(cs, adj)
    for w in wrappers.values():
        w.launches = 0
    yield
    torch.cuda.synchronize()
    out.update({k: w.launches for k, w in wrappers.items()})


@contextlib.contextmanager
def plain_path(cs, adj, kf):
    """Swap every kernel wrapper for its plain PyTorch version (in the
    modules that call them), for the plain-path timings."""
    def adjoint_plain(*args, site_grads=True):
        return adj.adjoint_pipeline_uniform_plain(*args)

    def gadjoint_plain(*args, needs=None):
        return adj.adjoint_pipeline_plain(*args)
    swaps = {"filter_pipeline_uniform": cs.filter_pipeline_uniform_plain,
             "smoother_pipeline_uniform": cs.smoother_pipeline_uniform_plain,
             "filter_pipeline": cs.filter_pipeline_plain,
             "smoother_scan": cs.smoother_scan_plain,
             "filter_scan": cs.filter_scan_plain}
    saved = []
    for mod in (cs, kf):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    for name, fn in (("adjoint_pipeline_uniform", adjoint_plain),
                     ("adjoint_pipeline", gadjoint_plain)):
        saved.append((adj, name, getattr(adj, name)))
        setattr(adj, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------
def jittered_grid(n, seed=0):
    """linspace(0, 100, n), each point moved by up to 0.4 of the spacing."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 100.0, n)
    return x + 0.4 * (100.0 / max(n - 1, 1)) * rng.uniform(-1.0, 1.0, n)


def sites(n, batch, dtype, rng, masked):
    """Sites of y = sin(2x) + 0.2 noise (noise variance 0.04) on any grid."""
    dev = DEVICE
    x = np.linspace(0.0, 100.0, n)
    y = np.sin(2.0 * x) + 0.2 * rng.standard_normal(batch + (n,))
    nu = torch.as_tensor(y / 0.04, dtype=dtype, device=dev)[..., None, None, :]
    lam = torch.full((1, 1, 1), 1.0 / 0.04, dtype=dtype,
                     device=dev).expand(batch + (1, 1, n))
    maskf = None
    if masked:
        maskf = torch.as_tensor(rng.random(batch + (n,)) > 0.3, dtype=dtype,
                                device=dev)[..., None, None, :]
    return nu, lam, maskf


def sum_kernel(d, dtype):
    """A Sum of Matern kernels of state dim d = 4..12: the d9 model's
    Matern52s (the first for d <= 6, the first two for d < 9), then
    SUM_EXTRA[d]."""
    from markovflow_tpu_torch import kernels

    base = 1 if d <= 6 else (2 if d < 9 else 3)
    kids = [kernels.Matern52(lengthscale=ell, variance=var, dtype=dtype,
                             device=DEVICE) for ell, var in D9[:base]]
    kids += [getattr(kernels, name)(lengthscale=1.0, variance=0.3, dtype=dtype,
                                    device=DEVICE) for name in SUM_EXTRA[d]]
    k = kernels.Sum(kids)
    assert k.state_dim == d
    return k


def emission_row(k, d, dtype):
    """The kernel's emission row as [1, d, 1]: [1, 0, ...] for a Matern,
    the children's rows side by side for a Sum."""
    if d <= 3:
        h = torch.zeros((1, d, 1), dtype=dtype, device=DEVICE)
        h[0, 0, 0] = 1.0
        return h
    tp = torch.zeros((1,), dtype=dtype, device=DEVICE)
    return k.generate_emission_model(tp).emission_matrix.movedim(-3, -1)


def uniform_problem(d, n, batch, dtype, seed, masked=False):
    """Constant Matern prior steps on linspace(0, 100, n) with sites; for
    d >= 4 those of a Sum (sum_kernel), made in float64 and cast, as
    general_problem makes them."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    kdtype = dtype if d <= 3 else torch.float64
    k = (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                          dtype=kdtype, device=dev)
         if d <= 3 else sum_kernel(d, kdtype))
    dt = torch.full((1,), 100.0 / max(n - 1, 1), dtype=kdtype, device=dev)
    with torch.no_grad():
        fc, cc, qc, mu0, p0 = (x.to(dtype) for x in k.prior_const_tl(dt))
    hc = emission_row(k, d, dtype)
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (fc, cc, qc, mu0, p0, hc, nu, lam, maskf)


def general_problem(d, n, batch, dtype, seed, masked=False):
    """Per-step Matern prior steps (a Sum's for d >= 4) on a jittered grid,
    one emission row expanded over the steps, and sites.  The prior steps
    are made in float64 and cast: Matern52's generic process noise cancels
    in float32 at these small steps, and the check is of the kernels."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    k = (getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                          dtype=torch.float64, device=dev)
         if d <= 3 else sum_kernel(d, torch.float64))
    tp = torch.as_tensor(jittered_grid(n, seed), device=dev)
    with torch.no_grad():
        F, c, Q = (x.to(dtype) for x in k.prior_arrays_tl(tp))
    h = emission_row(k, d, dtype)
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (F, c, Q, h.expand(1, d, n), nu, lam, maskf)


def adjoint_sum_scales(adj, args, m_f, p_f, gscale):
    """The sums of the magnitudes of the terms of the adjoint's six summed
    gradients (the scale of each sum's error), from the plain stages."""
    from markovflow_tpu_torch.ops.kalman import _materialize_uniform

    fc, cc, qc, mu0, p0, hc, nu, lam, maskf = args
    n = nu.shape[-1]
    F, c, Q, H = _materialize_uniform(fc, cc, qc, mu0, p0, hc, n)
    mk = (torch.ones(nu.shape[:-3] + (n,), dtype=nu.dtype, device=nu.device)
          if maskf is None else maskf[..., 0, 0, :])
    g_f, g_c, g_q, g_h, _, _ = adj._adjoint_grads(F, c, Q, H, nu, lam, mk, m_f, p_f)
    gg = gscale.abs()[..., None, None, None]

    def mag(x):
        return (gg * x.abs()).sum(-1, keepdim=True)
    return (mag(g_f[..., 1:]), mag(g_c[..., 1:]), mag(g_q[..., 1:]),
            gg * g_c[..., :1].abs(), gg * g_q[..., :1].abs(), mag(g_h))


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------
ADJ_OUT = ("gFc", "gcc", "gQc", "gmu0", "gP0", "gHc", "gnu", "glam")
GADJ_OUT = ("gF", "gc", "gQ", "gH", "gnu", "glam")


def phase_kernels_vs_plain(cs, adj):
    log("phase 3: kernels against their plain versions on the card")
    cases = [(n, batch, d, dtype, False)
             for dtype in (torch.float64, torch.float32)
             for n in (4099, T_FULL) for batch in ((), (3,)) for d in (1, 2, 3)]
    cases.append((4099, (3,), 2, torch.float64, True))
    cases.append((4099, (3,), 2, torch.float32, True))
    # the d = 7..12 kernels: float64 at N = 4099, float32 at d = 9, N = 1e5;
    # then the shapes of the multi-level pass 2 (csrc/wide_scan.cuh): 2,084
    # warp totals at d = 9, N = 1e5; a partial group at N = 50; a batch
    # and a mask at d = 7 and d = 12
    cases += [(4099, (3,), d, torch.float64, False) for d in range(7, 13)]
    cases.append((T_D9, (), 9, torch.float32, False))
    cases += [(T_D9, (), 9, torch.float64, False), (50, (), 9, torch.float64, False),
              (4099, (3,), 7, torch.float64, True), (4099, (3,), 12, torch.float64, True)]
    # the staged passes of kernels 2, 5 and 6 at d = 7..12: runs of steps
    # that end inside a chunk (CH = 4 in float32, 2 in float64) and N below
    # CH; d = 12 in float64 with a batch, the most shared memory a warp
    cases += [(n, (), 9, dtype, False) for n in CHUNK_EDGES
              for dtype in (torch.float64, torch.float32)]
    cases.append((50, (3,), 12, torch.float64, False))
    for i, (n, batch, d, dtype, masked) in enumerate(cases):
        kernels_vs_plain_case(cs, adj, i, n, batch, d, dtype, masked)
    # the filter scan's moments-only pass 3 on elements no model makes
    for n, batch, d in ((4099, (3,), 7), (4099, (3,), 9), (4099, (3,), 12), (47, (), 9)):
        filter_scan_random_case(cs, n, batch, d)
    # the d <= 6 passes where a thread's, a warp's or a block's run of steps
    # ends: the general filter and Koopman backward, the uniform filter, the
    # uniform smoother and Koopman backward, the filter scan (also at d = 4,
    # where it reads each step where it lies) and the smoother scan (d = 4,
    # its last staged d, 160 threads a block in float64; d = 5 and 6, where
    # it reads each step where it lies)
    for dtype in (torch.float64, torch.float32):
        for n in EDGE_NS:
            for d in (1, 2, 3, 6):
                general_edges_case(cs, adj, n, d, dtype)
                uniform_edges_case(cs, n, d, dtype)
                uniform_pair_edges_case(cs, adj, n, d, dtype)
            for d in (1, 2, 3, 4, 6):
                filter_scan_random_case(cs, n, (3,), d, dtype)
            for d in range(1, 7):
                smoother_scan_edges_case(cs, n, d, dtype)


def general_edges_case(cs, adj, n, d, dtype):
    """The general filter and Koopman backward against their plain versions
    at N = n, batch (3,), with a mask and the stride-0 emission row and lam
    of GPR (general_problem's)."""
    f64 = dtype == torch.float64
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    gargs = general_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or gargs[3].stride(-1) == gargs[5].stride(-1) == 0
    gscale = torch.linspace(1.0, -0.5, 3, dtype=dtype, device=DEVICE)
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline(*gargs)
        m_p, p_p, ll_p = cs.filter_pipeline_plain(*gargs)
        ga_k = adj.adjoint_pipeline(*gargs, m_p, p_p, gscale)
        ga_p = adj.adjoint_pipeline_plain(*gargs, m_p, p_p, gscale)
    torch.cuda.synchronize()
    diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
             "loglik": rel_diff(ll_k, ll_p),
             **{name: rel_diff(g, w) for name, g, w in zip(GADJ_OUT, ga_k, ga_p)}}
    tols = {k: tol_m for k in diffs}
    tols["loglik"] = TOL_F64 if f64 else TOL_F32_LOGLIK
    check(f"general edges N={n} batch=(3,) d={d} {str(dtype)[6:]} masked", diffs, tols)


def uniform_edges_case(cs, n, d, dtype):
    """The uniform filter against its plain version at N = n, batch (3,),
    with a mask and GPR's stride-0 lam (uniform_problem's)."""
    f64 = dtype == torch.float64
    args = uniform_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or args[7].stride(-1) == 0
    with torch.no_grad():
        got, want = cs.filter_pipeline_uniform(*args), cs.filter_pipeline_uniform_plain(*args)
    torch.cuda.synchronize()
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    check(f"uniform edges N={n} batch=(3,) d={d} {str(dtype)[6:]} masked",
          {k: rel_diff(g, w) for k, g, w in zip(("m_f", "P_f", "loglik"), got, want)},
          {"m_f": tol_m, "P_f": tol_m, "loglik": TOL_F64 if f64 else TOL_F32_LOGLIK})


def uniform_pair_edges_case(cs, adj, n, d, dtype):
    """The uniform smoother and Koopman backward against their plain versions
    at N = n, batch (3,), from the plain filter's moments of
    uniform_problem's problem with a mask and GPR's stride-0 lam; the
    backward with the site gradients and without them (as the main path
    calls it), its sums against the magnitudes of their terms."""
    f64 = dtype == torch.float64
    args = uniform_problem(d, n, (3,), dtype, seed=n, masked=True)
    assert n == 1 or args[7].stride(-1) == 0
    gscale = torch.linspace(1.0, -0.5, 3, dtype=dtype, device=DEVICE)
    with torch.no_grad():
        m_p, p_p, _ = cs.filter_pipeline_uniform_plain(*args)
        s_k = cs.smoother_pipeline_uniform(*args[:3], m_p, p_p)
        s_p = cs.smoother_pipeline_uniform_plain(*args[:3], m_p, p_p)
        a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale)
        a_k0 = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale, site_grads=False)
        a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
        scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale) + (None, None)
    torch.cuda.synchronize()
    assert a_k0[6] is None and a_k0[7] is None
    diffs = {"m_s": rel_diff(s_k[0], s_p[0]), "P_s": rel_diff(s_k[1], s_p[1]),
             **{name: rel_diff(g, w, sc) for name, g, w, sc in zip(ADJ_OUT, a_k, a_p, scales)},
             **{name + " (no site grads)": rel_diff(g, w, sc)
                for name, g, w, sc in zip(ADJ_OUT[:6], a_k0, a_p, scales)}}
    tol = TOL_F64 if f64 else TOL_F32_MOMENTS
    check(f"uniform smoother, Koopman backward edges N={n} batch=(3,) d={d} "
          f"{str(dtype)[6:]} masked", diffs, dict.fromkeys(diffs, tol))


def random_contractions(rng, shape, d):
    """Random d x d matrices of spectral radius at most 0.95, [*shape, d, d]."""
    a = 0.8 * np.eye(d) + 0.3 * rng.standard_normal(shape + (d, d)) / np.sqrt(d)
    return a * (0.95 / np.maximum(np.abs(np.linalg.eigvals(a)).max(-1), 0.95))[..., None, None]


def psd(x):
    """x x^T over the last two axes."""
    return x @ np.swapaxes(x, -1, -2)


def random_filter_elements(d, n, batch, dtype, device=DEVICE, seed=0):
    """Prebuilt filtering elements that no model makes: a random contraction A
    and random PSD C and J at every step, step 0 included (where
    make_filter_elements_tl has A = 0 and J = 0), random b and eta.  The
    cuda tests and the CPU shim run (tests/) take them from here."""
    rng = np.random.default_rng(seed + 11 * d)
    a = random_contractions(rng, batch + (n,), d)
    lc = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    lj = 0.3 * rng.standard_normal(batch + (n, d, d)) / np.sqrt(d)
    t = lambda x: torch.as_tensor(np.moveaxis(x, -3, -1), dtype=dtype,  # noqa: E731
                                  device=device)
    return (t(a), t(rng.standard_normal(batch + (n, d, 1))), t(psd(lc)), t(psd(lj)),
            t(rng.standard_normal(batch + (n, d, 1))))


def random_smoother_elements(d, n, batch, dtype, device=DEVICE, seed=0):
    """Prebuilt smoothing elements that no model makes: a random contraction E
    and a random PSD L at every step, the last included (where
    smoother_elements_tl has E = 0), random g."""
    rng = np.random.default_rng(seed + 13 * d)
    e = random_contractions(rng, batch + (n,), d)
    ll = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    t = lambda x: torch.as_tensor(np.moveaxis(x, -3, -1), dtype=dtype,  # noqa: E731
                                  device=device)
    return t(e), t(rng.standard_normal(batch + (n, d, 1))), t(psd(ll))


def filter_scan_random_case(cs, n, batch, d, dtype=torch.float64):
    """The filter-scan kernel against its plain version on random prebuilt
    elements."""
    elems = random_filter_elements(d, n, batch, dtype, DEVICE)
    with torch.no_grad():
        got, want = cs.filter_scan(*elems), cs.filter_scan_plain(*elems)
    torch.cuda.synchronize()
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_MOMENTS
    check(f"filter scan, random elements N={n} batch={batch} d={d} {str(dtype)[6:]}",
          {"m_f": rel_diff(got[0], want[0]), "P_f": rel_diff(got[1], want[1])},
          {"m_f": tol, "P_f": tol})


def smoother_scan_edges_case(cs, n, d, dtype):
    """The smoother scan against its plain version at N = n, batch (3,), on
    the RTS elements of general_problem's problem with a mask (from the
    plain filter's moments) and on random prebuilt elements."""
    from markovflow_tpu_torch.ops.kalman import smoother_elements_tl

    gargs = general_problem(d, n, (3,), dtype, seed=n, masked=True)
    with torch.no_grad():
        m_p, p_p, _ = cs.filter_pipeline_plain(*gargs)
        inputs = {"RTS": smoother_elements_tl(*gargs[:3], m_p, p_p)[:3],
                  "random": random_smoother_elements(d, n, (3,), dtype, DEVICE, seed=n)}
        outs = {name: (cs.smoother_scan(*e), cs.smoother_scan_plain(*e))
                for name, e in inputs.items()}
    torch.cuda.synchronize()
    diffs = {f"{name} {leg}": rel_diff(k, w) for name, (got, want) in outs.items()
             for leg, k, w in zip(("m_s", "P_s"), got, want)}
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_MOMENTS
    check(f"smoother scan edges N={n} batch=(3,) d={d} {str(dtype)[6:]}", diffs,
          dict.fromkeys(diffs, tol))


def kernels_vs_plain_case(cs, adj, i, n, batch, d, dtype, masked):
    """Every kernel against its plain version on the problems of case i:
    a uniform-grid and a jittered-grid problem of state dim d, N = n."""
    from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                                 smoother_elements_tl)

    f64 = dtype == torch.float64
    tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
    tol_ll = TOL_F64 if f64 else TOL_F32_LOGLIK
    tag = (f"N={n} batch={batch} d={d} {str(dtype)[6:]}"
           + (" masked" if masked else ""))
    # kernels 1-3 on a uniform grid
    args = uniform_problem(d, n, batch, dtype, seed=i, masked=masked)
    fc, cc, qc = args[:3]
    gscale = torch.linspace(1.0, -0.5, max(1, int(np.prod(batch))),
                            dtype=dtype, device=DEVICE).reshape(batch)
    with_adjoint = d <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline_uniform(*args)
        m_p, p_p, ll_p = cs.filter_pipeline_uniform_plain(*args)
        ms_k, ps_k = cs.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
        ms_p, ps_p = cs.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
        a_k = a_p = scales = ()
        if with_adjoint:
            a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale)
            a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
            scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale) + (None, None)
    torch.cuda.synchronize()
    diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
             "loglik": rel_diff(ll_k, ll_p), "m_s": rel_diff(ms_k, ms_p),
             "P_s": rel_diff(ps_k, ps_p)}
    diffs.update({name: rel_diff(g, w, s) for name, g, w, s in
                  zip(ADJ_OUT, a_k, a_p, scales)})
    tols = {k: tol_m for k in diffs}
    tols["loglik"] = tol_ll
    wide32 = d > adj.UNIFORM_ADJOINT_MAX_STATE_DIM and not f64
    if wide32:
        a64 = [None if x is None else x.double() for x in args]
        with torch.no_grad():
            r_m, r_p, r_ll = cs.filter_pipeline_uniform_plain(*a64)
            r_ms, r_ps = cs.smoother_pipeline_uniform_plain(
                *a64[:3], m_p.double(), p_p.double())
        check_f32_wide("uniform " + tag, {
            "m_f": (m_k, m_p, r_m), "P_f": (p_k, p_p, r_p),
            "loglik": (ll_k, ll_p, r_ll), "m_s": (ms_k, ms_p, r_ms),
            "P_s": (ps_k, ps_p, r_ps)}, tols)
    else:
        check("uniform " + tag, diffs, tols)
    del args, m_k, p_k, m_p, p_p, ms_k, ps_k, ms_p, ps_p, a_k, a_p, scales
    # kernels 4-7 on a jittered grid: the general filter, the smoother
    # scan, the filter scan (of the problem's filtering elements) and the
    # general Koopman backward (all six gradients)
    gargs = general_problem(d, n, batch, dtype, seed=i, masked=masked)
    with torch.no_grad():
        m_k, p_k, ll_k = cs.filter_pipeline(*gargs)
        m_p, p_p, ll_p = cs.filter_pipeline_plain(*gargs)
        elems = smoother_elements_tl(*gargs[:3], m_p, p_p)[:3]
        ms_k, ps_k = cs.smoother_scan(*elems)
        ms_p, ps_p = cs.smoother_scan_plain(*elems)
        felems = make_filter_elements_tl(*gargs[:6])
        fs_k, fs_p = cs.filter_scan(*felems), cs.filter_scan_plain(*felems)
        ga_k = adj.adjoint_pipeline(*gargs, m_p, p_p, gscale)
        ga_p = adj.adjoint_pipeline_plain(*gargs, m_p, p_p, gscale)
    torch.cuda.synchronize()
    outs = {"m_f": (m_k, m_p), "P_f": (p_k, p_p), "loglik": (ll_k, ll_p),
            "m_s": (ms_k, ms_p), "P_s": (ps_k, ps_p), "scan m_f": (fs_k[0], fs_p[0]),
            "scan P_f": (fs_k[1], fs_p[1]), **dict(zip(GADJ_OUT, zip(ga_k, ga_p)))}
    tols = {k: tol_m for k in outs}
    tols["loglik"] = tol_ll
    if wide32:
        g64 = [None if x is None else x.double() for x in gargs]
        with torch.no_grad():
            r_m, r_p, r_ll = cs.filter_pipeline_plain(*g64)
            refs = [r_m, r_p, r_ll, *cs.smoother_scan_plain(*(e.double() for e in elems)),
                    *cs.filter_scan_plain(*(e.double() for e in felems)),
                    *adj.adjoint_pipeline_plain(*g64, m_p.double(), p_p.double(),
                                                gscale.double())]
        check_f32_wide("general " + tag, {k: (kk, pp, r) for (k, (kk, pp)), r
                                          in zip(outs.items(), refs)}, tols)
    else:
        check("general " + tag, {k: rel_diff(kk, pp) for k, (kk, pp) in outs.items()},
              tols)


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------
def flagship_data(n, uniform=True):
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 100.0, n) if uniform else jittered_grid(n, 0)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    return x, y


def flagship_params(lengthscale=0.5, variance=1.0):
    from markovflow_tpu_torch.utils.bijectors import positive

    return {"kernel.lengthscale": positive().inverse(np.asarray(lengthscale)),
            "kernel.variance": positive().inverse(np.asarray(variance)),
            "chol_obs_covariance": np.asarray([[0.2]])}


def d9_params():
    """The d9 model's parameters under the JAX Sum's attribute paths."""
    from markovflow_tpu_torch.utils.bijectors import positive

    params = {"chol_obs_covariance": np.asarray([[0.2]])}
    for i, (ell, var) in enumerate(D9):
        params[f"kernel.kernels[{i}].lengthscale"] = positive().inverse(np.asarray(ell))
        params[f"kernel.kernels[{i}].variance"] = positive().inverse(np.asarray(var))
    return params


def build_gpr(n, dtype, uniform=True, d9=False):
    """The flagship GPR, or the d9 model (bench.py's d9 config, whose data
    are the flagship's), on a uniform or the jittered grid."""
    from markovflow_tpu_torch.convert import gpr_from_numpy

    x, y = flagship_data(n, uniform)
    model = gpr_from_numpy(d9_params() if d9 else flagship_params(), x, y,
                           device=DEVICE, dtype=dtype,
                           kernel=("Matern52",) * 3 if d9 else "Matern32")
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform="
                             f"{model._uniform_grid}, not {uniform}")
    return model


def hyper(model):
    """label -> unconstrained hyperparameter tensor of a model's kernel."""
    k = model.kernel
    if not hasattr(k, "kernels"):
        return {name: getattr(k, name).unconstrained
                for name in ("lengthscale", "variance")}
    return {f"kernels[{i}].{name}": getattr(c, name).unconstrained
            for i, c in enumerate(k.kernels) for name in ("lengthscale", "variance")}


def load_numpy_oracle():
    """tests/tools/numpy_kalman.py, loaded by path (its package imports JAX)."""
    path = ROOT / "tests" / "tools" / "numpy_kalman.py"
    spec = importlib.util.spec_from_file_location("numpy_kalman", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_steps(model):
    """(mu0, P0, A [N-1, d, d], b [N-1, d], Q [N-1, d, d]) of a float64
    model's prior on its own grid, as numpy arrays for the oracle."""
    with torch.no_grad():
        F, c, Q = (x.cpu().numpy() for x in
                   model.kernel.prior_arrays_tl(model.time_points))
    steps = lambda x: np.moveaxis(x[..., 1:], -1, 0)
    return c[:, 0, 0], Q[..., 0], steps(F), steps(c)[:, :, 0], steps(Q)


def oracle_loglik(npk, model, y):
    mu0, p0, a, b, q = oracle_steps(model)
    h = model.kernel.generate_emission_model(
        model.time_points[:1]).emission_matrix[0].cpu().numpy()
    return npk.kalman_filter(mu0, p0, a, b, q, h, np.asarray([[0.04]]), y)


def check_fd_gradients(npk, n, uniform, d9=False):
    """float64 gradients of the loss at N = n against central differences
    of the numpy oracle's log-likelihood in the unconstrained parameters."""
    model = build_gpr(n, torch.float64, uniform, d9)
    model.loss().backward()
    _, y = flagship_data(n, uniform)
    errs = {}
    for name, p in hyper(model).items():
        got = float(p.grad)
        lls = []
        for sign in (1.0, -1.0):
            with torch.no_grad():
                p.add_(sign * FD_STEP)
                lls.append(oracle_loglik(npk, model, y)[-1])
                p.sub_(sign * FD_STEP)
        want = -(lls[0] - lls[1]) / (2.0 * FD_STEP)
        errs[name] = abs(got - want) / abs(want)
    grid = "uniform" if uniform else "jittered"
    log(f"  N={n} f64 {grid} gradients vs central differences of the numpy "
        f"oracle: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_FD:g})")
    if not all(v <= TOL_FD for v in errs.values()):
        raise AssertionError("gradients disagree with finite differences")


def check_oracle_values(npk, n, uniform, d9=False):
    """float64 value and marginals at N = n against the numpy oracle."""
    small = build_gpr(n, torch.float64, uniform, d9)
    with torch.no_grad():
        ll = float(small.log_likelihood())
        m_s, p_s = small.kalman.posterior_marginals()
    _, y = flagship_data(n, uniform)
    mf, pf, _, _, ll_ref = oracle_loglik(npk, small, y)
    _, _, a, b, q = oracle_steps(small)
    ms_ref, ps_ref, _ = npk.rts_smoother(mf, pf, a, b, q)
    e_ll = abs(ll - ll_ref) / abs(ll_ref)
    e_m = float(np.abs(m_s.cpu().numpy() - ms_ref).max())
    e_p = float(np.abs(p_s.cpu().numpy() - ps_ref).max())
    grid = "uniform" if uniform else "jittered"
    log(f"  N={n} f64 {grid} vs sequential numpy oracle: loglik rel {e_ll:.3e}, "
        f"m_s abs {e_m:.3e}, P_s abs {e_p:.3e} (tol 1e-9)")
    if not (e_ll <= 1e-9 and e_m <= 1e-9 and e_p <= 1e-9):
        raise AssertionError("the port disagrees with the numpy oracle")


def check_marginals(marginals, n=T_FULL, d=2):
    for m_s, p_s in marginals:
        if m_s.shape != (n, d) or p_s.shape != (n, d, d):
            raise AssertionError(f"bad marginal shapes {m_s.shape} {p_s.shape}")
        if not (torch.isfinite(m_s).all() and torch.isfinite(p_s).all()):
            raise AssertionError("non-finite posterior marginals")


def f32_vs_f64(uniform, d9, loss32, marg32):
    """The float32 loss, marginals and gradients against the same model in
    float64, on the current path: (loss rel diff, marginal m and P diffs
    normwise, per-parameter gradient rel diffs, gradients normwise).  The
    float32 gradients come from a fresh model."""
    n = T_D9 if d9 else T_FULL
    model64 = build_gpr(n, torch.float64, uniform, d9)
    loss64 = model64.loss()
    loss64.backward()
    with torch.no_grad():
        m64, p64 = model64.kalman.posterior_marginals()
    fresh = build_gpr(n, torch.float32, uniform, d9)
    fresh.loss().backward()
    loss32, loss64 = float(loss32.detach()), float(loss64.detach())
    g32 = {k: float(v.grad) for k, v in hyper(fresh).items()}
    g64 = {k: float(v.grad) for k, v in hyper(model64).items()}
    rel_g = {k: abs(g32[k] - g64[k]) / abs(g64[k]) for k in g64}
    norm_g = (max(abs(g32[k] - g64[k]) for k in g64)
              / max(abs(v) for v in g64.values()))
    return (abs(loss32 - loss64) / abs(loss64), loss64,
            rel_diff(marg32[0].double(), m64), rel_diff(marg32[1].double(), p64),
            rel_g, norm_g)


def check_f32_vs_f64(model, uniform, loss32, marg32, d9=False):
    """The float32 model's loss, marginals and gradients against the same
    model in float64 (both on the kernel path); for the d9 model the
    gradients are compared normwise (its six gradients span four orders of
    magnitude) against the measured d9 bounds."""
    rel, loss64, rel_m, rel_p, rel_g, norm_g = f32_vs_f64(uniform, d9, loss32, marg32)
    tol_loss, tol_m, tol_g = ((TOL_D9_F32_VS_F64_LOSS, TOL_D9_F32_MOMENTS,
                               TOL_D9_F32_VS_F64_GRAD) if d9 else
                              (TOL_F32_VS_F64_LOSS, TOL_F32_MOMENTS,
                               TOL_F32_VS_F64_GRAD))
    log(f"  loss (f64) = {loss64!r}; f32 vs f64: loss {rel:.3e} "
        f"(tol {tol_loss:g}); marginals m {rel_m:.3e}, P {rel_p:.3e} "
        f"(tol {tol_m:g}); gradients "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel_g.items())
        + (f", normwise {norm_g:.3e}" if d9 else "") + f" (tol {tol_g:g})")
    if not rel <= tol_loss:
        raise AssertionError(f"f32 loss differs from f64 by {rel:.3e}")
    if not (rel_m <= tol_m and rel_p <= tol_m):
        raise AssertionError("f32 marginals differ from f64")
    if not (norm_g <= tol_g if d9 else all(v <= tol_g for v in rel_g.values())):
        raise AssertionError("f32 gradients differ from f64")
    return rel_g


def check_fit(losses):
    vals = [float(v) for v in losses]
    log(f"  fit losses: {vals!r}")
    if len(vals) != FIT_STEPS or not all(np.isfinite(vals)):
        raise AssertionError(f"bad fit losses {vals}")
    if not all(b < a for a, b in zip(vals, vals[1:])):
        raise AssertionError(f"the fit losses do not decrease: {vals}")


def expect_launches(path, got, want):
    log(f"  launches during {path}: {got}")
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def no_launches(**counts):
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {name: counts.get(name, 0) for _, name in COUNTED}


def phase_serving(cs, adj, npk):
    log(f"phase 4a: GPR serving on a uniform grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32)
    counts = {}
    with launches_of(cs, adj, counts), torch.no_grad():
        losses = [model.loss() for _ in range(3)]
        marginals = [model.kalman.posterior_marginals() for _ in range(2)]
    expect_launches("the uniform requests", counts,
                    no_launches(filter_pipeline_uniform=5,
                                smoother_pipeline_uniform=2))
    for loss in losses:
        if loss.shape != () or not torch.isfinite(loss):
            raise AssertionError(f"bad loss {loss}")
    check_marginals(marginals)
    log(f"  loss (f32) = {float(losses[0])!r}")
    model64 = build_gpr(T_FULL, torch.float64)
    with torch.no_grad():
        loss64 = model64.loss()
        m64, p64 = model64.kalman.posterior_marginals()
    rel = abs(float(losses[0]) - float(loss64)) / abs(float(loss64))
    rel_m = rel_diff(marginals[0][0].double(), m64)
    rel_p = rel_diff(marginals[0][1].double(), p64)
    log(f"  loss (f64) = {float(loss64)!r}; f32 vs f64 loss rel diff = "
        f"{rel:.3e} (tol {TOL_F32_VS_F64_LOSS:g}); marginals m {rel_m:.3e}, "
        f"P {rel_p:.3e} (tol {TOL_F32_MOMENTS:g})")
    if not rel <= TOL_F32_VS_F64_LOSS:
        raise AssertionError(f"f32 loss differs from f64 by {rel:.3e}")
    if not (rel_m <= TOL_F32_MOMENTS and rel_p <= TOL_F32_MOMENTS):
        raise AssertionError("f32 marginals differ from f64")
    check_oracle_values(npk, 500, uniform=True)
    return model, counts


def phase_training_uniform(cs, adj, training, npk):
    log(f"phase 4b: GPR training on a uniform grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32)
    counts = {}
    with launches_of(cs, adj, counts):
        _, losses = training.fit(model, num_steps=FIT_STEPS)
    expect_launches(f"{FIT_STEPS} uniform fit steps", counts,
                    no_launches(filter_pipeline_uniform=FIT_STEPS,
                                adjoint_pipeline_uniform=FIT_STEPS))
    check_fit(losses)
    fresh = build_gpr(T_FULL, torch.float32)
    loss32 = fresh.loss()
    with torch.no_grad():
        marg32 = fresh.kalman.posterior_marginals()
    rel_g = check_f32_vs_f64(fresh, True, loss32, marg32)
    check_fd_gradients(npk, 500, uniform=True)
    return counts, rel_g


def phase_general(cs, adj, training, npk):
    log(f"phase 4c: GPR on a jittered grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32, uniform=False)
    counts = {}
    with launches_of(cs, adj, counts):
        with torch.no_grad():
            loss = model.loss()
            marginals = [model.kalman.posterior_marginals()]
        _, losses = training.fit(model, num_steps=FIT_STEPS)
    expect_launches(f"a loss, marginals and {FIT_STEPS} fit steps", counts,
                    no_launches(filter_pipeline=2 + FIT_STEPS, smoother_scan=1,
                                adjoint_pipeline=FIT_STEPS))
    if loss.shape != () or not torch.isfinite(loss):
        raise AssertionError(f"bad loss {loss}")
    check_marginals(marginals)
    check_fit(losses)
    log(f"  loss (f32) = {float(loss)!r}")
    rel_g = check_f32_vs_f64(model, False, loss, marginals[0])
    check_oracle_values(npk, 500, uniform=False)
    check_fd_gradients(npk, 500, uniform=False)
    return counts, rel_g


def phase_d9(cs, adj, kf, training, npk):
    """The d9 model at T = 1e5, float32, on the kernel path; returns the
    launch counts of its three paths."""
    log(f"phase 4d: the d9 model (Sum of three Matern52, state dim 9) at "
        f"T = {T_D9}, float32")
    counts = {}
    model = build_gpr(T_D9, torch.float32, d9=True)
    counts["d9 serving"] = {}
    with launches_of(cs, adj, counts["d9 serving"]), torch.no_grad():
        loss = model.loss()
        marginals = model.kalman.posterior_marginals()
    expect_launches("a d9 loss() and posterior_marginals()", counts["d9 serving"],
                    no_launches(filter_pipeline=1, filter_pipeline_uniform=1,
                                smoother_pipeline_uniform=1))
    if loss.shape != () or not torch.isfinite(loss):
        raise AssertionError(f"bad loss {loss}")
    check_marginals([marginals], T_D9, 9)
    log(f"  loss (f32) = {float(loss)!r}")
    check_f32_vs_f64(model, True, loss, marginals, d9=True)
    fit_model = build_gpr(T_D9, torch.float32, d9=True)
    counts["d9 training"] = {}
    with launches_of(cs, adj, counts["d9 training"]):
        _, losses = training.fit(fit_model, num_steps=FIT_STEPS)
    expect_launches(f"{FIT_STEPS} d9 fit steps", counts["d9 training"],
                    no_launches(filter_pipeline=FIT_STEPS, adjoint_pipeline=FIT_STEPS))
    check_fit(losses)
    jit = build_gpr(T_D9, torch.float32, uniform=False, d9=True)
    counts["d9 jittered"] = {}
    with launches_of(cs, adj, counts["d9 jittered"]):
        jloss = jit.loss()
        jloss.backward()
        with torch.no_grad():
            jmarg = jit.kalman.posterior_marginals()
    expect_launches("a d9 jittered loss().backward() and posterior_marginals()",
                    counts["d9 jittered"],
                    no_launches(filter_pipeline=2, smoother_scan=1,
                                adjoint_pipeline=1))
    check_marginals([jmarg], T_D9, 9)
    log(f"  jittered loss (f32) = {float(jloss.detach())!r}")
    check_f32_vs_f64(jit, False, jloss, jmarg, d9=True)
    # the same comparison on the plain path: what the reference's formulas
    # give in float32, without the kernels
    with plain_path(cs, adj, kf):
        for uniform in (True, False):
            plain = build_gpr(T_D9, torch.float32, uniform, d9=True)
            ploss = plain.loss()
            with torch.no_grad():
                pmarg = plain.kalman.posterior_marginals()
            rel, _, rel_m, rel_p, rel_g, norm_g = f32_vs_f64(uniform, True, ploss, pmarg)
            log(f"  plain path, {'uniform' if uniform else 'jittered'} grid: f32 vs "
                f"f64 loss {rel:.3e}; marginals m {rel_m:.3e}, P {rel_p:.3e}; "
                f"gradients " + ", ".join(f"{k} {v:.3e}" for k, v in rel_g.items())
                + f", normwise {norm_g:.3e}")
    for uniform in (True, False):
        check_oracle_values(npk, 500, uniform, d9=True)
        check_fd_gradients(npk, 500, uniform, d9=True)
    return counts


def ops_inputs(model):
    """A model's prior steps, emission and sites in the time-middle layout
    of the ops API: F [N, d, d], c [N, d], Q [N, d, d], H [N, 1, d],
    nu [N, 1], lam [N, 1, 1]; and the same in the time-last layout."""
    kal = model.kalman
    with torch.no_grad():
        F, c, Q = kal.prior_tl
        H = kal._emission_tl()
        nu, lam, _ = kal._site_nats_tl()
    tl = (F, c, Q, H, nu, lam)
    tm = lambda x: x.movedim(-1, -3)            # noqa: E731
    vec = lambda x: x[..., 0, :].movedim(-1, -2)  # noqa: E731
    return (tm(F), vec(c), tm(Q), tm(H), vec(nu), tm(lam)), tl


def sparse_sites_run(kf, dtype, x, y, idx):
    """KalmanFilterWithSparseSites for the flagship's kernel on the grid x
    with sites at x[idx] (y / 0.04, precision 1 / 0.04): the loss
    -log_likelihood(), after its backward, and the gradients of the
    kernel's two hyperparameters and of the sites' two naturals."""
    from markovflow_tpu_torch import kernels

    k = kernels.Matern32(lengthscale=0.5, variance=1.0, dtype=dtype, device=DEVICE)
    tp = torch.as_tensor(x, dtype=dtype, device=DEVICE)
    nat1 = torch.as_tensor(y[idx, None] / 0.04, dtype=dtype, device=DEVICE)
    nat2 = torch.full((idx.size, 1, 1), -0.5 / 0.04, dtype=dtype, device=DEVICE)
    nat1.requires_grad_(True)
    nat2.requires_grad_(True)
    f = kf.KalmanFilterWithSparseSites(
        k.generate_emission_model(tp), kf.UnivariateGaussianSitesNat(nat1, nat2),
        x.size, torch.as_tensor(idx, device=DEVICE), None,
        prior_tl=k.prior_arrays_tl(tp))
    loss = -f.log_likelihood()
    loss.backward()
    return loss.detach(), [k.lengthscale.unconstrained.grad,
                           k.variance.unconstrained.grad, nat1.grad, nat2.grad]


def phase_ops(cs, adj, kf):
    """The ops filter API through the filter-scan kernel and the sparse-site
    filter through the general Koopman backward; returns the launch counts
    of its paths."""
    from markovflow_tpu_torch.ops import kalman

    log(f"phase 4e: the ops filter API and the sparse-site filter on the jittered "
        f"grid, float32")
    counts = {}
    for path, n, d9 in (("ops", T_FULL, False), ("ops d9", T_D9, True)):
        model = build_gpr(n, torch.float32, uniform=False, d9=d9)
        args, tl = ops_inputs(model)
        counts[path] = {}
        with launches_of(cs, adj, counts[path]), torch.no_grad():
            m_f, p_f = kalman.parallel_filter(kalman.make_filter_elements(*args))
        expect_launches(f"parallel_filter at T = {n}" + (" (d9)" if d9 else ""),
                        counts[path], no_launches(filter_scan=1))
        d = model.kernel.state_dim
        if m_f.shape != (n, d) or p_f.shape != (n, d, d):
            raise AssertionError(f"bad filtered shapes {m_f.shape} {p_f.shape}")
        with torch.no_grad():
            gm, gp, _ = cs.filter_pipeline(*tl)
            args64, _ = ops_inputs(build_gpr(n, torch.float64, uniform=False, d9=d9))
            m64, p64 = kalman.parallel_filter(kalman.make_filter_elements(*args64))
        tol = TOL_D9_F32_MOMENTS if d9 else TOL_F32_MOMENTS
        check(f"T={n} d={d} parallel_filter vs the general filter kernel, and vs f64",
              {"m_f": rel_diff(m_f, gm[..., 0, :].movedim(-1, -2)),
               "P_f": rel_diff(p_f, gp.movedim(-1, -3)),
               "m_f f64": rel_diff(m_f.double(), m64),
               "P_f f64": rel_diff(p_f.double(), p64)},
              {"m_f": tol, "P_f": tol, "m_f f64": tol, "P_f f64": tol})
    x, y = flagship_data(T_FULL, uniform=False)
    idx = np.sort(np.random.default_rng(1).choice(T_FULL, int(0.7 * T_FULL),
                                                  replace=False))
    counts["sparse"] = {}
    with launches_of(cs, adj, counts["sparse"]):
        loss, grads = sparse_sites_run(kf, torch.float32, x, y[:, 0], idx)
    expect_launches("a sparse-site -log_likelihood().backward()", counts["sparse"],
                    no_launches(filter_pipeline=1, adjoint_pipeline=1))
    if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError("non-finite sparse-site loss or gradients")
    loss64, grads64 = sparse_sites_run(kf, torch.float64, x, y[:, 0], idx)
    diffs = {"loss": rel_diff(loss.double(), loss64)}
    diffs.update({name: rel_diff(g.double(), w) for name, g, w in
                  zip(("lengthscale", "variance", "nat1", "nat2"), grads, grads64)})
    log(f"  sparse sites: {idx.size} of {T_FULL} grid points observed; "
        f"loss (f64) = {float(loss64)!r}")
    check("sparse sites f32 vs f64", diffs,
          {"loss": TOL_F32_VS_F64_LOSS, "lengthscale": TOL_F32_VS_F64_GRAD,
           "variance": TOL_F32_VS_F64_GRAD, "nat1": TOL_F32_MOMENTS,
           "nat2": TOL_F32_MOMENTS})
    return counts


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pass_label(key: str) -> str:
    """A kernel's profiler name without its return type, arguments and
    namespaces: ``wide_scan_level<WideFilterOp<float>, false, true, float>``."""
    key = key.removeprefix("void ").replace("mf::", "")
    depth = 0
    for i, ch in enumerate(key):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return key[:i]
    return key


def kernel_device_ms(fn, reps: int = 20):
    """Device milliseconds per call spent in the port's own CUDA kernels
    (namespace ``mf::``), from a torch.profiler trace of ``reps`` calls (0.0
    when the trace holds no device time), and per kernel of those (a pass):
    label -> (device ms per call, launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, passes = 0.0, {}
    for evt in prof.key_averages():
        if "mf::" in evt.key:
            for name in ("self_device_time_total", "self_cuda_time_total"):
                if hasattr(evt, name):
                    t = getattr(evt, name)
                    us += t
                    passes[pass_label(evt.key)] = (t / reps / 1e3, evt.count / reps)
                    break
    return us / reps / 1e3, passes


def train_step(model):
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss().backward()
        opt.step()
    return step


def stored_bytes(x) -> int:
    """Bytes of the distinct values of a tensor: an expanded axis (stride 0)
    holds one value."""
    return math.prod(n for n, st in zip(x.shape, x.stride()) if st != 0) * x.element_size()


def step_flops(name: str, d: int) -> int:
    """Operations of one step of the sequential recursion that a kernel's
    function computes (o = 1, counting a d x d product as 2 d^3 and a d x d
    inverse as 2 d^3): the least arithmetic of the function, whatever the
    kernel's parallel scan adds (each associative composition costs ~2x a
    sequential step).
      filter: predict F P F^T (4 d^3), update and likelihood (6 d^2);
      RTS smoother: Pp (4 d^3), its inverse and the gain (4 d^3), the
        smoothed covariance G (Ps - Pp) G^T (4 d^3), the means;
      smoother scan of prebuilt (E, g, L): E P E^T + L, E m + g;
      filter scan of prebuilt (A, b, C, J, eta): (I + C J)^-1 and
        A M C A^T (10 d^3), the means;
      Koopman backward, per step: Pp and L = F (I - K H) (6 d^3), the
        suffix E NDK E^T (4 d^3), N F P (4 d^3); the uniform one also the
        smoothed covariance for its summed gH (4 d^3)."""
    d2, d3 = d * d, d ** 3
    return {"filter_pipeline_uniform": 4 * d3 + 6 * d2,
            "filter_pipeline": 4 * d3 + 6 * d2,
            "smoother_pipeline_uniform": 12 * d3 + 6 * d2,
            "smoother_scan": 4 * d3 + 2 * d2,
            "filter_scan": 10 * d3 + 6 * d2,
            "adjoint_pipeline": 14 * d3 + 6 * d2,
            "adjoint_pipeline_uniform": 18 * d3 + 6 * d2}[name]


def bound(name, inputs, outputs, d, steps):
    """(bound_ms, bound_by) of one call: the larger of its bytes (each
    input read once, each output written once) over the H100's memory rate
    and its float32 operations (step_flops per step) over its float32 rate."""
    nbytes = sum(stored_bytes(x) for x in list(inputs) + list(outputs)
                 if isinstance(x, torch.Tensor))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = step_flops(name, d) * steps / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_calls(cs, adj, uni, gen):
    """Each kernel on the inputs of a uniform-grid and a jittered-grid model
    (the uniform adjoint up to d = 6), called as the main path calls it:
    name -> (kernel call, plain call, inputs).  The filter scan takes the
    jittered model's filtering elements; the two Koopman backwards write
    only what the GPR backward asks for."""
    from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                                 smoother_elements_tl)

    k_uni, k_gen = uni.kalman, gen.kalman
    Fc, cc, Qc, mu0, P0 = (x.detach() for x in k_uni.prior_const_tl)
    hc = k_uni._const_emission_tl()
    nu, lam, _ = k_uni._site_nats_tl()
    args = (Fc, cc, Qc, mu0, P0, hc, nu, lam)
    F, c, Q = (x.detach() for x in k_gen.prior_tl)
    H = k_gen._emission_tl()
    gnu, glam, _ = k_gen._site_nats_tl()
    gargs = (F, c, Q, H, gnu, glam)
    gs = torch.ones((), dtype=nu.dtype, device=DEVICE)
    with torch.no_grad():
        m_fp, p_fp, _ = cs.filter_pipeline_uniform_plain(*args)
        gm_fp, gp_fp, _ = cs.filter_pipeline_plain(*gargs)
        elems = smoother_elements_tl(F, c, Q, gm_fp, gp_fp)[:3]
        felems = make_filter_elements_tl(*gargs)
    calls = {
        "filter_pipeline_uniform": (lambda: cs.filter_pipeline_uniform(*args),
                                    lambda: cs.filter_pipeline_uniform_plain(*args),
                                    args),
        "smoother_pipeline_uniform": (
            lambda: cs.smoother_pipeline_uniform(Fc, cc, Qc, m_fp, p_fp),
            lambda: cs.smoother_pipeline_uniform_plain(Fc, cc, Qc, m_fp, p_fp),
            (Fc, cc, Qc, m_fp, p_fp)),
        "filter_pipeline": (lambda: cs.filter_pipeline(*gargs),
                            lambda: cs.filter_pipeline_plain(*gargs), gargs),
        "smoother_scan": (lambda: cs.smoother_scan(*elems),
                          lambda: cs.smoother_scan_plain(*elems), elems),
        "filter_scan": (lambda: cs.filter_scan(*felems),
                        lambda: cs.filter_scan_plain(*felems), felems),
        "adjoint_pipeline": (
            lambda: adj.adjoint_pipeline(*gargs, None, gm_fp, gp_fp, gs, needs=GPR_NEEDS),
            lambda: adj.adjoint_pipeline_plain(*gargs, None, gm_fp, gp_fp, gs),
            gargs + (gm_fp, gp_fp, gs)),
    }
    if Fc.shape[-3] <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM:
        # as the flagship's backward calls it: no site gradients
        calls["adjoint_pipeline_uniform"] = (
            lambda: adj.adjoint_pipeline_uniform(*args, None, m_fp, p_fp, gs,
                                                 site_grads=False),
            lambda: adj.adjoint_pipeline_uniform_plain(*args, None, m_fp, p_fp, gs),
            args + (m_fp, p_fp, gs))
    return calls


def compare_call(kfn, pfn):
    """A kernel call's outputs against its plain version's: the max abs
    difference and the largest plain entry, over the per-step and summed
    arrays both return (not the log-likelihood, a sum of N terms)."""
    with torch.no_grad():
        got, want = kfn(), pfn()
    pairs = [(g, w) for g, w in zip(got, want) if g is not None and g.dim() >= 3]
    return (max(float((g - w).abs().max()) for g, w in pairs),
            max(float(w.abs().max()) for _, w in pairs), got)


def phase_times(cs, adj, kf, card, counts):
    log(f"phase 5: times at T = {T_FULL} (flagship) and T = {T_D9} (d9 model), "
        f"float32, on {card}")
    uni = build_gpr(T_FULL, torch.float32)
    gen = build_gpr(T_FULL, torch.float32, uniform=False)
    d9u = build_gpr(T_D9, torch.float32, d9=True)
    d9j = build_gpr(T_D9, torch.float32, uniform=False, d9=True)
    sets = {"": (kernel_calls(cs, adj, uni, gen), 2, T_FULL),
            " d=9": (kernel_calls(cs, adj, d9u, d9j), 9, T_D9)}
    requests = {
        "uniform loss()": lambda: uni.loss(),
        "uniform posterior_marginals()": lambda: uni.kalman.posterior_marginals(),
        "jittered loss()": lambda: gen.loss(),
        "jittered posterior_marginals()": lambda: gen.kalman.posterior_marginals(),
        "d9 loss()": lambda: d9u.loss(),
        "d9 posterior_marginals()": lambda: d9u.kalman.posterior_marginals(),
        "d9 jittered loss()": lambda: d9j.loss(),
        "d9 jittered posterior_marginals()": lambda: d9j.kalman.posterior_marginals(),
    }
    steps = {"uniform training step": train_step(uni),
             "jittered training step": train_step(gen),
             "d9 training step": train_step(d9u),
             "d9 jittered training step": train_step(d9j)}
    calls = {name + tag: fns for tag, (c, _, _) in sets.items()
             for name, fns in c.items()}
    # turns: plain, kernel, kernel, plain; the medians of both turns
    t = {}
    for turn in ("plain", "kernel", "kernel", "plain"):
        reps = 20 if turn == "kernel" else 3
        ctx = plain_path(cs, adj, kf) if turn == "plain" else contextlib.nullcontext()
        with ctx:
            with torch.no_grad():
                for key, fn in requests.items():
                    t.setdefault((turn, key), []).append(cuda_ms(fn, reps))
            for key, fn in steps.items():
                t.setdefault((turn, key), []).append(cuda_ms(fn, reps))
        with torch.no_grad():
            for key, (kfn, pfn, _) in calls.items():
                t.setdefault((turn, key), []).append(
                    cuda_ms(kfn if turn == "kernel" else pfn, reps))
    ms = {k: statistics.median(v) for k, v in t.items()}
    for key in list(requests) + list(steps):
        log(f"  {key}: kernel path {ms[('kernel', key)]!r} ms, plain path "
            f"{ms[('plain', key)]!r} ms (CUDA events, median)  [{card}]")
    dev, passes, errs, largest, bounds = {}, {}, {}, {}, {}
    for tag, (c, d, n) in sets.items():
        for name, (kfn, pfn, inputs) in c.items():
            key = name + tag
            with torch.no_grad():
                dev[key], passes[key] = kernel_device_ms(kfn)
            errs[key], largest[key], outputs = compare_call(kfn, pfn)
            bounds[key] = bound(name, inputs, outputs, d, n)
    for key in calls:
        src = "on the device per call (torch.profiler)"
        if dev[key] <= 0.0:
            dev[key] = ms[("kernel", key)]
            src = "per wrapper call (the profiler saw no device time)"
        log(f"  {key} kernel: max abs diff from its plain version "
            f"{errs[key]:.3e} (largest entry {largest[key]:.3e})")
        log(f"  {key} kernel: {dev[key]!r} ms {src}; bound {bounds[key][0]!r} ms "
            f"({bounds[key][1]}); wrapper call {ms[('kernel', key)]!r} ms, plain "
            f"version {ms[('plain', key)]!r} ms (CUDA events, median per call)  [{card}]")
        log(f"  {key} kernel per pass: " + "; ".join(
            f"{label} {t!r} ms x{count:g}" for label, (t, count) in passes[key].items()))
    log(json.dumps({"passes": {key: {label: {"ms": t, "launches": count}
                                     for label, (t, count) in passes[key].items()}
                               for key in calls}, "card": card}))
    source = "markovflow_tpu_torch/ops/csrc/"
    # (name, source at d <= 6, source at d = 7..12, TPU kernel, paths at d = 2,
    # paths at d = 9)
    d9_paths = ("d9 serving", "d9 training", "d9 jittered")
    rows = [("filter_pipeline_uniform", "uniform_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1036", ("serving",), d9_paths),
            ("smoother_pipeline_uniform", "uniform_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1457", ("serving",), d9_paths),
            ("adjoint_pipeline_uniform", "adjoint_scan.cuh", None,
             "pallas_scan.py:1229", ("training",), ()),
            ("filter_pipeline", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:849", ("general", "sparse"), d9_paths),
            ("smoother_scan", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:1313", ("general",), d9_paths),
            ("filter_scan", "general_scan.cuh", "wide_scan.cuh",
             "pallas_scan.py:793", ("ops",), ("ops d9",)),
            ("adjoint_pipeline", "general_adjoint.cuh", "general_adjoint.cuh",
             "pallas_scan.py:681", ("general", "sparse"), d9_paths)]
    out = []
    for name, src, wide_src, rep, paths, wide_paths in rows:
        for tag, file, run in (("", src, paths), (" d=9", wide_src, wide_paths)):
            if file is None:
                continue
            key = name + tag
            out.append({"name": key, "route": "cuda", "source": source + file,
                        "replaces": "markovflow_tpu/ops/" + rep,
                        "launches": sum(counts[path][name] for path in run),
                        "max_abs_err": errs[key], "ms": dev[key],
                        "plain_ms": ms[("plain", key)], "bound_ms": bounds[key][0],
                        "bound_by": bounds[key][1], "library_ms": None})
    return out


def log_unit_seconds(cs) -> None:
    """The slowest nvcc units of the build, when this run built the library."""
    path = cs._BUILD_ROOT / cs._source_hash() / "unit_seconds.json"
    if path.is_file():
        secs = json.loads(path.read_text())
        slow = sorted(secs.items(), key=lambda kv: -kv[1])[:8]
        log(f"  {len(secs)} units, {sum(secs.values()):.1f} s of nvcc in all; slowest: "
            + "; ".join(f"{unit} {t:.1f} s" for unit, t in slow))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs, adj, kf, training = modules()
    npk = load_numpy_oracle()
    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    cs.build_kernels()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    log_unit_seconds(cs)
    t0 = time.perf_counter()
    phase_kernels_vs_plain(cs, adj)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = {}
    _, counts["serving"] = phase_serving(cs, adj, npk)
    counts["training"], _ = phase_training_uniform(cs, adj, training, npk)
    counts["general"], _ = phase_general(cs, adj, training, npk)
    counts.update(phase_d9(cs, adj, kf, training, npk))
    counts.update(phase_ops(cs, adj, kf))
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_times(cs, adj, kf, card, counts)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s; "
        f"whole run {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
