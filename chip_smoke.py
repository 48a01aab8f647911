"""Drive the PyTorch port's GPR serving and training paths once on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: a CUDA card must be present (no CPU fallback); print its name and
   power limit as nvidia-smi reports them;
2. build the CUDA kernels from the sources in the checkout (one nvcc unit
   per kernel family, dtype and state dim, compiled in parallel);
3. hold each of the five kernels against its plain PyTorch version on the
   card: N in {4099, 1e6}, batch () and (3,), d in {1, 2, 3}
   (Matern12/32/52), float64 and float32, plus one masked case; the uniform
   kernels on a uniform grid, the general pair on a jittered grid;
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
      general filter and smoother-scan kernels, against float64, and at
      N = 500 against the numpy oracle (value, marginals, finite-difference
      gradients);
5. times, kernel path against plain path, with CUDA events after a warm-up
   (median of several runs): serving requests, training steps on both
   grids, general-grid requests; each kernel's device time per call from a
   torch.profiler trace (the wrapper's call time also holds its host work).

The plain path swaps every kernel wrapper for its plain version
(``plain_path``).  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_FULL = 1_000_000
FIT_STEPS = 5
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
# float64 gradients against central differences (h = 1e-5) of the numpy
# oracle's log-likelihood: truncation ~h^2, roundoff ~1e-16 |ll| / h.
TOL_FD = 1e-6
FD_STEP = 1e-5
KERNEL_NAMES = {1: "Matern12", 2: "Matern32", 3: "Matern52"}
DEVICE = torch.device("cuda")


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
    return {"filter_pipeline_uniform": cs.filter_pipeline_uniform,
            "smoother_pipeline_uniform": cs.smoother_pipeline_uniform,
            "adjoint_pipeline_uniform": adj.adjoint_pipeline_uniform,
            "filter_pipeline": cs.filter_pipeline,
            "smoother_scan": cs.smoother_scan}


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
    swaps = {"filter_pipeline_uniform": cs.filter_pipeline_uniform_plain,
             "smoother_pipeline_uniform": cs.smoother_pipeline_uniform_plain,
             "filter_pipeline": cs.filter_pipeline_plain,
             "smoother_scan": cs.smoother_scan_plain}
    saved = []
    for mod in (cs, kf):
        for name, fn in swaps.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    saved.append((adj, "adjoint_pipeline_uniform", adj.adjoint_pipeline_uniform))
    adj.adjoint_pipeline_uniform = adjoint_plain
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
    return x + 0.4 * (x[1] - x[0]) * rng.uniform(-1.0, 1.0, n)


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


def uniform_problem(d, n, batch, dtype, seed, masked=False):
    """Constant Matern prior steps on linspace(0, 100, n) with sites."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    k = getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                         dtype=dtype, device=dev)
    dt = torch.full((1,), 100.0 / (n - 1), dtype=dtype, device=dev)
    with torch.no_grad():
        fc, cc, qc, mu0, p0 = k.prior_const_tl(dt)
    hc = torch.zeros((1, d, 1), dtype=dtype, device=dev)
    hc[0, 0, 0] = 1.0
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (fc, cc, qc, mu0, p0, hc, nu, lam, maskf)


def general_problem(d, n, batch, dtype, seed, masked=False):
    """Per-step Matern prior steps on a jittered grid, one emission row
    expanded over the steps, and sites.  The prior steps are made in
    float64 and cast: Matern52's generic process noise cancels in float32
    at these small steps, and the check is of the kernels."""
    from markovflow_tpu_torch import kernels

    dev = DEVICE
    k = getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                         dtype=torch.float64, device=dev)
    tp = torch.as_tensor(jittered_grid(n, seed), device=dev)
    with torch.no_grad():
        F, c, Q = (x.to(dtype) for x in k.prior_arrays_tl(tp))
    h = torch.zeros((1, d, 1), dtype=dtype, device=dev)
    h[0, 0, 0] = 1.0
    nu, lam, maskf = sites(n, batch, dtype, np.random.default_rng(seed), masked)
    return (F, c, Q, h.expand(1, d, n), nu, lam, maskf)


def adjoint_sum_scales(adj, args, m_f, p_f, gscale):
    """The sums of the magnitudes of the terms of the adjoint's six summed
    gradients (the scale of each sum's error), from the plain stages."""
    from markovflow_tpu_torch.ops.kalman import (_materialize_uniform,
                                                 smoother_scan_tl)

    fc, cc, qc, mu0, p0, hc, nu, lam, maskf = args
    n = nu.shape[-1]
    F, c, Q, H = _materialize_uniform(fc, cc, qc, mu0, p0, hc, n)
    mk = (torch.ones(nu.shape[:-3] + (n,), dtype=nu.dtype, device=nu.device)
          if maskf is None else maskf[..., 0, 0, :])
    g_f, g_c, g_q, g_h, _, _ = adj._adjoint_grads(
        F, c, Q, H, nu, lam, mk, m_f, p_f, scan=smoother_scan_tl)
    gg = gscale.abs()[..., None, None, None]

    def mag(x):
        return (gg * x.abs()).sum(-1, keepdim=True)
    return (mag(g_f[..., 1:]), mag(g_c[..., 1:]), mag(g_q[..., 1:]),
            gg * g_c[..., :1].abs(), gg * g_q[..., :1].abs(), mag(g_h))


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------
ADJ_OUT = ("gFc", "gcc", "gQc", "gmu0", "gP0", "gHc", "gnu", "glam")


def phase_kernels_vs_plain(cs, adj):
    from markovflow_tpu_torch.ops.kalman import smoother_elements_tl

    log("phase 3: kernels against their plain versions on the card")
    cases = [(n, batch, d, dtype, False)
             for dtype in (torch.float64, torch.float32)
             for n in (4099, T_FULL) for batch in ((), (3,)) for d in (1, 2, 3)]
    cases.append((4099, (3,), 2, torch.float64, True))
    cases.append((4099, (3,), 2, torch.float32, True))
    for i, (n, batch, d, dtype, masked) in enumerate(cases):
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
        with torch.no_grad():
            m_k, p_k, ll_k = cs.filter_pipeline_uniform(*args)
            m_p, p_p, ll_p = cs.filter_pipeline_uniform_plain(*args)
            ms_k, ps_k = cs.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
            ms_p, ps_p = cs.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
            a_k = adj.adjoint_pipeline_uniform(*args, m_p, p_p, gscale)
            a_p = adj.adjoint_pipeline_uniform_plain(*args, m_p, p_p, gscale)
            scales = adjoint_sum_scales(adj, args, m_p, p_p, gscale)
        torch.cuda.synchronize()
        diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
                 "loglik": rel_diff(ll_k, ll_p), "m_s": rel_diff(ms_k, ms_p),
                 "P_s": rel_diff(ps_k, ps_p)}
        diffs.update({name: rel_diff(g, w, s) for name, g, w, s in
                      zip(ADJ_OUT, a_k, a_p, scales + (None, None))})
        tols = {k: tol_m for k in diffs}
        tols["loglik"] = tol_ll
        check("uniform " + tag, diffs, tols)
        del args, m_k, p_k, m_p, p_p, ms_k, ps_k, ms_p, ps_p, a_k, a_p, scales
        # kernels 4-5 on a jittered grid
        gargs = general_problem(d, n, batch, dtype, seed=i, masked=masked)
        with torch.no_grad():
            m_k, p_k, ll_k = cs.filter_pipeline(*gargs)
            m_p, p_p, ll_p = cs.filter_pipeline_plain(*gargs)
            elems = smoother_elements_tl(*gargs[:3], m_p, p_p)[:3]
            ms_k, ps_k = cs.smoother_scan(*elems)
            ms_p, ps_p = cs.smoother_scan_plain(*elems)
        torch.cuda.synchronize()
        check("general " + tag,
              {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
               "loglik": rel_diff(ll_k, ll_p), "m_s": rel_diff(ms_k, ms_p),
               "P_s": rel_diff(ps_k, ps_p)},
              {"m_f": tol_m, "P_f": tol_m, "loglik": tol_ll, "m_s": tol_m,
               "P_s": tol_m})


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


def build_gpr(n, dtype, uniform=True, params=None):
    from markovflow_tpu_torch.convert import gpr_from_numpy

    x, y = flagship_data(n, uniform)
    model = gpr_from_numpy(params or flagship_params(), x, y,
                           device=DEVICE, dtype=dtype,
                           kernel="Matern32")
    if model._uniform_grid != uniform:
        raise AssertionError(f"the grid was detected as uniform="
                             f"{model._uniform_grid}, not {uniform}")
    return model


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
    return npk.kalman_filter(mu0, p0, a, b, q, np.asarray([[1.0, 0.0]]),
                             np.asarray([[0.04]]), y)


def check_fd_gradients(npk, n, uniform):
    """float64 gradients of the loss at N = n against central differences
    of the numpy oracle's log-likelihood in the unconstrained parameters."""
    model = build_gpr(n, torch.float64, uniform)
    model.loss().backward()
    _, y = flagship_data(n, uniform)
    errs = {}
    for name in ("lengthscale", "variance"):
        p = getattr(model.kernel, name).unconstrained
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


def check_oracle_values(npk, n, uniform):
    """float64 value and marginals at N = n against the numpy oracle."""
    small = build_gpr(n, torch.float64, uniform)
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


def check_marginals(marginals):
    for m_s, p_s in marginals:
        if m_s.shape != (T_FULL, 2) or p_s.shape != (T_FULL, 2, 2):
            raise AssertionError(f"bad marginal shapes {m_s.shape} {p_s.shape}")
        if not (torch.isfinite(m_s).all() and torch.isfinite(p_s).all()):
            raise AssertionError("non-finite posterior marginals")


def check_f32_vs_f64(model, uniform, loss32, marg32):
    """The float32 model's loss, marginals and gradients against the same
    model in float64 (both on the kernel path)."""
    model64 = build_gpr(T_FULL, torch.float64, uniform)
    loss64 = model64.loss()
    loss64.backward()
    with torch.no_grad():
        m64, p64 = model64.kalman.posterior_marginals()
    fresh = build_gpr(T_FULL, torch.float32, uniform)
    fresh.loss().backward()
    loss32, loss64 = float(loss32.detach()), float(loss64.detach())
    rel = abs(loss32 - loss64) / abs(loss64)
    rel_m = rel_diff(marg32[0].double(), m64)
    rel_p = rel_diff(marg32[1].double(), p64)
    rel_g = {name: abs(float(getattr(fresh.kernel, name).unconstrained.grad)
                       - float(getattr(model64.kernel, name).unconstrained.grad))
             / abs(float(getattr(model64.kernel, name).unconstrained.grad))
             for name in ("lengthscale", "variance")}
    log(f"  loss (f64) = {loss64!r}; f32 vs f64: loss {rel:.3e} "
        f"(tol {TOL_F32_VS_F64_LOSS:g}); marginals m {rel_m:.3e}, P {rel_p:.3e} "
        f"(tol {TOL_F32_MOMENTS:g}); gradients "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel_g.items())
        + f" (tol {TOL_F32_VS_F64_GRAD:g})")
    if not rel <= TOL_F32_VS_F64_LOSS:
        raise AssertionError(f"f32 loss differs from f64 by {rel:.3e}")
    if not (rel_m <= TOL_F32_MOMENTS and rel_p <= TOL_F32_MOMENTS):
        raise AssertionError("f32 marginals differ from f64")
    if not all(v <= TOL_F32_VS_F64_GRAD for v in rel_g.values()):
        raise AssertionError("f32 gradients differ from f64")
    return {k: float(v) for k, v in rel_g.items()}


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


def phase_serving(cs, adj, npk):
    log(f"phase 4a: GPR serving on a uniform grid at T = {T_FULL}, float32")
    model = build_gpr(T_FULL, torch.float32)
    counts = {}
    with launches_of(cs, adj, counts), torch.no_grad():
        losses = [model.loss() for _ in range(3)]
        marginals = [model.kalman.posterior_marginals() for _ in range(2)]
    expect_launches("the uniform requests", counts,
                    {"filter_pipeline_uniform": 5, "smoother_pipeline_uniform": 2,
                     "adjoint_pipeline_uniform": 0, "filter_pipeline": 0,
                     "smoother_scan": 0})
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
                    {"filter_pipeline_uniform": FIT_STEPS,
                     "smoother_pipeline_uniform": 0,
                     "adjoint_pipeline_uniform": FIT_STEPS,
                     "filter_pipeline": 0, "smoother_scan": 0})
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
                    {"filter_pipeline_uniform": 0, "smoother_pipeline_uniform": 0,
                     "adjoint_pipeline_uniform": 0,
                     "filter_pipeline": 2 + FIT_STEPS,
                     "smoother_scan": 1 + FIT_STEPS})
    if loss.shape != () or not torch.isfinite(loss):
        raise AssertionError(f"bad loss {loss}")
    check_marginals(marginals)
    check_fit(losses)
    log(f"  loss (f32) = {float(loss)!r}")
    rel_g = check_f32_vs_f64(model, False, loss, marginals[0])
    check_oracle_values(npk, 500, uniform=False)
    check_fd_gradients(npk, 500, uniform=False)
    return counts, rel_g


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


def kernel_device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call spent in the port's own CUDA kernels
    (namespace ``mf::``), from a torch.profiler trace of ``reps`` calls;
    0.0 when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if "mf::" in evt.key:
            for name in ("self_device_time_total", "self_cuda_time_total"):
                if hasattr(evt, name):
                    us += getattr(evt, name)
                    break
    return us / reps / 1e3


def train_step(model):
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        model.loss().backward()
        opt.step()
    return step


def phase_times(cs, adj, kf, card, counts):
    log(f"phase 5: times at T = {T_FULL}, float32, on {card}")
    uni = build_gpr(T_FULL, torch.float32)
    gen = build_gpr(T_FULL, torch.float32, uniform=False)
    k_uni, k_gen = uni.kalman, gen.kalman
    Fc, cc, Qc, mu0, P0 = (x.detach() for x in k_uni.prior_const_tl)
    hc = k_uni._const_emission_tl()
    nu, lam, _ = k_uni._site_nats_tl()
    args = (Fc, cc, Qc, mu0, P0, hc, nu, lam)
    F, c, Q = (x.detach() for x in k_gen.prior_tl)
    H = k_gen._emission_tl()
    gnu, glam, _ = k_gen._site_nats_tl()
    gargs = (F, c, Q, H, gnu, glam)
    gs = torch.ones((), dtype=torch.float32, device=DEVICE)
    from markovflow_tpu_torch.ops.kalman import smoother_elements_tl

    with torch.no_grad():
        m_fp, p_fp, _ = cs.filter_pipeline_uniform_plain(*args)
        gm_fp, gp_fp, _ = cs.filter_pipeline_plain(*gargs)
        elems = smoother_elements_tl(F, c, Q, gm_fp, gp_fp)[:3]
        errs, largest = {}, {}
        for name, got, want in (
                ("filter_pipeline_uniform", cs.filter_pipeline_uniform(*args)[:2],
                 (m_fp, p_fp)),
                ("smoother_pipeline_uniform",
                 cs.smoother_pipeline_uniform(Fc, cc, Qc, m_fp, p_fp),
                 cs.smoother_pipeline_uniform_plain(Fc, cc, Qc, m_fp, p_fp)),
                ("adjoint_pipeline_uniform",
                 adj.adjoint_pipeline_uniform(*args, None, m_fp, p_fp, gs),
                 adj.adjoint_pipeline_uniform_plain(*args, None, m_fp, p_fp, gs)),
                ("filter_pipeline", cs.filter_pipeline(*gargs)[:2], (gm_fp, gp_fp)),
                ("smoother_scan", cs.smoother_scan(*elems),
                 cs.smoother_scan_plain(*elems))):
            errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            largest[name] = max(float(w.abs().max()) for w in want)
        calls = {
            "filter_pipeline_uniform": (lambda: cs.filter_pipeline_uniform(*args),
                                        lambda: cs.filter_pipeline_uniform_plain(*args)),
            "smoother_pipeline_uniform": (
                lambda: cs.smoother_pipeline_uniform(Fc, cc, Qc, m_fp, p_fp),
                lambda: cs.smoother_pipeline_uniform_plain(Fc, cc, Qc, m_fp, p_fp)),
            # as the flagship's backward calls it: no site gradients
            "adjoint_pipeline_uniform": (
                lambda: adj.adjoint_pipeline_uniform(*args, None, m_fp, p_fp, gs,
                                                     site_grads=False),
                lambda: adj.adjoint_pipeline_uniform_plain(*args, None, m_fp,
                                                           p_fp, gs)),
            "filter_pipeline": (lambda: cs.filter_pipeline(*gargs),
                                lambda: cs.filter_pipeline_plain(*gargs)),
            "smoother_scan": (lambda: cs.smoother_scan(*elems),
                              lambda: cs.smoother_scan_plain(*elems)),
        }
    requests = {
        "uniform loss()": lambda: uni.loss(),
        "uniform posterior_marginals()": lambda: uni.kalman.posterior_marginals(),
        "jittered loss()": lambda: gen.loss(),
        "jittered posterior_marginals()": lambda: gen.kalman.posterior_marginals(),
    }
    steps = {"uniform training step": train_step(uni),
             "jittered training step": train_step(gen)}
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
            for key, (kfn, pfn) in calls.items():
                t.setdefault((turn, key), []).append(
                    cuda_ms(kfn if turn == "kernel" else pfn, reps))
    ms = {k: statistics.median(v) for k, v in t.items()}
    for key in list(requests) + list(steps):
        log(f"  {key}: kernel path {ms[('kernel', key)]!r} ms, plain path "
            f"{ms[('plain', key)]!r} ms (CUDA events, median)  [{card}]")
    dev = {}
    with torch.no_grad():
        for key, (kfn, _) in calls.items():
            dev[key] = kernel_device_ms(kfn)
    for key in calls:
        src = "on the device per call (torch.profiler)"
        if dev[key] <= 0.0:
            dev[key] = ms[("kernel", key)]
            src = "per wrapper call (the profiler saw no device time)"
        log(f"  {key} kernel: max abs diff from its plain version "
            f"{errs[key]:.3e} (largest entry {largest[key]:.3e})")
        log(f"  {key} kernel: {dev[key]!r} ms {src}; wrapper call "
            f"{ms[('kernel', key)]!r} ms, plain version {ms[('plain', key)]!r} ms "
            f"(CUDA events, median per call)  [{card}]")
    source = "markovflow_tpu_torch/ops/csrc/"
    rows = [("filter_pipeline_uniform", "uniform_scan.cuh", "pallas_scan.py:1036", "serving"),
            ("smoother_pipeline_uniform", "uniform_scan.cuh", "pallas_scan.py:1457", "serving"),
            ("adjoint_pipeline_uniform", "adjoint_scan.cuh", "pallas_scan.py:1229", "training"),
            ("filter_pipeline", "general_scan.cuh", "pallas_scan.py:849", "general"),
            ("smoother_scan", "general_scan.cuh", "pallas_scan.py:1313", "general")]
    return [{"name": name, "route": "cuda", "source": source + src,
             "replaces": "markovflow_tpu/ops/" + rep,
             "launches": counts[path][name], "max_abs_err": errs[name],
             "ms": dev[name], "plain_ms": ms[("plain", name)]}
            for name, src, rep, path in rows]


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
    t0 = time.perf_counter()
    phase_kernels_vs_plain(cs, adj)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = {}
    _, counts["serving"] = phase_serving(cs, adj, npk)
    counts["training"], _ = phase_training_uniform(cs, adj, training, npk)
    counts["general"], _ = phase_general(cs, adj, training, npk)
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
