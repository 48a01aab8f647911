"""Drive the PyTorch port's GPR serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: a CUDA card must be present (no CPU fallback); print its name and
   power limit as nvidia-smi reports them;
2. build the CUDA kernels from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card:
   N in {4099, 1e6}, batch () and (3,), d in {1, 2, 3} (Matern12/32/52
   constants), float64 and float32, plus one masked case;
4. the slice at full size: the flagship GPR (Matern32(0.5, 1.0), noise
   Cholesky 0.2, T = 1e6 points on linspace(0, 100), float32) answers
   loss() three times and kalman.posterior_marginals() twice through the
   kernels (launch counters), agrees with the same model in float64, and a
   small float64 model agrees with the sequential numpy Kalman oracle in
   tests/tools/numpy_kalman.py;
5. times per request and per kernel, kernel path against plain path, with
   CUDA events after a warm-up (median of several runs); each kernel's
   device time per call from a torch.profiler trace (the wrapper's call
   time also holds its host work, which exceeds the kernel's).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

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
# float64: the kernels and the plain versions compose the same elements in
# different orders, so they agree to a few hundred ulps of the largest entry.
TOL_F64 = 1e-9
# float32: the two bracketings of ~log2(N) compositions, each with a d x d
# inverse of (I + C J), differ by float32 roundoff amplified by those
# inverses; the likelihood is a sum of N terms and is compared relatively.
TOL_F32_MOMENTS = 1e-3
TOL_F32_LOGLIK = 1e-4
# f32 kernel path against the f64 kernel path for the T = 1e6 GPR loss; the
# JAX package measured 9.6e-7 for the same comparison on its own kernels.
TOL_F32_VS_F64_LOSS = 1e-5
KERNEL_NAMES = {1: "Matern12", 2: "Matern32", 3: "Matern52"}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (normwise, so near-zero entries do
    not dominate)."""
    scale = want.abs().max().clamp_min(torch.finfo(want.dtype).tiny)
    return float((got - want).abs().max() / scale)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def uniform_problem(d, n, batch, dtype, seed, masked=False):
    """Constant Matern prior steps on linspace(0, 100, n) with sites
    y = sin(2x) + 0.2 noise (noise variance 0.04)."""
    from markovflow_tpu_torch import kernels

    dev = torch.device("cuda")
    k = getattr(kernels, KERNEL_NAMES[d])(lengthscale=0.5, variance=1.0,
                                         dtype=dtype, device=dev)
    dt = torch.full((1,), 100.0 / (n - 1), dtype=dtype, device=dev)
    with torch.no_grad():
        fc, cc, qc, mu0, p0 = k.prior_const_tl(dt)
    hc = torch.zeros((1, d, 1), dtype=dtype, device=dev)
    hc[0, 0, 0] = 1.0
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 100.0, n)
    y = np.sin(2.0 * x) + 0.2 * rng.standard_normal(batch + (n,))
    nu = torch.as_tensor(y / 0.04, dtype=dtype, device=dev)[..., None, None, :]
    lam = torch.full((1, 1, 1), 1.0 / 0.04, dtype=dtype,
                     device=dev).expand(batch + (1, 1, n))
    maskf = None
    if masked:
        maskf = torch.as_tensor(rng.random(batch + (n,)) > 0.3, dtype=dtype,
                                device=dev)[..., None, None, :]
    return (fc, cc, qc, mu0, p0, hc, nu, lam, maskf)


def phase_kernels_vs_plain(ops):
    log("phase 3: kernels against their plain versions on the card")
    cases = [(n, batch, d, dtype, False)
             for dtype in (torch.float64, torch.float32)
             for n in (4099, T_FULL) for batch in ((), (3,)) for d in (1, 2, 3)]
    cases.append((4099, (3,), 2, torch.float64, True))
    cases.append((4099, (3,), 2, torch.float32, True))
    for i, (n, batch, d, dtype, masked) in enumerate(cases):
        args = uniform_problem(d, n, batch, dtype, seed=i, masked=masked)
        fc, cc, qc = args[:3]
        with torch.no_grad():
            m_k, p_k, ll_k = ops.filter_pipeline_uniform(*args)
            m_p, p_p, ll_p = ops.filter_pipeline_uniform_plain(*args)
            ms_k, ps_k = ops.smoother_pipeline_uniform(fc, cc, qc, m_p, p_p)
            ms_p, ps_p = ops.smoother_pipeline_uniform_plain(fc, cc, qc, m_p, p_p)
        torch.cuda.synchronize()
        f64 = dtype == torch.float64
        tol_m = TOL_F64 if f64 else TOL_F32_MOMENTS
        tol_ll = TOL_F64 if f64 else TOL_F32_LOGLIK
        diffs = {"m_f": rel_diff(m_k, m_p), "P_f": rel_diff(p_k, p_p),
                 "loglik": rel_diff(ll_k, ll_p), "m_s": rel_diff(ms_k, ms_p),
                 "P_s": rel_diff(ps_k, ps_p)}
        tols = {"m_f": tol_m, "P_f": tol_m, "loglik": tol_ll, "m_s": tol_m,
                "P_s": tol_m}
        tag = (f"N={n} batch={batch} d={d} {str(dtype)[6:]}"
               + (" masked" if masked else ""))
        log(f"  {tag}: max rel diff "
            + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
            + f" (tol {tol_m:g} / loglik {tol_ll:g})")
        for key, val in diffs.items():
            if not (np.isfinite(val) and val <= tols[key]):
                raise AssertionError(f"{tag}: {key} differs by {val:.3e} "
                                     f"> {tols[key]:g}")


def flagship_data(n):
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 100.0, n)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(n))[:, None]
    return x, y


def flagship_params():
    from markovflow_tpu_torch.utils.bijectors import positive

    return {"kernel.lengthscale": positive().inverse(np.asarray(0.5)),
            "kernel.variance": positive().inverse(np.asarray(1.0)),
            "chol_obs_covariance": np.asarray([[0.2]])}


def build_gpr(n, dtype):
    from markovflow_tpu_torch.convert import gpr_from_numpy

    x, y = flagship_data(n)
    model = gpr_from_numpy(flagship_params(), x, y, device=torch.device("cuda"),
                           dtype=dtype, kernel="Matern32")
    if not model._uniform_grid:
        raise AssertionError("the flagship grid was not detected as uniform")
    return model


def load_numpy_oracle():
    """tests/tools/numpy_kalman.py, loaded by path (its package imports JAX)."""
    path = ROOT / "tests" / "tools" / "numpy_kalman.py"
    spec = importlib.util.spec_from_file_location("numpy_kalman", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice(ops):
    log(f"phase 4: the GPR slice at T = {T_FULL}, float32, on the card")
    model = build_gpr(T_FULL, torch.float32)
    ops.filter_pipeline_uniform.launches = 0
    ops.smoother_pipeline_uniform.launches = 0
    with torch.no_grad():
        losses = [model.loss() for _ in range(3)]
        marginals = [model.kalman.posterior_marginals() for _ in range(2)]
    torch.cuda.synchronize()
    launches = {"filter_pipeline_uniform": ops.filter_pipeline_uniform.launches,
                "smoother_pipeline_uniform": ops.smoother_pipeline_uniform.launches}
    log(f"  launches during the requests: {launches}")
    if launches["filter_pipeline_uniform"] < 5 or \
            launches["smoother_pipeline_uniform"] < 2:
        raise AssertionError(f"the requests did not run through the kernels: "
                             f"{launches}")
    for loss in losses:
        if loss.shape != () or not torch.isfinite(loss):
            raise AssertionError(f"bad loss {loss}")
    for m_s, p_s in marginals:
        if m_s.shape != (T_FULL, 2) or p_s.shape != (T_FULL, 2, 2):
            raise AssertionError(f"bad marginal shapes {m_s.shape} {p_s.shape}")
        if not (torch.isfinite(m_s).all() and torch.isfinite(p_s).all()):
            raise AssertionError("non-finite posterior marginals")
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

    # a small float64 model against the sequential numpy oracle
    npk = load_numpy_oracle()
    n = 500
    small = build_gpr(n, torch.float64)
    with torch.no_grad():
        ll = float(small.log_likelihood())
        m_s, p_s = small.kalman.posterior_marginals()
        fc, cc, qc, mu0, p0 = (t.cpu().numpy() for t in small.kernel.prior_const_tl(
            torch.full((1,), 100.0 / (n - 1), dtype=torch.float64,
                       device="cuda")))
    _, y = flagship_data(n)
    a = np.broadcast_to(fc[..., 0], (n - 1, 2, 2))
    b = np.broadcast_to(cc[:, 0, 0], (n - 1, 2))
    q = np.broadcast_to(qc[..., 0], (n - 1, 2, 2))
    mf, pf, _, _, ll_ref = npk.kalman_filter(
        mu0[:, 0, 0], p0[..., 0], a, b, q, np.asarray([[1.0, 0.0]]),
        np.asarray([[0.04]]), y)
    ms_ref, ps_ref, _ = npk.rts_smoother(mf, pf, a, b, q)
    e_ll = abs(ll - ll_ref) / abs(ll_ref)
    e_m = float(np.abs(m_s.cpu().numpy() - ms_ref).max())
    e_p = float(np.abs(p_s.cpu().numpy() - ps_ref).max())
    log(f"  N={n} f64 vs sequential numpy oracle: loglik rel {e_ll:.3e}, "
        f"m_s abs {e_m:.3e}, P_s abs {e_p:.3e} (tol 1e-9)")
    if not (e_ll <= 1e-9 and e_m <= 1e-9 and e_p <= 1e-9):
        raise AssertionError("the port disagrees with the numpy oracle")
    return model, launches


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


def phase_times(ops, model, card, launches):
    log(f"phase 5: times at T = {T_FULL}, float32, on {card}")
    kf = model.kalman
    Fc, cc, Qc, mu0, P0 = kf.prior_const_tl
    hc = kf._const_emission_tl()
    nu, lam, _ = kf._site_nats_tl()
    args = (Fc, cc, Qc, mu0, P0, hc, nu, lam)

    def loss_plain():
        k = model.kalman
        n_, l_, _ = k._site_nats_tl()
        return -ops.filter_pipeline_uniform_plain(
            *k.prior_const_tl, k._const_emission_tl(), n_, l_)[2]

    def marginals_plain():
        k = model.kalman
        n_, l_, _ = k._site_nats_tl()
        fc_, cc_, qc_, m0_, p0_ = k.prior_const_tl
        m_f, p_f, _ = ops.filter_pipeline_uniform_plain(
            fc_, cc_, qc_, m0_, p0_, k._const_emission_tl(), n_, l_)
        return ops.smoother_pipeline_uniform_plain(fc_, cc_, qc_, m_f, p_f)

    with torch.no_grad():
        m_f, p_f, _ = ops.filter_pipeline_uniform(*args)
        m_fp, p_fp, _ = ops.filter_pipeline_uniform_plain(*args)
        ms_k, ps_k = ops.smoother_pipeline_uniform(Fc, cc, Qc, m_fp, p_fp)
        ms_p, ps_p = ops.smoother_pipeline_uniform_plain(Fc, cc, Qc, m_fp, p_fp)
        err_f = max(float((m_f - m_fp).abs().max()), float((p_f - p_fp).abs().max()))
        err_s = max(float((ms_k - ms_p).abs().max()), float((ps_k - ps_p).abs().max()))
        # turns: plain, kernel, kernel, plain; the medians of both turns
        t = {}
        for turn in ("plain", "kernel", "kernel", "plain"):
            if turn == "plain":
                runs = {"loss": (loss_plain, 5), "marginals": (marginals_plain, 5),
                        "filter": (lambda: ops.filter_pipeline_uniform_plain(*args), 5),
                        "smoother": (lambda: ops.smoother_pipeline_uniform_plain(
                            Fc, cc, Qc, m_fp, p_fp), 5)}
            else:
                runs = {"loss": (model.loss, 20),
                        "marginals": (lambda: model.kalman.posterior_marginals(), 20),
                        "filter": (lambda: ops.filter_pipeline_uniform(*args), 20),
                        "smoother": (lambda: ops.smoother_pipeline_uniform(
                            Fc, cc, Qc, m_fp, p_fp), 20)}
            for key, (fn, reps) in runs.items():
                t.setdefault((turn, key), []).append(cuda_ms(fn, reps))
        dev = {"filter": kernel_device_ms(lambda: ops.filter_pipeline_uniform(*args)),
               "smoother": kernel_device_ms(lambda: ops.smoother_pipeline_uniform(
                   Fc, cc, Qc, m_fp, p_fp))}
    ms = {k: statistics.median(v) for k, v in t.items()}
    for key in ("loss", "marginals"):
        log(f"  {key} request: kernel path {ms[('kernel', key)]!r} ms, plain path "
            f"{ms[('plain', key)]!r} ms (CUDA events, median per request)  [{card}]")
    for key in ("filter", "smoother"):
        src = "on the device per call (torch.profiler)"
        if dev[key] <= 0.0:
            dev[key] = ms[("kernel", key)]
            src = "per wrapper call (the profiler saw no device time)"
        log(f"  {key} kernel: {dev[key]!r} ms {src}; "
            f"wrapper call {ms[('kernel', key)]!r} ms, plain version "
            f"{ms[('plain', key)]!r} ms (CUDA events, median per call)  [{card}]")
    return [
        {"name": "filter_pipeline_uniform", "route": "cuda",
         "source": "markovflow_tpu_torch/ops/csrc/uniform_scan.cuh",
         "replaces": "markovflow_tpu/ops/pallas_scan.py:1036",
         "launches": launches["filter_pipeline_uniform"], "max_abs_err": err_f,
         "ms": dev["filter"], "plain_ms": ms[("plain", "filter")]},
        {"name": "smoother_pipeline_uniform", "route": "cuda",
         "source": "markovflow_tpu_torch/ops/csrc/uniform_scan.cuh",
         "replaces": "markovflow_tpu/ops/pallas_scan.py:1457",
         "launches": launches["smoother_pipeline_uniform"], "max_abs_err": err_s,
         "ms": dev["smoother"], "plain_ms": ms[("plain", "smoother")]},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from markovflow_tpu_torch.ops import cuda_scan as ops

    card = card_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    ops.build_kernels()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    phase_kernels_vs_plain(ops)
    model, launches = phase_slice(ops)
    kernels = phase_times(ops, model, card, launches)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
