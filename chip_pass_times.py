"""Time the d <= 6 kernels per pass on one CUDA card, float32, one series:

    python3 chip_pass_times.py

at d = 2, 3 and 6 (DIMS), T = N = chip_smoke.T_FULL (1e6), REPS calls each,
and kernels 1, 3, 4 and 7 at o x o sites as their main paths call them
(chip_smoke.kernel_calls): at (d, o) = (6, 3) on mo3's inputs
(chip_smoke.build_mo3, T = N, float32: GPR's stride-0 H and lam, no mask;
the Koopman backwards as GPR's backward calls them, writing only what it
asks for) and kernel 4 at (2, 2) on bench config 2's natural-gradient
synthetic model (chip_smoke.natgrad_kernel_calls, T = 1e5, float64),
and at o > d kernels 4 and 7 at (6, 12) on fa12's jittered-grid inputs
and kernels 1 and 3 at (4, 6) on fa6c's uniform-grid ones
(chip_smoke.build_fa, T = N, float32; the backwards as a GPR backward
with a trainable loading calls them: gH, or gHc), in two series: the calls back to back, and each call after a write of
FLUSH_BYTES (five times the H100's 50 MB L2), so that no pass reads what an
earlier call left in L2.

The problems are chip_smoke.py's (uniform_problem and general_problem,
seed 0: Matern prior steps for d <= 3, a Sum of Matern kernels above, with
GPR's sites); the uniform smoother and Koopman backward take the uniform
filter kernel's moments, the smoother scan the general problem's RTS
elements, the filter scan its filtering elements and the general Koopman
backward the general filter kernel's moments; the Koopman backwards write
what the GPR backward asks for (the uniform one no site gradients).  Each
kernel's device ms per call and per pass come from a torch.profiler trace
of REPS calls (chip_smoke.kernel_device_ms, which counts only the port's
kernels, not the flushing write).  To compare two trees, run
the script of one tree from the root of each, in turns, in one call.  The
last line is one JSON object of all of it.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke

DIMS = (2, 3, 6)
N = chip_smoke.T_FULL
REPS = 20
FLUSH_BYTES = 256 << 20


def after_flush(fn, buf):
    """fn, each call after a write of buf."""
    def call():
        buf.zero_()
        return fn()
    return call


def calls(cs, adj, d, n):
    """name -> the kernel call, on the problems of state dim d, N = n."""
    from markovflow_tpu_torch.ops.kalman import (make_filter_elements_tl,
                                                 smoother_elements_tl)

    f32 = torch.float32
    uni = chip_smoke.uniform_problem(d, n, (), f32, seed=0)[:8]
    gen = chip_smoke.general_problem(d, n, (), f32, seed=0)[:6]
    gs = torch.ones((), dtype=f32, device=chip_smoke.DEVICE)
    with torch.no_grad():
        m_u, p_u, _ = cs.filter_pipeline_uniform(*uni)
        m_g, p_g, _ = cs.filter_pipeline(*gen)
        elems = smoother_elements_tl(*gen[:3], m_g, p_g)[:3]
        felems = make_filter_elements_tl(*gen)
    return {
        "filter_pipeline_uniform": lambda: cs.filter_pipeline_uniform(*uni),
        "smoother_pipeline_uniform": lambda: cs.smoother_pipeline_uniform(*uni[:3], m_u, p_u),
        "adjoint_pipeline_uniform": lambda: adj.adjoint_pipeline_uniform(
            *uni, None, m_u, p_u, gs, site_grads=False),
        "filter_pipeline": lambda: cs.filter_pipeline(*gen),
        "smoother_scan": lambda: cs.smoother_scan(*elems),
        "filter_scan": lambda: cs.filter_scan(*felems),
        "adjoint_pipeline": lambda: adj.adjoint_pipeline(*gen, None, m_g, p_g, gs,
                                                         needs=chip_smoke.GPR_NEEDS),
    }


def multi_output_calls(cs, adj):
    """name -> the kernel call of kernels 1, 3, 4 and 7 at o x o sites,
    o <= d and o > d (above)."""
    f32 = torch.float32
    mo3 = chip_smoke.kernel_calls(cs, adj, chip_smoke.build_mo3(N, f32),
                                  chip_smoke.build_mo3(N, f32, uniform=False))
    out = {f"{name} o=3 d=6": mo3[name][0]
           for name in ("filter_pipeline_uniform", "adjoint_pipeline_uniform",
                        "filter_pipeline", "adjoint_pipeline")}
    out["filter_pipeline o=2 d=2 float64"] = chip_smoke.natgrad_kernel_calls(cs)[
        "filter_pipeline"][0]
    fa_needs = (True, True, True, True, False, False)
    fa12 = chip_smoke.kernel_calls(cs, adj, None, chip_smoke.build_fa("fa12", N, f32, False),
                                   fa_needs)
    out.update((f"{name} o=12 d=6", fa12[name][0])
               for name in ("filter_pipeline", "adjoint_pipeline"))
    fa6c = chip_smoke.kernel_calls(cs, adj, chip_smoke.build_fa("fa6c", N, f32),
                                   chip_smoke.build_fa("fa6c", N, f32, False), fa_needs)
    out.update((f"{name} o=6 d=4", fa6c[name][0])
               for name in ("filter_pipeline_uniform", "adjoint_pipeline_uniform"))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_pass_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs, adj, _, _ = chip_smoke.modules()
    card = chip_smoke.card_line()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    cs.build_kernels()
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=chip_smoke.DEVICE)
    out = {}
    named = [(f"{name} d={d}", fn) for d in DIMS for name, fn in calls(cs, adj, d, N).items()]
    named += list(multi_output_calls(cs, adj).items())
    for name, fn in named:
        for series, f in (("", fn), (" L2 flushed", after_flush(fn, buf))):
            with torch.no_grad():
                ms, passes = chip_smoke.kernel_device_ms(f, REPS)
            out[f"{name}{series}"] = {
                "ms": ms, "passes": {k: t for k, (t, _) in passes.items()}}
            print(f"  {name}{series}: {ms!r} ms; " + "; ".join(
                f"{k} {t!r}" for k, (t, _) in passes.items()), flush=True)
    print(json.dumps({"card": card, "n": N, "times": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
