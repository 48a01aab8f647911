"""Time and check kernel 4's two site routes above state dim 6 on one CUDA
card, on the general filter's inputs of chip_smoke.py's phase-4l models:

    python3 chip_wide_forms.py

Kernel 4 at o = 2..12, d = 7..12 (markovflow_tpu_torch/ops/csrc/
wide_info.cuh) folds each step's o x o site into state space where lam's
step stride is 0 (winfo_fold in pass 1, winfo_kalman_step in pass 3), and
builds each step's filtering element where lam changes with the step
(winfo_element, composed by WideFilterOp in pass 1, with winfo_loglik_lam
and wide_filter_moments in pass 3).  mo9 and fa9 at T = 1e5 (both grids,
float32 and float64) pass one noise precision, lam of stride 0; the same
lam stored at every step sends the same problem down the element form.
For each route: ms per call (CUDA events, median of 20 calls after 3),
and m_f, P_f (normwise, relative to the largest entry) and the
log-likelihood (relative) against the plain version in float64 on the
float64 model's inputs.  The last line is one JSON object of all of it.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs_smoke

CALLS, WARMUP = 20, 3


def filter_inputs(model):
    """(F, c, Q, H, nu, lam) of the model's general filter, as its loss
    passes them."""
    k = model.kalman
    f, c, q = k.prior_tl
    nu, lam, mask = k._site_nats_tl()
    if mask is not None:
        raise AssertionError("phase 4l's models have no mask")
    return f, c, q, k._emission_tl(), nu, lam


def rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def measure(cs, name, uniform, device, n=cs_smoke.T_D9, calls=CALLS, warmup=WARMUP):
    """The two routes of kernel 4 on one model and grid, both dtypes."""
    with torch.no_grad():
        ref64 = filter_inputs(cs_smoke.build_wide(name, n, torch.float64, uniform, device))
        want = cs.filter_pipeline_plain(*ref64)
        out = {}
        for dtype in (torch.float32, torch.float64):
            args = filter_inputs(cs_smoke.build_wide(name, n, dtype, uniform, device))
            if args[5].stride(-1) != 0:
                raise AssertionError(f"{name}: lam changes with the step")
            routes = {"fold (lam of stride 0)": args,
                      "element form (lam at every step)": args[:5] + (args[5].contiguous(),)}
            for route, a in routes.items():
                got = cs.filter_pipeline(*a)
                errs = {k: rel(g, w) for k, g, w in zip(("m_f", "P_f", "loglik"), got, want)}
                if not all(v == v and v < float("inf") for v in errs.values()):
                    raise AssertionError(f"{name} {route}: non-finite output")
                ms = cs_smoke.cuda_ms(lambda a=a: cs.filter_pipeline(*a), calls, warmup)
                out[f"{str(dtype)[6:]} {route}"] = {"ms": ms, **errs}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from markovflow_tpu_torch.ops import cuda_scan as cs

    card = cs_smoke.card_line()
    print(card, flush=True)
    cs.build_kernels()
    res = {}
    for name in ("mo9", "fa9"):
        for uniform in (True, False):
            key = f"{name} {'uniform' if uniform else 'jittered'}"
            res[key] = measure(cs, name, uniform, cs_smoke.DEVICE)
            for route, r in res[key].items():
                print(f"{key} {route}: {r['ms']!r} ms; vs float64 plain: m_f {r['m_f']:.3e} "
                      f"P_f {r['P_f']:.3e} loglik {r['loglik']:.3e}  [{card}]", flush=True)
    print(json.dumps({"card": card, "kernel 4 routes": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
