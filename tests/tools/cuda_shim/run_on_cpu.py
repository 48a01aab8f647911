"""Run the port's kernel wrappers' CUDA branch on CPU tensors through the
library of build.py, against the plain versions, in float64:

    python tests/tools/cuda_shim/run_on_cpu.py OUT_DIR D:N:BATCH[:sparse|:multi] ...

e.g. ``9:4099:(3,)`` (state dim 9, 4,099 steps, batch (3,), a mask),
``9:300:(2,):sparse`` (lam = nu = 0 at the masked steps) or ``3:1100:(2,):multi``
(only the general filter, at o x o sites for o = 2..d: chip_smoke's
multi_output_problem with H and lam stored at every step, and for o = d
also with both stride 0).  A copy of the
package in OUT_DIR takes the CUDA branch for CPU tensors; each case prints
every kernel's largest difference from its plain version, relative to the
plain output's largest entry.  At small N, since the lanes run as threads:
d = 12 at N = 4099 with batch (3,) takes a few minutes.

``load(OUT_DIR)`` returns the patched (cuda_scan, adjoint) modules, for
driving chip_smoke.py's phase-3 check (``kernels_vs_plain_case``) on the
CPU with its ``DEVICE`` set to the CPU and ``torch.cuda.synchronize`` a
no-op.
"""
import contextlib
import ctypes
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]


def load(out: Path):
    pkg = out / "pkg"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "markovflow_tpu_torch", pkg / "markovflow_tpu_torch")
    for name in ("ops/cuda_scan.py", "ops/adjoint.py"):
        f = pkg / "markovflow_tpu_torch" / name
        f.write_text(f.read_text()
                     .replace('.device.type == "cpu"', '.device.type == "none"')
                     .replace('.device.type != "cuda"', '.device.type not in ("cuda", "cpu")'))
    sys.path.insert(0, str(pkg))
    sys.path.append(str(ROOT))  # chip_smoke; the patched package comes first
    from markovflow_tpu_torch.ops import adjoint, cuda_scan

    lib = ctypes.CDLL(str(out / "libmarkovflow_scans.so"))
    cuda_scan._declare(lib)
    cuda_scan._LIB = lib
    cuda_scan._stream = lambda device: 0
    torch.cuda.device = lambda device: contextlib.nullcontext()
    return cuda_scan, adjoint


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def problems(d, n, batch, sparse):
    """A constant SSM and a per-step one (F_0 = 0) with sites and a mask,
    float64, as tests/port/test_torch_cuda.py makes them."""
    rng = np.random.default_rng(d)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731

    def contraction(shape):
        f = 0.8 * np.eye(d) + 0.3 * rng.standard_normal(shape + (d, d)) / np.sqrt(d)
        return f * (0.95 / np.maximum(np.abs(np.linalg.eigvals(f)).max(-1), 0.95))[..., None, None]

    def sites():
        keep = (rng.random(batch + (1, 1, n)) > 0.3).astype(float)
        nu, lam = rng.standard_normal(batch + (1, 1, n)), 2.0 + rng.random(batch + (1, 1, n))
        if sparse:
            nu, lam = nu * keep, lam * keep
        return [t(nu), t(lam), t(keep)]

    lq = 0.2 * rng.standard_normal((d, d)) + np.eye(d)
    uni = [t(contraction(())[..., None]), t(0.1 * rng.standard_normal((d, 1, 1))),
           t((lq @ lq.T)[..., None]), t(rng.standard_normal((d, 1, 1))),
           t(1.5 * np.eye(d)[..., None]), t(rng.standard_normal((1, d, 1))), *sites()]
    f = contraction(batch + (n,))
    lq = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    q = lq @ np.swapaxes(lq, -1, -2)
    f[..., 0, :, :], q[..., 0, :, :] = 0.0, 1.5 * np.eye(d)
    gen = [t(np.moveaxis(f, -3, -1)), t(0.1 * rng.standard_normal(batch + (d, 1, n))),
           t(np.moveaxis(q, -3, -1)), t(rng.standard_normal((1, d, 1))).expand(batch + (1, d, n)),
           *sites()]
    return uni, gen


def check_multi(cs, d, n, batch):
    """The general filter at o = 2..d against its plain version."""
    import chip_smoke

    out = {}
    for o in range(2, d + 1):
        for const in (False, True) if o == d else (False,):
            args = chip_smoke.multi_output_problem(d, o, n, batch, torch.float64, seed=n,
                                                   device="cpu", const_sites=const)
            tag = f"o{o}{'c' if const else ''} "
            for name, got, want in zip(("m_f", "P_f", "loglik"), cs.filter_pipeline(*args),
                                       cs.filter_pipeline_plain(*args)):
                out[tag + name] = rel(got, want)
    return out


def check(cs, adj, d, n, batch, sparse=False):
    import chip_smoke
    from markovflow_tpu_torch.ops.kalman import make_filter_elements_tl, smoother_elements_tl

    uni, gen = problems(d, n, batch, sparse)
    out = {}
    m_p, p_p, ll_p = cs.filter_pipeline_uniform_plain(*uni)
    for name, got, want in zip(("m_f", "P_f", "loglik"), cs.filter_pipeline_uniform(*uni),
                               (m_p, p_p, ll_p)):
        out["uniform " + name] = rel(got, want)
    for name, got, want in zip(("m_s", "P_s"), cs.smoother_pipeline_uniform(*uni[:3], m_p, p_p),
                               cs.smoother_pipeline_uniform_plain(*uni[:3], m_p, p_p)):
        out["uniform " + name] = rel(got, want)
    gs = torch.linspace(0.5, -1.5, max(1, math.prod(batch)), dtype=torch.float64).reshape(batch)
    if d <= adj.UNIFORM_ADJOINT_MAX_STATE_DIM:
        for name, got, want in zip(chip_smoke.ADJ_OUT,
                                   adj.adjoint_pipeline_uniform(*uni, m_p, p_p, gs),
                                   adj.adjoint_pipeline_uniform_plain(*uni, m_p, p_p, gs)):
            out["uniform " + name] = rel(got, want)
    m_p, p_p, ll_p = cs.filter_pipeline_plain(*gen)
    for name, got, want in zip(("m_f", "P_f", "loglik"), cs.filter_pipeline(*gen),
                               (m_p, p_p, ll_p)):
        out[name] = rel(got, want)
    elems = smoother_elements_tl(*gen[:3], m_p, p_p)[:3]
    for name, got, want in zip(("m_s", "P_s"), cs.smoother_scan(*elems),
                               cs.smoother_scan_plain(*elems)):
        out[name] = rel(got, want)
    relems = chip_smoke.random_smoother_elements(d, n, batch, torch.float64, "cpu")
    for name, got, want in zip(("random m_s", "random P_s"), cs.smoother_scan(*relems),
                               cs.smoother_scan_plain(*relems)):
        out[name] = rel(got, want)
    felems = make_filter_elements_tl(*gen[:6])
    for name, got, want in zip(("scan m_f", "scan P_f"), cs.filter_scan(*felems),
                               cs.filter_scan_plain(*felems)):
        out[name] = rel(got, want)
    relems = chip_smoke.random_filter_elements(d, n, batch, torch.float64, "cpu")
    for name, got, want in zip(("random scan m_f", "random scan P_f"), cs.filter_scan(*relems),
                               cs.filter_scan_plain(*relems)):
        out[name] = rel(got, want)
    for name, got, want in zip(("gF", "gc", "gQ", "gH", "gnu", "glam"),
                               adj.adjoint_pipeline(*gen, m_p, p_p, gs),
                               adj.adjoint_pipeline_plain(*gen, m_p, p_p, gs)):
        out[name] = rel(got, want)
    return out


if __name__ == "__main__":
    cs, adj = load(Path(sys.argv[1]).resolve())
    worst = 0.0
    for case in sys.argv[2:]:
        d, n, batch, *flag = case.split(":")
        if flag == ["multi"]:
            res = check_multi(cs, int(d), int(n), eval(batch))
        else:
            res = check(cs, adj, int(d), int(n), eval(batch), flag == ["sparse"])
        worst = max(worst, *res.values())
        print(f"{case}: " + " ".join(f"{k}={v:.1e}" for k, v in res.items()), flush=True)
    print(f"worst {worst:.2e}")
