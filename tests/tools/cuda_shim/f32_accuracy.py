"""Float32 accuracy of the d <= 6 filter, smoother and Koopman backward
kernels on the CPU, through the library of build.py: each kernel's float32
outputs against the plain versions in float64, at d = 2, with dense sites and
with sparse ones (lam = nu = 0 at 30% of the steps): the general filter and
Koopman backward on the flagship's jittered-grid problem
(chip_smoke.general_problem), the uniform filter, smoother and Koopman
backward on its uniform-grid problem (chip_smoke.uniform_problem; the
latter two from the uniform filter's moments in each precision), and the
smoother scan and the filter scan on the jittered problem's smoothing
elements (from the float64 filter's moments) and filtering elements, each
rounded to float32:

    python tests/tools/cuda_shim/f32_accuracy.py OUT_DIR [--root TREE] [--n N] [--seeds S]

TREE (default: this checkout) is the tree whose package, run_on_cpu.py and
chip_smoke.py are used; OUT_DIR must hold build.py's library of that tree's
sources, so that two trees (a parent and a change) can be held side by
side.  Prints each output's largest difference relative to the float64
output's largest entry (and of its sum over the steps, as a gradient with
respect to a constant is) per seed, then the median and maximum over the
seeds.  g++ rounds as the card does not (no fused multiply-adds), so these
compare formulations, not the card's numbers.
"""
import argparse
import statistics
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path)
    ap.add_argument("--root", type=Path)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    root = args.root or Path(__file__).resolve().parents[3]
    sys.path.insert(0, str(root / "tests" / "tools" / "cuda_shim"))
    import run_on_cpu

    cs, adj = run_on_cpu.load(args.out.resolve())
    import chip_smoke
    from markovflow_tpu_torch.ops.kalman import make_filter_elements_tl, smoother_elements_tl

    chip_smoke.DEVICE = torch.device("cpu")
    torch.cuda.synchronize = lambda *a: None

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    errs = {}
    for seed in range(args.seeds):
        for sparse in (False, True):
            g64 = list(chip_smoke.general_problem(2, args.n, (), torch.float64, seed=seed,
                                                  masked=sparse))
            if sparse:
                g64[4], g64[5] = g64[4] * g64[6], g64[5] * g64[6]
            g32 = [None if x is None else x.float() for x in g64]
            m64, p64, ll64 = cs.filter_pipeline_plain(*g64)
            m32, p32, ll32 = cs.filter_pipeline(*g32)
            one = torch.ones((), dtype=torch.float64)
            a64 = adj.adjoint_pipeline_plain(*g64, m64, p64, one)
            a32 = adj.adjoint_pipeline(*g32, m32, p32, one.float())
            e = {"m_f": rel(m32, m64), "P_f": rel(p32, p64), "loglik": rel(ll32, ll64)}
            u64 = list(chip_smoke.uniform_problem(2, args.n, (), torch.float64, seed=seed,
                                                  masked=sparse))
            if sparse:
                u64[6], u64[7] = u64[6] * u64[8], u64[7] * u64[8]
            u32 = [None if x is None else x.float() for x in u64]
            um32, up32, ull32 = cs.filter_pipeline_uniform(*u32)
            um64, up64, ull64 = cs.filter_pipeline_uniform_plain(*u64)
            for name, x32, x64 in zip(("uniform m_f", "uniform P_f", "uniform loglik"),
                                      (um32, up32, ull32), (um64, up64, ull64)):
                e[name] = rel(x32, x64)
            for name, x32, x64 in zip(("uniform m_s", "uniform P_s"),
                                      cs.smoother_pipeline_uniform(*u32[:3], um32, up32),
                                      cs.smoother_pipeline_uniform_plain(*u64[:3], um64, up64)):
                e[name] = rel(x32, x64)
            for name, x32, x64 in zip(chip_smoke.ADJ_OUT,
                                      adj.adjoint_pipeline_uniform(*u32, um32, up32, one.float()),
                                      adj.adjoint_pipeline_uniform_plain(*u64, um64, up64, one)):
                e["uniform " + name] = rel(x32, x64)
            s64 = smoother_elements_tl(*g64[:3], m64, p64)[:3]
            for name, x32, x64 in zip(("scan m_s", "scan P_s"),
                                      cs.smoother_scan(*(x.float() for x in s64)),
                                      cs.smoother_scan_plain(*s64)):
                e[name] = rel(x32, x64)
            f64 = make_filter_elements_tl(*g64[:6])
            for name, x32, x64 in zip(("scan m_f", "scan P_f"),
                                      cs.filter_scan(*(x.float() for x in f64)),
                                      cs.filter_scan_plain(*f64)):
                e[name] = rel(x32, x64)
            for name, x32, x64 in zip(("gF", "gc", "gQ", "gH", "gnu", "glam"), a32, a64):
                e[name] = rel(x32, x64)
                e["sum " + name] = rel(x32.double().sum(-1), x64.sum(-1))
            kind = "sparse" if sparse else "dense"
            print(f"seed {seed} {kind}: " + " ".join(f"{k}={v:.2e}" for k, v in e.items()),
                  flush=True)
            for k, v in e.items():
                errs.setdefault((kind, k), []).append(v)
    for (kind, k), v in errs.items():
        print(f"{kind} {k}: median {statistics.median(v):.2e} max {max(v):.2e}")


if __name__ == "__main__":
    main()
