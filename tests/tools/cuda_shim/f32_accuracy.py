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
    python tests/tools/cuda_shim/f32_accuracy.py OUT_DIR --oxo [--over-d] [--seeds 8] [--jobs J] [--json PATH]
    python3 tests/tools/cuda_shim/f32_accuracy.py --oxo [--over-d] --card [--json PATH]

TREE (default: this checkout) is the tree whose package, run_on_cpu.py and
chip_smoke.py are used; OUT_DIR must hold build.py's library of that tree's
sources, so that two trees (a parent and a change) can be held side by
side.  Prints each output's largest difference relative to the float64
output's largest entry (and of its sum over the steps, as a gradient with
respect to a constant is) per seed, then the median and maximum over the
seeds.  g++ rounds as the card does not (no fused multiply-adds), so these
compare formulations, not the card's numbers.

With ``--oxo``: kernels 1, 3, 4 and 7 at o x o sites, (d, o) = (6, o) for
o = 2..6 and the o > d pairs of OXO_OVER_D (kernels 1 and 3 to o = 6;
``--over-d``: those alone), N in OXO_NS, seeds 0..S-1 (default 8), on
chip_smoke.multi_output_kernels' per-step sites with a dense H whose entries
are not scaled to the states' spread (``scaled=False``): each output's
float32 error against the plain version in float64 on the same inputs, for
the kernel and for the plain version in float32, their ratio, and whether
the output fails chip_smoke.check_f32_wide's rule (kernel and plain
further apart than the tolerance, and the kernel's error above
F32_NO_WORSE times the plain version's).  Under the shim the cases run in
J processes; with ``--card`` they run on the CUDA card, through the
package of TREE, and OUT_DIR is not read.  ``--json`` writes every error.
"""
import argparse
import json
import multiprocessing
import statistics
import sys
from pathlib import Path

import torch


#: the o x o mode's state dim, output dims and step counts: one step (the
#: prior alone), a block and a few blocks of steps
OXO_D = 6
OXO_OS = (2, 3, 4, 5, 6)
#: the o > d pairs (d, o) of the run-time-o sources (csrc/info_scan.cuh)
OXO_OVER_D = ((1, 2), (2, 5), (4, 6), (3, 12), (6, 12))
OXO_NS = (1, 257, 4099)
_OXO = {}


def oxo_case(case):
    """One (d, o, N, seed) of the o x o mode: output -> (kernel error,
    plain error, kernel against plain, tolerance)."""
    d, o, n, seed = case
    cs, adj, chip_smoke = _OXO["cs"], _OXO["adj"], _OXO["chip_smoke"]
    out, ref = chip_smoke.multi_output_kernels(cs, adj, d, o, n, (), torch.float32, seed,
                                               device=chip_smoke.DEVICE, dense_h=True,
                                               scaled=False)
    res = {}
    for name, (got, plain, sc) in out.items():
        want = ref[name]
        scale = None if sc is None else sc.double()
        res[name] = (chip_smoke.rel_diff(got.double(), want, scale),
                     chip_smoke.rel_diff(plain.double(), want, scale),
                     chip_smoke.rel_diff(got, plain, sc),
                     chip_smoke.TOL_F32_LOGLIK if name.endswith("loglik")
                     else chip_smoke.TOL_F32_MOMENTS)
    return case, res


def oxo(cs, adj, chip_smoke, seeds: int, jobs: int, json_path, over_d=False) -> None:
    _OXO.update(cs=cs, adj=adj, chip_smoke=chip_smoke)
    pairs = list(OXO_OVER_D) if over_d else [(OXO_D, o) for o in OXO_OS] + list(OXO_OVER_D)
    cases = [(d, o, n, seed) for seed in range(seeds) for n in OXO_NS for d, o in pairs]
    if jobs > 1:
        torch.set_num_threads(1)
        with multiprocessing.get_context("fork").Pool(jobs) as pool:
            results = pool.map(oxo_case, cases, chunksize=1)
    else:
        results = [oxo_case(c) for c in cases]
    no_worse = chip_smoke.F32_NO_WORSE
    table, rows = {}, []
    for (d, o, n, seed), res in results:
        for name, (err_k, err_p, diff, tol) in res.items():
            fails = diff > tol and err_k > no_worse * err_p
            table.setdefault((name, d, o, n), []).append((seed, err_k, err_p, fails))
            rows.append({"output": name, "d": d, "o": o, "n": n, "seed": seed, "kernel": err_k,
                         "plain": err_p, "kernel_vs_plain": diff, "tol": tol,
                         "fails": fails})
    print("o x o sites, unscaled dense H, float32 against float64 "
          f"(kernel / plain; the ratio's median and max over {seeds} seeds; seeds where "
          f"the kernel is over {no_worse:g}x the plain version; seeds failing "
          "check_f32_wide's rule):", flush=True)
    worse_all = fail_all = 0
    for (name, d, o, n), per in table.items():
        ratios = [k / max(p, 1e-300) for _, k, p, _ in per]
        worse = sum(r > no_worse for r in ratios)
        fails = sum(f for *_, f in per)
        worse_all += worse
        fail_all += fails
        print(f"  {name} d={d} o={o} N={n}: kernel max {max(k for _, k, _, _ in per):.2e}, plain "
              f"max {max(p for _, _, p, _ in per):.2e}; ratio median "
              f"{statistics.median(ratios):.2f} max {max(ratios):.2f}; worse {worse}/{len(per)}"
              f"; fails {fails}/{len(per)}", flush=True)
    print(f"in all: {worse_all} of {len(rows)} (output, d, o, N, seed) over {no_worse:g}x the "
          f"plain version's error, {fail_all} failing check_f32_wide's rule", flush=True)
    if json_path is not None:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(rows))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path, nargs="?")
    ap.add_argument("--root", type=Path)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seeds", type=int)
    ap.add_argument("--oxo", action="store_true")
    ap.add_argument("--over-d", action="store_true")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    root = args.root or Path(__file__).resolve().parents[3]
    if args.card:
        if not args.oxo:
            ap.error("--card runs the --oxo mode only")
        sys.path.insert(0, str(root))
        import chip_smoke

        if not torch.cuda.is_available():
            sys.exit("f32_accuracy --card: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        cs, adj, _, _ = chip_smoke.modules()
        print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {chip_smoke.card_line()}",
              flush=True)
        return oxo(cs, adj, chip_smoke, args.seeds or 8, 1, args.json, args.over_d)
    if args.out is None:
        ap.error("OUT_DIR is needed without --card")
    sys.path.insert(0, str(root / "tests" / "tools" / "cuda_shim"))
    import run_on_cpu

    cs, adj = run_on_cpu.load(args.out.resolve())
    import chip_smoke
    from markovflow_tpu_torch.ops.kalman import make_filter_elements_tl, smoother_elements_tl

    chip_smoke.DEVICE = torch.device("cpu")
    torch.cuda.synchronize = lambda *a: None
    if args.oxo:
        return oxo(cs, adj, chip_smoke, args.seeds or 8, args.jobs, args.json, args.over_d)
    seeds = args.seeds or 5

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    errs = {}
    for seed in range(seeds):
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
