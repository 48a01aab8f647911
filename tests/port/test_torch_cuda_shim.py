"""The CUDA sources of markovflow_tpu_torch/ops/csrc/ on the CPU.

The module builds every unit once with g++ against the stand-in CUDA runtime
of tests/tools/cuda_shim/ (lanes as threads, cp.async as a plain copy; see
its build.py), then runs the wrappers' CUDA branch on CPU tensors through
that library against the plain versions, in float64, in a fresh process
(tests/tools/cuda_shim/run_on_cpu.py, which puts a patched copy of the
package first on sys.path).  A case is D:N:BATCH[:sparse]; every kernel
output must lie within TOL of its plain version, relative to the plain
output's largest entry.  Skips without g++.

    python -m pytest tests/port/test_torch_cuda_shim.py
"""
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

SHIM = Path(__file__).resolve().parents[1] / "tools" / "cuda_shim"
# float64: the kernels compose in another order than the plain versions;
# these cases differ by 1e-13 at most (the general Koopman backward's glam)
TOL = 1e-12


# d = 7..12 (csrc/wide_scan.cuh, the wide routes), then d <= 6: the filter
# passes (general, uniform, filter scan), the Koopman backwards' register
# passes and the smoothers' across two or more blocks of steps, at d = 2
# (R = 8) and d = 3 (R = 4; the filter scan's largest staged d), staged
# through shared memory and at d = 5 not (but the uniform kernels'),
# sparse sites, d = 6 across three blocks of the uniform kernels' staged
# passes (four warps a block in float64), and d = 4 across two blocks of
# the smoother scan's last staged tile (five warps a block in float64); and
# the general filter alone at o = 2 (d = 2, staged, two blocks; H and lam
# stored at every step and both stride 0).  At o >= 3 the plain version
# itself strays from a sequential float64 recursion by up to ~2e-11 in P_f
# (the kernel by 4e-12): the card's tests hold those at 1e-9.  Then kernels
# 1, 3 and 7 (and 4) at o x o sites, (d, o) = (3, 2) and (4, 3), across
# two blocks of kernel 1's staged passes and three of the backwards'
# pass 3, per-step sites with a dense H, stride-0 ones (the rank-o routes
# of kernels 1 and 4) over 2 N + 1 steps, across pass 1's blocks of
# kernel 4's 8-step runs and kernels 3's and 7's at d = 4 (1,024 and
# 2,048 steps; kernel 1's 16-step blocks, 3,072 steps there, are crossed
# on the card at N = 4099), and stride-0 ones without a mask; and the four
# sources at o > d (info_scan.cuh: kernels 1, 3, 7 and 4 with a run-time
# o) at (d, o) = (3, 5), across three blocks of their unstaged passes; and
# kernels 4 and 7 above d = 6 (wide_info.cuh, run-time d and o) at N = 9,
# across a chunk edge of both and a warp's run of 8 steps: kernel 4's
# d-space fold and kernel 7 at mo9's (9, 3) on stride-0 H and lam, and
# kernel 4's element form on per-step sites, all three at (7, 12)
CASES = ["7:97:(2,)", "9:300:()", "9:64:(2,):sparse", "12:50:(2,)",
         "2:2100:(2,)", "2:700:(2,):sparse", "5:600:()", "3:1100:(2,)", "6:1100:()",
         "4:1100:(2,)", "2:2100:(2,):multi", "3:1100:(2,):o2", "4:1100:(2,):o3",
         "3:1100:(2,):o5", "9:9:(2,):o3", "7:9:():o12"]
# the o x o cases at o = 3 hold P_f to the plain version, which strays by
# ~2e-11 there (above); the kernels differ from it by 4.5e-12 at most
TOL_O = 1e-10
# the outputs of a case: the uniform filter (3) and smoother (2), the
# uniform Koopman backward (8, at d <= 6), the general filter (3), the
# smoother scan of the problem's elements and of random ones (2 + 2), the
# filter scan of the problem's elements and of random ones (2 + 2), the
# general Koopman backward (6); a multi case: m_f, P_f and loglik at each
# o = 2..d, and at o = d also with stride-0 sites; an o case: the uniform
# filter (3), the uniform Koopman backward with all its outputs, without
# the site gradients and without them and gHc (the lean pass 3, as GPR's
# backward asks: 8 + 6 + 5), the general filter (3) and Koopman backward
# with all six outputs and with GPR's three (6 + 3), for per-step sites,
# stride-0 ones and stride-0 ones without a mask (above d = 6 the general
# kernels' only: 3 + 6 + 3 for each)
N_OUTPUTS = {True: 30, False: 22}


def n_outputs(case: str) -> int:
    d = int(case.split(":")[0])
    if case.endswith(":multi"):
        return 3 * d
    if ":o" in case:
        return 102 if d <= 6 else 36
    return N_OUTPUTS[d <= 6]
# a case takes 5-15 s alone (lanes as fibers, one core each)
CASE_SECONDS = 300


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    """The directory of the library, built once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_shim")
    build = subprocess.run([sys.executable, str(SHIM / "build.py"), str(out)],
                           capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stdout + build.stderr
    return out


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_versions_under_the_shim(shim_lib, case):
    """d = 7, 9 and 12, N below and above a few warps' runs of steps; d = 2,
    3, 4, 5 and 6 across a block's tile of steps; a batch, a mask, and sparse
    sites (lam = nu = 0 where masked): all seven kernels (the uniform Koopman
    backward at d <= 6, with the site gradients), and the smoother scan and
    the filter scan also on random prebuilt elements; the general filter at
    o x o sites; kernels 1, 3 and 7 at o x o sites, o <= d and o > d."""
    # each case in a process of its own, under a time limit of its own
    run = subprocess.run([sys.executable, str(SHIM / "run_on_cpu.py"), str(shim_lib), case],
                         capture_output=True, text=True, timeout=CASE_SECONDS)
    assert run.returncode == 0, run.stdout + run.stderr
    line = next(ln[len(case) + 1:] for ln in run.stdout.splitlines() if ln.startswith(case + ":"))
    diffs = [float(v) for v in re.findall(r"=(\S+)", line)]
    assert len(diffs) == n_outputs(case), line
    assert all(v <= (TOL_O if ":o" in case else TOL) for v in diffs), line


# kernel 4's element form (wide_info.cuh) at o = d on the natural-gradient
# inversion's indefinite sites, float64, at sizes past a few warps' runs:
# with a warp's steps folded in order the log-likelihood left the plain
# version by 15x its one-ulp spread at d = 9, N = 200 and by 90x at d = 7,
# N = 300 (chip_smoke's bound is 10x)
NATGRAD_CASES = ["9:200:():natgrad", "7:300:():natgrad", "12:200:():natgrad"]


@pytest.mark.parametrize("case", NATGRAD_CASES)
def test_element_form_on_natgrad_sites_under_the_shim(shim_lib, case):
    """m_f, P_f and the log-likelihood within chip_smoke.natgrad_filter_case's
    bounds (each printed as its difference over its bound)."""
    run = subprocess.run([sys.executable, str(SHIM / "run_on_cpu.py"), str(shim_lib), case],
                         capture_output=True, text=True, timeout=CASE_SECONDS)
    assert run.returncode == 0, run.stdout + run.stderr
    line = next(ln[len(case) + 1:] for ln in run.stdout.splitlines() if ln.startswith(case + ":"))
    ratios = [float(v) for v in re.findall(r"=(\S+)", line)]
    assert len(ratios) == 3 and all(v <= 1.0 for v in ratios), line


@pytest.mark.parametrize("sfx", ["f32", "f64"])
@pytest.mark.parametrize("d", [7, 9, 12])
def test_uniform_smoother_keeps_only_the_e_legs(shim_lib, sfx, d):
    """At d = 7..12 the uniform smoother keeps each step's element for pass
    3: E in the scratch (d^2 values a step), g and L in the outputs.  Its
    scratch exceeds the smoother scan's by exactly that, fewer values than
    the moments the call returns."""
    lib = ctypes.CDLL(str(shim_lib / "libmarkovflow_scans.so"))
    for fn in (lib[f"mf_uniform_smoother_scratch_{sfx}"], lib[f"mf_smoother_scratch_{sfx}"]):
        fn.argtypes, fn.restype = [ctypes.c_int64] * 3, ctypes.c_int64
    batch, n = 3, 100_003
    extra = (lib[f"mf_uniform_smoother_scratch_{sfx}"](d, batch, n)
             - lib[f"mf_smoother_scratch_{sfx}"](d, batch, n))
    assert extra == batch * n * d * d < batch * n * (d * d + d)
