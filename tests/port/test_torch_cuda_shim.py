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
# passes and the uniform smoother's across two or more blocks of steps, at
# d = 2 (R = 8) and d = 3 (R = 4; the filter scan's largest staged d),
# staged through shared memory and at d = 5 not (but the uniform kernels'),
# sparse sites, and d = 6 across three blocks of the uniform kernels'
# staged passes (four warps a block in float64)
CASES = ["7:97:(2,)", "9:300:()", "9:64:(2,):sparse", "12:50:(2,)",
         "2:2100:(2,)", "2:700:(2,):sparse", "5:600:()", "3:1100:(2,)", "6:1100:()"]
# the outputs of a case: the uniform filter (3) and smoother (2), the
# uniform Koopman backward (8, at d <= 6), the general filter (3), the
# smoother scan (2), the filter scan of the problem's elements and of random
# ones (2 + 2), the general Koopman backward (6)
N_OUTPUTS = {True: 28, False: 20}


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


@pytest.fixture(scope="module")
def shim_results(shim_lib):
    """Every case in one process (the package copy and the imports once):
    case -> its line of differences."""
    run = subprocess.run([sys.executable, str(SHIM / "run_on_cpu.py"), str(shim_lib), *CASES],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout + run.stderr
    return {case: ln[len(case) + 1:] for ln in run.stdout.splitlines()
            for case in CASES if ln.startswith(case + ":")}


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_versions_under_the_shim(shim_results, case):
    """d = 7, 9 and 12, N below and above a few warps' runs of steps; d = 2,
    3, 5 and 6 across a block's tile of steps; a batch, a mask, and sparse sites
    (lam = nu = 0 where masked): all seven kernels (the uniform Koopman
    backward at d <= 6, with the site gradients), and the filter scan also
    on random prebuilt elements."""
    line = shim_results[case]
    diffs = [float(v) for v in re.findall(r"=(\S+)", line)]
    assert len(diffs) == N_OUTPUTS[int(case.split(":")[0]) <= 6], line
    assert all(v <= TOL for v in diffs), line


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
