"""Report on one CUDA card what chip_smoke.py does not measure for the
d = 7..12 kernels (markovflow_tpu_torch/ops/csrc/wide_scan.cuh) and for the
d <= 6 register passes of the filters, the smoothers and the Koopman
backwards (kernels 1 to 7):

    python3 chip_wide_report.py

1. ptxas's registers, stack and spills of every kernel of the runtime-d
   units (nvcc -Xptxas -v on csrc/wide_inst.cu, one unit per family and
   dtype, and csrc/wide_info_inst.cu: kernels 4 and 7 at o = 2..12, one
   unit per kernel and dtype) and of the uniform, general, adjoint and gadjoint units at d = 2,
   3 and 6 in float32, and of the uniform and adjoint units in float64
   (uniform_inst.cu, general_inst.cu, adjoint_inst.cu, gadjoint_inst.cu;
   kernels 1 and 2, 4, 5 and 6, 3, and 7), and of the o x o units of mo3's
   filters, (d, o) = (6, 3) in float32 (generalo_inst.cu: kernels 4 and 1),
   of the natural-gradient inversion's, (2, 2) in float64, and of mo3's
   Koopman backwards, (6, 3) in float32 and float64 (adjointo_inst.cu:
   kernels 7 and 3),
   compiled in parallel, and the static count of each kernel's SASS
   instructions by kind (cuobjdump -sass): shared-memory loads and stores
   (LDS, STS), generic loads and stores (LD, ST), global loads and stores
   (LDG, STG), local-memory loads and stores (LDL, STL), FMAs, shuffles,
   all;
2. the shared memory a warp of passes 1, 3 and 2 of kernels 2, 5 and 6
   (the staged passes), and the warps an SM keeps resident, as the library
   configures the launches and the occupancy calculator counts them
   (mf_wide_occupancy_*), at d = 9 in float32 and d = 12 in float64;
3. the registers, local memory and shared memory of passes 1, 3 and 2 of
   kernels 1 to 7 at d = 1..6 and the warps an SM keeps resident, as the
   library's runtime reports them (mf_general_occupancy_*; a library
   without that entry reports none, one that does not answer for kernel 1,
   2, 3, 5 or 6 none of it), float32 and float64.

The last line is one JSON object of all of it.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

CASES = ((9, torch.float32), (12, torch.float64))
KERNELS = {2: "uniform RTS smoother", 5: "smoother scan", 6: "filter scan"}


#: SASS opcodes counted, by kind
SASS_KINDS = {"LDS": ("LDS",), "STS": ("STS",), "LD": ("LD",), "ST": ("ST",),
              "LDG": ("LDG",), "STG": ("STG",), "LDL/STL": ("LDL", "STL"),
              "FMA": ("FFMA", "DFMA"), "SHFL": ("SHFL",)}
#: the d <= 6 units reported beside the wide ones: (source, defines)
NARROW_UNITS = [(f"{fam}_inst.cu", [f"-DMF_T={t}", f"-DMF_D={d}"])
                for fam, dtypes in (("uniform", ("float", "double")), ("general", ("float",)),
                                    ("adjoint", ("float", "double")), ("gadjoint", ("float",)))
                for t in dtypes for d in (2, 3, 6)] + [
    (f"{fam}o_inst.cu", [f"-DMF_T={t}", f"-DMF_D={d}", f"-DMF_O={o}"])
    for fam, t, d, o in (("general", "float", 6, 3), ("general", "double", 2, 2),
                         ("adjoint", "float", 6, 3), ("adjoint", "double", 6, 3))]


def sass_counts(sass: str, demangle) -> dict:
    """label -> {kind: static count, "all": every instruction} per function
    of a cuobjdump -sass listing."""
    out, counts = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            counts = out.setdefault(demangle(m.group(1)), dict.fromkeys([*SASS_KINDS, "all"], 0))
        elif counts is not None and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)):
            counts["all"] += 1
            for kind, ops in SASS_KINDS.items():
                counts[kind] += m.group(1) in ops
    return out


def ptxas(cs) -> tuple:
    """label -> (registers, stack bytes, spill store bytes, spill load
    bytes) of every kernel of the wide units and of NARROW_UNITS, and label
    -> SASS counts."""
    nvcc = cs._find_nvcc()
    bindir = str(Path(nvcc).parent)
    filt = shutil.which("cu++filt", path=bindir) or shutil.which("c++filt")
    dump = shutil.which("cuobjdump", path=bindir)
    units = [(src, defines) for src, defines in cs._UNITS
             if src in ("wide_inst.cu", "wide_info_inst.cu")] + NARROW_UNITS

    def demangle(name):
        if filt is None:
            return name
        return chip_smoke.pass_label(subprocess.run([filt, name], capture_output=True,
                                                    text=True).stdout.strip())

    def one(unit):
        src, defines = unit
        with tempfile.TemporaryDirectory() as tmp:
            run = subprocess.run([nvcc, *cs._NVCC_FLAGS, "-Xptxas", "-v", *defines, "-c",
                                  str(cs._CSRC / src), "-o", f"{tmp}/u.o"],
                                 check=True, capture_output=True, text=True)
            sass = "" if dump is None else subprocess.run(
                [dump, "-sass", f"{tmp}/u.o"], capture_output=True, text=True).stdout
        return run.stderr, sass

    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        results = list(pool.map(one, units))
    sass = {}
    for _, listing in results:
        sass.update(sass_counts(listing, demangle))
    out, name, frame = {}, None, None
    for line in "\n".join(log for log, _ in results).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            out[demangle(name)] = (int(m.group(1)), *(frame or (0, 0, 0)))
            name = frame = None
    return out, sass


def occupancy(cs) -> list:
    """Per kernel, case and pass: shared memory a warp and the warps an SM
    keeps resident, from the library."""
    lib, rows = cs.build_kernels(), []
    for d, dtype in CASES:
        sfx = "f32" if dtype == torch.float32 else "f64"
        for kernel, name in KERNELS.items():
            out = (ctypes.c_int64 * 6)()
            err = getattr(lib, f"mf_wide_occupancy_{sfx}")(kernel, d, out)
            if err != 0:
                raise RuntimeError(f"mf_wide_occupancy_{sfx}({kernel}, {d}): CUDA error {err}")
            for i, label in enumerate(("pass 1", "pass 3", "pass 2")):
                row = {"kernel": kernel, "pass": label, "d": d, "dtype": sfx,
                       "smem_bytes_a_warp": out[2 * i], "resident_warps": out[2 * i + 1]}
                rows.append(row)
                print(f"  kernel {kernel} ({name}) d={d} {sfx} {label}: {row['smem_bytes_a_warp']} "
                      f"B a warp; {row['resident_warps']} warps an SM resident", flush=True)
    return rows


def general_occupancy(cs) -> list:
    """Per kernel (1 to 7), state dim 1..6, dtype and pass: registers,
    local and shared memory and resident warps, from the library; empty
    when the library has no mf_general_occupancy_* entry, and no rows of a
    kernel it does not answer for."""
    lib, rows = cs.build_kernels(), []
    if not hasattr(lib, "mf_general_occupancy_f32"):
        print("  the library has no mf_general_occupancy_* entry", flush=True)
        return rows
    for sfx in ("f32", "f64"):
        for kernel in range(1, 8):
            for d in range(1, 7):
                out = (ctypes.c_int64 * 12)()
                err = getattr(lib, f"mf_general_occupancy_{sfx}")(kernel, d, out)
                if err != 0 and kernel in (1, 2, 3, 5, 6):  # an older library's
                    break
                if err != 0:
                    raise RuntimeError(f"mf_general_occupancy_{sfx}({kernel}, {d}): CUDA error {err}")
                for i, label in enumerate(("pass 1", "pass 3", "pass 2")):
                    row = {"kernel": kernel, "pass": label, "d": d, "dtype": sfx,
                           "registers": out[4 * i], "local_bytes": out[4 * i + 1],
                           "smem_bytes": out[4 * i + 2],
                           "resident_warps": out[4 * i + 3]}
                    rows.append(row)
                    print(f"  kernel {kernel} d={d} {sfx} {label}: {row['registers']} registers, "
                          f"{row['local_bytes']} B local, {row['smem_bytes']} B shared a "
                          f"block; {row['resident_warps']} warps an SM resident", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_wide_report: no CUDA device", file=sys.stderr)
        return 1
    from markovflow_tpu_torch.ops import cuda_scan as cs

    card = chip_smoke.card_line()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    print("1. ptxas (registers, stack, spill stores, spill loads):", flush=True)
    regs, sass = ptxas(cs)
    for label, vals in sorted(regs.items()):
        print(f"  {label}: {vals[0]} registers, {vals[1]} B stack, {vals[2]} B spill stores, "
              f"{vals[3]} B spill loads; SASS "
              + " ".join(f"{k} {v}" for k, v in sass.get(label, {}).items()), flush=True)
    print("2. shared memory and resident warps:", flush=True)
    occ = occupancy(cs)
    print("3. kernels 1 to 7 at d <= 6, from the library:", flush=True)
    gocc = general_occupancy(cs)
    print(json.dumps({"card": card, "ptxas": regs, "sass": sass, "occupancy": occ,
                      "general_occupancy": gocc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
