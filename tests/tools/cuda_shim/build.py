"""Build the CUDA kernels of markovflow_tpu_torch/ops/csrc/ with g++ against
the stand-in cuda_runtime.h beside this file, into a shared library with the
same C interface as the nvcc build:

    python tests/tools/cuda_shim/build.py OUT_DIR

The sources are copied into OUT_DIR with every ``k<<<grid, block, smem,
stream>>>(args);`` rewritten to a call of the stand-in launcher and the
kernels' ``extern __shared__`` buffer mapped to the launch's buffer; the
units are those of ops/cuda_scan.py (_UNITS), compiled in parallel.  Then
run the wrappers' CUDA branch on CPU tensors with run_on_cpu.py.
"""
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
CSRC = ROOT / "markovflow_tpu_torch" / "ops" / "csrc"
LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^;{}]*?>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def split_top(cfg: str):
    """The launch configuration's arguments, split at top-level commas."""
    parts, depth, cur = [], 0, ""
    for ch in cfg:
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        depth += ch in "(<"
        depth -= ch in ")>"
        cur += ch
    return parts + [cur.strip()]


def rewrite(m) -> str:
    name, cfg, args = m.groups()
    g, b, smem, stream = (split_top(cfg) + ["0", "nullptr"])[:4]
    return (f"mf_shim::launch(dim3({g}), dim3({b}), size_t({smem}), {stream}, "
            f"[&]() {{ {name}({args}); }});")


def main(out: Path) -> Path:
    sys.path.insert(0, str(ROOT))
    from markovflow_tpu_torch.ops.cuda_scan import _UNITS

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in CSRC.glob("*.cu*"):
        text = f.read_text().replace(
            "extern __shared__ __align__(16) unsigned char mf_wide_smem[];",
            "#define mf_wide_smem (mf_shim::dyn_smem)")
        (out / f.name).write_text(LAUNCH.sub(rewrite, text))

    def obj(i: int) -> str:
        src, defines = _UNITS[i]
        o = out / f"unit{i}.o"
        subprocess.run(["g++", "-std=c++20", "-x", "c++", "-O1", "-fPIC", "-pthread",
                        f"-I{HERE}", f"-I{out}", *defines, "-c", str(out / src),
                        "-o", str(o)], check=True)
        return str(o)

    with ThreadPoolExecutor() as pool:
        objs = list(pool.map(obj, range(len(_UNITS))))
    lib = out / "libmarkovflow_scans.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(lib), *objs], check=True)
    return lib


if __name__ == "__main__":
    print(main(Path(sys.argv[1]).resolve()))
