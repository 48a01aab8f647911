"""Uniform-grid Kalman filter and smoother: CUDA kernels and their plain
versions.

Two kernels written by hand for Hopper (``sm_90a``), in
``ops/csrc/uniform_scan.cuh``:

* :func:`filter_pipeline_uniform` replaces the TPU kernel
  ``markovflow_tpu/ops/pallas_scan.py::pallas_filter_pipeline_uniform``;
* :func:`smoother_pipeline_uniform` replaces
  ``markovflow_tpu/ops/pallas_scan.py::pallas_smoother_pipeline_uniform``.

Each wrapper takes its plain PyTorch version (:func:`filter_pipeline_uniform_plain`,
:func:`smoother_pipeline_uniform_plain`) only when the tensors lie on the CPU.
For CUDA tensors it launches the kernel, or raises on a device, dtype, state
or output dimension it does not take; it never falls back.  Each wrapper
counts its launches in a plain integer attribute ``launches``.

The kernels are built at first use with ``nvcc`` from the sources in
``csrc/`` into ``_build/torch_kernels/<hash of the sources>/`` at the root
of the checkout, and loaded with ``ctypes`` through a plain C interface.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from .kalman import _materialize_uniform, filter_pipeline_tl, smoother_pipeline_tl

__all__ = ["filter_pipeline_uniform", "smoother_pipeline_uniform",
           "filter_pipeline_uniform_plain", "smoother_pipeline_uniform_plain",
           "build_kernels", "MAX_STATE_DIM"]

#: the kernels are instantiated for state dims 1..6 and output dim 1
MAX_STATE_DIM = 6

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC"]
_LIB_NAME = "libmarkovflow_uniform_scan.so"
_LIB: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def filter_pipeline_uniform_plain(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf=None):
    """Plain PyTorch version of :func:`filter_pipeline_uniform`: the
    materialised prior steps through :func:`ops.kalman.filter_pipeline_tl`."""
    F, c, Q, H = _materialize_uniform(Fc, cc, Qc, mu0, P0, Hc, nu.shape[-1])
    mask = None if maskf is None else maskf[..., 0, 0, :] > 0.5
    return filter_pipeline_tl(F, c, Q, H, nu, lam, mask)


def smoother_pipeline_uniform_plain(Fc, cc, Qc, m_f, p_f):
    """Plain PyTorch version of :func:`smoother_pipeline_uniform`: the
    expanded prior steps through :func:`ops.kalman.smoother_pipeline_tl`
    (which never reads element 0, the prior)."""
    n = m_f.shape[-1]
    F, c, Q = (x.expand(x.shape[:-1] + (n,)) for x in (Fc, cc, Qc))
    m_s, p_s, _ = smoother_pipeline_tl(F, c, Q, m_f, p_f)
    return m_s, p_s


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
def _find_nvcc() -> str:
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


#: compilation units: the C entry points, then one unit per (dtype, state
#: dim) instantiation of the kernels, so that nvcc runs them in parallel
_UNITS = [("uniform_scan.cu", [])] + [
    ("uniform_scan_inst.cu", [f"-DMF_T={t}", f"-DMF_D={d}"])
    for t in ("float", "double") for d in range(1, MAX_STATE_DIM + 1)]


def _source_hash() -> str:
    h = hashlib.sha256(repr((_NVCC_FLAGS, _UNITS)).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    """Compile the units in parallel, then link one shared library with a
    plain C interface."""
    def obj(i: int) -> str:
        src, defines = _UNITS[i]
        o = str(out_dir / f"unit{i}.o")
        subprocess.run([nvcc, *_NVCC_FLAGS, *defines, "-c", str(_CSRC / src),
                        "-o", o], check=True, capture_output=True, text=True)
        return o

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        objs = list(pool.map(obj, range(len(_UNITS))))
    lib = out_dir / _LIB_NAME
    subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", str(lib), *objs],
                   check=True, capture_output=True, text=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in ("f32", "f64"):
        for kind in ("filter", "smoother"):
            fn = getattr(lib, f"mf_uniform_{kind}_scratch_{sfx}")
            fn.argtypes = [i64, i64, i64]
            fn.restype = i64
        fn = getattr(lib, f"mf_uniform_filter_{sfx}")
        fn.argtypes = ([p] * 7 + [i64] * 3 + [p] + [i64] * 4 + [p] + [i64] * 2
                       + [p] * 4 + [i64] * 3 + [p])
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_uniform_smoother_{sfx}")
        fn.argtypes = [p] * 8 + [i64] * 3 + [p]
        fn.restype = ctypes.c_int


def build_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_dir = _BUILD_ROOT / _source_hash()
    lib_path = lib_dir / _LIB_NAME
    if not lib_path.is_file():
        _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        nvcc = _find_nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD_ROOT) as tmp:
            try:
                built = _compile(nvcc, Path(tmp))
            except subprocess.CalledProcessError as err:
                raise RuntimeError(f"nvcc failed:\n{err.stderr}") from err
            lib_dir.mkdir(exist_ok=True)
            os.replace(built, lib_path)  # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda(tensors, d: int, o: int) -> str:
    """Raise unless every tensor is on one CUDA device with one supported
    dtype and the dims are instantiated; return the dtype suffix."""
    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"all inputs must be {dtype}, got {t.dtype}")
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")
    if not 1 <= d <= MAX_STATE_DIM:
        raise NotImplementedError(
            f"the CUDA kernels take state dims 1..{MAX_STATE_DIM}, got {d}")
    if o != 1:
        raise NotImplementedError(
            f"the CUDA kernels take output dim 1, got {o}")
    return _SUFFIX[dtype]


def _check_grid(B: int, n: int) -> None:
    """Steps run on the grid's x axis, the batch on its y axis."""
    if n < 1:
        raise ValueError("the CUDA kernels need at least one time step")
    if B > 65535:
        raise NotImplementedError(
            f"the CUDA kernels take at most 65535 series at once, got {B}")


def _flat_consts(lead, B, *pairs):
    """Broadcast constants [..., d1, d2, 1] to the batch, contiguous [B, ...]."""
    return [x.expand(lead + shape).reshape((B,) + shape).contiguous()
            for x, shape in pairs]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def filter_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf=None):
    """Kalman filter on a uniform grid with constant prior steps.

    Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1] for every step
    k >= 1; the prior mu0 [..., d, 1, 1], P0 [..., d, d, 1] at step 0;
    constant emission Hc [..., o, d, 1]; sites nu [..., o, 1, N],
    lam [..., o, o, N] and an optional mask maskf [..., 1, 1, N] (steps with
    maskf <= 0.5 add 0 to the likelihood).  Site inputs may be expanded
    views: the kernel reads them through their strides.

    Returns (m_f [..., d, 1, N], P_f [..., d, d, N], loglik [...]).
    """
    if nu.device.type == "cpu":
        return filter_pipeline_uniform_plain(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                             maskf)
    if nu.device.type != "cuda":
        raise ValueError(f"no kernel for device {nu.device}")
    d, o, n = Fc.shape[-3], lam.shape[-3], nu.shape[-1]
    inputs = [Fc, cc, Qc, mu0, P0, Hc, nu, lam]
    leads = [x.shape[:-3] for x in inputs]
    if maskf is not None:
        inputs.append(maskf)
        leads.append(maskf.shape[:-3])
    sfx = _check_cuda(inputs, d, o)
    lead = torch.broadcast_shapes(*leads)
    B = math.prod(lead)
    _check_grid(B, n)
    fc, ccf, qc, m0, p0, hc = _flat_consts(
        lead, B, (Fc, (d, d, 1)), (cc, (d, 1, 1)), (Qc, (d, d, 1)),
        (mu0, (d, 1, 1)), (P0, (d, d, 1)), (Hc, (o, d, 1)))
    nu_b = nu.expand(lead + (o, 1, n)).reshape(B, o, 1, n)
    lam_b = lam.expand(lead + (o, o, n)).reshape(B, o, o, n)
    if maskf is None:
        mask_ptr, mask_sb, mask_st = None, 0, 0
    else:
        mask_b = maskf.expand(lead + (1, 1, n)).reshape(B, 1, 1, n)
        mask_ptr, mask_sb, mask_st = (mask_b.data_ptr(), mask_b.stride(0),
                                      mask_b.stride(3))
    kw = dict(dtype=nu.dtype, device=nu.device)
    m_f = torch.empty((B, d, 1, n), **kw)
    p_f = torch.empty((B, d, d, n), **kw)
    loglik = torch.empty((B,), **kw)
    lib = build_kernels()
    scratch = torch.empty(
        (getattr(lib, f"mf_uniform_filter_scratch_{sfx}")(d, B, n),), **kw)
    sn, sl = nu_b.stride(), lam_b.stride()
    with torch.cuda.device(nu.device):
        err = getattr(lib, f"mf_uniform_filter_{sfx}")(
            fc.data_ptr(), ccf.data_ptr(), qc.data_ptr(), m0.data_ptr(),
            p0.data_ptr(), hc.data_ptr(),
            nu_b.data_ptr(), sn[0], sn[1], sn[3],
            lam_b.data_ptr(), sl[0], sl[1], sl[2], sl[3],
            mask_ptr, mask_sb, mask_st,
            m_f.data_ptr(), p_f.data_ptr(), loglik.data_ptr(),
            scratch.data_ptr(), B, n, d, _stream(nu.device))
    _raise_on(err, "filter_pipeline_uniform")
    filter_pipeline_uniform.launches += 1
    return (m_f.reshape(lead + (d, 1, n)), p_f.reshape(lead + (d, d, n)),
            loglik.reshape(lead))


filter_pipeline_uniform.launches = 0


def smoother_pipeline_uniform(Fc, cc, Qc, m_f, p_f):
    """RTS smoother on a uniform grid with constant prior steps
    (Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1]) from the
    filtered moments m_f [..., d, 1, N], P_f [..., d, d, N], which must be
    contiguous on CUDA.  Returns (m_s [..., d, 1, N], P_s [..., d, d, N])."""
    if m_f.device.type == "cpu":
        return smoother_pipeline_uniform_plain(Fc, cc, Qc, m_f, p_f)
    if m_f.device.type != "cuda":
        raise ValueError(f"no kernel for device {m_f.device}")
    d, n = Fc.shape[-3], m_f.shape[-1]
    sfx = _check_cuda([Fc, cc, Qc, m_f, p_f], d, 1)
    lead = m_f.shape[:-3]
    if p_f.shape != lead + (d, d, n) or m_f.shape != lead + (d, 1, n):
        raise ValueError(f"m_f {tuple(m_f.shape)} / P_f {tuple(p_f.shape)} "
                         f"do not match state dim {d}")
    if not (m_f.is_contiguous() and p_f.is_contiguous()):
        raise ValueError("the smoother kernel takes contiguous m_f and P_f")
    B = math.prod(lead)
    _check_grid(B, n)
    fc, ccf, qc = _flat_consts(lead, B, (Fc, (d, d, 1)), (cc, (d, 1, 1)),
                               (Qc, (d, d, 1)))
    m_s = torch.empty_like(m_f)
    p_s = torch.empty_like(p_f)
    lib = build_kernels()
    scratch = torch.empty(
        (getattr(lib, f"mf_uniform_smoother_scratch_{sfx}")(d, B, n),),
        dtype=m_f.dtype, device=m_f.device)
    with torch.cuda.device(m_f.device):
        err = getattr(lib, f"mf_uniform_smoother_{sfx}")(
            fc.data_ptr(), ccf.data_ptr(), qc.data_ptr(), m_f.data_ptr(),
            p_f.data_ptr(), m_s.data_ptr(), p_s.data_ptr(), scratch.data_ptr(),
            B, n, d, _stream(m_f.device))
    _raise_on(err, "smoother_pipeline_uniform")
    smoother_pipeline_uniform.launches += 1
    return m_s, p_s


smoother_pipeline_uniform.launches = 0
