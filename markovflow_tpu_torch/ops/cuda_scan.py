"""Kalman filter and smoother scans: CUDA kernels and their plain versions.

Kernels written by hand for Hopper (``sm_90a``), in ``ops/csrc/``:

* :func:`filter_pipeline_uniform` replaces the TPU kernel
  ``markovflow_tpu/ops/pallas_scan.py::pallas_filter_pipeline_uniform``;
* :func:`smoother_pipeline_uniform` replaces
  ``markovflow_tpu/ops/pallas_scan.py::pallas_smoother_pipeline_uniform``
  (both in ``csrc/uniform_scan.cuh``);
* :func:`filter_pipeline` replaces ``pallas_filter_pipeline``,
  :func:`smoother_scan` replaces ``pallas_smoother_scan`` and
  :func:`filter_scan` replaces ``pallas_filter_scan`` (all three in
  ``csrc/general_scan.cuh``).

The Koopman backward kernels, the ports of ``pallas_adjoint_pipeline_uniform``
and ``pallas_adjoint_pipeline``, have their wrappers in
:mod:`markovflow_tpu_torch.ops.adjoint` beside their plain versions; they are
built into the same library.

Each wrapper takes its plain PyTorch version (``*_plain``) only when the
tensors lie on the CPU.  For CUDA tensors it launches the kernel, or raises
on a device, dtype, state or output dimension it does not take; it never
falls back.  Each wrapper counts its launches in a plain integer attribute
``launches``.

The kernels are built at first use with ``nvcc`` from the sources in
``csrc/`` into ``_build/torch_kernels/<hash of the sources>/`` at the root
of the checkout, and loaded with ``ctypes`` through a plain C interface.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from .kalman import (_materialize_uniform, filter_pipeline_tl, filter_scan_tl,
                     smoother_pipeline_tl, smoother_scan_tl)

__all__ = ["filter_pipeline_uniform", "smoother_pipeline_uniform",
           "filter_pipeline", "smoother_scan", "filter_scan",
           "filter_pipeline_uniform_plain", "smoother_pipeline_uniform_plain",
           "filter_pipeline_plain", "smoother_scan_plain", "filter_scan_plain",
           "build_kernels", "MAX_STATE_DIM"]

#: the filter and smoother kernels take state dims 1..12 and output dim 1:
#: d = 1..6 as unrolled instantiations with elements in registers, d = 7..12
#: through one runtime-d instantiation whose warps compose elements held in
#: shared memory (``csrc/wide_scan.cuh``)
MAX_STATE_DIM = 12
#: the two filters and the two Koopman backwards (:func:`filter_pipeline`,
#: :func:`filter_pipeline_uniform`, ``adjoint.adjoint_pipeline`` and
#: ``adjoint.adjoint_pipeline_uniform``) also take o x o sites at o = 2..d
#: for these state dims (``GeneralStepsO``, ``UniformStepsO``,
#: ``GeneralAdjStepsO``, ``UniformAdjStepsO`` in ``csrc/``; one unit per
#: (dtype, d, o) for the filters and one for the backwards).  The filters
#: take a rank-o route where lam's step stride is 0, as GPR's noise
#: precision is expanded (``GeneralStepsRankO``, ``UniformStepsRankO``: a
#: conditional Kalman step a step, no d x d inverse), and the element form
#: where lam changes with the step, as the natural-gradient inversion's
#: indefinite sites do (the covariance form loses their digits)
MULTI_OUTPUT_MAX_STATE_DIM = 6

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC"]
_LIB_NAME = "libmarkovflow_scans.so"
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


def filter_pipeline_plain(F, c, Q, H, nu, lam, maskf=None):
    """Plain PyTorch version of :func:`filter_pipeline`:
    :func:`ops.kalman.filter_pipeline_tl` with the float mask as booleans."""
    mask = None if maskf is None else maskf[..., 0, 0, :] > 0.5
    return filter_pipeline_tl(F, c, Q, H, nu, lam, mask)


def smoother_scan_plain(E, g, L):
    """Plain PyTorch version of :func:`smoother_scan`: the reverse
    :func:`ops.scans.scan_tl` over the smoothing composition."""
    return smoother_scan_tl(E, g, L)


def filter_scan_plain(A, b, C, J, eta):
    """Plain PyTorch version of :func:`filter_scan`:
    :func:`ops.scans.scan_tl` over the filtering composition."""
    return filter_scan_tl(A, b, C, J, eta)


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


#: compilation units: one per (family, dtype) of the runtime-d kernels for
#: d = 7..12, one per (kernel family, dtype, state dim) instantiation of the
#: unrolled kernels for d = 1..6, one per (dtype, d, o) of the filters and
#: one of the Koopman backwards at o x o sites, and the C entry points, so
#: that nvcc runs them in parallel; the runtime-d units start first, then
#: the o x o units, then the others from the largest state dim.
#: "gadjoint" is the general-grid Koopman backward.
_FAMILIES = ("uniform", "general", "adjoint", "gadjoint")
_O_PAIRS = [(d, o) for d in range(MULTI_OUTPUT_MAX_STATE_DIM, 1, -1)
            for o in range(d, 1, -1)]
_UNITS = [
    ("wide_inst.cu", [f"-DMF_T={t}", f"-DMF_{fam.upper()}"])
    for fam in ("general", "gadjoint", "uniform") for t in ("double", "float")] + [
    (f"{fam}o_inst.cu", [f"-DMF_T={t}", f"-DMF_D={d}", f"-DMF_O={o}"])
    for fam in ("adjoint", "general") for d, o in _O_PAIRS
    for t in ("double", "float")] + [
    (f"{fam}_inst.cu", [f"-DMF_T={t}", f"-DMF_D={d}"])
    for d in range(6, 0, -1) for fam in _FAMILIES
    for t in ("double", "float")] + [("entry_points.cu", [])]


def _source_hash() -> str:
    h = hashlib.sha256(repr((_NVCC_FLAGS, _UNITS)).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    """Compile the units in parallel, then link one shared library with a
    plain C interface.  Each unit's seconds go to ``unit_seconds.json``
    beside the library."""
    seconds = {}

    def obj(i: int) -> str:
        src, defines = _UNITS[i]
        o = str(out_dir / f"unit{i}.o")
        start = time.perf_counter()
        subprocess.run([nvcc, *_NVCC_FLAGS, *defines, "-c", str(_CSRC / src),
                        "-o", o], check=True, capture_output=True, text=True)
        seconds[" ".join([src, *defines])] = time.perf_counter() - start
        return o

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        objs = list(pool.map(obj, range(len(_UNITS))))
    (out_dir / "unit_seconds.json").write_text(json.dumps(seconds, indent=1))
    lib = out_dir / _LIB_NAME
    subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", str(lib), *objs],
                   check=True, capture_output=True, text=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in ("f32", "f64"):
        for kind in ("filter_scan", "smoother", "uniform_smoother"):
            fn = getattr(lib, f"mf_{kind}_scratch_{sfx}")
            fn.argtypes = [i64, i64, i64]
            fn.restype = i64
        # (d, o, batch, n); the Koopman backwards' (d, o, obs, batch, n)
        for kind, nargs in (("uniform_filter", 4), ("general_filter", 4), ("adjoint", 5),
                            ("general_adjoint", 5)):
            fn = getattr(lib, f"mf_{kind}_scratch_{sfx}")
            fn.argtypes = [i64] * nargs
            fn.restype = i64
        fn = getattr(lib, f"mf_uniform_filter_{sfx}")
        fn.argtypes = [p] * 10 + [p] * 4 + [i64] * 4 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_uniform_smoother_{sfx}")
        fn.argtypes = [p] * 8 + [i64] * 3 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_general_filter_{sfx}")
        fn.argtypes = [p] * 8 + [p] * 4 + [i64] * 4 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_smoother_scan_{sfx}")
        fn.argtypes = [p] * 6 + [i64] * 3 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_uniform_adjoint_{sfx}")
        fn.argtypes = [p] * 10 + [p] * 3 + [p] * 5 + [i64, p] + [i64] * 4 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_filter_scan_{sfx}")
        fn.argtypes = [p] * 5 + [p] * 3 + [i64] * 3 + [p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mf_general_adjoint_{sfx}")
        fn.argtypes = [p] * 8 + [p] * 3 + [p] * 7 + [i64] * 4 + [p]
        fn.restype = ctypes.c_int
        for kind in ("wide", "general"):
            fn = getattr(lib, f"mf_{kind}_occupancy_{sfx}")
            fn.argtypes = [i64, i64, p]
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
            os.replace(built.parent / "unit_seconds.json", lib_dir / "unit_seconds.json")
            os.replace(built, lib_path)  # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda(tensors, d: int, o: int, max_d: int = MAX_STATE_DIM) -> str:
    """Raise unless every tensor is on one CUDA device with one supported
    dtype and the dims are instantiated (state dims 1..``max_d``; output
    dim 1, or 1..d at d <= MULTI_OUTPUT_MAX_STATE_DIM: the smoothers and
    the filter scan, which have no output dim, pass 1); return the dtype
    suffix."""
    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"all inputs must be {dtype}, got {t.dtype}")
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")
    if not 1 <= d <= max_d:
        raise NotImplementedError(
            f"this CUDA kernel takes state dims 1..{max_d}, got {d}")
    if o != 1 and d > MULTI_OUTPUT_MAX_STATE_DIM:
        raise NotImplementedError(
            f"the CUDA kernels take output dims o > 1 only at state dims "
            f"1..{MULTI_OUTPUT_MAX_STATE_DIM}, got o = {o} at d = {d} (o > 1 "
            f"at d = 7..12 has no kernel)")
    if not 1 <= o <= d:
        raise NotImplementedError(
            f"the CUDA kernels take output dims 1..d, got o = {o} at d = {d} "
            f"(o > d has no kernel)")
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


def _flat_steps(lead, B, x, shape):
    """Broadcast per-step [..., d1, d2, N] to the batch as [B, d1, d2, N],
    a view where the strides allow (expanded axes keep stride 0)."""
    return x.expand(lead + shape).reshape((B,) + shape)


def _strides(*tensors_and_axes):
    """A C array of int64 strides: for each (tensor, axes), the strides of
    those axes of the [B, d1, d2, N] tensor (0 for an absent tensor)."""
    vals = []
    for t, axes in tensors_and_axes:
        vals += [0] * len(axes) if t is None else [t.stride(a) for a in axes]
    return (ctypes.c_int64 * len(vals))(*vals)


def _site_views(lead, B, o, n, nu, lam, maskf):
    """The site inputs as [B, ...] views, and their strides in the order the
    C entry points take them: nu (batch, row, step), lam (batch, row,
    column, step), mask (batch, step)."""
    nu_b = _flat_steps(lead, B, nu, (o, 1, n))
    lam_b = _flat_steps(lead, B, lam, (o, o, n))
    mask_b = None if maskf is None else _flat_steps(lead, B, maskf, (1, 1, n))
    strides = [(nu_b, (0, 1, 3)), (lam_b, (0, 1, 2, 3)), (mask_b, (0, 3))]
    ptrs = (nu_b.data_ptr(), lam_b.data_ptr(),
            None if mask_b is None else mask_b.data_ptr())
    return ptrs, strides


def _general_views(lead, B, F, c, Q, H, nu, lam, maskf):
    """The per-step prior and emission and the sites as [B, ...] views:
    their pointers (F, c, Q, H, nu, lam, mask) and the C array of strides in
    the order the general entry points take them: F (batch, row, column,
    step), c (batch, row, step), Q and H as F, then the sites."""
    d, o, n = F.shape[-3], lam.shape[-3], F.shape[-1]
    prior = [_flat_steps(lead, B, x, shape) for x, shape in
             ((F, (d, d, n)), (c, (d, 1, n)), (Q, (d, d, n)), (H, (o, d, n)))]
    sites, site_strides = _site_views(lead, B, o, n, nu, lam, maskf)
    strides = _strides((prior[0], (0, 1, 2, 3)), (prior[1], (0, 1, 3)),
                       (prior[2], (0, 1, 2, 3)), (prior[3], (0, 1, 2, 3)),
                       *site_strides)
    return [x.data_ptr() for x in prior] + list(sites), strides


def _scratch(kind: str, sfx: str, dims, B: int, n: int, like):
    """The kernel's scratch; ``dims``: (d,), (d, o) for the filters, or
    (d, o, obs) for the Koopman backwards (obs: whether the call writes an
    observation term)."""
    lib = build_kernels()
    size = getattr(lib, f"mf_{kind}_scratch_{sfx}")(*dims, B, n)
    return torch.empty((size,), dtype=like.dtype, device=like.device)


def filter_pipeline_uniform(Fc, cc, Qc, mu0, P0, Hc, nu, lam, maskf=None):
    """Kalman filter on a uniform grid with constant prior steps.

    Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1] for every step
    k >= 1; the prior mu0 [..., d, 1, 1], P0 [..., d, d, 1] at step 0;
    constant emission Hc [..., o, d, 1]; sites nu [..., o, 1, N],
    lam [..., o, o, N] and an optional mask maskf [..., 1, 1, N] (steps with
    maskf <= 0.5 add 0 to the likelihood).  Site inputs may be expanded
    views: the kernel reads them through their strides.  o = 1 at
    d = 1..12, o = 2..d at d = 1..6.

    Returns (m_f [..., d, 1, N], P_f [..., d, d, N], loglik [...]).
    """
    if nu.device.type == "cpu":
        return filter_pipeline_uniform_plain(Fc, cc, Qc, mu0, P0, Hc, nu, lam,
                                             maskf)
    if nu.device.type != "cuda":
        raise ValueError(f"no kernel for device {nu.device}")
    d, o, n = Fc.shape[-3], lam.shape[-3], nu.shape[-1]
    inputs = [Fc, cc, Qc, mu0, P0, Hc, nu, lam]
    if maskf is not None:
        inputs.append(maskf)
    sfx = _check_cuda(inputs, d, o)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in inputs))
    B = math.prod(lead)
    _check_grid(B, n)
    consts = _flat_consts(
        lead, B, (Fc, (d, d, 1)), (cc, (d, 1, 1)), (Qc, (d, d, 1)),
        (mu0, (d, 1, 1)), (P0, (d, d, 1)), (Hc, (o, d, 1)))
    sites, site_strides = _site_views(lead, B, o, n, nu, lam, maskf)
    kw = dict(dtype=nu.dtype, device=nu.device)
    m_f = torch.empty((B, d, 1, n), **kw)
    p_f = torch.empty((B, d, d, n), **kw)
    loglik = torch.empty((B,), **kw)
    scratch = _scratch("uniform_filter", sfx, (d, o), B, n, nu)
    with torch.cuda.device(nu.device):
        err = getattr(build_kernels(), f"mf_uniform_filter_{sfx}")(
            *(x.data_ptr() for x in consts), *sites, _strides(*site_strides),
            m_f.data_ptr(), p_f.data_ptr(), loglik.data_ptr(),
            scratch.data_ptr(), B, n, d, o, _stream(nu.device))
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
    _check_moments(m_f, p_f, lead, d, n)
    B = math.prod(lead)
    _check_grid(B, n)
    fc, ccf, qc = _flat_consts(lead, B, (Fc, (d, d, 1)), (cc, (d, 1, 1)),
                               (Qc, (d, d, 1)))
    m_s = torch.empty_like(m_f)
    p_s = torch.empty_like(p_f)
    scratch = _scratch("uniform_smoother", sfx, (d,), B, n, m_f)
    with torch.cuda.device(m_f.device):
        err = getattr(build_kernels(), f"mf_uniform_smoother_{sfx}")(
            fc.data_ptr(), ccf.data_ptr(), qc.data_ptr(), m_f.data_ptr(),
            p_f.data_ptr(), m_s.data_ptr(), p_s.data_ptr(), scratch.data_ptr(),
            B, n, d, _stream(m_f.device))
    _raise_on(err, "smoother_pipeline_uniform")
    smoother_pipeline_uniform.launches += 1
    return m_s, p_s


smoother_pipeline_uniform.launches = 0


def _check_moments(m, p, lead, d, n):
    """(m [..., d, 1, N], P [..., d, d, N]) pairs the kernels read as
    contiguous arrays."""
    if p.shape != lead + (d, d, n) or m.shape != lead + (d, 1, n):
        raise ValueError(f"{tuple(m.shape)} / {tuple(p.shape)} do not match "
                         f"state dim {d} and {n} steps")
    if not (m.is_contiguous() and p.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous moments")


def filter_pipeline(F, c, Q, H, nu, lam, maskf=None):
    """Kalman filter with per-step prior steps and emission, for any grid.

    F [..., d, d, N], c [..., d, 1, N], Q [..., d, d, N] (step 0 is the
    prior: F_0 = 0, c_0 = mu0, Q_0 = P0); H [..., o, d, N]; sites
    nu [..., o, 1, N], lam [..., o, o, N] and an optional mask
    maskf [..., 1, 1, N] (steps with maskf <= 0.5 add 0 to the likelihood).
    Every input may be an expanded view: the kernel reads all of them
    through their strides.  o = 1 at d = 1..12, o = 2..d at d = 1..6; lam
    may be indefinite (the posterior must be proper) where it changes with
    the step; a lam of step stride 0 takes the rank-o route.

    Returns (m_f [..., d, 1, N], P_f [..., d, d, N], loglik [...]).
    """
    if F.device.type == "cpu":
        return filter_pipeline_plain(F, c, Q, H, nu, lam, maskf)
    if F.device.type != "cuda":
        raise ValueError(f"no kernel for device {F.device}")
    d, o, n = F.shape[-3], lam.shape[-3], F.shape[-1]
    inputs = [F, c, Q, H, nu, lam]
    if maskf is not None:
        inputs.append(maskf)
    sfx = _check_cuda(inputs, d, o)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in inputs))
    B = math.prod(lead)
    _check_grid(B, n)
    ptrs, strides = _general_views(lead, B, F, c, Q, H, nu, lam, maskf)
    kw = dict(dtype=F.dtype, device=F.device)
    m_f = torch.empty((B, d, 1, n), **kw)
    p_f = torch.empty((B, d, d, n), **kw)
    loglik = torch.empty((B,), **kw)
    scratch = _scratch("general_filter", sfx, (d, o), B, n, F)
    with torch.cuda.device(F.device):
        err = getattr(build_kernels(), f"mf_general_filter_{sfx}")(
            *ptrs, strides, m_f.data_ptr(), p_f.data_ptr(), loglik.data_ptr(),
            scratch.data_ptr(), B, n, d, o, _stream(F.device))
    _raise_on(err, "filter_pipeline")
    filter_pipeline.launches += 1
    return (m_f.reshape(lead + (d, 1, n)), p_f.reshape(lead + (d, d, n)),
            loglik.reshape(lead))


filter_pipeline.launches = 0


def smoother_scan(E, g, L):
    """Reverse (suffix) scan of prebuilt smoothing elements E [..., d, d, N],
    g [..., d, 1, N], L [..., d, d, N] (leading shapes broadcast).
    Returns the g and L legs of every suffix, (m_s [..., d, 1, N],
    P_s [..., d, d, N]) for RTS elements."""
    if E.device.type == "cpu":
        return smoother_scan_plain(E, g, L)
    if E.device.type != "cuda":
        raise ValueError(f"no kernel for device {E.device}")
    d, n = E.shape[-3], E.shape[-1]
    sfx = _check_cuda([E, g, L], d, 1)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in (E, g, L)))
    B = math.prod(lead)
    _check_grid(B, n)
    e_b, g_b, l_b = (x.expand(lead + shape).reshape((B,) + shape).contiguous()
                     for x, shape in ((E, (d, d, n)), (g, (d, 1, n)),
                                      (L, (d, d, n))))
    m_s = torch.empty_like(g_b)
    p_s = torch.empty_like(l_b)
    scratch = _scratch("smoother", sfx, (d,), B, n, E)
    with torch.cuda.device(E.device):
        err = getattr(build_kernels(), f"mf_smoother_scan_{sfx}")(
            e_b.data_ptr(), g_b.data_ptr(), l_b.data_ptr(), m_s.data_ptr(),
            p_s.data_ptr(), scratch.data_ptr(), B, n, d, _stream(E.device))
    _raise_on(err, "smoother_scan")
    smoother_scan.launches += 1
    return m_s.reshape(lead + (d, 1, n)), p_s.reshape(lead + (d, d, n))


smoother_scan.launches = 0


def filter_scan(A, b, C, J, eta):
    """Prefix scan of prebuilt filtering elements A [..., d, d, N],
    b [..., d, 1, N], C [..., d, d, N], J [..., d, d, N], eta [..., d, 1, N]
    (leading shapes broadcast) with the filtering composition.  Returns the
    b and C legs of every prefix: (m_f [..., d, 1, N], P_f [..., d, d, N])
    for the elements of :func:`ops.kalman.make_filter_elements_tl`.  The
    kernel takes one column in b and eta."""
    if A.device.type == "cpu":
        return filter_scan_plain(A, b, C, J, eta)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    d, n = A.shape[-3], A.shape[-1]
    if b.shape[-2] != 1 or eta.shape[-2] != 1:
        raise NotImplementedError(
            f"the CUDA filter scan takes one column in b and eta, got "
            f"{b.shape[-2]} and {eta.shape[-2]}")
    sfx = _check_cuda([A, b, C, J, eta], d, 1)
    lead = torch.broadcast_shapes(*(x.shape[:-3] for x in (A, b, C, J, eta)))
    B = math.prod(lead)
    _check_grid(B, n)
    elems = [x.expand(lead + shape).reshape((B,) + shape).contiguous()
             for x, shape in ((A, (d, d, n)), (b, (d, 1, n)), (C, (d, d, n)),
                              (J, (d, d, n)), (eta, (d, 1, n)))]
    kw = dict(dtype=A.dtype, device=A.device)
    m_f = torch.empty((B, d, 1, n), **kw)
    p_f = torch.empty((B, d, d, n), **kw)
    scratch = _scratch("filter_scan", sfx, (d,), B, n, A)
    with torch.cuda.device(A.device):
        err = getattr(build_kernels(), f"mf_filter_scan_{sfx}")(
            *(x.data_ptr() for x in elems), m_f.data_ptr(), p_f.data_ptr(),
            scratch.data_ptr(), B, n, d, _stream(A.device))
    _raise_on(err, "filter_scan")
    filter_scan.launches += 1
    return m_f.reshape(lead + (d, 1, n)), p_f.reshape(lead + (d, d, n))


filter_scan.launches = 0
