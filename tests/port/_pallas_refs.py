"""Reference outputs of the JAX package's Pallas kernels, in interpret mode.

``python tests/port/_pallas_refs.py OUT.npz CASE...`` runs the kernels of
each named case in interpret mode (chunk=16, r_blk=4, as
tests/unit/test_uniform_path.py runs them; chunk=1, r_blk=1 for state dims
7..12, see :func:`interpret_kw`) and saves their outputs:

* a case of :data:`CASES` or :data:`WIDE_CASES` (uniform grid) runs
  ``pallas_filter_pipeline_uniform`` and ``pallas_smoother_pipeline_uniform``;
* ``adjoint:CASE`` runs ``pallas_filter_pipeline_uniform`` and, on its
  output, ``pallas_adjoint_pipeline_uniform`` with the per-row cotangent
  :func:`case_gscale`;
* a case of :data:`GENERAL_CASES` or :data:`WIDE_GENERAL_CASES` runs
  ``pallas_filter_pipeline`` on per-step prior steps and
  ``pallas_smoother_scan`` on prebuilt elements;
* ``fscan:CASE`` (a general case) builds the filtering elements of the
  case's inputs with the JAX package's ``make_filter_elements_tl`` and runs
  ``pallas_filter_scan`` on them, saving the elements too;
* ``gadjoint:CASE`` (a general case) runs ``pallas_filter_pipeline`` and,
  on its output, ``pallas_adjoint_pipeline`` (the fused general-grid
  Koopman backward) with the per-row cotangent :func:`general_gscale`.

The port's tests run it in fresh processes (:func:`run_refs`):
interpret-mode Pallas programs can crash XLA:CPU in a process that has
already compiled many programs (the reason for ``tests.tools.isolated``).
Tracing, lowering and compiling one case takes seconds (about 16 s for the
filter and smoother at d = 3) to minutes (d = 9, 12: the kernels unroll
their d x d products), so the tests split the cases over a few concurrent
processes.

The inputs are made here from numpy seeds, so the port's tests rebuild the
very same arrays with :func:`case_inputs`, :func:`general_inputs` and
:func:`scan_inputs`.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

#: name -> (state dim, number of steps, batch shape, masked)
CASES = {
    "d1_n64": (1, 64, (), False),
    "d1_n73": (1, 73, (), False),
    "d2_n64": (2, 64, (), False),
    "d2_n73": (2, 73, (), False),
    "d3_n64": (3, 64, (), False),
    "d3_n73": (3, 73, (), False),
    "d2_n73_masked": (2, 73, (), True),
    "d2_n64_batch3": (2, 64, (3,), False),
}
#: general-grid cases: aligned (64 = 4 chunks), padded (73) and masked
GENERAL_CASES = {
    "g_d2_n64": (2, 64, (), False),
    "g_d3_n73": (3, 73, (), False),
    "g_d2_n73_masked": (2, 73, (2,), True),
}
#: the same for state dims 7..12 (the d = 7..12 kernels of the port)
WIDE_CASES = {
    "d7_n37": (7, 37, (), False),
    "d9_n37_masked": (9, 37, (), True),
    "d12_n37": (12, 37, (), False),
}
WIDE_GENERAL_CASES = {
    "g_d7_n37": (7, 37, (), False),
    "g_d9_n37_masked": (9, 37, (2,), True),
    "g_d12_n37": (12, 37, (), False),
}
_UNIFORM = {**CASES, **WIDE_CASES}
_GENERAL = {**GENERAL_CASES, **WIDE_GENERAL_CASES}
INPUT_NAMES = ("fc", "cc", "qc", "mu0", "p0", "hc", "nu", "lam", "maskf")
OUTPUT_NAMES = ("m_f", "p_f", "loglik", "m_s", "p_s")
ADJOINT_NAMES = ("gFc", "gcc", "gQc", "gmu0", "gP0", "gHc", "gnu", "glam")
GENERAL_INPUT_NAMES = ("F", "c", "Q", "H", "nu", "lam", "maskf")
GENERAL_OUTPUT_NAMES = ("m_f", "p_f", "loglik", "m_s", "p_s")
ELEMENT_NAMES = ("A", "b", "C", "J", "eta")
GADJOINT_NAMES = ("gF", "gc", "gQ", "gH", "gnu", "glam")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def interpret_kw(d: int) -> dict:
    """The Pallas kernels' interpret-mode arguments at state dim d.  For
    d >= 7 one step per grid step (chunk=1, r_blk=1): the kernel body then
    traces the fewest copies of the d x d composition (its unrolled
    products grow as d^3), which roughly halves the compile time of the
    chunk=16 body at d = 9 and 12; the algebra is the same."""
    if d >= 7:
        return dict(chunk=1, r_blk=1, interpret=True)
    return dict(chunk=16, r_blk=4, interpret=True)


def case_inputs(name: str) -> dict:
    """A random stable constant SSM with one output and per-step sites
    (numpy float64, time-last)."""
    d, n, batch, masked = _UNIFORM[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    fc = 0.8 * np.eye(d) + 0.05 * rng.standard_normal((d, d))
    lq = 0.3 * rng.standard_normal((d, d)) + np.eye(d)
    return {
        "fc": fc[..., None],
        "cc": 0.1 * rng.standard_normal((d, 1, 1)),
        "qc": (0.3 * lq @ lq.T)[..., None],
        "mu0": rng.standard_normal((d, 1, 1)),
        "p0": (1.5 * np.eye(d))[..., None],
        "hc": rng.standard_normal((1, d, 1)),
        "nu": rng.standard_normal(batch + (1, 1, n)),
        "lam": 2.0 + rng.random(batch + (1, 1, n)),
        "maskf": ((rng.random(batch + (1, 1, n)) > 0.3).astype(np.float64)
                  if masked else None),
    }


def case_gscale(name: str) -> np.ndarray:
    """The per-row cotangent of a case's log-likelihood."""
    batch = _UNIFORM[name][2]
    return np.linspace(0.7, -1.3, int(np.prod(batch))).reshape(batch)


def general_gscale(name: str) -> np.ndarray:
    """The per-row cotangent of a general case's log-likelihood."""
    batch = _GENERAL[name][2]
    return np.linspace(0.7, -1.3, int(np.prod(batch))).reshape(batch)


def general_inputs(name: str) -> dict:
    """Per-step prior steps of a random contraction SSM (F_0 = 0, the prior
    row), per-step emission rows and sites (numpy float64, time-last)."""
    d, n, batch, masked = _GENERAL[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = 0.8 * np.eye(d) + 0.1 * rng.standard_normal(batch + (n, d, d))
    lq = 0.3 * rng.standard_normal(batch + (n, d, d)) + np.eye(d)
    q = 0.3 * lq @ np.swapaxes(lq, -1, -2)
    f[..., 0, :, :] = 0.0
    q[..., 0, :, :] = 1.5 * np.eye(d)
    tl = lambda x: np.moveaxis(x, -3, -1)
    return {
        "F": tl(f),
        "c": 0.1 * rng.standard_normal(batch + (d, 1, n)),
        "Q": tl(q),
        "H": rng.standard_normal(batch + (1, d, n)),
        "nu": rng.standard_normal(batch + (1, 1, n)),
        "lam": 2.0 + rng.random(batch + (1, 1, n)),
        "maskf": ((rng.random(batch + (1, 1, n)) > 0.3).astype(np.float64)
                  if masked else None),
    }


def scan_inputs(name: str) -> tuple:
    """Random smoothing elements (E, g, L) for the reverse scan; E's entries
    shrink as 1 / sqrt(d) above d = 3, so that the suffix products do not
    grow with the state dim."""
    d, n, batch, _ = _GENERAL[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    lq = 0.3 * rng.standard_normal(batch + (n, d, d))
    scale = 0.4 * min(1.0, np.sqrt(3.0 / d))
    return (scale * rng.standard_normal(batch + (d, d, n)),
            rng.standard_normal(batch + (d, 1, n)),
            np.moveaxis(lq @ np.swapaxes(lq, -1, -2), -3, -1))


def main(out_path: str, names) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from markovflow_tpu.config import setup_compilation_cache
    from markovflow_tpu.ops.kalman import make_filter_elements_tl
    from markovflow_tpu.ops.pallas_scan import (
        pallas_adjoint_pipeline, pallas_adjoint_pipeline_uniform,
        pallas_filter_pipeline, pallas_filter_pipeline_uniform,
        pallas_filter_scan, pallas_smoother_pipeline_uniform,
        pallas_smoother_scan)

    # the persistent compilation cache the test suite uses (tests/conftest.py)
    setup_compilation_cache(os.environ.get(
        "MFTPU_TEST_CACHE_DIR", os.path.join(ROOT, ".jax_cache")))
    out = {}
    for name in names:
        kind, case = name.split(":") if ":" in name else ("", name)
        kw = interpret_kw((_GENERAL if case in _GENERAL else _UNIFORM)[case][0])
        filt = jax.jit(lambda *a: pallas_filter_pipeline_uniform(*a, **kw))
        smooth = jax.jit(lambda *a: pallas_smoother_pipeline_uniform(*a, **kw))
        adjoint = jax.jit(lambda *a: pallas_adjoint_pipeline_uniform(*a, **kw))
        gfilt = jax.jit(lambda *a: pallas_filter_pipeline(*a, **kw))
        gscan = jax.jit(lambda e: pallas_smoother_scan(e, **kw))
        fscan = jax.jit(lambda e: pallas_filter_scan(e, **kw))
        gadjoint = jax.jit(lambda *a: pallas_adjoint_pipeline(*a, **kw))
        if kind in ("fscan", "gadjoint"):
            x = {k: None if v is None else jnp.asarray(v)
                 for k, v in general_inputs(case).items()}
            args = [x[k] for k in GENERAL_INPUT_NAMES]
            if kind == "fscan":
                elems = make_filter_elements_tl(*args[:6])
                vals = dict(zip(ELEMENT_NAMES, elems))
                vals["m_f"], vals["p_f"] = fscan(elems)
            else:
                m_f, p_f, _ = gfilt(*args)
                vals = dict(zip(GADJOINT_NAMES, gadjoint(
                    *args, m_f, p_f, jnp.asarray(general_gscale(case)))),
                    m_f=m_f, p_f=p_f)
        elif name in _GENERAL:
            x = {k: None if v is None else jnp.asarray(v)
                 for k, v in general_inputs(name).items()}
            m_f, p_f, ll = gfilt(*(x[k] for k in GENERAL_INPUT_NAMES))
            m_s, p_s = gscan(tuple(jnp.asarray(v) for v in scan_inputs(name)))
            vals = dict(zip(GENERAL_OUTPUT_NAMES, (m_f, p_f, ll, m_s, p_s)))
        else:
            x = {k: None if v is None else jnp.asarray(v)
                 for k, v in case_inputs(case).items()}
            m_f, p_f, ll = filt(*(x[k] for k in INPUT_NAMES))
            if name.startswith("adjoint:"):
                vals = dict(zip(ADJOINT_NAMES, adjoint(
                    *(x[k] for k in INPUT_NAMES), m_f, p_f,
                    jnp.asarray(case_gscale(case)))), m_f=m_f, p_f=p_f)
            else:
                m_s, p_s = smooth(x["fc"], x["cc"], x["qc"], m_f, p_f)
                vals = dict(zip(OUTPUT_NAMES, (m_f, p_f, ll, m_s, p_s)))
        for key, val in vals.items():
            out[f"{name}/{key}"] = np.array(val)
    np.savez(out_path, **out)


def run_refs(tmp_dir, groups) -> dict:
    """Run :func:`main` on each group of case names in its own fresh
    process, all at once, and merge their outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for i, names in enumerate(groups):
        out = os.path.join(str(tmp_dir), f"refs{i}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_pallas_refs.py"), out, *names],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    refs = {}
    for out, proc in procs:
        log, _ = proc.communicate(timeout=1200)
        assert proc.returncode == 0, f"Pallas reference process failed:\n{log[-4000:]}"
        with np.load(out) as z:
            refs.update({k: z[k] for k in z.files})
    return refs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
