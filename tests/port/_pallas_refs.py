"""Reference outputs of the JAX package's Pallas kernels, in interpret mode.

``python tests/port/_pallas_refs.py OUT.npz CASE...`` runs the kernels of
each named case in interpret mode (chunk=16, r_blk=4, as
tests/unit/test_uniform_path.py runs them) and saves their outputs:

* a case of :data:`CASES` (uniform grid) runs
  ``pallas_filter_pipeline_uniform`` and ``pallas_smoother_pipeline_uniform``;
* ``adjoint:CASE`` runs ``pallas_filter_pipeline_uniform`` and, on its
  output, ``pallas_adjoint_pipeline_uniform`` with the per-row cotangent
  :func:`case_gscale`;
* a case of :data:`GENERAL_CASES` runs ``pallas_filter_pipeline`` on
  per-step prior steps and ``pallas_smoother_scan`` on prebuilt elements.

The port's tests run it in fresh processes (:func:`run_refs`):
interpret-mode Pallas programs can crash XLA:CPU in a process that has
already compiled many programs (the reason for ``tests.tools.isolated``).
Tracing, lowering and compiling one case takes seconds (about 16 s for the
filter and smoother at d = 3), so the tests split the cases over a few
concurrent processes.

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
INPUT_NAMES = ("fc", "cc", "qc", "mu0", "p0", "hc", "nu", "lam", "maskf")
OUTPUT_NAMES = ("m_f", "p_f", "loglik", "m_s", "p_s")
ADJOINT_NAMES = ("gFc", "gcc", "gQc", "gmu0", "gP0", "gHc", "gnu", "glam")
GENERAL_INPUT_NAMES = ("F", "c", "Q", "H", "nu", "lam", "maskf")
GENERAL_OUTPUT_NAMES = ("m_f", "p_f", "loglik", "m_s", "p_s")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def case_inputs(name: str) -> dict:
    """A random stable constant SSM with one output and per-step sites
    (numpy float64, time-last)."""
    d, n, batch, masked = CASES[name]
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
    batch = CASES[name][2]
    return np.linspace(0.7, -1.3, int(np.prod(batch))).reshape(batch)


def general_inputs(name: str) -> dict:
    """Per-step prior steps of a random contraction SSM (F_0 = 0, the prior
    row), per-step emission rows and sites (numpy float64, time-last)."""
    d, n, batch, masked = GENERAL_CASES[name]
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
    """Random smoothing elements (E, g, L) for the reverse scan."""
    d, n, batch, _ = GENERAL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    lq = 0.3 * rng.standard_normal(batch + (n, d, d))
    return (0.4 * rng.standard_normal(batch + (d, d, n)),
            rng.standard_normal(batch + (d, 1, n)),
            np.moveaxis(lq @ np.swapaxes(lq, -1, -2), -3, -1))


def main(out_path: str, names) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from markovflow_tpu.config import setup_compilation_cache
    from markovflow_tpu.ops.pallas_scan import (
        pallas_adjoint_pipeline_uniform, pallas_filter_pipeline,
        pallas_filter_pipeline_uniform, pallas_smoother_pipeline_uniform,
        pallas_smoother_scan)

    # the persistent compilation cache the test suite uses (tests/conftest.py)
    setup_compilation_cache(os.environ.get(
        "MFTPU_TEST_CACHE_DIR", os.path.join(ROOT, ".jax_cache")))
    kw = dict(chunk=16, r_blk=4, interpret=True)
    filt = jax.jit(lambda *a: pallas_filter_pipeline_uniform(*a, **kw))
    smooth = jax.jit(lambda *a: pallas_smoother_pipeline_uniform(*a, **kw))
    adjoint = jax.jit(lambda *a: pallas_adjoint_pipeline_uniform(*a, **kw))
    gfilt = jax.jit(lambda *a: pallas_filter_pipeline(*a, **kw))
    gscan = jax.jit(lambda e: pallas_smoother_scan(e, **kw))
    out = {}
    for name in names:
        if name in GENERAL_CASES:
            x = {k: None if v is None else jnp.asarray(v)
                 for k, v in general_inputs(name).items()}
            m_f, p_f, ll = gfilt(*(x[k] for k in GENERAL_INPUT_NAMES))
            m_s, p_s = gscan(tuple(jnp.asarray(v) for v in scan_inputs(name)))
            vals = dict(zip(GENERAL_OUTPUT_NAMES, (m_f, p_f, ll, m_s, p_s)))
        else:
            case = name.split(":")[-1]
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
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"Pallas reference process failed:\n{log[-4000:]}"
        with np.load(out) as z:
            refs.update({k: z[k] for k in z.files})
    return refs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
