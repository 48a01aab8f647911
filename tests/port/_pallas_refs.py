"""Reference outputs of the JAX package's uniform-grid Pallas kernels.

``python tests/port/_pallas_refs.py OUT.npz CASE...`` runs
``pallas_filter_pipeline_uniform`` and ``pallas_smoother_pipeline_uniform``
in interpret mode (chunk=16, r_blk=4, as tests/unit/test_uniform_path.py
runs them) on the named cases of :data:`CASES` and saves their outputs.
The port's tests run it in fresh processes: interpret-mode Pallas programs
can crash XLA:CPU in a process that has already compiled many programs (the
reason for ``tests.tools.isolated``).  Tracing, lowering and compiling one
case takes seconds (about 16 s for both kernels at d = 3), so the tests
split the cases over a few concurrent processes.

The inputs are made here from numpy seeds, so the port's tests rebuild the
very same arrays with :func:`case_inputs`.
"""
from __future__ import annotations

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
INPUT_NAMES = ("fc", "cc", "qc", "mu0", "p0", "hc", "nu", "lam", "maskf")
OUTPUT_NAMES = ("m_f", "p_f", "loglik", "m_s", "p_s")


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


def main(out_path: str, names) -> None:
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from markovflow_tpu.config import setup_compilation_cache
    from markovflow_tpu.ops.pallas_scan import (
        pallas_filter_pipeline_uniform, pallas_smoother_pipeline_uniform)

    # the persistent compilation cache the test suite uses (tests/conftest.py)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    setup_compilation_cache(os.environ.get(
        "MFTPU_TEST_CACHE_DIR", os.path.join(root, ".jax_cache")))
    filt = jax.jit(lambda *a: pallas_filter_pipeline_uniform(
        *a, chunk=16, r_blk=4, interpret=True))
    smooth = jax.jit(lambda *a: pallas_smoother_pipeline_uniform(
        *a, chunk=16, r_blk=4, interpret=True))
    out = {}
    for name in names:
        x = {k: None if v is None else jnp.asarray(v)
             for k, v in case_inputs(name).items()}
        m_f, p_f, ll = filt(*(x[k] for k in INPUT_NAMES))
        m_s, p_s = smooth(x["fc"], x["cc"], x["qc"], m_f, p_f)
        for key, val in zip(OUTPUT_NAMES, (m_f, p_f, ll, m_s, p_s)):
            out[f"{name}/{key}"] = np.array(val)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
