"""The JAX package's CVI outputs for ``test_torch_cvi.py``, made in fresh
processes.

``python tests/port/_cvi_refs.py OUT.npz NAME...`` builds the JAX CVI model
of each named configuration of :data:`CONFIGS` on :func:`problem`'s data
and saves, under ``NAME/``, whether it took the uniform-grid path, its
hyperparameters (unconstrained) and one jitted program's outputs: the
sites after one and after three site updates, then the ELBO and its
gradients, the classic ELBO, ``predict_f`` and ``predict_log_density``.

The port's tests run it through :func:`run_refs`, not in their own
process: these programs' executables, (de)serialized in a test worker
that has already compiled many programs, crash XLA:CPU later in that
worker (the reason for ``tests.tools.isolated``).

The data are made here from numpy seeds, so the tests rebuild the very
same arrays with :func:`problem`.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

N = 96
LR = 0.5
#: name -> (likelihood, uniform grid, mean function)
CONFIGS = {f"{lik.lower()}_{'uniform' if u else 'jittered'}": (lik, u, None)
           for lik in ("Gaussian", "Bernoulli", "Poisson") for u in (True, False)}
CONFIGS["poisson_jittered_linear_mean"] = ("Poisson", False, "Linear")
#: the JAX model's lengthscale, variance, Gaussian noise variance and
#: linear mean coefficient
LENGTHSCALE, VARIANCE, NOISE_VARIANCE, COEFFICIENT = 0.7, 1.3, 0.09, -0.05
OUTPUTS = {"sites1": 2, "sites3": 2, "elbo": 1, "grads": 2, "classic_elbo": 1,
           "predict_f": 2, "predict_log_density": 1}


def data(likelihood, uniform, rng, n=N):
    """x on [0, 10] (jittered by up to 0.4 of the spacing) and y of the
    likelihood around sin(2x)."""
    x = np.linspace(0.0, 10.0, n)
    if not uniform:
        x = x + 0.4 * (10.0 / (n - 1)) * rng.uniform(-1.0, 1.0, n)
    f = np.sin(2.0 * x)
    y = {"Gaussian": f + 0.2 * rng.standard_normal(n),
         "Bernoulli": (f + 0.3 * rng.standard_normal(n) > 0).astype(np.float64),
         "Poisson": rng.poisson(np.exp(f)).astype(np.float64)}[likelihood]
    return x, y[:, None]


def problem(name):
    """(x, y, x_new, y_new) of a configuration: the new points include both
    ends, points past them and points between."""
    likelihood, uniform, _ = CONFIGS[name]
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    x, y = data(likelihood, uniform, rng)
    x_new = np.concatenate([[-2.0, x[0]], rng.uniform(0.0, 10.0, 12), [x[-1], 12.5]])
    return x, y, x_new, data(likelihood, uniform, rng, x_new.size)[1]


def main(out_path: str, names) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from markovflow_tpu import likelihoods as jl
    from markovflow_tpu import mean_function as jmf
    from markovflow_tpu.config import setup_compilation_cache
    from markovflow_tpu.kernels import Matern32
    from markovflow_tpu.models.variational_cvi import CVIGaussianProcess
    from markovflow_tpu.utils import filtered_value_and_grad

    # the persistent compilation cache the test suite uses (tests/conftest.py)
    setup_compilation_cache(os.environ.get(
        "MFTPU_TEST_CACHE_DIR", os.path.join(ROOT, ".jax_cache")))

    def outputs(m, x_new, y_new):
        m1 = m.update_sites()
        m3 = m1.update_sites().update_sites()
        elbo, grads = filtered_value_and_grad(lambda mm: mm.elbo(), m3)
        return {"sites1": (m1.sites.nat1, m1.sites.nat2),
                "sites3": (m3.sites.nat1, m3.sites.nat2),
                "elbo": (elbo,), "grads": (grads.kernel.lengthscale.unconstrained,
                                           grads.kernel.variance.unconstrained),
                "classic_elbo": (m3.classic_elbo(),), "predict_f": m3.predict_f(x_new),
                "predict_log_density": (m3.predict_log_density((x_new, y_new)),)}
    run = jax.jit(outputs)
    out = {}
    for name in names:
        likelihood, _, mean = CONFIGS[name]
        x, y, x_new, y_new = problem(name)
        lik = {"Gaussian": lambda: jl.Gaussian(variance=NOISE_VARIANCE),
               "Bernoulli": jl.Bernoulli, "Poisson": jl.Poisson}[likelihood]()
        m = CVIGaussianProcess(
            (jnp.asarray(x), jnp.asarray(y)),
            Matern32(lengthscale=LENGTHSCALE, variance=VARIANCE), lik, learning_rate=LR,
            mean_function=None if mean is None else jmf.LinearMeanFunction(COEFFICIENT))
        out[f"{name}/uniform_grid"] = np.array(m._uniform_grid)
        out[f"{name}/kernel.lengthscale"] = np.array(m.kernel.lengthscale.unconstrained)
        out[f"{name}/kernel.variance"] = np.array(m.kernel.variance.unconstrained)
        if likelihood == "Gaussian":
            out[f"{name}/likelihood.variance"] = np.array(m.likelihood.variance.unconstrained)
        for key, vals in run(m, jnp.asarray(x_new), jnp.asarray(y_new)).items():
            for i, val in enumerate(vals):
                out[f"{name}/{key}/{i}"] = np.array(val)
    np.savez(out_path, **out)


def run_refs(tmp_dir, groups) -> dict:
    """Run :func:`main` on each group of configuration names in its own
    fresh process, all at once, and merge their outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for i, names in enumerate(groups):
        out = os.path.join(str(tmp_dir), f"cvi_refs{i}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_cvi_refs.py"), out, *names],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    refs = {}
    for out, proc in procs:
        log, _ = proc.communicate(timeout=1200)
        assert proc.returncode == 0, f"CVI reference process failed:\n{log[-4000:]}"
        with np.load(out) as z:
            refs.update({k: z[k] for k in z.files})
    return refs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
