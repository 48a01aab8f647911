"""The JAX package's multi-output GPR, Product and MultivariateGaussian
outputs for ``test_torch_multi_output.py``, made in fresh processes.

``python tests/port/_mo_refs.py OUT.npz NAME...`` saves, under ``NAME/``,
for each named configuration of :data:`CONFIGS` (a GPR model on
:func:`data`'s series): whether it took the uniform-grid path, the
children's unconstrained hyperparameters, and one jitted program's
outputs: the log-likelihood, its gradients with respect to each child's
lengthscale and variance, the smoothed marginals, and at :func:`new_points`
``predict_f`` (diagonal and full output covariances) and ``predict_y``
(each jitted on its own, or eagerly; the predictions of one series only:
the JAX conditionals take no batch).
The name ``kernels`` saves the prior steps, emission and state-space model
of the multi-output kernels of :data:`KERNELS` on one uniform and one
batched irregular grid; ``likelihood`` the five outputs of a
``MultivariateGaussian`` on :func:`likelihood_inputs`.

The port's tests run it through :func:`run_refs` (the reason is
``_cvi_refs.py``'s).  The data are made here from numpy seeds, so the
tests rebuild the very same arrays.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

N = 256
N_NEW = 40
#: the slice's configuration (mo3: three Matern32, lengthscales 0.5, 1, 2,
#: variance 1) and the JAX package's mixed one
#: (tests/integration/test_combinator_matrix.py): (kind, lengthscale,
#: variance) of each child
MO3 = (("Matern32", 0.5, 1.0), ("Matern32", 1.0, 1.0), ("Matern32", 2.0, 1.0))
MIXED = (("Matern12", 0.7, 1.3), ("Matern32", 1.1, 0.4), ("Matern52", 0.9, 0.6))
#: mo9: the d9 model's three Matern52 children (bench.py's d9 config),
#: d = 9, o = 3: the general kernels at o > 1 above d = 6
MO9 = (("Matern52", 0.5, 1.0), ("Matern52", 2.0, 0.5), ("Matern52", 8.0, 0.25))
#: a full noise Cholesky, so that the sites' lam is not diagonal
CHOL3 = np.array([[0.2, 0.0, 0.0], [0.05, 0.2, 0.0], [0.02, 0.05, 0.2]])
#: name -> (combinator, children, batch shape, uniform grid)
CONFIGS = {
    "mo3_uniform": ("IndependentMultiOutput", MO3, (), True),
    "mo3_jittered": ("IndependentMultiOutput", MO3, (), False),
    "mixed_uniform": ("IndependentMultiOutput", MIXED, (), True),
    "mixed2_jittered_batch3": ("IndependentMultiOutput", MIXED[:2], (3,), False),
    "product_12x32_uniform": ("Product", (("Matern12", 0.7, 1.3), ("Matern32", 1.1, 0.4)),
                              (), True),
    "product_32x32_jittered": ("Product", (("Matern32", 0.8, 1.0), ("Matern32", 1.5, 0.5)),
                               (), False),
}
#: mo9 on a uniform and a jittered grid, made only where named
#: (test_torch_wide_multi_output.py); their seeds follow CONFIGS'
WIDE_CONFIGS = {
    "mo9_uniform": ("IndependentMultiOutput", MO9, (), True),
    "mo9_jittered": ("IndependentMultiOutput", MO9, (), False),
}
_ALL = {**CONFIGS, **WIDE_CONFIGS}
#: the kernels whose prior steps, emission and SSM ``kernels`` saves
KERNELS = {"mo3": MO3, "mixed": MIXED, "mixed2": MIXED[:2]}
#: the reference processes of test_torch_multi_output.py, balanced by
#: cost: 85-130 s each for a model (its eager gradient, ~45 s at d = 6; its
#: jitted pieces) when six run at once on eight cores (mo9's configurations
#: run in test_torch_wide_multi_output.py)
GROUPS = (("mo3_uniform",), ("mo3_jittered",), ("mixed_uniform",),
          ("mixed2_jittered_batch3", "likelihood"), ("product_12x32_uniform", "kernels"),
          ("product_32x32_jittered",))


def _seed(name: str) -> int:
    """The configuration's index (CONFIGS' sorted, then WIDE_CONFIGS')."""
    if name in CONFIGS:
        return sorted(CONFIGS).index(name)
    return len(CONFIGS) + sorted(WIDE_CONFIGS).index(name)


def output_dim(name: str) -> int:
    comb, children, _, _ = _ALL[name]
    return len(children) if comb == "IndependentMultiOutput" else 1


def chol(o: int) -> np.ndarray:
    return CHOL3[:o, :o] if o > 1 else np.array([[0.2]])


def data(name: str):
    """(x [batch..., N], y [batch..., N, o]): linspace(0, 10, N), jittered
    by up to 0.4 of the spacing off the uniform grid; y_i = sin((i + 1) x)
    + 0.2 noise."""
    _, _, batch, uniform = _ALL[name]
    o = output_dim(name)
    rng = np.random.default_rng(_seed(name))
    x = np.broadcast_to(np.linspace(0.0, 10.0, N), batch + (N,)).copy()
    if not uniform:
        x = x + 0.4 * (10.0 / (N - 1)) * rng.uniform(-1.0, 1.0, x.shape)
    f = np.stack([np.sin((i + 1.0) * x) for i in range(o)], axis=-1)
    return x, f + 0.2 * rng.standard_normal(f.shape)


def new_points(name: str) -> np.ndarray:
    """Points inside, on and past both ends of the grid."""
    x, _ = data(name)
    rng = np.random.default_rng(100 + _seed(name))
    pts = np.concatenate([[-0.5, x.reshape(-1)[0], x.reshape(-1)[7], 10.5],
                          rng.uniform(0.0, 10.0, N_NEW - 4)])
    return np.sort(pts)


def kernel_grids():
    """A uniform grid [N] and a batched irregular one [3, N] (each row
    linspace(0, 10, N) jittered by up to 0.4 of the spacing)."""
    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 10.0, N)
    return {"uniform": x,
            "batch3": x + 0.4 * (10.0 / (N - 1)) * rng.uniform(-1.0, 1.0, (3, N))}


def likelihood_inputs():
    """(chol [3, 3], f [5, N_NEW, 3], f_means, f_covs [5, N_NEW, 3, 3], y)."""
    rng = np.random.default_rng(21)
    shape = (5, N_NEW, 3)
    lf = 0.3 * rng.standard_normal(shape + (3,))
    covs = lf @ np.swapaxes(lf, -1, -2) + 0.1 * np.eye(3)
    return (CHOL3, rng.standard_normal(shape), rng.standard_normal(shape), covs,
            rng.standard_normal(shape))


def main(out_path: str, names) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import markovflow_tpu.kernels as jk
    from markovflow_tpu.likelihoods import MultivariateGaussian
    from markovflow_tpu.models import GaussianProcessRegression
    from markovflow_tpu.utils import filtered_value_and_grad

    def children(specs):
        return [getattr(jk, k)(lengthscale=e, variance=v) for k, e, v in specs]

    out = {}
    for name in names:
        if name == "kernels":
            for kname, specs in KERNELS.items():
                k = jk.IndependentMultiOutput(children(specs))
                for gname, t in kernel_grids().items():
                    tag = f"{name}/{kname}/{gname}"
                    t = jnp.asarray(t)
                    for key, v in zip(("F", "c", "Q"), k.prior_arrays_tl(t)):
                        out[f"{tag}/{key}"] = v
                    for key, v in zip(("Fc", "cc", "Qc", "mu0", "P0"),
                                      k.prior_const_tl(t[..., 1:2] - t[..., :1])):
                        out[f"{tag}/{key}"] = v
                    out[f"{tag}/H"] = k.generate_emission_model(t).emission_matrix
                    ssm = k.state_space_model(t)
                    for key in ("initial_mean", "cholesky_initial_covariance",
                                "state_transitions", "state_offsets",
                                "cholesky_process_covariances"):
                        out[f"{tag}/{key}"] = getattr(ssm, key)
            continue
        if name == "likelihood":
            ch, f, fm, fc, y = (jnp.asarray(a) for a in likelihood_inputs())
            lik = MultivariateGaussian(ch)
            out[f"{name}/log_probability_density"] = lik.log_probability_density(f, y)
            out[f"{name}/variational_expectations"] = lik.variational_expectations(fm, fc, y)
            out[f"{name}/predict_mean"], out[f"{name}/predict_cov"] = \
                lik.predict_mean_and_var(fm, fc)
            out[f"{name}/predict_density"] = lik.predict_density(fm, fc, y)
            out[f"{name}/needs_full_cov"] = np.asarray(lik.needs_full_cov)
            continue
        comb, specs, _, _ = _ALL[name]
        kids = children(specs)
        kernel = getattr(jk, comb)(kids)
        x, y = data(name)
        model = GaussianProcessRegression(
            input_data=(x, jnp.asarray(y)), kernel=kernel,
            chol_obs_covariance=jnp.asarray(chol(output_dim(name))))
        out[f"{name}/uniform"] = np.asarray(model._uniform_grid)
        for i, kid in enumerate(kids):
            for p in ("lengthscale", "variance"):
                out[f"{name}/kernel.kernels[{i}].{p}"] = getattr(kid, p).unconstrained
        t = jnp.asarray(new_points(name))
        # each piece jitted on its own or run eagerly: under one jit XLA:CPU
        # compiles the d = 6 gradient in 11 minutes (eagerly it takes 45 s)
        out[f"{name}/loglik"] = jax.jit(lambda m: m.log_likelihood())(model)
        out[f"{name}/marg_means"], out[f"{name}/marg_covs"] = \
            model.kalman.posterior_marginals()
        if not _ALL[name][2]:  # the JAX conditionals take one series
            post = model.posterior
            out[f"{name}/f_mean"], out[f"{name}/f_var"] = post.predict_f(t)
            out[f"{name}/f_mean_full"], out[f"{name}/f_cov"] = post.predict_f(
                t, full_output_cov=True)
            out[f"{name}/y_mean"], out[f"{name}/y_cov"] = post.predict_y(t)
        _, grads = filtered_value_and_grad(lambda mm: jnp.sum(mm.loss()), model)
        for i, g in enumerate(grads.kernel.kernels):
            for p in ("lengthscale", "variance"):
                out[f"{name}/grad kernel.kernels[{i}].{p}"] = getattr(g, p).unconstrained
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


def run_refs(tmp_dir, groups) -> dict:
    """Run :func:`main` on each group of names in its own fresh process,
    all at once, and merge their outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for i, names in enumerate(groups):
        out = os.path.join(str(tmp_dir), f"mo_refs{i}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_mo_refs.py"), out, *names],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    refs = {}
    for out, proc in procs:
        log, _ = proc.communicate(timeout=1200)
        assert proc.returncode == 0, f"multi-output reference process failed:\n{log[-4000:]}"
        with np.load(out) as z:
            refs.update({k: z[k] for k in z.files})
    return refs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
