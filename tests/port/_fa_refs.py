"""The JAX package's GP factor analysis outputs for
``test_torch_factor_analysis.py``, made in one fresh process.

``python tests/port/_fa_refs.py OUT.npz`` saves:

* under ``kernel/o{O}/{GRID}/``, for the ``FactorAnalysisKernel`` of
  :data:`KERNEL_LATENTS` (the latents of the JAX package's own tests), a
  seeded loading and identity weights at output dims 2 and 3 on one uniform grid
  [N] and one batched irregular one [3, N]: the prior steps (per-step and
  constant), the emission, the state-space model and the projections to
  the latent space g of :func:`projection_inputs`' states and covariances;
  and under ``kernel/grad`` the gradient of a covariance entry through a
  latent's lengthscale (``tests/integration/test_combinator_matrix.py``'s
  probe);
* under ``NAME/``, for each configuration of :data:`CONFIGS` (a GPR model
  on :func:`data`'s series, its loading trainable): whether the JAX model
  took the uniform-grid path, the latents' unconstrained hyperparameters
  and the loading, the log-likelihood and its gradients with respect to
  them, the smoothed marginals and, at :func:`new_points`, ``predict_f``
  (diagonal and full) and ``predict_y``.  A time-varying weight function
  on a uniform grid is built with ``uniform_grid=False``: the JAX
  package's general route, the reference, since its uniform route reads
  step 0's emission at every step.

The data, weights and loading are made here from numpy seeds, so the
tests rebuild the very same arrays and the same weight function in torch
(:func:`weights`).  Run through :func:`run_refs` (the reason is
``_cvi_refs.py``'s).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

N = 160
N_NEW = 30
#: the latents of the GPR configurations (kind, lengthscale, variance): d = 3
LATENTS = (("Matern32", 0.6, 1.0), ("Matern12", 1.5, 0.8))
#: the latents of the kernel cases (tests/integration/test_combinator_matrix.py)
KERNEL_LATENTS = (("Matern12", 0.7, 1.3), ("Matern32", 1.1, 0.4))
#: name -> (output dim, time-varying weights, uniform grid)
CONFIGS = {
    "tv_uniform": (5, True, True),
    "tv_jittered": (5, True, False),
    "const_uniform": (5, False, True),
    "const_jittered": (4, False, False),
    "const8_uniform": (8, False, True),
}
#: fa9's latents: the d9 model's three Matern52 children, d = 9
LATENTS9 = (("Matern52", 0.5, 1.0), ("Matern52", 2.0, 0.5), ("Matern52", 8.0, 0.25))
#: fa9 (twelve outputs of LATENTS9 with time-varying weights: the general
#: kernels at d = 9, o = 12), made only where named (main's ``names``;
#: test_torch_wide_multi_output.py)
WIDE_CONFIGS = {
    "fa9_uniform": (12, True, True),
    "fa9_jittered": (12, True, False),
}
_ALL = {**CONFIGS, **WIDE_CONFIGS}


def _seed(name: str) -> int:
    """The configuration's index (CONFIGS' sorted, then WIDE_CONFIGS')."""
    if name in CONFIGS:
        return sorted(CONFIGS).index(name)
    return len(CONFIGS) + sorted(WIDE_CONFIGS).index(name)


def latents_of(name: str):
    """The latents (kind, lengthscale, variance) of a configuration."""
    return LATENTS9 if name in WIDE_CONFIGS else LATENTS


def periods(o: int) -> np.ndarray:
    return np.linspace(2.0, 9.0, o)


def weights(t, o: int, varying: bool, xp):
    """A(t) [..., N, o, o] for time points t [..., N] in the array module
    xp (jax.numpy or torch): diag(1 + 0.5 sin(2 pi t / p_i)) when
    ``varying``, else the identity expanded (stride 0 along time)."""
    if xp.__name__ == "torch":
        eye = xp.eye(o, dtype=t.dtype, device=t.device)
        if not varying:
            return eye.expand(tuple(t.shape) + (o, o))
        p = xp.as_tensor(periods(o), dtype=t.dtype, device=t.device)
        a = 1.0 + 0.5 * xp.sin(2.0 * np.pi * t[..., None] / p)
        return a[..., :, None] * eye
    eye = xp.eye(o)
    if not varying:
        return xp.broadcast_to(eye, t.shape + (o, o))
    a = 1.0 + 0.5 * xp.sin(2.0 * np.pi * t[..., None] / xp.asarray(periods(o)))
    return a[..., :, None] * eye


def loading(o: int, n_latents: int = 2) -> np.ndarray:
    return np.random.default_rng(40 + o).standard_normal((o, n_latents))


def chol(o: int) -> np.ndarray:
    """A full lower-triangular noise Cholesky [o, o]."""
    rng = np.random.default_rng(50 + o)
    return np.tril(0.05 * rng.standard_normal((o, o)), -1) + np.diag(rng.uniform(0.2, 0.4, o))


def data(name: str):
    """(x [N], y [N, o]): linspace(0, 10, N), jittered by up to 0.4 of the
    spacing off the uniform grid; y_i = sin((i + 1) x / 2) + 0.3 noise."""
    o, _, uniform = _ALL[name]
    rng = np.random.default_rng(_seed(name))
    x = np.linspace(0.0, 10.0, N)
    if not uniform:
        x = x + 0.4 * (10.0 / (N - 1)) * rng.uniform(-1.0, 1.0, x.shape)
    f = np.stack([np.sin((i + 1.0) * x / 2.0) for i in range(o)], axis=-1)
    return x, f + 0.3 * rng.standard_normal(f.shape)


def new_points(name: str) -> np.ndarray:
    """Points inside, on and past both ends of the grid."""
    x, _ = data(name)
    rng = np.random.default_rng(100 + _seed(name))
    pts = np.concatenate([[-0.5, x[0], x[7], 10.5], rng.uniform(0.0, 10.0, N_NEW - 4)])
    return np.sort(pts)


def kernel_grids():
    """A uniform grid [N] and a batched irregular one [3, N]."""
    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 10.0, N)
    return {"uniform": x,
            "batch3": x + 0.4 * (10.0 / (N - 1)) * rng.uniform(-1.0, 1.0, (3, N))}


def projection_inputs(grid_shape):
    """States [..., N, d] and covariances [..., N, d, d] (d = 3) to project."""
    rng = np.random.default_rng(11)
    lc = 0.5 * rng.standard_normal(grid_shape + (3, 3))
    return rng.standard_normal(grid_shape + (3,)), lc @ np.swapaxes(lc, -1, -2) + 0.1 * np.eye(3)


def main(out_path: str, names=()) -> None:
    """Everything but WIDE_CONFIGS, or with ``names`` only those
    configurations."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import markovflow_tpu.kernels as jk
    from markovflow_tpu.models import GaussianProcessRegression
    from markovflow_tpu.utils import filtered_value_and_grad

    def latents(specs):
        return [getattr(jk, k)(lengthscale=e, variance=v) for k, e, v in specs]

    out = {}
    for o in () if names else (2, 3):
        for gname, t in kernel_grids().items():
            tag = f"kernel/o{o}/{gname}"
            k = jk.FactorAnalysisKernel(lambda tt, o=o: weights(tt, o, False, jnp),
                                        latents(KERNEL_LATENTS), output_dim=o,
                                        loading=jnp.asarray(loading(o)), trainable_loading=False)
            t = jnp.asarray(t)
            for key, v in zip(("F", "c", "Q"), k.prior_arrays_tl(t)):
                out[f"{tag}/{key}"] = v
            for key, v in zip(("Fc", "cc", "Qc", "mu0", "P0"),
                              k.prior_const_tl(t[..., 1:2] - t[..., :1])):
                out[f"{tag}/{key}"] = v
            em = k.generate_emission_model(t)
            out[f"{tag}/H"] = em.emission_matrix
            ssm = k.state_space_model(t)
            for key in ("initial_mean", "cholesky_initial_covariance", "state_transitions",
                        "state_offsets", "cholesky_process_covariances"):
                out[f"{tag}/{key}"] = getattr(ssm, key)
            s, cov = (jnp.asarray(a) for a in projection_inputs(t.shape))
            out[f"{tag}/g"] = em.project_state_to_g(s)
            out[f"{tag}/g_var"] = em.project_state_covariance_to_g(cov)
            out[f"{tag}/g_cov"] = em.project_state_covariance_to_g(cov, full_output_cov=True)
            out[f"{tag}/f_cov"] = em.project_state_covariance_to_f(cov, full_output_cov=True)

    ts = jnp.asarray([0.0, 0.4, 1.3])
    b3 = jnp.asarray(loading(3))

    def probe(ell):
        kids = latents(KERNEL_LATENTS)
        kids[0] = jk.Matern12(lengthscale=ell, variance=1.3)
        k = jk.FactorAnalysisKernel(lambda tt: weights(tt, 3, False, jnp), kids, output_dim=3,
                                    loading=b3, trainable_loading=False)
        ssm = k.state_space_model(ts)
        a, p = ssm.state_transitions, ssm.marginal_covariances
        h = k.generate_emission_model(ts).emission_matrix
        return (h[0] @ (p[0] @ a[0].T) @ h[1].T)[0, 0]

    if not names:
        out["kernel/grad"] = jax.grad(probe)(0.7)

    for name in names or CONFIGS:
        o, varying, uniform = _ALL[name]
        kids = latents(latents_of(name))
        kernel = jk.FactorAnalysisKernel(lambda tt, o=o, v=varying: weights(tt, o, v, jnp),
                                         kids, output_dim=o,
                                         loading=jnp.asarray(loading(o, len(kids))),
                                         trainable_loading=True)
        x, y = data(name)
        model = GaussianProcessRegression(
            input_data=(x, jnp.asarray(y)), kernel=kernel,
            chol_obs_covariance=jnp.asarray(chol(o)),
            uniform_grid=False if varying else None)
        out[f"{name}/uniform"] = np.asarray(model._uniform_grid)
        for i, kid in enumerate(kids):
            for p in ("lengthscale", "variance"):
                out[f"{name}/kernel._inner.kernels[{i}].{p}"] = getattr(kid, p).unconstrained
        out[f"{name}/kernel._loading"] = kernel._loading.unconstrained
        out[f"{name}/loglik"] = jax.jit(lambda m: m.log_likelihood())(model)
        out[f"{name}/marg_means"], out[f"{name}/marg_covs"] = model.kalman.posterior_marginals()
        t = jnp.asarray(new_points(name))
        post = model.posterior
        out[f"{name}/f_mean"], out[f"{name}/f_var"] = post.predict_f(t)
        out[f"{name}/f_mean_full"], out[f"{name}/f_cov"] = post.predict_f(
            t, full_output_cov=True)
        out[f"{name}/y_mean"], out[f"{name}/y_cov"] = post.predict_y(t)
        _, grads = filtered_value_and_grad(lambda mm: jnp.sum(mm.loss()), model)
        for i, g in enumerate(grads.kernel._inner.kernels):
            for p in ("lengthscale", "variance"):
                out[f"{name}/grad kernel._inner.kernels[{i}].{p}"] = getattr(g, p).unconstrained
        out[f"{name}/grad kernel._loading"] = grads.kernel._loading.unconstrained
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


def run_refs(tmp_dir, names=()) -> dict:
    """Run :func:`main` (on ``names``) in a fresh process and load its
    outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = os.path.join(str(tmp_dir), "fa_refs.npz")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "_fa_refs.py"), out, *names],
                          env=env,
                          cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=1200)
    assert proc.returncode == 0, f"factor analysis reference process failed:\n{proc.stdout[-4000:]}"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
