"""The JAX package's natural-gradient outputs for ``test_torch_natgrad.py``,
made in fresh processes.

``python tests/port/_natgrad_refs.py OUT.npz GROUP`` runs one group of
:data:`GROUPS` and saves its outputs:

* ``vgp``: the Bernoulli VGP's ELBO at the prior, then two jitted steps
  (gamma 0.5) of each naturals engine, plain and with momentum: the new
  SSM's fields and the loss after each step;
* ``svgp``: the Gaussian SVGP's ELBO at the prior and one step of each
  engine (fields, and the ELBO at the new q); a random SSM's precision
  and normalizer; the CVI model's ``dist_q_naturals`` at random sites.

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

N = 48          # VGP data, and the SVGP's minibatch
M = 16          # SVGP inducing points
GAMMA = 0.5
STEPS = 2
LENGTHSCALE, VARIANCE, NOISE_VARIANCE = 0.7, 1.3, 0.09
ENGINES = ("sequential", "parallel")
GROUPS = ("vgp", "svgp")
FIELDS = ("initial_mean", "cholesky_initial_covariance", "state_transitions",
          "state_offsets", "cholesky_process_covariances")


def vgp_data():
    """Bernoulli labels around sin(2x) on linspace(0, 5, N)."""
    rng = np.random.default_rng(11)
    x = np.linspace(0.0, 5.0, N)
    y = (np.sin(2.0 * x) + 0.3 * rng.standard_normal(N) > 0).astype(np.float64)
    return x, y[:, None]


def svgp_data():
    """y = sin(2x) + 0.3 noise on linspace(0, 5, N), inducing points on
    linspace(-0.01, 5.01, M)."""
    rng = np.random.default_rng(12)
    x = np.linspace(0.0, 5.0, N)
    y = np.sin(2.0 * x) + 0.3 * rng.standard_normal(N)
    return x, y[:, None], np.linspace(-0.01, 5.01, M)


def cvi_sites():
    """Sites (nat1 [N, 1], nat2 [N, 1, 1]) of precision 1..5 on
    vgp_data's grid."""
    rng = np.random.default_rng(13)
    lam = rng.uniform(1.0, 5.0, (N, 1))
    return lam * rng.standard_normal((N, 1)), (-0.5 * lam)[..., None]


def fields(ssm):
    return [np.array(getattr(ssm, f)) for f in FIELDS]


def main(out_path: str, group: str) -> None:
    import functools

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from markovflow_tpu import likelihoods as jl
    from markovflow_tpu.config import setup_compilation_cache
    from markovflow_tpu.kernels import Matern32
    from markovflow_tpu.models import SparseVariationalGaussianProcess
    from markovflow_tpu.models.variational import VariationalGaussianProcess
    from markovflow_tpu.models.variational_cvi import CVIGaussianProcess
    from markovflow_tpu.kalman_filter import UnivariateGaussianSitesNat
    from markovflow_tpu.ssm_natgrad import SSMNaturalGradient
    from markovflow_tpu.state_space_model import StateSpaceModel

    setup_compilation_cache(os.environ.get(
        "MFTPU_TEST_CACHE_DIR", os.path.join(ROOT, ".jax_cache")))
    kernel = lambda: Matern32(lengthscale=LENGTHSCALE, variance=VARIANCE)  # noqa: E731
    out = {}
    if group == "vgp":
        x, y = vgp_data()
        vgp = VariationalGaussianProcess((jnp.asarray(x), jnp.asarray(y)), kernel(),
                                         jl.Bernoulli())
        out["elbo0"] = np.array(vgp.elbo())
        for engine in ENGINES:
            for mom in (False, True):
                opt = SSMNaturalGradient(gamma=GAMMA, momentum=mom, naturals_engine=engine)
                step = opt.make_step(lambda s: vgp.with_dist_q(s).loss())
                ssm, state = vgp.dist_q.non_trainable_copy(), None
                state = opt.init(ssm)
                for i in range(STEPS):
                    ssm, state, loss = step(ssm, state)
                    tag = f"{engine}/{mom}/{i}"
                    out[f"{tag}/loss"] = np.array(loss)
                    for f, v in zip(FIELDS, fields(ssm)):
                        out[f"{tag}/{f}"] = v
    else:
        x, y, z = svgp_data()
        data = (jnp.asarray(x), jnp.asarray(y))
        svgp = SparseVariationalGaussianProcess(
            kernel(), jl.Gaussian(variance=NOISE_VARIANCE), jnp.asarray(z), num_data=2 * N)
        out["elbo0"] = np.array(svgp.elbo(data))
        for engine in ENGINES:
            opt = SSMNaturalGradient(gamma=GAMMA, naturals_engine=engine)
            step = jax.jit(functools.partial(
                opt.step, lambda s: svgp.with_dist_q(s).loss(data)))
            ssm, _, loss = step(svgp.dist_q.non_trainable_copy())
            out[f"{engine}/loss"] = np.array(loss)
            out[f"{engine}/elbo"] = np.array(svgp.with_dist_q(ssm).elbo(data))
            for f, v in zip(FIELDS, fields(ssm)):
                out[f"{engine}/{f}"] = v
        # a random SSM's precision and normalizer (the port's tests rebuild
        # it from _ssm_cases.ssm_arrays)
        sys.path.insert(0, HERE)
        from _ssm_cases import ssm_arrays

        ssm = StateSpaceModel(*(jnp.asarray(a) for a in ssm_arrays(2, (2,), 5)))
        prec = ssm.precision()
        out["precision/diag"] = np.array(prec.diag)
        out["precision/lower"] = np.array(prec.lower)
        out["normalizer"] = np.array(ssm.normalizer)
        xv, yv = vgp_data()
        nat1, nat2 = cvi_sites()
        cvi = CVIGaussianProcess((jnp.asarray(xv), jnp.asarray(yv)), kernel(),
                                 jl.Bernoulli(), sites=UnivariateGaussianSitesNat(
                                     jnp.asarray(nat1), jnp.asarray(nat2)))
        for f, v in zip(FIELDS, fields(cvi.dist_q_naturals)):
            out[f"dist_q_naturals/{f}"] = v
        for f, v in zip(FIELDS, fields(cvi.dist_q)):
            out[f"dist_q/{f}"] = v
    np.savez(out_path, **out)


def run_refs(tmp_dir) -> dict:
    """Run :func:`main` on each group in its own fresh process, all at
    once, and merge their outputs under ``GROUP/``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for group in GROUPS:
        out = os.path.join(str(tmp_dir), f"natgrad_refs_{group}.npz")
        procs.append((group, out, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_natgrad_refs.py"), out, group],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    refs = {}
    for group, out, proc in procs:
        log, _ = proc.communicate(timeout=1200)
        assert proc.returncode == 0, f"natgrad reference process failed:\n{log[-4000:]}"
        with np.load(out) as z:
            refs.update({f"{group}/{k}": z[k] for k in z.files})
    return refs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
