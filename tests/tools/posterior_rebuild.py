"""The posterior state-space model's covariances rebuilt from its factors
against the smoother's, in the JAX package and in the port, on the CPU in
float64: the d9 model (a Sum of three Matern52) on the jittered grid
linspace(0, 100, T) (each point moved by up to 0.4 of the spacing).

    PYTHONPATH=. python tests/tools/posterior_rebuild.py 10000 100000

Prints, for each T, max |rebuilt - smoother| / max |smoother| of the
marginal covariances for both packages (about a minute at T = 1e5).
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import markovflow_tpu.kernels as jk  # noqa: E402
from markovflow_tpu.models import GaussianProcessRegression as JGPR  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402

D9 = ((0.5, 1.0), (2.0, 0.5), (8.0, 0.25))


def main(sizes):
    for n in sizes:
        x = np.linspace(0.0, 100.0, n)
        x = x + 0.4 * (100.0 / (n - 1)) * np.random.default_rng(0).uniform(-1.0, 1.0, n)
        y = (np.sin(2.0 * x) + 0.2 * np.random.default_rng(0).standard_normal(n))[:, None]
        kids = [jk.Matern52(lengthscale=ell, variance=var) for ell, var in D9]
        jm = JGPR(input_data=(x, jnp.asarray(y)), kernel=jk.Sum(kids),
                  chol_obs_covariance=jnp.asarray([[0.2]]))

        def covs(m):
            return (m.kalman.posterior_state_space_model().marginal_covariances,
                    m.kalman.posterior_marginals()[1])
        rebuilt, smoothed = (np.array(v) for v in jax.jit(covs)(jm))
        params = {"chol_obs_covariance": np.asarray([[0.2]])}
        for i, kid in enumerate(kids):
            for p in ("lengthscale", "variance"):
                params[f"kernel.kernels[{i}].{p}"] = np.array(getattr(kid, p).unconstrained)
        pm = gpr_from_numpy(params, x, y, dtype=torch.float64, device="cpu",
                            kernel=("Matern52",) * 3)
        with torch.no_grad():
            dist = pm.kalman.posterior_state_space_model()
            port_rebuilt = dist.rebuilt_marginals_tl()[1].movedim(-1, -3).numpy()
            port_smoothed = dist.marginals_tl()[1].movedim(-1, -3).numpy()
        scale = np.abs(smoothed).max()
        print(f"T = {n}: rebuilt vs smoother covariances, JAX "
              f"{np.abs(rebuilt - smoothed).max() / scale:.3e}, port "
              f"{np.abs(port_rebuilt - port_smoothed).max() / scale:.3e}; the two "
              f"packages' smoother covariances differ by "
              f"{np.abs(port_smoothed - smoothed).max() / scale:.3e}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [10_000, 100_000])
