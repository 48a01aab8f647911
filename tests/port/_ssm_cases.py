"""Shared inputs of the port's state-space model, conditionals and
posterior tests: random stable state-space models and the same kernel in
both packages, made from numpy seeds."""
import numpy as np
import torch

import markovflow_tpu.kernels as jk
from markovflow_tpu_torch import kernels as tk

ATOL = 1e-10    # moments, marginals, SSM parameters (on their largest entry's scale)
RTOL = 1e-10    # log-densities and KL
T = 24          # transitions of ssm_arrays' models


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, atol=ATOL, rtol=0.0):
    """got within ``atol`` of want on the scale of want's largest entry
    (absolute where that is at most 1), or within ``rtol`` elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.array(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol)


def _contractions(rng, shape, d):
    a = 0.8 * np.eye(d) + 0.3 * rng.standard_normal(shape + (d, d)) / np.sqrt(d)
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    return a * (0.95 / np.maximum(radius, 0.95))[..., None, None]


def _chols(rng, shape, d):
    low = np.tril(0.3 * rng.standard_normal(shape + (d, d)), -1)
    return low + np.eye(d) * (0.5 + rng.random(shape + (d,)))[..., None, :]


def ssm_arrays(d, batch, seed, n=T):
    """(mu0, chol_P0, A, b, chol_Q) of a random stable SSM of n transitions."""
    rng = np.random.default_rng(seed + 10 * d + len(batch))
    return (rng.standard_normal(batch + (d,)), _chols(rng, batch, d),
            _contractions(rng, batch + (n,), d), 0.1 * rng.standard_normal(batch + (n, d)),
            _chols(rng, batch + (n,), d))


KERNELS = {"Matern12": ("Matern12",), "Matern32": ("Matern32",),
           "Matern52": ("Matern52",), "Sum": ("Matern12", "Matern32")}


def kernel_pair(names, ell=0.7, var=1.3):
    """The same kernel (a Sum for several names) in both packages."""
    js = [getattr(jk, n)(lengthscale=ell * (i + 1), variance=var / (i + 1))
          for i, n in enumerate(names)]
    ts = []
    for n, j in zip(names, js):
        k = getattr(tk, n)(dtype=torch.float64, device="cpu")
        with torch.no_grad():
            for p in ("lengthscale", "variance"):
                getattr(k, p).unconstrained.copy_(_t(getattr(j, p).unconstrained))
        ts.append(k)
    if len(names) == 1:
        return js[0], ts[0]
    return jk.Sum(js), tk.Sum(ts)
