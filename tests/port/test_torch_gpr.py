"""The port's GPR serving slice against the JAX package's GPR (float64, CPU).

Both models are built from one numpy seed; the port's through
``convert.gpr_from_numpy`` from the JAX model's parameters.  On the CPU the
JAX package runs its XLA scans, whose agreement with its Pallas kernels its
own interpret-mode tests pin.  Each JAX reference is one jitted program,
computed once per module.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import markovflow_tpu.kernels as jk  # noqa: E402
from markovflow_tpu.models import GaussianProcessRegression as JGPR  # noqa: E402
from markovflow_tpu.utils import filtered_value_and_grad  # noqa: E402
from markovflow_tpu.utils.checks import is_uniform_grid as j_is_uniform  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402
from markovflow_tpu_torch.utils.checks import is_uniform_grid  # noqa: E402

N = 500
LOGLIK_RTOL = 1e-10     # sums of N terms, same algorithm, other bracketing
MARGINALS_ATOL = 1e-10
GRAD_RTOL = 1e-8        # both the Koopman score, in other bracketings

# name -> (kernel, lengthscale, variance, batch shape, uniform grid);
# "flagship" is the model of __graft_entry__.py.  A kernel given as a tuple
# of names is the Sum of those kernels, with one lengthscale and variance
# each: "d9" is the composite model of bench.py's d9 config (state dim 9).
D9 = (("Matern52",) * 3, (0.5, 2.0, 8.0), (1.0, 0.5, 0.25))
CONFIGS = {
    "flagship": ("Matern32", 0.5, 1.0, (), True),
    "matern12_batch2": ("Matern12", 0.7, 1.3, (2,), True),
    "matern52_random_grid": ("Matern52", 0.9, 0.8, (), False),
    "d9": D9 + ((), True),
    "d9_random_grid": D9 + ((), False),
}

_SERVE = jax.jit(lambda m: (m.log_likelihood(), m.loss(),
                            m.kalman.posterior_marginals(engine="pallas")))


def _data(seed, batch, uniform):
    rng = np.random.default_rng(seed)
    if uniform:   # each row its own uniform grid (its own dt)
        rows = 1.0 + np.arange(int(np.prod(batch))).reshape(batch + (1,))
        x = np.linspace(0.0, 10.0, N) * rows
    else:
        x = np.sort(rng.random(batch + (N,)) * 10.0, axis=-1)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(x.shape))[..., None]
    return x, y


def _children(name):
    """[(JAX kernel path, kernel name, port kernel of the port model)...]."""
    kernel = CONFIGS[name][0]
    if isinstance(kernel, str):
        return [("kernel", kernel, lambda m: m.kernel)]
    return [(f"kernel.kernels[{i}]", k, lambda m, i=i: m.kernel.kernels[i])
            for i, k in enumerate(kernel)]


def _pair(name):
    kernel, ell, var, batch, uniform = CONFIGS[name]
    x, y = _data(sorted(CONFIGS).index(name), batch, uniform)
    if isinstance(kernel, str):
        j_kernel = getattr(jk, kernel)(lengthscale=ell, variance=var)
        j_children = [j_kernel]
    else:
        j_children = [getattr(jk, k)(lengthscale=e, variance=v)
                      for k, e, v in zip(kernel, ell, var)]
        j_kernel = jk.Sum(j_children)
    jax_m = JGPR(input_data=(x, jnp.asarray(y)), kernel=j_kernel,
                 chol_obs_covariance=jnp.asarray([[0.2]]))
    params = {"chol_obs_covariance": np.array(jax_m.chol_obs_covariance)}
    for (path, _, _), child in zip(_children(name), j_children):
        for p in ("lengthscale", "variance"):
            params[f"{path}.{p}"] = np.array(getattr(child, p).unconstrained)
    port_m = gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64,
                            kernel=kernel)
    return jax_m, port_m


@pytest.fixture(scope="module")
def served():
    """name -> (JAX results, port results) of loglik, loss and marginals."""
    out = {}
    for name in CONFIGS:
        jax_m, port_m = _pair(name)
        assert port_m._uniform_grid == jax_m._uniform_grid == CONFIGS[name][4]
        ll, loss, (means, covs) = _SERVE(jax_m)
        with torch.no_grad():
            got = (port_m.log_likelihood(), port_m.loss(),
                   *port_m.kalman.posterior_marginals())
        out[name] = ([np.array(v) for v in (ll, loss, means, covs)],
                     [v.numpy() for v in got])
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_likelihood_and_loss_match_jax(served, name):
    want, got = served[name]
    np.testing.assert_allclose(got[0], want[0], rtol=LOGLIK_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_posterior_marginals_match_jax(served, name):
    want, got = served[name]
    for g, w in zip(got[2:], want[2:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=MARGINALS_ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cpu_gradients_match_jax(name):
    """On CPU tensors the loss's Koopman backward (the plain versions of the
    kernels) gives the JAX package's gradients, on both grids and for a
    batch of series; at d = 9 on a uniform grid through the materialised
    general route on both sides."""
    jax_m, port_m = _pair(name)
    grad_fn = lambda m: filtered_value_and_grad(lambda mm: jnp.sum(mm.loss()), m)
    # The Sum's gradient does not go under one jit: XLA:CPU's compile of
    # that program outruns 15 minutes at d = 9, while its jitted pieces take
    # about a minute in all
    _, grads = (grad_fn if isinstance(CONFIGS[name][0], tuple)
                else jax.jit(grad_fn))(jax_m)
    port_m.loss().sum().backward()
    for i, (path, _, port_child) in enumerate(_children(name)):
        j_child = grads.kernel if path == "kernel" else grads.kernel.kernels[i]
        for key in ("lengthscale", "variance"):
            want = np.array(getattr(j_child, key).unconstrained)
            got = getattr(port_child(port_m), key).unconstrained.grad.numpy()
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       err_msg=f"{path}.{key}")


def test_uniform_detection_matches_jax():
    rng = np.random.default_rng(6)
    grids = [np.linspace(0.0, 1.0, 100),
             np.linspace(0.0, 1000.0, 10_000, dtype=np.float32),
             np.cumsum(rng.random(50)),
             np.asarray([0.0, 1.0]),
             np.asarray([0.0, 0.0, 0.0]),
             np.stack([np.linspace(0, 1, 64), np.linspace(0, 2, 64)]),
             np.linspace(0.0, 1.0, 100) + 1e-9 * rng.standard_normal(100)]
    for tp in grids:
        assert is_uniform_grid(tp) == j_is_uniform(tp), tp[:4]


def test_bad_inputs_raise():
    x, y = _data(7, (), True)
    params = {"chol_obs_covariance": np.eye(1)}
    with pytest.raises(ValueError):       # unsorted time points
        gpr_from_numpy(params, x[::-1], y, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):       # observations of the wrong length
        gpr_from_numpy(params, x, y[:-1], device="cpu", dtype=torch.float64)
