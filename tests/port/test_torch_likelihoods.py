"""The port's scalar likelihoods against the JAX package's (float64, CPU):
log_probability_density, variational_expectations, predict_density,
predict_mean_and_var and the gradients of the summed variational
expectations with respect to the means and variances of q(f), for the
Gaussian, Bernoulli (probit), Poisson and Student-t likelihoods.

Inputs come from one numpy seed per likelihood; each JAX reference is one
jitted program, computed once per module.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu import likelihoods as jl  # noqa: E402
from markovflow_tpu_torch import likelihoods as tl  # noqa: E402

N = 200
#: values and gradients: the same closed forms or the same 20-node
#: Gauss-Hermite rule, in float64
ATOL = 1e-10
QUANTITIES = ("log_probability_density", "variational_expectations",
              "predict_density", "predict_mean_and_var", "ve_gradients")


def _pair(name):
    """(JAX likelihood, port likelihood, numpy inputs (f, f_means, f_vars, y))."""
    rng = np.random.default_rng(sorted(LIKELIHOODS).index(name))
    f = 1.5 * rng.standard_normal((N, 1))
    means = 1.5 * rng.standard_normal((N, 1))
    variances = 0.05 + rng.random((N, 1))
    y = {"Gaussian": np.sin(means) + 0.3 * rng.standard_normal((N, 1)),
         "Bernoulli": (rng.random((N, 1)) > 0.5).astype(np.float64),
         "Poisson": rng.poisson(np.exp(0.5 * means)).astype(np.float64),
         "StudentT": np.sin(means) + 0.3 * rng.standard_t(3.0, (N, 1))}[name]
    jax_lik, port_lik = LIKELIHOODS[name]()
    return jax_lik, port_lik, (f, means, variances, y)


def _gaussian():
    return jl.Gaussian(variance=0.3), tl.Gaussian(0.3, dtype=torch.float64, device="cpu")


def _student_t():
    return (jl.StudentT(scale=0.4, df=4.0),
            tl.StudentT(0.4, df=4.0, dtype=torch.float64, device="cpu"))


LIKELIHOODS = {"Gaussian": _gaussian,
               "Bernoulli": lambda: (jl.Bernoulli(), tl.Bernoulli()),
               "Poisson": lambda: (jl.Poisson(binsize=1.5), tl.Poisson(binsize=1.5)),
               "StudentT": _student_t}


def _outputs(lik, f, means, variances, y, grad):
    return {"log_probability_density": lik.log_probability_density(f, y),
            "variational_expectations": lik.variational_expectations(means, variances, y),
            "predict_density": lik.predict_density(means, variances, y),
            "predict_mean_and_var": lik.predict_mean_and_var(means, variances),
            "ve_gradients": grad(lik, means, variances, y)}


def _jax_grad(lik, means, variances, y):
    return jax.grad(lambda m, v: jnp.sum(lik.variational_expectations(m, v, y)),
                    argnums=(0, 1))(means, variances)


def _port_grad(lik, means, variances, y):
    m = means.clone().requires_grad_(True)
    v = variances.clone().requires_grad_(True)
    return torch.autograd.grad(lik.variational_expectations(m, v, y).sum(), (m, v))


@pytest.fixture(scope="module", params=sorted(LIKELIHOODS))
def evaluated(request):
    jax_lik, port_lik, inputs = _pair(request.param)
    want = jax.jit(lambda lk, *a: _outputs(lk, *a, grad=_jax_grad))(
        jax_lik, *(jnp.asarray(x) for x in inputs))
    got = _outputs(port_lik, *(torch.as_tensor(x) for x in inputs), grad=_port_grad)
    return got, want


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_likelihood_matches_jax(evaluated, quantity):
    got, want = evaluated
    g, w = _flat(got[quantity]), _flat(want[quantity])
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=ATOL * max(1.0, np.abs(b).max()), rtol=0)


def test_inv_probit_matches_jax_and_keeps_its_jitter():
    x = np.linspace(-40.0, 40.0, 801)
    got = tl.inv_probit(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.array(jl.inv_probit(jnp.asarray(x))), atol=ATOL, rtol=0)
    assert got.min() >= 1e-3 and got.max() <= 1.0 - 1e-3


def test_student_t_scale_is_a_trainable_positive_parameter():
    lik = tl.StudentT(0.4, df=4.0, dtype=torch.float64, device="cpu")
    assert lik.scale.unconstrained.requires_grad
    assert [n for n, _ in lik.named_parameters()] == ["scale.unconstrained"]
    np.testing.assert_allclose(lik.scale.value.item(), 0.4, rtol=1e-12)
