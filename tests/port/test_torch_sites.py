"""The port's Gaussian sites and the Kalman filters with time-varying and
with sparse sites against the JAX package (float64, CPU).

Both packages get the same prior steps (per-step ``prior_tl`` of a general
case, or the constant ``prior_const_tl`` of a uniform case), emission and
site naturals; the JAX filters take the Koopman gradient engine.  The
log-likelihood agrees within 1e-12 relative, its gradients in the prior
steps and the sites' naturals within 1e-8 relative (normwise), and the
filtered moments within 1e-10 absolute.  The sparse filter scatters 70% of
the grid points' sites and masks the rest: on CUDA its gradient runs the
general filter and the general Koopman backward with that mask.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu import kalman_filter as jkf  # noqa: E402
from markovflow_tpu.emission_model import EmissionModel as JEmission  # noqa: E402
from markovflow_tpu.ops.adjoint import _materialize_uniform  # noqa: E402
from markovflow_tpu_torch import kalman_filter as tkf  # noqa: E402
from markovflow_tpu_torch.emission_model import EmissionModel  # noqa: E402

from _pallas_refs import case_inputs, general_inputs  # noqa: E402

VALUE_RTOL = 1e-12
GRAD_RTOL = 1e-8
ATOL = 1e-10


def _problem(name, uniform):
    """(prior arrays: prior_const_tl of a uniform case, prior_tl of a
    general one; the emission [..., N, 1, d]; the site naturals
    nat1 [..., N, 1], nat2 [..., N, 1, 1]) of a case, as numpy arrays."""
    if uniform:
        x = case_inputs(name)
        prior = tuple(x[k] for k in ("fc", "cc", "qc", "mu0", "p0"))
        n = x["nu"].shape[-1]
        h = np.broadcast_to(np.moveaxis(x["hc"], -1, -3), (n,) + x["hc"].shape[:2])
    else:
        x = general_inputs(name)
        prior = tuple(x[k] for k in ("F", "c", "Q"))
        h = np.moveaxis(x["H"], -1, -3)
    nat1 = np.moveaxis(x["nu"][..., 0, :], -1, -2)
    nat2 = -0.5 * np.moveaxis(x["lam"], -1, -3)
    return prior, h, nat1, nat2


def _j_prior(prior, h, uniform, batch):
    """The JAX filter's (prior_tl, prior_const_tl).  The materialised
    prior_tl is broadcast to the sites' batch: the JAX filter_pipeline_tl
    concatenates the prior steps with batched predictions, which
    jnp.concatenate does not broadcast."""
    p = tuple(jnp.asarray(a) for a in prior)
    if not uniform:
        return p, None
    hc = jnp.moveaxis(jnp.asarray(h)[..., :1, :, :], -3, -1)
    tl = _materialize_uniform(*p, hc, h.shape[-3])[:3]
    return tuple(jnp.broadcast_to(x, batch + x.shape[-3:]) for x in tl), p


def _observed(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, int(0.7 * n), replace=False))


def _jax_filter(kind, prior, h, nat1, nat2, uniform, idx):
    prior_tl, prior_const = _j_prior(prior, h, uniform, nat1.shape[:-2])
    sites = jkf.UnivariateGaussianSitesNat(nat1, nat2)
    if kind == "sites":
        return jkf.KalmanFilterWithSites(None, JEmission(jnp.asarray(h)), sites,
                                         prior_tl=prior_tl, prior_const_tl=prior_const)
    f = jkf.KalmanFilterWithSparseSites(None, JEmission(jnp.asarray(h)), sites,
                                        h.shape[-3], jnp.asarray(idx), None)
    f.prior_tl, f.prior_const_tl = prior_tl, prior_const
    return f


def _port_filter(kind, prior, h, nat1, nat2, uniform, idx):
    key = "prior_const_tl" if uniform else "prior_tl"
    sites = tkf.UnivariateGaussianSitesNat(nat1, nat2)
    emission = EmissionModel(torch.from_numpy(np.ascontiguousarray(h)))
    if kind == "sites":
        return tkf.KalmanFilterWithSites(emission, sites, **{key: tuple(prior)})
    return tkf.KalmanFilterWithSparseSites(emission, sites, h.shape[-3],
                                           torch.from_numpy(idx), None,
                                           **{key: tuple(prior)})


CONFIGS = [("sites", "g_d2_n73_masked", False), ("sites", "d3_n73", True),
           ("sparse", "g_d3_n73", False), ("sparse", "g_d2_n73_masked", False),
           ("sparse", "d2_n64_batch3", True)]


@pytest.mark.parametrize("kind,name,uniform", CONFIGS)
def test_site_filter_log_likelihood_and_gradients_match_jax(kind, name, uniform):
    prior, h, nat1, nat2 = _problem(name, uniform)
    idx = _observed(h.shape[-3], len(name))
    if kind == "sparse":
        nat1, nat2 = nat1[..., idx, :], nat2[..., idx, :, :]
    batch = nat1.shape[:-2]
    weights = np.linspace(0.7, -1.3, int(np.prod(batch))).reshape(batch)
    k = len(prior)

    def j_loss(*a):
        f = _jax_filter(kind, a[:k], h, a[k], a[k + 1], uniform, idx)
        return jnp.sum(weights * f.log_likelihood(grad_engine="koopman"))
    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=tuple(range(k + 2))))(
        *(jnp.asarray(a) for a in prior + (nat1, nat2)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in prior + (nat1, nat2)]
    f = _port_filter(kind, t[:k], h, t[k], t[k + 1], uniform, idx)
    t_val = (torch.from_numpy(weights) * f.log_likelihood()).sum()
    t_grads = torch.autograd.grad(t_val, t)
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=VALUE_RTOL)
    for i, (g, w) in enumerate(zip(t_grads, j_grads)):
        w = np.array(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=str(i))


@pytest.mark.parametrize("kind,name,uniform", CONFIGS)
def test_site_filter_forward_filter_matches_jax(kind, name, uniform):
    prior, h, nat1, nat2 = _problem(name, uniform)
    idx = _observed(h.shape[-3], len(name))
    if kind == "sparse":
        nat1, nat2 = nat1[..., idx, :], nat2[..., idx, :, :]
    jf = _jax_filter(kind, prior, h, jnp.asarray(nat1), jnp.asarray(nat2), uniform, idx)
    tf = _port_filter(kind, [torch.from_numpy(a) for a in prior], h,
                      torch.from_numpy(nat1), torch.from_numpy(nat2), uniform, idx)
    for got, want in zip(tf.forward_filter(), jf.forward_filter()):
        want = np.array(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_univariate_sites_match_jax():
    _, _, nat1, nat2 = _problem("g_d2_n73_masked", False)
    j = jkf.UnivariateGaussianSitesNat(jnp.asarray(nat1), jnp.asarray(nat2))
    t = tkf.UnivariateGaussianSitesNat(torch.from_numpy(nat1), torch.from_numpy(nat2))
    for name in ("means", "precisions"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.array(getattr(j, name)),
                                   rtol=1e-15)
    for got, want in zip(t.natural_parameters, j.natural_parameters):
        np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-15)
    assert t.log_norm.shape == nat1.shape
    assert isinstance(t.replace_nats(t.nat1, t.nat2), tkf.UnivariateGaussianSitesNat)
