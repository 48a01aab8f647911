"""The port's CVI against the JAX package's (float64, CPU): the sites after
one and after three site updates, the ELBO, its gradients with respect to
the kernel's hyperparameters, the classic ELBO, predict_f and
predict_log_density, for the Gaussian, Bernoulli and Poisson likelihoods
on a uniform and a jittered grid (and Poisson with a linear mean
function); and the ports of
tests/integration/models/test_cvi.py's three checks.

Both models are built from one numpy seed (``_cvi_refs.problem``), the
port's through ``convert.cvi_from_numpy`` with the JAX model's
hyperparameters.  The JAX references are one jitted program per
configuration, run in fresh processes (``_cvi_refs.run_refs``).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu.models import variational_cvi as jcvi  # noqa: E402
from markovflow_tpu_torch.convert import cvi_from_numpy, gpr_from_numpy  # noqa: E402
from markovflow_tpu_torch.kalman_filter import UnivariateGaussianSitesNat  # noqa: E402
from markovflow_tpu_torch.models import variational_cvi as tcvi  # noqa: E402
from markovflow_tpu_torch.utils.bijectors import positive  # noqa: E402
from _cvi_refs import (CONFIGS, COEFFICIENT, LENGTHSCALE, LR, N, NOISE_VARIANCE,  # noqa: E402
                       OUTPUTS, VARIANCE, data, problem, run_refs)
from _ssm_cases import _close, _t  # noqa: E402

#: sites, marginals and predictions (on their largest entry's scale): both
#: packages run the same filter and smoother formulas in other bracketings
ATOL = 1e-10
#: the ELBO and the classic ELBO (sums of N terms), relative.  The classic
#: ELBO's KL reads the smoother's moments in the port and the moments
#: rebuilt from the posterior's factors in the JAX package (ROADMAP queue
#: 3); at these sizes in float64 the two agree to roundoff.
ELBO_RTOL = 1e-10
#: the ELBO's gradients, relative: both the Koopman score
GRAD_RTOL = 1e-8
#: the configurations split over concurrent reference processes
GROUPS = (sorted(CONFIGS)[::2], sorted(CONFIGS)[1::2])


def _params(name, refs=None):
    """The kernel's (and a Gaussian likelihood's) unconstrained values: the
    JAX model's from ``refs``, or by default the port's bijector on the
    same constrained values."""
    keys = ["kernel.lengthscale", "kernel.variance"]
    values = [LENGTHSCALE, VARIANCE]
    if CONFIGS[name][0] == "Gaussian":
        keys.append("likelihood.variance")
        values.append(NOISE_VARIANCE)
    if refs is not None:
        return {k: refs[f"{name}/{k}"] for k in keys}
    return {k: positive().inverse(np.asarray(v)) for k, v in zip(keys, values)}


def _pair(name, refs=None):
    """(the port's model, x_new, y_new) of a configuration; its grid is
    detected as the JAX model's was."""
    likelihood, uniform, mean = CONFIGS[name]
    x, y, x_new, y_new = problem(name)
    params = _params(name, refs)
    if mean is not None:
        params["mean_function.coefficient"] = COEFFICIENT
    pm = cvi_from_numpy(params, x, y, dtype=torch.float64, device="cpu",
                        likelihood=likelihood, learning_rate=LR, mean_function=mean)
    assert pm._uniform_grid == uniform
    if refs is not None:
        assert pm._uniform_grid == bool(refs[f"{name}/uniform_grid"])
    return pm, x_new, y_new


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("cvi_refs"), GROUPS)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request, refs):
    name = request.param
    pm, x_new, y_new = _pair(name, refs)
    want = {key: tuple(refs[f"{name}/{key}/{i}"] for i in range(count))
            for key, count in OUTPUTS.items()}
    got = {"sites1": tuple(x.clone() for x in (pm.update_sites().sites.nat1,
                                               pm.sites.nat2))}
    pm.update_sites().update_sites()
    got["sites3"] = (pm.sites.nat1, pm.sites.nat2)
    elbo = pm.elbo()
    elbo.backward()
    got.update(elbo=(elbo.detach(),), grads=(pm.kernel.lengthscale.unconstrained.grad,
                                             pm.kernel.variance.unconstrained.grad))
    with torch.no_grad():
        got.update(classic_elbo=(pm.classic_elbo(),), predict_f=pm.predict_f(_t(x_new)),
                   predict_log_density=(pm.predict_log_density((_t(x_new), _t(y_new))),))
    return got, want, pm


@pytest.mark.parametrize("key", ["sites1", "sites3", "predict_f", "predict_log_density"])
def test_cvi_matches_jax(run, key):
    got, want, _ = run
    for g, w in zip(got[key], want[key]):
        _close(g, w, ATOL)


@pytest.mark.parametrize("key", ["elbo", "classic_elbo"])
def test_cvi_elbos_match_jax(run, key):
    got, want, _ = run
    np.testing.assert_allclose(got[key][0].item(), float(want[key][0]), rtol=ELBO_RTOL)


def test_cvi_gradients_match_jax(run):
    """The kernel's gradients; the likelihood's variance has no path into
    the site model's ELBO: JAX gives it 0, torch None."""
    got, want, pm = run
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g.numpy(), np.array(w), rtol=GRAD_RTOL)
    if hasattr(pm.likelihood, "variance"):
        assert pm.likelihood.variance.unconstrained.grad is None


def test_sites_are_detached_tensors_after_an_update():
    """update_sites writes detached tensors: no graph of the marginals is
    kept, and the ELBO's backward asks for no site gradient."""
    pm, _, _ = _pair("poisson_jittered")
    pm.update_sites()
    assert not pm.sites.nat1.requires_grad and not pm.sites.nat2.requires_grad
    assert pm.sites.nat1.grad_fn is None and pm.sites.nat2.grad_fn is None
    pm.loss().backward()
    assert pm.kernel.lengthscale.unconstrained.grad is not None


def test_back_project_nats_and_the_gradient_transformation_match_jax():
    rng = np.random.default_rng(5)
    nat1, nat2 = rng.standard_normal((7, 1)), -rng.random((7, 1))
    h = rng.standard_normal((7, 1, 3))
    want = jcvi.back_project_nats(jnp.asarray(nat1), jnp.asarray(nat2), jnp.asarray(h))
    got = tcvi.back_project_nats(_t(nat1), _t(nat2), _t(h))
    for g, w in zip(got, want):
        _close(g, w, ATOL)
    mu, g_mu, g_var = (rng.standard_normal((7, 1)) for _ in range(3))
    want = jcvi.gradient_transformation_mean_var_to_expectation(
        (jnp.asarray(mu), None), (jnp.asarray(g_mu), jnp.asarray(g_var)))
    got = tcvi.gradient_transformation_mean_var_to_expectation(
        (_t(mu), None), (_t(g_mu), _t(g_var)))
    for g, w in zip(got, want):
        _close(g, w, ATOL)


def test_initial_sites_are_the_jax_packages():
    pm, _, _ = _pair("gaussian_uniform")
    assert torch.equal(pm.sites.nat1, torch.zeros((N, 1), dtype=torch.float64))
    assert torch.equal(pm.sites.nat2, torch.full((N, 1, 1), -1e-10, dtype=torch.float64))


def test_cvi_starts_from_given_sites():
    rng = np.random.default_rng(3)
    x, y = data("Gaussian", True, rng)
    nat1, nat2 = rng.standard_normal((N, 1)), -0.5 - rng.random((N, 1, 1))
    pm = cvi_from_numpy({"sites.nat1": nat1, "sites.nat2": nat2}, x, y,
                        dtype=torch.float64, device="cpu")
    assert isinstance(pm.sites, UnivariateGaussianSitesNat)
    np.testing.assert_array_equal(pm.sites.nat1.numpy(), nat1)
    np.testing.assert_array_equal(pm.sites.nat2.numpy(), nat2)


def test_what_is_not_ported_raises():
    pm, _, _ = _pair("gaussian_uniform")
    with pytest.raises(NotImplementedError, match="item 6"):
        pm.dist_q_naturals
    x, y = data("Gaussian", True, np.random.default_rng(0))
    for kw in ({"grad_engine": "autodiff"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="item 9"):
            tcvi.CVIGaussianProcess((x, _t(y)), pm.kernel, pm.likelihood, **kw)


# ---------------------------------------------------------------------------
# tests/integration/models/test_cvi.py, ported
# ---------------------------------------------------------------------------
NOISE = 0.3


def _gaussian_cvi_and_gpr(uniform):
    rng = np.random.default_rng(11)
    x = np.linspace(0.0, 5.0, 40) if uniform else np.sort(rng.uniform(0.0, 5.0, 40))
    y = (np.sin(2.0 * x) + 0.1 * rng.standard_normal(x.size))[:, None]
    params = {"kernel.lengthscale": positive().inverse(0.7),
              "kernel.variance": positive().inverse(1.2),
              "likelihood.variance": positive().inverse(NOISE ** 2),
              "chol_obs_covariance": np.asarray([[NOISE]])}
    cvi = cvi_from_numpy(params, x, y, dtype=torch.float64, device="cpu", learning_rate=1.0)
    gpr = gpr_from_numpy(params, x, y, dtype=torch.float64, device="cpu")
    assert cvi._uniform_grid == gpr._uniform_grid == uniform
    return cvi, gpr


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "jittered"])
def test_cvi_gaussian_converges_to_gpr(uniform):
    """A Gaussian likelihood and learning rate 1: one update puts the exact
    likelihood factors in the sites, which recovers GPR (value and
    posterior at new points; 1e-8 as in the JAX test, here far inside)."""
    cvi, gpr = _gaussian_cvi_and_gpr(uniform)
    cvi.update_sites()
    with torch.no_grad():
        np.testing.assert_allclose(cvi.elbo().item(), gpr.log_likelihood().item(), rtol=1e-10)
        x_new = _t([0.4, 2.3, 4.9, 7.0])
        for c, g in zip(cvi.predict_f(x_new), gpr.predict_f(x_new)):
            np.testing.assert_allclose(c.numpy(), g.numpy(), atol=1e-10)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "jittered"])
def test_cvi_elbo_equals_classic_elbo_at_convergence(uniform):
    """For the Gaussian case at convergence both ELBOs equal log p(y)
    (the JAX test's rtol 1e-7)."""
    cvi, _ = _gaussian_cvi_and_gpr(uniform)
    cvi.update_sites()
    with torch.no_grad():
        np.testing.assert_allclose(cvi.elbo().item(), cvi.classic_elbo().item(), rtol=1e-7)


def test_cvi_poisson_improves():
    """A log-Gaussian Cox process (bench config 4's family): the classic
    ELBO rises by more than 1 over 15 updates and falls by no more than
    1e-6 at any update after the fifth (the JAX test's rule)."""
    rng = np.random.default_rng(4)
    x = np.linspace(0.0, 4.0, 25)
    y = rng.poisson(np.exp(np.sin(2.0 * x))).astype(np.float64)[:, None]
    cvi = cvi_from_numpy({"kernel.lengthscale": positive().inverse(0.8),
                          "kernel.variance": positive().inverse(1.0)}, x, y,
                         dtype=torch.float64, device="cpu", likelihood="Poisson",
                         learning_rate=0.5)
    elbos = [cvi.classic_elbo().item()]
    for _ in range(15):
        elbos.append(cvi.update_sites().classic_elbo().item())
    assert elbos[-1] > elbos[0] + 1.0
    assert np.all(np.diff(elbos[5:]) > -1e-6)


def test_classic_elbo_has_a_cpu_gradient():
    """On the CPU the classic ELBO differentiates through the plain filter
    and smoother (on the card it raises: test_torch_cuda.py)."""
    pm, _, _ = _pair("bernoulli_uniform")
    pm.update_sites()
    pm.classic_elbo().backward()
    assert torch.isfinite(pm.kernel.lengthscale.unconstrained.grad)
