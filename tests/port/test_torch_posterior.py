"""The port's GPR posterior against the JAX package's (float64, CPU): the
posterior state-space model on a uniform and a jittered grid, predict_f
and predict_y at inner points, exact hits and points past either end, for
Matern12/32/52 and a Sum, with each of the four mean functions; the sparse
filter's ``condense``; sample_f's moments; and predict_f against a dense
GP in numpy.

Both models are built from one numpy seed, the port's through
``convert.gpr_from_numpy``.  Each JAX reference is one jitted program per
configuration.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import markovflow_tpu.kernels as jk  # noqa: E402
import markovflow_tpu.mean_function as jmf  # noqa: E402
from markovflow_tpu import kalman_filter as jkf  # noqa: E402
from markovflow_tpu.emission_model import EmissionModel as JEmission  # noqa: E402
from markovflow_tpu.models import GaussianProcessRegression as JGPR  # noqa: E402
from markovflow_tpu_torch import kalman_filter as tkf  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402
from tests.tools.dense_gp import dense_posterior  # noqa: E402
from _ssm_cases import RTOL, _close, _t, kernel_pair  # noqa: E402

N = 64
#: name -> (kernel names, uniform grid, mean function)
CONFIGS = {
    "flagship_uniform": (("Matern32",), True, None),
    "matern32_jittered_linear": (("Matern32",), False, "Linear"),
    "matern12_jittered_step": (("Matern12",), False, "Step"),
    "matern52_uniform_impulse": (("Matern52",), True, "Impulse"),
    "sum_jittered_zero": (("Matern12", "Matern32"), False, "Zero"),
}


def grid(uniform, rng):
    if uniform:
        return np.linspace(0.0, 10.0, N)
    return np.linspace(0.0, 10.0, N) + 0.4 * (10.0 / (N - 1)) * rng.uniform(-1, 1, N)


def new_points(x, rng):
    """Inner points, exact hits at the first, an inner and the last point,
    and points past either end, near and far."""
    return np.concatenate([[-1e4, -2.0, x[0] - 1e-3], x[[0, 31, N - 1]],
                           rng.random(20) * 10.0, [x[-1] + 1e-3, 13.0, 1e4]])


def _jax_mean(kind, jkern, d, rng):
    """The JAX mean function and its numpy parameters under the model's
    attribute paths."""
    if kind is None:
        return None, {}
    if kind == "Zero":
        return jmf.ZeroMeanFunction(), {}
    if kind == "Linear":
        return jmf.LinearMeanFunction(0.3), {"mean_function.coefficient": 0.3}
    # M = d action times: the JAX StepMeanFunction takes no other M
    times = np.sort(rng.random(d) * 8.0 + 1.0)
    u = rng.standard_normal(times.shape + (d,))
    cls = {"Impulse": jmf.ImpulseMeanFunction, "Step": jmf.StepMeanFunction}[kind]
    return cls(times, u, jkern), {"mean_function.action_times": times,
                                  "mean_function.state_perturbations": u}


def pair(name):
    names, uniform, mean = CONFIGS[name]
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    jkern, tkern = kernel_pair(names)
    x = grid(uniform, rng)
    y = (np.sin(2.0 * x) + 0.2 * rng.standard_normal(N))[:, None]
    jmean, mparams = _jax_mean(mean, jkern, tkern.state_dim, rng)
    jm = JGPR(input_data=(x, jnp.asarray(y)), kernel=jkern,
              chol_obs_covariance=jnp.asarray([[0.2]]), mean_function=jmean)
    params = {"chol_obs_covariance": np.array([[0.2]]), **mparams}
    children = [jkern] if len(names) == 1 else jkern.kernels
    for i, child in enumerate(children):
        path = "kernel" if len(names) == 1 else f"kernel.kernels[{i}]"
        for p in ("lengthscale", "variance"):
            params[f"{path}.{p}"] = np.array(getattr(child, p).unconstrained)
    pm = gpr_from_numpy(params, x, y, dtype=torch.float64, device="cpu",
                        kernel=names[0] if len(names) == 1 else names,
                        mean_function=mean)
    assert pm._uniform_grid == jm._uniform_grid == uniform
    return jm, pm, x, y, new_points(x, rng)


def _jax_outputs(model, xs):
    post = model.posterior
    d = post.dist
    return {"ssm": (d.initial_mean, d.initial_covariance, d.state_transitions,
                    d.state_offsets, d.process_covariances,
                    d.cholesky_process_covariances),
            "f": post.predict_f(xs), "y": post.predict_y(xs), "loss": model.loss()}


_JAX = jax.jit(_jax_outputs)
SSM_FIELDS = ("initial_mean", "initial_covariance", "state_transitions",
              "state_offsets", "process_covariances", "cholesky_process_covariances")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    jm, pm, x, y, xs = pair(request.param)
    want = _JAX(jm, jnp.asarray(xs))
    with torch.no_grad():
        post = pm.posterior
        got = {"ssm": tuple(getattr(post.dist, f) for f in SSM_FIELDS),
               "f": post.predict_f(_t(xs)), "y": post.predict_y(_t(xs)),
               "loss": pm.loss(), "model_f": pm.predict_f(_t(xs))}
    return got, want, pm, x, y, xs


def test_posterior_state_space_model_matches_jax(served):
    got, want = served[:2]
    for field, g, w in zip(SSM_FIELDS, got["ssm"], want["ssm"]):
        _close(g, w)


def test_predict_f_and_predict_y_match_jax(served):
    """Where the JAX value is finite.  The JAX impulse and step mean
    functions return NaN far before their first action time (A(t - t_0)
    overflows there and multiplies a zero state); the port returns 0 for
    the mean function there (ROADMAP queue 3)."""
    got, want, pm, _, _, xs = served
    mf = pm.mean_function
    before = (xs < float(mf.action_times[0])) if hasattr(mf, "action_times") \
        else np.zeros(xs.shape, bool)
    for g, w in [*zip(got["f"], want["f"]), *zip(got["y"], want["y"]),
                 *zip(got["model_f"], want["f"])]:
        w = np.array(w)
        bad = ~np.isfinite(w).all(-1)
        assert np.all(before[bad]) and torch.isfinite(g).all()
        _close(g[~bad], w[~bad])


def test_loss_with_the_mean_function_matches_jax(served):
    got, want = served[:2]
    _close(got["loss"], want["loss"], atol=0, rtol=RTOL)


def test_predictions_are_finite_and_revert_to_the_prior_far_away(served):
    """At +/-1e4 the variance of f is the prior's (the verify skill's far
    extrapolation probe), and at exact hits it is below the prior's."""
    got, _, pm, x, _, xs = served
    mean, var = got["f"]
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    with torch.no_grad():
        prior_var = float(sum(k.variance.value for k in
                              getattr(pm.kernel, "kernels", [pm.kernel])))
    np.testing.assert_allclose(var[[0, -1], 0].numpy(), prior_var, rtol=1e-10)
    assert bool((var[3:6, 0] < 0.1 * prior_var).all())


def test_predict_f_matches_a_dense_gp(served):
    """predict_f and its full covariance against the dense O(N^3) GP in
    numpy (tests/tools/dense_gp.py), with the model's mean function."""
    got, _, pm, x, y, xs = served
    kerns = [(type(k).__name__, k.lengthscale.value.item(), k.variance.value.item())
             for k in getattr(pm.kernel, "kernels", [pm.kernel])]
    mfn = None
    if pm.mean_function is not None:
        mfn = lambda t: pm.mean_function(_t(t)).detach().numpy()[:, 0]  # noqa: E731
    inner = slice(1, -1)      # the dense Gram is singular across 1e4
    mean, cov, _ = dense_posterior(kerns, 0.04, x, y[:, 0], xs[inner], mfn)
    _close(got["f"][0][inner, 0], mean, atol=1e-8)
    _close(got["f"][1][inner, 0], np.diag(cov), atol=1e-8)
    with torch.no_grad():
        full = pm.posterior.predict_f(_t(xs[inner]), full_output_cov=True)[1]
    _close(full[:, 0, 0], np.diag(cov), atol=1e-8)


def test_sample_f_moments_match_predict_f():
    """sample_f's mean and variance over 4,000 draws from a seeded
    generator lie within 5 standard errors of predict_f's, and the same
    seed gives the same draws."""
    _, pm, x, _, xs = pair("flagship_uniform")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        post = pm.posterior
        draws = post.sample_f(_t(xs), 4000, generator=g)[..., 0]
        again = post.sample_f(_t(xs), 4000, generator=torch.Generator().manual_seed(0))
        mean, var = (v[:, 0] for v in post.predict_f(_t(xs)))
    assert draws.shape == (4000, xs.size) and torch.equal(again[..., 0], draws)
    se = torch.sqrt(var / 4000)
    assert bool(((draws.mean(0) - mean).abs() <= 5 * se + 1e-12).all())
    se_var = var * np.sqrt(2.0 / 3999)
    assert bool(((draws.var(0) - var).abs() <= 5 * se_var + 1e-12).all())


# ---------------------------------------------------------------------------
# condense
# ---------------------------------------------------------------------------
def _sparse_pair(uniform):
    """The same sparse-site filter in both packages: the flagship's kernel
    on N grid points with sites at 40% of them (the first and last
    observed on the jittered grid, neither on the uniform one)."""
    rng = np.random.default_rng(11 + uniform)
    jkern, tkern = kernel_pair(("Matern32",))
    x = grid(uniform, rng)
    inner = np.sort(rng.choice(np.arange(1, N - 1), int(0.4 * N) - 2, replace=False))
    idx = inner if uniform else np.concatenate([[0], inner, [N - 1]])
    nat1 = rng.standard_normal((idx.size, 1)) / 0.04
    nat2 = np.full((idx.size, 1, 1), -0.5 / 0.04)
    h = np.broadcast_to(np.eye(1, 2), (N, 1, 2))
    jf = jkf.KalmanFilterWithSparseSites(
        jkern.state_space_model(x), JEmission(jnp.asarray(h)),
        jkf.UnivariateGaussianSitesNat(jnp.asarray(nat1), jnp.asarray(nat2)), N,
        jnp.asarray(idx), None)
    tp = _t(x)
    prior = ({"prior_const_tl": tkern.prior_const_tl(tp[1:2] - tp[:1])} if uniform
             else {"prior_tl": tkern.prior_arrays_tl(tp)})
    tf = tkf.KalmanFilterWithSparseSites(
        tkern.generate_emission_model(tp),
        tkf.UnivariateGaussianSitesNat(_t(nat1), _t(nat2)), N, torch.as_tensor(idx),
        None, **prior)
    return jf, tf


_JAX_CONDENSE = jax.jit(lambda f: (f.log_likelihood(), f.condense().prior_tl,
                                   f.condense().log_likelihood()))


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "jittered"])
def test_condense_matches_jax_and_the_grid_filter(uniform):
    jf, tf = _sparse_pair(uniform)
    j_ll, j_prior, j_cll = _JAX_CONDENSE(jf)
    with torch.no_grad():
        cf = tf.condense()
        for g, w in zip(cf.prior_tl, j_prior):
            _close(g, w)
        grid_ll, cond_ll = tf.log_likelihood(), cf.log_likelihood()
        _close(cond_ll, j_cll, atol=0, rtol=RTOL)
        _close(cond_ll, grid_ll, atol=0, rtol=RTOL)
        _close(grid_ll, j_ll, atol=0, rtol=RTOL)
        # the condensed filter's posterior lives on the observed points
        post = cf.posterior_state_space_model()
        m_s, _ = tf.posterior_marginals()
    idx = tf.observations_index
    _close(post.marginal_means, m_s[idx])


def test_posterior_moments_are_the_smoothers(served):
    """The posterior SSM carries the smoother's moments, which predict_f
    reads; at these sizes the reference's rebuild from the factors (the
    affine covariance scan) gives the same covariances."""
    _, _, pm, _, _, _ = served
    with torch.no_grad():
        dist = pm.posterior.dist
        m_s, p_s = pm.kalman.posterior_marginals()
        means, covs = dist.marginals
        _, rebuilt = dist.rebuilt_marginals_tl()
        sub = dist.subsequent_covariances()
        sub_rebuilt = dist.subsequent_covariances(covs)
    _close(means, m_s, atol=1e-15)
    _close(covs, p_s, atol=1e-15)
    _close(rebuilt.movedim(-1, -3), p_s)
    _close(sub, sub_rebuilt)


def test_posterior_takes_output_dim_one_only():
    """Its likelihood: a Gaussian of the noise variance at output dim 1, a
    MultivariateGaussian of the noise Cholesky above it (multi-output GPR,
    test_torch_multi_output.py holds its predictions against the JAX
    package's)."""
    from markovflow_tpu_torch.likelihoods import Gaussian, MultivariateGaussian

    x = np.linspace(0.0, 1.0, 8)
    params = {"kernel.kernels[0].lengthscale": np.asarray(0.0),
              "kernel.kernels[1].lengthscale": np.asarray(0.0),
              "chol_obs_covariance": np.eye(2) * 0.2}
    model = gpr_from_numpy(params, x, np.zeros((8, 2)), dtype=torch.float64, device="cpu",
                           kernel=("IndependentMultiOutput", ("Matern32", "Matern12")))
    lik = model.posterior.likelihood
    assert isinstance(lik, MultivariateGaussian)
    np.testing.assert_array_equal(lik.chol_covariance.value.detach().numpy(), np.eye(2) * 0.2)
    params["chol_obs_covariance"] = np.eye(1) * 0.2
    single = gpr_from_numpy(params, x, np.zeros((8, 1)), dtype=torch.float64, device="cpu",
                            kernel=("Sum", ("Matern32", "Matern12")))
    assert isinstance(single.posterior.likelihood, Gaussian)


def test_new_constructors_default_to_the_card():
    import inspect

    from markovflow_tpu_torch.likelihoods import Gaussian
    from markovflow_tpu_torch.mean_function import LinearMeanFunction

    for fn in (Gaussian.__init__, LinearMeanFunction.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_gaussian_likelihood_and_gauss_hermite_match_jax():
    from markovflow_tpu.likelihoods import Gaussian as JGaussian
    from markovflow_tpu.likelihoods import gauss_hermite as j_gh
    from markovflow_tpu_torch.likelihoods import Gaussian, gauss_hermite

    rng = np.random.default_rng(9)
    f, fv, y = (rng.standard_normal((3, 7, 1)), rng.random((3, 7, 1)) + 0.1,
                rng.standard_normal((3, 7, 1)))
    jl, tl = JGaussian(variance=0.3), Gaussian(0.3, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        _close(tl.log_probability_density(_t(f), _t(y)), jl.log_probability_density(f, y))
        _close(tl.variational_expectations(_t(f), _t(fv), _t(y)),
               jl.variational_expectations(f, fv, y))
        _close(tl.predict_density(_t(f), _t(fv), _t(y)), jl.predict_density(f, fv, y))
        for g, w in zip(tl.predict_mean_and_var(_t(f), _t(fv)),
                        jl.predict_mean_and_var(f, fv)):
            _close(g, w)
        # E[exp(f)] by quadrature on both sides
        _close(gauss_hermite(torch.exp, _t(f), _t(fv)),
               j_gh(jnp.exp, jnp.asarray(f), jnp.asarray(fv)))
