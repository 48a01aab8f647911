"""The port's SDE tools against the JAX package's (float64, CPU): the
product Gauss-Hermite rule, the drift's expectations and gradient, the
statistical linearisation, the linear drift's conversions, the KL
surrogate (against JAX and against the Ornstein-Uhlenbeck closed form),
the Euler-Maruyama steps fed the JAX normals, the Kalman filter built
from a state-space model, and bench config 5's VI iteration at n = 60.

Inputs come from numpy seeds or, for the simulated path, from the JAX
package's own PRNG, whose normals the port's steps take as a tensor.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu import sde as js  # noqa: E402
from markovflow_tpu.emission_model import EmissionModel as JEmission  # noqa: E402
from markovflow_tpu.kalman_filter import KalmanFilter as JKalmanFilter  # noqa: E402
from markovflow_tpu.state_space_model import StateSpaceModel as JSSM  # noqa: E402
from markovflow_tpu_torch import sde as ts  # noqa: E402
from markovflow_tpu_torch.emission_model import EmissionModel  # noqa: E402
from markovflow_tpu_torch.kalman_filter import KalmanFilter  # noqa: E402
from markovflow_tpu_torch.state_space_model import StateSpaceModel  # noqa: E402
from _ssm_cases import _close, _t, ssm_arrays  # noqa: E402

#: values on their largest entry's scale: the same quadrature rules and
#: closed forms, the same filter and smoother formulas in other bracketings
ATOL = 1e-10
#: KL surrogates and log-likelihoods, relative
RTOL = 1e-10
KW = dict(dtype=torch.float64, device="cpu")
DECAY, Q = 1.7, 0.8
N_VI = 60


def _sdes(name):
    if name == "DoubleWell":
        return js.DoubleWellSDE(q=0.5), ts.DoubleWellSDE(q=0.5, **KW)
    return js.OrnsteinUhlenbeckSDE(decay=DECAY, q=Q), ts.OrnsteinUhlenbeckSDE(DECAY, Q, **KW)


def _path(rng, b, n, d=1):
    mu = rng.standard_normal((b, n, d))
    low = np.tril(0.3 * rng.standard_normal((b, n, d, d)), -1) + np.eye(d) * (
        0.2 + rng.random((b, n, d)))[..., None, :]
    return mu, low @ np.swapaxes(low, -1, -2)


@pytest.mark.parametrize("d, h", [(1, 10), (1, 20), (2, 6)])
def test_mvnquad_matches_jax(d, h):
    rng = np.random.default_rng(d + h)
    mu, cov = (x[0] for x in _path(rng, 1, 30, d))

    def fn(x, xp):
        return xp.concatenate([xp.sin(x), x[..., :1] ** 2 * xp.cos(x[..., -1:])], axis=-1)
    want = js.mvnquad(lambda x: fn(x, jnp), jnp.asarray(mu), jnp.asarray(cov), h=h)
    got = ts.mvnquad(lambda x: torch.cat([torch.sin(x), x[..., :1] ** 2
                                          * torch.cos(x[..., -1:])], -1),
                     _t(mu), _t(cov), h=h)
    _close(got, want, ATOL)


@pytest.mark.parametrize("name", ["DoubleWell", "OrnsteinUhlenbeck"])
def test_drift_expectations_and_gradient_match_jax(name):
    jsde, tsde = _sdes(name)
    mu, cov = _path(np.random.default_rng(1), 2, 25)
    want = jax.jit(lambda mu, cov: (jsde.expected_drift(mu, cov),
                                    jsde.expected_gradient_drift(mu, cov),
                                    jsde.gradient_drift(mu[0]), jsde.diffusion(mu, None)))(
        jnp.asarray(mu), jnp.asarray(cov))
    got = (tsde.expected_drift(_t(mu), _t(cov)), tsde.expected_gradient_drift(_t(mu), _t(cov)),
           tsde.gradient_drift(_t(mu[0])), tsde.diffusion(_t(mu), None))
    for g, w in zip(got, want):
        _close(g, w, ATOL)


SSM_FIELDS = ("initial_mean", "cholesky_initial_covariance", "state_transitions",
              "state_offsets", "cholesky_process_covariances")


@pytest.mark.parametrize("batched", [True, False], ids=["batch1", "unbatched"])
def test_linearize_sde_matches_jax(batched):
    """A*_i = E[f'] dt + I, b*_i = (E[f] - E[f'] E[x]) dt, chol Q = l sqrt(dt)
    on n path points and n + 1 time points; the unbatched path ([n, 1],
    [n, 1, 1]) pads as the JAX function does."""
    jsde, tsde = _sdes("DoubleWell")
    rng = np.random.default_rng(2)
    mu, cov = _path(rng, 1, 40)
    if not batched:
        mu, cov = mu[0], cov[0]
    times = np.sort(rng.uniform(0.0, 4.0, 41))
    init = (np.asarray([[1.0]]), np.asarray([[[0.25]]]))
    want = jax.jit(lambda times, mu, cov, m0, p0: js.linearize_sde(
        jsde, times, js.Gaussian(mu, cov), js.Gaussian(m0, p0)))(
        *(jnp.asarray(x) for x in (times, mu, cov) + init))
    got = ts.linearize_sde(tsde, _t(times), ts.Gaussian(_t(mu), _t(cov)),
                           ts.Gaussian(*(_t(x) for x in init)))
    for field in SSM_FIELDS:
        _close(getattr(got, field), getattr(want, field), ATOL)


def test_linear_drift_round_trip_matches_jax():
    """SSM -> LinearDrift -> SSM, as the JAX package computes it."""
    mu0, l0, a, b, lq = ssm_arrays(1, (), 3)
    times = np.linspace(0.0, 1.2, a.shape[0] + 1)
    dt = float(times[1] - times[0])
    jssm = JSSM(*(jnp.asarray(x) for x in (mu0, l0, a, b, lq)))
    tssm = StateSpaceModel(*(_t(x) for x in (mu0, l0, a, b, lq)))
    jd, td = js.LinearDrift.from_ssm(jssm, dt), ts.LinearDrift.from_ssm(tssm, dt)
    _close(td.A, jd.A, ATOL)
    _close(td.b, jd.b, ATOL)
    q = np.sqrt(Q) * np.ones((a.shape[0], 1, 1))
    want = jd.to_ssm(jnp.asarray(q), jnp.asarray(times), jssm.initial_mean,
                     jssm.cholesky_initial_covariance)
    got = td.to_ssm(_t(q), _t(times), tssm.initial_mean,
                    tssm.cholesky_initial_covariance)
    for field in SSM_FIELDS:
        _close(getattr(got, field), getattr(want, field), ATOL)
    with pytest.raises(ValueError):
        ts.LinearDrift().to_ssm(_t(q), _t(times), tssm.initial_mean,
                                tssm.cholesky_initial_covariance)


@pytest.mark.parametrize("name", ["DoubleWell", "OrnsteinUhlenbeck"])
def test_kl_surrogate_matches_jax(name):
    jsde, tsde = _sdes(name)
    rng = np.random.default_rng(4)
    mu, cov = (x[0] for x in _path(rng, 1, 30))
    a, b = -1.0 + 0.5 * rng.standard_normal((30, 1)), 0.3 * rng.standard_normal((30, 1))
    want = js.squared_drift_difference_along_Gaussian_path(
        jsde, js.LinearDrift(A=jnp.asarray(a), b=jnp.asarray(b)),
        js.Gaussian(jnp.asarray(mu), jnp.asarray(cov)), 0.05)
    got = ts.squared_drift_difference_along_Gaussian_path(
        tsde, ts.LinearDrift(A=_t(a), b=_t(b)), ts.Gaussian(_t(mu), _t(cov)), 0.05)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_kl_surrogate_matches_the_ornstein_uhlenbeck_closed_form():
    """For a linear drift a x against the OU drift -decay x the integrand
    is (a + decay)^2 E[x^2] / q, exact under the quadrature."""
    _, tsde = _sdes("OrnsteinUhlenbeck")
    rng = np.random.default_rng(5)
    n, dt, a_q = 30, 0.05, -2.1
    m = rng.standard_normal((n, 1))
    s = np.abs(rng.standard_normal((n, 1, 1))) + 0.1
    got = ts.squared_drift_difference_along_Gaussian_path(
        tsde, ts.LinearDrift(A=_t(np.full((n, 1), a_q)), b=_t(np.zeros((n, 1)))),
        ts.Gaussian(_t(m), _t(s)), dt)
    e_x2 = m[:, 0] ** 2 + s[:, 0, 0]
    np.testing.assert_allclose(got.item(), 0.5 * np.sum((a_q + DECAY) ** 2 * e_x2 / Q) * dt,
                               rtol=1e-12)


@pytest.mark.parametrize("name", ["DoubleWell", "OrnsteinUhlenbeck"])
def test_euler_maruyama_fed_the_jax_normals_matches_jax(name):
    """The steps of the JAX euler_maruyama with the normals its key draws."""
    jsde, tsde = _sdes(name)
    grid = np.linspace(0.0, 2.0, 81)
    x0 = np.asarray([[1.0], [-0.5], [0.2]])
    key = jax.random.PRNGKey(3)
    want = js.euler_maruyama(jsde, jnp.asarray(x0), jnp.asarray(grid), key)
    normals = jax.random.normal(key, (grid.size - 1,) + x0.shape, jnp.float64)
    got = ts.euler_maruyama_from_normals(tsde, _t(x0), _t(grid), _t(normals))
    _close(got, want, ATOL)


def test_euler_maruyama_draws_from_its_generator():
    _, tsde = _sdes("DoubleWell")
    grid, x0 = torch.linspace(0.0, 1.0, 21, **KW), torch.ones((2, 1), **KW)
    a, b = (ts.euler_maruyama(tsde, x0, grid, torch.Generator().manual_seed(s))
            for s in (0, 0))
    assert a.shape == (2, 21, 1) and torch.equal(a, b) and torch.equal(a[:, 0], x0)
    c = ts.euler_maruyama(tsde, x0, grid, torch.Generator().manual_seed(1))
    assert not torch.equal(a, c)


def test_kalman_filter_of_a_state_space_model_matches_jax():
    """KalmanFilter(prior_tl=ssm.prior_tl()) takes the model's
    (mu0, P0, A, b, Q) as its per-step prior with element 0 the initial
    distribution, as the JAX package's KalmanFilter(ssm, ...) does: the
    prior arrays, the log-likelihood and the posterior's marginals."""
    arrays = ssm_arrays(2, (2,), 6)
    n = arrays[2].shape[-3] + 1
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, n, 1, 2))
    y = rng.standard_normal((2, n, 1))
    chol = np.asarray([[0.3]])
    tssm = StateSpaceModel(*(_t(x) for x in arrays))

    @jax.jit  # one XLA compile, not one per eager op
    def jax_side(arrays, h, y, chol):
        jkf = JKalmanFilter(JSSM(*arrays), JEmission(h), y, chol)
        return (jkf._tl_inputs()[:3], jkf.log_likelihood(),
                jkf.posterior_state_space_model().marginals)
    prior, loglik, marginals = jax_side(tuple(jnp.asarray(x) for x in arrays),
                                        *(jnp.asarray(x) for x in (h, y, chol)))
    tkf = KalmanFilter(EmissionModel(_t(h)), _t(y), _t(chol), prior_tl=tssm.prior_tl())
    for got, want in zip(tkf.prior_tl, prior):
        _close(got, want, ATOL)
    np.testing.assert_allclose(tkf.log_likelihood().numpy(), np.array(loglik), rtol=RTOL)
    for got, w in zip(tkf.posterior_state_space_model().marginals, marginals):
        _close(got, w, ATOL)


def _vi(sde_pkg, sde, kalman, emission, times, dt, obs, tensor):
    """Bench config 5's VI loop (tests/unit/test_sde.py's workflow): four
    iterations of linearisation, the Kalman filter of the linearised prior,
    its posterior SSM and the KL surrogate; the KLs and the paths."""
    n = times.shape[0] - 1
    path = sde_pkg.Gaussian(tensor(np.zeros((1, n, 1))), tensor(np.ones((1, n, 1, 1))))
    init = sde_pkg.Gaussian(tensor(np.asarray([[1.0]])), tensor(np.full((1, 1, 1), 0.25)))
    out = []
    for _ in range(4):
        prior = sde_pkg.linearize_sde(sde, times, path, init)
        post = kalman(prior, emission(tensor(np.ones((1, n + 1, 1, 1)))), obs,
                      tensor(np.asarray([[0.2]]))).posterior_state_space_model()
        means, covs = post.marginals
        drift = sde_pkg.LinearDrift.from_ssm(post, dt)
        kl = sde_pkg.squared_drift_difference_along_Gaussian_path(
            sde, sde_pkg.LinearDrift(A=drift.A[0, :, :, 0], b=drift.b[0]),
            sde_pkg.Gaussian(means[0, 1:], covs[0, 1:]), dt)
        path = sde_pkg.Gaussian(means[..., 1:, :], covs[..., 1:, :, :])
        out.append((kl, path.mu, path.cov))
    return out


def test_vi_iteration_matches_jax():
    """Four VI iterations at n = 60 from the JAX package's simulated truth
    and observations: the KL and the posterior path of each; the KL falls
    from the first iteration to the last."""
    jsde, tsde = _sdes("DoubleWell")
    times = np.linspace(0.0, 3.0, N_VI + 1)
    key = jax.random.PRNGKey(7)
    truth = js.euler_maruyama(jsde, jnp.asarray([[1.0]]), jnp.asarray(times), key)[0]
    obs = np.array(truth + 0.2 * jax.random.normal(jax.random.fold_in(key, 1), truth.shape))[None]

    def jax_kalman(prior, em, y, chol):
        return JKalmanFilter(prior, em, y, chol)

    def port_kalman(prior, em, y, chol):
        return KalmanFilter(em, y, chol, prior_tl=prior.prior_tl())
    dt = float(times[1] - times[0])
    want = jax.jit(lambda t, y: _vi(js, jsde, jax_kalman, JEmission, t, dt, y, jnp.asarray))(
        jnp.asarray(times), jnp.asarray(obs))
    with torch.no_grad():
        got = _vi(ts, tsde, port_kalman, EmissionModel, _t(times), dt, _t(obs), _t)
    for (g_kl, g_mu, g_cov), (w_kl, w_mu, w_cov) in zip(got, want):
        np.testing.assert_allclose(g_kl.item(), float(w_kl), rtol=RTOL)
        _close(g_mu, w_mu, ATOL)
        _close(g_cov, w_cov, ATOL)
    assert got[-1][0] < got[0][0]
