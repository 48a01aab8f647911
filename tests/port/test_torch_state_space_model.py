"""The port's state-space model, affine scans, small linear algebra, the
kernels' state-space models and the mean functions against the JAX
package's (float64, CPU).

Both sides take the same numpy arrays, made from a seed.  Each JAX
reference is one jitted program per configuration.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import markovflow_tpu.mean_function as jmf  # noqa: E402
from markovflow_tpu import state_space_model as jssm  # noqa: E402
from markovflow_tpu.ops import scans as jscans  # noqa: E402
from markovflow_tpu.utils import linalg as jla  # noqa: E402
from markovflow_tpu_torch import mean_function as tmf  # noqa: E402
from markovflow_tpu_torch import state_space_model as tssm  # noqa: E402
from markovflow_tpu_torch.ops import scans as tscans  # noqa: E402
from markovflow_tpu_torch.utils import linalg as tla  # noqa: E402
from _ssm_cases import (ATOL, KERNELS, RTOL, T, _chols, _close,  # noqa: E402
                        _contractions, _t, kernel_pair, ssm_arrays)

CONFIGS = [(d, batch) for d in (1, 2, 3) for batch in ((), (3,))]
IDS = [f"d{d}_batch{len(b)}" for d, b in CONFIGS]


def _jax_outputs(arrays, other, states, key):
    q, p = jssm.StateSpaceModel(*arrays), jssm.StateSpaceModel(*other)
    covs, sub = q.covariance_blocks()
    return {"means": q.marginal_means, "covs": q.marginal_covariances,
            "marginals_tl": q.marginals_tl(), "covs_b": covs, "sub": sub,
            "log_det_precision": q.log_det_precision, "log_pdf": q.log_pdf(states),
            "kl": q.kl_divergence(p), "sample": q.sample(key, (2,)),
            "p0": q.initial_covariance, "q": q.process_covariances}


_JAX_SSM = jax.jit(_jax_outputs)


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def ssm_case(request):
    d, batch = request.param
    arrays, other = ssm_arrays(d, batch, 0), ssm_arrays(d, batch, 1)
    states = np.random.default_rng(d).standard_normal((2,) + batch + (T + 1, d))
    key = jax.random.PRNGKey(d)
    want = _JAX_SSM(arrays, other, states, key)
    eps = np.array(jax.random.normal(key, (2,) + batch + (T + 1, d), dtype=jnp.float64))
    q = tssm.StateSpaceModel(*map(_t, arrays))
    p = tssm.StateSpaceModel(*map(_t, other))
    return q, p, _t(states), eps, want


def test_marginals_match_jax(ssm_case):
    q, _, _, _, want = ssm_case
    _close(q.marginal_means, want["means"])
    _close(q.marginal_covariances, want["covs"])
    for got, w in zip(q.marginals, (want["means"], want["covs"])):
        _close(got, w)
    for got, w in zip(q.marginals_tl(), want["marginals_tl"]):
        _close(got, w)
    covs, sub = q.covariance_blocks()
    _close(covs, want["covs_b"])
    _close(sub, want["sub"])
    _close(q.subsequent_covariances(), want["sub"])
    _close(q.initial_covariance, want["p0"])
    _close(q.process_covariances, want["q"])


def test_densities_and_kl_match_jax(ssm_case):
    q, p, states, _, want = ssm_case
    _close(q.log_det_precision, want["log_det_precision"], atol=0, rtol=RTOL)
    _close(q.log_pdf(states), want["log_pdf"], atol=0, rtol=RTOL)
    _close(q.kl_divergence(p), want["kl"], atol=0, rtol=RTOL)
    _close(q.kl_divergence(p, marginals_tl=q.marginals_tl()), want["kl"], atol=0,
           rtol=RTOL)


def test_sample_maps_the_jax_draw_to_the_jax_sample(ssm_case):
    """The JAX sample is jax.random.normal(key, shape) through the affine
    map; the port's sample_from_normals maps the same draw."""
    q, _, _, eps, want = ssm_case
    _close(q.sample_from_normals(_t(eps)), want["sample"])
    g = torch.Generator().manual_seed(0)
    draw = q.sample((5,), generator=g)
    assert draw.shape == (5,) + q.batch_shape + q.event_shape
    assert torch.isfinite(draw).all()


def test_shapes_and_compatibility(ssm_case):
    q, p, _, _, _ = ssm_case
    d = q.state_dim
    assert q.event_shape == (T + 1, d) and q.num_transitions == T
    tssm.check_compatible(q, p)
    short = tssm.StateSpaceModel(q.initial_mean, q.cholesky_initial_covariance,
                                 q.state_transitions[..., 1:, :, :],
                                 q.state_offsets[..., 1:, :],
                                 q.cholesky_process_covariances[..., 1:, :, :])
    with pytest.raises(ValueError):
        q.kl_divergence(short)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_trainable_copy_holds_the_values_and_trains(d):
    q = tssm.StateSpaceModel(*map(_t, ssm_arrays(d, (), 0)))
    tq = q.trainable_copy()
    for name in ("initial_mean", "cholesky_initial_covariance", "state_transitions",
                 "state_offsets", "cholesky_process_covariances"):
        _close(getattr(tq, name), getattr(q, name), atol=1e-15)
    params = list(tq.parameters())
    assert len(params) == 5 and all(p.requires_grad for p in params)
    tq.log_pdf(q.marginal_means).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params)
    frozen = tq.non_trainable_copy()
    assert not list(frozen.parameters())
    _close(frozen.marginal_covariances, q.marginal_covariances, atol=1e-14)


def test_from_covariances_maps_zero_blocks_to_zero_factors():
    mu0, l0, a, b, lq = ssm_arrays(2, (), 0)
    q = lq @ np.swapaxes(lq, -1, -2)
    q[3] = 0.0
    args = (mu0, l0 @ l0.T, a, b, q)
    want = jssm.state_space_model_from_covariances(*args)
    got = tssm.state_space_model_from_covariances(*map(_t, args))
    _close(got.cholesky_process_covariances, want.cholesky_process_covariances)
    _close(got.cholesky_initial_covariance, want.cholesky_initial_covariance)
    assert float(got.cholesky_process_covariances[3].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# small linear algebra
# ---------------------------------------------------------------------------
def _psd(rng, shape, d):
    x = rng.standard_normal(shape + (d, d))
    return x @ np.swapaxes(x, -1, -2) + 0.1 * np.eye(d)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_cholesky_forms_match_jax(d):
    rng = np.random.default_rng(d)
    m = _psd(rng, (5,), d)
    m[2] = 0.0
    _close(tla.small_cholesky(_t(m[:2])), jla.small_cholesky(m[:2]))
    _close(tla.cholesky_or_zero(_t(m)), jla.cholesky_or_zero(m))
    _close(tla.psd_cholesky(_t(m)), jla.psd_cholesky(m))
    chol = np.linalg.cholesky(m[:2])
    rhs = rng.standard_normal((2, d, 3))
    _close(tla.solve_from_chol(_t(chol), _t(rhs)), jla.solve_from_chol(chol, rhs))
    x, mean = rng.standard_normal((4, 2, d)), rng.standard_normal((2, d))
    _close(tla.mvn_logpdf(_t(x), _t(mean), _t(chol)), jla.mvn_logpdf(x, mean, chol),
           atol=0, rtol=RTOL)


@pytest.mark.parametrize("d", [2, 3])
def test_psd_cholesky_clamps_a_negative_pivot_with_a_finite_gradient(d):
    """A roundoff-negative pivot (a deterministic direction, as Q_post of
    near-coincident points) clamps to zero; value and gradient match the
    JAX package's and are finite."""
    rng = np.random.default_rng(d)
    v = rng.standard_normal((d, 1))
    m = v @ v.T
    m[-1, -1] -= 1e-14          # the last pivot goes a roundoff below zero
    want = jla.psd_cholesky(m)
    want_grad = jax.grad(lambda x: jnp.sum(jla.psd_cholesky(x) ** 2 + jla.psd_cholesky(x)))(m)
    x = _t(m).requires_grad_(True)
    got = tla.psd_cholesky(x)
    (got ** 2 + got).sum().backward()
    assert float(got.detach()[-1, -1]) == 0.0
    assert torch.isfinite(got).all() and torch.isfinite(x.grad).all()
    _close(got, want)
    _close(x.grad, want_grad)
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(_t(m))


# ---------------------------------------------------------------------------
# the affine scans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d, batch", CONFIGS, ids=IDS)
def test_affine_scans_match_jax(d, batch):
    rng = np.random.default_rng(7 * d + len(batch))
    n = 37
    F = _contractions(rng, batch + (n,), d)
    F[..., 0, :, :] = 0.0
    c = rng.standard_normal(batch + (n, d))
    Q = _psd(rng, batch + (n,), d)
    _close(tscans.affine_scan(_t(F), _t(c)), jax.jit(jscans.affine_scan)(F, c))
    for got, want in zip(tscans.affine_cov_scan(_t(F), _t(c), _t(Q)),
                         jax.jit(jscans.affine_cov_scan)(F, c, Q)):
        _close(got, want)
    tl = (np.moveaxis(F, -3, -1), np.moveaxis(c[..., None], -3, -1), np.moveaxis(Q, -3, -1))
    for got, want in zip(tscans.affine_cov_scan_tl(*map(_t, tl)),
                         jax.jit(jscans.affine_cov_scan_tl)(*tl)):
        _close(got, want)
    start = np.zeros(n, bool)
    start[[0, 1, 5, 6, 20, 36]] = True
    seg = jax.jit(jscans.segmented_affine_cov_scan_tl)(*tl, start)
    for got, want in zip(tscans.segmented_affine_cov_scan_tl(
            *map(_t, tl), torch.as_tensor(start)), seg):
        _close(got, want)


# ---------------------------------------------------------------------------
# the kernels' state-space models and the mean functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_state_space_model_matches_jax(name):
    """On sorted uniform draws (steps down to ~1e-3).  Matern52's process
    noise is the generic P_inf - A P_inf A^T, whose roundoff (1e-16 of its
    O(1) operands) is no longer small beside Q ~ dt^5 at the shortest
    steps: there the Cholesky factor is not determined to 1e-10, so the
    covariances are compared, and the factors where every step is at least
    0.2."""
    jkern, tkern = kernel_pair(KERNELS[name])
    rng = np.random.default_rng(3)
    fn = jax.jit(lambda k, t: k.state_space_model(t))
    x = np.sort(rng.random(40) * 10.0)
    spread = np.cumsum(0.2 + rng.random(40))
    for grid, attrs in ((x, ("initial_mean", "state_transitions", "state_offsets",
                             "initial_covariance", "process_covariances")),
                        (spread, ("cholesky_initial_covariance",
                                  "cholesky_process_covariances"))):
        want = fn(jkern, grid)
        with torch.no_grad():
            got = tkern.state_space_model(_t(grid))
        for attr in attrs:
            _close(getattr(got, attr), getattr(want, attr))
    with torch.no_grad():
        _close(tkern.feedback_matrix, jkern.feedback_matrix)
        _close(tkern.state_transitions(_t(np.diff(x))), jkern.state_transitions(np.diff(x)))


def _mean_pair(kind, jkern, tkern, d):
    rng = np.random.default_rng(5)
    if kind == "Zero":
        return jmf.ZeroMeanFunction(), tmf.ZeroMeanFunction()
    if kind == "Linear":
        return (jmf.LinearMeanFunction(0.3),
                tmf.LinearMeanFunction(0.3, dtype=torch.float64, device="cpu"))
    times = np.sort(rng.random(d) * 8.0 + 1.0)   # M = d (see ROADMAP queue 3)
    u = rng.standard_normal((d, d))
    jcls, tcls = {"Impulse": (jmf.ImpulseMeanFunction, tmf.ImpulseMeanFunction),
                  "Step": (jmf.StepMeanFunction, tmf.StepMeanFunction)}[kind]
    return jcls(times, u, jkern), tcls(_t(times), _t(u), tkern)


@pytest.mark.parametrize("kind, kernel", [
    ("Zero", "Matern32"), ("Linear", "Matern32"), ("Impulse", "Matern32"),
    ("Impulse", "Matern52"), ("Step", "Matern12"), ("Step", "Matern32")])
def test_mean_functions_match_jax(kind, kernel):
    jkern, tkern = kernel_pair(KERNELS[kernel])
    d = tkern.state_dim
    jm, tm = _mean_pair(kind, jkern, tkern, d)
    ts = np.concatenate([[-1.0, 0.0], np.linspace(0.5, 12.0, 23)])
    if kind in ("Impulse", "Step"):
        ts = np.sort(np.concatenate([ts, np.asarray(jm.action_times)]))
    with torch.no_grad():
        _close(tm(_t(ts)), jm(jnp.asarray(ts)))


def test_step_mean_function_takes_more_steps_than_state_dims():
    """The JAX package's StepMeanFunction raises for M != d at d >= 2 (it
    broadcasts F to [M, d]); the port's broadcasts F over the M steps.
    Held to the superposition of step responses: the input's change
    u_k - u_{k-1} at t_k adds (A(t - t_k) - I) F^-1 (u_k - u_{k-1}) for
    t > t_k."""
    _, tkern = kernel_pair(("Matern32",))
    rng = np.random.default_rng(2)
    times, u = _t(np.array([1.0, 2.5, 4.0])), _t(rng.standard_normal((3, 2)))
    ts = _t(np.linspace(0.0, 6.0, 31))
    with torch.no_grad():
        got = tmf.StepMeanFunction(times, u, tkern)(ts)[:, 0]
        f_inv = torch.linalg.inv(tkern.feedback_matrix)
        want = torch.zeros_like(ts)
        jumps = u - torch.cat([torch.zeros_like(u[:1]), u[:-1]])
        for tk_, uk in zip(times, jumps):
            dt = torch.clamp(ts - tk_, min=0.0)
            a = tkern.state_transitions(dt)
            resp = ((a - torch.eye(2, dtype=torch.float64)) @ (f_inv @ uk))[:, 0]
            want = want + torch.where(ts > tk_, resp, torch.zeros_like(resp))
    _close(got, want, atol=1e-12)
