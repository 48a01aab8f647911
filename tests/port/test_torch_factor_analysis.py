"""GP factor analysis in the port against the JAX package (float64, CPU):
``FactorAnalysisKernel`` (prior steps, emission, state-space model, the
projections of ``ComposedPairEmissionModel`` to the latent space, a
lengthscale's gradient; output dims 2 and 3, one series and a batch of
three) and GPR on it at o > d on a uniform and an irregular grid, with a
time-varying and a constant weight function: the log-likelihood, the
gradients of the latents' hyperparameters and of the loading, the smoothed
marginals, ``predict_f`` and ``predict_y``.  On a uniform grid with a
time-varying emission the port takes the general kernels and is held to
the JAX package's general route (its uniform route reads step 0's
emission at every step); on a constant emission it still takes the
uniform kernels (the wrappers it calls).  Also the plain general kernels
at o = 8 against the Pallas kernels in interpret mode (the o > d cases
that kernels 1 and 3 also take are ``_pallas_refs.MO_CASES``, held in
``test_torch_multi_output.py``).

The JAX references run in two fresh processes started at once
(``_fa_refs.py`` and ``_pallas_refs.py``).

    python -m pytest tests/port/test_torch_factor_analysis.py -q
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch import kalman_filter as kf  # noqa: E402
from markovflow_tpu_torch import kernels  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402
from markovflow_tpu_torch.emission_model import ComposedPairEmissionModel  # noqa: E402
from markovflow_tpu_torch.likelihoods import MultivariateGaussian  # noqa: E402
from markovflow_tpu_torch.ops import adjoint as adj  # noqa: E402
from markovflow_tpu_torch.ops import cuda_scan as cs  # noqa: E402

import _fa_refs as R  # noqa: E402
from _pallas_refs import (GADJOINT_NAMES, GENERAL_INPUT_NAMES, MO_GENERAL_CASES,  # noqa: E402
                          mo_gscale, mo_inputs)
from _pallas_refs import run_refs as run_pallas_refs  # noqa: E402

LOGLIK_RTOL = 1e-12     # sums of N terms, same algorithm, other bracketing
GRAD_RTOL = 1e-8        # both the Koopman score, in other bracketings
ATOL = 1e-10            # marginals and predictions
# the prior steps: the latents' closed-form Q against the JAX package's
# P_inf - A P_inf A^T of the whole state (test_torch_multi_output.py)
STEPS_ATOL = 1e-12
# the plain kernels against the Pallas ones, as test_torch_kernels_plain.py
PALLAS_ATOL = 1e-10
PALLAS_LOGLIK_RTOL = 1e-12


@pytest.fixture(scope="module")
def both_refs(tmp_path_factory):
    """(the JAX factor analysis outputs, the Pallas kernels' outputs), their
    fresh processes started at once."""
    with ThreadPoolExecutor(2) as pool:
        fa = pool.submit(R.run_refs, tmp_path_factory.mktemp("fa_refs"))
        pallas = pool.submit(run_pallas_refs, tmp_path_factory.mktemp("fa_pallas_refs"),
                             [tuple(f"mo:{name}" for name in MO_GENERAL_CASES)])
        return fa.result(), pallas.result()


@pytest.fixture(scope="module")
def refs(both_refs):
    return both_refs[0]


@pytest.fixture(scope="module")
def pallas_refs(both_refs):
    return both_refs[1]


def _np(x):
    return x.detach().numpy()


def _latents(specs):
    return [getattr(kernels, k)(lengthscale=e, variance=v, dtype=torch.float64, device="cpu")
            for k, e, v in specs]


# ---------------------------------------------------------------------------
# FactorAnalysisKernel and ComposedPairEmissionModel
# ---------------------------------------------------------------------------
def _kernel(o, ell0=0.7):
    kids = _latents(R.KERNEL_LATENTS)
    if ell0 != 0.7:
        kids[0] = kernels.Matern12(lengthscale=ell0, variance=1.3, dtype=torch.float64,
                                   device="cpu")
    return kernels.FactorAnalysisKernel(lambda t: R.weights(t, o, False, torch), kids,
                                        output_dim=o, loading=R.loading(o),
                                        trainable_loading=False)


@pytest.mark.parametrize("grid", ["uniform", "batch3"])
@pytest.mark.parametrize("o", [2, 3])
def test_factor_analysis_prior_and_emission_match_jax(refs, o, grid):
    """Prior steps (per step and constant), emission (H = A B H_inner,
    constant here: an expanded view) and state-space model."""
    k = _kernel(o)
    assert k.output_dim == o and k.state_dim == 3 and not k.loading.requires_grad
    t = torch.as_tensor(R.kernel_grids()[grid])
    tag = f"kernel/o{o}/{grid}"
    with torch.no_grad():
        got = dict(zip(("F", "c", "Q"), k.prior_arrays_tl(t)))
        got.update(zip(("Fc", "cc", "Qc", "mu0", "P0"),
                       k.prior_const_tl(t[..., 1:2] - t[..., :1])))
        em = k.generate_emission_model(t)
        got["H"] = em.emission_matrix
        ssm = k.state_space_model(t)
    assert isinstance(em, ComposedPairEmissionModel) and em.emission_matrix.stride(-3) == 0
    for key, val in got.items():
        want = refs[f"{tag}/{key}"]
        assert val.shape == want.shape, key
        np.testing.assert_allclose(_np(val), want, atol=STEPS_ATOL, rtol=0, err_msg=key)
    for key in ("initial_mean", "state_transitions", "state_offsets"):
        np.testing.assert_allclose(_np(getattr(ssm, key)), refs[f"{tag}/{key}"],
                                   atol=STEPS_ATOL, rtol=0, err_msg=key)
    for key in ("cholesky_initial_covariance", "cholesky_process_covariances"):
        lg, lw = _np(getattr(ssm, key)), refs[f"{tag}/{key}"]
        np.testing.assert_allclose(lg @ np.swapaxes(lg, -1, -2),
                                   lw @ np.swapaxes(lw, -1, -2), atol=STEPS_ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("grid", ["uniform", "batch3"])
@pytest.mark.parametrize("o", [2, 3])
def test_composed_pair_projections_match_jax(refs, o, grid):
    """project_state_to_g, project_state_covariance_to_g (diagonal and
    full) and the full covariance of f."""
    t = torch.as_tensor(R.kernel_grids()[grid])
    em = _kernel(o).generate_emission_model(t)
    s, cov = (torch.as_tensor(a) for a in R.projection_inputs(tuple(t.shape)))
    tag = f"kernel/o{o}/{grid}"
    with torch.no_grad():
        got = {"g": em.project_state_to_g(s), "g_var": em.project_state_covariance_to_g(cov),
               "g_cov": em.project_state_covariance_to_g(cov, full_output_cov=True),
               "f_cov": em.project_state_covariance_to_f(cov, full_output_cov=True)}
    for key, val in got.items():
        want = refs[f"{tag}/{key}"]
        assert val.shape == want.shape, key
        np.testing.assert_allclose(_np(val), want, atol=STEPS_ATOL, rtol=0, err_msg=key)


def test_factor_analysis_lengthscale_gradient_matches_jax(refs):
    """d/d ell of H_0 P_0 A_0^T H_1^T [0, 0], through the latent's
    lengthscale (tests/integration/test_combinator_matrix.py's probe)."""
    ell = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    ts = torch.tensor([0.0, 0.4, 1.3], dtype=torch.float64)
    kids = _latents(R.KERNEL_LATENTS)
    kids[0].lengthscale.unconstrained.data.copy_(
        kids[0].lengthscale.transform.inverse(ell.detach()))
    k = kernels.FactorAnalysisKernel(lambda t: R.weights(t, 3, False, torch), kids,
                                     output_dim=3, loading=R.loading(3),
                                     trainable_loading=False)
    ssm = k.state_space_model(ts)
    a, p = ssm.state_transitions, ssm.marginal_covariances
    h = k.generate_emission_model(ts).emission_matrix
    val = (h[0] @ (p[0] @ a[0].T) @ h[1].T)[0, 0]
    (g_u,) = torch.autograd.grad(val, kids[0].lengthscale.unconstrained)
    # the JAX probe differentiates by the constrained lengthscale
    dell_du = torch.autograd.functional.jacobian(
        kids[0].lengthscale.transform.forward, kids[0].lengthscale.unconstrained.detach())
    np.testing.assert_allclose(float(g_u / dell_du), float(refs["kernel/grad"]), rtol=1e-8)


def test_factor_analysis_loading_defaults_and_time_varying_emission():
    """The loading defaults to eye(output_dim, n_latents), trainable; a
    time-varying weight function gives a per-step emission."""
    kids = _latents(R.LATENTS)
    k = kernels.FactorAnalysisKernel(lambda t: R.weights(t, 5, True, torch), kids, output_dim=5)
    np.testing.assert_array_equal(_np(k.loading), np.eye(5, 2))
    assert k.loading.requires_grad
    t = torch.linspace(0.0, 10.0, 17, dtype=torch.float64)
    h = k.generate_emission_model(t).emission_matrix
    assert h.shape == (17, 5, 3) and h.stride(-3) != 0
    assert not torch.equal(h[0], h[5])


# ---------------------------------------------------------------------------
# GPR on a factor analysis kernel
# ---------------------------------------------------------------------------
def _model(name, refs):
    o, varying, _ = R.CONFIGS[name]
    params = {"chol_obs_covariance": R.chol(o),
              "kernel._loading": refs[f"{name}/kernel._loading"]}
    for i in range(len(R.LATENTS)):
        for p in ("lengthscale", "variance"):
            key = f"kernel._inner.kernels[{i}].{p}"
            params[key] = refs[f"{name}/{key}"]
    x, y = R.data(name)
    return gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64,
                          kernel=("FactorAnalysisKernel", tuple(k for k, _, _ in R.LATENTS)),
                          weight_fn=lambda t: R.weights(t, o, varying, torch))


def _route(name):
    """The prior a filter of the configuration takes: uniform (constant
    steps) only on a uniform grid with a constant emission of at most
    UNIFORM_MAX_OUTPUT_DIM rows."""
    o, varying, uniform = R.CONFIGS[name]
    return uniform and not varying and o <= cs.UNIFORM_MAX_OUTPUT_DIM


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_fa_gpr_log_likelihood_matches_jax(refs, name):
    """The JAX reference of a time-varying emission is its general route."""
    m = _model(name, refs)
    assert m._uniform_grid == R.CONFIGS[name][2]
    assert bool(refs[f"{name}/uniform"]) == (R.CONFIGS[name][2] and not R.CONFIGS[name][1])
    kal = m.kalman
    assert (kal.prior_const_tl is not None) == _route(name)
    assert (kal.prior_tl is not None) == (not _route(name))
    with torch.no_grad():
        np.testing.assert_allclose(_np(m.log_likelihood()), refs[f"{name}/loglik"],
                                   rtol=LOGLIK_RTOL)
        np.testing.assert_allclose(_np(m.loss()), -refs[f"{name}/loglik"], rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_fa_gpr_gradients_match_jax(refs, name):
    """The latents' lengthscales and variances and the loading, through the
    plain Koopman backwards (the loading's through gH or gHc)."""
    m = _model(name, refs)
    m.loss().backward()
    for i, child in enumerate(m.kernel._inner.kernels):
        for p in ("lengthscale", "variance"):
            key = f"kernel._inner.kernels[{i}].{p}"
            np.testing.assert_allclose(_np(getattr(child, p).unconstrained.grad),
                                       refs[f"{name}/grad {key}"], rtol=GRAD_RTOL, err_msg=key)
    np.testing.assert_allclose(_np(m.kernel._loading.unconstrained.grad),
                               refs[f"{name}/grad kernel._loading"], rtol=GRAD_RTOL)


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_fa_gpr_posterior_marginals_match_jax(refs, name):
    m = _model(name, refs)
    with torch.no_grad():
        means, covs = m.kalman.posterior_marginals()
    for got, key in ((means, "marg_means"), (covs, "marg_covs")):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_fa_gpr_predictions_match_jax(refs, name):
    """predict_f (diagonal and full output covariances, the emission at the
    new points through weight_fn) and predict_y (MultivariateGaussian)."""
    m = _model(name, refs)
    post = m.posterior
    assert isinstance(post.likelihood, MultivariateGaussian)
    t = torch.as_tensor(R.new_points(name))
    with torch.no_grad():
        got = dict(zip(("f_mean", "f_var"), post.predict_f(t)))
        got.update(zip(("f_mean_full", "f_cov"), post.predict_f(t, full_output_cov=True)))
        got.update(zip(("y_mean", "y_cov"), post.predict_y(t)))
    for key, val in got.items():
        want = refs[f"{name}/{key}"]
        assert val.shape == want.shape, key
        np.testing.assert_allclose(_np(val), want, atol=ATOL, rtol=0, err_msg=key)


def test_fa_gpr_sample_f_and_fit(refs):
    """sample_f's shape on the time-varying model, and fit stepping the
    latents and the loading with the loss falling."""
    from markovflow_tpu_torch.training import fit

    m = _model("tv_jittered", refs)
    t = torch.as_tensor(R.new_points("tv_jittered"))
    draws = m.posterior.sample_f(t, 3, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (3, len(t), R.CONFIGS["tv_jittered"][0])
    assert torch.isfinite(draws).all()
    b0 = m.kernel.loading.detach().clone()
    _, losses = fit(m, num_steps=4, optimizer=torch.optim.Adam(
        [p for p in m.parameters() if p.requires_grad], lr=0.05))
    assert losses[-1] < losses[0]
    assert not torch.equal(m.kernel.loading.detach(), b0)


# ---------------------------------------------------------------------------
# The uniform-grid dispatch (a time-varying emission never takes kernels 1-3)
# ---------------------------------------------------------------------------
_WRAPPERS = (("uniform", kf, "filter_pipeline_uniform"), ("uniform", kf, "smoother_pipeline_uniform"),
             ("uniform", adj, "adjoint_pipeline_uniform"), ("uniform", cs, "filter_pipeline_uniform"),
             ("general", kf, "filter_pipeline"), ("general", kf, "smoother_scan"),
             ("general", adj, "adjoint_pipeline"), ("general", cs, "filter_pipeline"))


@pytest.mark.parametrize("name", ["tv_uniform", "const_uniform", "const8_uniform"])
def test_uniform_grid_dispatch_by_emission(refs, name, monkeypatch):
    """On a uniform grid the loss, its gradient and the marginals call the
    uniform kernels' wrappers (1, 2, 3) where the emission is constant and
    has at most UNIFORM_MAX_OUTPUT_DIM rows, and only the general ones (4,
    5, 7) otherwise.  (On the card the launch counters say the same:
    test_torch_cuda.py.)"""
    calls = {"uniform": 0, "general": 0}
    for route, mod, fname in _WRAPPERS:
        fn = getattr(mod, fname)

        def spy(*a, _fn=fn, _route=route, **kw):
            calls[_route] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, fname, spy)
    m = _model(name, refs)
    m.loss().backward()
    with torch.no_grad():
        m.kalman.posterior_marginals()
    uniform = _route(name)
    assert calls["uniform"] > 0 if uniform else calls["uniform"] == 0, calls
    assert calls["general"] == 0 if uniform else calls["general"] > 0, calls


# ---------------------------------------------------------------------------
# The plain general kernels at o = 8 against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["general filter", "general Koopman backward"])
@pytest.mark.parametrize("name", sorted(MO_GENERAL_CASES))
def test_plain_general_kernels_at_o_past_six_match_pallas(pallas_refs, name, kernel):
    """filter_pipeline_plain and adjoint_pipeline_plain at (d, o) = (3, 8)
    with a full lam at every step and a mask (kernels 1 and 3 stop at
    o = 6), the backward on the Pallas filter's moments."""
    _, gen = mo_inputs(name)
    gen = [None if gen[k] is None else torch.from_numpy(gen[k]) for k in GENERAL_INPUT_NAMES]
    key = f"mo:{name}/"
    ref = {k[len(key):]: v for k, v in pallas_refs.items() if k.startswith(key)}
    assert not any(k.startswith("u_") for k in ref)
    if kernel == "general filter":
        m_f, p_f, ll = cs.filter_pipeline_plain(*gen)
        np.testing.assert_allclose(_np(m_f), ref["g_m_f"], atol=PALLAS_ATOL, rtol=0)
        np.testing.assert_allclose(_np(p_f), ref["g_p_f"], atol=PALLAS_ATOL, rtol=0)
        np.testing.assert_allclose(_np(ll), ref["g_loglik"], rtol=PALLAS_LOGLIK_RTOL)
        return
    gs = torch.from_numpy(np.asarray(mo_gscale(name)))
    got = adj.adjoint_pipeline_plain(*gen, torch.from_numpy(ref["g_m_f"]),
                                     torch.from_numpy(ref["g_p_f"]), gs)
    for g, k in zip(got, GADJOINT_NAMES):
        want = ref["g_" + k]
        assert tuple(g.shape) == want.shape, k
        np.testing.assert_allclose(_np(g), want, atol=PALLAS_ATOL * max(1.0, np.abs(want).max()),
                                   rtol=0, err_msg=k)
