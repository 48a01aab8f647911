"""Multi-output GPR above state dim 6 in the port against the JAX package
(float64, CPU): mo9 (an ``IndependentMultiOutput`` of the d9 model's three
Matern52 children, d = 9, o = 3, a full noise Cholesky) and fa9 (a
``FactorAnalysisKernel`` of them as latents, twelve outputs, time-varying
weights, a trainable loading), each on a uniform and an irregular grid:
the log-likelihood, the gradients, the smoothed marginals, ``predict_f``
and ``predict_y``.  Both models take the general kernels (4, 5, 7) on
either grid: the JAX package sends o > 1 above d = 6 to its materialised
route, and the port's filter classes and uniform log-likelihood do the
same (the routes are tested here through the wrappers they call; on the
card the launch counters say the same, ``test_torch_cuda.py``).  Also the
plain kernels 4 and 7 at (d, o) = (9, 3) and (7, 12) against the Pallas
kernels in interpret mode, ``convert.gpr_from_numpy`` for both
specifications, and the wrappers' limits at d = 7..12.

The JAX references run in four fresh processes started at once
(``_mo_refs.py`` for mo9, ``_fa_refs.py`` for fa9, ``_pallas_refs.py`` for
each Pallas case).

    python -m pytest tests/port/test_torch_wide_multi_output.py -q
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch import kalman_filter as kf  # noqa: E402
from markovflow_tpu_torch import kernels  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402
from markovflow_tpu_torch.likelihoods import MultivariateGaussian  # noqa: E402
from markovflow_tpu_torch.ops import adjoint as adj  # noqa: E402
from markovflow_tpu_torch.ops import cuda_scan as cs  # noqa: E402

import _fa_refs as FA  # noqa: E402
import _mo_refs as MO  # noqa: E402
from _pallas_refs import (GADJOINT_NAMES, GENERAL_INPUT_NAMES, MO_WIDE_CASES,  # noqa: E402
                          mo_gscale, mo_inputs)
from _pallas_refs import run_refs as run_pallas_refs  # noqa: E402

LOGLIK_RTOL = 1e-10     # sums of N terms, same algorithm, other bracketing
GRAD_RTOL = 1e-8        # both the Koopman score, in other bracketings
ATOL = 1e-10            # marginals and predictions
# the plain kernels against the Pallas ones, as test_torch_kernels_plain.py
PALLAS_ATOL = 1e-10
PALLAS_LOGLIK_RTOL = 1e-12
MO9 = ("mo9_uniform", "mo9_jittered")
FA9 = ("fa9_uniform", "fa9_jittered")


@pytest.fixture(scope="module")
def all_refs(tmp_path_factory):
    """(the JAX models' outputs, the Pallas kernels' outputs), their fresh
    processes all started at once."""
    with ThreadPoolExecutor(3) as pool:
        mo = pool.submit(MO.run_refs, tmp_path_factory.mktemp("mo9_refs"), [MO9])
        fa = pool.submit(FA.run_refs, tmp_path_factory.mktemp("fa9_refs"), FA9)
        pallas = pool.submit(run_pallas_refs, tmp_path_factory.mktemp("wide_pallas_refs"),
                             [(f"mo:{name}",) for name in MO_WIDE_CASES])
        return {**mo.result(), **fa.result()}, pallas.result()


@pytest.fixture(scope="module")
def refs(all_refs):
    return all_refs[0]


@pytest.fixture(scope="module")
def pallas_refs(all_refs):
    return all_refs[1]


def _np(x):
    return x.detach().numpy()


def _model(name, refs):
    """mo9 or fa9 from the JAX model's unconstrained parameters."""
    if name in MO9:
        comb, specs, _, _ = MO.WIDE_CONFIGS[name]
        params = {"chol_obs_covariance": MO.chol(MO.output_dim(name))}
        for i in range(len(specs)):
            for p in ("lengthscale", "variance"):
                key = f"kernel.kernels[{i}].{p}"
                params[key] = refs[f"{name}/{key}"]
        x, y = MO.data(name)
        return gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64,
                              kernel=(comb, tuple(k for k, _, _ in specs)))
    o, varying, _ = FA.WIDE_CONFIGS[name]
    specs = FA.latents_of(name)
    params = {"chol_obs_covariance": FA.chol(o),
              "kernel._loading": refs[f"{name}/kernel._loading"]}
    for i in range(len(specs)):
        for p in ("lengthscale", "variance"):
            key = f"kernel._inner.kernels[{i}].{p}"
            params[key] = refs[f"{name}/{key}"]
    x, y = FA.data(name)
    return gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64,
                          kernel=("FactorAnalysisKernel", tuple(k for k, _, _ in specs)),
                          weight_fn=lambda t: FA.weights(t, o, varying, torch))


def _hyper(m, name):
    """name -> the model's trainable parameter, under the JAX model's paths."""
    if name in MO9:
        return {f"kernel.kernels[{i}].{p}": getattr(k, p).unconstrained
                for i, k in enumerate(m.kernel.kernels) for p in ("lengthscale", "variance")}
    out = {f"kernel._inner.kernels[{i}].{p}": getattr(k, p).unconstrained
           for i, k in enumerate(m.kernel._inner.kernels) for p in ("lengthscale", "variance")}
    out["kernel._loading"] = m.kernel._loading.unconstrained
    return out


# ---------------------------------------------------------------------------
# GPR against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MO9 + FA9)
def test_wide_gpr_log_likelihood_matches_jax(refs, name):
    m = _model(name, refs)
    assert m.kernel.state_dim == 9
    with torch.no_grad():
        np.testing.assert_allclose(_np(m.log_likelihood()), refs[f"{name}/loglik"],
                                   rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", MO9 + FA9)
def test_wide_gpr_gradients_match_jax(refs, name):
    """The children's (latents') hyperparameters and fa9's loading, through
    the plain version of the general Koopman backward."""
    m = _model(name, refs)
    m.loss().sum().backward()
    for key, prm in _hyper(m, name).items():
        np.testing.assert_allclose(_np(prm.grad), refs[f"{name}/grad {key}"], rtol=GRAD_RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", MO9 + FA9)
def test_wide_gpr_posterior_marginals_match_jax(refs, name):
    m = _model(name, refs)
    with torch.no_grad():
        means, covs = m.kalman.posterior_marginals()
    for got, key in ((means, "marg_means"), (covs, "marg_covs")):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("full", [False, True], ids=["diag", "full_output_cov"])
@pytest.mark.parametrize("name", MO9 + FA9)
def test_wide_gpr_predict_f_matches_jax(refs, name, full):
    m = _model(name, refs)
    t = torch.as_tensor((MO if name in MO9 else FA).new_points(name))
    with torch.no_grad():
        mean, cov = m.posterior.predict_f(t, full_output_cov=full)
    keys = ("f_mean_full", "f_cov") if full else ("f_mean", "f_var")
    for got, key in zip((mean, cov), keys):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", MO9 + FA9)
def test_wide_gpr_predict_y_matches_jax(refs, name):
    """Through MultivariateGaussian (full output covariances)."""
    m = _model(name, refs)
    post = m.posterior
    assert isinstance(post.likelihood, MultivariateGaussian)
    with torch.no_grad():
        mean, cov = post.predict_y(torch.as_tensor((MO if name in MO9 else FA).new_points(name)))
    for got, key in ((mean, "y_mean"), (cov, "y_cov")):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", MO9 + FA9)
def test_convert_builds_the_jax_models_kernel(refs, name):
    """gpr_from_numpy for ("IndependentMultiOutput", ("Matern52",) * 3) and
    ("FactorAnalysisKernel", ("Matern52",) * 3): the kernel's class and
    dims, and every parameter at the JAX model's attribute path."""
    m = _model(name, refs)
    mo = name in MO9
    k = m.kernel
    assert isinstance(k, kernels.IndependentMultiOutput if mo else kernels.FactorAnalysisKernel)
    kids = k.kernels if mo else k._inner.kernels
    assert [type(c) for c in kids] == [kernels.Matern52] * 3
    assert (k.state_dim, k.output_dim) == (9, 3 if mo else FA.WIDE_CONFIGS[name][0])
    assert m._uniform_grid == name.endswith("uniform")
    if mo:  # the JAX factor analysis on a uniform grid is built with uniform_grid=False
        assert m._uniform_grid == bool(refs[f"{name}/uniform"])
    for key, prm in _hyper(m, name).items():
        np.testing.assert_array_equal(_np(prm), refs[f"{name}/{key}"], err_msg=key)
        assert prm.requires_grad, key


# ---------------------------------------------------------------------------
# The routes at o > 1 above d = 6
# ---------------------------------------------------------------------------
_WRAPPERS = (("uniform", kf, "filter_pipeline_uniform"),
             ("uniform", kf, "smoother_pipeline_uniform"),
             ("uniform", adj, "adjoint_pipeline_uniform"),
             ("uniform", cs, "filter_pipeline_uniform"),
             ("general", kf, "filter_pipeline"), ("general", kf, "smoother_scan"),
             ("general", adj, "adjoint_pipeline"), ("general", cs, "filter_pipeline"))


def _spy_routes(monkeypatch):
    calls = {"uniform": 0, "general": 0}
    for route, mod, fname in _WRAPPERS:
        fn = getattr(mod, fname)

        def spy(*a, _fn=fn, _route=route, **kw):
            calls[_route] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, fname, spy)
    return calls


def test_serving_route_materialises_above_d6_at_o_past_one(refs, monkeypatch):
    """mo9 on a uniform grid: a constant emission of three rows at d = 9, so
    the filter class materialises the constant prior steps (kernel 1 takes
    o = 1 only above d = 6) and the loss, its gradient, the marginals and
    the posterior call only the general kernels' wrappers (4, 5, 7); the d9
    model's one row at d = 9 keeps the uniform ones."""
    calls = _spy_routes(monkeypatch)
    m = _model("mo9_uniform", refs)
    assert m._uniform_grid and m.kalman.prior_tl is not None
    assert m.kalman.prior_const_tl is None
    m.loss().backward()
    with torch.no_grad():
        m.kalman.posterior_marginals()
        m.posterior.predict_f(torch.linspace(0.0, 10.0, 7, dtype=torch.float64))
    assert calls["uniform"] == 0 and calls["general"] >= 4, calls
    # one output at d = 9: the uniform kernels
    calls.update(uniform=0, general=0)
    x = np.linspace(0.0, 10.0, 64)
    params = {"chol_obs_covariance": np.array([[0.2]])}
    d9 = gpr_from_numpy(params, x, np.sin(x)[:, None], device="cpu", dtype=torch.float64,
                        kernel=("Matern52",) * 3)
    assert d9.kalman.prior_const_tl is not None
    with torch.no_grad():
        d9.kalman.posterior_marginals()
    assert calls["uniform"] == 2 and calls["general"] == 0, calls


def test_uniform_loss_takes_the_general_kernels_above_d6_at_o_past_one(monkeypatch):
    """log_likelihood_koopman_uniform at d = 9, o = 3 materialises the
    constant steps and takes the general filter and Koopman backward (on
    CUDA kernels 4 and 7; it raised NotImplementedError there before), as
    the JAX package's _uniform_engine routes it; its value and gradient are
    the general route's."""
    rng = np.random.default_rng(9)
    d, o, n = 9, 3, 40
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    fc = 0.9 * np.eye(d) + 0.02 * rng.standard_normal((d, d))
    lq = 0.2 * rng.standard_normal((d, d)) + np.eye(d)
    ll = rng.standard_normal((o, o))
    consts = [t(fc[..., None]), t(0.1 * rng.standard_normal((d, 1, 1))),
              t((0.3 * lq @ lq.T)[..., None]), t(rng.standard_normal((d, 1, 1))),
              t((1.5 * np.eye(d))[..., None]), t(rng.standard_normal((o, d, 1)))]
    for x in consts:
        x.requires_grad_(True)
    nu = t(rng.standard_normal((o, 1, n)))
    lam = t((ll @ ll.T + np.eye(o))[..., None]).expand(o, o, n)
    calls = _spy_routes(monkeypatch)
    loss = adj.log_likelihood_koopman_uniform(*consts, nu, lam)
    loss.backward()
    assert calls["uniform"] == 0 and calls["general"] >= 1, calls
    F, c, Q, H = (x.detach() for x in
                  cs._materialize_uniform(*(x.detach() for x in consts), n))
    want = adj.log_likelihood_koopman(F, c, Q, H, nu, lam)
    np.testing.assert_allclose(_np(loss), _np(want), rtol=1e-13)
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in consts)


@pytest.mark.parametrize("d", [7, 9, 12])
def test_general_wrappers_take_o_to_twelve_above_d6(d):
    """The limits the CUDA branch checks before a launch: the general
    kernels take o = 2..12 at d = 7..12, the uniform ones o = 1 only, and
    neither o = 13."""
    x = [torch.zeros(1, dtype=torch.float64)]
    for o in (2, 3, d, 12):
        assert cs._check_cuda(x, d, o) == "f64"
        with pytest.raises(NotImplementedError):
            cs._check_cuda(x, d, o, max_o=cs.UNIFORM_MAX_OUTPUT_DIM)
    assert cs._check_cuda(x, d, 1, max_o=cs.UNIFORM_MAX_OUTPUT_DIM) == "f64"
    with pytest.raises(NotImplementedError):
        cs._check_cuda(x, d, 13)


# ---------------------------------------------------------------------------
# The plain kernels 4 and 7 above d = 6 against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["general filter", "general Koopman backward"])
@pytest.mark.parametrize("name", sorted(MO_WIDE_CASES))
def test_plain_general_kernels_above_d6_match_pallas(pallas_refs, name, kernel):
    """filter_pipeline_plain and adjoint_pipeline_plain at (d, o) = (9, 3)
    (a batch of two, masked) and (7, 12), a dense H and a full lam at
    every step, the backward on the Pallas filter's moments."""
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
