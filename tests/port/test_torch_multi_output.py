"""The port's multi-output GPR against the JAX package's (float64, CPU):
``IndependentMultiOutput`` (its prior steps, emission and state-space
model; o = 2, 3), GPR with a full o x o noise Cholesky on a uniform and a
jittered grid (log-likelihood, the gradients of every kernel
hyperparameter, the smoothed marginals, ``predict_f`` with and without the
full output covariances, ``predict_y``), ``sample_f``'s shapes and moments,
the five methods of ``MultivariateGaussian``, the ``Product`` kernel's GPR,
and ``convert.gpr_from_numpy``'s multi-output specs.  Also the plain
versions of kernels 1, 3 and 7 at o x o sites (a full lam at every step)
against the Pallas kernels in interpret mode.

Both sides are built from one numpy seed, the port's models through
``convert.gpr_from_numpy`` from the JAX models' parameters.  The JAX
references run in fresh processes (``_mo_refs.py``, ``_pallas_refs.py``).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch import kernels  # noqa: E402
from markovflow_tpu_torch.convert import gpr_from_numpy  # noqa: E402
from markovflow_tpu_torch.likelihoods import MultivariateGaussian  # noqa: E402
from markovflow_tpu_torch.ops import adjoint as adj  # noqa: E402
from markovflow_tpu_torch.ops import cuda_scan as cs  # noqa: E402

import _mo_refs as R  # noqa: E402
from _pallas_refs import (ADJOINT_NAMES, GADJOINT_NAMES, GENERAL_INPUT_NAMES,  # noqa: E402
                          INPUT_NAMES, MO_CASES, mo_gscale, mo_inputs)
from _pallas_refs import run_refs as run_pallas_refs  # noqa: E402

LOGLIK_RTOL = 1e-10     # sums of N terms, same algorithm, other bracketing
GRAD_RTOL = 1e-8        # both the Koopman score, in other bracketings
ATOL = 1e-10            # marginals and predictions
# the prior steps: the port's IndependentMultiOutput takes its children's
# closed-form Q, the JAX package the whole state's P_inf - A P_inf A^T,
# equal in exact arithmetic; float64 roundoff of entries up to ~10
STEPS_ATOL = 1e-12
# the plain kernels against the Pallas ones, as test_torch_kernels_plain.py
PALLAS_ATOL = 1e-10
PALLAS_LOGLIK_RTOL = 1e-12


@pytest.fixture(scope="module")
def both_refs(tmp_path_factory):
    """(the JAX models' outputs, the Pallas kernels' outputs), their fresh
    processes all started at once."""
    with ThreadPoolExecutor(2) as pool:
        mo = pool.submit(R.run_refs, tmp_path_factory.mktemp("mo_refs"), R.GROUPS)
        pallas = pool.submit(run_pallas_refs, tmp_path_factory.mktemp("mo_pallas_refs"),
                             [(f"mo:{name}",) for name in MO_CASES])
        return mo.result(), pallas.result()


@pytest.fixture(scope="module")
def refs(both_refs):
    return both_refs[0]


@pytest.fixture(scope="module")
def pallas_refs(both_refs):
    return both_refs[1]


def _model(name, refs):
    comb, specs, _, _ = R.CONFIGS[name]
    params = {"chol_obs_covariance": R.chol(R.output_dim(name))}
    for i in range(len(specs)):
        for p in ("lengthscale", "variance"):
            key = f"kernel.kernels[{i}].{p}"
            params[key] = refs[f"{name}/{key}"]
    x, y = R.data(name)
    return gpr_from_numpy(params, x, y, device="cpu", dtype=torch.float64,
                          kernel=(comb, tuple(k for k, _, _ in specs)))


def _children(specs):
    return [getattr(kernels, k)(lengthscale=e, variance=v, dtype=torch.float64,
                                device="cpu") for k, e, v in specs]


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# IndependentMultiOutput
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", ["uniform", "batch3"])
@pytest.mark.parametrize("kname", sorted(R.KERNELS))
def test_independent_multi_output_prior_matches_jax(refs, kname, grid):
    """Prior steps (per step and constant), emission and state-space model,
    for one series and a batch of three."""
    k = kernels.IndependentMultiOutput(_children(R.KERNELS[kname]))
    assert k.output_dim == len(R.KERNELS[kname])
    t = torch.as_tensor(R.kernel_grids()[grid])
    tag = f"kernels/{kname}/{grid}"
    with torch.no_grad():
        got = dict(zip(("F", "c", "Q"), k.prior_arrays_tl(t)))
        got.update(zip(("Fc", "cc", "Qc", "mu0", "P0"),
                       k.prior_const_tl(t[..., 1:2] - t[..., :1])))
        got["H"] = k.generate_emission_model(t).emission_matrix
        ssm = k.state_space_model(t)
    for key, val in got.items():
        want = refs[f"{tag}/{key}"]
        assert val.shape == want.shape, key
        np.testing.assert_allclose(_np(val), want, atol=STEPS_ATOL, rtol=0, err_msg=key)
    for key in ("initial_mean", "state_transitions", "state_offsets"):
        np.testing.assert_allclose(_np(getattr(ssm, key)), refs[f"{tag}/{key}"],
                                   atol=STEPS_ATOL, rtol=0, err_msg=key)
    # the Cholesky factors through the covariances they factor: a factor's
    # small pivots (Q's first entry ~ dt^3) move more than Q does
    for key in ("cholesky_initial_covariance", "cholesky_process_covariances"):
        lg, lw = _np(getattr(ssm, key)), refs[f"{tag}/{key}"]
        np.testing.assert_allclose(lg @ np.swapaxes(lg, -1, -2),
                                   lw @ np.swapaxes(lw, -1, -2), atol=STEPS_ATOL, rtol=0,
                                   err_msg=key)


def test_independent_multi_output_emission_is_block_diagonal_and_expanded():
    k = kernels.IndependentMultiOutput(_children(R.MO3))
    h = k.generate_emission_model(torch.linspace(0.0, 1.0, 11, dtype=torch.float64))
    assert h.emission_matrix.shape == (11, 3, 6)
    assert h.emission_matrix.stride(-3) == 0
    want = np.zeros((3, 6))
    want[0, 0] = want[1, 2] = want[2, 4] = 1.0
    np.testing.assert_array_equal(_np(h.emission_matrix[0]), want)


# ---------------------------------------------------------------------------
# GPR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_gpr_log_likelihood_matches_jax(refs, name):
    m = _model(name, refs)
    assert m._uniform_grid == bool(refs[f"{name}/uniform"]) == R.CONFIGS[name][3]
    with torch.no_grad():
        np.testing.assert_allclose(_np(m.log_likelihood()), refs[f"{name}/loglik"],
                                   rtol=LOGLIK_RTOL)
        np.testing.assert_allclose(_np(m.loss()), -refs[f"{name}/loglik"],
                                   rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_gpr_gradients_match_jax(refs, name):
    """Every kernel hyperparameter's gradient (the noise Cholesky is a
    buffer, as at o = 1), through the plain versions of the Koopman
    backwards."""
    m = _model(name, refs)
    m.loss().sum().backward()
    assert m.chol_obs_covariance.grad is None
    for i, child in enumerate(m.kernel.kernels):
        for p in ("lengthscale", "variance"):
            key = f"kernel.kernels[{i}].{p}"
            np.testing.assert_allclose(_np(getattr(child, p).unconstrained.grad),
                                       refs[f"{name}/grad {key}"], rtol=GRAD_RTOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(R.CONFIGS))
def test_gpr_posterior_marginals_match_jax(refs, name):
    m = _model(name, refs)
    with torch.no_grad():
        means, covs = m.kalman.posterior_marginals()
    for got, key in ((means, "marg_means"), (covs, "marg_covs")):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


PREDICTED = sorted(n for n in R.CONFIGS if not R.CONFIGS[n][2])


@pytest.mark.parametrize("full", [False, True], ids=["diag", "full_output_cov"])
@pytest.mark.parametrize("name", PREDICTED)
def test_gpr_predict_f_matches_jax(refs, name, full):
    m = _model(name, refs)
    t = torch.as_tensor(R.new_points(name))
    with torch.no_grad():
        mean, cov = m.posterior.predict_f(t, full_output_cov=full)
    keys = ("f_mean_full", "f_cov") if full else ("f_mean", "f_var")
    for got, key in zip((mean, cov), keys):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", PREDICTED)
def test_gpr_predict_y_matches_jax(refs, name):
    """Through MultivariateGaussian (full output covariances) at o > 1, the
    Gaussian likelihood at o = 1."""
    m = _model(name, refs)
    post = m.posterior
    o = R.output_dim(name)
    assert isinstance(post.likelihood, MultivariateGaussian) == (o > 1)
    with torch.no_grad():
        mean, cov = post.predict_y(torch.as_tensor(R.new_points(name)))
    for got, key in ((mean, "y_mean"), (cov, "y_cov")):
        want = refs[f"{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["mo3_uniform", "mo3_jittered"])
def test_gpr_sample_f_shapes_and_moments(refs, name):
    """4,000 joint draws of f at the new points: their means within 5
    standard errors of predict_f's, their variances within 5 standard
    errors of a variance's (sqrt(2 / n) relative)."""
    m = _model(name, refs)
    t = torch.as_tensor(R.new_points(name))
    n = 4000
    with torch.no_grad():
        post = m.posterior
        draws = post.sample_f(t, n, generator=torch.Generator().manual_seed(3))
        mean, var = post.predict_f(t)
    assert draws.shape == (n, t.shape[0], 3)
    assert torch.isfinite(draws).all()
    se = torch.sqrt(var / n)
    assert ((draws.mean(0) - mean).abs() <= 5.0 * se + 1e-12).all()
    rel = (draws.var(0) / var - 1.0).abs()
    assert (rel <= 5.0 * np.sqrt(2.0 / n)).all()


# ---------------------------------------------------------------------------
# MultivariateGaussian
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["log_probability_density", "variational_expectations",
                                    "predict_mean_and_var", "predict_density",
                                    "needs_full_cov"])
def test_multivariate_gaussian_matches_jax(refs, method):
    chol, f, fm, fc, y = (torch.as_tensor(a) for a in R.likelihood_inputs())
    lik = MultivariateGaussian(chol, dtype=torch.float64, device="cpu")
    assert lik.obs_dim == 3
    np.testing.assert_array_equal(_np(lik.chol_covariance.value), R.CHOL3)
    with torch.no_grad():
        got = {"log_probability_density": lambda: (lik.log_probability_density(f, y),),
               "variational_expectations": lambda: (lik.variational_expectations(fm, fc, y),),
               "predict_mean_and_var": lambda: lik.predict_mean_and_var(fm, fc),
               "predict_density": lambda: (lik.predict_density(fm, fc, y),),
               "needs_full_cov": lambda: (torch.as_tensor(lik.needs_full_cov),)}[method]()
    keys = {"predict_mean_and_var": ("predict_mean", "predict_cov")}.get(method, (method,))
    for g, key in zip(got, keys):
        want = refs[f"likelihood/{key}"]
        assert tuple(g.shape) == want.shape, key
        np.testing.assert_allclose(_np(g), want, rtol=1e-12, atol=1e-12, err_msg=key)


def test_multivariate_gaussian_cholesky_is_trainable():
    lik = MultivariateGaussian(R.CHOL3, dtype=torch.float64, device="cpu")
    f = torch.zeros((4, 3), dtype=torch.float64)
    lik.log_probability_density(f, f + 0.1).sum().backward()
    grad = lik.chol_covariance.unconstrained.grad
    assert grad.shape == (6,) and torch.isfinite(grad).all() and (grad != 0).any()


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------
def test_gpr_from_numpy_takes_multi_output_specs(refs):
    """The (combinator, names) spec builds the combinator of those children
    with the JAX parameters under kernel.kernels[i].*, and the o x o noise
    Cholesky."""
    m = _model("mixed_uniform", refs)
    assert isinstance(m.kernel, kernels.IndependentMultiOutput)
    assert [type(k).__name__ for k in m.kernel.kernels] == ["Matern12", "Matern32", "Matern52"]
    assert (m.kernel.state_dim, m.kernel.output_dim) == (6, 3)
    np.testing.assert_array_equal(_np(m.chol_obs_covariance), R.CHOL3)
    for i, (_, ell, var) in enumerate(R.MIXED):
        np.testing.assert_allclose(_np(m.kernel.kernels[i].lengthscale.value), ell, rtol=1e-12)
        np.testing.assert_allclose(_np(m.kernel.kernels[i].variance.value), var, rtol=1e-12)
    p = _model("product_32x32_jittered", refs)
    assert isinstance(p.kernel, kernels.Product)
    assert (p.kernel.state_dim, p.kernel.output_dim) == (4, 1)
    s = gpr_from_numpy({"chol_obs_covariance": np.eye(1)}, np.linspace(0.0, 1.0, 5),
                       np.zeros((5, 1)), device="cpu", dtype=torch.float64,
                       kernel=("Sum", ("Matern12", "Matern32")))
    assert isinstance(s.kernel, kernels.Sum) and s.kernel.state_dim == 3


# ---------------------------------------------------------------------------
# The plain versions of kernels 1, 3 and 7 at o x o sites against Pallas
# ---------------------------------------------------------------------------
def _mo_tensors(name):
    uni, gen = mo_inputs(name)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    return ([t(uni[k]) for k in INPUT_NAMES], [t(gen[k]) for k in GENERAL_INPUT_NAMES])


@pytest.mark.parametrize("kernel", ["uniform filter", "uniform Koopman backward",
                                    "general filter", "general Koopman backward"])
@pytest.mark.parametrize("name", sorted(MO_CASES))
def test_plain_kernels_at_o_sites_match_pallas(pallas_refs, name, kernel):
    """filter_pipeline_uniform_plain, adjoint_pipeline_uniform_plain,
    filter_pipeline_plain and adjoint_pipeline_plain at o = d = 2 and 3 with
    a full lam at every step (and a mask at d = 3), the backwards on the
    Pallas filters' moments."""
    uni, gen = _mo_tensors(name)
    gs = torch.from_numpy(np.asarray(mo_gscale(name)))
    key = f"mo:{name}/"
    ref = {k[len(key):]: v for k, v in pallas_refs.items() if k.startswith(key)}
    if kernel.endswith("filter"):
        pre, args = ("u_", uni) if kernel.startswith("uniform") else ("g_", gen)
        fn = cs.filter_pipeline_uniform_plain if pre == "u_" else cs.filter_pipeline_plain
        m_f, p_f, ll = fn(*args)
        np.testing.assert_allclose(_np(m_f), ref[pre + "m_f"], atol=PALLAS_ATOL, rtol=0)
        np.testing.assert_allclose(_np(p_f), ref[pre + "p_f"], atol=PALLAS_ATOL, rtol=0)
        np.testing.assert_allclose(_np(ll), ref[pre + "loglik"], rtol=PALLAS_LOGLIK_RTOL)
        return
    if kernel.startswith("uniform"):
        got = adj.adjoint_pipeline_uniform_plain(
            *uni, torch.from_numpy(ref["u_m_f"]), torch.from_numpy(ref["u_p_f"]), gs)
        names, pre = ADJOINT_NAMES, "u_"
    else:
        got = adj.adjoint_pipeline_plain(
            *gen, torch.from_numpy(ref["g_m_f"]), torch.from_numpy(ref["g_p_f"]), gs)
        names, pre = GADJOINT_NAMES, "g_"
    for g, k in zip(got, names):
        want = ref[pre + k]
        assert tuple(g.shape) == want.shape, k
        np.testing.assert_allclose(_np(g), want, atol=PALLAS_ATOL * max(1.0, np.abs(want).max()),
                                   rtol=0, err_msg=k)
