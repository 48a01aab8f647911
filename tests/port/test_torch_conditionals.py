"""The port's conditionals (off-grid prediction of the states) against the
JAX package's (float64, CPU), at inner points, exact hits and points past
either end; and the extrapolation's finiteness in float32 (port only).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu import conditionals as jc  # noqa: E402
from markovflow_tpu import state_space_model as jssm  # noqa: E402
from markovflow_tpu_torch import conditionals as tc  # noqa: E402
from markovflow_tpu_torch import kernels as tk  # noqa: E402
from markovflow_tpu_torch import state_space_model as tssm  # noqa: E402
from _ssm_cases import KERNELS, _close, _t, kernel_pair, ssm_arrays  # noqa: E402

N = 40


def new_points(x, rng, gap=0.0):
    """Inner points, three exact hits (first, inner, last), and points past
    either end, near and far; none of them within ``gap`` of an existing
    point but the hits."""
    inner = rng.random(200) * (x[-1] - x[0]) + x[0]
    inner = inner[np.abs(inner[:, None] - x[None, :]).min(-1) >= gap][:25]
    near = max(gap, 1e-3)
    return np.concatenate([[-1e4, -3.0, x[0] - near], x[[0, 17, N - 1]], inner,
                           [x[-1] + near, x[-1] + 5.0, 1e4]])


def _jax_outputs(kernel, dist, x, xs):
    stats = jc.conditional_statistics(xs, x, kernel)
    mu = kernel.initial_mean(x.shape[:-1])
    p_inf = kernel.initial_covariance(x[..., :1])
    return {"stats": stats, "pairs": jc.pairwise_marginals(dist, mu, p_inf),
            "predict": jc.conditional_predict(xs, x, kernel, dist),
            "predict_tl": jc.conditional_predict_tl(xs, x, kernel, dist)}


_JAX = jax.jit(_jax_outputs)


#: Matern52's process noise is the generic P_inf - A P_inf A^T in both
#: packages: at a step dt its value ~dt^5 keeps only the digits above the
#: roundoff of its O(1) operands (3 of them at dt = 1e-3), which the
#: conditional statistics divide by.  The two packages round it
#: differently, so for Matern52 the new points keep 0.05 from the existing
#: ones, where Q holds 12 digits (ROADMAP queue 3).  The posterior tests
#: take near points for every kernel: there the statistics meet the
#: posterior's own pair moments.
GAP = {"Matern52": 0.05}


@pytest.fixture(scope="module", params=sorted(KERNELS))
def case(request):
    """A kernel, a random SSM over its N points (the batch shape is the time
    points', which the JAX package takes unbatched here), the points and
    the new points, and the JAX outputs."""
    name = request.param
    jkern, tkern = kernel_pair(KERNELS[name])
    rng = np.random.default_rng(sorted(KERNELS).index(name))
    x = np.sort(rng.random(N) * 10.0)
    xs = new_points(x, rng, GAP.get(name, 0.0))
    arrays = ssm_arrays(tkern.state_dim, (), 2, N - 1)
    want = _JAX(jkern, jssm.StateSpaceModel(*arrays), x, xs)
    return tkern, tssm.StateSpaceModel(*map(_t, arrays)), _t(x), _t(xs), want


def test_conditional_statistics_match_jax(case):
    tkern, _, x, xs, want = case
    with torch.no_grad():
        got = tc.conditional_statistics(xs, x, tkern)
    for g, w in zip(got[:3], want["stats"][:3]):
        _close(g, w)
    assert torch.equal(got[3], torch.as_tensor(np.array(want["stats"][3])))


def test_pairwise_marginals_match_jax(case):
    tkern, dist, x, _, want = case
    with torch.no_grad():
        got = tc.pairwise_marginals(dist, tkern.initial_mean(tuple(x.shape[:-1])),
                                    tkern.initial_covariance(x[..., :1]))
    for g, w in zip(got, want["pairs"]):
        _close(g, w)


def test_conditional_predict_matches_jax(case):
    tkern, dist, x, xs, want = case
    with torch.no_grad():
        for g, w in zip(tc.conditional_predict(xs, x, tkern, dist), want["predict"]):
            _close(g, w)
        for g, w in zip(tc.conditional_predict_tl(xs, x, tkern, dist), want["predict_tl"]):
            _close(g, w)


def test_statistics_from_transitions_and_base_predict_match_jax():
    rng = np.random.default_rng(4)
    d, n = 2, 9
    a = 0.5 * rng.standard_normal((2, n, d, d))
    lq = rng.standard_normal((2, n, d, d))
    q = lq @ np.swapaxes(lq, -1, -2) + 0.1 * np.eye(d)
    b = rng.standard_normal((2, n, d))
    args = (a[0], q[0], b[0], a[1], q[1], b[1])
    want = jc._conditional_statistics_from_transitions(*args)
    got = tc._conditional_statistics_from_transitions(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w)
    m = rng.standard_normal((n, 2 * d))
    s = rng.standard_normal((n, 2 * d, 2 * d))
    s = s @ np.swapaxes(s, -1, -2)
    for g, w in zip(tc.base_conditional_predict(*map(_t, (*want, m, s))),
                    jc.base_conditional_predict(*want, m, s)):
        _close(g, w)


def _prior_kernel(name, dtype):
    if name == "d9":
        return tk.Sum([tk.Matern52(lengthscale=ell, variance=var, dtype=dtype,
                                   device="cpu")
                       for ell, var in ((0.5, 1.0), (2.0, 0.5), (8.0, 0.25))])
    return getattr(tk, name)(lengthscale=0.5, variance=1.0, dtype=dtype, device="cpu")


def _prior_case(name, dtype):
    """A port kernel in ``dtype`` on linspace(0, 10, 101), with its prior
    there as the distribution: made in float64 and cast (the d9 model's
    generic process noise cancels in float32 at these steps, and its
    Cholesky factor fails)."""
    x = torch.linspace(0.0, 10.0, 101, dtype=torch.float64)
    prior = _prior_kernel(name, torch.float64).state_space_model(x)
    cast = tssm.StateSpaceModel(*(v.detach().to(dtype) for v in (
        prior.initial_mean, prior.cholesky_initial_covariance, prior.state_transitions,
        prior.state_offsets, prior.cholesky_process_covariances)))
    return _prior_kernel(name, dtype), x.to(dtype), cast


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52", "d9"])
def test_extrapolation_and_exact_hits_are_finite_and_revert_to_the_prior(name, dtype):
    """Past either end the phantom neighbours sit at -/+ 1e10: the closed
    forms see a = lam * 1e10, where a power of a that overflowed would make
    inf * exp(-a) = NaN.  Every prediction is finite.  Given the prior as
    the distribution, the marginal at a point past either end or at an
    exact hit is the prior's (P_inf, mean 0); in float64 at the points
    near the grid too (in float32 the d9 model's generic process noise
    cancels there, ROADMAP queue 3)."""
    k, x, prior = _prior_case(name, dtype)
    far_and_hits = torch.cat([torch.tensor([-1e6, -50.0], dtype=dtype), x[[0, 30, -1]],
                              torch.tensor([60.0, 1e6], dtype=dtype)])
    near = torch.tensor([-1e-2, 3.05, 10.01], dtype=dtype)
    with torch.no_grad():
        means, covs = tc.conditional_predict_tl(torch.cat([far_and_hits, near]), x, k,
                                                prior)
        p_inf = k.steady_state_covariance[..., None].expand(covs.shape)
    assert torch.isfinite(means).all() and torch.isfinite(covs).all()
    checked = slice(None) if dtype == torch.float64 else slice(0, far_and_hits.numel())
    tol = 1e-9 if dtype == torch.float64 else 2e-6
    scale = float(p_inf.abs().max())
    assert float((covs - p_inf)[..., checked].abs().max()) <= tol * scale
    assert float(means[..., checked].abs().max()) <= tol * scale ** 0.5
