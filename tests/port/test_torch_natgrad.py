"""The port's natural-gradient family against the JAX package's (float64,
CPU): the Bernoulli VGP's steps with both naturals engines, plain and with
momentum; the SVGP's ELBO and one step; a state-space model's precision
and normalizer; CVI's ``dist_q_naturals``.  The models are built from one
numpy seed (``_natgrad_refs``), the port's through ``convert``; the JAX
references run in fresh processes (``_natgrad_refs.run_refs``).  And the
port alone: with a Gaussian likelihood one gamma = 1 VGP step lands on the
GPR posterior, whose ELBO is the GPR log-likelihood."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch.convert import (cvi_from_numpy, gpr_from_numpy,  # noqa: E402
                                          ssm_from_numpy, svgp_from_numpy, vgp_from_numpy)
from markovflow_tpu_torch.ssm_natgrad import SSMNaturalGradient  # noqa: E402
from markovflow_tpu_torch.state_space_model import StateSpaceModel  # noqa: E402
from markovflow_tpu_torch.utils.bijectors import positive  # noqa: E402
from _natgrad_refs import (ENGINES, FIELDS, GAMMA, LENGTHSCALE, N, NOISE_VARIANCE,  # noqa: E402
                           STEPS, VARIANCE, cvi_sites, run_refs, svgp_data, vgp_data)
from _ssm_cases import _close, _t, ssm_arrays  # noqa: E402

#: the new SSM's fields, on their largest entry's scale
FIELD_ATOL = 1e-8
#: ELBOs and losses, relative
ELBO_RTOL = 1e-10
#: the parallel engine against the sequential one (both packages'
#: engines agree to this)
ENGINE_ATOL = 1e-8


def _params(gaussian=False):
    keys = ["kernel.lengthscale", "kernel.variance"]
    values = [LENGTHSCALE, VARIANCE]
    if gaussian:
        keys.append("likelihood.variance")
        values.append(NOISE_VARIANCE)
    return {k: positive().inverse(np.asarray(v)) for k, v in zip(keys, values)}


def _fields(ssm):
    return [getattr(ssm, f) for f in FIELDS]


def _vgp(likelihood="Bernoulli"):
    x, y = vgp_data()
    if likelihood == "Gaussian":
        y = np.sin(2.0 * x)[:, None] + 0.3 * np.random.default_rng(3).standard_normal((N, 1))
    return vgp_from_numpy(_params(likelihood == "Gaussian"), x, y, dtype=torch.float64,
                          device="cpu", likelihood=likelihood), x, y


def _svgp():
    x, y, z = svgp_data()
    m = svgp_from_numpy(_params(True), z, dtype=torch.float64, device="cpu",
                        likelihood="Gaussian", num_data=2 * N)
    return m, (_t(x), _t(y))


def _run(opt, loss_fn, ssm, steps):
    """The SSMs and losses of ``steps`` steps of ``opt.make_step``."""
    step, state, out = opt.make_step(loss_fn), opt.init(ssm), []
    for _ in range(steps):
        ssm, state, loss = step(ssm, state)
        out.append((ssm, loss))
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("natgrad_refs"))


def test_vgp_elbo_at_the_prior_matches_jax(refs):
    vgp, _, _ = _vgp()
    _close(vgp.elbo(), refs["vgp/elbo0"], atol=0.0, rtol=ELBO_RTOL)


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_vgp_natgrad_steps_match_jax(refs, engine, momentum):
    vgp, _, _ = _vgp()
    opt = SSMNaturalGradient(gamma=GAMMA, momentum=momentum, naturals_engine=engine)
    for i, (ssm, loss) in enumerate(_run(opt, lambda s: vgp.with_dist_q(s).loss(),
                                         vgp.dist_q.non_trainable_copy(), STEPS)):
        tag = f"vgp/{engine}/{momentum}/{i}"
        _close(loss, refs[f"{tag}/loss"], atol=0.0, rtol=ELBO_RTOL)
        for f, got in zip(FIELDS, _fields(ssm)):
            _close(got, refs[f"{tag}/{f}"], atol=FIELD_ATOL)


@pytest.mark.parametrize("momentum", [False, True])
def test_parallel_engine_matches_sequential(momentum):
    vgp, _, _ = _vgp()
    runs = {}
    for engine in ENGINES:
        opt = SSMNaturalGradient(gamma=GAMMA, momentum=momentum, naturals_engine=engine)
        runs[engine] = _run(opt, lambda s: vgp.with_dist_q(s).loss(),
                            vgp.dist_q.non_trainable_copy(), 3)
    for (s_seq, l_seq), (s_par, l_par) in zip(runs["sequential"], runs["parallel"]):
        _close(l_par, l_seq, atol=0.0, rtol=ELBO_RTOL)
        for got, want in zip(_fields(s_par), _fields(s_seq)):
            _close(got, want.detach(), atol=ENGINE_ATOL)


@pytest.mark.parametrize("engine", ENGINES)
def test_vgp_gaussian_gamma_one_step_reaches_gpr(engine):
    """q after one gamma = 1 step is the exact posterior: its ELBO is the
    GPR log-likelihood (relative 1e-8), and its marginals the smoother's."""
    vgp, x, y = _vgp("Gaussian")
    opt = SSMNaturalGradient(gamma=1.0, naturals_engine=engine)
    (ssm, _), = _run(opt, lambda s: vgp.with_dist_q(s).loss(),
                     vgp.dist_q.non_trainable_copy(), 1)
    gpr = gpr_from_numpy({**_params(), "chol_obs_covariance": np.sqrt([[NOISE_VARIANCE]])},
                         x, y, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        elbo, ll = vgp.with_dist_q(ssm).elbo(), gpr.log_likelihood()
        marg = gpr.kalman.posterior_marginals()
    _close(elbo, ll, atol=0.0, rtol=1e-8)
    _close(ssm.marginal_means, marg[0], atol=1e-8)
    _close(ssm.marginal_covariances, marg[1], atol=1e-8)


def test_svgp_elbo_at_the_prior_matches_jax(refs):
    svgp, data = _svgp()
    _close(svgp.elbo(data), refs["svgp/elbo0"], atol=0.0, rtol=ELBO_RTOL)


@pytest.mark.parametrize("engine", ENGINES)
def test_svgp_step_matches_jax(refs, engine):
    svgp, data = _svgp()
    opt = SSMNaturalGradient(gamma=GAMMA, naturals_engine=engine)
    (ssm, loss), = _run(opt, lambda s: svgp.with_dist_q(s).loss(data),
                        svgp.dist_q.non_trainable_copy(), 1)
    _close(loss, refs[f"svgp/{engine}/loss"], atol=0.0, rtol=ELBO_RTOL)
    for f, got in zip(FIELDS, _fields(ssm)):
        _close(got, refs[f"svgp/{engine}/{f}"], atol=FIELD_ATOL)
    with torch.no_grad():
        _close(svgp.with_dist_q(ssm).elbo(data), refs[f"svgp/{engine}/elbo"], atol=0.0,
               rtol=ELBO_RTOL)
        assert svgp.with_dist_q(ssm).elbo(data) > svgp.elbo(data)


def test_precision_and_normalizer_match_jax(refs):
    ssm = ssm_from_numpy(ssm_arrays(2, (2,), 5), dtype=torch.float64, device="cpu")
    prec = ssm.precision()
    _close(prec.diag, refs["svgp/precision/diag"])
    _close(prec.lower, refs["svgp/precision/lower"])
    _close(ssm.normalizer, refs["svgp/normalizer"], atol=0.0, rtol=1e-10)
    dense = prec.to_dense()
    _close(dense @ torch.linalg.inv(dense), torch.eye(dense.shape[-1]).expand(dense.shape))


def test_dist_q_naturals_matches_jax_and_dist_q(refs):
    x, y = vgp_data()
    nat1, nat2 = cvi_sites()
    cvi = cvi_from_numpy({**_params(), "sites.nat1": nat1, "sites.nat2": nat2}, x, y,
                         dtype=torch.float64, device="cpu", likelihood="Bernoulli")
    with torch.no_grad():
        naturals, direct = cvi.dist_q_naturals, cvi.dist_q
    for f, got in zip(FIELDS, _fields(naturals)):
        _close(got, refs[f"svgp/dist_q_naturals/{f}"], atol=FIELD_ATOL)
    assert isinstance(naturals, StateSpaceModel)
    for got, want in zip(naturals.marginals, direct.marginals):
        _close(got, want, atol=FIELD_ATOL)
