"""The port's SSM / expectation / natural transformations against the JAX
package's (float64, CPU, the same random stable SSMs from one numpy seed,
``_ssm_cases.ssm_arrays``): the nine public functions, both natural round
trips, the parallel naturals engine against the sequential one, and the
general filter's plain path at o x o sites (o = 2..d) against the JAX
``filter_pipeline_tl``.  Parameters within ATOL of the largest entry;
the parallel engine's within ATOL_PARALLEL of the sequential one's (its
filter and smoother compose in another order than the UDU recursion)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from markovflow_tpu import ssm_gaussian_transformations as jt  # noqa: E402
from markovflow_tpu.ops import kalman as jk  # noqa: E402
from markovflow_tpu.state_space_model import StateSpaceModel as JSSM  # noqa: E402
from markovflow_tpu_torch import ssm_gaussian_transformations as tt  # noqa: E402
from markovflow_tpu_torch.ops import cuda_scan  # noqa: E402
from markovflow_tpu_torch.state_space_model import StateSpaceModel as TSSM  # noqa: E402
from _ssm_cases import _close, _t, ssm_arrays  # noqa: E402

ATOL = 1e-10
ATOL_PARALLEL = 1e-9
#: the general filter's plain path against the JAX one: the same formulas
#: (make_filter_elements_tl, the scan, the lam-form likelihood), the same
#: bracketing; moments on their largest entry, the log-likelihood relative
ATOL_FILTER = 1e-10
CASES = [(1, ()), (2, ()), (2, (2,)), (3, ()), (4, (2,))]


def _pair(d, batch, seed=0, n=12):
    arrays = ssm_arrays(d, batch, seed, n)
    return TSSM(*(_t(a) for a in arrays)), JSSM(*(jnp.asarray(a) for a in arrays))


def _all_close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, atol=atol)


def _ssm_params(ssm):
    """(A_s, b_s, chol_P0, chol_Q_s, mu0), the order the *_params functions
    return."""
    return (ssm.state_transitions, ssm.state_offsets, ssm.cholesky_initial_covariance,
            ssm.cholesky_process_covariances, ssm.initial_mean)


@pytest.mark.parametrize("d,batch", CASES)
def test_expectations_match_jax_and_round_trip(d, batch):
    ts, js = _pair(d, batch)
    eta_t, eta_j = tt.ssm_to_expectations(ts), jt.ssm_to_expectations(js)
    _all_close(eta_t, eta_j)
    params = tt.expectations_to_ssm_params(*eta_t)
    _all_close(params, jt.expectations_to_ssm_params(*eta_j))
    _all_close(params, _ssm_params(ts))
    _all_close(_ssm_params(tt.expectations_to_ssm(*eta_t)), _ssm_params(ts))


@pytest.mark.parametrize("d,batch", CASES)
def test_naturals_match_jax_and_round_trip(d, batch):
    ts, js = _pair(d, batch)
    th_t, th_j = tt.ssm_to_naturals(ts), jt.ssm_to_naturals(js)
    _all_close(th_t, th_j)
    seq = tt.naturals_to_ssm_params(*th_t)
    _all_close(seq, jt.naturals_to_ssm_params(*th_j))
    _all_close(seq, _ssm_params(ts))
    _all_close(_ssm_params(tt.naturals_to_ssm(*th_t)), _ssm_params(ts))
    par = tt.naturals_to_ssm_params_parallel(*th_t)
    _all_close(par, seq, atol=ATOL_PARALLEL)
    _all_close(par, jt.naturals_to_ssm_params_parallel(*th_j), atol=ATOL_PARALLEL)


@pytest.mark.parametrize("d,batch", CASES)
def test_naturals_without_smoothing_match_jax_and_round_trip(d, batch):
    ts, js = _pair(d, batch)
    th_t = tt.ssm_to_naturals_no_smoothing(ts)
    _all_close(th_t, jt.ssm_to_naturals_no_smoothing(js))
    params = tt.naturals_to_ssm_params_no_smoothing(*th_t)
    _all_close(params, jt.naturals_to_ssm_params_no_smoothing(
        *jt.ssm_to_naturals_no_smoothing(js)))
    _all_close(params, _ssm_params(ts))


@pytest.mark.parametrize("d,batch", CASES)
def test_precision_and_naturals_agree(d, batch):
    """theta_diag = -1/2 diag(K^-1), theta_subdiag = -lower(K^-1), and
    theta_linear = K^-1 mu, against the precision built block by block."""
    ts, js = _pair(d, batch)
    th_lin, th_diag, th_sub = tt.ssm_to_naturals(ts)
    prec = ts.precision()
    _close(-0.5 * prec.diag, th_diag)
    _close(-prec.lower, th_sub)
    _close(prec.block_mult_vector(ts.marginal_means), th_lin)
    _close(prec.to_dense(), js.precision().to_dense())


@pytest.mark.parametrize("d,o", [(d, o) for d in range(2, 7) for o in range(2, d + 1)])
@pytest.mark.parametrize("const_sites", [False, True])
def test_general_filter_plain_at_o_sites_matches_jax(d, o, const_sites):
    """The wrapper's CPU path (its plain version) at o x o sites, masked,
    against the JAX package's filter_pipeline_tl."""
    args = chip_smoke.multi_output_problem(d, o, 40, (2,), torch.float64, seed=d + o,
                                           device="cpu", const_sites=const_sites)
    got = cuda_scan.filter_pipeline(*args)
    j = [jnp.asarray(x.expand((2,) + x.shape[-3:]).numpy()) for x in args[:6]]
    want = jax.jit(jk.filter_pipeline_tl)(*j, jnp.asarray(args[6][..., 0, 0, :].numpy() > 0.5))
    _close(got[0], want[0], atol=ATOL_FILTER)
    _close(got[1], want[1], atol=ATOL_FILTER)
    _close(got[2], want[2], atol=0.0, rtol=ATOL_FILTER)
