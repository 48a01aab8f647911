"""The filter-scan kernel's plain version and the port's time-middle Kalman
API against the JAX package (float64, CPU).

* ``filter_scan_plain`` against ``pallas_filter_scan`` in interpret mode,
  both fed the JAX package's filtering elements of a general case (d = 2
  aligned, d = 3 padded, d = 2 with a batch, d = 7);
* ``make_filter_elements``, ``parallel_filter``, ``sequential_filter``,
  ``predicted_moments``, ``log_likelihood_sites``, ``parallel_smoother``,
  ``sequential_smoother`` and ``posterior_ssm_params`` against the JAX
  functions of the same names;
* the wrapper takes the plain version on CPU tensors and launches nothing.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu.ops import kalman as jk  # noqa: E402
from markovflow_tpu_torch.ops import kalman as tk  # noqa: E402
from markovflow_tpu_torch.ops.cuda_scan import (filter_scan,  # noqa: E402
                                                filter_scan_plain)

from _pallas_refs import (ELEMENT_NAMES, GENERAL_CASES,  # noqa: E402
                          general_inputs, run_refs)

CASES = sorted(GENERAL_CASES) + ["g_d7_n37"]
# concurrent reference processes, balanced by cost (d = 7 dominates)
GROUPS = (("fscan:g_d7_n37",), ("fscan:g_d3_n73",),
          ("fscan:g_d2_n64", "fscan:g_d2_n73_masked"))
assert sorted(g.split(":")[1] for g in sum(GROUPS, ())) == sorted(CASES)
# float64 values agree to roundoff: the plain version scans in another
# bracketing than the Pallas kernel's sequential runs + lane scan
ATOL = 1e-10
LOGLIK_RTOL = 1e-12


@pytest.fixture(scope="module")
def fscan_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("fscan_refs"), GROUPS)


@pytest.mark.parametrize("name", CASES)
def test_filter_scan_plain_matches_pallas(fscan_refs, name):
    elems = [torch.from_numpy(fscan_refs[f"fscan:{name}/{k}"]) for k in ELEMENT_NAMES]
    m_f, p_f = filter_scan_plain(*elems)
    for key, got in (("m_f", m_f), ("p_f", p_f)):
        want = fscan_refs[f"fscan:{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=key)


def test_filter_scan_wrapper_takes_the_plain_version_on_cpu():
    x = general_inputs("g_d2_n73_masked")
    elems = tk.make_filter_elements_tl(*(torch.from_numpy(x[k]) for k in
                                         ("F", "c", "Q", "H", "nu", "lam")))
    before = filter_scan.launches
    for g, w in zip(filter_scan(*elems), filter_scan_plain(*elems)):
        assert torch.equal(g, w)
    assert filter_scan.launches == before


def _time_middle(name):
    """A general case's inputs in the JAX package's time-middle layout, as
    numpy arrays: F [..., N, d, d], c [..., N, d], Q, H [..., N, 1, d],
    nu [..., N, 1], lam [..., N, 1, 1], and the boolean mask [..., N] (or
    None)."""
    x = general_inputs(name)
    tm = lambda a: np.moveaxis(a, -1, -3)           # noqa: E731
    vec = lambda a: np.moveaxis(a[..., 0, :], -1, -2)  # noqa: E731
    mask = None if x["maskf"] is None else x["maskf"][..., 0, 0, :] > 0.5
    return (tm(x["F"]), vec(x["c"]), tm(x["Q"]), tm(x["H"]), vec(x["nu"]),
            tm(x["lam"]), mask)


def _close(got, want, atol=ATOL):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_time_middle_api_matches_jax(name):
    """The port's time-middle functions, chained as a user chains them, on
    the same inputs as the JAX package's: each output within 1e-10
    absolute, the site log-likelihood within 1e-12 relative."""
    F, c, Q, H, nu, lam, mask = _time_middle(name)
    j = [jnp.asarray(a) for a in (F, c, Q, H, nu, lam)]
    t = [torch.from_numpy(a) for a in (F, c, Q, H, nu, lam)]
    j_elems = jk.make_filter_elements(*j)
    t_elems = tk.make_filter_elements(*t)
    _close(t_elems, j_elems)
    j_m, j_p = jk.parallel_filter(j_elems)
    t_m, t_p = tk.parallel_filter(t_elems)
    _close((t_m, t_p), (j_m, j_p))
    _close(tk.sequential_filter(t_elems), jk.sequential_filter(j_elems))
    j_mp, j_pp = jk.predicted_moments(j[0], j[1], j[2], j_m, j_p)
    t_mp, t_pp = tk.predicted_moments(t[0], t[1], t[2], t_m, t_p)
    _close((t_mp, t_pp), (j_mp, j_pp))
    j_mask = None if mask is None else jnp.asarray(mask)
    t_mask = None if mask is None else torch.from_numpy(mask)
    np.testing.assert_allclose(
        tk.log_likelihood_sites(t[3], t[4], t[5], t_mp, t_pp, t_mask).numpy(),
        np.array(jk.log_likelihood_sites(j[3], j[4], j[5], j_mp, j_pp, j_mask)),
        rtol=LOGLIK_RTOL)
    j_sm = jk.parallel_smoother(j[0], j[1], j[2], j_m, j_p)
    t_sm = tk.parallel_smoother(t[0], t[1], t[2], t_m, t_p)
    _close(t_sm, j_sm)
    _close(tk.sequential_smoother(t[0], t[1], t[2], t_m, t_p),
           jk.sequential_smoother(j[0], j[1], j[2], j_m, j_p))
    _close(tk.posterior_ssm_params(*t_sm), jk.posterior_ssm_params(*j_sm))


def test_parallel_filter_matches_the_general_filter_pipeline():
    """One function, two routes: the ops API's filtered moments are the
    general filter's (the filter-scan kernel and the general filter kernel
    compute them on CUDA)."""
    from markovflow_tpu_torch.ops.cuda_scan import filter_pipeline
    x = general_inputs("g_d3_n73")
    args = [torch.from_numpy(x[k]) for k in ("F", "c", "Q", "H", "nu", "lam")]
    m_f, p_f, _ = filter_pipeline(*args)
    tm = _time_middle("g_d3_n73")
    got_m, got_p = tk.parallel_filter(tk.make_filter_elements(
        *(torch.from_numpy(a) for a in tm[:6])))
    torch.testing.assert_close(got_m, m_f[..., 0, :].movedim(-1, -2), rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, p_f.movedim(-1, -3), rtol=0, atol=ATOL)
