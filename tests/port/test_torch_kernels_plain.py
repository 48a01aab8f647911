"""The plain PyTorch versions of the port's filter and smoother kernels
against the JAX package's Pallas kernels, run in interpret mode (float64,
CPU).

* ``filter_pipeline_uniform_plain`` against ``pallas_filter_pipeline_uniform``;
* ``smoother_pipeline_uniform_plain`` against
  ``pallas_smoother_pipeline_uniform`` (both fed the Pallas filter's output);
* ``filter_pipeline_plain`` against ``pallas_filter_pipeline`` and
  ``smoother_scan_plain`` against ``pallas_smoother_scan`` (general grid).

The Pallas references run in fresh processes (``_pallas_refs.py``), as
``tests.tools.isolated`` runs the JAX suite's interpret-mode tests.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch.ops.cuda_scan import (  # noqa: E402
    filter_pipeline, filter_pipeline_plain, filter_pipeline_uniform,
    filter_pipeline_uniform_plain, smoother_pipeline_uniform,
    smoother_pipeline_uniform_plain, smoother_scan, smoother_scan_plain)

from _pallas_refs import (CASES, GENERAL_CASES, GENERAL_INPUT_NAMES,  # noqa: E402
                          INPUT_NAMES, case_inputs, general_inputs, run_refs,
                          scan_inputs)

# concurrent reference processes, balanced by cost (d = 3 dominates)
GROUPS = (("d3_n64", "d1_n64", "d1_n73"), ("d3_n73", "d2_n64"),
          ("d2_n73", "d2_n73_masked", "d2_n64_batch3"), tuple(GENERAL_CASES))
assert sorted(sum(GROUPS, ())) == sorted(CASES) + sorted(GENERAL_CASES)

# float64 values agree to roundoff: the plain version scans in another
# bracketing than the Pallas kernel's sequential runs + lane scan
ATOL = 1e-10
LOGLIK_RTOL = 1e-12


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("pallas_refs"), GROUPS)


def _inputs(name):
    return [None if v is None else torch.from_numpy(v)
            for v in (case_inputs(name)[k] for k in INPUT_NAMES)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_filter_plain_matches_pallas(pallas_refs, name):
    m_f, p_f, ll = filter_pipeline_uniform_plain(*_inputs(name))
    np.testing.assert_allclose(m_f.numpy(), pallas_refs[f"{name}/m_f"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_f.numpy(), pallas_refs[f"{name}/p_f"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ll.numpy(), pallas_refs[f"{name}/loglik"],
                               rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_smoother_plain_matches_pallas(pallas_refs, name):
    fc, cc, qc = _inputs(name)[:3]
    m_f = torch.from_numpy(pallas_refs[f"{name}/m_f"])
    p_f = torch.from_numpy(pallas_refs[f"{name}/p_f"])
    m_s, p_s = smoother_pipeline_uniform_plain(fc, cc, qc, m_f, p_f)
    np.testing.assert_allclose(m_s.numpy(), pallas_refs[f"{name}/m_s"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_s.numpy(), pallas_refs[f"{name}/p_s"], atol=ATOL, rtol=0)


def _general(name):
    return [None if v is None else torch.from_numpy(v)
            for v in (general_inputs(name)[k] for k in GENERAL_INPUT_NAMES)]


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_general_filter_plain_matches_pallas(pallas_refs, name):
    m_f, p_f, ll = filter_pipeline_plain(*_general(name))
    np.testing.assert_allclose(m_f.numpy(), pallas_refs[f"{name}/m_f"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_f.numpy(), pallas_refs[f"{name}/p_f"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ll.numpy(), pallas_refs[f"{name}/loglik"],
                               rtol=LOGLIK_RTOL)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_smoother_scan_plain_matches_pallas(pallas_refs, name):
    m_s, p_s = smoother_scan_plain(*(torch.from_numpy(x) for x in scan_inputs(name)))
    np.testing.assert_allclose(m_s.numpy(), pallas_refs[f"{name}/m_s"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_s.numpy(), pallas_refs[f"{name}/p_s"], atol=ATOL, rtol=0)


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the wrappers return exactly the plain versions'
    results and launch nothing."""
    args = _inputs("d2_n73_masked")
    before = (filter_pipeline_uniform.launches, smoother_pipeline_uniform.launches)
    got = filter_pipeline_uniform(*args)
    want = filter_pipeline_uniform_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fc, cc, qc = args[:3]
    for g, w in zip(smoother_pipeline_uniform(fc, cc, qc, *want[:2]),
                    smoother_pipeline_uniform_plain(fc, cc, qc, *want[:2])):
        assert torch.equal(g, w)
    assert (filter_pipeline_uniform.launches,
            smoother_pipeline_uniform.launches) == before


def test_general_wrappers_take_the_plain_versions_on_cpu():
    args = _general("g_d2_n73_masked")
    elems = [torch.from_numpy(x) for x in scan_inputs("g_d2_n73_masked")]
    before = (filter_pipeline.launches, smoother_scan.launches)
    for g, w in zip(filter_pipeline(*args), filter_pipeline_plain(*args)):
        assert torch.equal(g, w)
    for g, w in zip(smoother_scan(*elems), smoother_scan_plain(*elems)):
        assert torch.equal(g, w)
    assert (filter_pipeline.launches, smoother_scan.launches) == before
