"""The plain PyTorch versions of the port's filter and smoother kernels at
state dims 7..12 against the JAX package's Pallas kernels in interpret mode
(float64, CPU), as ``test_torch_kernels_plain.py`` holds them at d <= 3:

* ``filter_pipeline_uniform_plain`` / ``smoother_pipeline_uniform_plain``
  against ``pallas_filter_pipeline_uniform`` /
  ``pallas_smoother_pipeline_uniform`` (the smoother fed the Pallas
  filter's output);
* ``filter_pipeline_plain`` / ``smoother_scan_plain`` against
  ``pallas_filter_pipeline`` / ``pallas_smoother_scan``.

The Pallas kernels unroll their d x d products, so their interpret-mode
compile grows as d^3: one reference process per case, all at once.  d = 7
and d = 9 run in the fast tier; d = 12 (some 6 to 8 minutes of compile
per case) is in the slow tier, as the JAX package's own interpret-mode
Pallas grids are.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch.ops.cuda_scan import (  # noqa: E402
    filter_pipeline_plain, filter_pipeline_uniform_plain,
    smoother_pipeline_uniform_plain, smoother_scan_plain)

from _pallas_refs import (GENERAL_INPUT_NAMES, INPUT_NAMES,  # noqa: E402
                          WIDE_CASES, WIDE_GENERAL_CASES, case_inputs,
                          general_inputs, run_refs, scan_inputs)

FAST = ("d7_n37", "d9_n37_masked")
FAST_GENERAL = ("g_d7_n37", "g_d9_n37_masked")
SLOW = ("d12_n37", "g_d12_n37")
assert sorted(FAST + FAST_GENERAL + SLOW) == sorted({**WIDE_CASES, **WIDE_GENERAL_CASES})

# float64 values agree to roundoff, as at d <= 3
ATOL = 1e-10
LOGLIK_RTOL = 1e-12


@pytest.fixture(scope="module")
def wide_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("wide_refs"),
                    [(name,) for name in FAST + FAST_GENERAL])


@pytest.fixture(scope="module")
def d12_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("d12_refs"),
                    [(name,) for name in SLOW])


def _uniform(name):
    return [None if v is None else torch.from_numpy(v)
            for v in (case_inputs(name)[k] for k in INPUT_NAMES)]


def _general(name):
    return [None if v is None else torch.from_numpy(v)
            for v in (general_inputs(name)[k] for k in GENERAL_INPUT_NAMES)]


def _close(got, refs, name, keys):
    for g, key in zip(got, keys):
        want = refs[f"{name}/{key}"]
        assert g.shape == want.shape, key
        if key == "loglik":
            np.testing.assert_allclose(g.numpy(), want, rtol=LOGLIK_RTOL)
        else:
            np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=0,
                                       err_msg=key)


def _check_filter(refs, name):
    _close(filter_pipeline_uniform_plain(*_uniform(name)), refs, name,
           ("m_f", "p_f", "loglik"))


def _check_smoother(refs, name):
    fc, cc, qc = _uniform(name)[:3]
    m_f = torch.from_numpy(refs[f"{name}/m_f"])
    p_f = torch.from_numpy(refs[f"{name}/p_f"])
    _close(smoother_pipeline_uniform_plain(fc, cc, qc, m_f, p_f), refs, name,
           ("m_s", "p_s"))


def _check_general_filter(refs, name):
    _close(filter_pipeline_plain(*_general(name)), refs, name,
           ("m_f", "p_f", "loglik"))


def _check_smoother_scan(refs, name):
    got = smoother_scan_plain(*(torch.from_numpy(x) for x in scan_inputs(name)))
    _close(got, refs, name, ("m_s", "p_s"))


@pytest.mark.parametrize("name", FAST)
def test_filter_plain_matches_pallas_above_d6(wide_refs, name):
    _check_filter(wide_refs, name)


@pytest.mark.parametrize("name", FAST)
def test_smoother_plain_matches_pallas_above_d6(wide_refs, name):
    _check_smoother(wide_refs, name)


@pytest.mark.parametrize("name", FAST_GENERAL)
def test_general_filter_plain_matches_pallas_above_d6(wide_refs, name):
    _check_general_filter(wide_refs, name)


@pytest.mark.parametrize("name", FAST_GENERAL)
def test_smoother_scan_plain_matches_pallas_above_d6(wide_refs, name):
    _check_smoother_scan(wide_refs, name)


@pytest.mark.slow
@pytest.mark.parametrize("check", [_check_filter, _check_smoother],
                         ids=["filter", "smoother"])
def test_uniform_plain_matches_pallas_at_d12(d12_refs, check):
    check(d12_refs, "d12_n37")


@pytest.mark.slow
@pytest.mark.parametrize("check", [_check_general_filter, _check_smoother_scan],
                         ids=["filter", "smoother_scan"])
def test_general_plain_matches_pallas_at_d12(d12_refs, check):
    check(d12_refs, "g_d12_n37")
