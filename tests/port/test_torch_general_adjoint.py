"""The general-grid Koopman backward kernel's plain version against the JAX
package's ``pallas_adjoint_pipeline`` in interpret mode (float64, CPU).

``adjoint_pipeline_plain`` (the plain stages around the plain reverse scan)
and the fused Pallas kernel get the same general case and the Pallas
filter's moments, with a per-row cotangent other than 1; all six per-step
gradients agree within 1e-10 absolute.  The cases: d = 2 aligned, d = 3
padded, d = 2 masked with a batch; d = 7 and d = 9 (masked, batch) in the
slow tier, whose references compile for minutes.  On CPU tensors the
wrapper returns the plain version's six gradients and launches nothing.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from markovflow_tpu_torch.ops import adjoint as adj  # noqa: E402

from _pallas_refs import (GADJOINT_NAMES, GENERAL_CASES,  # noqa: E402
                          GENERAL_INPUT_NAMES, general_gscale, general_inputs,
                          run_refs)

# concurrent reference processes, balanced by cost (d = 3 dominates)
GROUPS = (("gadjoint:g_d3_n73",),
          ("gadjoint:g_d2_n64", "gadjoint:g_d2_n73_masked"))
assert sorted(g.split(":")[1] for g in sum(GROUPS, ())) == sorted(GENERAL_CASES)
SLOW = ("g_d7_n37", "g_d9_n37_masked")
ATOL = 1e-10          # the same function, composed in another order


@pytest.fixture(scope="module")
def gadjoint_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("gadjoint_refs"), GROUPS)


@pytest.fixture(scope="module")
def wide_gadjoint_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("wide_gadjoint_refs"),
                    [(f"gadjoint:{name}",) for name in SLOW])


def _inputs(name):
    return [None if v is None else torch.from_numpy(v)
            for v in (general_inputs(name)[k] for k in GENERAL_INPUT_NAMES)]


def _check(refs, name):
    ref = {k.split("/")[1]: v for k, v in refs.items()
           if k.startswith(f"gadjoint:{name}/")}
    got = adj.adjoint_pipeline_plain(
        *_inputs(name), torch.from_numpy(ref["m_f"]), torch.from_numpy(ref["p_f"]),
        torch.from_numpy(general_gscale(name)))
    for key, g in zip(GADJOINT_NAMES, got):
        assert g.shape == ref[key].shape, key
        np.testing.assert_allclose(g.numpy(), ref[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_general_adjoint_plain_matches_pallas(gadjoint_refs, name):
    _check(gadjoint_refs, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_general_adjoint_plain_matches_pallas_above_d6(wide_gadjoint_refs, name):
    _check(wide_gadjoint_refs, name)


def test_adjoint_wrapper_takes_the_plain_version_on_cpu():
    args = _inputs("g_d2_n73_masked")
    m_f = torch.randn(2, 2, 1, 73, dtype=torch.float64)
    p_f = torch.eye(2, dtype=torch.float64)[..., None].expand(2, 2, 2, 73)
    gs = torch.tensor([0.3, -2.0], dtype=torch.float64)
    before = adj.adjoint_pipeline.launches
    got = adj.adjoint_pipeline(*args, m_f, p_f, gs, needs=(True,) + (False,) * 5)
    want = adj.adjoint_pipeline_plain(*args, m_f, p_f, gs)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert adj.adjoint_pipeline.launches == before
    drop = args[-1] <= 0.5     # [2, 1, 1, 73]
    for g in got[3:]:          # masked steps: zero observation gradients
        assert (g[drop.expand_as(g)] == 0).all()
