"""The port's Koopman gradients against the JAX package (float64, CPU).

* ``adjoint_pipeline_uniform_plain`` (the plain version of the uniform
  backward kernel) against ``pallas_adjoint_pipeline_uniform`` in interpret
  mode, all eight outputs, fed the Pallas filter's moments;
* the uniform likelihood's Koopman backward against autograd through the
  plain filter, an independent oracle;
* the general ``log_likelihood_koopman``: value and all six gradients
  against the JAX package's ``log_likelihood_koopman``.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from markovflow_tpu.ops.adjoint import \
    log_likelihood_koopman as j_log_likelihood_koopman  # noqa: E402
from markovflow_tpu_torch.ops import adjoint as adj  # noqa: E402
from markovflow_tpu_torch.ops.cuda_scan import \
    filter_pipeline_uniform_plain  # noqa: E402

from _pallas_refs import (ADJOINT_NAMES, GENERAL_CASES,  # noqa: E402
                          GENERAL_INPUT_NAMES, INPUT_NAMES, case_gscale,
                          case_inputs, general_inputs, run_refs)

ADJOINT_CASES = ("d1_n73", "d2_n64", "d3_n73", "d2_n73_masked", "d2_n64_batch3")
# concurrent reference processes, balanced by cost (d = 3 dominates)
GROUPS = (("adjoint:d3_n73", "adjoint:d1_n73"),
          ("adjoint:d2_n64", "adjoint:d2_n73_masked", "adjoint:d2_n64_batch3"))
ATOL = 1e-10          # the same function; sums of N terms in another order
ORACLE_RTOL = 1e-8    # Koopman score against autograd through the scans
VALUE_RTOL = 1e-10
GRAD_RTOL = 1e-8


@pytest.fixture(scope="module")
def adjoint_refs(tmp_path_factory):
    return run_refs(tmp_path_factory.mktemp("adjoint_refs"), GROUPS)


def _inputs(name, requires_grad=False):
    return [None if v is None else
            torch.from_numpy(v).requires_grad_(requires_grad and k != "maskf")
            for k, v in ((k, case_inputs(name)[k]) for k in INPUT_NAMES)]


@pytest.mark.parametrize("name", ADJOINT_CASES)
def test_adjoint_plain_matches_pallas(adjoint_refs, name):
    ref = {k.split("/")[1]: v for k, v in adjoint_refs.items()
           if k.startswith(f"adjoint:{name}/")}
    got = adj.adjoint_pipeline_uniform_plain(
        *_inputs(name), torch.from_numpy(ref["m_f"]), torch.from_numpy(ref["p_f"]),
        torch.from_numpy(case_gscale(name)))
    for key, g in zip(ADJOINT_NAMES, got):
        assert g.shape == ref[key].shape, key
        np.testing.assert_allclose(g.numpy(), ref[key], atol=ATOL, rtol=0,
                                   err_msg=key)


def _sym(g):
    return 0.5 * (g + g.transpose(-3, -2))


@pytest.mark.parametrize("name", ["d1_n73", "d3_n64", "d2_n73_masked",
                                  "d2_n64_batch3"])
def test_koopman_backward_matches_autograd(name):
    """The Koopman score of the uniform likelihood equals autograd through
    the plain filter.  Its (Q, Lam) cotangents are the symmetric extensions
    (the score is defined on symmetric matrices), so the symmetric inputs'
    gradients are compared by their symmetric parts.  A masked step carries
    no site (nu = 0, lam = 0), as the score's derivation assumes, and the
    score sets its site gradients to zero: those are compared on the kept
    steps."""
    x = _inputs(name)
    maskf = x[-1]
    if maskf is not None:
        x[6], x[7] = x[6] * maskf, x[7] * maskf
    x = [None if v is None else v.requires_grad_(k != "maskf")
         for k, v in zip(INPUT_NAMES, x)]
    weights = torch.from_numpy(case_gscale(name))
    mask = None if maskf is None else maskf[..., 0, 0, :] > 0.5
    ll = adj.log_likelihood_koopman_uniform(*x[:-1], mask)
    got = torch.autograd.grad((weights * ll).sum(), x[:-1])
    ll_ref = filter_pipeline_uniform_plain(*x)[2]
    want = torch.autograd.grad((weights * ll_ref).sum(), x[:-1])
    np.testing.assert_allclose(ll.detach().numpy(), ll_ref.detach().numpy(),
                               rtol=1e-12)
    for key, g, w in zip(INPUT_NAMES, got, want):
        if key in ("qc", "p0", "lam"):
            g, w = _sym(g), _sym(w)
        if key in ("nu", "lam") and maskf is not None:
            g, w = g * maskf, w * maskf
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ORACLE_RTOL,
                                   atol=ORACLE_RTOL * float(w.abs().max()),
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(GENERAL_CASES))
def test_general_log_likelihood_koopman_matches_jax(name):
    x = general_inputs(name)
    arrays = [x[k] for k in GENERAL_INPUT_NAMES[:-1]]
    mask = None if x["maskf"] is None else x["maskf"][..., 0, 0, :] > 0.5
    batch = GENERAL_CASES[name][2]
    weights = np.linspace(0.7, -1.3, int(np.prod(batch))).reshape(batch)

    def j_loss(*a):
        return jnp.sum(weights * j_log_likelihood_koopman(*a, mask=mask))
    j_val, j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(6))))(*(jnp.asarray(a) for a in arrays))
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    t_val = (torch.from_numpy(weights) * adj.log_likelihood_koopman(
        *t_args, None if mask is None else torch.from_numpy(mask))).sum()
    t_grads = torch.autograd.grad(t_val, t_args)
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=VALUE_RTOL)
    for key, g, w in zip(GENERAL_INPUT_NAMES, t_grads, j_grads):
        w = np.array(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=key)
