"""The port's Sum kernel against the JAX package's (float64, CPU): the prior
steps on a uniform grid (``prior_const_tl``) and on a random grid
(``prior_arrays_tl``), and the emission row, at state dims 4, 6 and 9."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import markovflow_tpu.kernels as jk  # noqa: E402
import markovflow_tpu_torch.kernels as tk  # noqa: E402
from markovflow_tpu.utils.linalg import block_diag as j_block_diag  # noqa: E402
from markovflow_tpu_torch.utils.linalg import block_diag  # noqa: E402

# state dim -> children (kernel, lengthscale, variance); 9 is the composite
# model Matern52(0.5, 1) + Matern52(2, 0.5) + Matern52(8, 0.25)
SUMS = {
    4: (("Matern12", 0.7, 1.3), ("Matern52", 1.5, 0.4)),
    6: (("Matern12", 0.7, 1.3), ("Matern32", 0.3, 0.9), ("Matern52", 2.0, 0.5)),
    9: (("Matern52", 0.5, 1.0), ("Matern52", 2.0, 0.5), ("Matern52", 8.0, 0.25)),
}
# the same closed forms and products, in another order
RTOL, ATOL = 1e-12, 1e-12


def _pair(d):
    """A JAX Sum and the port's, with the same unconstrained values."""
    jax_k = jk.Sum([getattr(jk, name)(lengthscale=ell, variance=var)
                    for name, ell, var in SUMS[d]])
    children = []
    for jax_child, (name, _, _) in zip(jax_k.kernels, SUMS[d]):
        child = getattr(tk, name)(dtype=torch.float64, device="cpu")
        with torch.no_grad():
            for p in ("lengthscale", "variance"):
                getattr(child, p).unconstrained.copy_(torch.as_tensor(
                    np.array(getattr(jax_child, p).unconstrained)))
        children.append(child)
    port_k = tk.Sum(children)
    assert port_k.state_dim == jax_k.state_dim == d
    return jax_k, port_k


def _close(got, want, labels):
    for g, w, label in zip(got, want, labels):
        w = np.array(w)
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("d", sorted(SUMS))
def test_sum_prior_const_tl_matches_jax(d):
    """dt = 1e-3 (T = 1e5 on [0, 100]): the generic Q = P_inf - A P_inf A^T
    of the whole state, as the JAX ConcatKernel computes it."""
    jax_k, port_k = _pair(d)
    want = jax_k.prior_const_tl(jnp.asarray([1e-3]))
    got = port_k.prior_const_tl(torch.tensor([1e-3], dtype=torch.float64))
    _close(got, want, ["Fc", "cc", "Qc", "mu0", "P0"])


@pytest.mark.parametrize("d", sorted(SUMS))
def test_sum_prior_arrays_tl_matches_jax(d):
    rng = np.random.default_rng(d)
    tp = np.cumsum(rng.random(40) * 0.2)
    jax_k, port_k = _pair(d)
    want = jax_k.prior_arrays_tl(jnp.asarray(tp))
    got = port_k.prior_arrays_tl(torch.from_numpy(tp))
    _close(got, want, ["F", "c", "Q"])


@pytest.mark.parametrize("d", sorted(SUMS))
def test_sum_emission_matches_jax(d):
    """H concatenates the children's rows, in the time points' dtype."""
    jax_k, port_k = _pair(d)
    tp = np.linspace(0.0, 1.0, 7)
    want = np.array(jax_k.generate_emission_model(jnp.asarray(tp)).emission_matrix)
    got = port_k.generate_emission_model(torch.from_numpy(tp)).emission_matrix
    assert got.dtype == torch.float64 and got.shape == want.shape == (7, 1, d)
    np.testing.assert_array_equal(got.numpy(), want)
    h32 = port_k.generate_emission_model(
        torch.from_numpy(tp).float()).emission_matrix
    assert h32.dtype == torch.float32


def test_add_builds_a_sum():
    """k1 + k2 + k3 nests Sums, as in the JAX package; the prior steps are
    those of the flat Sum of the three."""
    _, flat = _pair(9)
    nested = flat.kernels[0] + flat.kernels[1] + flat.kernels[2]
    assert isinstance(nested, tk.Sum) and nested.state_dim == 9
    dt = torch.tensor([1e-3], dtype=torch.float64)
    for g, w in zip(nested.prior_const_tl(dt), flat.prior_const_tl(dt)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_block_diag_matches_jax():
    rng = np.random.default_rng(3)
    blocks = [rng.standard_normal((2, 1, 3, 3)), rng.standard_normal((4, 2, 2)),
              rng.standard_normal((1, 1))]
    want = np.array(j_block_diag([jnp.asarray(b) for b in blocks]))
    got = block_diag([torch.from_numpy(b) for b in blocks])
    assert got.shape == want.shape == (2, 4, 6, 6)
    np.testing.assert_array_equal(got.numpy(), want)
