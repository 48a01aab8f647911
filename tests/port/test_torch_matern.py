"""The port's Matern kernels and parameters against the JAX package's
(float64, CPU): ``prior_const_tl`` on both sides of Matern32's series
cutoff, ``prior_arrays_tl`` on a random grid, and the softplus bijector."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import markovflow_tpu.kernels as jk  # noqa: E402
import markovflow_tpu_torch.kernels as tk  # noqa: E402
from markovflow_tpu.utils.bijectors import Positive as JPositive  # noqa: E402
from markovflow_tpu_torch.utils.bijectors import Positive  # noqa: E402

KERNELS = ["Matern12", "Matern32", "Matern52"]
# closed forms evaluated in another order: agreement to roundoff
RTOL, ATOL = 1e-12, 1e-14


def _pair(name, dtype=torch.float64, lengthscale=0.5, variance=1.3):
    """A JAX kernel and the port's, with the same unconstrained values."""
    jax_k = getattr(jk, name)(lengthscale=lengthscale, variance=variance)
    port_k = getattr(tk, name)(dtype=dtype, device="cpu")
    with torch.no_grad():
        for p in ("lengthscale", "variance"):
            getattr(port_k, p).unconstrained.copy_(torch.as_tensor(
                np.array(getattr(jax_k, p).unconstrained)))
    return jax_k, port_k


# Matern32 at lengthscale 0.5: a = sqrt(3) dt / 0.5, the float64 series
# cutoff a = 0.02 sits at dt ~ 0.0058
@pytest.mark.parametrize("dt", [1e-3, 0.1], ids=["series", "direct"])
@pytest.mark.parametrize("name", KERNELS)
def test_prior_const_tl_matches_jax(name, dt):
    jax_k, port_k = _pair(name)
    want = jax_k.prior_const_tl(jnp.asarray([dt]))
    got = port_k.prior_const_tl(torch.tensor([dt], dtype=torch.float64))
    assert len(got) == len(want) == 5
    for g, w, label in zip(got, want, ["Fc", "cc", "Qc", "mu0", "P0"]):
        np.testing.assert_allclose(g.detach().numpy(), np.array(w), rtol=RTOL,
                                   atol=ATOL, err_msg=label)


@pytest.mark.parametrize("name", KERNELS)
def test_prior_arrays_tl_matches_jax(name):
    rng = np.random.default_rng(7)
    tp = np.cumsum(rng.random(40) * 0.2)
    jax_k, port_k = _pair(name)
    want = jax_k.prior_arrays_tl(jnp.asarray(tp))
    got = port_k.prior_arrays_tl(torch.from_numpy(tp))
    for g, w, label in zip(got, want, ["F", "c", "Q"]):
        np.testing.assert_allclose(g.detach().numpy(), np.array(w), rtol=RTOL,
                                   atol=ATOL, err_msg=label)


@pytest.mark.parametrize("name", ["Matern12", "Matern32"])
def test_float32_process_noise_is_stable_at_small_steps(name):
    """At a = lam dt ~ 3.5e-3 (T = 1e6 on [0, 100]) the float32 Q[0, 0]
    comes from the stable forms (expm1; Matern32's series below its float32
    cutoff 0.2), not from a cancelling difference: it agrees with float64
    to float32 precision.  (The cancelling formula for Matern32's Q11 ~
    (4/3) a^3 = 6e-8 would be off by about eps32 / Q11, i.e. 200%.)"""
    dt = 100.0 / (1_000_000 - 1)
    _, k64 = _pair(name)
    _, k32 = _pair(name, dtype=torch.float32)
    q64 = k64.prior_const_tl(torch.tensor([dt], dtype=torch.float64))[2]
    q32 = k32.prior_const_tl(torch.tensor([dt], dtype=torch.float32))[2]
    np.testing.assert_allclose(q32[0, 0, 0].item(), q64[0, 0, 0].item(),
                               rtol=1e-5)


@pytest.mark.parametrize("dt", [1e-3, 1e-2])
def test_float32_matern52_transition_statistics_are_float64_rounded(dt):
    """Matern52's generic Q = P_inf - A P_inf A^T has no float32 digits left
    at small steps (its smallest eigenvalue is ~(lam dt)^5 of P_inf's
    scale), so with float32 parameters A and Q are evaluated in float64 and
    rounded: they agree with float64 to float32 precision entrywise, Q stays
    positive definite, and the parameters' gradients flow through.  (In
    float32 the generic form's Q[0, 0] at dt = 1e-3 would be off by about
    eps32 |P_inf| / Q[0, 0], some hundred times itself.)"""
    _, k64 = _pair("Matern52", lengthscale=0.25)
    _, k32 = _pair("Matern52", dtype=torch.float32, lengthscale=0.25)
    a64, q64 = k64.transition_statistics_tl(torch.tensor([dt], dtype=torch.float64))
    a32, q32 = k32.transition_statistics_tl(torch.tensor([dt], dtype=torch.float32))
    assert a32.dtype == q32.dtype == torch.float32
    np.testing.assert_allclose(a32.detach().numpy(), a64.detach().numpy(), rtol=1e-6,
                               atol=1e-6 * float(a64.abs().max()))
    # float64's own cancellation leaves ~1e-16 absolute in Q's entries
    np.testing.assert_allclose(q32.detach().numpy(), q64.detach().numpy(), rtol=1e-5,
                               atol=1e-12)
    assert torch.linalg.eigvalsh(q32[..., 0].double()).min() > 0
    q32.sum().backward()
    for p in (k32.lengthscale, k32.variance):
        assert p.unconstrained.grad is not None and torch.isfinite(p.unconstrained.grad).all()


def test_positive_bijector_matches_jax():
    y = np.array([1e-5, 0.5, 1.0, 30.0, 1e3])
    x = Positive().inverse(y)
    np.testing.assert_allclose(x, np.array(JPositive().inverse(y)), rtol=1e-15)
    np.testing.assert_allclose(
        Positive().forward(torch.from_numpy(x)).numpy(),
        np.array(JPositive().forward(jnp.asarray(x))), rtol=1e-15)
    np.testing.assert_allclose(
        Positive().inverse(torch.from_numpy(y)).numpy(), x, rtol=1e-15)


def test_emission_row_takes_the_time_points_dtype():
    """H is built in the data's dtype and device, not a global default."""
    k = tk.Matern52(dtype=torch.float64, device="cpu")
    tp = torch.linspace(0.0, 1.0, 5, dtype=torch.float32)
    h = k.generate_emission_model(tp).emission_matrix
    assert h.dtype == torch.float32 and h.shape == (5, 1, 3)
    np.testing.assert_array_equal(h[0].numpy(), [[1.0, 0.0, 0.0]])
