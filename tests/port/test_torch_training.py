"""The port's ``training.fit`` against the JAX package's ``fit`` (float64,
CPU): three Adam steps (lr 1e-2) from the same parameters give the same
losses and the same unconstrained parameters."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from markovflow_tpu import training as j_training  # noqa: E402
from markovflow_tpu_torch import training  # noqa: E402

from test_torch_gpr import _pair  # noqa: E402

STEPS = 3
RTOL = 1e-8


@pytest.mark.parametrize("name", ["flagship", "matern52_random_grid"])
def test_fit_matches_jax(name):
    jax_m, port_m = _pair(name)
    jax_m, jax_losses = j_training.fit(jax_m, num_steps=STEPS)
    port_m, losses = training.fit(port_m, num_steps=STEPS)
    np.testing.assert_allclose(losses.numpy(), np.array(jax_losses), rtol=RTOL)
    assert losses[-1] < losses[0]
    for key in ("lengthscale", "variance"):
        want = np.array(getattr(jax_m.kernel, key).unconstrained)
        got = getattr(port_m.kernel, key).unconstrained.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=key)


def test_fit_takes_a_loss_and_an_optimizer():
    import torch

    _, port_m = _pair("flagship")
    params = [p for p in port_m.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=1e-3)
    before = [p.detach().clone() for p in params]
    _, losses = training.fit(port_m, loss_fn=lambda m: 2.0 * m.loss(),
                             num_steps=2, optimizer=opt)
    assert losses.shape == (2,)
    assert all(not torch.equal(a, p.detach()) for a, p in zip(before, params))
    np.testing.assert_allclose(losses[0].item(), 2.0 * _pair("flagship")[1].loss().item(),
                               rtol=1e-12)
