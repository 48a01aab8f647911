"""Training loop (counterpart of ``markovflow_tpu/training.py::fit``).

Parameters are ``nn.Parameter``s whose trainability is ``requires_grad``,
so :func:`fit` optimises exactly the parameters that require gradients; the
data and the noise Cholesky of a model are buffers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["fit"]


def fit(model, loss_fn: Optional[Callable] = None, num_steps: int = 100,
        optimizer: Optional[torch.optim.Optimizer] = None):
    """Minimise ``loss_fn(model)`` (default ``model.loss()``) over the
    parameters of ``model`` that require gradients, with ``optimizer``
    (default ``torch.optim.Adam(lr=1e-2)``, the JAX package's
    ``optax.adam(1e-2)``).  Returns (model, losses [num_steps]), the loss of
    each step taken before that step's update."""
    if loss_fn is None:
        def loss_fn(m):
            return m.loss()
    if optimizer is None:
        optimizer = torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad], lr=1e-2)
    losses = []
    for _ in range(num_steps):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    if not losses:
        return model, torch.empty((0,))
    return model, torch.stack(losses)
