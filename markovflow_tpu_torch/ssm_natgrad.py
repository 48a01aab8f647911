"""Natural-gradient optimiser for state-space models (counterpart of
``markovflow_tpu/ssm_natgrad.py``).

The natural gradient of a loss L in the naturals theta is dL/d(eta), the
gradient in the expectation parameters: the loss's gradient in the SSM's
fields pulled back through ``expectations_to_ssm_params``:

    g_ssm  = grad_ssm L                                  (torch.autograd.grad)
    g_eta  = vjp(expectations_to_ssm_params, eta)(g_ssm)  (grad_outputs=g_ssm)
    theta <- theta - gamma g_eta
    ssm   <- naturals_to_ssm(theta)

``step`` returns a new SSM of plain tensors; optional Adam-style momentum
on theta with a Fisher-norm scale, as in the JAX package.  Run it in
float64: theta_diag carries Q^-1 ~ dt^-3 (about 1e9 at dt = 1e-3 for a
Matern-3/2), which float32 cannot hold to the digits the inversion needs.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .ops.kalman import _from_tl, _to_tl
from .ssm_gaussian_transformations import (expectations_to_ssm_params_tl, naturals_to_ssm,
                                           naturals_to_ssm_params_parallel_tl,
                                           ssm_to_expectations_tl, ssm_to_naturals_tl)
from .state_space_model import StateSpaceModel

__all__ = ["SSMNaturalGradient", "NatGradState"]


class NatGradState(NamedTuple):
    momentum: Optional[Tuple[torch.Tensor, ...]]  # theta-shaped, or None
    fisher_norm: torch.Tensor  # moving average of g . g
    count: int


def _fields(ssm: StateSpaceModel):
    return (ssm.initial_mean, ssm.cholesky_initial_covariance, ssm.state_transitions,
            ssm.state_offsets, ssm.cholesky_process_covariances)


class SSMNaturalGradient:
    def __init__(self, gamma: float = 0.1, momentum: bool = False, beta1: float = 0.9,
                 beta2: float = 0.99, epsilon: float = 1e-8,
                 naturals_engine: str = "sequential"):
        """``naturals_engine``: how theta -> SSM is inverted each step:
        "sequential", the UDU backward recursion (a loop over the states),
        or "parallel", the synthetic model's filter and smoother (on the
        card, the general filter kernel at o = d and the smoother-scan
        kernel)."""
        if naturals_engine not in ("sequential", "parallel"):
            raise ValueError(f"unknown naturals_engine {naturals_engine!r}")
        self.gamma = gamma
        self.momentum = momentum
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.naturals_engine = naturals_engine

    def _naturals_to_ssm_tl(self, theta_tl) -> StateSpaceModel:
        if self.naturals_engine == "parallel":
            a_tl, b_tl, chol_p0, chol_q_tl, mu0 = naturals_to_ssm_params_parallel_tl(*theta_tl)
            return StateSpaceModel(mu0[..., 0, 0], chol_p0[..., 0], _from_tl(a_tl),
                                   _from_tl(b_tl)[..., 0], _from_tl(chol_q_tl))
        th_lin, th_diag, th_sub = theta_tl
        return naturals_to_ssm(_from_tl(th_lin)[..., 0], _from_tl(th_diag), _from_tl(th_sub))

    def init(self, ssm: StateSpaceModel) -> NatGradState:
        zero = torch.zeros((), dtype=ssm.dtype, device=ssm.device)
        if not self.momentum:
            return NatGradState(None, zero, 0)
        with torch.no_grad():
            theta = ssm_to_naturals_tl(ssm)
        return NatGradState(tuple(torch.zeros_like(t) for t in theta), zero, 0)

    def make_step(self, loss_fn: Callable[[StateSpaceModel], torch.Tensor]):
        """``(ssm, state) -> (ssm, state, loss)``: :meth:`step` with
        ``loss_fn`` bound."""
        return functools.partial(self.step, loss_fn)

    def step(self, loss_fn: Callable[[StateSpaceModel], torch.Tensor],
             ssm: StateSpaceModel, state: Optional[NatGradState] = None):
        """One natural-gradient step from ``ssm`` (its fields' values; the
        loss sees them as leaf tensors).  Returns (new_ssm, state, loss)."""
        if state is None:
            state = self.init(ssm)
        leaves = [x.detach().requires_grad_() for x in _fields(ssm)]
        with torch.enable_grad():
            loss = loss_fn(StateSpaceModel(*leaves))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g_mu0, g_l0, g_a, g_b, g_lq = (torch.zeros_like(x) if g is None else g
                                       for g, x in zip(grads, leaves))
        # the Cholesky factors are lower-triangular parameters (the JAX
        # package's trainable copy fills only the lower triangle)
        g_tl = (_to_tl(g_a), _to_tl(g_b[..., None]), torch.tril(g_l0)[..., None],
                _to_tl(torch.tril(g_lq)), g_mu0[..., None, None])
        plain = StateSpaceModel(*(x.detach() for x in leaves))
        with torch.no_grad():
            eta = [x.detach().requires_grad_() for x in ssm_to_expectations_tl(plain)]
        with torch.enable_grad():
            out = expectations_to_ssm_params_tl(*eta)
            g_eta = torch.autograd.grad(out, eta, grad_outputs=g_tl, allow_unused=True)
        g_eta = [torch.zeros_like(e) if g is None else g for g, e in zip(g_eta, eta)]
        with torch.no_grad():
            theta = ssm_to_naturals_tl(plain)
            if self.momentum:
                mom = tuple(self.beta1 * m + (1.0 - self.beta1) * g
                            for m, g in zip(state.momentum, g_eta))
                # the Fisher norm <g, g~>, g the theta-gradient taken as g_eta
                sq = sum((g * g).sum() for g in g_eta)
                fisher = self.beta2 * state.fisher_norm + (1.0 - self.beta2) * sq
                count = state.count + 1
                fisher_hat = fisher / (1.0 - self.beta2 ** count)
                scale = self.gamma / (torch.sqrt(fisher_hat) + self.epsilon)
                theta_new = tuple(t - scale * (m / (1.0 - self.beta1 ** count))
                                  for t, m in zip(theta, mom))
                state = NatGradState(mom, fisher, count)
            else:
                theta_new = tuple(t - self.gamma * g for t, g in zip(theta, g_eta))
                state = NatGradState(None, state.fisher_norm, state.count + 1)
            new_ssm = self._naturals_to_ssm_tl(theta_new)
        return new_ssm, state, loss.detach()
