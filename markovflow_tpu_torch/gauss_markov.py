"""Gauss-Markov distribution interface (counterpart of
``markovflow_tpu/gauss_markov.py``).

Sampling takes an explicit ``torch.Generator`` in place of a PRNG key.
``precision()`` (the joint precision as a block-tridiagonal matrix) is not
part of the port's interface yet: it needs ``block_tri_diag.py``.
"""
from __future__ import annotations

import abc

import torch
from torch import nn

__all__ = ["GaussMarkovDistribution", "check_compatible"]


class GaussMarkovDistribution(nn.Module, abc.ABC):
    @property
    @abc.abstractmethod
    def event_shape(self):
        """Shape of a single draw: (num_states, state_dim)."""

    @property
    @abc.abstractmethod
    def batch_shape(self):
        ...

    @property
    @abc.abstractmethod
    def state_dim(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def num_transitions(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def marginal_means(self) -> torch.Tensor:
        ...

    @property
    @abc.abstractmethod
    def marginal_covariances(self) -> torch.Tensor:
        ...

    @property
    def marginals(self):
        return self.marginal_means, self.marginal_covariances

    @abc.abstractmethod
    def covariance_blocks(self):
        """(diagonal blocks, lower off-diagonal blocks) of the joint
        covariance."""

    @abc.abstractmethod
    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def log_pdf(self, states: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def kl_divergence(self, other: "GaussMarkovDistribution") -> torch.Tensor:
        """KL[self || other]."""


def check_compatible(a: GaussMarkovDistribution, b: GaussMarkovDistribution):
    """Raise unless ``a`` and ``b`` agree in state dim, number of
    transitions and batch shape."""
    if a.state_dim != b.state_dim:
        raise ValueError(f"state_dim mismatch: {a.state_dim} vs {b.state_dim}")
    if a.num_transitions != b.num_transitions:
        raise ValueError(
            f"num_transitions mismatch: {a.num_transitions} vs {b.num_transitions}")
    if a.batch_shape != b.batch_shape:
        raise ValueError(f"batch_shape mismatch: {a.batch_shape} vs {b.batch_shape}")
