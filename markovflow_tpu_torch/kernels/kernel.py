"""Kernel abstract base (counterpart of ``markovflow_tpu/kernels/kernel.py``)."""
from __future__ import annotations

import abc

import torch
from torch import nn

from ..emission_model import EmissionModel

__all__ = ["Kernel"]


class Kernel(nn.Module, abc.ABC):
    """A kernel given by a Gauss-Markov prior over states plus an emission
    model projecting states to function values."""

    @abc.abstractmethod
    def build_finite_distribution(self, time_points: torch.Tensor):
        """The Gauss-Markov prior over the states at ``time_points``."""

    @abc.abstractmethod
    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        ...

    @property
    @abc.abstractmethod
    def output_dim(self) -> int:
        ...
