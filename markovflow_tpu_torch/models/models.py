"""Model base class (counterpart of ``markovflow_tpu/models/models.py``;
``posterior`` and ``predict_f`` come with the posterior module)."""
from __future__ import annotations

import abc

import torch
from torch import nn

__all__ = ["MarkovFlowModel"]


class MarkovFlowModel(nn.Module, abc.ABC):
    """Uniform model surface: ``loss()`` is what training minimises."""

    @abc.abstractmethod
    def loss(self) -> torch.Tensor:
        ...
