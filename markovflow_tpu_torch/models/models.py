"""Model base class (counterpart of ``markovflow_tpu/models/models.py``;
``log_prior_density`` waits for parameter priors)."""
from __future__ import annotations

import abc

import torch
from torch import nn

from ..posterior import PosteriorProcess

__all__ = ["MarkovFlowModel"]


class MarkovFlowModel(nn.Module, abc.ABC):
    """Uniform model surface: ``loss()`` is what training minimises,
    ``posterior`` predicts."""

    @abc.abstractmethod
    def loss(self) -> torch.Tensor:
        ...

    @property
    @abc.abstractmethod
    def posterior(self) -> PosteriorProcess:
        ...

    def predict_state(self, new_time_points):
        return self.posterior.predict_state(new_time_points)

    def predict_f(self, new_time_points, full_output_cov: bool = False):
        return self.posterior.predict_f(new_time_points, full_output_cov)
