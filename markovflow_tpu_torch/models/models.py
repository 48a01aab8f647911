"""Model base classes (counterpart of ``markovflow_tpu/models/models.py``;
``log_prior_density`` waits for parameter priors)."""
from __future__ import annotations

import abc
import copy
from typing import Tuple

import torch
from torch import nn

from ..posterior import PosteriorProcess
from ..utils.checks import (check_observations, check_time_points, host_array,
                            is_uniform_grid)

__all__ = ["MarkovFlowModel", "MarkovFlowSparseModel"]


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

    def _replace(self, **attrs) -> "MarkovFlowModel":
        """A shallow copy with ``attrs`` set (the JAX modules' ``replace``):
        the copy shares every other submodule, buffer and parameter."""
        new = copy.copy(self)
        new._modules = dict(self._modules)
        for name, value in attrs.items():
            setattr(new, name, value)
        return new

    def _set_data(self, input_data: Tuple) -> None:
        """Check (time_points [..., N], observations [..., N, o]) on the
        host, keep both as buffers in the observations' dtype and on their
        device, and pick the prior's path once: the stationary uniform-grid
        path (constant prior steps, no [d, d, N] array) where the time
        points are evenly spaced and ``self.kernel`` has constant steps,
        the per-step path otherwise.  Numpy time points skip the one
        device-to-host copy that a CUDA tensor costs here."""
        time_points, observations = input_data
        tp_host = host_array(time_points)
        check_time_points(tp_host)
        check_observations(observations, tp_host)
        kw = dict(dtype=observations.dtype, device=observations.device)
        self.register_buffer("time_points", torch.as_tensor(time_points, **kw))
        self.register_buffer("observations", observations)
        self._uniform_grid = (is_uniform_grid(tp_host)
                              and hasattr(self.kernel, "prior_const_tl"))

    def _prior_kwargs(self) -> dict:
        """The prior of the model's Kalman filter: ``prior_const_tl`` on the
        uniform path, ``prior_tl`` on the per-step one."""
        tp = self.time_points
        if self._uniform_grid:
            dt = (tp[..., -1:] - tp[..., :1]) / (tp.shape[-1] - 1)
            return {"prior_const_tl": self.kernel.prior_const_tl(dt)}
        return {"prior_tl": self.kernel.prior_arrays_tl(tp)}


class MarkovFlowSparseModel(MarkovFlowModel, abc.ABC):
    """A model evaluated on data it is given (minibatches), with predictive
    densities."""

    def predict_log_density(self, input_data):
        time_points, observations = input_data
        f_means, f_covs = self.predict_f(time_points)
        return self.likelihood.predict_density(f_means, f_covs, observations)
