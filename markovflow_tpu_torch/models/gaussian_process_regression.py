"""Exact GP regression via Kalman filtering (counterpart of
``markovflow_tpu/models/gaussian_process_regression.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kalman_filter import KalmanFilter
from ..kernels import SDEKernel
from ..likelihoods import Gaussian, MultivariateGaussian
from ..mean_function import MeanFunction
from ..posterior import AnalyticPosteriorProcess
from .models import MarkovFlowModel

__all__ = ["GaussianProcessRegression"]


class GaussianProcessRegression(MarkovFlowModel):
    def __init__(self, input_data: Tuple, kernel: SDEKernel,
                 chol_obs_covariance: torch.Tensor,
                 mean_function: Optional[MeanFunction] = None):
        """input_data: (time_points [..., N], observations [..., N, o]);
        chol_obs_covariance [o, o].  The data and the noise Cholesky are
        buffers in the observations' dtype and on their device.  The
        filters see the observations minus ``mean_function`` of the time
        points; the posterior adds it back to f.  The uniform-grid path is
        detected from the time points on the host, at construction and
        never per call (``MarkovFlowModel._set_data``)."""
        super().__init__()
        self.kernel = kernel
        self.mean_function = mean_function
        self._set_data(input_data)
        self.register_buffer("chol_obs_covariance", torch.as_tensor(
            chol_obs_covariance, dtype=self.observations.dtype,
            device=self.observations.device))

    def _residual(self) -> torch.Tensor:
        """The observations minus the mean function."""
        if self.mean_function is None:
            return self.observations
        return self.observations - self.mean_function(self.time_points)

    @property
    def kalman(self) -> KalmanFilter:
        """The Kalman filter of this model.  On the uniform path it holds
        only the constant prior steps, the emission row and the data."""
        return KalmanFilter(self.kernel.generate_emission_model(self.time_points),
                            self._residual(), self.chol_obs_covariance,
                            **self._prior_kwargs())

    def log_likelihood(self) -> torch.Tensor:
        """log p(Y)."""
        return self.kalman.log_likelihood()

    def loss(self) -> torch.Tensor:
        return -self.log_likelihood()

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        """The exact posterior process: the filter's posterior state-space
        model (one filter and one smoother launch) with the noise as its
        likelihood (a Gaussian of the noise variance at output dim 1, a
        MultivariateGaussian of the noise Cholesky above it) and the mean
        function."""
        chol = self.chol_obs_covariance
        kw = dict(dtype=chol.dtype, device=chol.device)
        if chol.shape[-1] == 1:
            lik = Gaussian(chol[..., 0, 0] ** 2, **kw)
        else:
            lik = MultivariateGaussian(chol, **kw)
        return AnalyticPosteriorProcess(
            posterior_dist=self.kalman.posterior_state_space_model(),
            kernel=self.kernel, conditioning_time_points=self.time_points,
            likelihood=lik, mean_function=self.mean_function)
