"""Exact GP regression via Kalman filtering (counterpart of
``markovflow_tpu/models/gaussian_process_regression.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kalman_filter import KalmanFilter
from ..kernels import SDEKernel
from ..likelihoods import Gaussian
from ..mean_function import MeanFunction
from ..posterior import AnalyticPosteriorProcess
from ..utils.checks import (check_observations, check_time_points,
                            host_array, is_uniform_grid)
from .models import MarkovFlowModel

__all__ = ["GaussianProcessRegression"]


class GaussianProcessRegression(MarkovFlowModel):
    def __init__(self, input_data: Tuple, kernel: SDEKernel,
                 chol_obs_covariance: torch.Tensor,
                 mean_function: Optional[MeanFunction] = None,
                 uniform_grid: Optional[bool] = None):
        """input_data: (time_points [..., N], observations [..., N, o]);
        chol_obs_covariance [o, o].  The data and the noise Cholesky are
        buffers in the observations' dtype and on their device.  The
        filters see the observations minus ``mean_function`` of the time
        points; the posterior adds it back to f.

        ``uniform_grid``: the stationary uniform-grid path (constant prior
        steps, no [d, d, N] array).  ``None`` detects it from the time
        points on the host: pass numpy time points to skip the one
        device-to-host copy that a CUDA tensor costs here, at construction
        and never per call.  ``False`` forces the general path; ``True``
        asserts eligibility."""
        super().__init__()
        time_points, observations = input_data
        tp_host = host_array(time_points)
        check_time_points(tp_host)
        check_observations(observations, tp_host)
        kw = dict(dtype=observations.dtype, device=observations.device)
        self.register_buffer("time_points", torch.as_tensor(time_points, **kw))
        self.register_buffer("observations", observations)
        self.register_buffer("chol_obs_covariance",
                             torch.as_tensor(chol_obs_covariance, **kw))
        self.kernel = kernel
        self.mean_function = mean_function
        detected = (is_uniform_grid(tp_host)
                    and hasattr(kernel, "prior_const_tl"))
        if uniform_grid and not detected:
            raise ValueError("uniform_grid=True requires evenly spaced time "
                             "points and a stationary kernel")
        self._uniform_grid = detected if uniform_grid is None \
            else bool(uniform_grid)

    def _residual(self) -> torch.Tensor:
        """The observations minus the mean function."""
        if self.mean_function is None:
            return self.observations
        return self.observations - self.mean_function(self.time_points)

    @property
    def kalman(self) -> KalmanFilter:
        """The Kalman filter of this model.  On the uniform path it holds
        only the constant prior steps, the emission row and the data."""
        tp = self.time_points
        emission = self.kernel.generate_emission_model(tp)
        if self._uniform_grid:
            n = tp.shape[-1]
            dt = (tp[..., -1:] - tp[..., :1]) / (n - 1)
            return KalmanFilter(emission, self._residual(),
                                self.chol_obs_covariance,
                                prior_const_tl=self.kernel.prior_const_tl(dt))
        return KalmanFilter(emission, self._residual(),
                            self.chol_obs_covariance,
                            prior_tl=self.kernel.prior_arrays_tl(tp))

    def log_likelihood(self) -> torch.Tensor:
        """log p(Y)."""
        return self.kalman.log_likelihood()

    def loss(self) -> torch.Tensor:
        return -self.log_likelihood()

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        """The exact posterior process: the filter's posterior state-space
        model (one filter and one smoother launch) with a Gaussian
        likelihood of the noise variance and the mean function.  Output dim
        1 only: more needs the multivariate Gaussian likelihood and kernels
        of output dim > 1, not ported yet."""
        chol = self.chol_obs_covariance
        if chol.shape[-1] != 1:
            raise NotImplementedError(
                "GaussianProcessRegression.posterior takes output dim 1 only")
        lik = Gaussian(chol[..., 0, 0] ** 2, dtype=chol.dtype, device=chol.device)
        return AnalyticPosteriorProcess(
            posterior_dist=self.kalman.posterior_state_space_model(),
            kernel=self.kernel, conditioning_time_points=self.time_points,
            likelihood=lik, mean_function=self.mean_function)
