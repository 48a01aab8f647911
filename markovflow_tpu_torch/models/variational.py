"""Variational GP with a full-rank state-space posterior (counterpart of
``markovflow_tpu/models/variational.py``): q(s) is a state-space model over
the training time points, ELBO = sum_k E_q[log p(y_k | f_k)] - KL[q || p].

Train q by natural gradients (:class:`~markovflow_tpu_torch.ssm_natgrad.
SSMNaturalGradient`): ``opt.step(lambda s: vgp.with_dist_q(s).loss(), ssm)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import SDEKernel
from ..likelihoods import Likelihood
from ..mean_function import MeanFunction
from ..ops.kalman import _from_tl
from ..posterior import AnalyticPosteriorProcess
from ..state_space_model import StateSpaceModel
from .models import MarkovFlowModel

__all__ = ["VariationalGaussianProcess"]


class VariationalGaussianProcess(MarkovFlowModel):
    def __init__(self, input_data: Tuple, kernel: SDEKernel, likelihood: Likelihood,
                 mean_function: Optional[MeanFunction] = None,
                 initial_distribution: Optional[StateSpaceModel] = None):
        """input_data: (time_points [..., N], observations [..., N, 1]), kept
        as buffers in the observations' dtype and on their device.  q starts
        at ``initial_distribution``, by default the prior at the time
        points, as trainable parameters."""
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self._set_data(input_data)
        if initial_distribution is None:
            with torch.no_grad():
                initial_distribution = kernel.state_space_model(self.time_points)
        self._dist_q = initial_distribution.trainable_copy()

    @property
    def dist_q(self) -> StateSpaceModel:
        return self._dist_q

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.time_points)

    def with_dist_q(self, ssm: StateSpaceModel) -> "VariationalGaussianProcess":
        """A copy of this model whose q is ``ssm`` as given: a natural-gradient
        step's leaf tensors keep their graph (``ssm.trainable_copy()`` makes
        parameters of it instead)."""
        return self._replace(_dist_q=ssm)

    def elbo(self) -> torch.Tensor:
        """sum VE - KL[q || p], with one marginals scan of q shared by the
        projection and the KL."""
        dist_q = self.dist_q
        mq, pq = dist_q.marginals_tl()
        emission = self.kernel.generate_emission_model(self.time_points)
        f_means, f_covs = emission.project_state_marginals_to_f(_from_tl(mq)[..., 0],
                                                                _from_tl(pq))
        if self.mean_function is not None:
            f_means = f_means + self.mean_function(self.time_points)
        ve = self.likelihood.variational_expectations(f_means, f_covs,
                                                      self.observations).sum(-1)
        return ve - dist_q.kl_divergence(self.dist_p, marginals_tl=(mq, pq))

    def loss(self) -> torch.Tensor:
        return -self.elbo()

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            posterior_dist=self.dist_q, kernel=self.kernel,
            conditioning_time_points=self.time_points, likelihood=self.likelihood,
            mean_function=self.mean_function)
