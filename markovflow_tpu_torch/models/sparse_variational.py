"""Sparse variational GP with inducing states (counterpart of
``markovflow_tpu/models/sparse_variational.py``): q(s) is a state-space
model over the states at M inducing time points; the data enter through the
conditional marginals q(f(x)) (:mod:`..conditionals`), with minibatch
scaling.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import SDEKernel
from ..likelihoods import Likelihood
from ..mean_function import MeanFunction
from ..posterior import AnalyticPosteriorProcess
from ..state_space_model import StateSpaceModel
from ..utils.bijectors import ordered
from ..utils.module import Parameter
from .models import MarkovFlowSparseModel

__all__ = ["SparseVariationalGaussianProcess"]


class SparseVariationalGaussianProcess(MarkovFlowSparseModel):
    def __init__(self, kernel: SDEKernel, likelihood: Likelihood,
                 inducing_points: torch.Tensor,
                 mean_function: Optional[MeanFunction] = None,
                 num_data: Optional[int] = None,
                 initial_distribution: Optional[StateSpaceModel] = None,
                 trainable_inducing_points: bool = False):
        """The inducing points [M] (a tensor: the model takes its dtype and
        device) are an ordered parameter, fixed unless
        ``trainable_inducing_points``.  q starts at
        ``initial_distribution``, by default the prior at the inducing
        points, as trainable parameters."""
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.num_data = num_data
        z = torch.as_tensor(inducing_points)
        self._inducing_points = Parameter(z, transform=ordered(),
                                          trainable=trainable_inducing_points,
                                          dtype=z.dtype, device=z.device)
        if initial_distribution is None:
            with torch.no_grad():
                initial_distribution = kernel.build_finite_distribution(z)
        self._dist_q = initial_distribution.trainable_copy()

    @property
    def inducing_inputs(self) -> torch.Tensor:
        return self._inducing_points.value

    @property
    def time_points(self) -> torch.Tensor:
        return self.inducing_inputs

    @property
    def dist_q(self) -> StateSpaceModel:
        return self._dist_q

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.inducing_inputs)

    def with_dist_q(self, ssm: StateSpaceModel) -> "SparseVariationalGaussianProcess":
        """A copy of this model whose q is ``ssm`` as given (see
        ``VariationalGaussianProcess.with_dist_q``)."""
        return self._replace(_dist_q=ssm)

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        """q(f) anywhere, through the conditionals of the inducing states."""
        return AnalyticPosteriorProcess(
            posterior_dist=self.dist_q, kernel=self.kernel,
            conditioning_time_points=self.inducing_inputs, likelihood=self.likelihood,
            mean_function=self.mean_function)

    def elbo(self, input_data: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """VE(q(f(x))) * num_data / N - KL[q(s(z)) || p(s(z))] for a
        minibatch (x [N], y [N, 1])."""
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        ve = self.likelihood.variational_expectations(f_mu, f_var, y).sum()
        kl = self.dist_q.kl_divergence(self.dist_p).sum()
        scale = 1.0 if self.num_data is None else self.num_data / x.shape[-1]
        return ve * scale - kl

    def loss(self, input_data) -> torch.Tensor:
        return -self.elbo(input_data)
