"""Conjugate-computation VI (CVI) with Gaussian sites on a Markovian GP
(counterpart of ``markovflow_tpu/models/variational_cvi.py``).

The posterior is q(s) = p(s) prod_k t_k(f_k) with univariate Gaussian sites
t_k in natural form (Khan & Lin 2017).  A site update is the damped
gradient of the variational expectations with respect to the expectation
parameters [mu, mu^2 + var] of the marginals q(f_k).

Every heavy pass runs through the kernel wrappers of
:mod:`markovflow_tpu_torch.ops`: the ELBO is the site filter's
log-likelihood (the uniform filter and Koopman backward on a uniform grid,
the general ones on any other), and ``update_sites`` reads the smoothed
marginals (the filter, then the uniform smoother or the smoother scan).
On CPU tensors the wrappers run their plain versions.

Unlike the JAX module, ``update_sites`` writes the new sites into the model
and returns it, so ``m = m.update_sites()`` reads as in JAX.  The sites are
tensors, not parameters: nothing trains them but the site updates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kalman_filter import KalmanFilterWithSites, UnivariateGaussianSitesNat
from ..kernels import SDEKernel
from ..likelihoods import Likelihood
from ..mean_function import MeanFunction
from ..posterior import AnalyticPosteriorProcess
from ..state_space_model import StateSpaceModel
from .models import MarkovFlowModel

__all__ = ["CVIGaussianProcess", "GaussianProcessWithSitesBase",
           "back_project_nats", "gradient_transformation_mean_var_to_expectation"]


def back_project_nats(nat1, nat2, emission_matrix):
    """Lift f-space natural parameters to the state space, f = H s:
    nat1 [..., N, 1], nat2 [..., N, 1], H [..., N, 1, d] ->
    ([..., N, d], [..., N, d, d])."""
    h = emission_matrix[..., 0, :]
    return h * nat1, nat2[..., None] * h[..., :, None] * h[..., None, :]


def gradient_transformation_mean_var_to_expectation(inputs, grads):
    """Gradients with respect to [mu, var] -> with respect to
    [mu, var + mu^2]."""
    mu, _ = inputs
    g_mu, g_var = grads
    return g_mu - 2.0 * g_var * mu, g_var


class _NoGradientOnTheCard(torch.autograd.Function):
    """Passes a value computed without a graph; its backward raises."""

    @staticmethod
    def forward(ctx, value, *params):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "classic_elbo has no gradient on the card: the smoother kernels "
            "have no backward")


class GaussianProcessWithSitesBase(MarkovFlowModel):
    """The site-model machinery of CVI: the prior, the emission, the sites,
    their Kalman filter and the conjugate posterior."""

    def __init__(self, input_data: Tuple, kernel: SDEKernel,
                 likelihood: Likelihood,
                 mean_function: Optional[MeanFunction] = None,
                 sites: Optional[UnivariateGaussianSitesNat] = None,
                 grad_engine: str = "koopman", mesh=None):
        """input_data: (time_points [..., N], observations [..., N, 1]).
        The data are buffers in the observations' dtype and on their
        device, and the uniform-grid path is detected from the time points
        on the host at construction (``MarkovFlowModel._set_data``).
        ``sites`` default to nat1 = 0, nat2 = -1e-10 (a site precision of
        2e-10), as in the JAX package.  ``grad_engine`` takes "koopman"
        only, and ``mesh`` None: the other engines and the
        sequence-parallel one are not ported yet."""
        super().__init__()
        if grad_engine != "koopman":
            raise NotImplementedError(
                f'grad_engine="{grad_engine}" is not ported yet (ROADMAP '
                "queue 1 item 9); the port has the Koopman score only")
        if mesh is not None:
            raise NotImplementedError(
                "the sequence-parallel engine (mesh) is not ported yet "
                "(ROADMAP queue 1 item 9)")
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self._set_data(input_data)
        if sites is None:
            sites = UnivariateGaussianSitesNat(
                torch.zeros_like(self.observations),
                torch.full_like(self.observations, -1e-10)[..., None])
        self.sites = sites
        self.grad_engine = grad_engine

    @property
    def dist_p(self) -> StateSpaceModel:
        return self.kernel.state_space_model(self.time_points)

    @property
    def emission(self):
        return self.kernel.generate_emission_model(self.time_points)

    @property
    def dist_q(self) -> StateSpaceModel:
        """The conjugate posterior q(s) = p(s) prod_k t_k(f_k), as the
        posterior state-space model of the site filter (one filter and one
        smoother launch)."""
        return self.posterior_kalman.posterior_state_space_model()

    @property
    def dist_q_naturals(self) -> StateSpaceModel:
        """q(s) built through the naturals, as the JAX package keeps it for
        parity: the prior's naturals plus the sites' back-projected ones,
        inverted by the UDU factorisation (a loop over the states)."""
        from ..ssm_gaussian_transformations import naturals_to_ssm, ssm_to_naturals

        theta_linear, theta_diag, theta_subdiag = ssm_to_naturals(self.dist_p)
        bp_nat1, bp_nat2 = back_project_nats(self.sites.nat1, self.sites.nat2[..., 0],
                                             self.emission.emission_matrix)
        return naturals_to_ssm(theta_linear + bp_nat1, theta_diag + bp_nat2, theta_subdiag)

    @property
    def posterior_kalman(self) -> KalmanFilterWithSites:
        """The Kalman filter of the sites.  On the uniform path it holds
        only the constant prior steps, the emission row and the sites."""
        return KalmanFilterWithSites(self.emission, self.sites,
                                     **self._prior_kwargs())

    def log_likelihood(self) -> torch.Tensor:
        """The site model's marginal likelihood; its gradient is the Koopman
        score (the sites take none: they are not trainable)."""
        return self.posterior_kalman.log_likelihood()

    @property
    def posterior(self) -> AnalyticPosteriorProcess:
        return AnalyticPosteriorProcess(
            posterior_dist=self.dist_q, kernel=self.kernel,
            conditioning_time_points=self.time_points,
            likelihood=self.likelihood, mean_function=self.mean_function)

    def _f_marginals(self, marginals=None):
        """q(f) at the training points ([..., N, 1], [..., N, 1]): the
        smoothed state ``marginals`` (by default from a filter and a
        smoother launch) projected by the emission, plus the mean
        function."""
        if marginals is None:
            marginals = self.posterior_kalman.posterior_marginals()
        means, covs = marginals
        f_mu, f_var = self.emission.project_state_marginals_to_f(means, covs)
        if self.mean_function is not None:
            f_mu = f_mu + self.mean_function(self.time_points)
        return f_mu, f_var


class CVIGaussianProcess(GaussianProcessWithSitesBase):
    """CVI: site updates by damped natural-gradient steps of learning rate
    ``learning_rate``, the ELBO as the site model's marginal likelihood."""

    def __init__(self, input_data, kernel, likelihood, mean_function=None,
                 learning_rate: float = 0.1, sites=None,
                 grad_engine: str = "koopman", mesh=None):
        super().__init__(input_data, kernel, likelihood, mean_function, sites,
                         grad_engine=grad_engine, mesh=mesh)
        self.learning_rate = learning_rate

    def local_objective(self, f_mu, f_var, y):
        return self.likelihood.variational_expectations(f_mu, f_var, y)

    def local_objective_and_gradients(self, f_mu, f_var):
        """(the summed variational expectations, their gradients with
        respect to the expectation parameters [mu, var + mu^2]), taken on
        detached leaves so that no graph of the hyperparameters is kept."""
        mu = f_mu.detach().requires_grad_(True)
        var = f_var.detach().requires_grad_(True)
        with torch.enable_grad():
            val = self.local_objective(mu, var, self.observations).sum()
            g_mu, g_var = torch.autograd.grad(val, (mu, var))
        return val.detach(), gradient_transformation_mean_var_to_expectation(
            (mu.detach(), var.detach()), (g_mu, g_var))

    def update_sites(self) -> "CVIGaussianProcess":
        """theta <- (1 - lr) theta + lr dVE/deta, written into the sites
        (detached); returns the model."""
        with torch.no_grad():
            f_mu, f_var = self._f_marginals()
        _, (g1, g2) = self.local_objective_and_gradients(f_mu, f_var)
        lr = self.learning_rate
        with torch.no_grad():
            nat1, nat2 = (UnivariateGaussianSitesNat._v(x)
                          for x in (self.sites.nat1, self.sites.nat2))
            self.sites = self.sites.replace_nats(
                (1 - lr) * nat1 + lr * g1, (1 - lr) * nat2 + lr * g2[..., None])
        return self

    def elbo(self) -> torch.Tensor:
        """The site model's marginal likelihood."""
        return self.log_likelihood()

    def classic_elbo(self) -> torch.Tensor:
        """sum VE - KL[q || p], a check quantity.  Its KL reads the
        smoother's moments, which ``dist_q`` carries (the JAX package
        rebuilds them from the posterior's factors).  On the card the value
        comes without a graph, and asking for its gradient raises: the
        smoother kernels have no backward."""
        if self.observations.device.type != "cuda":
            return self._classic_elbo()
        with torch.no_grad():
            value = self._classic_elbo()
        params = [p for p in self.parameters() if p.requires_grad]
        if torch.is_grad_enabled() and params:
            return _NoGradientOnTheCard.apply(value, *params)
        return value

    def _classic_elbo(self) -> torch.Tensor:
        """One filter and one smoother launch: q(f) and the KL both read
        ``dist_q``'s moments."""
        dist_q = self.dist_q
        f_mu, f_var = self._f_marginals(dist_q.marginals)
        ve = self.likelihood.variational_expectations(
            f_mu, f_var, self.observations).sum()
        return ve - dist_q.kl_divergence(self.dist_p).sum()

    def loss(self) -> torch.Tensor:
        return -self.elbo()

    def predict_log_density(self, input_data):
        """log p(y* | data) at (x* [..., N*], y* [..., N*, 1]), [..., N*]."""
        x, y = input_data
        f_mu, f_var = self.posterior.predict_f(x)
        return self.likelihood.predict_density(f_mu, f_var, y)
