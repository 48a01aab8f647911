from .base import Likelihood, gauss_hermite
from .scalar import Bernoulli, Gaussian, Poisson, StudentT, inv_probit
from .multivariate_gaussian import MultivariateGaussian
