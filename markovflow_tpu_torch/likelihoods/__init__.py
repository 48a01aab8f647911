from .base import Likelihood, gauss_hermite
from .scalar import Gaussian
