from .drift import LinearDrift
from .sde import SDE, DoubleWellSDE, Gaussian, OrnsteinUhlenbeckSDE, mvnquad
from .sde_utils import (euler_maruyama, euler_maruyama_from_normals,
                        linearize_sde,
                        squared_drift_difference_along_Gaussian_path)
