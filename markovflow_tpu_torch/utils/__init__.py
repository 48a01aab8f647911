from .bijectors import Bijector, Identity, Positive, positive
from .linalg import small_det, small_inv, small_solve, symmetrize, tlt
from .module import Parameter
