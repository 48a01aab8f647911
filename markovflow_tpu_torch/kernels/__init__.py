from .kernel import Kernel
from .matern import Matern12, Matern32, Matern52
from .sde_kernel import (ConcatKernel, FactorAnalysisKernel, IndependentMultiOutput,
                         Product, SDEKernel, StationaryKernel, Sum)
