"""The port's entry points build on the CUDA card unless the caller names
another device; the tests and every CPU caller pass ``device="cpu"``.
Nothing moves to the CPU on its own."""
import inspect

import numpy as np
import pytest
import torch

from markovflow_tpu_torch import kernels
from markovflow_tpu_torch.convert import gpr_from_numpy
from markovflow_tpu_torch.kernels.sde_kernel import StationaryKernel
from markovflow_tpu_torch.utils.module import Parameter


@pytest.mark.parametrize("fn", [Parameter.__init__, StationaryKernel.__init__,
                                kernels.Matern12.__init__, kernels.Matern32.__init__,
                                kernels.Matern52.__init__, gpr_from_numpy],
                         ids=["Parameter", "StationaryKernel", "Matern12",
                              "Matern32", "Matern52", "gpr_from_numpy"])
def test_constructors_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_a_kernel_built_without_a_device_is_on_the_card():
    """On a machine with a card the parameters land on it; without one the
    constructor raises instead of building on the CPU."""
    if torch.cuda.is_available():
        k = kernels.Matern52(dtype=torch.float64)
        assert k.lengthscale.unconstrained.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            kernels.Matern52(dtype=torch.float64)
        with pytest.raises((AssertionError, RuntimeError)):
            gpr_from_numpy({"chol_obs_covariance": np.asarray([[0.2]])},
                           np.linspace(0.0, 1.0, 5), np.zeros((5, 1)),
                           dtype=torch.float64)


def test_sum_lives_where_its_children_do():
    k = kernels.Sum([kernels.Matern12(dtype=torch.float64, device="cpu"),
                     kernels.Matern32(dtype=torch.float64, device="cpu")])
    tp = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
    assert all(x.device.type == "cpu" for x in k.prior_arrays_tl(tp))
    assert k.state_mean.device.type == "cpu"
