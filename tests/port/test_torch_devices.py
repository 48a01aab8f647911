"""The port's entry points build on the CUDA card unless the caller names
another device; the tests and every CPU caller pass ``device="cpu"``.
Nothing moves to the CPU on its own."""
import inspect

import numpy as np
import pytest
import torch

from markovflow_tpu_torch import kernels, likelihoods, sde
from markovflow_tpu_torch.convert import (cvi_from_numpy, gpr_from_numpy, ssm_from_numpy,
                                          svgp_from_numpy, vgp_from_numpy)
from markovflow_tpu_torch.kernels.sde_kernel import StationaryKernel
from markovflow_tpu_torch.utils.module import Parameter


@pytest.mark.parametrize("fn", [Parameter.__init__, StationaryKernel.__init__,
                                kernels.Matern12.__init__, kernels.Matern32.__init__,
                                kernels.Matern52.__init__, gpr_from_numpy,
                                likelihoods.Gaussian.__init__, likelihoods.StudentT.__init__,
                                sde.OrnsteinUhlenbeckSDE.__init__,
                                sde.DoubleWellSDE.__init__, cvi_from_numpy,
                                vgp_from_numpy, svgp_from_numpy, ssm_from_numpy],
                         ids=["Parameter", "StationaryKernel", "Matern12",
                              "Matern32", "Matern52", "gpr_from_numpy", "Gaussian",
                              "StudentT", "OrnsteinUhlenbeckSDE", "DoubleWellSDE",
                              "cvi_from_numpy", "vgp_from_numpy", "svgp_from_numpy",
                              "ssm_from_numpy"])
def test_constructors_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("build", [
    lambda: likelihoods.StudentT(0.3, dtype=torch.float64),
    lambda: sde.DoubleWellSDE(q=0.5, dtype=torch.float64),
    lambda: sde.OrnsteinUhlenbeckSDE(dtype=torch.float64),
    lambda: cvi_from_numpy({}, np.linspace(0.0, 1.0, 5), np.zeros((5, 1)),
                           dtype=torch.float64, likelihood="Bernoulli"),
    lambda: vgp_from_numpy({}, np.linspace(0.0, 1.0, 5), np.zeros((5, 1)),
                           dtype=torch.float64),
    lambda: svgp_from_numpy({}, np.linspace(0.0, 1.0, 5), dtype=torch.float64)],
    ids=["StudentT", "DoubleWellSDE", "OrnsteinUhlenbeckSDE", "cvi_from_numpy",
         "vgp_from_numpy", "svgp_from_numpy"])
def test_new_constructors_without_a_device_build_on_the_card(build):
    """CVI's and the SDE tools' constructors, like the kernels': on the card
    where there is one; without one they raise instead of building on the
    CPU."""
    if torch.cuda.is_available():
        model = build()
        assert all(t.is_cuda for t in list(model.parameters()) + list(model.buffers()))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()


def test_cvi_and_its_sites_live_where_the_observations_do():
    m = cvi_from_numpy({}, np.linspace(0.0, 1.0, 5), np.zeros((5, 1)),
                       dtype=torch.float64, device="cpu", likelihood="Poisson")
    assert m.time_points.device.type == "cpu"
    assert m.sites.nat1.device.type == m.sites.nat2.device.type == "cpu"


@pytest.mark.parametrize("sparse", [False, True], ids=["vgp", "svgp"])
def test_variational_models_and_their_q_live_where_their_data_do(sparse):
    x = np.linspace(0.0, 1.0, 5)
    m = (svgp_from_numpy({}, x, dtype=torch.float64, device="cpu") if sparse else
         vgp_from_numpy({}, x, np.zeros((5, 1)), dtype=torch.float64, device="cpu"))
    assert all(t.device.type == "cpu" for t in list(m.parameters()) + list(m.buffers()))
    assert m.dist_q.initial_mean.device.type == "cpu"


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
