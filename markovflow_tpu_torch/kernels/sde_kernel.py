"""SDE kernels discretised to prior steps (counterpart of
``markovflow_tpu/kernels/sde_kernel.py``).

The time-last methods (``transition_statistics_tl``, ``prior_arrays_tl``,
``prior_const_tl``) feed the filters; the standard-layout ones
(``transition_statistics``, ``state_space_model``, ...) are views of the
same closed forms, for the state-space model, the conditionals and the
mean functions.

Every tensor is built in the dtype and on the device of the kernel's
parameters or of the time points it is given; nothing falls back to a
global default dtype.  A kernel's parameters live on the CUDA card unless
its constructor is given another ``device``; a :class:`Sum`, an
:class:`IndependentMultiOutput` and a :class:`Product` hold no trainable
parameters of their own and live where their children do, as does a
:class:`FactorAnalysisKernel`'s loading.
"""
from __future__ import annotations

import abc
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..emission_model import ComposedPairEmissionModel, EmissionModel
from ..state_space_model import StateSpaceModel
from ..utils.linalg import (batched_kron, block_diag, cholesky_or_zero, small_mv,
                            to_delta_time)
from ..utils.module import Parameter
from .kernel import Kernel

__all__ = ["SDEKernel", "StationaryKernel", "ConcatKernel", "Sum",
           "IndependentMultiOutput", "Product", "FactorAnalysisKernel"]


def _mat_vec_tl(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [..., d, d, N] times a constant vector m [..., d] -> [..., d, N]."""
    return (a * m[..., None, :, None]).sum(-2)


class SDEKernel(Kernel, abc.ABC):
    """Base for kernels that are LTI SDEs dx = F x dt + L dW."""

    def __init__(self, output_dim: int = 1, jitter: float = 0.0):
        super().__init__()
        self._output_dim = output_dim
        self._jitter = jitter

    @property
    def output_dim(self) -> int:
        return self._output_dim

    @property
    @abc.abstractmethod
    def state_dim(self) -> int:
        ...

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """H = [1 0 ... 0] per output at every time point, as an expanded
        view [..., N, o, d] in the time points' dtype and device."""
        n = time_points.shape[-1]
        h_row = torch.zeros(self.output_dim, self.state_dim,
                            dtype=time_points.dtype, device=time_points.device)
        h_row[:, 0] = 1.0
        shape = tuple(time_points.shape[:-1]) + (n, self.output_dim,
                                                 self.state_dim)
        return EmissionModel(h_row.expand(shape))

    def __add__(self, other: "SDEKernel") -> "Sum":
        return Sum([self, other])

    @abc.abstractmethod
    def transition_statistics(self, transition_times, time_deltas):
        """(A [..., N, d, d], Q [..., N, d, d]) of transitions that start at
        ``transition_times`` and last ``time_deltas`` [..., N]."""

    @abc.abstractmethod
    def initial_mean(self, batch_shape=()) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def initial_covariance(self, initial_time_point) -> torch.Tensor:
        """P0 at the first time point, [..., d, d]."""

    @abc.abstractmethod
    def state_offsets(self, state_transitions, time_deltas,
                      transition_times=None) -> torch.Tensor:
        """b [..., N, d] of the transitions."""

    def transition_statistics_from_time_points(self, time_points):
        return self.transition_statistics(time_points[..., :-1],
                                          to_delta_time(time_points))

    def state_space_model(self, time_points: torch.Tensor) -> StateSpaceModel:
        """The prior over the states at ``time_points`` [..., N]."""
        a_s, q_s = self.transition_statistics_from_time_points(time_points)
        b_s = self.state_offsets(a_s, to_delta_time(time_points),
                                 transition_times=time_points[..., :-1])
        mu0 = self.initial_mean(tuple(time_points.shape[:-1]))
        p0 = self.initial_covariance(time_points[..., :1])
        return StateSpaceModel(mu0, cholesky_or_zero(p0), a_s, b_s,
                               cholesky_or_zero(q_s))

    def build_finite_distribution(self, time_points: torch.Tensor) -> StateSpaceModel:
        return self.state_space_model(time_points)


def stationary_q_tl(a: torch.Tensor, p: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """The generic process noise Q = sym(P_inf - A P_inf A^T) (+ jitter I)
    [..., d, d, N] of transitions A [..., d, d, N] and P_inf [..., d, d]."""
    ap = (a[..., :, :, None, :] * p[..., None, :, :, None]).sum(-3)
    apa = (ap[..., :, None, :, :] * a[..., None, :, :, :]).sum(-2)
    q = p[..., None] - apa
    q = 0.5 * (q + q.transpose(-3, -2))
    if jitter:
        q = q + jitter * torch.eye(a.shape[-2], dtype=q.dtype, device=q.device)[..., None]
    return q


class StationaryKernel(SDEKernel, abc.ABC):
    """Stationary kernels: fixed feedback matrix F and steady state P_inf,
    Q_k = P_inf - A_k P_inf A_k^T."""

    def __init__(self, output_dim: int = 1, jitter: float = 0.0, *,
                 dtype: torch.dtype, device="cuda"):
        super().__init__(output_dim, jitter)
        self._state_mean = Parameter(np.zeros((self.state_dim,)),
                                     trainable=False, dtype=dtype,
                                     device=device)

    @property
    def state_mean(self) -> torch.Tensor:
        return self._state_mean.value

    @property
    @abc.abstractmethod
    def steady_state_covariance(self) -> torch.Tensor:
        """P_inf [d, d]."""

    @property
    @abc.abstractmethod
    def feedback_matrix(self) -> torch.Tensor:
        """F in dx = F x dt + L dW, [d, d]."""

    @abc.abstractmethod
    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        """A(dt) = expm(F dt) in time-last layout [..., d, d, N]."""

    def state_transitions(self, time_deltas: torch.Tensor) -> torch.Tensor:
        """A(dt) [..., N, d, d]."""
        return self.state_transitions_tl(time_deltas).movedim(-1, -3)

    def transition_statistics(self, transition_times, time_deltas):
        """(A, Q) [..., N, d, d]: a view of :meth:`transition_statistics_tl`
        (the transition times do not matter to a stationary kernel)."""
        a, q = self.transition_statistics_tl(time_deltas)
        return a.movedim(-1, -3), q.movedim(-1, -3)

    def initial_mean(self, batch_shape=()) -> torch.Tensor:
        return self.state_mean.expand(tuple(batch_shape) + (self.state_dim,))

    def initial_covariance(self, initial_time_point) -> torch.Tensor:
        """P0 = P_inf + jitter I, [..., d, d] for the time point [..., 1]."""
        p0 = self._p0(self.state_mean.dtype)[..., 0]
        return p0.expand(tuple(initial_time_point.shape[:-1]) + p0.shape[-2:])

    def state_offsets(self, state_transitions, time_deltas,
                      transition_times=None) -> torch.Tensor:
        """b_k = (I - A_k) m, which keeps the stationary mean m."""
        m = self.state_mean
        return m - small_mv(state_transitions, m)

    def _p0(self, dtype) -> torch.Tensor:
        """P0 = P_inf + jitter I, [d, d, 1]."""
        eye = torch.eye(self.state_dim, dtype=dtype,
                        device=self.state_mean.device)
        return (self.steady_state_covariance + self._jitter * eye)[..., None]

    def transition_statistics_tl(self, time_deltas: torch.Tensor):
        """(A, Q) in time-last layout [..., d, d, N]."""
        a = self.state_transitions_tl(time_deltas)
        return a, stationary_q_tl(a, self.steady_state_covariance, self._jitter)

    def prior_arrays_tl(self, time_points: torch.Tensor):
        """(F [..., d, d, N], c [..., d, 1, N], Q [..., d, d, N]) with
        element 0 encoding the initial distribution."""
        a, q = self.transition_statistics_tl(torch.diff(time_points, dim=-1))
        edge = a.shape[:-1] + (1,)
        f_tl = torch.cat([torch.zeros(edge, dtype=a.dtype, device=a.device),
                          a], dim=-1)
        q_tl = torch.cat([self._p0(a.dtype).expand(edge), q], dim=-1)
        m = self.state_mean
        b = m[..., None] - _mat_vec_tl(a, m)        # b_k = (I - A_k) m
        c0 = m[..., None].expand(b.shape[:-1] + (1,))
        c_tl = torch.cat([c0, b], dim=-1)[..., :, None, :]
        return f_tl, c_tl, q_tl

    def prior_const_tl(self, dt: torch.Tensor):
        """Constant prior steps for a UNIFORM grid with time delta ``dt``
        [..., 1]: every transition k >= 1 shares (Fc, cc, Qc) and element 0
        is the prior (mu0, P0).

        Returns (Fc [..., d, d, 1], cc [..., d, 1, 1], Qc [..., d, d, 1],
        mu0 [..., d, 1, 1], P0 [..., d, d, 1]).
        """
        a, q = self.transition_statistics_tl(dt)
        d = self.state_dim
        m = self.state_mean
        cc = (m[..., None] - _mat_vec_tl(a, m))[..., :, None, :]
        mu0 = m[..., None, None].expand(m.shape[:-1] + (d, 1, 1))
        return a, cc, q, mu0, self._p0(a.dtype)


class ConcatKernel(StationaryKernel, abc.ABC):
    """State concatenation of stationary child kernels: block-diagonal A and
    P_inf, concatenated state mean.  The process noise is the generic
    Q = P_inf - A P_inf A^T of the whole state, not the children's own
    forms, as in the JAX package (it cancels in float32 at small steps)."""

    def __init__(self, kernels: Sequence[StationaryKernel], jitter: float = 0.0,
                 output_dim: Optional[int] = None):
        kernels = list(kernels)
        out = output_dim if output_dim is not None else kernels[0].output_dim
        SDEKernel.__init__(self, out, jitter)   # the state mean is the children's
        self.kernels = nn.ModuleList(kernels)

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.kernels)

    @property
    def state_mean(self) -> torch.Tensor:
        return torch.cat([k.state_mean for k in self.kernels], dim=-1)

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return block_diag([k.steady_state_covariance for k in self.kernels])

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return block_diag([k.feedback_matrix for k in self.kernels])

    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        blocks = [k.state_transitions_tl(time_deltas).movedim(-1, -3)
                  for k in self.kernels]
        return block_diag(blocks).movedim(-3, -1)


class Sum(ConcatKernel):
    """f = sum_i f_i: H is the horizontal concatenation of the children's."""

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """The children's rows side by side, as an expanded view
        [..., N, o, d] in the time points' dtype and device."""
        h = torch.cat([k.generate_emission_model(time_points).emission_matrix[..., :1, :, :]
                       for k in self.kernels], dim=-1)
        return EmissionModel(h.expand(h.shape[:-3] + time_points.shape[-1:] + h.shape[-2:]))


def _block_diag_tl(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Block-diagonal of time-last blocks [..., d_i, e_i, N] ->
    [..., sum d, sum e, N], contiguous in the time-last layout."""
    return block_diag([m.movedim(-1, -3) for m in mats]).movedim(-3, -1).contiguous()


class IndependentMultiOutput(ConcatKernel):
    """One independent latent process per output: the state is the
    children's, side by side, and H = H_1 (+) H_2 (+) ... (block diagonal),
    so the output dim is the number of children.  The process noise is the
    block-diagonal of the children's own Q (the Matern kernels' closed
    forms), equal to the whole state's P_inf - A P_inf A^T of the JAX
    package in exact arithmetic, and free of its cancellation at small
    steps in float32; a child's own jitter is part of its Q."""

    def __init__(self, kernels: Sequence[StationaryKernel], jitter: float = 0.0):
        kernels = list(kernels)
        super().__init__(kernels, jitter=jitter, output_dim=len(kernels))

    def transition_statistics_tl(self, time_deltas: torch.Tensor):
        """(A, Q) [..., d, d, N]: the children's, block-diagonal."""
        stats = [k.transition_statistics_tl(time_deltas) for k in self.kernels]
        a = _block_diag_tl([s[0] for s in stats])
        q = _block_diag_tl([s[1] for s in stats])
        if self._jitter:
            q = q + self._jitter * torch.eye(self.state_dim, dtype=q.dtype,
                                             device=q.device)[..., None]
        return a, q

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """The children's rows on the block diagonal, as an expanded view
        [..., N, o, d] in the time points' dtype and device."""
        h = block_diag([k.generate_emission_model(time_points).emission_matrix[..., :1, :, :]
                        for k in self.kernels])
        return EmissionModel(h.expand(h.shape[:-3] + time_points.shape[-1:] + h.shape[-2:]))


class Product(StationaryKernel):
    """The product of stationary kernels: a Kronecker-structured state
    (state dim the product of the children's), A and P_inf the Kronecker
    products of the children's, F their Kronecker sum, H the Kronecker
    product of their rows, and the generic process noise
    Q = P_inf - A P_inf A^T, as in the JAX package."""

    def __init__(self, kernels: Sequence[StationaryKernel], jitter: float = 0.0):
        kernels = list(kernels)
        SDEKernel.__init__(self, kernels[0].output_dim, jitter)
        self.kernels = nn.ModuleList(kernels)
        mean = kernels[0].state_mean
        self._state_mean = Parameter(np.zeros((self.state_dim,)), trainable=False,
                                     dtype=mean.dtype, device=mean.device)

    @property
    def state_dim(self) -> int:
        return int(np.prod([k.state_dim for k in self.kernels]))

    @property
    def feedback_matrix(self) -> torch.Tensor:
        """The Kronecker sum: sum_i I (x) ... F_i ... (x) I."""
        kw = dict(dtype=self.state_mean.dtype, device=self.state_mean.device)
        total = None
        for i, k in enumerate(self.kernels):
            mat = None
            for j, kj in enumerate(self.kernels):
                term = k.feedback_matrix if j == i else torch.eye(kj.state_dim, **kw)
                mat = term if mat is None else batched_kron(mat, term)
            total = mat if total is None else total + mat
        return total

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        out = None
        for k in self.kernels:
            p = k.steady_state_covariance
            out = p if out is None else batched_kron(out, p)
        return out

    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        out = None
        for k in self.kernels:
            a = k.state_transitions_tl(time_deltas).movedim(-1, -3)
            out = a if out is None else batched_kron(out, a)
        return out.movedim(-3, -1)

    def generate_emission_model(self, time_points: torch.Tensor) -> EmissionModel:
        """The Kronecker product of the children's rows, as an expanded view
        [..., N, o, d] in the time points' dtype and device."""
        h = None
        for k in self.kernels:
            hk = k.generate_emission_model(time_points).emission_matrix[..., :1, :, :]
            h = hk if h is None else batched_kron(h, hk)
        return EmissionModel(h.expand(h.shape[:-3] + time_points.shape[-1:] + h.shape[-2:]))


class FactorAnalysisKernel(StationaryKernel):
    """GP factor analysis: f_i(t) = sum_jk A_ij(t) B_jk g_k(t), latent
    processes g (an :class:`IndependentMultiOutput` of ``kernels``, whose
    state is this kernel's) mixed by a trainable loading B [output_dim,
    n_latents] and a known weight function A(t).  ``weight_fn`` maps time
    points [..., N] (a tensor) to A [..., N, X, output_dim]; H(t) =
    A(t) B H_inner is [..., N, X, d] (a :class:`ComposedPairEmissionModel`),
    so the observation dim is X and usually exceeds the state dim.  A
    weight function that returns the same A at every step as an expanded
    view (stride 0 along time) gives a constant emission, which takes the
    uniform-grid kernels on a uniform grid; any other A takes the per-step
    route (``kalman_filter.BaseKalmanFilter``)."""

    def __init__(self, weight_fn: Callable, kernels: Sequence[StationaryKernel],
                 output_dim: int, trainable_loading: bool = True, loading=None,
                 jitter: float = 0.0):
        """``loading``: the initial B (numpy or tensor), default
        ``eye(output_dim, n_latents)``; it lives in the dtype and on the
        device of the latents' parameters."""
        kernels = list(kernels)
        SDEKernel.__init__(self, output_dim, jitter)
        self._inner = IndependentMultiOutput(kernels, jitter=jitter)
        self.weight_fn = weight_fn
        mean = kernels[0].state_mean
        if loading is None:
            loading = np.eye(output_dim, len(kernels))
        self._loading = Parameter(loading, trainable=trainable_loading,
                                  dtype=mean.dtype, device=mean.device)

    @property
    def loading(self) -> torch.Tensor:
        return self._loading.value

    @property
    def state_dim(self) -> int:
        return self._inner.state_dim

    @property
    def state_mean(self) -> torch.Tensor:
        return self._inner.state_mean

    @property
    def feedback_matrix(self) -> torch.Tensor:
        return self._inner.feedback_matrix

    @property
    def steady_state_covariance(self) -> torch.Tensor:
        return self._inner.steady_state_covariance

    def state_transitions_tl(self, time_deltas: torch.Tensor) -> torch.Tensor:
        return self._inner.state_transitions_tl(time_deltas)

    def transition_statistics_tl(self, time_deltas: torch.Tensor):
        """The latents' (A, Q) [..., d, d, N]: block-diagonal, each child's
        closed-form Q (:class:`IndependentMultiOutput`)."""
        return self._inner.transition_statistics_tl(time_deltas)

    def generate_emission_model(self, time_points: torch.Tensor) -> ComposedPairEmissionModel:
        """H = (A(t) B) H_inner with A(t) = ``weight_fn(time_points)``: the
        outer factor A B [..., N, X, n_latents], formed at one step and
        expanded where A has stride 0 along time."""
        inner = self._inner.generate_emission_model(time_points)
        weights = self.weight_fn(time_points)
        b = self.loading
        if weights.shape[-3] > 1 and weights.stride(-3) == 0:
            outer = (weights[..., :1, :, :, None] * b).sum(-2)
            outer = outer.expand(weights.shape[:-2] + outer.shape[-2:])
        else:
            outer = (weights[..., :, :, None] * b).sum(-2)
        return ComposedPairEmissionModel(EmissionModel(outer), inner)
