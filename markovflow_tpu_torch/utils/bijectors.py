"""Constraint bijectors (counterpart of ``markovflow_tpu/utils/bijectors.py``).

``forward`` maps an unconstrained tensor to the constrained space;
``inverse`` maps back and accepts numpy arrays or tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Bijector", "Identity", "Positive", "positive", "FillTriangular",
           "triangular"]


@dataclasses.dataclass(frozen=True)
class Bijector:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class Positive(Bijector):
    """Softplus with a small lower bound, as the JAX package's ``positive()``."""

    lower: float = 1e-6

    def forward(self, x):
        # logaddexp(x, 0), not F.softplus: softplus returns x itself above
        # its threshold, 2e-9 away from the JAX value at x = 20
        return torch.logaddexp(x, torch.zeros_like(x)) + self.lower

    def inverse(self, y):
        if isinstance(y, torch.Tensor):
            y = torch.clamp(y - self.lower, min=1e-20)
            return y + torch.log(-torch.expm1(-y))
        y = np.maximum(np.asarray(y) - self.lower, 1e-20)
        # softplus^{-1}(y) = y + log(1 - exp(-y)), stable for large/small y
        return y + np.log(-np.expm1(-y))


def positive(lower: float = 1e-6) -> Positive:
    return Positive(lower=lower)


@dataclasses.dataclass(frozen=True)
class FillTriangular(Bijector):
    """Vector of n(n+1)/2 entries <-> lower-triangular [..., n, n] matrix,
    in row-major lower-triangular order (0,0), (1,0), (1,1), (2,0), ...,
    as the JAX package's ``triangular()``."""

    def forward(self, x):
        m = x.shape[-1]
        n = int(round((np.sqrt(8 * m + 1) - 1) / 2))
        rows, cols = np.tril_indices(n)
        out = x.new_zeros(x.shape[:-1] + (n, n))
        out[..., rows, cols] = x
        return out

    def inverse(self, y):
        rows, cols = np.tril_indices(y.shape[-1])
        return y[..., rows, cols]


def triangular() -> FillTriangular:
    return FillTriangular()
