"""Constrained parameters (counterpart of ``markovflow_tpu/utils/module.py``).

A :class:`Parameter` is an ``nn.Module`` holding the UNCONSTRAINED value as
an ``nn.Parameter`` plus its bijector; ``.value`` applies the bijector.
Trainability is ``requires_grad``, so the JAX package's ``trainable_mask``
and ``filtered_value_and_grad`` have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .bijectors import Bijector, Identity

__all__ = ["Parameter"]


class Parameter(nn.Module):
    def __init__(self, value, transform: Bijector | None = None,
                 trainable: bool = True, *, dtype: torch.dtype, device="cuda"):
        """``value`` is the constrained value (a numpy array, Python scalar
        or tensor).  The parameter lives on ``device``: the CUDA card unless
        the caller names another."""
        super().__init__()
        self.transform = transform if transform is not None else Identity()
        if isinstance(value, torch.Tensor):
            value = value.detach().to(dtype=dtype, device=device)
        else:
            value = np.asarray(value, dtype=np.float64)
        raw = torch.as_tensor(self.transform.inverse(value), dtype=dtype,
                              device=device)
        self.unconstrained = nn.Parameter(raw.detach().clone(),
                                          requires_grad=trainable)

    @property
    def value(self) -> torch.Tensor:
        return self.transform.forward(self.unconstrained)

    def extra_repr(self) -> str:
        return f"transform={self.transform!r}"
