"""Emission models: f = H x (counterpart of ``markovflow_tpu/emission_model.py``).

Only what the Kalman filter reads is ported so far; the projections of
states to f come with the posterior.
"""
from __future__ import annotations

import torch

__all__ = ["EmissionModel"]


class EmissionModel:
    """Linear emission f = H x; ``emission_matrix`` is [..., N, o, d]
    (an expanded view when H is the same at every step)."""

    def __init__(self, emission_matrix: torch.Tensor):
        self.emission_matrix = emission_matrix
