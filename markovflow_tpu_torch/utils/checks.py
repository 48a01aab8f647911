"""Input validation at API boundaries (counterpart of
``markovflow_tpu/utils/checks.py``).

Value checks run on the host.  Callers pass numpy time points, or a tensor
that is copied to the host once, where the model is constructed; no check
reads a device tensor back on a later call.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_time_points", "check_observations", "is_uniform_grid",
           "host_array"]


def host_array(x) -> np.ndarray:
    """``x`` as a numpy array (one device-to-host copy for a CUDA tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_time_points(time_points: np.ndarray, name: str = "time_points"):
    """Raise unless host ``time_points`` have an axis and are non-decreasing
    along the last one."""
    if time_points.ndim < 1:
        raise ValueError(f"{name} must have at least one axis")
    if time_points.shape[-1] > 1 and not np.all(
            np.diff(time_points, axis=-1) >= 0):
        raise ValueError(f"{name} must be sorted in non-decreasing order "
                         "along the last axis")


def check_observations(observations, time_points,
                       name: str = "observations"):
    """Raise unless ``observations`` is ``time_points.shape + [obs_dim]``
    with ``obs_dim >= 1`` (shape checks only)."""
    obs_shape = tuple(observations.shape)
    tp_shape = tuple(time_points.shape)
    if len(obs_shape) != len(tp_shape) + 1 or obs_shape[:-1] != tp_shape:
        raise ValueError(
            f"{name} must have shape time_points.shape + [obs_dim]; "
            f"got {obs_shape} for time points {tp_shape}")
    if obs_shape[-1] < 1:
        raise ValueError(f"{name} must have obs_dim >= 1, got {obs_shape}")


def is_uniform_grid(time_points: np.ndarray) -> bool:
    """True iff host ``time_points`` are strictly increasing and evenly
    spaced up to the rounding of their storage dtype (2 eps max|t| per
    delta), with at least three points."""
    tp = np.asarray(time_points)
    if tp.ndim < 1 or tp.shape[-1] < 3:
        return False
    deltas = np.diff(tp, axis=-1)
    mean = deltas.mean(axis=-1, keepdims=True)
    if not np.all(np.isfinite(mean)) or np.any(mean <= 0):
        return False
    eps = np.finfo(tp.dtype).eps if np.issubdtype(tp.dtype, np.floating) \
        else np.finfo(np.float64).eps
    atol = 2.0 * eps * np.max(np.abs(tp))
    return bool(np.all(np.abs(deltas - mean) <= atol))
