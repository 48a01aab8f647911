"""Parallel-prefix scan over the time axis (counterpart of
``markovflow_tpu/ops/scans.py::scan_tl``).

A plain log-depth associative scan in torch, the same recursion as
``jax.lax.associative_scan``: combine adjacent pairs, scan the half-length
sequence, then fill in the even positions.  The JAX package's three-phase
chunking exists for XLA's compile times and is not carried over.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["scan_tl"]

Elems = Tuple[torch.Tensor, ...]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[..., ceil(n/2)] and [..., floor(n/2)] -> [..., n], even first."""
    n_odd = odd.shape[-1]
    pairs = torch.stack([even[..., :n_odd], odd], dim=-1)
    out = pairs.reshape(pairs.shape[:-2] + (2 * n_odd,))
    if even.shape[-1] > n_odd:
        out = torch.cat([out, even[..., n_odd:]], dim=-1)
    return out


def _scan(combine: Callable[[Elems, Elems], Elems], elems: Elems) -> Elems:
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    # prefix of the pairs (0, 1), (2, 3), ... = prefixes at the odd positions
    reduced = combine(tuple(e[..., 0:-1:2] for e in elems),
                      tuple(e[..., 1::2] for e in elems))
    odd = _scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(o[..., :-1] for o in odd),
                       tuple(e[..., 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], v], dim=-1)
                 for e, v in zip(elems, even))
    return tuple(_interleave(v, o) for v, o in zip(even, odd))


def scan_tl(combine: Callable[[Elems, Elems], Elems],
            elems: Sequence[torch.Tensor], reverse: bool = False) -> Elems:
    """Inclusive prefix scan over the trailing (time) axis of time-last
    leaves [..., d1, d2, N] (leading batch shapes broadcast).
    ``combine(acc, new)`` takes the accumulated side first: the earlier
    elements for a forward scan, the later ones (the suffix) for a reverse
    scan."""
    lead = torch.broadcast_shapes(*(e.shape[:-3] for e in elems))
    elems = tuple(e.expand(lead + e.shape[-3:]) for e in elems)
    if reverse:
        flipped = tuple(torch.flip(e, dims=(-1,)) for e in elems)
        return tuple(torch.flip(r, dims=(-1,))
                     for r in _scan(combine, flipped))
    return _scan(combine, elems)
