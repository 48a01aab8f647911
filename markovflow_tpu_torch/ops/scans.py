"""Parallel-prefix scans over the time axis (counterpart of
``markovflow_tpu/ops/scans.py``).

:func:`scan_tl` is a plain log-depth associative scan in torch, the same
recursion as ``jax.lax.associative_scan``: combine adjacent pairs, scan the
half-length sequence, then fill in the even positions.  The JAX package's
three-phase chunking exists for XLA's compile times and is not carried
over.  On it sit the affine recursions of the state-space model (marginal
means and covariances, sampling) and of ``condense``: XLA scans in the JAX
package, not Pallas kernels, so plain torch here.  They differentiate by
plain autograd (the JAX package's analytic adjoints are not ported).

Small-matrix products over time-last arrays are elementwise products
summed over the inner dimension (:func:`_mm_tl`): no matmul, so no TF32 on
the card.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["scan_tl", "affine_scan", "affine_cov_scan_tl", "affine_cov_scan",
           "segmented_affine_cov_scan_tl"]

Elems = Tuple[torch.Tensor, ...]


def _mm_tl(a, b):
    """[..., d1, d2, N] @ [..., d2, d3, N] -> [..., d1, d3, N], as
    elementwise products summed over d2."""
    return (a[..., :, :, None, :] * b[..., None, :, :, :]).sum(-3)


def _t_tl(a):
    return a.transpose(-3, -2)


def _sym_tl(a):
    return 0.5 * (a + _t_tl(a))


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


def _combine_affine(e1, e2):
    f1, c1 = e1
    f2, c2 = e2
    return _mm_tl(f2, f1), _mm_tl(f2, c1) + c2


def _combine_affine_cov(e1, e2):
    f1, c1, q1 = e1
    f2, c2, q2 = e2
    q = _mm_tl(f2, _mm_tl(q1, _t_tl(f2))) + q2
    return _mm_tl(f2, f1), _mm_tl(f2, c1) + c2, _sym_tl(q)


def affine_scan(F: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Prefix solutions of ``x_k = F_k x_{k-1} + c_k`` with ``x_{-1} = 0``.

    ``F`` [..., N, d, d], ``c`` [..., N, d]; returns x [..., N, d].  Encode
    the initial state as element 0 with ``F_0 = 0, c_0 = x_0``.
    """
    _, xs = scan_tl(_combine_affine, (F.movedim(-3, -1),
                                      c[..., None].movedim(-3, -1)))
    return xs[..., 0, :].movedim(-1, -2)


def affine_cov_scan_tl(f_tl, c_tl, q_tl):
    """Prefix means and covariances of ``x_k = F_k x_{k-1} + c_k + w_k``,
    ``w_k ~ N(0, Q_k)``, in time-last layout: ``f_tl``, ``q_tl``
    [..., d, d, N], ``c_tl`` [..., d, 1, N] (leading shapes broadcast).
    Returns (means [..., d, 1, N], covs [..., d, d, N])."""
    _, ms, ps = scan_tl(_combine_affine_cov, (f_tl, c_tl, q_tl))
    return ms, ps


def affine_cov_scan(F: torch.Tensor, c: torch.Tensor, Q: torch.Tensor):
    """:func:`affine_cov_scan_tl` in the standard layout: ``F``, ``Q``
    [..., N, d, d], ``c`` [..., N, d].  Encode the initial distribution as
    element 0 with ``F_0 = 0, c_0 = mu_0, Q_0 = P_0``.  Returns
    (means [..., N, d], covs [..., N, d, d])."""
    ms, ps = affine_cov_scan_tl(F.movedim(-3, -1), c[..., None].movedim(-3, -1),
                                Q.movedim(-3, -1))
    return ms[..., 0, :].movedim(-1, -2), ps.movedim(-1, -3)


def segmented_affine_cov_scan_tl(f_tl, c_tl, q_tl, start):
    """Segment-wise composition of affine-Gaussian maps, time-last layout:
    ``f_tl``, ``q_tl`` [..., d, d, N], ``c_tl`` [..., d, 1, N]; ``start``
    [N] boolean, True at k where the composition restarts.  Returns
    (F, c, Q) whose index k holds the composition of the elements from its
    segment's start through k: one prefix scan that carries an or-flag and
    drops the left operand where the right one starts a segment (which
    keeps the combine associative)."""
    s_tl = start.to(f_tl.dtype).expand(f_tl.shape[:-3] + start.shape[-1:])
    s_tl = s_tl[..., None, None, :]

    def combine(e1, e2):
        f1, c1, q1, s1 = e1
        f2, c2, q2, s2 = e2
        keep = 1.0 - s2
        q = _mm_tl(f2, _mm_tl(q1, _t_tl(f2))) * keep + q2
        return (_mm_tl(f2, f1) * keep + f2 * s2, _mm_tl(f2, c1) * keep + c2,
                _sym_tl(q), torch.maximum(s1, s2))

    fc, cc, qc, _ = scan_tl(combine, (f_tl, c_tl, q_tl, s_tl))
    return fc, cc, qc
