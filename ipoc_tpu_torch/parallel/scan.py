"""Associative scan on tuples of tensors (the port's counterpart of
``jax.lax.associative_scan``; torch has no public one).

A copy of JAX's odd/even recursion: combine adjacent pairs, scan the half
recursively, then fill in the even positions.  The plain versions of the
scan kernels (``ops/scan_kernels.py``) run on it, so that they combine
elements in the same tree as the JAX package and round as close to it as
eager torch allows.
"""

from __future__ import annotations

from typing import Callable

import torch


def _slice(e, dim, start, stop=None, step=1):
    idx = [slice(None)] * e.dim()
    idx[dim] = slice(start, stop, step)
    return e[tuple(idx)]


def _interleave(even, odd, dim):
    """``even[0], odd[0], even[1], odd[1], ...`` along ``dim``; ``even``
    has as many rows as ``odd`` or one more."""
    n_even, n_odd = even.shape[dim], odd.shape[dim]
    if n_even > n_odd:  # a placeholder row, cut off below
        odd = torch.cat([odd, _slice(odd, dim, 0, 1)], dim=dim)
    shape = list(even.shape)
    shape[dim] = 2 * n_even
    out = torch.stack([even, odd], dim=dim + 1).reshape(shape)
    return out.narrow(dim, 0, n_even + n_odd)


def associative_scan(fn: Callable, elems: tuple, reverse: bool = False,
                     dim: int = 0) -> tuple:
    """Inclusive scan of ``elems`` (a tuple of tensors sharing the size of
    ``dim``) under the associative ``fn(a, b) -> c`` on tuples.

    ``reverse=False`` gives ``[e0, fn(e0, e1), fn(fn(e0, e1), e2), ...]``;
    ``reverse=True`` flips the inputs, scans, and flips the result back, so
    that ``fn`` receives ``(combination of later elements, earlier
    element)``, as in JAX.
    """
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    if reverse:
        elems = tuple(e.flip(dim) for e in elems)

    def combine(a, b):
        return tuple(fn(tuple(a), tuple(b)))

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        # Combine adjacent pairs, scan the half, fill in the even rows.
        reduced = combine([_slice(e, dim, 0, n - 1, 2) for e in es],
                          [_slice(e, dim, 1, None, 2) for e in es])
        odd = scan(reduced)
        later = [_slice(e, dim, 2, None, 2) for e in es]
        if n % 2 == 0:
            even = combine([_slice(e, dim, 0, -1) for e in odd], later)
        else:
            even = combine(odd, later)
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                for e, r in zip(es, even)]
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(e.flip(dim) for e in out)
    return out
