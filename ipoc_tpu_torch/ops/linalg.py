"""Small dense linear algebra (counterpart of ``ipoc_tpu/ops/linalg.py``):
only what the slice needs.  Unrolled over the small matrix dimension and
batched over leading axes, any dtype, any device."""

from __future__ import annotations

import torch


def sym(a):
    """Symmetrize (batched) square matrices."""
    return 0.5 * (a + a.transpose(-1, -2))


def _cholesky_small(A):
    """Batched lower Cholesky, unrolled; NaN entries when not PD."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[..., j, k] * L[..., j, k]
        Ljj = torch.sqrt(d)  # NaN for negative d == not PD
        L[..., j, j] = Ljj
        for i in range(j + 1, n):
            off = A[..., i, j]
            for k in range(j):
                off = off - L[..., i, k] * L[..., j, k]
            L[..., i, j] = off / Ljj
    return L


def _tri_solve_small(L, B, lower=True):
    """Batched triangular solve against a matrix RHS, unrolled."""
    n = L.shape[-1]
    X = B.clone()
    order = range(n) if lower else range(n - 1, -1, -1)
    for row in order:
        rhs = X[..., row, :]
        inner = range(row) if lower else range(row + 1, n)
        for j in inner:
            rhs = rhs - L[..., row, j, None] * X[..., j, :]
        X[..., row, :] = rhs / L[..., row, row, None]
    return X


def cholesky_solve(A, b):
    """Solve ``A x = b`` for symmetric positive-definite A via Cholesky.

    ``b`` is a single vector if ``b.ndim == 1``, otherwise a (batched,
    broadcastable) matrix ``(..., n, k)``.  Returns NaNs if A is not PD;
    callers pair it with :func:`is_posdef`.
    """
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    A = sym(A)
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    b = b.expand(batch + b.shape[-2:])
    L = _cholesky_small(A)
    y = _tri_solve_small(L, b, lower=True)
    x = _tri_solve_small(L.transpose(-1, -2), y, lower=False)
    return x[..., 0] if vec else x


def is_posdef(A):
    """Positive-definiteness via Cholesky success (all-finite factor),
    reduced over all leading batch axes."""
    return torch.isfinite(_cholesky_small(sym(A))).all()
