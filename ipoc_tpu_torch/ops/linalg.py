"""Small dense linear algebra (counterpart of ``ipoc_tpu/ops/linalg.py``):
Cholesky factor and solve, the positive-definiteness flag, and the general
small solves with and without pivoting.  Unrolled over the small matrix
dimension and batched over leading axes, any dtype, any device."""

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
    x = cholesky_solve_factored(_cholesky_small(A), b)
    return x[..., 0] if vec else x


def cholesky_solve_factored(L, b):
    """Solve ``L L^T x = b`` for a lower Cholesky factor ``L (..., n, n)``
    (from :func:`cholesky` of the symmetrized matrix) and a matrix RHS
    ``b (..., n, k)`` of the same batch shape."""
    y = _tri_solve_small(L, b, lower=True)
    return _tri_solve_small(L.transpose(-1, -2), y, lower=False)


def cholesky(A):
    """Batched lower Cholesky factor; NaN entries when A is not PD."""
    return _cholesky_small(A)


def is_posdef(A, batch_dims: int = 0):
    """Positive-definiteness via Cholesky success (all-finite factor).

    The flag keeps the first ``batch_dims`` axes and reduces over the rest:
    ``batch_dims=0`` reduces over every leading axis (JAX's unbatched
    ``is_posdef``), ``batch_dims=1`` gives one flag per lane of a
    ``(B, T, n, n)`` stack, as JAX's reduction does under ``vmap``."""
    ok = torch.isfinite(_cholesky_small(sym(A)))
    return ok.flatten(batch_dims).all(-1) if batch_dims else ok.all()


def _gauss_solve_small(A, B):
    """Batched small solve by Gaussian elimination with partial pivoting:
    ``A (..., n, n)``, ``B (..., n, k)`` -> ``(..., n, k)``.  The same
    elimination order as JAX's ``_gauss_solve_small`` (the first largest
    pivot candidate wins a tie)."""
    n = A.shape[-1]
    A, B = A.clone(), B.clone()
    idx = torch.arange(n, device=A.device)
    for col in range(n):
        colvals = A[..., :, col].abs()
        colvals = torch.where(idx >= col, colvals,
                              torch.full_like(colvals, -float("inf")))
        p = torch.argmax(colvals, dim=-1, keepdim=True)  # (..., 1)
        perm = torch.where(idx == col, p, torch.where(idx == p, col, idx))
        A = torch.gather(A, -2, perm[..., None].expand(A.shape))
        B = torch.gather(B, -2, perm[..., None].expand(B.shape))
        pivot = A[..., col, col, None]
        if col + 1 < n:
            factor = A[..., col + 1:, col] / pivot
            A[..., col + 1:, :] += -factor[..., None] * A[..., col:col + 1, :]
            B[..., col + 1:, :] += -factor[..., None] * B[..., col:col + 1, :]
    return _back_substitute(A, B)


def _gauss_solve_small_nopivot(A, B):
    """Batched small solve without pivoting, for diagonally sound systems
    (regularized Newton blocks, ``I + C J`` with PSD factors); not safe for
    arbitrary matrices."""
    n = A.shape[-1]
    A, B = A.clone(), B.clone()
    for col in range(n):
        pivot = A[..., col, col, None]
        if col + 1 < n:
            factor = A[..., col + 1:, col] / pivot
            A[..., col + 1:, :] += -factor[..., None] * A[..., col:col + 1, :]
            B[..., col + 1:, :] += -factor[..., None] * B[..., col:col + 1, :]
    return _back_substitute(A, B)


def _back_substitute(A, B):
    n = A.shape[-1]
    for row in range(n - 1, -1, -1):
        rhs = B[..., row, :]
        for j in range(row + 1, n):
            rhs = rhs - A[..., row, j, None] * B[..., j, :]
        B[..., row, :] = rhs / A[..., row, row, None]
    return B


def solve(A, b, pivot: bool = True):
    """General (non-SPD) batched small solve, any dtype, any device.

    ``b`` is a single vector iff ``b.ndim == 1``, otherwise a
    broadcastable matrix ``(..., n, k)`` (the ``jnp.linalg.solve``
    convention).  ``pivot=False`` selects the elimination without row
    swaps (:func:`_gauss_solve_small_nopivot`)."""
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    b = b.expand(batch + b.shape[-2:])
    x = (_gauss_solve_small if pivot else _gauss_solve_small_nopivot)(A, b)
    return x[..., 0] if vec else x
