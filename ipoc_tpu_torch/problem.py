"""Problem specification layer (counterpart of ``ipoc_tpu/problem.py``).

The same five-callable :class:`OCP` interface as the JAX package, with one
convention of the port: every callable is written on tensors with leading
batch axes (``x[..., i]``, reductions over the last axis).  One definition
then serves three callers:

* the batched solver, which calls it directly on ``(B, nx)`` lane states or
  ``(B, T, nx)`` trajectories;
* ``torch.func`` derivatives, which ``vmap`` it over flattened stages, where
  the leading axes are empty;
* :func:`barrier_ocp`'s ``total_cost``, batched over any leading axes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class OCP(NamedTuple):
    """Discrete-time optimal control problem, as five pure callables.

    * ``dynamics(x, u) -> x_next``, shapes ``(..., nx), (..., nu) -> (..., nx)``
    * ``constraints(x, u) -> c`` of shape ``(..., nc)``; feasible iff
      ``c <= 0`` elementwise
    * ``stage_cost(x, u, bp) -> (...)`` including the log-barrier term
    * ``final_cost(xT) -> (...)``
    * ``total_cost(X, U, bp) -> (...)`` over ``(..., T+1, nx)`` states and
      ``(..., T, nu)`` controls; ``bp`` is a float or a tensor of the leading
      batch shape (one barrier parameter per trajectory)
    """

    dynamics: Callable
    constraints: Callable
    stage_cost: Callable
    final_cost: Callable
    total_cost: Callable


class Derivatives(NamedTuple):
    """Stacked per-stage derivatives (leading axes ``(..., T)``).

    :func:`ipoc_tpu_torch.ops.derivatives.compute_derivatives` fills every
    field (the DDP trial's tensor form); ``compute_first_order`` leaves the
    second-order fields ``None``.
    """

    cx: torch.Tensor
    cu: torch.Tensor
    cxx: torch.Tensor | None
    cuu: torch.Tensor | None
    cxu: torch.Tensor | None
    fx: torch.Tensor
    fu: torch.Tensor
    fxx: torch.Tensor | None
    fuu: torch.Tensor | None
    fxu: torch.Tensor | None


class LinearizedOCP(NamedTuple):
    """Newton-step stage quantities: ``r`` the control-gradient of the
    Hamiltonian, ``Q/R/M`` the costate-contracted stage Hessian blocks."""

    r: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor


def log_barrier(constraints: Callable) -> Callable:
    """Return ``b(x, u) = -sum(log(-c(x, u)))`` over the last axis.

    Feasible iff ``c < 0`` strictly; on the boundary the barrier is +inf and
    outside it NaN (log of a negative number), as in the JAX package.
    """

    def barrier(x, u):
        return -torch.log(-constraints(x, u)).sum(-1)

    return barrier


def stage_sum(c: torch.Tensor) -> torch.Tensor:
    """``c.sum(-1)`` added in a fixed pairwise order: halves added
    elementwise until one stage is left (an odd stage out is carried).
    A lane's rounding then depends on its horizon alone.  ``torch.sum`` on
    a CUDA tensor splits the reduction by the whole tensor's shape, so a
    lane's total there rounds with the batch's size
    (``scripts/batch_size_witness.py``)."""
    while c.shape[-1] > 1:
        h = c.shape[-1] // 2
        pair = c[..., :h] + c[..., h:2 * h]
        c = torch.cat([pair, c[..., 2 * h:]], -1) if c.shape[-1] % 2 else pair
    return c[..., 0]


def stage_norm(c: torch.Tensor) -> torch.Tensor:
    """A lane's Frobenius norm over its stages, ``vector_norm(c, dim=(-2,
    -1))`` for ``c (..., T, n)``, its squares added by :func:`stage_sum`
    (``torch.linalg.vector_norm`` on a CUDA tensor rounds with the batch's
    size, as ``torch.sum`` does)."""
    return torch.sqrt(stage_sum((c * c).flatten(-2)))


def barrier_ocp(
    dynamics: Callable,
    constraints: Callable,
    stage_cost: Callable,
    final_cost: Callable,
) -> OCP:
    """Build an :class:`OCP` whose stage cost adds ``bp * barrier``.

    ``total_cost`` sums the stage costs over the horizon plus the final cost,
    batched over the leading axes of ``states``.
    """

    bar = log_barrier(constraints)

    def stage_cost_bp(x, u, bp):
        return stage_cost(x, u) + bp * bar(x, u)

    def total_cost(states, controls, bp):
        if isinstance(bp, torch.Tensor):
            bp = bp.unsqueeze(-1)  # one barrier parameter per trajectory
        ct = stage_cost_bp(states[..., :-1, :], controls, bp)
        return stage_sum(ct) + final_cost(states[..., -1, :])

    return OCP(dynamics, constraints, stage_cost_bp, final_cost, total_cost)


def unconstrained_ocp(dynamics: Callable, stage_cost: Callable,
                      final_cost: Callable) -> OCP:
    """An :class:`OCP` with a vacuous constraint (always feasible) and no
    barrier term: ``constraints`` is ``-1`` on every stage and the stage
    cost ignores ``bp``."""

    def constraints(x, u):
        return torch.full((*x.shape[:-1], 1), -1.0, dtype=x.dtype,
                          device=x.device)

    def stage_cost_bp(x, u, bp):
        del bp
        return stage_cost(x, u)

    def total_cost(states, controls, bp):
        ct = stage_cost_bp(states[..., :-1, :], controls, bp)
        return stage_sum(ct) + final_cost(states[..., -1, :])

    return OCP(dynamics, constraints, stage_cost_bp, final_cost, total_cost)
