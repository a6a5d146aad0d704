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

    The slice computes first order only (:func:`ipoc_tpu_torch.ops.
    derivatives.compute_first_order`); the second-order fields stay ``None``.
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
        return ct.sum(-1) + final_cost(states[..., -1, :])

    return OCP(dynamics, constraints, stage_cost_bp, final_cost, total_cost)
