"""Receding-horizon MPC loops (counterpart of ``ipoc_tpu/mpc.py``).

At every simulation step the horizon subproblem is re-solved and its first
control applied (the reference's ``examples/linear_mpc_parallel.py``
loop).  JAX runs each closed loop as one ``lax.scan``; here each is a
Python loop over the steps, on the device of its inputs.  The warm start
is by resolve: the previous plan is passed on unshifted, as in JAX.

The port's LQT and dynamics carry a leading batch axis, so
:func:`lqt_mpc_loop` regulates a batch of LQTs at once and the batched
loops call ``plant(xs, u0)`` on the whole batch.  On a card the parallel
LQT passes run the value-scan and affine-scan kernels
(``parallel/lqt.py``), and the batched resolvers typically run
``solvers/packed_stream.py`` :func:`solve_batch_packed` on the mega
kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from ipoc_tpu_torch.parallel.lqt import (
    LQT,
    par_bwd_pass,
    par_fwd_pass,
    seq_bwd_pass,
    seq_fwd_pass,
)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def lqt_mpc_loop(lqt: LQT, x0, n_steps: int, mode: str = "par",
                 plant: Callable | None = None):
    """Closed-loop MPC with a fixed LQT subproblem re-solved every step.

    ``lqt`` is batch-first (``parallel/lqt.py`` :class:`LQT`), ``x0 (B,
    nx)``.  ``mode`` selects the parallel (associative-scan) or the
    sequential passes; the backward pass is recomputed every step, as in
    JAX.  ``plant(x, u)`` overrides the simulation dynamics, by default
    stage 0 of each LQT.  Returns ``(states (n_steps, B, nx), controls
    (n_steps, B, nu))``.
    """
    if mode == "par":
        bwd = lambda: par_bwd_pass(lqt)[:2]  # noqa: E731
        fwd = lambda x, K, d: par_fwd_pass(lqt, x, K, d)  # noqa: E731
    elif mode == "seq":
        bwd = lambda: seq_bwd_pass(lqt)[:2]  # noqa: E731
        fwd = lambda x, K, d: seq_fwd_pass(lqt, x, K, d)  # noqa: E731
    else:
        raise ValueError(f"unknown mode: {mode}")
    if plant is None:
        def plant(x, u):
            return (_mv(lqt.A[:, 0], x) + _mv(lqt.B[:, 0], u)
                    + lqt.c[:, 0])

    xs, us = [], []
    x = x0
    for _ in range(n_steps):
        K, d = bwd()
        u_plan, _ = fwd(x, K, d)
        u0 = u_plan[:, 0]
        x = plant(x, u0)
        xs.append(x)
        us.append(u0)
    return (_stack(xs, x0.shape, x0),
            _stack(us, (x0.shape[0], lqt.B.shape[-1]), x0))


def _stack(items, shape, like):
    """The per-step outputs as one ``(n_steps, *shape)`` tensor, empty (as
    JAX's scan returns) when there is no step."""
    return torch.stack(items) if items else like.new_empty((0, *shape))


def nmpc_loop(solve: Callable, plant: Callable, x0, u_init, n_steps: int):
    """Nonlinear MPC: ``solve(u_warm (T, nu), x (nx,)) -> u_plan (T, nu)``
    re-solved each step, warm-started by the previous plan; applies
    ``u_plan[0]`` through ``plant``.  Returns ``(states (n_steps, nx),
    controls (n_steps, nu))``."""
    xs, us = [], []
    x, u_warm = x0, u_init
    for _ in range(n_steps):
        u_warm = solve(u_warm, x)
        u0 = u_warm[0]
        x = plant(x, u0)
        xs.append(x)
        us.append(u0)
    return _stack(xs, x0.shape, x0), _stack(us, u_init.shape[1:], u_init)


def nmpc_loop_batched(solve_batch: Callable, plant: Callable, x0s, u_init,
                      n_steps: int):
    """Batched nonlinear MPC: B controllers in lockstep, one resolve per
    step for the whole batch (``solve_batch(u_warm (B, T, nu), xs (B, nx))
    -> u_plans (B, T, nu)``, typically :func:`solve_batch_packed` on the
    mega kernel), warm-started as :func:`nmpc_loop`.  ``plant(xs, u0)``
    steps every controller.  Returns ``(states (n_steps, B, nx), controls
    (n_steps, B, nu))``."""
    xs, us = [], []
    x, u_warm = x0s, u_init
    for _ in range(n_steps):
        u_warm = solve_batch(u_warm, x)
        u0 = u_warm[:, 0]
        x = plant(x, u0)
        xs.append(x)
        us.append(u0)
    return (_stack(xs, x0s.shape, x0s),
            _stack(us, (u_init.shape[0], u_init.shape[-1]), u_init))


def nmpc_loop_batched_warm(solve_cold: Callable, solve_warm: Callable,
                           plant: Callable, x0s, u_init, n_steps: int):
    """Batched NMPC with a warm barrier re-entry.

    The first resolve (from ``u_init``, with no plan to continue) runs
    ``solve_cold``, the full barrier schedule; every later one starts from
    the controller's own previous plan and runs ``solve_warm``, typically
    ``solve_batch_packed(..., bp_entry=0.02)``, which re-enters the
    barrier one decade in (infeasible warm starts fall back to the cold
    schedule per lane inside the resolver).  Returns what
    :func:`nmpc_loop_batched` returns.
    """
    if n_steps < 1:
        raise ValueError(
            "nmpc_loop_batched_warm needs n_steps >= 1 (the first step "
            "is the cold resolve)")
    u_plans = solve_cold(u_init, x0s)
    u0 = u_plans[:, 0]
    x = plant(x0s, u0)
    xs, us = [x], [u0]
    for _ in range(n_steps - 1):
        u_plans = solve_warm(u_plans, x)
        uk = u_plans[:, 0]
        x = plant(x, uk)
        xs.append(x)
        us.append(uk)
    return torch.stack(xs), torch.stack(us)
