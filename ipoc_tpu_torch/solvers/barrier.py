"""Barrier schedule (counterpart of ``ipoc_tpu/solvers/barrier.py``): start
at ``bp_init``, run the stage solver warm-started from the previous
stage's controls, divide by ``bp_decay``, stop at ``bp <= bp_min`` (five
stages with the reference defaults)."""

from __future__ import annotations

from typing import Callable

import torch

from ipoc_tpu_torch.config import SolverConfig


def n_barrier_stages(cfg: SolverConfig) -> int:
    """Number of stages the schedule runs (5 with reference defaults)."""
    n, bp = 0, cfg.bp_init
    while bp > cfg.bp_min:
        n += 1
        bp /= cfg.bp_decay
    return n


def barrier_loop(solve_stage: Callable, controls, cfg: SolverConfig):
    """Run ``solve_stage(u, bp) -> (u, newton_iters)`` over the barrier
    schedule; returns ``(u_opt, total_newton_iterations)``.

    ``bp`` is a 0-dim tensor in the controls' dtype on their device,
    divided by ``bp_decay`` in that dtype, as the JAX package carries it:
    in float32 it is the float32 value that sets the stage tolerance and
    the barrier cost.  The loop predicate is one host read per stage.
    """
    bp = torch.tensor(cfg.bp_init, dtype=controls.dtype,
                      device=controls.device)
    total = None
    u = controls
    while bool(bp > cfg.bp_min):
        u, iters = solve_stage(u, bp)
        total = iters if total is None else total + iters
        bp = bp / cfg.bp_decay
    if total is None:
        total = torch.zeros(controls.shape[:-2], dtype=torch.int32,
                            device=controls.device)
    return u, total
