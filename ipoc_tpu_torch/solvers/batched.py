"""Scenario batches (counterpart of ``make_batch`` in
``ipoc_tpu/solvers/batched.py``; the vmapped ``solve_batch`` is later
work, ROADMAP)."""

from __future__ import annotations

import torch


def make_batch(generator: torch.Generator, base_state, n: int, horizon: int,
               nu: int, state_scale=0.0, control_scale=0.1,
               dtype=torch.float32):
    """Random scenario batch: perturbed initial states and noise warm
    starts, ``(u0 (n, horizon, nu), x0 (n, nx))``, on the CPU.

    The numbers are drawn from a CPU ``generator``, so a seed gives the same
    pool whichever device it is moved to.  They are not ``jax.random``'s
    numbers for the same seed.
    """
    base = base_state.to("cpu", dtype)
    x0 = base[None, :] + state_scale * torch.randn(
        (n, base.shape[0]), generator=generator, dtype=dtype)
    u0 = control_scale * torch.randn((n, horizon, nu), generator=generator,
                                     dtype=dtype)
    return u0, x0
