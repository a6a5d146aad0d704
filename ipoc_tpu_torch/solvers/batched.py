"""Batched interior-point solves (counterpart of
``ipoc_tpu/solvers/batched.py``): ``solve_batch`` and ``make_batch``.

JAX ``vmap``s the single solve over the scenarios; the port runs the
solvers on a leading lane axis B, its loops in lockstep until every lane's
predicate is false, each lane's updates masked, so each lane equals its
single solve (early-converged lanes wait for the slowest one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.ip_ddp import ddp_solve_batched
from ipoc_tpu_torch.solvers.ip_newton import (
    par_solve_batched,
    seq_solve_batched,
)


class BatchSolution(NamedTuple):
    controls: torch.Tensor    # (B, T, nu)
    iterations: torch.Tensor  # (B,) int32 total Newton iterations per scenario


def solve_batch(
    ocp: OCP,
    controls,        # (B, T, nu) warm starts
    initial_states,  # (B, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    method: str = "par",
) -> BatchSolution:
    """A full interior-point solve of every scenario, on the device of
    ``controls``: ``method`` "par" (the Newton solve with ``cfg``'s step
    evaluator: "par", "seq", or, with ``globalization="single"``, the fused
    "fused" and "ddp" trials, bench.py's batch mode under
    ``BATCH_CONFIG``), "seq" (the sequential validation solve) or "ddp"
    (``interior_point_ddp``, the reference's IP-DDP with its retry loop:
    plain tensor code, no kernel)."""
    solvers = {"par": par_solve_batched, "seq": seq_solve_batched,
               "ddp": ddp_solve_batched}
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}")
    u, iters = solvers[method](ocp, controls, initial_states, cfg)
    return BatchSolution(u, iters)


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
