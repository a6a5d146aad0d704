"""Batched interior-point solves (counterpart of
``ipoc_tpu/solvers/batched.py``): ``solve_batch``, its batch-sharded form
``solve_batch_sharded`` and ``make_batch``.

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


def solve_batch_sharded(
    ocp: OCP,
    controls,        # (N, T, nu), N divisible by the mesh dimension
    initial_states,  # (N, nx)
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    method: str = "par",
    axis_name: str = "batch",
) -> BatchSolution:
    """The scenarios split over the mesh's ``axis_name`` dimension, each
    rank running :func:`solve_batch` on its slice (so on a card "par"
    trials are the one-launch parallel trial kernel).  Every rank passes
    the whole batch and gets every scenario's solution back, on its device
    (``parallel.sharding.rank_device``); the solves share nothing but the
    final gather."""
    from ipoc_tpu_torch.parallel.sharding import (
        axis_size,
        gather_shards,
        rank_device,
        shard,
    )

    n = axis_size(mesh, axis_name)
    if controls.shape[0] % n != 0:
        raise ValueError(
            f"batch {controls.shape[0]} not divisible by {n} shards")
    idx, group = mesh.get_local_rank(axis_name), mesh.get_group(axis_name)
    dev = rank_device(controls)
    sol = solve_batch(ocp, shard(controls.to(dev), idx, n, 0),
                      shard(initial_states.to(dev), idx, n, 0), cfg, method)
    return BatchSolution(gather_shards(sol.controls, group, 0),
                         gather_shards(sol.iterations, group, 0))


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
