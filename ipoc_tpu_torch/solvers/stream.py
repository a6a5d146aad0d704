"""Streaming batched interior-point solves: refill converged lanes
(counterpart of the unpacked ``solve_stream`` in
``ipoc_tpu/solvers/stream.py``).

A pool of N scenarios goes through B resident lanes in a two-level loop: an
inner loop advances every live lane by up to ``refill_every`` flat-mode
Newton iterations (:func:`ipoc_tpu_torch.solvers.ip_newton.flat_lane_iter`),
exiting early once every live lane has finished; then the outer loop copies
the finished lanes' solutions out and refills those lanes from the pool.
Per-scenario results are those of the flat-mode solver; only the lane
scheduling differs.

The loops run on the host, which waits for the device twice per inner step:
for the loop predicate (are any live lanes unfinished? kept so that
``steps`` counts the same lockstep steps as the JAX package) and, inside
``flat_lane_iter``, for which lanes roll over to a new barrier stage.  Each
outer round reads which lanes finished.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.ip_newton import (
    FlatLane,
    flat_lane_init,
    flat_lane_iter,
    flat_total_cap,
)


class StreamSolution(NamedTuple):
    controls: torch.Tensor    # (N, T, nu) per-scenario solutions
    iterations: torch.Tensor  # (N,) int32 Newton iterations per scenario
    steps: int                # lockstep loop steps taken


def solve_stream(
    ocp: OCP,
    controls,        # (N, T, nu) per-scenario warm starts
    initial_states,  # (N, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    bp_init=None,    # optional (N,) per-scenario barrier start (else cfg's)
    rp_init=None,    # optional (N,) per-scenario initial LM damping
) -> StreamSolution:
    """Solve N scenarios with B = min(lanes, N) resident lanes, refilling.

    Runs on the device of ``controls``.  Requires
    ``cfg.globalization == "single"`` and ``cfg.newton_impl == "seq"`` (the
    lane functions raise on any other evaluator).
    """
    if cfg.globalization != "single":
        raise ValueError(
            "solve_stream requires globalization='single' "
            "(the retry loop is a lockstep barrier across lanes)")
    N, T, nu = controls.shape
    B = min(lanes, N)
    dtype, device = controls.dtype, controls.device
    if device.type == "cuda":
        cuda.disable_tf32()
    if bp_init is None:
        bp_init = torch.full((N,), cfg.bp_init, dtype=dtype, device=device)
    if rp_init is None:
        rp_init = torch.full((N,), cfg.reg_init, dtype=dtype, device=device)

    lane = flat_lane_init(ocp, controls[:B], initial_states[:B], cfg,
                          bp0=bp_init[:B], rp0=rp_init[:B])
    sid = torch.arange(B, device=device)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    out_u = torch.zeros((N, T, nu), dtype=dtype, device=device)
    out_it = torch.zeros((N,), dtype=torch.int32, device=device)
    pool_next = B
    gens = (N + B - 1) // B
    K = max(1, refill_every)
    # Outer-round backstop: every round either advances at least one
    # lane-iteration or captures/retires at least one scenario.
    max_outer = flat_total_cap(cfg) * (gens + 1) + N + gens + 1
    steps = 0

    for _ in range(max_outer):
        if not bool(active.any()):
            break
        # Inner loop: up to K Newton steps, exiting early once every live
        # lane is finished.  `active` is constant within the round.
        for _ in range(K):
            adv = active & ~lane.done
            if not bool(adv.any()):
                break
            lane = flat_lane_iter(ocp, lane, cfg, adv)
            steps += 1

        # 1. Capture finished scenarios.  Only finished lanes are written,
        #    each to its own scenario row: no index repeats, so the write is
        #    deterministic.
        fin = (lane.done & active).nonzero().squeeze(1)
        rows = sid[fin]
        out_u.index_copy_(0, rows, lane.u[fin])
        out_it.index_copy_(0, rows, lane.it[fin])

        # 2. Refill from the pool: the k-th finished lane (in lane order)
        #    takes scenario pool_next + k while the pool lasts; the rest
        #    retire.  A refilled lane with a non-finite warm start is done
        #    from init and is captured next round with it=0.
        n_take = min(fin.numel(), N - pool_next)
        take = fin[:n_take]
        if n_take:
            new = torch.arange(pool_next, pool_next + n_take, device=device)
            fresh = flat_lane_init(ocp, controls[new], initial_states[new],
                                   cfg, bp0=bp_init[new], rp0=rp_init[new])
            lane = FlatLane(*(a.index_copy(0, take, f)
                              for a, f in zip(lane, fresh)))
            sid = sid.index_copy(0, take, new)
            pool_next += n_take
        active = active.index_fill(0, fin[n_take:], False)

    return StreamSolution(out_u, out_it, steps)
