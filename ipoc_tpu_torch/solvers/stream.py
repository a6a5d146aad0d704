"""Streaming batched interior-point solves: refill converged lanes
(counterpart of ``solve_stream`` and ``solve_stream_multigrid`` in
``ipoc_tpu/solvers/stream.py``, and of their forms with the pool sharded
over ranks).

``newton_impl="fused"`` (``BATCH_CONFIG``, what the bench runs) and
``"ddp"`` go to the packed stream, ``solvers/packed_stream.py``, as in the
JAX package.  This module's own loop is the unpacked stream, which runs
``newton_impl="seq"`` or ``"par"``.  :func:`solve_stream_multigrid`, the bench's default
mode, runs two streams: a coarse grid, then the fine grid warm-started
from it.

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
    # (N,) bool: the scenario's barrier schedule ran to bp_min; False where
    # its solve stopped on a non-finite cost or gradient (or its warm start
    # was infeasible), and its controls are the last iterate.
    completed: torch.Tensor


def solve_stream(
    ocp: OCP,
    controls,        # (N, T, nu) per-scenario warm starts
    initial_states,  # (N, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    bp_init=None,    # optional (N,) per-scenario barrier start (else cfg's)
    rp_init=None,    # optional (N,) per-scenario initial LM damping
    warm_transfer: bool = False,
    transfer_bp: float = 0.02,
) -> StreamSolution:
    """Solve N scenarios with B = min(lanes, N) resident lanes, refilling.

    Runs on the device of ``controls``.  Requires
    ``cfg.globalization == "single"``; ``newton_impl="fused"`` and
    ``"ddp"`` run the packed stream on its mega-kernel executor, ``"seq"``
    and ``"par"`` the unpacked one.  ``warm_transfer`` and ``transfer_bp``
    go to the packed stream (:func:`solve_stream_packed`), which alone
    runs them.
    """
    if cfg.globalization != "single":
        raise ValueError(
            "solve_stream requires globalization='single' "
            "(the retry loop is a lockstep barrier across lanes)")
    if cfg.newton_impl in ("fused", "ddp"):
        from ipoc_tpu_torch.solvers.packed_stream import solve_stream_packed

        return solve_stream_packed(
            ocp, controls, initial_states, cfg, lanes=lanes,
            refill_every=refill_every, bp_init=bp_init, rp_init=rp_init,
            warm_transfer=warm_transfer, transfer_bp=transfer_bp)
    if warm_transfer:
        raise ValueError("warm_transfer requires the packed stream "
                         "(newton_impl='fused' or 'ddp')")
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
    out_done = torch.zeros((N,), dtype=torch.bool, device=device)
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
        out_done.index_copy_(0, rows, lane.bp[fin] <= cfg.bp_min)

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

    return StreamSolution(out_u, out_it, steps, out_done)


class MultigridSolution(NamedTuple):
    controls: torch.Tensor           # (N, T, nu) per-scenario solutions
    iterations: torch.Tensor         # (N,) fine-level Newton iterations
    iterations_coarse: torch.Tensor  # (N,) coarse-level Newton iterations
    steps: int                       # fine-level lockstep steps
    steps_coarse: int                # coarse-level lockstep steps
    fallback: torch.Tensor           # (N,) bool: the gate's cold starts
    completed: torch.Tensor          # (N,) bool: the fine level's, as
    #                                  StreamSolution's


def solve_stream_multigrid(
    ocp: OCP,
    ocp_coarse: OCP,
    coarsen: int,
    controls,        # (N, T, nu) per-scenario warm starts (T % coarsen == 0)
    initial_states,  # (N, nx)
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    fine_bp_init: float = 0.02,
    fine_reg_init: float = 1.0,
    coarse_impl: str | None = None,
    fine_impl: str | None = None,
    coarse_solver=None,
) -> MultigridSolution:
    """Coarse-to-fine (multigrid-in-time) streaming solve.

    Every scenario is solved first on a ``coarsen``-times coarser time grid
    (``ocp_coarse``: the same continuous problem at ``coarsen * dt``) down
    to the fine re-entry barrier ``fine_bp_init``; its controls, held over
    ``coarsen`` fine stages (zero-order hold by repetition), warm-start the
    fine grid, which re-enters the barrier schedule at ``fine_bp_init`` with
    LM damping ``fine_reg_init``.  A scenario whose interpolated start is
    unusable on the fine grid (a non-finite barrier cost at
    ``fine_bp_init``, or non-finite controls; one rollout-cost launch on a
    card) falls back to its own ``controls`` and the full schedule through
    the per-scenario ``bp_init``/``rp_init``; ``fallback`` marks those
    scenarios.

    ``coarse_impl``/``fine_impl`` override the level's ``newton_impl``
    (the bench runs ``coarse_impl="ddp"``); ``coarse_solver`` replaces the
    coarse solve: ``(ocp_c, u_c, x0, cfg_c, lanes, refill_every) ->`` a
    solution with ``controls``, ``iterations`` and ``steps`` (JAX's hook
    also passes ``inner_unroll``, which the port does not have).  Semantics
    are the JAX package's; on a nonconvex problem a small share of
    scenarios lands in another local basin than the single-grid stream.
    """
    N, T, nu = controls.shape
    if T % coarsen != 0:
        raise ValueError(f"horizon {T} not divisible by coarsen={coarsen}")
    from ipoc_tpu_torch.ops.fused_iter import rollout_cost_packed
    from ipoc_tpu_torch.solvers.packed_stream import _pack

    # The coarse level only needs to reach the fine re-entry bp.
    coarse_bp_min = max(cfg.bp_min, fine_bp_init * (1.0 - 1e-6))
    c_cfg = cfg.replace(bp_min=coarse_bp_min)
    if coarse_impl is not None:
        c_cfg = c_cfg.replace(newton_impl=coarse_impl)
    f_cfg = cfg if fine_impl is None else cfg.replace(newton_impl=fine_impl)
    u_coarse = controls[:, ::coarsen].contiguous()
    if coarse_solver is None:
        sol_c = solve_stream(ocp_coarse, u_coarse, initial_states, c_cfg,
                             lanes=lanes, refill_every=refill_every)
    else:
        sol_c = coarse_solver(ocp_coarse, u_coarse, initial_states, c_cfg,
                              lanes, refill_every)
    u_warm = torch.repeat_interleave(sol_c.controls, coarsen, dim=1)

    # The usable gate: a finite barrier cost at the re-entry bp (which
    # subsumes strict feasibility and a fine-grid rollout that overflows)
    # and finite controls.
    dtype, device = controls.dtype, controls.device
    u_p, x0_p = _pack(u_warm, initial_states)
    fine_bp = torch.full((N,), fine_bp_init, dtype=dtype, device=device)
    cost = rollout_cost_packed(ocp, u_p, x0_p, fine_bp)[2]
    ok = torch.isfinite(cost) & torch.isfinite(u_warm).flatten(1).all(1)
    u_start = torch.where(ok[:, None, None], u_warm, controls)
    bp0 = torch.where(ok, fine_bp, torch.full_like(fine_bp, cfg.bp_init))
    rp0 = torch.where(ok, torch.full_like(fine_bp, fine_reg_init),
                      torch.full_like(fine_bp, cfg.reg_init))
    sol_f = solve_stream(ocp, u_start, initial_states, f_cfg, lanes=lanes,
                         refill_every=refill_every, bp_init=bp0,
                         rp_init=rp0)
    return MultigridSolution(
        controls=sol_f.controls,
        iterations=sol_f.iterations,
        iterations_coarse=sol_c.iterations,
        steps=sol_f.steps,
        steps_coarse=sol_c.steps,
        fallback=~ok,
        completed=sol_f.completed,
    )


def _shard_pool(controls, initial_states, mesh, axis_name):
    """This rank's slice of a pool and what gathers it back."""
    from ipoc_tpu_torch.parallel.sharding import (
        axis_size,
        gather_shards,
        pmax,
        rank_device,
        shard,
    )

    n = axis_size(mesh, axis_name)
    if controls.shape[0] % n != 0:
        raise ValueError(
            f"pool {controls.shape[0]} not divisible by {n} shards")
    idx, group = mesh.get_local_rank(axis_name), mesh.get_group(axis_name)
    dev = rank_device(controls)
    u = shard(controls.to(dev), idx, n, 0)
    x0 = shard(initial_states.to(dev), idx, n, 0)

    def gather(a):
        return gather_shards(a, group, 0)

    def most(steps: int) -> int:
        return int(pmax(torch.tensor(steps, device=dev), group))

    return u, x0, gather, most


def solve_stream_sharded(
    ocp: OCP,
    controls,        # (N, T, nu) pool, N divisible by the mesh dimension
    initial_states,  # (N, nx)
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    axis_name: str = "batch",
    **stream_kwargs,
) -> StreamSolution:
    """The pool split over the mesh's ``axis_name`` dimension, one
    :func:`solve_stream` per rank with ``lanes`` resident lanes (on a card
    the packed stream's mega kernel and lane-open kernel under
    ``BATCH_CONFIG``).  Every rank passes the whole pool and gets every
    scenario's solution back; ``steps`` is the most any rank took (the
    slowest rank bounds the wall clock).  Other keyword arguments
    (``warm_transfer``, ``transfer_bp``) go to each rank's stream; the
    per-scenario ``bp_init``/``rp_init`` are refused, as in JAX: fold them
    into ``cfg`` or use :func:`solve_stream`.
    """
    bad = {"bp_init", "rp_init"} & set(stream_kwargs)
    if bad:
        raise ValueError(
            f"solve_stream_sharded: {sorted(bad)} cannot be forwarded: the "
            "entry shards only the pool's controls and initial states; "
            "pre-fold the override into cfg or use solve_stream")
    u, x0, gather, most = _shard_pool(controls, initial_states, mesh,
                                      axis_name)
    sol = solve_stream(ocp, u, x0, cfg, lanes=lanes,
                       refill_every=refill_every, **stream_kwargs)
    return StreamSolution(gather(sol.controls), gather(sol.iterations),
                          most(sol.steps),
                          gather(sol.completed.to(torch.uint8)).bool())


def solve_stream_multigrid_sharded(
    ocp: OCP,
    ocp_coarse: OCP,
    coarsen: int,
    controls,        # (N, T, nu) pool, N divisible by the mesh dimension
    initial_states,  # (N, nx)
    mesh,
    cfg: SolverConfig = DEFAULT_CONFIG,
    lanes: int = 2048,
    refill_every: int = 16,
    axis_name: str = "batch",
    **mg_kwargs,
) -> MultigridSolution:
    """The pool split over the mesh's ``axis_name`` dimension, one
    :func:`solve_stream_multigrid` per rank (coarse solve, interpolation,
    fine re-entry and the per-scenario fallback all stay on the rank).
    Other keyword arguments (``coarse_impl="ddp"``, bench.py's default;
    ``fine_impl``, ``fine_bp_init``, ``fine_reg_init``, ``coarse_solver``)
    go to each rank's solve; both levels' ``steps`` are the most any rank
    took."""
    u, x0, gather, most = _shard_pool(controls, initial_states, mesh,
                                      axis_name)
    sol = solve_stream_multigrid(ocp, ocp_coarse, coarsen, u, x0, cfg,
                                 lanes=lanes, refill_every=refill_every,
                                 **mg_kwargs)
    return MultigridSolution(
        controls=gather(sol.controls),
        iterations=gather(sol.iterations),
        iterations_coarse=gather(sol.iterations_coarse),
        steps=most(sol.steps),
        steps_coarse=most(sol.steps_coarse),
        fallback=gather(sol.fallback.to(torch.uint8)).bool(),
        completed=gather(sol.completed.to(torch.uint8)).bool(),
    )
