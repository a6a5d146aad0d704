"""The packed streaming executor (counterpart of
``ipoc_tpu/solvers/packed_stream.py``).

The stream of ``solvers/stream.py`` with the lane state kept in the
kernels' layout across iterations, so no iteration relayouts it:

* the layout is batch-last: stage arrays ``(T, rows, B)`` (the trajectory's
  stages 0..T-1 and the controls), terminal and initial states ``(nx, B)``,
  per-lane scalars ``(B,)``; one scenario per column, so a kernel's
  neighbouring threads read neighbouring addresses;
* the default executor is the mega kernel (``ops/mega.py``): each refill
  round is one launch of ``refill_every`` lane iterations (trial, accept,
  convergence tests, and the stage transition only for a lane that rolls
  over), updating the lanes in place, and one host read of the steps it
  ran;
* the two-launch arm (``mega=False``) runs :func:`packed_lane_iter` per
  iteration: the fused trial (two launches; DDP: the merged kernel's one)
  and the stage-transition kernel, which runs on every lane every
  iteration (as in JAX), so that which lanes roll over is never read on
  the host;
* the Levenberg scale ``||cu||_F`` is carried per lane (``cun``), summed in
  the kernels at the trial point and at the transition candidates, instead
  of a gradient pass per iteration;
* lanes are packed and unpacked only at capture and refill, once per
  ``refill_every`` iterations; opening and refilling lanes is one
  rollout-cost launch per round.

:func:`solve_batch_packed` is the lockstep flat batch in the same layout
(no pool, no refill): bench.py's NMPC resolver, with a warm barrier entry
(``bp_entry``).  The stream's ``warm_transfer`` reopens a refilled lane
from the finished lane's controls.  Both open a lane a second time at a
warm barrier and keep the cold open where the warm one is infeasible.

Per-lane semantics are those of ``flat_lane_iter`` with the fused or DDP
evaluator; the one numerical difference is the summation order of
``||cu||_F``, which can flip an accept decision within rounding
(converged solutions agree to solver tolerance).  On the CPU every kernel
is its plain version.  The JAX package's TPU machinery is not ported: the
sublane and VMEM gates (``batch_packed_eligible`` among them: the port
takes any B), the streamed mega kernel's dispatch (the one mega kernel
takes every horizon, ``ops/mega.py``), the environment switches
(``mega=False`` replaces ``IPOC_MEGA_KERNEL=0``; ``IPOC_PACKED_FORCE`` has
nothing to force) and the ``interpret`` argument (the device of the
inputs picks the kernels or their plain versions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import SolverConfig
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.fused_iter import (
    fused_newton_iter_packed,
    fused_newton_iter_plain,
    rollout_cost_packed,
    rollout_cost_plain,
    transition_packed,
    transition_plain,
)
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap


class PackedLane(NamedTuple):
    """Flat-mode lane state, batch-last (one scenario per column)."""

    x0: torch.Tensor        # (nx, B) scenario initial states
    xs: torch.Tensor        # (T, nx, B) trajectory stages 0..T-1
    xT: torch.Tensor        # (nx, B) terminal states
    u: torch.Tensor         # (T, nu, B) controls
    u_prev: torch.Tensor    # (T, nu, B) previous stage's controls
    cun: torch.Tensor       # (B,) ||cu||_F at the current iterate
    it: torch.Tensor        # (B,) int32 total Newton iterations
    stage_it: torch.Tensor  # (B,) int32 iterations in the current stage
    rp: torch.Tensor        # (B,) LM regularization
    r_inc: torch.Tensor     # (B,) LM growth factor
    bp: torch.Tensor        # (B,) barrier parameter
    bp0: torch.Tensor       # (B,) the lane's starting barrier parameter
    done: torch.Tensor      # (B,) bool: solve complete


def packed_lane_init(ocp: OCP, u, x0, bp0, rp0,
                     cfg: SolverConfig) -> PackedLane:
    """Open packed lanes: one rollout-cost launch.

    ``u (T, nu, B)``, ``x0 (nx, B)``, ``bp0``/``rp0 (B,)``.  A lane whose
    warm-start barrier cost is non-finite opens with ``done=True`` (it=0).
    """
    xs, xT, cost, cunsq = rollout_cost_packed(ocp, u, x0, bp0)
    B = u.shape[-1]

    def zi():
        return torch.zeros((B,), dtype=torch.int32, device=u.device)

    # Every field owns its storage (the mega kernel updates the lane in
    # place): nothing aliases another field or the caller's tensors.
    return PackedLane(
        x0=x0.clone(), xs=xs, xT=xT, u=u.clone(), u_prev=u.clone(),
        cun=torch.sqrt(cunsq), it=zi(), stage_it=zi(), rp=rp0.clone(),
        r_inc=torch.full_like(rp0, cfg.reg_inc_init), bp=bp0.clone(),
        bp0=bp0.clone(), done=~torch.isfinite(cost))


def packed_lane_iter(ocp: OCP, lane: PackedLane, cfg: SolverConfig,
                     adv, plain: bool = False) -> PackedLane:
    """One Newton (or, with ``newton_impl="ddp"``, DDP) iteration and
    stage-transition step on packed lanes.

    Per-lane semantics are ``flat_lane_iter``'s, with the Levenberg scale
    read from the lane's kernel-accumulated ``cun``.  ``adv (B,)`` masks
    lanes: a lane with ``adv=False`` comes back unchanged.  The evaluators
    are the kernels on a card and their plain versions on the CPU;
    ``plain`` takes the plain versions on a card too (the mega kernel's
    plain version).  Out of place: the lane passed in is not modified.
    """
    ddp = cfg.newton_impl == "ddp"
    if plain:
        trial, transition, roll_cost = (fused_newton_iter_plain,
                                        transition_plain, rollout_cost_plain)
    else:
        trial, transition, roll_cost = (fused_newton_iter_packed,
                                        transition_packed, rollout_cost_packed)
    if ddp or cfg.scale_reg_by_grad:
        # DDP scales the Levenberg parameter by ||cu|| unconditionally.
        reg = lane.rp * torch.clamp(lane.cun, min=cfg.reg_scale_floor)
    else:
        reg = lane.rp
    (tu, tx, txT, cost, nc, mc, pred, piv, hu, cun_t) = trial(
        ocp, lane.xs, lane.xT, lane.u, lane.bp, reg, ddp=ddp)
    ok = torch.isfinite(piv) & (piv > 0) & torch.isfinite(pred)
    new_cost = torch.where(mc <= 0.0, nc, torch.full_like(nc, float("inf")))

    rho = gain_ratio(new_cost, cost, pred)
    accept = (rho > 0.0) & ok
    stalled = ~accept & (lane.rp >= cfg.reg_max) & bool(cfg.stall_exit)
    rp_new, ri_new = lm_update(lane.rp, lane.r_inc, rho, accept, cfg)
    rp = torch.where(adv, rp_new, lane.rp)
    r_inc = torch.where(adv, ri_new, lane.r_inc)
    accept = accept & adv

    xs = torch.where(accept, tx, lane.xs)
    xT = torch.where(accept, txT, lane.xT)
    u = torch.where(accept, tu, lane.u)
    cun = torch.where(accept, torch.sqrt(cun_t), lane.cun)

    tol_s = torch.clamp(cfg.stage_tol_scale * lane.bp, min=cfg.tol)
    conv = hu < tol_s
    if cfg.pred_floor > 0.0:
        conv = conv | (ok & (pred.abs() < cfg.pred_floor * (1.0 + cost.abs())))
    bad = (~torch.isfinite(hu) | ~torch.isfinite(cost)) & adv
    advance = conv | stalled | (lane.stage_it + 1 > cfg.max_newton_iters)
    advance = advance & ~bad & adv
    bp_next = lane.bp / cfg.bp_decay
    done_now = bad | (advance & (bp_next <= cfg.bp_min))
    roll = advance & ~done_now
    u_prev = torch.where(roll, u, lane.u_prev)
    if cfg.stage_predictor:
        # Continuation predictor: both candidates on every lane (no host
        # read of which lanes roll); a NaN/inf predicted cost loses every
        # comparison.  Only from the second transition on.
        u_pred = u + (1.0 / cfg.bp_decay) * (u - lane.u_prev)
        xa, xb, xaT, xbT, ca, cb, cua, cub = transition(
            ocp, u, u_pred, lane.x0, bp_next)
        take = roll & (lane.bp < lane.bp0) & (cb < ca)
        xs = torch.where(take, xb, torch.where(roll, xa, xs))
        xT = torch.where(take, xbT, torch.where(roll, xaT, xT))
        u = torch.where(take, u_pred, u)
        cun = torch.where(take, torch.sqrt(cub),
                          torch.where(roll, torch.sqrt(cua), cun))
    else:
        xr, xrT, _, cur = roll_cost(ocp, u, lane.x0, bp_next)
        xs = torch.where(roll, xr, xs)
        xT = torch.where(roll, xrT, xT)
        cun = torch.where(roll, torch.sqrt(cur), cun)
    bp = torch.where(advance, bp_next, lane.bp)
    stage_reg = (cfg.reg_init if cfg.reg_stage_init is None
                 else cfg.reg_stage_init)
    rp = torch.where(advance, torch.full_like(rp, stage_reg), rp)
    r_inc = torch.where(advance, torch.full_like(r_inc, cfg.reg_inc_init),
                        r_inc)
    tick = adv.to(torch.int32)
    stage_it = torch.where(advance, torch.zeros_like(lane.stage_it),
                           lane.stage_it + tick)
    return PackedLane(
        x0=lane.x0, xs=xs, xT=xT, u=u, u_prev=u_prev, cun=cun,
        it=lane.it + tick, stage_it=stage_it, rp=rp, r_inc=r_inc, bp=bp,
        bp0=lane.bp0, done=lane.done | done_now)


def select_lanes(ok, new: PackedLane, old: PackedLane) -> PackedLane:
    """Per lane, ``new``'s fields where ``ok (B,)`` holds, else ``old``'s:
    fresh tensors, so the selected lane owns its storage (the mega kernel
    writes lanes in place)."""
    return PackedLane(*(torch.where(ok, n, o) for n, o in zip(new, old)))


def _check_packed(cfg: SolverConfig) -> None:
    """What the packed executors run: the fused or DDP evaluator, one trial
    per iteration, the exact terminal Hessian."""
    if cfg.newton_impl not in ("fused", "ddp"):
        raise ValueError("the packed stream runs newton_impl='fused' or "
                         f"'ddp'; got {cfg.newton_impl!r}")
    if cfg.globalization != "single":
        raise ValueError("the packed stream requires globalization='single'")
    if cfg.terminal_hessian != "exact":
        raise ValueError("the fused evaluators compute the terminal Hessian "
                         "in-kernel and require terminal_hessian='exact'")


def _pack(controls, initial_states):
    """Scenario rows ``(n, T, nu)``, ``(n, nx)`` -> batch-last lanes."""
    return (controls.permute(1, 2, 0).contiguous(),
            initial_states.T.contiguous())


def solve_stream_packed(
    ocp: OCP,
    controls,        # (N, T, nu) per-scenario warm starts
    initial_states,  # (N, nx)
    cfg: SolverConfig,
    lanes: int = 2048,
    refill_every: int = 16,
    bp_init=None,    # optional (N,) per-scenario barrier start
    rp_init=None,    # optional (N,) per-scenario initial LM damping
    warm_transfer: bool = False,
    transfer_bp: float = 0.02,
    mega: bool = True,
):
    """The packed stream: ``solve_stream``'s scheduling and per-scenario
    results with the fused (``newton_impl="fused"``) or DDP (``"ddp"``)
    evaluator.  Returns a ``StreamSolution``.

    Each refill round is one :func:`ops.mega.mega_k_iterations` launch of
    ``refill_every`` lane iterations, then one host read of the steps it
    ran, then the capture and refill (JAX's mega executor).  ``mega=False``
    takes the two-launch arm instead: up to ``refill_every`` calls of
    :func:`packed_lane_iter`, with one host read per step for the loop
    predicate (JAX's ``IPOC_MEGA_KERNEL=0``).  Runs on the device of
    ``controls``: the kernels on a card, their plain versions on the CPU.
    Requires ``globalization="single"`` and ``terminal_hessian="exact"``.

    ``warm_transfer``: the scenario that refills a finished lane opens from
    that lane's own controls (read after the round's iterations, as the
    capture reads them) with its own initial state, at barrier
    ``transfer_bp`` and damping ``reg_init``: one more rollout-cost launch
    per refill round.  Where that open is infeasible (a non-finite barrier
    cost) the lane falls back to the scenario's cold open.  It changes
    which basin a multi-modal scenario lands in, and it overrides the
    refill's barrier and damping, so it refuses ``bp_init``/``rp_init``.
    """
    from ipoc_tpu_torch.ops.mega import mega_k_iterations, mega_workspace
    from ipoc_tpu_torch.solvers.stream import StreamSolution

    _check_packed(cfg)
    if warm_transfer and (bp_init is not None or rp_init is not None):
        raise ValueError(
            "warm_transfer overrides the refill barrier/damping for "
            "feasible transferred lanes, silently defeating per-scenario "
            "bp_init/rp_init: use one or the other")
    N, T, nu = controls.shape
    B = min(lanes, N)
    dtype, device = controls.dtype, controls.device
    if device.type == "cuda":
        cuda.disable_tf32()
    if bp_init is None:
        bp_init = torch.full((N,), cfg.bp_init, dtype=dtype, device=device)
    if rp_init is None:
        rp_init = torch.full((N,), cfg.reg_init, dtype=dtype, device=device)

    def open_lanes(rows):
        u, x0 = _pack(controls[rows], initial_states[rows])
        return packed_lane_init(ocp, u, x0, bp_init[rows].contiguous(),
                                rp_init[rows].contiguous(), cfg)

    lane = open_lanes(torch.arange(B, device=device))
    workspace = mega_workspace(lane) if mega else None
    ddp = cfg.newton_impl == "ddp"
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
        if mega:
            # K iterations in one launch; each lane stops once it is done.
            lane, dt = mega_k_iterations(ocp, lane, active, cfg, K, ddp,
                                         workspace)
            steps += int(dt)
        else:
            # Up to K iterations, exiting early once every live lane is
            # finished (one host read per step, so that `steps` counts the
            # JAX package's lockstep steps).
            for _ in range(K):
                adv = active & ~lane.done
                if not bool(adv.any()):
                    break
                lane = packed_lane_iter(ocp, lane, cfg, adv)
                steps += 1

        # 1. Capture finished scenarios: each finished lane to its own row.
        fin = (lane.done & active).nonzero().squeeze(1)
        rows = sid[fin]
        out_u.index_copy_(0, rows, lane.u[..., fin].permute(2, 0, 1))
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
            fresh = open_lanes(new)
            if warm_transfer:
                # The finished lanes' controls, the new scenarios' states.
                bpw = torch.full((n_take,), transfer_bp, dtype=dtype,
                                 device=device)
                warm = packed_lane_init(
                    ocp, lane.u[..., take].contiguous(),
                    initial_states[new].T.contiguous(), bpw,
                    torch.full_like(bpw, cfg.reg_init), cfg)
                fresh = select_lanes(~warm.done, warm, fresh)
            lane = PackedLane(*(a.index_copy(-1, take, f)
                                for a, f in zip(lane, fresh)))
            sid = sid.index_copy(0, take, new)
            pool_next += n_take
        active = active.index_fill(0, fin[n_take:], False)

    return StreamSolution(out_u, out_it, steps, out_done)


def solve_batch_packed(
    ocp: OCP,
    controls,        # (B, T, nu) warm starts
    initial_states,  # (B, nx)
    cfg: SolverConfig,
    k_block: int = 32,
    bp_entry: float | None = None,
):
    """Lockstep flat batch solve in the packed layout on the mega kernel
    (JAX ``solve_batch_packed``): bench.py's NMPC resolver.

    The lanes are opened once (one rollout-cost launch), then k-blocks of
    :func:`ops.mega.mega_k_iterations` (``k_block`` iterations a launch,
    every lane active; DDP mode with ``newton_impl="ddp"``) run on one
    workspace until no lane is live or ``flat_total_cap(cfg) // k_block +
    2`` blocks have run; one host read per block (is any lane live?) is
    the only sync.  Returns ``(controls (B, T, nu), iterations (B,)
    int32)``.  Per-lane semantics are ``flat_lane_iter``'s, up to the
    packed ``||cu||`` summation order.  Runs on the device of
    ``controls``: the kernels on a card, their plain versions on the CPU.

    ``bp_entry``: a warm resolve from the caller's own previous plan opens
    the lanes a second time, at barrier ``bp_entry`` from the same
    controls (a second rollout-cost launch), and keeps that open on every
    lane where it is not ``done`` (its barrier cost is finite); the other
    lanes keep their cold open at ``cfg.bp_init``.  A fallback lane runs
    the full cold schedule under the caller's config, so it inherits the
    iteration cap the caller chose for warm resolves (as in JAX).  A start
    that is not near-optimal takes more iterations at ``bp_entry`` than
    cold: keep the first resolve cold.

    Not ported, being TPU machinery: the sublane and VMEM gates
    (``batch_packed_eligible``, ``mega_supported``), ``IPOC_PACKED_FORCE``
    and ``interpret``; the port takes any B.
    """
    from ipoc_tpu_torch.ops.mega import mega_k_iterations, mega_workspace

    _check_packed(cfg)
    B = controls.shape[0]
    dtype, device = controls.dtype, controls.device
    if device.type == "cuda":
        cuda.disable_tf32()
    u, x0 = _pack(controls, initial_states)
    bp0 = torch.full((B,), cfg.bp_init, dtype=dtype, device=device)
    rp0 = torch.full((B,), cfg.reg_init, dtype=dtype, device=device)
    lane = packed_lane_init(ocp, u, x0, bp0, rp0, cfg)
    if bp_entry is not None:
        warm = packed_lane_init(ocp, u, x0, torch.full_like(bp0, bp_entry),
                                rp0, cfg)
        lane = select_lanes(~warm.done, warm, lane)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    workspace = mega_workspace(lane)
    ddp = cfg.newton_impl == "ddp"
    for _ in range(flat_total_cap(cfg) // k_block + 2):
        if not bool((~lane.done).any()):
            break
        lane, _ = mega_k_iterations(ocp, lane, active, cfg, k_block, ddp,
                                    workspace)
    return lane.u.permute(2, 0, 1).contiguous(), lane.it
