"""The whole nonlinear interior-point Newton solve with the horizon sharded
over ranks (counterpart of ``ipoc_tpu/solvers/time_sharded.py``).

Derivatives, costates, the Riccati backward and forward passes, trial
updates, the cost and feasibility reductions, the barrier schedule and the
nonlinear rollouts all run on each rank's slice of the stages; every rank
of the mesh's ``"time"`` group calls the same function (one process per
rank, where JAX runs one ``shard_map``).

Per iteration each rank sends O(1) rows: one all-gather of the shard
aggregates in each of the three sharded scans (costates, Riccati backward,
linear forward; ``parallel/sharding.py``), the neighbour exchanges that
shift stages across the shard boundary, and the reductions of cost,
gradient norm, feasibility and predicted reduction.  Every reduction is an
all-gather combined in rank order, so every rank holds the same bits of
each value that steers a loop (cost, accept decision, gradient norm, the
"any lane live" flag) and the ranks' loops take the same branches: a rank
whose loop ran one more time would wait for ever in a collective.

The nonlinear rollout that opens a barrier stage is serial in time: a
chain of per-rank rollouts, each handing its last state to the next rank.
The Newton trial itself is the linear update, whose forward pass is a
scan.

On a card the local scans are the affine-scan (#15) and value-scan (#16)
kernels; the rest is plain tensor code, as it was plain XLA in JAX.  As in
the rest of the port, the functions are batched over a leading lane axis:
per-stage arrays are ``(B, T_local, ...)`` and per-lane values ``(B,)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.derivatives import (
    final_gradient,
    final_hessian,
    first_order_stages,
    hamiltonian_lqr_stages,
)
from ipoc_tpu_torch.ops.scan_kernels import affine_scan
from ipoc_tpu_torch.parallel.costates import affine_combine
from ipoc_tpu_torch.parallel.lqt import _mv, newton_lqt
from ipoc_tpu_torch.parallel.sharding import (
    all_gather,
    axis_size,
    combine_across_shards,
    gather_shards,
    pall,
    pany,
    pmax,
    psum,
    rank_device,
    shard,
)
from ipoc_tpu_torch.parallel.time_sharded import (
    TIME_AXIS,
    par_bwd_pass_time_sharded,
    par_fwd_pass_time_sharded,
    shift_left_across_shards,
)
from ipoc_tpu_torch.problem import OCP, LinearizedOCP, stage_sum
from ipoc_tpu_torch.solvers.barrier import barrier_loop
from ipoc_tpu_torch.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu_torch.solvers.ip_newton import (
    _lane_scalars,
    _stage_tol,
    _where,
    flat_total_cap,
)
from ipoc_tpu_torch.utils.integrators import rollout


def sharded_rollout(dynamics, u_local, x0, group):
    """Nonlinear open-loop rollout of ``u_local (B, T_local, nu)`` with the
    horizon sharded over ``group``: rank j rolls its slice out once rank
    j - 1 has handed it its last state (one all-gather per hand-off).

    Returns the local stage states ``(B, T_local, nx)`` and the terminal
    state ``(B, nx)`` on every rank.  The chain spans the whole horizon,
    once per barrier stage, not per Newton iteration.
    """
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    start, xs, x_end = x0, None, None
    for j in range(n):
        if idx == j:
            traj = rollout(dynamics, u_local, start)
            xs, x_end = traj[:, :-1], traj[:, -1]
        if j < n - 1:
            ends = all_gather(x_end if idx == j else torch.zeros_like(x0),
                              group)
            if idx == j + 1:
                start = ends[j]
    return xs, all_gather(x_end, group)[n - 1]


def _per_lane(bp):
    """A 0-dim or ``(B,)`` barrier parameter against ``(B, T)`` stage
    costs."""
    return bp[..., None] if bp.dim() else bp


def _total_cost_sharded(ocp: OCP, xs_local, u_local, xT, bp, group):
    """Barrier total cost per lane: the ranks' stage-cost sums added in
    rank order, plus the terminal cost (the same on every rank)."""
    ct = ocp.stage_cost(xs_local, u_local, _per_lane(bp))
    return psum(stage_sum(ct), group) + ocp.final_cost(xT)


def _feasible_sharded(ocp: OCP, xs_local, u_local, group):
    cons = ocp.constraints(xs_local, u_local)
    return pall((cons <= 0).flatten(1).all(1), group)


def _next_costates_sharded(ocp: OCP, d, xT, group):
    """``lam_{k+1}`` for each local stage k (what the Hamiltonian contracts
    with): the sharded suffix scan of the affine costate elements (the
    local phase in the affine-scan kernel on a card), then a shift one
    stage earlier across the shard boundary."""
    lam_T = final_gradient(ocp, xT)
    F = d.fx.transpose(-1, -2)
    local = affine_scan(F.contiguous(), d.cx.contiguous(), reverse=True)
    Fs, cs = combine_across_shards(affine_combine, local, group,
                                   reverse=True)
    lam = _mv(Fs, lam_T[:, None]) + cs
    return shift_left_across_shards(lam, lam_T, group)


def _stage_quantities_sharded(ocp: OCP, cfg: SolverConfig, group, xs, xT,
                              u, bp):
    """Once-per-iteration trial inputs for horizon-sharded lanes: the cost,
    first-order stage data, the Newton stage data, the global ``||cu||_F``
    Levenberg scale (``None`` when ``scale_reg_by_grad`` is off) and the
    terminal weight (``Q`` at global stage 0, on rank 0, under
    ``terminal_hessian="reference"``).  Shared by the staged solver's
    single and retry bodies and the batched flat evaluator."""
    cost = _total_cost_sharded(ocp, xs, u, xT, bp, group)
    d = first_order_stages(ocp, xs, u, bp)
    lam_next = _next_costates_sharded(ocp, d, xT, group)
    lin = hamiltonian_lqr_stages(ocp, xs, u, lam_next, bp)
    nrm = (psum(stage_sum((d.cu * d.cu).flatten(-2)), group).sqrt()
           if cfg.scale_reg_by_grad else None)
    if cfg.terminal_hessian == "reference":
        XT = all_gather(lin.Q[:, 0], group)[0]
    else:
        XT = final_hessian(ocp, xT)
    return cost, d, lin, nrm, XT


def _trial_step_sharded(ocp: OCP, cfg: SolverConfig, group, xs, xT, u, x0,
                        bp, rp, d, lin: LinearizedOCP, nrm, XT):
    """One regularized LQT trial from the stage quantities: ``(temp_xs,
    temp_xT, temp_u, pred, bwd_feasible, Hu_norm, new_cost)``."""
    reg = rp if nrm is None else rp * torch.clamp(nrm, min=cfg.reg_scale_floor)
    eye_u = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    lin_reg = LinearizedOCP(lin.r, lin.Q,
                            lin.R + reg[:, None, None, None] * eye_u, lin.M)
    lqt = newton_lqt(lin_reg, d, XT)
    Kx, kff, _, _, pred, bwd_feasible = par_bwd_pass_time_sharded(lqt, group)
    du, dxs, dxT = par_fwd_pass_time_sharded(
        lqt, torch.zeros_like(x0), Kx, kff, group, with_terminal=True)
    temp_u, temp_xs, temp_xT = u + du, xs + dxs, xT + dxT
    Hu_norm = pmax(lin.r.abs().flatten(1).amax(1), group)
    new_cost = torch.where(
        _feasible_sharded(ocp, temp_xs, temp_u, group),
        _total_cost_sharded(ocp, temp_xs, temp_u, temp_xT, bp, group),
        torch.full_like(pred, float("inf")))
    return temp_xs, temp_xT, temp_u, pred, bwd_feasible, Hu_norm, new_cost


def _newton_stage_sharded(ocp: OCP, u, x0, bp, cfg: SolverConfig, group):
    """One barrier stage, horizon-sharded, with the single-trial or the
    retry globalization; returns ``(u, iterations)``.

    ``"single"`` is ``ip_newton._newton_stage_par_single`` stage for stage;
    ``"retry"`` is ``_newton_stage_par``: per Newton iteration the stage
    quantities once, then trials with growing regularization until one is
    accepted, adopted on the retry loop's exit unless it stalled or is not
    finite.  Each loop predicate is read from values every rank holds
    bit for bit, so every rank runs the same trials.
    """
    xs, xT = sharded_rollout(ocp.dynamics, u, x0, group)
    start_ok = torch.isfinite(_total_cost_sharded(ocp, xs, u, xT, bp, group))
    Hu_norm = torch.where(
        start_ok, torch.ones_like(start_ok, dtype=bp.dtype),
        torch.full_like(start_ok, float("nan"), dtype=bp.dtype))
    t, rp, r_inc = _lane_scalars(u, cfg)
    tol = _stage_tol(cfg, bp)
    retry = cfg.globalization == "retry"
    while True:
        run = ~((Hu_norm < tol) | (t > cfg.max_newton_iters)
                | ~torch.isfinite(Hu_norm))
        if not bool(run.any()):
            break
        cost, d, lin, nrm, XT = _stage_quantities_sharded(
            ocp, cfg, group, xs, xT, u, bp)

        def trial_once(rp):
            return _trial_step_sharded(ocp, cfg, group, xs, xT, u, x0, bp,
                                       rp, d, lin, nrm, XT)

        if retry:
            txs, txT, tu = xs, xT, u
            hn = torch.zeros_like(Hu_norm)
            success = torch.zeros_like(run)
            stalled = torch.zeros_like(run)
            rp_i, ri = rp, r_inc
            k = torch.zeros_like(t)
            while True:
                stop = (success | (k > cfg.max_inner_iters) | stalled
                        | ((k > 0) & ~torch.isfinite(hn)))
                act = run & ~stop
                if not bool(act.any()):
                    break
                nxs, nxT, nu_, pred, bwd_ok, h, new_cost = trial_once(rp_i)
                rho = gain_ratio(new_cost, cost, pred)
                ok = (rho > 0.0) & bwd_ok
                stall = ~ok & (rp_i >= cfg.reg_max) & bool(cfg.stall_exit)
                nrp, nri = lm_update(rp_i, ri, rho, ok, cfg)
                txs, txT, tu = (_where(act, nxs, txs), _where(act, nxT, txT),
                                _where(act, nu_, tu))
                hn = torch.where(act, h, hn)
                success = torch.where(act, ok, success)
                stalled = torch.where(act, stall, stalled)
                rp_i = torch.where(act, nrp, rp_i)
                ri = torch.where(act, nri, ri)
                k = k + act.to(k.dtype)
            # Adopt on the retry loop's exit, but not a stalled or
            # non-finite trial.
            trial_ok = (torch.isfinite(psum(tu.sum((1, 2)), group))
                        & torch.isfinite(psum(txs.sum((1, 2)), group))
                        & ~stalled)
            keep = run & trial_ok
            xs, xT, u = _where(keep, txs, xs), _where(keep, txT, xT), \
                _where(keep, tu, u)
            hn = torch.where(stalled, torch.full_like(hn, float("nan")), hn)
            Hu_norm = torch.where(run, hn, Hu_norm)
            rp, r_inc = torch.where(run, rp_i, rp), torch.where(run, ri, r_inc)
        else:
            txs, txT, tu, pred, bwd_ok, hn, new_cost = trial_once(rp)
            rho = gain_ratio(new_cost, cost, pred)
            accept = (rho > 0.0) & bwd_ok
            stalled = ~accept & (rp >= cfg.reg_max) & bool(cfg.stall_exit)
            nrp, nri = lm_update(rp, r_inc, rho, accept, cfg)
            keep = run & accept
            xs, xT, u = _where(keep, txs, xs), _where(keep, txT, xT), \
                _where(keep, tu, u)
            hn = torch.where(stalled, torch.full_like(hn, float("nan")), hn)
            if cfg.pred_floor > 0.0:
                tiny = bwd_ok & (pred.abs()
                                 < cfg.pred_floor * (1.0 + cost.abs()))
                hn = torch.where(tiny, torch.zeros_like(hn), hn)
            Hu_norm = torch.where(run, hn, Hu_norm)
            rp, r_inc = torch.where(run, nrp, rp), torch.where(run, nri, r_inc)
        t = t + run.to(t.dtype)
    return u, t


def _check_time_sharded(cfg: SolverConfig) -> None:
    if cfg.globalization not in ("single", "retry"):
        raise ValueError(
            "ip_newton_time_sharded supports globalization='single' or "
            "'retry' (the retry scalars are the same on every rank, so the "
            "inner loop shards as it is)")
    if cfg.newton_impl != "par":
        raise ValueError(
            "ip_newton_time_sharded evaluates trials with the "
            "parallel-in-time (time-sharded) LQT passes; set "
            "newton_impl='par'")


def ip_newton_time_sharded(ocp: OCP, controls, initial_state, mesh,
                           cfg: SolverConfig = DEFAULT_CONFIG,
                           axis_name: str = TIME_AXIS):
    """Interior-point Newton solve of one scenario with the horizon sharded
    over the mesh's ``axis_name`` dimension.

    Every rank passes the full ``controls (T, nu)`` (T divisible by the
    dimension's size) and ``initial_state (nx,)`` and gets ``(optimal
    controls (T, nu), total iterations)`` back, on its device
    (``parallel.sharding.rank_device``).  The iterates are those of
    ``par_interior_point_optimal_control(cfg)`` with ``newton_impl="par"``
    and ``globalization`` ``"single"`` or ``"retry"``: the sharding changes
    only where each stage is computed.
    """
    _check_time_sharded(cfg)
    n = axis_size(mesh, axis_name)
    T = controls.shape[0]
    if T % n != 0:
        raise ValueError(f"horizon {T} not divisible by {n} shards")
    group, idx = mesh.get_group(axis_name), mesh.get_local_rank(axis_name)
    dev = rank_device(controls)
    if dev.type == "cuda":
        cuda.disable_tf32()
    u_local = shard(controls.to(dev), idx, n, 0)[None]
    x0 = initial_state.to(dev)[None]
    u, it = barrier_loop(
        lambda u, bp: _newton_stage_sharded(ocp, u, x0, bp, cfg, group),
        u_local, cfg)
    return gather_shards(u[0], group, 0), it[0]


def _trial_eval_sharded(ocp: OCP, cfg: SolverConfig, group):
    """One time-sharded Newton trial evaluation of every local lane, with
    no control flow of its own, so every rank runs the same collectives:
    ``(cost, temp_xs, temp_xT, temp_u, pred, bwd_feasible, Hu_norm,
    new_cost)``, the quantities of ``ip_newton._trial_eval``."""

    def eval_lanes(xs, xT, u, x0, bp, rp):
        cost, d, lin, nrm, XT = _stage_quantities_sharded(
            ocp, cfg, group, xs, xT, u, bp)
        return (cost,) + _trial_step_sharded(ocp, cfg, group, xs, xT, u, x0,
                                             bp, rp, d, lin, nrm, XT)

    return eval_lanes


def ip_newton_batch_time_sharded(ocp: OCP, controls, initial_states, mesh,
                                 cfg: SolverConfig = DEFAULT_CONFIG,
                                 batch_axis: str = "batch",
                                 axis_name: str = TIME_AXIS):
    """The interior-point solve of N scenarios on a (batch x time) mesh:
    the scenarios split over ``batch_axis``, each scenario's horizon over
    ``axis_name``.  Every rank passes the full ``controls (N, T, nu)`` and
    ``initial_states (N, nx)`` and gets ``(controls (N, T, nu), iterations
    (N,))`` back.

    Every rank must run the same loop, so the solve runs in flat mode with
    masked lanes: one loop whose continue flag is "some lane of the mesh is
    live", gathered over the whole mesh.  Per lane this is the flat-mode
    single-trial solve (``barrier_mode="flat"``), with the stage predictor
    when ``cfg.stage_predictor`` is on (one more masked candidate rollout
    and cost a step).  The stage-opening rollout runs every step, masked,
    because it gathers across the time group.  ``globalization="retry"`` is
    refused, as in JAX: in lockstep every accepted lane would wait for the
    slowest lane's retries.
    """
    if cfg.globalization != "single" or cfg.newton_impl != "par":
        raise ValueError(
            "ip_newton_batch_time_sharded requires globalization='single' "
            "and newton_impl='par' (see ip_newton_time_sharded; retry is "
            "excluded: in lockstep every lane would wait for the slowest "
            "lane's retries)")
    nb, nt = axis_size(mesh, batch_axis), axis_size(mesh, axis_name)
    N, T = controls.shape[0], controls.shape[1]
    if N % nb != 0:
        raise ValueError(f"batch {N} not divisible by {nb} shards")
    if T % nt != 0:
        raise ValueError(f"horizon {T} not divisible by {nt} shards")
    tg, bg = mesh.get_group(axis_name), mesh.get_group(batch_axis)
    ti, bi = mesh.get_local_rank(axis_name), mesh.get_local_rank(batch_axis)
    dev = rank_device(controls)
    if dev.type == "cuda":
        cuda.disable_tf32()
    u = shard(shard(controls.to(dev), bi, nb, 0), ti, nt, 1)
    x0 = shard(initial_states.to(dev), bi, nb, 0)
    dtype, Nl = u.dtype, u.shape[0]
    eval_lanes = _trial_eval_sharded(ocp, cfg, tg)
    total_cap = flat_total_cap(cfg)

    def roll(u_):
        return sharded_rollout(ocp.dynamics, u_, x0, tg)

    def cost_of(xs_, u_, xT_, bp_):
        return _total_cost_sharded(ocp, xs_, u_, xT_, bp_, tg)

    def mesh_any(flag):
        # One gather over the world group: every rank of the mesh.
        return bool(pany(flag, None))

    def lanes(v):
        return torch.full((Nl,), v, dtype=dtype, device=dev)

    xs, xT = roll(u)
    bp = lanes(cfg.bp_init)
    start_ok = torch.isfinite(cost_of(xs, u, xT, bp))
    u_prev = u
    it = torch.zeros((Nl,), dtype=torch.int32, device=dev)
    stage_it = torch.zeros_like(it)
    rp, r_inc = lanes(cfg.reg_init), lanes(cfg.reg_inc_init)
    done = ~start_ok
    stage_reg = (cfg.reg_init if cfg.reg_stage_init is None
                 else cfg.reg_stage_init)
    cont = mesh_any(start_ok.any())
    while cont:
        adv = ~done
        cost, txs, txT, tu, pred, bwd_ok, hu, new_cost = eval_lanes(
            xs, xT, u, x0, bp, rp)
        rho = gain_ratio(new_cost, cost, pred)
        accept = (rho > 0.0) & bwd_ok
        stalled = ~accept & (rp >= cfg.reg_max) & bool(cfg.stall_exit)
        rp_new, ri_new = lm_update(rp, r_inc, rho, accept, cfg)
        rp = torch.where(adv, rp_new, rp)
        r_inc = torch.where(adv, ri_new, r_inc)
        accept = accept & adv
        xs, xT, u = _where(accept, txs, xs), _where(accept, txT, xT), \
            _where(accept, tu, u)

        conv = hu < _stage_tol(cfg, bp)
        if cfg.pred_floor > 0.0:
            conv = conv | (bwd_ok
                           & (pred.abs() < cfg.pred_floor * (1.0 + cost.abs())))
        bad = (~torch.isfinite(hu) | ~torch.isfinite(cost)) & adv
        advance = conv | stalled | (stage_it + 1 > cfg.max_newton_iters)
        advance = advance & ~bad & adv
        bp_next = bp / cfg.bp_decay
        done_now = bad | (advance & (bp_next <= cfg.bp_min))
        roll_mask = advance & ~done_now
        # The stage-opening rollout, masked per lane but run every step, so
        # that every rank makes the same collectives.
        rxs, rxT = roll(u)
        u_prev_new = _where(roll_mask, u, u_prev)
        if cfg.stage_predictor:
            # Central-path extrapolation, flat_lane_iter's semantics: one
            # more masked candidate rollout and cost; a NaN/inf predicted
            # cost loses the comparison.
            u_pred = u + (1.0 / cfg.bp_decay) * (u - u_prev)
            pxs, pxT = roll(u_pred)
            ca = cost_of(rxs, u, rxT, bp_next)
            cb = cost_of(pxs, u_pred, pxT, bp_next)
            # Only from the second transition on.
            take = roll_mask & (bp < cfg.bp_init) & (cb < ca)
            xs = _where(take, pxs, _where(roll_mask, rxs, xs))
            xT = _where(take, pxT, _where(roll_mask, rxT, xT))
            u = _where(take, u_pred, u)
        else:
            xs = _where(roll_mask, rxs, xs)
            xT = _where(roll_mask, rxT, xT)
        u_prev = u_prev_new
        bp = torch.where(advance, bp_next, bp)
        rp = torch.where(advance, torch.full_like(rp, stage_reg), rp)
        r_inc = torch.where(advance, torch.full_like(r_inc, cfg.reg_inc_init),
                            r_inc)
        tick = adv.to(torch.int32)
        it = it + tick
        stage_it = torch.where(advance, torch.zeros_like(stage_it),
                               stage_it + tick)
        done = done | done_now | (it >= total_cap)
        # Every rank of the mesh must take the same branch.
        cont = mesh_any((~done).any())
    u = gather_shards(gather_shards(u, tg, 1), bg, 0)
    return u, gather_shards(it, bg, 0)
