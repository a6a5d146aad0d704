"""Interior-point Newton solvers (counterpart of
``ipoc_tpu/solvers/ip_newton.py``): the parallel-in-time solve
``par_interior_point_optimal_control`` (retry or single-trial
globalization, staged or flat barrier schedule), the sequential validation
solve ``seq_interior_point_optimal_control``, and the flat-mode lanes that
the unpacked stream and the batch solves run with every step evaluator
(``newton_impl`` "par", "seq", "fused" or "ddp").

Everything is batched by hand over a leading lane axis B: what JAX wrote
per scenario under ``vmap`` is written here on ``(B, ...)`` tensors.  A
while loop runs while any lane's predicate holds (one host read per
predicate) and every per-lane update is masked, so per-lane results equal
the single solves.  Per-lane values (regularization, iteration counts) are
``(B,)`` tensors; the staged schedule's barrier parameter is one 0-dim
tensor in the controls' dtype.

On a card the Pallas kernels of these paths run as hand-written CUDA
kernels: the parallel trial as one launch of the fused trial kernel
(``ops/newton_kernel.py``), the parallel costates as the affine-scan kernel
(``ops/scan_kernels.py``), for ``"seq"`` the costate recursion and the
sequential trial (``ops/cuda/seq_newton.py``), and for ``"fused"`` and
``"ddp"`` the whole trial evaluation (two launches; DDP: the merged
kernel's one), the flat lanes' rollout and their stage transition
(``ops/fused_iter.py``).  Those kernels are batch-last, ``(T, rows, B)``;
the lanes stay batch-first, so each call transposes its inputs and
outputs.  Derivatives, the staged solves' stage-start rollouts and the
sequential solver's Riccati recursion are plain tensor code, as they were
plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, jacrev

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.ops import cuda, linalg
from ipoc_tpu_torch.ops.cuda.seq_newton import seq_newton_trial_batched
from ipoc_tpu_torch.ops.derivatives import (
    check_feasibility,
    compute_first_order,
    compute_hamiltonian_lqr,
    final_hessian,
    over_leading,
)
from ipoc_tpu_torch.ops.fused_iter import (
    fused_newton_iter_packed,
    lanes_first,
    lanes_last,
    rollout_packed,
    stage_cu,
    transition_packed,
)
from ipoc_tpu_torch.ops.newton_kernel import fused_newton_step
from ipoc_tpu_torch.parallel.costates import par_costates, seq_costates
from ipoc_tpu_torch.problem import (
    OCP,
    Derivatives,
    LinearizedOCP,
    stage_norm,
    stage_sum,
)
from ipoc_tpu_torch.solvers.barrier import barrier_loop, n_barrier_stages
from ipoc_tpu_torch.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu_torch.utils.integrators import rollout

_IMPLS = ("par", "seq", "fused", "ddp")


def check_newton_impl(cfg: SolverConfig) -> None:
    """The step evaluators of the lanes and the solves; nothing else is
    substituted."""
    if cfg.newton_impl not in _IMPLS:
        raise ValueError(f"unknown newton_impl {cfg.newton_impl!r}")


def _lane_view(mask, like):
    """A (B,) lane mask shaped to broadcast against ``like`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _regularized(lin: LinearizedOCP, d: Derivatives, rp, scale_by_grad: bool,
                 scale_floor: float = 1e-6):
    """Levenberg regularization of the control Hessian block:
    ``R += rp * max(||cu||_F, floor) * I`` per lane (the Frobenius norm over
    the lane's whole horizon), or ``R += rp * I`` unscaled."""
    if scale_by_grad:
        rp = rp * torch.clamp(stage_norm(d.cu), min=scale_floor)
    nu = lin.R.shape[-1]
    eye = torch.eye(nu, dtype=lin.R.dtype, device=lin.R.device)
    R = lin.R + rp[:, None, None, None] * eye
    return LinearizedOCP(lin.r, lin.Q, R, lin.M)


def _costates(ocp: OCP, x_last, d: Derivatives, cfg: SolverConfig):
    """Costates matched to the step evaluator: the parallel-in-time scan
    (affine-scan kernel on a card) for ``newton_impl="par"``, the
    sequential recursion (costate kernel on a card) for ``"seq"``; the
    same values either way."""
    check_newton_impl(cfg)
    if cfg.newton_impl == "seq":
        return seq_costates(ocp, x_last, d)
    return par_costates(ocp, x_last, d)


def par_newton_step(ocp: OCP, x, d: Derivatives, rp, lin: LinearizedOCP,
                    cfg: SolverConfig):
    """One regularized Newton trial step per lane.

    Returns ``(dx, du, pred_reduction, feasible, Hu)``; the forward pass
    starts from zero deviation, so (dx, du) are additive updates.

    * ``newton_impl="par"``: the parallel-in-time LQT solve, on a card one
      launch of the fused trial kernel, on the CPU its plain version (the
      ``newton_lqt`` -> ``par_bwd_pass`` -> ``par_fwd_pass`` pipeline).
    * ``"seq"``: the sequential Riccati recursion, the trial kernel on a
      card, its plain version on the CPU.

    ``"fused"`` and ``"ddp"`` evaluate the whole trial in
    :func:`_trial_eval` and raise here: the retry loop re-solves with new
    regularization, which only the single-trial globalization avoids.
    """
    check_newton_impl(cfg)
    if cfg.newton_impl == "fused":
        raise ValueError(
            "newton_impl='fused' evaluates the whole trial in one fused "
            "kernel and requires globalization='single' (the single-trial "
            "staged or flat drivers); the retry loop re-solves with new "
            "regularization, which the fused evaluation covers via "
            "_trial_eval instead")
    if cfg.newton_impl == "ddp":
        raise ValueError(
            "newton_impl='ddp' evaluates the whole trial (derivatives + "
            "Vx-contracted backward pass + nonlinear re-rollout) per "
            "iteration and requires globalization='single'; use "
            "interior_point_ddp for the reference retry-loop structure")
    lin_reg = _regularized(lin, d, rp, cfg.scale_reg_by_grad,
                           cfg.reg_scale_floor)
    if cfg.terminal_hessian == "reference":
        XT = lin.Q[:, 0]  # reference quirk: the LQT terminal weight is Q[0]
    else:
        XT = final_hessian(ocp, x[:, -1])
    trial = (seq_newton_trial_batched if cfg.newton_impl == "seq"
             else fused_newton_step)
    du, dx, pred, feasible = trial(
        *(a.contiguous() for a in (lin_reg.r, lin_reg.Q, lin_reg.R,
                                   lin_reg.M, d.fx, d.fu, XT)))
    return dx, du, pred, feasible, lin.r


def _fused_trial_eval(ocp: OCP, x, u, bp, rp, cfg: SolverConfig):
    """The ``"fused"`` and ``"ddp"`` arms of :func:`_trial_eval`: the whole
    evaluation in the fused trial's kernels (Newton two launches, DDP the
    merged kernel's one), the Levenberg scale ``||cu||_F`` computed here on
    the lanes, as JAX computes it outside its kernel.  The lanes go to the
    kernels batch-last and come back batch-first."""
    ddp = cfg.newton_impl == "ddp"
    if not ddp and cfg.terminal_hessian != "exact":
        raise ValueError(
            "newton_impl='fused' computes the terminal Hessian in-kernel and "
            "requires terminal_hessian='exact'")
    B = u.shape[0]
    bp = torch.broadcast_to(bp, (B,)).contiguous()
    reg = rp
    # DDP scales the Levenberg parameter by ||cu|| unconditionally.
    if ddp or cfg.scale_reg_by_grad:
        cu_norm = stage_norm(stage_cu(ocp, x, u, bp))
        reg = rp * torch.clamp(cu_norm, min=cfg.reg_scale_floor)
    xs, xT = lanes_last(x)
    tu, tx, txT, cost, nc, mc, pred, piv, hu, _ = fused_newton_iter_packed(
        ocp, xs, xT, u.permute(1, 2, 0).contiguous(), bp, reg, ddp=ddp)
    ok = torch.isfinite(piv) & (piv > 0) & torch.isfinite(pred)
    new_cost = torch.where(mc <= 0.0, nc, torch.full_like(nc, float("inf")))
    return (cost, lanes_first(tx, txT), tu.permute(2, 0, 1), pred, ok, hu,
            new_cost)


def _trial_eval(ocp: OCP, x, u, bp, rp, cfg: SolverConfig):
    """One Newton trial evaluation per lane: ``(cost, temp_x, temp_u, pred,
    bwd_feasible, Hu_norm, new_cost)``; the unfused composition for
    ``"par"`` and ``"seq"``, the fused trial for ``"fused"`` and
    ``"ddp"``."""
    if cfg.newton_impl in ("fused", "ddp"):
        return _fused_trial_eval(ocp, x, u, bp, rp, cfg)
    cost = ocp.total_cost(x, u, bp)
    d = compute_first_order(ocp, x, u, bp)
    costates = _costates(ocp, x[:, -1], d, cfg)
    lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)
    dx, du, pred, bwd_feasible, Hu = par_newton_step(ocp, x, d, rp, lin, cfg)
    Hu_norm = Hu.abs().flatten(1).amax(1)
    temp_x = x + dx
    temp_u = u + du
    # An infeasible trial's barrier cost is NaN (log of a negative number);
    # it is replaced by +inf, so the trial is rejected.
    new_cost = torch.where(
        check_feasibility(ocp, temp_x, temp_u),
        ocp.total_cost(temp_x, temp_u, bp),
        torch.full_like(cost, float("inf")),
    )
    return cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost


class FlatLane(NamedTuple):
    """Per-scenario state of flat-mode IP solves, one row per lane."""

    x0: torch.Tensor        # (B, nx) scenario initial states
    x: torch.Tensor         # (B, T+1, nx) current trajectories
    u: torch.Tensor         # (B, T, nu) current controls
    u_prev: torch.Tensor    # (B, T, nu) previous stage's converged controls
    it: torch.Tensor        # (B,) int32 total Newton iterations per scenario
    stage_it: torch.Tensor  # (B,) int32 iterations in the current stage
    rp: torch.Tensor        # (B,) LM regularization
    r_inc: torch.Tensor     # (B,) LM growth factor
    bp: torch.Tensor        # (B,) barrier parameter
    bp0: torch.Tensor       # (B,) the lane's starting barrier parameter
    done: torch.Tensor      # (B,) bool: solve complete (u holds the solution)


def _fused_evaluator(cfg: SolverConfig) -> bool:
    check_newton_impl(cfg)
    return cfg.newton_impl in ("fused", "ddp")


def _lane_rollout(ocp: OCP, cfg: SolverConfig):
    """Open-loop rollout for the lane paths: ``u (B, T, nu)``, ``x0 (B,
    nx)`` -> ``(B, T+1, nx)``; the rollout kernel with the fused and DDP
    evaluators, plain with ``"par"`` and ``"seq"``."""
    if _fused_evaluator(cfg):
        return lambda u, x0: lanes_first(*rollout_packed(
            ocp, u.permute(1, 2, 0).contiguous(), x0.T.contiguous()))
    return lambda u, x0: rollout(ocp.dynamics, u, x0)


def _lane_transition(ocp: OCP, cfg: SolverConfig):
    """Two-candidate stage transition (plain warm start and central-path
    prediction): both rollouts and their barrier costs at the new bp; one
    launch of the transition kernel with the fused and DDP evaluators."""
    if _fused_evaluator(cfg):
        def fused(u, up, x0, bp):
            xa, xb, xaT, xbT, ca, cb, _, _ = transition_packed(
                ocp, u.permute(1, 2, 0).contiguous(),
                up.permute(1, 2, 0).contiguous(), x0.T.contiguous(),
                bp.contiguous())
            return lanes_first(xa, xaT), lanes_first(xb, xbT), ca, cb

        return fused

    def f(u, up, x0, bp):
        xa = rollout(ocp.dynamics, u, x0)
        xb = rollout(ocp.dynamics, up, x0)
        return xa, xb, ocp.total_cost(xa, u, bp), ocp.total_cost(xb, up, bp)

    return f


def flat_lane_init(ocp: OCP, controls, initial_state, cfg: SolverConfig,
                   bp0=None, rp0=None) -> FlatLane:
    """Open flat-mode solves for a batch of scenarios: rollout plus the
    non-finite warm-start guard (such a lane is ``done`` at once, it=0).

    ``bp0``/``rp0`` optionally override ``cfg.bp_init``/``cfg.reg_init`` per
    lane, as ``(B,)`` tensors.
    """
    B = controls.shape[0]
    kw = dict(dtype=controls.dtype, device=controls.device)
    if bp0 is None:
        bp0 = torch.full((B,), cfg.bp_init, **kw)
    if rp0 is None:
        rp0 = torch.full((B,), cfg.reg_init, **kw)
    x0_traj = _lane_rollout(ocp, cfg)(controls, initial_state)
    start_ok = torch.isfinite(ocp.total_cost(x0_traj, controls, bp0))
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=controls.device)
    return FlatLane(
        x0=initial_state,
        x=x0_traj,
        u=controls,
        u_prev=controls,
        it=zeros_i,
        stage_it=zeros_i,
        rp=rp0.to(**kw),
        r_inc=torch.full((B,), cfg.reg_inc_init, **kw),
        bp=bp0.to(**kw),
        bp0=bp0.to(**kw),
        done=~start_ok,
    )


def flat_lane_iter(ocp: OCP, lane: FlatLane, cfg: SolverConfig,
                   adv=None) -> FlatLane:
    """One Newton iteration (plus any stage transition) of every lane.

    Per lane this replays the staged single-trial solve: the same trial
    sequence, per-stage regularization resets, rollout at each stage start
    and stage tolerances.  ``adv`` is a (B,) bool mask: a lane with
    ``adv=False`` comes back exactly unchanged.  A lane whose cost or
    gradient goes non-finite is retired at once.

    The stage transition (two rollouts with the predictor) runs only on the
    lanes that roll over to a new stage, and not at all when none does: the
    host reads which lanes roll (one sync per iteration).  The other lanes
    would discard the transition's result, so per-lane results are those of
    evaluating it everywhere.
    """
    x, u, bp = lane.x, lane.u, lane.bp
    rp, r_inc = lane.rp, lane.r_inc
    if adv is None:
        adv = torch.ones_like(lane.done)
    cost, temp_x, temp_u, pred, bwd_feasible, Hu_norm, new_cost = (
        _trial_eval(ocp, x, u, bp, rp, cfg))
    rho = gain_ratio(new_cost, cost, pred)
    accept = (rho > 0.0) & bwd_feasible
    stalled = ~accept & (rp >= cfg.reg_max) & bool(cfg.stall_exit)
    rp_new, r_inc_new = lm_update(rp, r_inc, rho, accept, cfg)
    rp = torch.where(adv, rp_new, rp)
    r_inc = torch.where(adv, r_inc_new, r_inc)
    accept = accept & adv
    x = torch.where(_lane_view(accept, x), temp_x, x)
    u = torch.where(_lane_view(accept, u), temp_u, u)

    conv = Hu_norm < _stage_tol(cfg, bp)
    if cfg.pred_floor > 0.0:
        conv = conv | (bwd_feasible
                       & (pred.abs() < cfg.pred_floor * (1.0 + cost.abs())))
    bad = ~torch.isfinite(Hu_norm) | ~torch.isfinite(cost)
    bad = bad & adv
    # Stage ends on convergence, stall, or the per-stage iteration cap.
    advance = conv | stalled | (lane.stage_it + 1 > cfg.max_newton_iters)
    advance = advance & ~bad & adv
    bp_next = bp / cfg.bp_decay
    done_now = bad | (advance & (bp_next <= cfg.bp_min))
    # Stage transition: decay bp, reset the LM state, re-rollout the
    # nonlinear trajectory from the warm-started controls.
    roll = advance & ~done_now
    u_prev = torch.where(_lane_view(roll, u), u, lane.u_prev)
    idx = roll.nonzero().squeeze(1)
    if idx.numel():
        # x and u are fresh tensors from the accept select: updated in place.
        u_r, x0_r = u[idx], lane.x0[idx]
        if cfg.stage_predictor:
            # Continuation predictor: extrapolate the central path and keep
            # whichever candidate has the lower barrier cost at the new bp;
            # a NaN/inf predicted cost loses every comparison.  Only from
            # the second transition on (bp below the lane's starting bp).
            u_pred = u_r + (1.0 / cfg.bp_decay) * (u_r - lane.u_prev[idx])
            x_plain, x_pred, c_plain, c_pred = _lane_transition(ocp, cfg)(
                u_r, u_pred, x0_r, bp_next[idx])
            take = (bp[idx] < lane.bp0[idx]) & (c_pred < c_plain)
            x[idx] = torch.where(_lane_view(take, x_pred), x_pred, x_plain)
            u[idx] = torch.where(_lane_view(take, u_pred), u_pred, u_r)
        else:
            x[idx] = _lane_rollout(ocp, cfg)(u_r, x0_r)
    bp = torch.where(advance, bp_next, bp)
    stage_reg = (cfg.reg_init if cfg.reg_stage_init is None
                 else cfg.reg_stage_init)
    rp = torch.where(advance, torch.full_like(rp, stage_reg), rp)
    r_inc = torch.where(advance, torch.full_like(r_inc, cfg.reg_inc_init),
                        r_inc)
    tick = adv.to(torch.int32)
    stage_it = torch.where(advance, torch.zeros_like(lane.stage_it),
                           lane.stage_it + tick)
    return FlatLane(
        x0=lane.x0, x=x, u=u, u_prev=u_prev, it=lane.it + tick,
        stage_it=stage_it, rp=rp, r_inc=r_inc, bp=bp, bp0=lane.bp0,
        done=lane.done | done_now,
    )


def flat_total_cap(cfg: SolverConfig) -> int:
    """Upper bound on flat-mode iterations (every stage may run to its
    cap)."""
    return n_barrier_stages(cfg) * (cfg.max_newton_iters + 1)


# ---------------------------------------------------------------------------
# Staged solves: one barrier stage per call, lanes in lockstep
# ---------------------------------------------------------------------------


def _where(mask, new, old):
    """Per-lane select of ``(B, ...)`` tensors by a ``(B,)`` mask."""
    return torch.where(_lane_view(mask, new), new, old)


def _stage_start(ocp: OCP, controls, initial_state, bp):
    """A stage's opening rollout and gradient-norm carry: NaN for a lane
    whose warm start has a non-finite barrier cost (infeasible), which then
    takes no iteration and returns its input."""
    states = rollout(ocp.dynamics, controls, initial_state)
    start_ok = torch.isfinite(ocp.total_cost(states, controls, bp))
    init_norm = torch.where(start_ok, torch.ones_like(start_ok, dtype=bp.dtype),
                            torch.full_like(start_ok, float("nan"),
                                            dtype=bp.dtype))
    return states, init_norm


def _lane_scalars(controls, cfg: SolverConfig):
    """Per-lane ``(it, rp, r_inc)`` at a stage's start."""
    B = controls.shape[0]
    kw = dict(dtype=controls.dtype, device=controls.device)
    return (torch.zeros((B,), dtype=torch.int32, device=controls.device),
            torch.full((B,), cfg.reg_init, **kw),
            torch.full((B,), cfg.reg_inc_init, **kw))


def _stage_tol(cfg: SolverConfig, bp):
    """``max(tol, stage_tol_scale * bp)`` in bp's dtype."""
    return torch.clamp(cfg.stage_tol_scale * bp, min=cfg.tol)


def _newton_stage_par(ocp: OCP, controls, initial_state, bp,
                      cfg: SolverConfig):
    """One barrier stage of the parallel Newton method with the retry
    globalization: per Newton iteration the cost, derivatives, costates and
    Newton stage data once, then trials with growing regularization until
    one is accepted.  The trial is adopted on the retry loop's exit (as in
    the reference), except after a stall or with non-finite values; a stall
    ends the stage through a NaN gradient norm."""
    x, Hu_norm = _stage_start(ocp, controls, initial_state, bp)
    u = controls
    it, rp, r_inc = _lane_scalars(controls, cfg)
    tol = _stage_tol(cfg, bp)
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    while True:
        run = ~((Hu_norm < tol) | (it > cfg.max_newton_iters)
                | ~torch.isfinite(Hu_norm))
        if not bool(run.any()):
            break
        cost = ocp.total_cost(x, u, bp)
        d = compute_first_order(ocp, x, u, bp)
        costates = _costates(ocp, x[:, -1], d, cfg)
        lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)
        Hu_abs = lin.r.abs().flatten(1).amax(1)

        tx, tu, hn = x, u, torch.zeros_like(Hu_norm)
        success = torch.zeros_like(run)
        stalled = torch.zeros_like(run)
        rp_i, ri = rp, r_inc
        k = torch.zeros_like(it)
        while True:
            stop = (success | (k > cfg.max_inner_iters) | stalled
                    | ((k > 0) & ~torch.isfinite(hn)))
            act = run & ~stop
            if not bool(act.any()):
                break
            dx, du, pred, feasible, _ = par_newton_step(ocp, x, d, rp_i, lin,
                                                        cfg)
            ntx, ntu = x + dx, u + du
            new_cost = torch.where(check_feasibility(ocp, ntx, ntu),
                                   ocp.total_cost(ntx, ntu, bp), inf)
            rho = gain_ratio(new_cost, cost, pred)
            ok = (rho > 0.0) & feasible
            # Stall: a rejected trial at maximum regularization.
            stall = ~ok & (rp_i >= cfg.reg_max) & bool(cfg.stall_exit)
            nrp, nri = lm_update(rp_i, ri, rho, ok, cfg)
            tx, tu = _where(act, ntx, tx), _where(act, ntu, tu)
            hn = torch.where(act, Hu_abs, hn)
            success = torch.where(act, ok, success)
            stalled = torch.where(act, stall, stalled)
            rp_i, ri = torch.where(act, nrp, rp_i), torch.where(act, nri, ri)
            k = k + act.to(k.dtype)

        trial_ok = (torch.isfinite(tu.sum((1, 2)))
                    & torch.isfinite(tx.sum((1, 2))) & ~stalled)
        keep = run & trial_ok
        x, u = _where(keep, tx, x), _where(keep, tu, u)
        hn = torch.where(stalled, torch.full_like(hn, float("nan")), hn)
        Hu_norm = torch.where(run, hn, Hu_norm)
        rp, r_inc = torch.where(run, rp_i, rp), torch.where(run, ri, r_inc)
        it = it + run.to(it.dtype)
    return x, u, it


def _newton_stage_par_single(ocp: OCP, controls, initial_state, bp,
                             cfg: SolverConfig):
    """One barrier stage with the single-trial globalization: one trial per
    Newton iteration with explicit accept/reject, no retry loop."""
    x, Hu_norm = _stage_start(ocp, controls, initial_state, bp)
    u = controls
    t, rp, r_inc = _lane_scalars(controls, cfg)
    tol = _stage_tol(cfg, bp)
    while True:
        run = ~((Hu_norm < tol) | (t > cfg.max_newton_iters)
                | ~torch.isfinite(Hu_norm))
        if not bool(run.any()):
            break
        cost, temp_x, temp_u, pred, feasible, hn, new_cost = _trial_eval(
            ocp, x, u, bp, rp, cfg)
        rho = gain_ratio(new_cost, cost, pred)
        accept = (rho > 0.0) & feasible
        stalled = ~accept & (rp >= cfg.reg_max) & bool(cfg.stall_exit)
        nrp, nri = lm_update(rp, r_inc, rho, accept, cfg)
        keep = run & accept
        x, u = _where(keep, temp_x, x), _where(keep, temp_u, u)
        hn = torch.where(stalled, torch.full_like(hn, float("nan")), hn)
        if cfg.pred_floor > 0.0:
            # Negligible predicted reduction at a convex step: numerically
            # stationary for this precision.
            tiny = feasible & (pred.abs()
                               < cfg.pred_floor * (1.0 + cost.abs()))
            hn = torch.where(tiny, torch.zeros_like(hn), hn)
        Hu_norm = torch.where(run, hn, Hu_norm)
        rp, r_inc = torch.where(run, nrp, rp), torch.where(run, nri, r_inc)
        t = t + run.to(t.dtype)
    return x, u, t


def _newton_flat_single(ocp: OCP, controls, initial_state, cfg: SolverConfig):
    """The whole solve as one loop with a per-lane barrier parameter
    (``barrier_mode="flat"``): :func:`flat_lane_iter` on the lanes that are
    not done and under the total iteration cap."""
    total_cap = flat_total_cap(cfg)
    lane = flat_lane_init(ocp, controls, initial_state, cfg)
    while True:
        adv = ~lane.done & (lane.it < total_cap)
        if not bool(adv.any()):
            break
        lane = flat_lane_iter(ocp, lane, cfg, adv)
    return lane.u, lane.it


def par_solve_batched(ocp: OCP, controls, initial_states,
                      cfg: SolverConfig = DEFAULT_CONFIG):
    """The parallel-in-time solve of every lane of ``controls (B, T, nu)``
    from ``initial_states (B, nx)``: ``(controls (B, T, nu), iterations
    (B,) int32)``, each lane equal to its single solve."""
    if controls.device.type == "cuda":
        cuda.disable_tf32()
    if cfg.barrier_mode == "flat":
        if cfg.globalization != "single":
            raise ValueError(
                "barrier_mode='flat' requires globalization='single' "
                "(the retry loop is itself a lockstep barrier across lanes)")
        return _newton_flat_single(ocp, controls, initial_states, cfg)
    stage_fn = (_newton_stage_par_single if cfg.globalization == "single"
                else _newton_stage_par)

    def stage(u, bp):
        _, u, iters = stage_fn(ocp, u, initial_states, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)


def par_interior_point_optimal_control(ocp: OCP, controls, initial_state,
                                       cfg: SolverConfig = DEFAULT_CONFIG):
    """Parallel-in-time interior-point Newton solve of one scenario, the
    flagship entry point: ``controls (T, nu)``, ``initial_state (nx,)`` ->
    ``(optimal controls (T, nu), total Newton iterations)`` (a 0-dim int32
    tensor).  Runs on the device of ``controls``."""
    u, it = par_solve_batched(ocp, controls[None], initial_state[None], cfg)
    return u[0], it[0]


# ---------------------------------------------------------------------------
# Sequential Newton solver (validation spine)
# ---------------------------------------------------------------------------


def seq_bwd_newton(final_cost, xN, lin: LinearizedOCP, d: Derivatives, rp):
    """Sequential Riccati backward pass on Newton stage data, per lane.

    ``rp (B,)`` is added to Quu unscaled.  Cholesky solves, a Cholesky-
    success convexity flag, and the terminal condition ``Vxx =
    hessian(final_cost)(xN)``, ``Vx = 0`` (the costates carry the gradient
    part).  Returns ``K (B,T,nu,nx)``, ``k (B,T,nu)``, the predicted
    reduction ``(B,)`` and the convexity flag ``(B,)``.
    """
    Vxx = over_leading(jacrev(grad(final_cost)), xN.shape[:-1], xN)
    Vx = torch.zeros_like(xN)
    T, nu = lin.R.shape[1], lin.R.shape[-1]
    eye = torch.eye(nu, dtype=lin.R.dtype, device=lin.R.device)
    reg = rp[:, None, None] * eye
    Ks, ks, dvs = [None] * T, [None] * T, [None] * T
    convex = torch.ones_like(rp, dtype=torch.bool)
    for t in range(T - 1, -1, -1):
        r, Q, R, M = lin.r[:, t], lin.Q[:, t], lin.R[:, t], lin.M[:, t]
        fx, fu = d.fx[:, t], d.fu[:, t]
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        Qxx = Q + fxT @ Vxx @ fx
        Quu = R + fuT @ Vxx @ fu + reg
        Qxu = M + fxT @ Vxx @ fu
        Qu = r + (fuT @ Vx[..., None])[..., 0]
        Qx = (fxT @ Vx[..., None])[..., 0]
        convex = convex & linalg.is_posdef(Quu, batch_dims=1)
        # One factorization for both gains: Quu [k | K] = -[Qu | Qxu^T].
        sol = linalg.cholesky_solve(
            Quu, torch.cat([Qu[..., None], Qxu.transpose(-1, -2)], dim=-1))
        k, K = -sol[..., 0], -sol[..., 1:]
        Vx = Qx + (Qxu @ k[..., None])[..., 0]
        Vxx = linalg.sym(Qxx + Qxu @ K)
        dvs[t] = ((k * Qu).sum(-1)
                  + 0.5 * (k * (Quu @ k[..., None])[..., 0]).sum(-1))
        Ks[t], ks[t] = K, k
    return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1),
            stage_sum(torch.stack(dvs, dim=1)), convex)


def seq_fwd_newton(K, k, d: Derivatives):
    """Linear deviation rollout: ``dx0 = 0``, ``dx+ = (fx + fu K) dx +
    fu k``, ``du = K dx + k``, per lane."""
    dx = [torch.zeros(K.shape[:1] + K.shape[-1:], dtype=K.dtype,
                      device=K.device)]
    for t in range(K.shape[1]):
        fx, fu = d.fx[:, t], d.fu[:, t]
        nxt = ((fx + fu @ K[:, t]) @ dx[-1][..., None])[..., 0] \
            + (fu @ k[:, t, :, None])[..., 0]
        dx.append(nxt)
    dx = torch.stack(dx, dim=1)
    du = (K @ dx[:, :-1, :, None])[..., 0] + k
    return du, dx


def _newton_stage_seq(ocp: OCP, controls, initial_state, bp,
                      cfg: SolverConfig):
    """One barrier stage of the sequential Newton method: one trial per
    iteration with explicit accept/reject; it stops on convergence with a
    convex backward pass, at ``max_newton_iters``, or on a non-finite
    gradient norm (a stall sets it NaN)."""
    x, Hu_norm = _stage_start(ocp, controls, initial_state, bp)
    u = controls
    t, mu, nu_ = _lane_scalars(controls, cfg)
    bp_feasible = torch.ones_like(Hu_norm, dtype=torch.bool)
    tol = _stage_tol(cfg, bp)
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    while True:
        converged = (Hu_norm < tol) & bp_feasible
        run = ~(converged | (t >= cfg.max_newton_iters)
                | ~torch.isfinite(Hu_norm))
        if not bool(run.any()):
            break
        cost = ocp.total_cost(x, u, bp)
        d = compute_first_order(ocp, x, u, bp)
        costates = seq_costates(ocp, x[:, -1], d)
        lin = compute_hamiltonian_lqr(ocp, x, u, costates, bp)
        K, k, pred, feasible = seq_bwd_newton(ocp.final_cost, x[:, -1], lin,
                                              d, mu)
        du, dx = seq_fwd_newton(K, k, d)
        hn = lin.r.abs().flatten(1).amax(1)
        temp_x, temp_u = x + dx, u + du
        new_cost = torch.where(check_feasibility(ocp, temp_x, temp_u),
                               ocp.total_cost(temp_x, temp_u, bp), inf)
        rho = gain_ratio(new_cost, cost, pred)
        accept = (rho > 0) & feasible
        stalled = ~accept & (mu >= cfg.reg_max) & bool(cfg.stall_exit)
        nmu, nnu = lm_update(mu, nu_, rho, accept, cfg)
        keep = run & accept
        x, u = _where(keep, temp_x, x), _where(keep, temp_u, u)
        hn = torch.where(stalled, torch.full_like(hn, float("nan")), hn)
        Hu_norm = torch.where(run, hn, Hu_norm)
        bp_feasible = torch.where(run, feasible, bp_feasible)
        mu, nu_ = torch.where(run, nmu, mu), torch.where(run, nnu, nu_)
        t = t + run.to(t.dtype)
    return x, u, t


def seq_solve_batched(ocp: OCP, controls, initial_states,
                      cfg: SolverConfig = DEFAULT_CONFIG):
    """The sequential solve of every lane: ``(controls (B, T, nu),
    iterations (B,) int32)``."""
    if controls.device.type == "cuda":
        cuda.disable_tf32()

    def stage(u, bp):
        _, u, iters = _newton_stage_seq(ocp, u, initial_states, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)


def seq_interior_point_optimal_control(ocp: OCP, controls, initial_state,
                                       cfg: SolverConfig = DEFAULT_CONFIG):
    """Sequential interior-point Newton solve of one scenario (the
    validation path): ``(controls (T, nu), iterations)``."""
    u, it = seq_solve_batched(ocp, controls[None], initial_state[None], cfg)
    return u[0], it[0]
