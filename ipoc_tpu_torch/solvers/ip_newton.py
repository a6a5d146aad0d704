"""Interior-point Newton lanes (counterpart of
``ipoc_tpu/solvers/ip_newton.py``): the subset the single-grid stream runs
with ``newton_impl="seq"``.

Everything is batched by hand over a leading lane axis B: a lane is one
scenario's flat-mode solve, and what JAX wrote per lane under ``vmap`` is
written here on ``(B, ...)`` tensors.  Per-lane values (barrier parameter,
regularization, iteration counts) are ``(B,)`` tensors.

On a card the two Pallas kernels of this path run as the hand-written CUDA
kernels (``ops/cuda/seq_newton.py``): the costate recursion and the
sequential Newton trial.  Derivatives, rollouts and the stage predictor's
transition are plain tensor code, as they were plain XLA in the JAX arm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import SolverConfig
from ipoc_tpu_torch.ops.cuda.seq_newton import seq_newton_trial_batched
from ipoc_tpu_torch.ops.derivatives import (
    check_feasibility,
    compute_first_order,
    compute_hamiltonian_lqr,
    final_hessian,
)
from ipoc_tpu_torch.parallel.costates import seq_costates
from ipoc_tpu_torch.problem import OCP, Derivatives, LinearizedOCP
from ipoc_tpu_torch.solvers.barrier import n_barrier_stages
from ipoc_tpu_torch.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu_torch.utils.integrators import rollout

# Step evaluators of the JAX package that the port does not run yet, and
# the ROADMAP.md item ("Modules to port") that will port each.
_NOT_PORTED = {
    "par": "The parallel-in-time single-solve path",
    "fused": "The packed stream on Hopper kernels",
    "ddp": "DDP and multigrid",
}


def check_newton_impl(cfg: SolverConfig) -> None:
    """Only ``newton_impl="seq"`` is ported; nothing else is substituted."""
    if cfg.newton_impl == "seq":
        return
    if cfg.newton_impl in _NOT_PORTED:
        raise ValueError(
            f"newton_impl={cfg.newton_impl!r} is not ported yet (ROADMAP.md, "
            f"modules to port: {_NOT_PORTED[cfg.newton_impl]!r}); use "
            "newton_impl='seq'")
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
        rp = rp * torch.clamp(torch.linalg.vector_norm(d.cu, dim=(-2, -1)),
                              min=scale_floor)
    nu = lin.R.shape[-1]
    eye = torch.eye(nu, dtype=lin.R.dtype, device=lin.R.device)
    R = lin.R + rp[:, None, None, None] * eye
    return LinearizedOCP(lin.r, lin.Q, R, lin.M)


def _costates(ocp: OCP, x_last, d: Derivatives, cfg: SolverConfig):
    """Costates matched to the step evaluator: the sequential recursion
    (costate kernel on a card) for ``newton_impl="seq"``."""
    check_newton_impl(cfg)
    return seq_costates(ocp, x_last, d)


def par_newton_step(ocp: OCP, x, d: Derivatives, rp, lin: LinearizedOCP,
                    cfg: SolverConfig):
    """One regularized Newton trial step per lane.

    Returns ``(dx, du, pred_reduction, feasible, Hu)``; the forward pass
    starts from zero deviation, so (dx, du) are additive updates.  With
    ``newton_impl="seq"`` the trial is the sequential Riccati recursion:
    the trial kernel on a card, its plain version on the CPU.
    """
    check_newton_impl(cfg)
    lin_reg = _regularized(lin, d, rp, cfg.scale_reg_by_grad,
                           cfg.reg_scale_floor)
    if cfg.terminal_hessian == "reference":
        XT = lin.Q[:, 0]  # reference quirk: the LQT terminal weight is Q[0]
    else:
        XT = final_hessian(ocp, x[:, -1])
    du, dx, pred, feasible = seq_newton_trial_batched(
        *(a.contiguous() for a in (lin_reg.r, lin_reg.Q, lin_reg.R,
                                   lin_reg.M, d.fx, d.fu, XT)))
    return dx, du, pred, feasible, lin.r


def _trial_eval(ocp: OCP, x, u, bp, rp, cfg: SolverConfig):
    """One Newton trial evaluation per lane: ``(cost, temp_x, temp_u, pred,
    bwd_feasible, Hu_norm, new_cost)``, the unfused composition."""
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


def _lane_rollout(ocp: OCP, cfg: SolverConfig):
    """Open-loop rollout for the lane paths (plain with ``"seq"``)."""
    check_newton_impl(cfg)
    return lambda u, x0: rollout(ocp.dynamics, u, x0)


def _lane_transition(ocp: OCP, cfg: SolverConfig):
    """Two-candidate stage transition (plain warm start and central-path
    prediction): both rollouts and their barrier costs at the new bp."""
    check_newton_impl(cfg)

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

    tol_s = torch.clamp(cfg.stage_tol_scale * bp, min=cfg.tol)
    conv = Hu_norm < tol_s
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
