"""Interior-point differential dynamic programming (counterpart of
``ipoc_tpu/solvers/ip_ddp.py``): the backward pass ``ddp_bwd_pass``/
``ddp_bwd_core`` and the single-solve baseline ``interior_point_ddp``.

DDP differs from the Newton trial in two ways: the second-order dynamics
terms are contracted with the value gradient ``Vx`` (not the costates), and
the trial trajectory is a nonlinear closed-loop re-rollout through the true
dynamics (``utils/integrators.py`` ``closed_loop_rollout``).  Batched over a
leading lane axis, a Python loop over the horizon.  In the fused paths the
whole DDP trial is one kernel launch on a card (``ops/fused_iter.py``, the
merged trial), and this pass is its plain version's backward half.

:func:`interior_point_ddp` keeps the reference's structure: per barrier
stage an outer loop that computes the derivatives once per iteration and
an inner loop that retries the backward pass and the rollout with growing
regularization.  No kernel is on this path, as no Pallas kernel is on
JAX's: it is plain tensor code on whatever device it is given (the
reference ran it in float64 on CUDA).  :func:`ddp_solve_batched` runs it
on a leading lane axis in lockstep, each lane's updates masked, so each
lane equals its own single solve.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacrev

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.ops.cuda.seq_newton import _pivots_only
from ipoc_tpu_torch.ops.derivatives import (
    check_feasibility,
    compute_derivatives,
    over_leading,
)
from ipoc_tpu_torch.ops.linalg import (
    _cholesky_small,
    cholesky_solve_factored,
    sym,
)
from ipoc_tpu_torch.problem import OCP, Derivatives, stage_norm
from ipoc_tpu_torch.solvers.barrier import barrier_loop
from ipoc_tpu_torch.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu_torch.utils.integrators import closed_loop_rollout


def ddp_bwd_pass(final_cost, final_state, d: Derivatives, reg_param,
                 scale_floor: float = 1e-6):
    """DDP backward pass with the Levenberg parameter scaled per lane by
    ``max(||cu||_F, scale_floor)``: ``reg_param (B,)``, ``final_state
    (B, nx)``, ``d`` fields ``(B, T, ...)``.  Returns ``(ffgain (B, T, nu),
    gain (B, T, nu, nx), pred (B,), feasible (B,), Qu (B, T, nu))``."""
    rp = reg_param * torch.clamp(stage_norm(d.cu), min=scale_floor)
    return ddp_bwd_core(final_cost, final_state, d, rp)


def ddp_bwd_core(final_cost, final_state, d: Derivatives, rp):
    """:func:`ddp_bwd_pass` with ``rp (B,)`` already scaled."""
    return _ddp_bwd(final_cost, final_state, d, rp)[:5]


def _ddp_bwd(final_cost, final_state, d: Derivatives, rp):
    """The backward recursion; returns :func:`ddp_bwd_core`'s outputs and
    the minimum pivot of an unpivoted elimination of every stage's
    regularized ``Quu`` (what the merged kernel reports)."""
    lead = final_state.shape[:-1]
    Vx = over_leading(grad(final_cost), lead, final_state)
    Vxx = over_leading(jacrev(grad(final_cost)), lead, final_state)
    T = d.cu.shape[-2]
    nu = d.cu.shape[-1]
    eye = torch.eye(nu, dtype=d.cu.dtype, device=d.cu.device)
    reg = rp[..., None, None] * eye
    dv = torch.zeros_like(Vx[..., 0])
    feasible = torch.ones_like(dv, dtype=torch.bool)
    piv = torch.full_like(dv, float("inf"))
    k_all, K_all, Qu_all = [None] * T, [None] * T, [None] * T

    def at(a, t):
        return a.select(len(lead), t)  # stage t of a (*lead, T, ...) field

    for t in range(T - 1, -1, -1):
        fx, fu = at(d.fx, t), at(d.fu, t)
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        Qx = at(d.cx, t) + (fxT @ Vx.unsqueeze(-1)).squeeze(-1)
        Qu = at(d.cu, t) + (fuT @ Vx.unsqueeze(-1)).squeeze(-1)
        # tensordot(Vx, f.., axes=1): the curvature contracted with Vx.
        Qxx = (at(d.cxx, t) + fxT @ Vxx @ fx
               + torch.einsum("...i,...ijk->...jk", Vx, at(d.fxx, t)))
        Qxu = (at(d.cxu, t) + fxT @ Vxx @ fu
               + torch.einsum("...i,...ijk->...jk", Vx, at(d.fxu, t)))
        Quu = (at(d.cuu, t) + fuT @ Vxx @ fu
               + torch.einsum("...i,...ijk->...jk", Vx, at(d.fuu, t))) + reg
        # One factor for the PD test and the solve (cholesky_solve's).
        L = _cholesky_small(sym(Quu))
        feasible = feasible & torch.isfinite(L).flatten(-2).all(-1)
        piv = torch.minimum(piv, _pivots_only(Quu))
        sol = cholesky_solve_factored(
            L, torch.cat([Qu.unsqueeze(-1), Qxu.transpose(-1, -2)], -1))
        k, K = -sol[..., 0], -sol[..., 1:]
        dv = dv + 0.5 * (Qu * k).sum(-1)
        Vx = Qx + (Qxu @ k.unsqueeze(-1)).squeeze(-1)
        Vxx = sym(Qxx + Qxu @ K)
        k_all[t], K_all[t], Qu_all[t] = k, K, Qu
    return (torch.stack(k_all, -2), torch.stack(K_all, -3), dv, feasible,
            torch.stack(Qu_all, -2), piv)


def _ddp_stage(ocp: OCP, controls, initial_state, bp, cfg: SolverConfig):
    """One barrier stage of IP-DDP on every lane: ``controls (B, T, nu)``,
    ``initial_state (B, nx)``, ``bp`` a 0-dim tensor; returns ``(x, u,
    iterations (B,) int32)``.

    The outer loop stops on ``Hu_norm < cfg.tol``, past
    ``cfg.max_ddp_iters`` or on a non-finite ``Hu_norm`` (``max |Qu|`` over
    the trajectory); a lane whose warm start has a non-finite barrier cost
    starts at NaN and runs no iteration.  The inner loop retries until a
    trial is accepted, past ``max_inner_iters``, on a stall, or on a
    non-finite ``Hu_norm`` after its first trial.  Its last trial is adopted
    if finite and not stalled, accepted or not; a stall sets ``Hu_norm`` to
    NaN, which ends the stage.
    """
    # ip_newton imports ops/fused_iter.py, which imports this module.
    from ipoc_tpu_torch.solvers.ip_newton import (
        _lane_scalars,
        _stage_start,
        _where,
    )

    x, Hu_norm = _stage_start(ocp, controls, initial_state, bp)
    u = controls
    it, rp, r_inc = _lane_scalars(controls, cfg)
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    while True:
        run = ~((Hu_norm < cfg.tol) | (it > cfg.max_ddp_iters)
                | ~torch.isfinite(Hu_norm))
        if not bool(run.any()):
            break
        cost = ocp.total_cost(x, u, bp)
        d = compute_derivatives(ocp, x, u, bp)

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
            ffgain, gain, pred, feasible, Qu = ddp_bwd_pass(
                ocp.final_cost, x[:, -1], d, rp_i, cfg.reg_scale_floor)
            ntx, ntu = closed_loop_rollout(ocp.dynamics, gain, ffgain, x, u)
            new_cost = torch.where(check_feasibility(ocp, ntx, ntu),
                                   ocp.total_cost(ntx, ntu, bp), inf)
            rho = gain_ratio(new_cost, cost, pred)
            ok = (rho > 0.0) & feasible
            stall = ~ok & (rp_i >= cfg.reg_max) & bool(cfg.stall_exit)
            nrp, nri = lm_update(rp_i, ri, rho, ok, cfg)
            tx, tu = _where(act, ntx, tx), _where(act, ntu, tu)
            hn = torch.where(act, Qu.abs().flatten(1).amax(1), hn)
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


def ddp_solve_batched(ocp: OCP, controls, initial_states,
                      cfg: SolverConfig = DEFAULT_CONFIG):
    """IP-DDP on every lane of ``controls (B, T, nu)`` from
    ``initial_states (B, nx)``: ``(controls (B, T, nu), iterations (B,)
    int32)``, each lane equal to its :func:`interior_point_ddp`.  Loop
    predicates are host reads; everything else stays on the device of
    ``controls``."""

    def stage(u, bp):
        _, u, iters = _ddp_stage(ocp, u, initial_states, bp, cfg)
        return u, iters

    return barrier_loop(stage, controls, cfg)


def interior_point_ddp(ocp: OCP, controls, initial_state,
                       cfg: SolverConfig = DEFAULT_CONFIG):
    """IP-DDP entry point (JAX ``interior_point_ddp``): ``controls (T,
    nu)``, ``initial_state (nx,)`` -> ``(optimal controls (T, nu), total
    DDP iterations)`` (a 0-dim int32 tensor), on the device of
    ``controls``.  No kernel: plain tensor code, as in JAX."""
    u, it = ddp_solve_batched(ocp, controls[None], initial_state[None], cfg)
    return u[0], it[0]
