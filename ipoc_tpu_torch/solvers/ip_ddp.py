"""The interior-point DDP backward pass (counterpart of
``ipoc_tpu/solvers/ip_ddp.py``, its ``ddp_bwd_pass``/``ddp_bwd_core``).

DDP differs from the Newton trial in two ways: the second-order dynamics
terms are contracted with the value gradient ``Vx`` (not the costates), and
the trial trajectory is a nonlinear closed-loop re-rollout through the true
dynamics (``utils/integrators.py`` ``closed_loop_rollout``).  Batched over a
leading lane axis, a Python loop over the horizon; on a card the whole DDP
trial is one kernel launch (``ops/fused_iter.py``, the merged trial), and
this pass is its plain version's backward half.

Not ported yet: ``_ddp_stage`` and ``interior_point_ddp``, the single-solve
entry with the retry globalization (ROADMAP.md, modules item 6).
"""

from __future__ import annotations

import torch
from torch.func import grad, jacrev

from ipoc_tpu_torch.ops.cuda.seq_newton import _pivots_only
from ipoc_tpu_torch.ops.derivatives import over_leading
from ipoc_tpu_torch.ops.linalg import _cholesky_small, cholesky_solve, sym
from ipoc_tpu_torch.problem import Derivatives


def ddp_bwd_pass(final_cost, final_state, d: Derivatives, reg_param,
                 scale_floor: float = 1e-6):
    """DDP backward pass with the Levenberg parameter scaled per lane by
    ``max(||cu||_F, scale_floor)``: ``reg_param (B,)``, ``final_state
    (B, nx)``, ``d`` fields ``(B, T, ...)``.  Returns ``(ffgain (B, T, nu),
    gain (B, T, nu, nx), pred (B,), feasible (B,), Qu (B, T, nu))``."""
    rp = reg_param * torch.clamp(
        torch.linalg.vector_norm(d.cu, dim=(-2, -1)), min=scale_floor)
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
        feasible = feasible & torch.isfinite(
            _cholesky_small(sym(Quu))).flatten(-2).all(-1)
        piv = torch.minimum(piv, _pivots_only(Quu))
        sol = cholesky_solve(Quu, torch.cat([Qu.unsqueeze(-1),
                                             Qxu.transpose(-1, -2)], -1))
        k, K = -sol[..., 0], -sol[..., 1:]
        dv = dv + 0.5 * (Qu * k).sum(-1)
        Vx = Qx + (Qxu @ k.unsqueeze(-1)).squeeze(-1)
        Vxx = sym(Qxx + Qxu @ K)
        k_all[t], K_all[t], Qu_all[t] = k, K, Qu
    return (torch.stack(k_all, -2), torch.stack(K_all, -3), dv, feasible,
            torch.stack(Qu_all, -2), piv)
