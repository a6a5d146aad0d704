"""Linear-quadratic tracking (LQT) subproblem: sequential and parallel
passes (counterpart of ``ipoc_tpu/parallel/lqt.py``).

The parallel backward pass is a suffix associative scan of conditional
value-function elements (five-tuples ``(A, b, C, eta, J)``); the parallel
forward pass is a prefix scan of closed-loop affine maps, sharing its
element algebra with the costate scan (``parallel/costates.py``).  Both
scans run through ``ops/scan_kernels.py``: the CUDA kernels on a card,
their plain versions on the CPU.  The sequential and the parallel backward
passes derive their gains from one shared function, :func:`stage_gains`.

Everything is batched over a leading lane axis B: every field of
:class:`LQT` carries it, the terminal fields ``XT``, ``HT`` and ``rT``
included, and ``pred_reduction`` and ``feasible`` come back as ``(B,)``.
What JAX reduces per lane under ``vmap`` (the feasibility flag) is reduced
per lane here.

Problem form (general LQT with cross terms):

* dynamics       ``x_{k+1} = A_k x_k + B_k u_k + c_k``
* stage cost     ``1/2 (H x - r)^T X (H x - r) + 1/2 (Z u - s)^T U (Z u - s)
  + (H x - r)^T M (Z u - s)``
* terminal cost  ``1/2 (H_T x_T - r_T)^T X_T (H_T x_T - r_T)``
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.ops import linalg
from ipoc_tpu_torch.ops.scan_kernels import (
    affine_scan,
    affine_scan_plain,
    value_scan,
    value_scan_plain,
)
from ipoc_tpu_torch.problem import Derivatives, LinearizedOCP, stage_sum


class LQT(NamedTuple):
    """LQT problem, field order ``A, B, c, XT, HT, rT, X, H, r, U, Z, s, M``.

    Shapes: A (B,T,nx,nx), B (B,T,nx,nu), c (B,T,nx); XT (B,nx,nx),
    HT (B,nm,nx), rT (B,nm); X (B,T,nm,nm), H (B,T,nm,nx), r (B,T,nm);
    U (B,T,ns,ns), Z (B,T,ns,nu), s (B,T,ns); M (B,T,nm,ns).
    """

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    XT: torch.Tensor
    HT: torch.Tensor
    rT: torch.Tensor
    X: torch.Tensor
    H: torch.Tensor
    r: torch.Tensor
    U: torch.Tensor
    Z: torch.Tensor
    s: torch.Tensor
    M: torch.Tensor


class LQTStage(NamedTuple):
    """Per-stage fields of an LQT (no terminal fields)."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    X: torch.Tensor
    H: torch.Tensor
    r: torch.Tensor
    U: torch.Tensor
    Z: torch.Tensor
    s: torch.Tensor
    M: torch.Tensor


def lqt_stages(lqt: LQT) -> LQTStage:
    return LQTStage(lqt.A, lqt.B, lqt.c, lqt.X, lqt.H, lqt.r, lqt.U, lqt.Z,
                    lqt.s, lqt.M)


class ValueElement(NamedTuple):
    """Associative-scan element of the conditional value function
    ``V(x, z) = 1/2 x^T J x - x^T eta + max_l [l^T (z - A x - b)
    - 1/2 l^T C l]`` (the dual form, finite when C is singular)."""

    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def value_combine(earlier: ValueElement, later: ValueElement) -> ValueElement:
    """Associative combination of conditional-value elements: ``earlier``
    spans [i, j), ``later`` [j, k), the result [i, k).  Batched over leading
    axes; the inner solves on ``I + C_i J_j`` and ``I + J_j C_i`` are
    unpivoted eliminations."""
    Ai, bi, Ci, etai, Ji = earlier
    Aj, bj, Cj, etaj, Jj = later
    n = Ai.shape[-1]
    eye = torch.eye(n, dtype=Ai.dtype, device=Ai.device)

    LHS = eye + Ci @ Jj
    Dt_A = linalg.solve(LHS, Ai, pivot=False)
    Dt_bCeta = linalg.solve(LHS, (bi + _mv(Ci, etaj))[..., None],
                            pivot=False)[..., 0]
    Dt_C = linalg.solve(LHS, Ci, pivot=False)

    LHS_T = eye + Jj @ Ci
    E_eta = linalg.solve(LHS_T, (etaj - _mv(Jj, bi))[..., None],
                         pivot=False)[..., 0]
    E_J = linalg.solve(LHS_T, Jj, pivot=False)

    AiT = Ai.transpose(-1, -2)
    return ValueElement(
        A=Aj @ Dt_A,
        b=_mv(Aj, Dt_bCeta) + bj,
        C=linalg.sym(Aj @ Dt_C @ Aj.transpose(-1, -2) + Cj),
        eta=_mv(AiT, E_eta) + etai,
        J=linalg.sym(AiT @ E_J @ Ai + Ji),
    )


def _elements(lqt: LQT) -> ValueElement:
    """Per-stage scan elements ``(B, T, ...)``, the cross term eliminated by
    completing the square in the control: ``Abar = A - Bbar U^-1 M^T H``,
    ``Xtil = X - M U^-1 M^T``.  The terminal element is separate
    (:func:`_terminal_element`)."""
    nu = lqt.U.shape[-1]
    # Z is invertible (the identity in every use); Bbar = B Z^{-1}.
    Bbar = linalg.solve(lqt.Z.transpose(-1, -2), lqt.B.transpose(-1, -2),
                        pivot=False).transpose(-1, -2)
    eye_u = torch.eye(nu, dtype=lqt.U.dtype, device=lqt.U.device)
    Uinv = linalg.solve(lqt.U, eye_u.expand(lqt.U.shape), pivot=False)
    UinvMt = Uinv @ lqt.M.transpose(-1, -2)

    Abar = lqt.A - Bbar @ UinvMt @ lqt.H
    cbar = lqt.c + _mv(Bbar, lqt.s + _mv(UinvMt, lqt.r))
    C = linalg.sym(Bbar @ Uinv @ Bbar.transpose(-1, -2))
    Xtil = lqt.X - lqt.M @ UinvMt
    Ht = lqt.H.transpose(-1, -2)
    J = linalg.sym(Ht @ Xtil @ lqt.H)
    eta = _mv(Ht @ Xtil, lqt.r)
    return ValueElement(A=Abar, b=cbar, C=C, eta=eta, J=J)


def _terminal_element(lqt: LQT) -> ValueElement:
    """Terminal element per lane: pure state cost, no dynamics."""
    HTt = lqt.HT.transpose(-1, -2)
    JT = linalg.sym(HTt @ lqt.XT @ lqt.HT)
    etaT = _mv(HTt @ lqt.XT, lqt.rT)
    zero = torch.zeros_like(JT)
    return ValueElement(A=zero, b=torch.zeros_like(etaT), C=zero, eta=etaT,
                        J=JT)


def stage_gains(stage: LQTStage, S_next, v_next):
    """Per-stage LQR gain and value update from the next-stage value
    ``V_{k+1}(x) = 1/2 x^T S' x - x^T v'``: returns ``K, d`` of the control
    law ``u_k = d_k - K_k x_k``, the value pair ``(S_k, v_k)``, the
    predicted cost change ``dV_k = d^T q_u + 1/2 d^T Quu d`` and a Cholesky
    positive-definiteness flag for ``Quu``.  Shared by the sequential scan
    and the parallel post-pass; batched over leading axes."""
    A, B, c, X, H, r, U, Z, s, M = stage
    At, Bt, Ht = A.transpose(-1, -2), B.transpose(-1, -2), H.transpose(-1, -2)
    Zt, Mt = Z.transpose(-1, -2), M.transpose(-1, -2)

    Sc_minus_v = _mv(S_next, c) - v_next
    Quu = linalg.sym(Zt @ U @ Z + Bt @ S_next @ B)
    Qxu = Ht @ M @ Z + At @ S_next @ B
    Qxx = linalg.sym(Ht @ X @ H + At @ S_next @ A)
    qu = -_mv(Zt @ U, s) - _mv(Zt @ Mt, r) + _mv(Bt, Sc_minus_v)
    qx = -_mv(Ht @ X, r) - _mv(Ht @ M, s) + _mv(At, Sc_minus_v)

    posdef = torch.isfinite(linalg.cholesky(Quu)).all(-1).all(-1)
    # Solve Quu [d | K] = [-qu | Qxu^T] in one factorization.
    rhs = torch.cat([-qu[..., None], Qxu.transpose(-1, -2)], dim=-1)
    sol = linalg.cholesky_solve(Quu, rhs)
    d, K = sol[..., 0], sol[..., 1:]

    S = linalg.sym(Qxx - Qxu @ K)
    v = -(qx + _mv(Qxu, d))
    dV = (d * qu).sum(-1) + 0.5 * (d * _mv(Quu, d)).sum(-1)
    return K, d, S, v, dV, posdef


def par_bwd_pass(lqt: LQT, plain: bool = False):
    """Parallel (associative-scan) backward pass.

    Returns ``(Kx, d, S, v, pred_reduction, feasible)``: ``S, v`` the value
    terms at every k in 0..T, ``pred_reduction (B,)`` the predicted total
    cost change of the full step from zero deviation, ``feasible (B,)``
    every stage's ``Quu`` and ``U`` positive definite, per lane.  The value
    scan runs in its kernel on a card; ``plain=True`` runs its plain
    version whatever the device.
    """
    elems = _elements(lqt)
    scan = value_scan_plain if plain else value_scan
    scanned = ValueElement(*scan(*(e.contiguous() for e in elems)))
    # scanned[k] spans stages [k, T); fold the terminal cost in with one
    # batched combine to obtain V_k for every k.
    eT = _terminal_element(lqt)
    full = value_combine(scanned, ValueElement(*(e[:, None] for e in eT)))
    S = torch.cat([full.J, eT.J[:, None]], dim=1)
    v = torch.cat([full.eta, eT.eta[:, None]], dim=1)
    K, d, _, _, dV, posdef = stage_gains(lqt_stages(lqt), S[:, 1:], v[:, 1:])
    feasible = posdef.all(-1) & linalg.is_posdef(lqt.U, batch_dims=1)
    return K, d, S, v, stage_sum(dV), feasible


def seq_bwd_pass(lqt: LQT):
    """Sequential backward pass, ``(Kx, d, S, v)``; the same
    :func:`stage_gains` as the parallel pass."""
    K, d, S, v, _, _ = seq_bwd_pass_full(lqt)
    return K, d, S, v


def seq_bwd_pass_full(lqt: LQT):
    """Sequential backward pass with the parallel pass's 6-tuple."""
    HTt = lqt.HT.transpose(-1, -2)
    ST = linalg.sym(HTt @ lqt.XT @ lqt.HT)
    vT = _mv(HTt @ lqt.XT, lqt.rT)
    stages = lqt_stages(lqt)
    T = lqt.A.shape[1]
    out = [None] * T
    S_next, v_next = ST, vT
    for k in range(T - 1, -1, -1):
        stage = LQTStage(*(f[:, k] for f in stages))
        out[k] = stage_gains(stage, S_next, v_next)
        S_next, v_next = out[k][2], out[k][3]
    K, d, S, v, dV, posdef = (torch.stack(f, dim=1) for f in zip(*out))
    S = torch.cat([S, ST[:, None]], dim=1)
    v = torch.cat([v, vT[:, None]], dim=1)
    feasible = posdef.all(-1) & linalg.is_posdef(lqt.U, batch_dims=1)
    return K, d, S, v, stage_sum(dV), feasible


def _closed_loop(lqt: LQT, Kx, d):
    """Closed-loop affine step maps ``x_{k+1} = F_k x_k + e_k``."""
    return lqt.A - lqt.B @ Kx, _mv(lqt.B, d) + lqt.c


def par_fwd_pass(lqt: LQT, x0, Kx, d, plain: bool = False):
    """Parallel forward pass: the closed-loop rollout as a prefix scan.

    ``x0 (B, nx)``; returns ``u (B, T, nu)`` and ``x (B, T+1, nx)``.  The
    affine scan runs in its kernel on a card; ``plain=True`` runs its plain
    version whatever the device.
    """
    F, e = _closed_loop(lqt, Kx, d)
    # Absorb x0 into element 0 so prefix combination yields x_{k+1}.
    e0 = _mv(F[:, 0], x0) + e[:, 0]
    F = torch.cat([torch.zeros_like(F[:, :1]), F[:, 1:]], dim=1)
    e = torch.cat([e0[:, None], e[:, 1:]], dim=1)
    scan = affine_scan_plain if plain else affine_scan
    _, xs = scan(F.contiguous(), e.contiguous(), reverse=False)
    x = torch.cat([x0[:, None], xs], dim=1)
    u = d - _mv(Kx, x[:, :-1])
    return u, x


def seq_fwd_pass(lqt: LQT, x0, Kx, d):
    """Sequential forward pass."""
    F, e = _closed_loop(lqt, Kx, d)
    xs = [x0]
    for k in range(F.shape[1]):
        xs.append(_mv(F[:, k], xs[-1]) + e[:, k])
    x = torch.stack(xs, dim=1)
    u = d - _mv(Kx, x[:, :-1])
    return u, x


def newton_lqt(lin: LinearizedOCP, d: Derivatives, terminal_hessian) -> LQT:
    """The Newton-step LQT from costate-contracted stage data: references
    ``s = -(R - M^T Q^{-1} M)^{-1} ru`` and ``r = -Q^{-1} M s`` make the
    LQT's linear terms reproduce the Newton model's ``ru^T du``.
    ``terminal_hessian (B, nx, nx)`` is the exact ``hessian(final_cost)``
    or ``Q[:, 0]`` (SolverConfig.terminal_hessian)."""
    ru, Q, R, M = lin
    B, T, nx = Q.shape[:3]
    nu = R.shape[-1]
    kw = dict(dtype=Q.dtype, device=Q.device)

    Qinv_M = linalg.solve(Q, M, pivot=False)
    Schur = R - M.transpose(-1, -2) @ Qinv_M
    s = -linalg.solve(Schur, ru[..., None], pivot=False)[..., 0]
    r = -_mv(Qinv_M, s)
    eye_x = torch.eye(nx, **kw)
    return LQT(
        A=d.fx,
        B=d.fu,
        c=torch.zeros((B, T, nx), **kw),
        XT=terminal_hessian,
        HT=eye_x.expand(B, nx, nx),
        rT=torch.zeros((B, nx), **kw),
        X=Q,
        H=eye_x.expand(B, T, nx, nx),
        r=r,
        U=R,
        Z=torch.eye(nu, **kw).expand(B, T, nu, nu),
        s=s,
        M=M,
    )
