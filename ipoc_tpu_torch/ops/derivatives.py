"""The derivative engine (counterpart of ``ipoc_tpu/ops/derivatives.py``).

Model derivatives are ``torch.func`` transforms (``grad``, ``jacrev``) of
the per-stage callables, ``vmap``-ed over every stage of
every trajectory at once: the leading axes ``(..., T)`` are flattened into
one batch of B*T stages.  This is plain tensor code outside any kernel, as
XLA computed it outside Pallas in the JAX package's unfused arm.  Nothing is
chunked: at the bench's size (4096 lanes x 100 stages) the stage batch
holds well inside one card's memory.

Hessians are reverse over reverse (``jacrev(grad(.))``), where the JAX
package takes forward over reverse.  Both are exact; the port avoids
forward mode because ``torch.func.jacfwd`` promotes a float32 result to
float64 when the function mixes a 0-dim tensor with a Python float (as
``x[..., i] - GOAL[i]`` does under ``vmap``), which would silently run the
float32 path's Hessians in float64.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacrev, vmap

from ipoc_tpu_torch.problem import OCP, Derivatives, LinearizedOCP


def over_leading(fn, lead: tuple, *args):
    """``vmap`` ``fn`` over the flattened leading axes ``lead`` of ``args``.

    Each argument has shape ``lead + rest``; outputs come back as
    ``lead + out_rest`` (a tensor or a tuple of tensors)."""
    n = len(lead)
    flat = [a.reshape((-1,) + a.shape[n:]) for a in args]
    out = vmap(fn)(*flat)
    if isinstance(out, torch.Tensor):
        return out.reshape(lead + out.shape[1:])
    return tuple(o.reshape(lead + o.shape[1:]) for o in out)


def stage_barrier(bp, lead: tuple, like: torch.Tensor):
    """The barrier parameter as one value per stage: ``bp`` is a float or a
    tensor of the trajectory batch shape ``lead[:-1]``."""
    bp = torch.as_tensor(bp, dtype=like.dtype, device=like.device)
    return bp.reshape(bp.shape + (1,) * (len(lead) - bp.dim())).expand(lead)


def compute_derivatives(ocp: OCP, states, controls, bp) -> Derivatives:
    """Stage derivatives of cost and dynamics along the trajectory, first
    and second order (the tensor form): ``cxx (..., T, nx, nx)``,
    ``cxu[i, j] = d2c/dx_i du_j``, ``fxx[i, j, k] = d2f_i/dx_j dx_k``,
    ``fxu[i, j, k] = d2f_i/dx_j du_k``, ``fuu`` likewise.  The DDP trial
    contracts the dynamics curvature with the value gradient."""
    lead = controls.shape[:-1]

    def stage(x, u, b):
        cx, cu = grad(ocp.stage_cost, argnums=(0, 1))(x, u, b)
        (cxx, cxu), (_, cuu) = jacrev(grad(ocp.stage_cost, argnums=(0, 1)),
                                      argnums=(0, 1))(x, u, b)
        fx, fu = jacrev(ocp.dynamics, argnums=(0, 1))(x, u)
        (fxx, fxu), (_, fuu) = jacrev(jacrev(ocp.dynamics, argnums=(0, 1)),
                                      argnums=(0, 1))(x, u)
        return cx, cu, cxx, cuu, cxu, fx, fu, fxx, fuu, fxu

    return Derivatives(*over_leading(
        stage, lead, states[..., :-1, :], controls,
        stage_barrier(bp, lead, controls)))


def compute_lqr_params(costates, d: Derivatives) -> LinearizedOCP:
    """Newton stage data from the tensor form, with the dynamics curvature
    contracted with the shifted costates ``lam[1:]``: ``ru = cu + fu' lam``,
    ``Q = cxx + lam . fxx``, ``R = cuu + lam . fuu``, ``M = cxu + lam .
    fxu``.  Equal to :func:`compute_hamiltonian_lqr` up to rounding."""
    lam = costates[..., 1:, :]
    ru = d.cu + torch.einsum("...tiu,...ti->...tu", d.fu, lam)
    Q = d.cxx + torch.einsum("...ti,...tijk->...tjk", lam, d.fxx)
    R = d.cuu + torch.einsum("...ti,...tijk->...tjk", lam, d.fuu)
    M = d.cxu + torch.einsum("...ti,...tijk->...tjk", lam, d.fxu)
    return LinearizedOCP(ru, Q, R, M)


def first_order_stages(ocp: OCP, stage_states, controls, bp) -> Derivatives:
    """:func:`compute_first_order` on explicit stage states ``(..., T, nx)``
    (``x_0..x_{T-1}``, no terminal row): the form the time-sharded solver
    takes, where each rank holds only its slice of the stages."""
    lead = controls.shape[:-1]

    def stage(x, u, b):
        cx, cu = grad(ocp.stage_cost, argnums=(0, 1))(x, u, b)
        fx, fu = jacrev(ocp.dynamics, argnums=(0, 1))(x, u)
        return cx, cu, fx, fu

    cx, cu, fx, fu = over_leading(stage, lead, stage_states, controls,
                                  stage_barrier(bp, lead, controls))
    return Derivatives(cx, cu, None, None, None, fx, fu, None, None, None)


def compute_first_order(ocp: OCP, states, controls, bp) -> Derivatives:
    """First-order stage derivatives (cx, cu, fx, fu) along the trajectory.

    ``states`` is ``(..., T+1, nx)``, ``controls`` ``(..., T, nu)``; the
    second-order fields are ``None``.
    """
    return first_order_stages(ocp, states[..., :-1, :], controls, bp)


def compute_hamiltonian_lqr(ocp: OCP, states, controls, costates, bp
                            ) -> LinearizedOCP:
    """Newton stage data as Hessians of the stage Hamiltonian
    ``H_k(x, u) = stage_cost(x, u, bp) + lam_{k+1} . dynamics(x, u)``:
    ``ru = dH/du``, ``Q = d2H/dx2``, ``R = d2H/du2``, ``M = d2H/dxdu``.

    One reverse-over-reverse pass per stage gives all four blocks.
    """
    return hamiltonian_lqr_stages(ocp, states[..., :-1, :], controls,
                                  costates[..., 1:, :], bp)


def hamiltonian_lqr_stages(ocp: OCP, stage_states, controls, next_costates,
                           bp) -> LinearizedOCP:
    """:func:`compute_hamiltonian_lqr` on explicit per-stage inputs: states
    ``x_k``, controls ``u_k`` and costates ``lam_{k+1}``, all ``(..., T,
    .)`` with no terminal row, for callers that hold a slice of the
    stages."""
    lead = controls.shape[:-1]

    def stage(x, u, lam_next, b):
        def ham(xx, uu):
            return (ocp.stage_cost(xx, uu, b)
                    + (lam_next * ocp.dynamics(xx, uu)).sum(-1))

        def gradient(xx, uu):
            gx, gu = grad(ham, argnums=(0, 1))(xx, uu)
            return (gx, gu), gu

        ((Q, M), (_, R)), ru = jacrev(gradient, argnums=(0, 1),
                                      has_aux=True)(x, u)
        return ru, Q, R, M

    ru, Q, R, M = over_leading(stage, lead, stage_states, controls,
                               next_costates,
                               stage_barrier(bp, lead, controls))
    return LinearizedOCP(ru, Q, R, M)


def final_gradient(ocp: OCP, final_states):
    """``grad(final_cost)`` at each ``(..., nx)`` terminal state."""
    return over_leading(grad(ocp.final_cost), final_states.shape[:-1],
                        final_states)


def final_hessian(ocp: OCP, final_states):
    """``hessian(final_cost)`` at each terminal state:
    ``(..., nx) -> (..., nx, nx)``."""
    return over_leading(jacrev(grad(ocp.final_cost)),
                        final_states.shape[:-1], final_states)


def check_feasibility(ocp: OCP, states, controls):
    """All stage constraints satisfied (``<= 0``) along each trajectory;
    boundary points count as feasible.  Returns a bool of the leading
    trajectory batch shape."""
    cons = ocp.constraints(states[..., :-1, :], controls)
    return (cons <= 0).flatten(-2).all(-1)
