"""Costate (adjoint) recursions (counterpart of
``ipoc_tpu/parallel/costates.py``): ``lam_T = grad(final_cost)(x_T)``,
``lam_k = cx_k + fx_k^T lam_{k+1}``, sequential and parallel-in-time.

Batched over a leading lane axis B.  ``lam_T`` is computed outside the
kernels, as the JAX package does.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_batched
from ipoc_tpu_torch.ops.derivatives import final_gradient
from ipoc_tpu_torch.ops.scan_kernels import affine_scan
from ipoc_tpu_torch.problem import OCP, Derivatives


def affine_combine(earlier, later):
    """Compose affine maps ``earlier(later(v))``: the element ``(F, c)`` is
    ``v -> F @ v + c``.  Shared by the costate scan and the LQT forward
    pass; batched over leading axes."""
    Fa, ca = earlier
    Fb, cb = later
    return Fa @ Fb, (Fa @ cb.unsqueeze(-1)).squeeze(-1) + ca


def seq_costates(ocp: OCP, final_state, d: Derivatives):
    """Batched sequential costates ``(B, T+1, nx)`` from terminal states
    ``(B, nx)`` and stage derivatives ``(B, T, ...)``: the costate kernel on
    a card, its plain version on the CPU."""
    lam_T = final_gradient(ocp, final_state)
    return seq_costates_batched(d.cx.contiguous(), d.fx.contiguous(),
                                lam_T.contiguous())


def par_costates(ocp: OCP, final_state, d: Derivatives):
    """Batched parallel-in-time costates ``(B, T+1, nx)``: a suffix scan of
    the affine elements ``lam -> fx_k^T lam + cx_k`` with a terminal element
    ``(0, lam_T)``, so that the suffix combination at k holds ``lam_k`` in
    its constant slot.  The affine-scan kernel on a card, its plain version
    (the associative scan) on the CPU; same values as :func:`seq_costates`.
    """
    lam_T = final_gradient(ocp, final_state)
    F = torch.cat([d.fx.transpose(-1, -2), torch.zeros_like(d.fx[:, :1])],
                  dim=1)
    c = torch.cat([d.cx, lam_T[:, None]], dim=1)
    return affine_scan(F.contiguous(), c.contiguous(), reverse=True)[1]
