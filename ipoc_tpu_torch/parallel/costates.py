"""Costate (adjoint) recursion (counterpart of
``ipoc_tpu/parallel/costates.py``): ``lam_T = grad(final_cost)(x_T)``,
``lam_k = cx_k + fx_k^T lam_{k+1}``.  The slice ports the sequential form;
the parallel-in-time scan is later work (ROADMAP)."""

from __future__ import annotations

from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_batched
from ipoc_tpu_torch.ops.derivatives import final_gradient
from ipoc_tpu_torch.problem import OCP, Derivatives


def seq_costates(ocp: OCP, final_state, d: Derivatives):
    """Batched sequential costates ``(B, T+1, nx)`` from terminal states
    ``(B, nx)`` and stage derivatives ``(B, T, ...)``.

    ``lam_T`` is computed outside the kernel, as the JAX package does; the
    recursion runs in the costate kernel on a card and in its plain version
    on the CPU."""
    lam_T = final_gradient(ocp, final_state)
    return seq_costates_batched(d.cx.contiguous(), d.fx.contiguous(),
                                lam_T.contiguous())
