"""Levenberg-Marquardt / trust-region globalization (counterpart of
``ipoc_tpu/solvers/globalization.py``), elementwise over lanes."""

from __future__ import annotations

import torch

from ipoc_tpu_torch.config import SolverConfig


def gain_ratio(new_cost, cost, predicted_reduction):
    """rho = (new_cost - cost) / predicted_reduction.

    Both are negative for a good step, so rho > 0 signals simultaneous
    actual and predicted decrease.  IEEE semantics are part of the result:
    a zero prediction gives +-inf or NaN, an infeasible trial (new_cost inf)
    gives -inf/NaN, and every comparison with NaN is False.
    """
    return (new_cost - cost) / predicted_reduction


def lm_update(rp, r_inc, rho, success, cfg: SolverConfig):
    """Marquardt-Nielsen regularization update.

    On success ``rp *= max(1/3, 1 - (2 rho - 1)^3)`` and the growth factor
    resets to 2; on failure ``rp *= r_inc`` and the growth factor doubles.
    ``rp`` is clipped to [reg_min, reg_max].
    """
    dtype = rp.dtype
    rp = torch.where(
        success,
        rp * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
        rp * r_inc,
    )
    r_inc = torch.where(success, torch.full_like(r_inc, 2.0), 2.0 * r_inc)
    rp = torch.clamp(rp, cfg.reg_min, cfg.reg_max)
    # Coerce back to the carry dtype: the gain ratio may be computed at a
    # higher precision than the solver state and must not promote it.
    return rp.to(dtype), r_inc.to(dtype)
