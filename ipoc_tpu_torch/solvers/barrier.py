"""Barrier schedule (counterpart of ``ipoc_tpu/solvers/barrier.py``): the
slice needs only the stage count; the staged loop ``barrier_loop`` is
later work (ROADMAP)."""

from __future__ import annotations

from ipoc_tpu_torch.config import SolverConfig


def n_barrier_stages(cfg: SolverConfig) -> int:
    """Number of stages the schedule runs (5 with reference defaults)."""
    n, bp = 0, cfg.bp_init
    while bp > cfg.bp_min:
        n += 1
        bp /= cfg.bp_decay
    return n
