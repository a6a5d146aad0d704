"""ipoc_tpu_torch: the PyTorch and CUDA port of ``ipoc_tpu``.

Interior-point optimal control with the JAX package's semantics, on
PyTorch tensors; the JAX package's Pallas kernels become hand-written CUDA
kernels for Hopper (``ipoc_tpu_torch/csrc``), built with ``nvcc`` at first
use on a card.  This package never imports jax.

Ported so far: the paper's parallel-in-time solve,
``par_interior_point_optimal_control`` (with ``solve_batch`` and ``solve``,
the sequential validation solve and the public LQT passes), on the
associative-scan kernels and the one-launch parallel trial; the bench's
default path, ``solve_stream_multigrid`` with a DDP coarse level, and the
single-grid scenario stream, ``solve_stream``, under ``BATCH_CONFIG`` (the
packed stream on the mega kernel, with per-stage code generated from the
model, at any horizon), with ``newton_impl="ddp"``, ``"seq"`` and
``"par"``; the bench's batch mode, ``solve_batch`` under ``BATCH_CONFIG``
(staged or flat, Newton or DDP) on the fused trial's, rollout and
transition kernels; bench.py's NMPC mode, ``solve_batch_packed`` (with a
warm barrier entry) on the mega kernel and the receding-horizon loops of
``ipoc_tpu_torch.mpc``; the single-solve IP-DDP baseline,
``interior_point_ddp`` (``solve_batch``/``solve`` with ``method="ddp"``);
warm transfer in the packed stream; the distribution layer on
``torch.distributed`` (``ipoc_tpu_torch.parallel.sharding``,
``parallel.distributed``, ``parallel.time_sharded``: the horizon-sharded
solve ``ip_newton_time_sharded`` and its batch x time form, and the
batch-sharded solves and streams, exported from
``ipoc_tpu_torch.solvers``); their models and derivatives.  ROADMAP.md
lists what is still to port.
"""

from ipoc_tpu_torch.config import (
    BATCH_CONFIG,
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SolverConfig,
)
from ipoc_tpu_torch.parallel.costates import par_costates, seq_costates
from ipoc_tpu_torch.parallel.lqt import (
    LQT,
    newton_lqt,
    par_bwd_pass,
    par_fwd_pass,
    seq_bwd_pass,
    seq_fwd_pass,
)
from ipoc_tpu_torch.solvers.batched import BatchSolution, solve_batch
from ipoc_tpu_torch.solvers.ip_ddp import interior_point_ddp
from ipoc_tpu_torch.solvers.ip_newton import (
    par_interior_point_optimal_control,
    seq_interior_point_optimal_control,
)
from ipoc_tpu_torch.solvers.solution import IPSolution, solve
from ipoc_tpu_torch.solvers.stream import (
    MultigridSolution,
    StreamSolution,
    solve_stream,
    solve_stream_multigrid,
)

__all__ = [
    "BATCH_CONFIG",
    "BatchSolution",
    "DEFAULT_CONFIG",
    "FAST_CONFIG",
    "IPSolution",
    "LQT",
    "MultigridSolution",
    "SolverConfig",
    "StreamSolution",
    "interior_point_ddp",
    "newton_lqt",
    "par_bwd_pass",
    "par_costates",
    "par_fwd_pass",
    "par_interior_point_optimal_control",
    "seq_bwd_pass",
    "seq_costates",
    "seq_fwd_pass",
    "seq_interior_point_optimal_control",
    "solve",
    "solve_batch",
    "solve_stream",
    "solve_stream_multigrid",
]
