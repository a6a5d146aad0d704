"""ipoc_tpu_torch: the PyTorch and CUDA port of ``ipoc_tpu``.

Interior-point optimal control with the JAX package's semantics, on
PyTorch tensors; the JAX package's Pallas kernels become hand-written CUDA
kernels for Hopper (``ipoc_tpu_torch/csrc``), built with ``nvcc`` at first
use on a card.  This package never imports jax.

Ported so far: the bench's default path, ``solve_stream_multigrid`` with a
DDP coarse level, and the single-grid scenario stream, ``solve_stream``,
under ``BATCH_CONFIG`` (the packed stream on the mega kernel, with
per-stage code generated from the model), with ``newton_impl="ddp"`` and
with ``newton_impl="seq"`` (two kernels); their models and derivatives.
ROADMAP.md lists what is still to port.
"""

from ipoc_tpu_torch.config import (
    BATCH_CONFIG,
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SolverConfig,
)
from ipoc_tpu_torch.solvers.stream import (
    MultigridSolution,
    StreamSolution,
    solve_stream,
    solve_stream_multigrid,
)

__all__ = [
    "BATCH_CONFIG",
    "DEFAULT_CONFIG",
    "FAST_CONFIG",
    "MultigridSolution",
    "SolverConfig",
    "StreamSolution",
    "solve_stream",
    "solve_stream_multigrid",
]
