"""ipoc_tpu_torch: the PyTorch and CUDA port of ``ipoc_tpu``.

Interior-point optimal control with the JAX package's semantics, on
PyTorch tensors; the JAX package's Pallas kernels become hand-written CUDA
kernels for Hopper (``ipoc_tpu_torch/csrc``), built with ``nvcc`` at first
use on a card.  This package never imports jax.

Ported so far: the single-grid scenario stream with the sequential Newton
step (``solve_stream`` with ``newton_impl="seq"``), its models, derivatives
and two kernels.  ROADMAP.md lists what is still to port.
"""

from ipoc_tpu_torch.config import (
    BATCH_CONFIG,
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SolverConfig,
)
from ipoc_tpu_torch.solvers.stream import StreamSolution, solve_stream

__all__ = [
    "BATCH_CONFIG",
    "DEFAULT_CONFIG",
    "FAST_CONFIG",
    "SolverConfig",
    "StreamSolution",
    "solve_stream",
]
