"""Solvers: flat-mode IP Newton lanes, the streaming executor, and their
sharded forms."""

from ipoc_tpu_torch.solvers.batched import solve_batch_sharded
from ipoc_tpu_torch.solvers.stream import (
    solve_stream_multigrid_sharded,
    solve_stream_sharded,
)
from ipoc_tpu_torch.solvers.time_sharded import (
    ip_newton_batch_time_sharded,
    ip_newton_time_sharded,
)

__all__ = [
    "ip_newton_batch_time_sharded",
    "ip_newton_time_sharded",
    "solve_batch_sharded",
    "solve_stream_multigrid_sharded",
    "solve_stream_sharded",
]
