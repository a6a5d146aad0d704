"""Multi-process initialization and the global mesh (counterpart of
``ipoc_tpu/parallel/distributed.py``), on ``torch.distributed``.

One process per rank.  The global mesh keeps each solve's time shards on
one node, so that the collectives inside a solve (the scans' aggregate
gathers, the neighbour exchanges, the cost and accept reductions) stay on
the node's links and only the batch dimension spans nodes.  In a single
process :func:`initialize` does nothing.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ipoc_tpu_torch.parallel.sharding import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               timeout: datetime.timedelta | None = None) -> None:
    """Initialize the default process group; nothing for one process.

    With ``num_processes > 1`` the group comes from the arguments:
    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``) and ``process_id`` this process's rank.  Without
    them, a ``WORLD_SIZE`` above 1 in the environment (``torchrun``) gives
    the group from the environment.  ``backend`` defaults to NCCL where a
    card is present and gloo otherwise.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                **kw)
    elif num_processes is None and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        dist.init_process_group(backend, init_method="env://", **kw)


def global_mesh(time: int = 1):
    """The mesh over every rank, ``(world // time, time)`` over ``("batch",
    "time")``, with each row of ``time`` ranks inside one node.

    Ranks are numbered node-major (``torchrun`` does so), so consecutive
    rows of ``time`` ranks stay on one node when ``time`` divides the
    ranks per node (``LOCAL_WORLD_SIZE``; every rank when it is unset).
    """
    n = dist.get_world_size()
    if n % time != 0:
        raise ValueError(f"device count {n} not divisible by time={time}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if time > local:
        raise ValueError(
            f"time={time} shards would span hosts (local devices: {local})")
    if local % time != 0:
        # Rows of `time` ranks stay within one node only when `time`
        # divides the ranks per node: 8 local ranks with time=6 would put
        # ranks 6..11 (two nodes) in one time group.
        raise ValueError(
            f"time={time} does not divide the per-host device count "
            f"{local}; time groups would straddle hosts")
    return make_mesh(n // time, time)


def scaling_report(solves_per_sec: float, n_chips: int,
                   single_chip_rate: float) -> dict:
    """Multi-chip scaling-efficiency record (BASELINE target >= 80%)."""
    ideal = single_chip_rate * n_chips
    return {
        "chips": n_chips,
        "solves_per_sec": solves_per_sec,
        "ideal": ideal,
        "efficiency": solves_per_sec / ideal if ideal else float("nan"),
    }
