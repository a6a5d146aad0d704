"""The device mesh and the cross-shard associative scan (counterpart of
``ipoc_tpu/parallel/sharding.py``), on ``torch.distributed``.

JAX's ``shard_map`` becomes one process per rank, each calling the same
function (SPMD).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world group with
the dimensions ``("batch", "time")``: ``batch`` shards independent
scenarios, ``time`` the horizon of each solve.  Where JAX names a mesh
axis (``axis_name``), the port's inner functions take that axis's
process group (``mesh.get_group(axis)``); a rank's coordinate along it is
``mesh.get_local_rank(axis)`` (``lax.axis_index``).

Every collective here is an ``all_gather``, which gloo and NCCL both run
on CPU and CUDA tensors: a reduction gathers the ranks' partials and
combines them in rank order on every rank, so that each rank holds the
same bits and the ranks' loops, steered by those values, stay in step.

The combine convention is ``fn(earlier, later)``, earlier in the scanned
(time) direction, as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist

from ipoc_tpu_torch.parallel.scan import associative_scan

AXES = ("batch", "time")


def make_mesh(batch: int = 1, time: int = 1):
    """A ``DeviceMesh`` of shape ``(batch, time)`` over the world group,
    dimensions ``("batch", "time")``; rank ``b * time + t`` sits at
    ``(b, t)``.  Every rank of the world calls it (it makes the subgroups).

    ``batch * time`` must equal the world size: each rank is one place of
    the mesh.  The mesh's device type is ``"cuda"`` where a card is present
    (then ``DeviceMesh`` selects device ``rank % device_count`` unless one
    is already selected), else ``"cpu"``; the groups carry tensors of
    either kind as their backend allows.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize first")
    n, world = batch * time, dist.get_world_size()
    if n != world:
        raise ValueError(f"need {n} ranks, have {world}")
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            (batch, time), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (``mesh.shape[axis]`` in JAX)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def rank_device(like: torch.Tensor) -> torch.device:
    """The device a rank's entry points run on: the CPU for CPU tensors on
    a gloo world, else ``cuda:<local rank % device_count>`` (``LOCAL_RANK``,
    or the rank where it is unset).  No card and no such CPU case raise."""
    if like.device.type == "cpu" and dist.get_backend() == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded entry points run on a card unless "
            "they are given CPU tensors on a gloo process group")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def shard(a: torch.Tensor, index: int, count: int, dim: int):
    """Slice ``index`` of ``count`` equal slices of ``a`` along ``dim``
    (``in_specs`` for one rank)."""
    n = a.shape[dim] // count
    return a.narrow(dim, index * n, n)


def gather_shards(a: torch.Tensor, group, dim: int):
    """The ranks' slices concatenated along ``dim`` in rank order, on every
    rank of ``group`` (``out_specs``)."""
    return torch.cat(tuple(all_gather(a, group).unbind(0)), dim=dim)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``t`` stacked on a new leading
    axis in rank order, on every rank of ``group``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def all_gather_many(tensors, group) -> tuple:
    """:func:`all_gather` of several tensors of one dtype in one
    collective (each collective costs a round trip)."""
    flat = all_gather(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[:, start:start + t.numel()].reshape(
            flat.shape[:1] + t.shape))
        start += t.numel()
    return tuple(out)


def rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """The gathered partials ``(S, ...)`` added in rank order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum`` with the partials added in rank order, so that every
    rank computes the same bits."""
    return rank_sum(all_gather(t, group))


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax``."""
    return all_gather(t, group).amax(0)


def pall(t: torch.Tensor, group) -> torch.Tensor:
    """A boolean ``t`` true on every rank of ``group`` (gathered as bytes:
    the backends' boolean support differs)."""
    return all_gather(t.to(torch.uint8), group).bool().all(0)


def pany(t: torch.Tensor, group) -> torch.Tensor:
    """A boolean ``t`` true on some rank of ``group``."""
    return all_gather(t.to(torch.uint8), group).bool().any(0)


def _row(elems, dim: int, i: int):
    return tuple(e.select(dim, i) for e in elems)


def combine_across_shards(fn: Callable, local: tuple, group,
                          reverse: bool = False, dim: int = 1) -> tuple:
    """Phases 2 and 3 of :func:`sharded_associative_scan` on a scan that
    each rank already ran over its slice (``local``, elements along
    ``dim``): an all-gather of each shard's aggregate, a scan over those
    aggregates, and one broadcast combine of the external prefix (or
    suffix) into every local element.  The callers with a scan kernel run
    the local phase in it and the rest here."""
    idx = dist.get_rank(group)
    n_shards = dist.get_world_size(group)
    local = tuple(local)
    if reverse:
        # This shard's aggregate spans its slice: the local suffix at 0.
        aggs = all_gather_many(_row(local, dim, 0), group)
        suffixes = associative_scan(lambda a, b: fn(b, a), aggs,
                                    reverse=True, dim=0)
        if idx == n_shards - 1:
            return local
        # The external suffix of shard i combines shards i+1..S-1.
        ext = tuple(s[idx + 1].unsqueeze(dim).expand_as(l)
                    for s, l in zip(suffixes, local))
        return tuple(fn(local, ext))
    aggs = all_gather_many(_row(local, dim, -1), group)
    prefixes = associative_scan(fn, aggs, dim=0)
    if idx == 0:
        return local
    # The external prefix of shard i combines shards 0..i-1.
    ext = tuple(p[idx - 1].unsqueeze(dim).expand_as(l)
                for p, l in zip(prefixes, local))
    return tuple(fn(ext, local))


def sharded_associative_scan(fn: Callable, elems: tuple, group,
                             reverse: bool = False, dim: int = 1) -> tuple:
    """Associative scan over the concatenation of the ranks' element slices.

    Each rank of ``group`` holds a contiguous, time-ordered slice of the
    elements along ``dim`` (a tuple of tensors), rank order being time
    order; the result is the scan of the whole array restricted to the
    local slice, ``fn`` taking ``(earlier, later)``.  Three phases, as in
    JAX: a local scan (:func:`ipoc_tpu_torch.parallel.scan.associative_scan`,
    JAX's recursion), an all-gather of each shard's aggregate with a tiny
    scan over them, and one broadcast combine
    (:func:`combine_across_shards`)."""
    elems = tuple(elems)
    if reverse:
        local = associative_scan(lambda a, b: fn(b, a), elems, reverse=True,
                                 dim=dim)
    else:
        local = associative_scan(fn, elems, dim=dim)
    return combine_across_shards(fn, local, group, reverse=reverse, dim=dim)
