"""Time-sharded LQT passes (counterpart of
``ipoc_tpu/parallel/time_sharded.py``).

The horizon of a solve is sharded over the ranks of a process group (the
mesh's ``"time"`` dimension), rank order being time order: each rank scans
its slice of the Riccati or affine elements, in the value-scan and
affine-scan kernels on a card (their plain versions on the CPU), the
shards' aggregates are gathered once, and a local combine completes the
global scan (``parallel/sharding.py``).  Element construction, the stage
gains and the control extraction need no communication.

As everywhere in the port the passes are batched over a leading lane axis
B: every per-stage field is ``(B, T_local, ...)``, the terminal fields
``(B, ...)`` are the same on every rank, and the scalars come back as
``(B,)``, the same bits on every rank.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.ops import linalg
from ipoc_tpu_torch.ops.scan_kernels import affine_scan, value_scan
from ipoc_tpu_torch.parallel.costates import affine_combine
from ipoc_tpu_torch.parallel.lqt import (
    LQT,
    LQTStage,
    ValueElement,
    _elements,
    _mv,
    _terminal_element,
    lqt_stages,
    stage_gains,
    value_combine,
)
from ipoc_tpu_torch.parallel.sharding import (
    all_gather,
    all_gather_many,
    axis_size,
    combine_across_shards,
    gather_shards,
    rank_device,
    rank_sum,
    shard,
)
from ipoc_tpu_torch.problem import stage_sum

TIME_AXIS = "time"


def _later_first(a, b):
    """The forward scans' ``fn(earlier, later)``: the affine map of the
    later interval after the earlier one's."""
    return affine_combine(b, a)


def shift_left_across_shards(a, fill, group):
    """A time-sharded per-stage array ``(B, T_local, ...)`` moved one stage
    earlier, ``v_k -> v_{k+1}``: the local tail takes stage 0 of the next
    rank (one all-gather of that row), the globally last stage ``fill``
    ``(B, ...)``.  ``a`` and ``fill`` may be tuples of arrays, shifted in
    one all-gather."""
    one = isinstance(a, torch.Tensor)
    arrays, fills = ((a,), (fill,)) if one else (tuple(a), tuple(fill))
    idx = torch.distributed.get_rank(group)
    last = idx == torch.distributed.get_world_size(group) - 1
    heads = all_gather_many([x[:, 0] for x in arrays], group)
    out = tuple(torch.cat([x[:, 1:], (f if last else h[idx + 1])[:, None]],
                          dim=1) for x, f, h in zip(arrays, fills, heads))
    return out[0] if one else out


def par_bwd_pass_time_sharded(lqt: LQT, group):
    """Backward LQT pass with the horizon sharded over ``group``.

    ``(Kx, d, S, v, pred_reduction, feasible)`` as ``par_bwd_pass``, but
    ``S, v`` hold the local stages' values only (the terminal pair is the
    terminal cost's), so that every output shards evenly; ``pred`` and
    ``feasible`` are reduced over the group.  The local suffix scan is the
    value-scan kernel on a card.
    """
    elems = _elements(lqt)
    local = value_scan(*(e.contiguous() for e in elems))
    scanned = ValueElement(*combine_across_shards(
        value_combine, local, group, reverse=True))
    eT = _terminal_element(lqt)
    full = value_combine(scanned, ValueElement(*(e[:, None] for e in eT)))
    S_stage, v_stage = full.J, full.eta  # S_k, v_k for the local stages
    # stage_gains wants S_{k+1}, v_{k+1}.
    S_next, v_next = shift_left_across_shards(
        (S_stage, v_stage), (eT.J, eT.eta), group)
    K, d, _, _, dV, posdef = stage_gains(lqt_stages(lqt), S_next, v_next)
    ok = posdef.all(-1) & linalg.is_posdef(lqt.U, batch_dims=1)
    # The predicted reduction and the flag in one all-gather.
    parts = all_gather(torch.stack([stage_sum(dV), ok.to(dV.dtype)], -1),
                       group)
    pred, feasible = rank_sum(parts[..., 0]), (parts[..., 1] > 0).all(0)
    return K, d, S_stage, v_stage, pred, feasible


def par_fwd_pass_time_sharded(lqt: LQT, x0, Kx, d, group,
                              with_terminal: bool = False):
    """Forward closed-loop pass with the horizon sharded over ``group``.

    ``x0 (B, nx)``; returns ``(u, x)`` with ``x`` the local *stage* states
    ``(B, T_local, nx)``, and with ``with_terminal=True`` also the terminal
    state ``x_T (B, nx)`` on every rank.  The local prefix scan is the
    affine-scan kernel on a card; one all-gather of the slices' last states
    gives both the previous rank's hand-off and ``x_T``.
    """
    F = lqt.A - lqt.B @ Kx
    e = _mv(lqt.B, d) + lqt.c
    idx = torch.distributed.get_rank(group)
    n_shards = torch.distributed.get_world_size(group)
    if idx == 0:
        # Absorb x0 into the global element 0.
        e = torch.cat([(_mv(F[:, 0], x0) + e[:, 0])[:, None], e[:, 1:]], 1)
        F = torch.cat([torch.zeros_like(F[:, :1]), F[:, 1:]], dim=1)
    local = affine_scan(F.contiguous(), e.contiguous(), reverse=False)
    F_pref, c_pref = combine_across_shards(_later_first, local, group)
    # pref[k] maps x0 to x_{k+1}.
    x_next = _mv(F_pref, x0[:, None]) + c_pref
    lasts = all_gather(x_next[:, -1], group)
    head = x0 if idx == 0 else lasts[idx - 1]
    x_stage = torch.cat([head[:, None], x_next[:, :-1]], dim=1)
    u = d - _mv(Kx, x_stage)
    if with_terminal:
        return u, x_stage, lasts[n_shards - 1]
    return u, x_stage


def solve_lqt_time_sharded(lqt: LQT, x0, mesh):
    """The whole LQT solve with the horizon sharded over the mesh's
    ``"time"`` dimension: every rank passes the full batched LQT and
    ``x0 (B, nx)`` and gets the full ``(u (B, T, nu), x_stages (B, T,
    nx))`` back.  Ranks along ``"batch"`` solve the same problem."""
    group = mesh.get_group(TIME_AXIS)
    idx, n = mesh.get_local_rank(TIME_AXIS), axis_size(mesh, TIME_AXIS)
    T = lqt.A.shape[1]
    if T % n != 0:
        raise ValueError(f"horizon {T} not divisible by {n} shards")
    dev = rank_device(x0)
    local = LQT(*(shard(f.to(dev), idx, n, 1) if name in LQTStage._fields
                  else f.to(dev) for name, f in zip(LQT._fields, lqt)))
    x0 = x0.to(dev)
    K, d, _, _, _, _ = par_bwd_pass_time_sharded(local, group)
    u, x = par_fwd_pass_time_sharded(local, x0, K, d, group)
    return gather_shards(u, group, 1), gather_shards(x, group, 1)
