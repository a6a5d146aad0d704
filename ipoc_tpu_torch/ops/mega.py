"""The resident mega kernel: k packed lane iterations per launch
(counterpart of ``ipoc_tpu/ops/pallas/mega_kernel.py``).

:func:`mega_k_iterations` runs ``k`` iterations of
``solvers/packed_stream.py``'s :func:`packed_lane_iter` on every active lane
in one launch of ``csrc/mega.cuh``'s ``mega_kernel``: the trial (Newton, or
DDP with ``ddp=True``), the accept and Levenberg-Marquardt update, the
convergence tests, and the stage transition with the predictor for a lane
that rolls over.  The kernel updates the lane's tensors in place and takes
its scratch arrays from a :class:`MegaWorkspace` that the caller allocates
once per stream.  The plain version, :func:`mega_k_iterations_plain`, is
``k`` masked ``packed_lane_iter`` steps on the plain evaluators; the
wrapper takes it for lanes on the CPU only.

The one kernel covers both of the JAX package's forms, the resident
``_mega_kernel`` and the streamed ``_mega_streamed_kernel``: the TPU kernel
streams the lane state through VMEM in time windows once it no longer fits
there (``mega_fits``), at T >= 600 and at every long horizon in DDP mode,
while this kernel reads the lane and its workspace from device memory at
any T, through a ``cp.async`` ring in shared memory that fetches stages
ahead of each sweep (the windows' counterpart).  An accept copies nothing:
the iterate ping-pongs between the lane's fields ``(xs, u)`` and the
workspace's ``(tx, tu)`` (the lazy accept merge's counterpart), and a lane
that ends a launch in the workspace is copied back once, so the lane's
fields hold the iterate between launches.  The lane's iteration is
``csrc/lane.h``, which the CPU tests also compile with the host compiler.
``chip_smoke.py`` holds the kernel to its plain version at T=1000 with the
streamed kernel's test matrix (Newton and DDP, two k-blocks of 2,
``max_newton_iters=2``).  Not ported, being TPU machinery: the VMEM gates
(``mega_fits``, ``_mega_sublanes``, ``stream_window``), the time blocks and
the parking of the predictor's candidate in the dead gains ring.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import SolverConfig
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.packed_stream import PackedLane, packed_lane_iter


class MegaWorkspace(NamedTuple):
    """The mega kernel's scratch arrays, batch-last like the lane: the
    other half of each lane's ping-pong iterate (a trial point or the
    predictor's candidate) and the gains."""

    tx: torch.Tensor     # (T, nx, B) states
    tu: torch.Tensor     # (T, nu, B) controls
    Kk: torch.Tensor     # (T, (1+nx)*nu, B) gains [k | K]


def mega_workspace(lane: PackedLane) -> MegaWorkspace:
    """Scratch arrays for :func:`mega_k_iterations` on lanes shaped like
    ``lane`` (allocated once per stream, reused by every launch)."""
    T, nx, B = lane.xs.shape
    nu = lane.u.shape[1]
    kw = dict(dtype=lane.xs.dtype, device=lane.xs.device)
    return MegaWorkspace(
        torch.empty((T, nx, B), **kw), torch.empty((T, nu, B), **kw),
        torch.empty((T, (1 + nx) * nu, B), **kw))


def lane_scalars(cfg: SolverConfig) -> tuple:
    """The config scalars the kernel takes at launch, in ``LaneScalars``
    order (``csrc/mega.cuh``)."""
    stage_reg = (cfg.reg_init if cfg.reg_stage_init is None
                 else cfg.reg_stage_init)
    return tuple(float(v) for v in (
        cfg.tol, cfg.stage_tol_scale, cfg.pred_floor, cfg.reg_min,
        cfg.reg_max, cfg.bp_decay, cfg.bp_min, cfg.reg_scale_floor,
        stage_reg, cfg.reg_inc_init, cfg.max_newton_iters,
        bool(cfg.stall_exit), bool(cfg.stage_predictor),
        bool(cfg.scale_reg_by_grad)))


def clone_lane(lane: PackedLane) -> PackedLane:
    """A copy of ``lane`` that owns its storage (the kernel writes lanes in
    place)."""
    return PackedLane(*(t.clone() for t in lane))


def mega_k_iterations_plain(ocp: OCP, lane: PackedLane, active,
                            cfg: SolverConfig, k: int, ddp: bool = False):
    """Plain version of the mega kernel: ``k`` masked
    :func:`packed_lane_iter` steps on the plain evaluators, stopping early
    once no active lane is unfinished.  Returns ``(lane, steps)``, a new
    lane and the number of iterations run (a 0-dim int32 tensor)."""
    cfg = cfg.replace(newton_impl="ddp" if ddp else "fused")
    steps = 0
    for _ in range(k):
        adv = active & ~lane.done
        if not bool(adv.any()):
            break
        lane = packed_lane_iter(ocp, lane, cfg, adv, plain=True)
        steps += 1
    return lane, torch.tensor(steps, dtype=torch.int32,
                              device=lane.xs.device)


def mega_k_iterations(ocp: OCP, lane: PackedLane, active, cfg: SolverConfig,
                      k: int, ddp: bool = False,
                      workspace: MegaWorkspace | None = None):
    """``k`` packed lane iterations in one launch (JAX
    ``mega_k_iterations``).

    ``lane`` is a :class:`PackedLane` (batch-last), ``active (B,)`` bool:
    an inactive lane is left as it is, and a lane stops once it is done.
    Returns ``(lane, steps)``: the updated lane and the number of
    iterations in which some active lane was not done (a 0-dim int32
    tensor on the lane's device, not read here).  On a card the kernel
    updates ``lane``'s tensors in place and returns the same lane; on the
    CPU the plain version returns a new one.
    """
    if cuda.on_cpu("mega", *lane, active):
        return mega_k_iterations_plain(ocp, lane, active, cfg, k, ddp)
    T, nx, B = lane.xs.shape
    nu = lane.u.shape[1]
    if workspace is None:
        workspace = mega_workspace(lane)
    floats = (lane.xs, lane.xT, lane.u, lane.u_prev, lane.cun, lane.rp,
              lane.r_inc, lane.bp, lane.x0, lane.bp0, *workspace)
    ng = (1 + nx) * nu
    code = cuda.check_inputs(
        "mega", floats,
        [(T, nx, B), (nx, B), (T, nu, B), (T, nu, B), (B,), (B,), (B,),
         (B,), (nx, B), (B,), (T, nx, B), (T, nu, B), (T, ng, B)])
    for t, dtype in ((lane.it, torch.int32), (lane.stage_it, torch.int32),
                     (lane.done, torch.bool), (active, torch.bool)):
        if (t.dtype != dtype or tuple(t.shape) != (B,)
                or not t.is_contiguous() or t.device != lane.xs.device):
            raise ValueError(f"mega: expected a contiguous ({B},) {dtype} "
                             f"on {lane.xs.device}")
    steps = torch.zeros((1,), dtype=torch.int32, device=lane.xs.device)
    if B == 0 or k <= 0:
        return lane, steps[0]
    written = (lane.xs, lane.xT, lane.u, lane.u_prev, lane.cun, lane.it,
               lane.stage_it, lane.rp, lane.r_inc, lane.bp, lane.done,
               *workspace)
    if len({t.data_ptr() for t in written}) != len(written):
        raise ValueError("mega: the lane's fields and the workspace must "
                         "not share storage (the kernel writes them)")
    lib = fused_iter.library(ocp, nx, nu)
    ptrs = fused_iter.pointers(
        (lane.xs, lane.xT, lane.u, lane.u_prev, lane.cun, lane.it,
         lane.stage_it, lane.rp, lane.r_inc, lane.bp, lane.done, lane.x0,
         lane.bp0, active, steps))
    scalars = lane_scalars(cfg)
    with torch.cuda.device(lane.xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ipoc_mega(code, int(ddp), ptrs,
                               fused_iter.pointers(workspace),
                               (ctypes.c_double * len(scalars))(*scalars),
                               k, B, T, stream)
    cuda.check(status, "mega")
    cuda.launches["mega"] += 1
    return lane, steps[0]


def ring_layout(ocp: OCP, nx: int, nu: int, dtype: torch.dtype) -> dict:
    """The mega kernel's stage ring in one model's library
    (``csrc/mega.cuh``): stages per slot ``W``, slots ``S`` and the dynamic
    shared memory per block in bytes."""
    out = (ctypes.c_int * 3)()
    cuda.check(fused_iter.library(ocp, nx, nu).ipoc_ring_layout(
        cuda.dtype_code(dtype), out), "ring_layout")
    return {"W": out[0], "S": out[1], "shared_bytes_per_block": out[2]}
