"""The one-launch parallel Newton trial: the kernel's wrapper and its plain
version (counterpart of ``ipoc_tpu/ops/pallas/newton_kernel.py``).

One trial of the parallel-in-time Newton step from the costate-contracted
stage data ``(ru, Q, R, M, fx, fu)`` (R already regularized) and the
terminal Hessian XT: the reference trick for ``s`` and ``r``, the value
elements and their suffix scan, the terminal fold, the gains, and the
closed-loop prefix scan from zero deviation, giving ``(du, dx, pred, ok)``
per lane.  On a card that is one launch of ``par_newton_trial_kernel``
(``csrc/par_newton.cu``, its phases and schedule in ``csrc/par_trial.h``),
with ``P`` lanes (threads) per scenario picked by :func:`trial_lanes`;
its plain version is the pipeline the JAX package runs off the TPU,
``newton_lqt`` -> ``par_bwd_pass`` -> ``par_fwd_pass``.
"""

from __future__ import annotations

import ctypes
import torch

from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.parallel.lqt import newton_lqt, par_bwd_pass, par_fwd_pass
from ipoc_tpu_torch.problem import Derivatives, LinearizedOCP

# (nx, nu) instantiations: pendulum, cartpole, the nu > 1 layout pin and
# the planar quadrotor (csrc/par_trial_62_*.cu).
TRIAL_SHAPES = ((2, 1), (4, 1), (3, 2), (6, 2))
# Lanes per scenario the kernel is instantiated for, and its launch rule's
# constant: an SM holds RESIDENT_WARPS of the cartpole-shaped (4, 1)
# kernel's warps in either dtype (its registers, 240-255 a thread, allow
# 8; phase 0 of chip_smoke.py checks it against trial_occupancy).  The
# block shape is the kernel's own (csrc/par_trial.h).
TRIAL_LANES = (32, 64, 128, 256)
RESIDENT_WARPS = 8


def trial_shared_bytes(nx: int, lanes: int, dtype: torch.dtype) -> int:
    """The trial kernel's shared memory per block at state size ``nx`` and
    ``lanes`` lanes per scenario (``csrc/par_trial.h`` ParTrial: a slot of
    ValueOp<nx>::E | 1 scalars for each lane and, past one warp, each
    warp; max(128 / lanes, 1) scenarios a block)."""
    slot = (3 * nx * nx + 2 * nx) | 1
    warps = lanes // 32
    per_scenario = (lanes + (warps if warps > 1 else 0)) * slot
    return max(128 // lanes, 1) * per_scenario * dtype.itemsize


def trial_lanes(B: int, T: int, sms: int = cuda.H100_SMS, nx: int = 4,
                dtype: torch.dtype = torch.float32) -> int:
    """P, the trial kernel's lanes per scenario for B scenarios of T
    stages of state size ``nx`` on a card of ``sms`` SMs.  P starts at 32
    and doubles while it is below 256 and below T (each lane keeps a
    stage), the doubled launch's warps, B * 2P / 32, still fit in one wave
    of ``sms`` x RESIDENT_WARPS, and its block's shared memory fits
    (``cuda.MAX_SMEM``: at nx=6 in float64, P=256 would take 255,552
    bytes).  So a large batch keeps 32 lanes, each a chunk of ceil(T / 32)
    stages (the least work: B=1024, T=100 gets 4 stages a lane), and a
    small one spreads its horizon for a short critical path (B=1, T=1000:
    256 lanes of 4 stages; 128 at nx=6 in float64)."""
    wave = sms * RESIDENT_WARPS * 32
    P = TRIAL_LANES[0]
    while (P < TRIAL_LANES[-1] and P < T and B * 2 * P <= wave
           and trial_shared_bytes(nx, 2 * P, dtype) <= cuda.MAX_SMEM):
        P *= 2
    return P


def trial_occupancy(dtype: torch.dtype, nx: int, nu: int, lanes: int) -> dict:
    """The card's view of one instantiation of the trial kernel: resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    threads, dynamic shared bytes and scenarios per block, registers and
    local (spill) bytes per thread."""
    out = (ctypes.c_int * 6)()
    cuda.check(cuda.library(cuda.PAR_NEWTON).ipoc_par_trial_occupancy(
        cuda.dtype_code(dtype), nx, nu, lanes, out), "par_trial_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


def newton_pipeline(ru, Q, R, M, fx, fu, XT, plain: bool = False):
    """``newton_lqt`` -> ``par_bwd_pass`` -> ``par_fwd_pass`` from zero
    deviation: ``(du, dx, pred, ok)``.  On CUDA tensors the two passes
    launch the value-scan and affine-scan kernels, unless ``plain``."""
    d = Derivatives(None, None, None, None, None, fx, fu, None, None, None)
    lqt = newton_lqt(LinearizedOCP(ru, Q, R, M), d, XT)
    Kx, kff, _, _, pred, feasible = par_bwd_pass(lqt, plain=plain)
    du, dx = par_fwd_pass(lqt, torch.zeros_like(XT[..., 0]), Kx, kff,
                          plain=plain)
    return du, dx, pred, feasible


def fused_newton_step_plain(ru, Q, R, M, fx, fu, XT):
    """Plain version of :func:`fused_newton_step`: the pipeline with the
    scans' plain versions, whatever the device."""
    return newton_pipeline(ru, Q, R, M, fx, fu, XT, plain=True)


def fused_newton_step(ru, Q, R, M, fx, fu, XT):
    """One parallel Newton trial per lane.

    Shapes: ru (B,T,nu), Q (B,T,nx,nx), R (B,T,nu,nu) (regularized),
    M (B,T,nx,nu), fx (B,T,nx,nx), fu (B,T,nx,nu), XT (B,nx,nx).  Returns
    du (B,T,nu), dx (B,T+1,nx), pred (B,), ok (B,) bool: the full step from
    zero deviation, its predicted cost change, and whether every stage's
    ``Quu`` and R are positive definite with a finite prediction.  CPU
    tensors take the plain version; CUDA tensors the kernel.
    """
    args = (ru, Q, R, M, fx, fu, XT)
    if cuda.on_cpu("par_newton_trial", *args):
        return fused_newton_step_plain(*args)
    B, T, nx, nu = fu.shape
    if (nx, nu) not in TRIAL_SHAPES:
        raise NotImplementedError(
            f"par_newton_trial: no kernel for (nx, nu) = ({nx}, {nu}); "
            f"instantiated: {TRIAL_SHAPES}")
    code = cuda.check_inputs("par_newton_trial", args, (
        (B, T, nu), (B, T, nx, nx), (B, T, nu, nu), (B, T, nx, nu),
        (B, T, nx, nx), (B, T, nx, nu), (B, nx, nx)))
    # The kernel reads stage rows in 16-byte vectors: a view that starts
    # off a 16-byte boundary goes through a copy.
    args = tuple(a if a.data_ptr() % 16 == 0 else a.clone() for a in args)
    kw = dict(dtype=fu.dtype, device=fu.device)
    gains = torch.empty((B, T, nu * (1 + nx)), **kw)
    du = torch.empty((B, T, nu), **kw)
    dx = torch.empty((B, T + 1, nx), **kw)
    pred = torch.empty((B,), **kw)
    ok = torch.empty((B,), dtype=torch.bool, device=fu.device)
    if B == 0 or T == 0:
        return du, dx.zero_(), pred.zero_(), ok.fill_(True)
    lib = cuda.library(cuda.PAR_NEWTON)
    sms = torch.cuda.get_device_properties(fu.device).multi_processor_count
    with torch.cuda.device(fu.device):
        status = lib.ipoc_par_newton_trial(
            code, nx, nu, trial_lanes(B, T, sms, nx, fu.dtype),
            *(a.data_ptr() for a in args), gains.data_ptr(),
            du.data_ptr(), dx.data_ptr(), pred.data_ptr(), ok.data_ptr(),
            B, T, torch.cuda.current_stream().cuda_stream)
    cuda.check(status, "par_newton_trial")
    cuda.launches["par_newton_trial"] += 1
    return du, dx, pred, ok
