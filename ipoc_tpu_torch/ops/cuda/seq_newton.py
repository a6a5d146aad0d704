"""Batched sequential Newton trial and costate recursion: the kernels'
wrappers and their plain versions (counterpart of
``ipoc_tpu/ops/pallas/seq_newton_kernel.py``).

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches the hand-written CUDA kernel (``csrc/seq_newton.cu``) for tensors
on a card; anything else raises.  There is no fallback from the kernel to
the plain version.  The plain versions compute the same recursion with the
same elimination and pivot semantics, batched, with a Python loop over T;
on the card they are what the kernels are held against.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.ops import cuda

# (nx, nu) instantiations of the trial kernel: pendulum, cartpole, the
# nu > 1 layout pin and the planar quadrotor.  The costate kernel is
# instantiated for these nx.
TRIAL_SHAPES = ((2, 1), (4, 1), (3, 2), (6, 2))
COSTATE_NX = (2, 3, 4, 6)
# Threads per block of the kernels that run the cooperative Riccati step
# (csrc/riccati_rows.h): one warp.
WARP = 32


def row_lanes(nx: int) -> int:
    """G, the lanes per scenario of the cooperative Riccati step: the least
    power of two >= nx (2 at nx=2, 4 at nx=3 and 4, 8 at nx=6); the
    kernels' rule (``csrc/riccati_rows.h`` ``row_lanes``)."""
    g = 1
    while g < nx:
        g *= 2
    return g


def row_geometry(nx: int, B: int) -> dict:
    """The launch of ``seq_trial_kernel``, ``costate_kernel`` and
    ``fused_bwd_kernel`` (and of ``merged_trial_kernel``, whose groups are
    the backward sweep's) for B scenarios of state size nx: one warp per
    block, 32 / G scenarios a block."""
    lanes = row_lanes(nx)
    per_block = WARP // lanes
    return {"lanes_per_scenario": lanes, "scenarios_per_block": per_block,
            "blocks": -(-B // per_block), "threads_per_block": WARP}


def costate_occupancy(dtype: torch.dtype, nx: int) -> dict:
    """The card's view of one instantiation of the costate kernel (as
    :func:`trial_occupancy`)."""
    import ctypes

    out = (ctypes.c_int * 6)()
    cuda.check(cuda.library().ipoc_seq_costates_occupancy(
        cuda.dtype_code(dtype), nx, out), "seq_costates_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


def trial_occupancy(dtype: torch.dtype, nx: int, nu: int) -> dict:
    """The card's view of one instantiation of the trial kernel: resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    threads, shared bytes and scenarios per block, registers and local
    (spill) bytes per thread."""
    import ctypes

    out = (ctypes.c_int * 6)()
    cuda.check(cuda.library().ipoc_seq_trial_occupancy(
        cuda.dtype_code(dtype), nx, nu, out), "seq_trial_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _mirror_upper(A):
    """Keep the upper triangle and mirror it below (``_add_mm_sym``): the
    result is exactly symmetric."""
    return A.triu() + A.triu(1).transpose(-1, -2)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _solve_track(A, rhs):
    """Unpivoted elimination ``A X = rhs`` over leading batch axes; returns
    ``(X, minimum pivot)``.  Pivots scale by their reciprocal, as the
    kernel does."""
    n = A.shape[-1]
    a = A.clone()
    b = rhs.clone()
    minpiv = None
    for k in range(n):
        piv = a[..., k, k]
        minpiv = piv if minpiv is None else torch.minimum(minpiv, piv)
        inv_p = (1.0 / piv).unsqueeze(-1)
        a[..., k, k + 1:] = a[..., k, k + 1:] * inv_p
        b[..., k, :] = b[..., k, :] * inv_p
        for i in range(k + 1, n):
            f = a[..., i, k].unsqueeze(-1)
            a[..., i, k + 1:] = a[..., i, k + 1:] - f * a[..., k, k + 1:]
            b[..., i, :] = b[..., i, :] - f * b[..., k, :]
    for i in range(n - 2, -1, -1):
        for l in range(i + 1, n):
            b[..., i, :] = b[..., i, :] - a[..., i, l].unsqueeze(-1) * b[..., l, :]
    return b, minpiv


def _pivots_only(A):
    """Minimum leading pivot of an unpivoted elimination (PD test)."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    return _solve_track(A, A[..., :1])[1]


def seq_newton_trial_plain(ru, Q, R, M, fx, fu, XT):
    """Plain version of the trial kernel (same contract as
    :func:`seq_newton_trial_batched`)."""
    du, dx, dv, minpiv = seq_trial_pivot_plain(ru, Q, R, M, fx, fu, XT)
    ok = torch.isfinite(minpiv) & (minpiv > 0) & torch.isfinite(dv)
    return du, dx, dv, ok


def seq_trial_pivot_plain(ru, Q, R, M, fx, fu, XT):
    """The plain trial with its minimum tracked pivot in place of ``ok``:
    ``(du, dx, pred, minpiv)`` (the fused kernels report the pivot)."""
    T, nx, nu = fu.shape[-3:]
    Vxx = XT
    Vx = torch.zeros_like(XT[..., 0])
    dv = torch.zeros_like(XT[..., 0, 0])
    minpiv = torch.full_like(dv, float("inf"))
    gains = [None] * T
    for t in range(T - 1, -1, -1):
        fx_t, fu_t = fx[..., t, :, :], fu[..., t, :, :]
        fxT, fuT = fx_t.transpose(-1, -2), fu_t.transpose(-1, -2)
        Vfx = Vxx @ fx_t
        Vfu = Vxx @ fu_t
        Qxx = _mirror_upper(Q[..., t, :, :] + fxT @ Vfx)
        Quu = _mirror_upper(R[..., t, :, :] + fuT @ Vfu)
        Qxu = M[..., t, :, :] + fxT @ Vfu
        Qu = ru[..., t, :] + _mv(fuT, Vx)
        Qx = _mv(fxT, Vx)
        # Quu [k | K] = -[Qu | Qxu'] in one elimination, pivots tracked.
        rhs = torch.cat([Qu.unsqueeze(-1), Qxu.transpose(-1, -2)], dim=-1)
        sol, piv = _solve_track(Quu, rhs)
        piv = torch.minimum(piv, _pivots_only(R[..., t, :, :]))
        k, K = -sol[..., 0], -sol[..., 1:]
        gains[t] = (k, K)
        Vx = Qx + _mv(Qxu, k)
        Vxx = _mirror_upper(Qxx + Qxu @ K)
        dv = dv + (k * Qu).sum(-1) + 0.5 * (k * _mv(Quu, k)).sum(-1)
        minpiv = torch.minimum(minpiv, piv)

    dx = [torch.zeros_like(Vx)]
    du = []
    for t in range(T):
        k, K = gains[t]
        du.append(k + _mv(K, dx[-1]))
        dx.append(_mv(fx[..., t, :, :], dx[-1]) + _mv(fu[..., t, :, :], du[-1]))
    return torch.stack(du, dim=-2), torch.stack(dx, dim=-2), dv, minpiv


def seq_costates_plain(cx, fx, lam_T):
    """Plain version of the costate kernel: ``lam_T`` given,
    ``lam_t = cx_t + fx_t' lam_{t+1}``."""
    T = cx.shape[-2]
    lam = [None] * T + [lam_T]
    for t in range(T - 1, -1, -1):
        lam[t] = cx[..., t, :] + _mv(fx[..., t, :, :].transpose(-1, -2),
                                     lam[t + 1])
    return torch.stack(lam, dim=-2)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def seq_newton_trial_batched(ru, Q, R, M, fx, fu, XT):
    """One sequential Newton trial per scenario.

    Shapes: ru (B,T,nu), Q (B,T,nx,nx), R (B,T,nu,nu) (regularized),
    M (B,T,nx,nu), fx (B,T,nx,nx), fu (B,T,nx,nu), XT (B,nx,nx).
    Returns du (B,T,nu), dx (B,T+1,nx), pred (B,), ok (B,) bool.
    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    args = (ru, Q, R, M, fx, fu, XT)
    if cuda.on_cpu("seq_newton_trial", *args):
        return seq_newton_trial_plain(*args)
    B, T, nx, nu = fu.shape
    if (nx, nu) not in TRIAL_SHAPES:
        raise NotImplementedError(
            f"seq_newton_trial: no kernel for (nx, nu) = ({nx}, {nu}); "
            f"instantiated: {TRIAL_SHAPES}")
    code = cuda.check_inputs("seq_newton_trial", args, (
        (B, T, nu), (B, T, nx, nx), (B, T, nu, nu), (B, T, nx, nu),
        (B, T, nx, nx), (B, T, nx, nu), (B, nx, nx)))
    kw = dict(dtype=fu.dtype, device=fu.device)
    gains = torch.empty((B, T, (1 + nx) * nu), **kw)
    du = torch.empty((B, T, nu), **kw)
    dx = torch.empty((B, T + 1, nx), **kw)
    pred = torch.empty((B,), **kw)
    ok = torch.empty((B,), dtype=torch.bool, device=fu.device)
    if B == 0:
        return du, dx, pred, ok
    lib = cuda.library()
    with cuda.device_guard(fu.device):
        stream = torch.cuda.current_stream(fu.device).cuda_stream
        status = lib.ipoc_seq_trial(
            code, nx, nu, *(a.data_ptr() for a in args), gains.data_ptr(),
            du.data_ptr(), dx.data_ptr(), pred.data_ptr(), ok.data_ptr(),
            B, T, stream)
    cuda.check(status, "seq_newton_trial")
    cuda.launches["seq_newton_trial"] += 1
    return du, dx, pred, ok


def seq_costates_batched(cx, fx, lam_T):
    """Sequential costate recursion per scenario.

    Shapes: cx (B,T,nx), fx (B,T,nx,nx), lam_T (B,nx) -> lam (B,T+1,nx).
    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if cuda.on_cpu("seq_costates", cx, fx, lam_T):
        return seq_costates_plain(cx, fx, lam_T)
    B, T, nx = cx.shape
    if nx not in COSTATE_NX:
        raise NotImplementedError(
            f"seq_costates: no kernel for nx = {nx}; instantiated: "
            f"{COSTATE_NX}")
    code = cuda.check_inputs("seq_costates", (cx, fx, lam_T),
                       ((B, T, nx), (B, T, nx, nx), (B, nx)))
    lam = torch.empty((B, T + 1, nx), dtype=cx.dtype, device=cx.device)
    if B == 0:
        return lam
    lib = cuda.library()
    with cuda.device_guard(cx.device):
        stream = torch.cuda.current_stream(cx.device).cuda_stream
        status = lib.ipoc_seq_costates(
            code, nx, cx.data_ptr(), fx.data_ptr(), lam_T.data_ptr(),
            lam.data_ptr(), B, T, stream)
    cuda.check(status, "seq_costates")
    cuda.launches["seq_costates"] += 1
    return lam
