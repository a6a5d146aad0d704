"""Associative scans over small-matrix elements: the kernels' wrappers and
their plain versions (counterpart of ``ipoc_tpu/ops/pallas/scan_kernels.py``).

Two element algebras, those of ``parallel/costates.py`` and
``parallel/lqt.py``: affine maps ``(F, c)`` (the costate recursion and the
LQT forward pass) and conditional-value 5-tuples ``(A, b, C, eta, J)`` (the
LQT backward pass).  Each wrapper takes the plain version for tensors on the
CPU and launches the hand-written CUDA kernel (``csrc/par_newton.cu``) for
tensors on a card; anything else raises.  There is no gate on dtype or n:
a card without an instantiation for the shape raises.  Both scans spread a
scenario over ``P`` lanes (``csrc/affine_scan.h``, one schedule for both
algebras) picked by :func:`scan_lanes` from each kernel's resident warps.

The plain versions are :func:`ipoc_tpu_torch.parallel.scan.associative_scan`
over the two combines, the same recursion and argument order as the JAX
package's ``lax.associative_scan`` paths.
"""

from __future__ import annotations

import ctypes

import torch

from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.parallel.scan import associative_scan

# State dimensions the scan kernels are instantiated for (pendulum,
# cartpole, the nx=3 layout pin and the planar quadrotor).
SCAN_N = (2, 3, 4, 6)
# Lanes per scenario the affine scan is instantiated for, and its launch
# rule's constants: the warps an SM holds of the n=4 kernel in each dtype
# at each lane count (its tile in shared memory, 40-83 KB a block in
# float32 and 90-182 KB in float64, sets them; phase 0 of chip_smoke.py
# checks them against scan_occupancy).
SCAN_LANES = (32, 64, 128, 256)
SCAN_RESIDENT_WARPS = {torch.float32: {32: 20, 64: 16, 128: 20, 256: 16},
                       torch.float64: {32: 8, 64: 8, 128: 8, 256: 8}}
# The same for the value scan at n=4: its 222 (float32) and 255 (float64)
# registers a thread set them, 8 warps an SM at every lane count.
VALUE_RESIDENT_WARPS = {dtype: dict.fromkeys(SCAN_LANES, 8)
                        for dtype in (torch.float32, torch.float64)}


def _odd_stride(n: int, a: int) -> int:
    """``csrc/riccati_rows.h`` odd_stride: the least odd multiple of ``a``
    that is >= n."""
    m = -(-n // a)
    return (m if m % 2 else m + 1) * a


def scan_shared_bytes(n: int, lanes: int, dtype: torch.dtype,
                      value: bool = False) -> int:
    """A scan kernel's shared memory per block at ``n`` and ``lanes``
    lanes per scenario (``csrc/affine_scan.h`` LaneScan: a tile of LT
    stages of each lane at a slot stride ES, and past one warp the warps'
    totals; max(128 / lanes, 1) scenarios a block)."""
    size = dtype.itemsize
    E = 3 * n * n + 2 * n if value else n * n + n
    if value:  # read in place: an odd stride, as many stages as 16 KB holds
        es = E | 1
        lt = min(max(16384 // (32 * es * size), 1), 4)
    else:
        es, lt = _odd_stride(E, 16 // size), 4
    warps = lanes // 32
    per_scenario = lt * lanes * es + (warps * E if warps > 1 else 0)
    return max(128 // lanes, 1) * per_scenario * size


def scan_lanes(B: int, T: int, dtype: torch.dtype,
               sms: int = cuda.H100_SMS, value: bool = False,
               n: int = 4) -> int:
    """P, a scan's lanes per scenario for B scenarios of T stages on a card
    of ``sms`` SMs: the trial's rule (``ops/newton_kernel.py``
    trial_lanes) with the scan's resident warps (``value``: the value
    scan's, VALUE_RESIDENT_WARPS; else SCAN_RESIDENT_WARPS).  P starts at
    32 and doubles while it is below 256 and below T (each lane keeps a
    stage) and the doubled launch's warps, B * 2P / 32, still fit in one
    wave of ``sms`` x the resident warps at 2P.  So a float32 batch of
    1024 takes 64 lanes of the affine scan (B=1024, T=101: 2 stages a
    lane; float64 32 lanes of 4) and 32 of the value scan, and a single
    scenario spreads its horizon (T=1001: 256 lanes of 4 stages).  P
    doubles only while the doubled block's shared memory fits
    (``cuda.MAX_SMEM``): at n=6 in float64 both scans stop at 128 lanes.
    The resident warps are n=4's at every n."""
    warps = (VALUE_RESIDENT_WARPS if value else SCAN_RESIDENT_WARPS)[dtype]
    P = SCAN_LANES[0]
    while (P < SCAN_LANES[-1] and P < T
           and B * 2 * P <= sms * warps[2 * P] * 32
           and scan_shared_bytes(n, 2 * P, dtype, value) <= cuda.MAX_SMEM):
        P *= 2
    return P


def scan_occupancy(dtype: torch.dtype, n: int, lanes: int,
                   value: bool = False) -> dict:
    """The card's view of the affine scan's suffix kernel (``value``: the
    value scan's) at ``n`` and ``lanes``: resident blocks per SM, threads,
    shared bytes and scenarios per block, registers and local (spill)
    bytes per thread."""
    out = (ctypes.c_int * 6)()
    name = "value_scan" if value else "affine_scan"
    cuda.check(getattr(cuda.library(cuda.PAR_NEWTON), f"ipoc_{name}_occupancy")(
        cuda.dtype_code(dtype), n, lanes, out), f"{name}_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


def affine_scan_plain(F, c, reverse: bool = False):
    """Plain version of :func:`affine_scan`."""
    # The combines' modules call these scans: imported here, not at the top.
    from ipoc_tpu_torch.parallel.costates import affine_combine

    # In a reverse scan fn receives (later combination, earlier element);
    # in a forward one (earlier combination, later element): the swap gives
    # earlier-after-later (suffix) and later-after-earlier (prefix).
    return associative_scan(lambda a, b: affine_combine(b, a), (F, c),
                            reverse=reverse, dim=1)


def value_scan_plain(A, b, C, eta, J):
    """Plain version of :func:`value_scan`."""
    from ipoc_tpu_torch.parallel.lqt import value_combine

    return associative_scan(lambda x, y: value_combine(y, x),
                            (A, b, C, eta, J), reverse=True, dim=1)


def affine_scan(F, c, reverse: bool = False):
    """Inclusive scan of affine elements ``v -> F_t v + c_t`` per lane.

    ``F (B, T, n, n)``, ``c (B, T, n)`` -> scans of the same shapes:
    ``reverse=True`` gives the suffix compositions earlier-after-later
    (``out[t] = e_t o e_{t+1} o ... o e_{T-1}``, the costate recursion),
    ``reverse=False`` the prefix compositions later-after-earlier
    (``out[t] = e_t o ... o e_0``, the closed-loop rollout).  CPU tensors
    take the plain version; CUDA tensors the kernel.
    """
    if cuda.on_cpu("affine_scan", F, c):
        return affine_scan_plain(F, c, reverse)
    B, T, n, _ = F.shape
    if n not in SCAN_N:
        raise NotImplementedError(
            f"affine_scan: no kernel for n = {n}; instantiated: {SCAN_N}")
    code = cuda.check_inputs("affine_scan", (F, c), ((B, T, n, n), (B, T, n)))
    # The kernel reads and writes rows in 16-byte vectors: a view that
    # starts off a 16-byte boundary goes through a copy.
    F, c = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (F, c))
    Fo, co = torch.empty_like(F), torch.empty_like(c)
    if B == 0 or T == 0:
        return Fo, co
    lib = cuda.library(cuda.PAR_NEWTON)
    dev = F.device
    with cuda.device_guard(dev):
        status = lib.ipoc_affine_scan(
            code, n, int(bool(reverse)),
            scan_lanes(B, T, F.dtype, cuda.sm_count(dev), n=n), F.data_ptr(),
            c.data_ptr(), Fo.data_ptr(), co.data_ptr(), B, T,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda.check(status, "affine_scan")
    cuda.launches["affine_scan"] += 1
    return Fo, co


def value_scan(A, b, C, eta, J):
    """Suffix scan of conditional-value elements per lane (the reverse
    associative scan of ``parallel/lqt.py``'s ``value_combine``, earlier
    before later).  ``A, C, J (B, T, n, n)``, ``b, eta (B, T, n)`` -> scans
    of the same shapes.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    args = (A, b, C, eta, J)
    if cuda.on_cpu("value_scan", *args):
        return value_scan_plain(*args)
    B, T, n, _ = A.shape
    if n not in SCAN_N:
        raise NotImplementedError(
            f"value_scan: no kernel for n = {n}; instantiated: {SCAN_N}")
    mat, vec = (B, T, n, n), (B, T, n)
    code = cuda.check_inputs("value_scan", args, (mat, vec, mat, vec, mat))
    outs = tuple(torch.empty_like(a) for a in args)
    if B == 0 or T == 0:
        return outs
    lib = cuda.library(cuda.PAR_NEWTON)
    dev = A.device
    with cuda.device_guard(dev):
        status = lib.ipoc_value_scan(
            code, n, scan_lanes(B, T, A.dtype, cuda.sm_count(dev), value=True,
                                n=n),
            *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs), B,
            T, torch.cuda.current_stream(dev).cuda_stream)
    cuda.check(status, "value_scan")
    cuda.launches["value_scan"] += 1
    return outs
