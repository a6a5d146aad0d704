"""Associative scans over small-matrix elements: the kernels' wrappers and
their plain versions (counterpart of ``ipoc_tpu/ops/pallas/scan_kernels.py``).

Two element algebras, those of ``parallel/costates.py`` and
``parallel/lqt.py``: affine maps ``(F, c)`` (the costate recursion and the
LQT forward pass) and conditional-value 5-tuples ``(A, b, C, eta, J)`` (the
LQT backward pass).  Each wrapper takes the plain version for tensors on the
CPU and launches the hand-written CUDA kernel (``csrc/par_newton.cu``) for
tensors on a card; anything else raises.  There is no gate on dtype or n:
a card without an instantiation for the shape raises.

The plain versions are :func:`ipoc_tpu_torch.parallel.scan.associative_scan`
over the two combines, the same recursion and argument order as the JAX
package's ``lax.associative_scan`` paths.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.parallel.scan import associative_scan

# State dimensions the scan kernels are instantiated for (pendulum,
# cartpole and the nx=3 layout pin).
SCAN_N = (2, 3, 4)


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
    Fo, co = torch.empty_like(F), torch.empty_like(c)
    if B == 0 or T == 0:
        return Fo, co
    lib = cuda.library(cuda.PAR_NEWTON)
    with torch.cuda.device(F.device):
        status = lib.ipoc_affine_scan(
            code, n, int(bool(reverse)), F.data_ptr(), c.data_ptr(),
            Fo.data_ptr(), co.data_ptr(), B, T,
            torch.cuda.current_stream().cuda_stream)
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
    with torch.cuda.device(A.device):
        status = lib.ipoc_value_scan(
            code, n, *(a.data_ptr() for a in args),
            *(o.data_ptr() for o in outs), B, T,
            torch.cuda.current_stream().cuda_stream)
    cuda.check(status, "value_scan")
    cuda.launches["value_scan"] += 1
    return outs
