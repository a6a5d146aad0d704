"""Hand-written CUDA kernels: build, load and count.

The kernels' sources live in ``ipoc_tpu_torch/csrc``.  At the first call on a
CUDA tensor :func:`library` compiles them with ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``build/ipoc_tpu_torch/<hash>/`` at the root of
the checkout, the directory keyed by a hash of the sources and the flags,
and loads it with ``ctypes``.  Importing this package builds nothing and
needs no ``nvcc``, so the CPU tests import every module.

There is no fallback: a build that fails, or a launch that CUDA
refuses, raises.  Each wrapper counts its launches in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "seq_newton.cu",)
BUILD_ROOT = _PKG.parent / "build" / "ipoc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Launch count per kernel: each wrapper adds one where it launches, nowhere
# else.  Plain integers; reset with :func:`reset_launches`.
launches = {"seq_newton_trial": 0, "seq_costates": 0}

_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels' sources into the shared library (once per
    content hash) and return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libseq_newton.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # Write under a temporary name, then rename: a reader never sees half a
    # library, and concurrent builds each finish their own file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ipoc_seq_trial.argtypes = [i, i, i] + [p] * 12 + [i, i, p]
        lib.ipoc_seq_trial.restype = i
        lib.ipoc_seq_costates.argtypes = [i, i] + [p] * 4 + [i, i, p]
        lib.ipoc_seq_costates.restype = i
        _lib = lib
    return _lib


def disable_tf32() -> None:
    """Keep float32 products at full precision on the card.

    The JAX build measured that reduced-precision products break
    interior-point convergence, so the port's CUDA path never runs TF32:
    neither in matrix products nor in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype argument."""
    codes = {torch.float32: 0, torch.float64: 1}
    if dtype not in codes:
        raise NotImplementedError(f"no kernel instantiation for {dtype}")
    return codes[dtype]


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero status from a C entry point."""
    if status == -1:
        raise NotImplementedError(f"{kernel}: no instantiation for this shape")
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
