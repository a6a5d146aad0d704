"""Hand-written CUDA kernels: build, load and count.

The kernels' sources live in ``ipoc_tpu_torch/csrc``.  A library is built
from static ``csrc`` files plus, for the fused kernels, text generated from
a model (``ops/fused_iter.py``): :func:`build_all` compiles each source
of each library with one ``nvcc`` call for ``sm_90a`` (float32 and float64
instantiated in it), all started together, and links each library's
objects into ``build/ipoc_tpu_torch/<hash>/`` at the root of the checkout, the
directory keyed by a hash of every ``csrc`` file, the generated text and
the flags.  The generated ``.cu`` is written into that directory next to
the ``.so``, so it can be inspected, and so is ``ptxas``'s report of each
kernel's registers and spills (``lib<name>.ptxas.txt``).  Libraries are plain-C shared objects
loaded with ``ctypes``.  Importing this package builds nothing and needs no ``nvcc``, so the
CPU tests import every module.

There is no fallback: a build that fails, or a launch that CUDA refuses,
raises.  Each wrapper counts its launches in :data:`launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "ipoc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# One source into one object: the flags without -shared, plus -c.
_COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

# Launch count per kernel: each wrapper adds one where it launches, nowhere
# else.  Plain integers; reset with :func:`reset_launches`.
launches = {"seq_newton_trial": 0, "seq_costates": 0, "fused_bwd": 0,
            "fused_fwd": 0, "rollout": 0, "rollout_cost": 0, "transition": 0,
            "merged_trial": 0, "mega": 0, "affine_scan": 0, "value_scan": 0,
            "par_newton_trial": 0}

_libs = {}


class LibSpec(NamedTuple):
    """What one shared library is compiled from."""

    name: str                               # lib<name>.so
    sources: tuple = ()                     # static .cu files under csrc
    generated: tuple = ()                   # ((file name, text), ...)


SEQ_NEWTON = LibSpec("seq_newton", (CSRC / "seq_newton.cu",))
# The scans and the C entries; the trial's instantiations, one object per
# dtype and per shape list, and the scans' at n=6, one per scan and dtype
# (the library's longest compiles, built side by side).
PAR_NEWTON = LibSpec("par_newton", (
    CSRC / "par_newton.cu", CSRC / "par_trial_f32.cu",
    CSRC / "par_trial_f64.cu", CSRC / "par_trial_62_f32.cu",
    CSRC / "par_trial_62_f64.cu", CSRC / "scan_n6_affine_f32.cu",
    CSRC / "scan_n6_affine_f64.cu", CSRC / "scan_n6_value_f32.cu",
    CSRC / "scan_n6_value_f64.cu"))
# The shared memory one block may take on an H100 (csrc/launch_attr.cuh
# kMaxSmem): the launch rules keep every launch under it.
MAX_SMEM = 232448


# The SMs of an H100 (SXM): the launch rules' default card.
H100_SMS = 132
_sms = {}


def sm_count(device: torch.device) -> int:
    """The SMs of card ``device`` (read once per card)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


# What the occupancy entries (``ipoc_*_occupancy``) write, in order.
OCCUPANCY_KEYS = ("blocks_per_sm", "threads_per_block", "shared_bytes_per_block",
                  "scenarios_per_block", "registers", "local_bytes")


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


def lib_path(spec: LibSpec) -> Path:
    """Where ``spec``'s library is (or will be) built: keyed by a hash of the
    flags, every file of ``csrc`` (sources and headers) and the generated
    text."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    for src in spec.sources:
        h.update(b"src\0" + src.name.encode())
    for name, text in spec.generated:
        h.update(name.encode() + b"\0" + text.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{spec.name}.so"


# (source file, seconds from the start of its build to the end of its
# compile) for each source this process compiled (chip_smoke.py phase 0
# reports them).
compile_seconds: list = []


def _run(cmds):
    """Run ``cmds`` all at once; return each one's (returncode, stderr,
    seconds from the start to its end)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]

    def wait(proc):
        _, err = proc.communicate()
        return proc.returncode, err, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        return list(pool.map(wait, procs))


def build_all(specs) -> list:
    """Compile every library of ``specs`` not built yet: one ``nvcc`` per
    source file, all started together, then one link per library; return
    their paths.  Raises if any build fails."""
    paths = [lib_path(s) for s in specs]
    builds, compiles = [], []
    for spec, path in zip(specs, paths):
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        sources = list(spec.sources)
        for name, text in spec.generated:
            (path.parent / name).write_text(text)
            sources.append(path.parent / name)
        # Objects and the library in a temporary directory, then a rename:
        # a reader never sees half a library, and concurrent builds each
        # finish their own files.
        tmp = tempfile.mkdtemp(dir=path.parent)
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        first = len(compiles)
        compiles += [[_nvcc(), *_COMPILE_FLAGS, "-I", str(CSRC), "-o", obj,
                      str(src)] for src, obj in zip(sources, objs)]
        builds.append((path, tmp, objs, range(first, len(compiles))))
    results = _run(compiles)
    for cmd, (_, _, seconds) in zip(compiles, results):
        compile_seconds.append((os.path.basename(cmd[-1]), seconds))
    errors, links = [], []
    for path, tmp, objs, idx in builds:
        failed = [i for i in idx if results[i][0] != 0]
        errors += [f"nvcc failed ({results[i][0]}):\n{' '.join(compiles[i])}"
                   f"\n{results[i][1]}" for i in failed]
        if not failed:
            path.with_suffix(".ptxas.txt").write_text(
                "".join(results[i][1] for i in idx))
            links.append((path, tmp, [_nvcc(), "-shared", "-o",
                                      os.path.join(tmp, "lib.so"), *objs]))
    for (path, tmp, cmd), (rc, err, _) in zip(links,
                                              _run([c for _, _, c in links])):
        if rc != 0:
            errors.append(f"nvcc link failed ({rc}):\n{' '.join(cmd)}\n{err}")
        else:
            os.replace(os.path.join(tmp, "lib.so"), path)
    for _, tmp, _, _ in builds:
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return paths


def build(spec: LibSpec = SEQ_NEWTON) -> Path:
    """Compile one library (once per content hash) and return its path."""
    return build_all([spec])[0]


def _bind(lib, signatures: dict) -> None:
    """Set the ctypes argument and (int) return types of C entry points."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "seq_newton": {"ipoc_seq_trial": [_I] * 3 + [_P] * 12 + [_I, _I, _P],
                   "ipoc_seq_costates": [_I] * 2 + [_P] * 4 + [_I, _I, _P],
                   "ipoc_seq_trial_occupancy": [_I] * 3 + [_P],
                   "ipoc_seq_costates_occupancy": [_I] * 2 + [_P]},
    "par_newton": {
        "ipoc_affine_scan": [_I] * 4 + [_P] * 4 + [_I, _I, _P],
        "ipoc_affine_scan_occupancy": [_I] * 3 + [_P],
        "ipoc_value_scan": [_I] * 3 + [_P] * 10 + [_I, _I, _P],
        "ipoc_value_scan_occupancy": [_I] * 3 + [_P],
        "ipoc_par_newton_trial": [_I] * 4 + [_P] * 12 + [_I, _I, _P],
        "ipoc_par_trial_occupancy": [_I] * 4 + [_P]},
}


def library(spec: LibSpec = SEQ_NEWTON) -> ctypes.CDLL:
    """A loaded static kernel library (``SEQ_NEWTON`` or ``PAR_NEWTON``),
    built at first use."""
    if spec.name not in _libs:
        lib = ctypes.CDLL(str(build(spec)))
        _bind(lib, _SIGNATURES[spec.name])
        _libs[spec.name] = lib
    return _libs[spec.name]


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


def device_guard(device: torch.device):
    """A context that makes the card ``device`` current for a launch: a
    no-op where it is current already (entering a device guard costs a
    few microseconds of host time a launch)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def on_cpu(name: str, *tensors) -> bool:
    """True for tensors all on the CPU (plain version), False for tensors
    all on one card (kernel); raises for a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "the CPU (plain version) or all on one card (kernel)")


def check_inputs(name: str, tensors, shapes) -> int:
    """Check a kernel's inputs (one device and dtype, the expected shapes,
    contiguous) and return the dtype code."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share one device and dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dtype_code(dtype)
