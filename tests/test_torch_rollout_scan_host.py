"""The open-loop rollout's lane loop (``csrc/rollout.h``) and the affine
scan's lane schedule (``csrc/affine_scan.h``), built with the host C++
compiler and held to their plain versions on the CPU.

The headers hold the CUDA kernels' per-lane code and the schedule that
orders it.  The rollout's host executor runs each scenario's lane in turn;
the scan's steps every lane of a scenario through each step, a shuffle
reading the lanes' values as they stood before it, with the shared memory
filled with NaN first.  Here they are compiled with ``g++`` and held

* the rollout in float64 at 1e-12 of scale to ``rollout_plain``, cartpole,
  pendulum, the planar quadrotor (nx=6, nu=2) and the unicycle (nx=3, nu=2) at dt = 1/40, B in {1, 3, 37} and T in {1, 7, 40}; to the
  one-thread loop it replaces (the parent kernel's, built by the same
  compiler) bit for bit in float64 and float32, at the kernel's chunk
  length and at those measured against it; on inputs that start one scalar
  past a 16-byte boundary, to the bit of the aligned ones;
* the scan in float64 to ``affine_scan_plain`` at 1e-12 of scale (the
  association follows P, so not to the bit), both directions, n in
  {2, 3, 4, 6}, every lane count P in {32, 64, 128, 256} whose block fits
  the card's shared memory, T in {1, 7, 33, 129, 1000} (1000 and 129 are
  no multiple of P times the chunk length); ``scan_shared_bytes`` equal to
  the header's count at every n, dtype and P, and the cap it puts on P;
* the launch rules: the rollout's scenarios per block, chunk length and
  blocks, and ``scan_lanes`` with the scan's block shape, at B in {1, 3,
  1024, 4096};
* in float32 against JAX's kernels in interpret mode on the same
  numpy-seeded inputs: ``rollout_batched`` (``tests/test_torch_fused_iter.py``'s
  atol 1e-6) and ``pallas_affine_scan`` (``tests/test_torch_scan.py``'s
  atol 2e-5 on F, 2e-4 on c).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.models import quadrotor as j_quadrotor
from ipoc_tpu.models import unicycle as j_unicycle
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.ops.pallas.scan_kernels import pallas_affine_scan
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops import scan_kernels as sk

torch.set_num_threads(1)

TOL = 1e-12
DT = 1.0 / 40
# model: (port module, JAX module, nx, nu, the controls' centre inside the
# box)
MODELS = {"cartpole": (t_cartpole, j_cartpole, 4, 1, 0.0),
          "pendulum": (t_pendulum, j_pendulum, 2, 1, 0.0),
          "quadrotor": (t_quadrotor, j_quadrotor, 6, 2, t_quadrotor.HOVER),
          "unicycle": (t_unicycle, j_unicycle, 3, 2, 0.3)}
# Stages per chunk: the kernel's (8 in float32, 1 in float64) first, then
# those timed against it.
ROLLOUT_CHUNKS = ("kernel's", 2, 4, 16)

ROLLOUT_SOURCE = r"""
#include <math.h>
#include <vector>
#include "rollout.h"

template <typename scalar_t, int W>
int run(const void* const* in, void* const* out, int B, int T) {
  ipoc::rollout_host<Model, scalar_t, W>(
      static_cast<const scalar_t*>(in[0]), static_cast<const scalar_t*>(in[1]),
      static_cast<scalar_t*>(out[0]), static_cast<scalar_t*>(out[1]), B, T);
  return 0;
}

// The one-thread loop of the kernel it replaces, lane by lane.
template <typename scalar_t>
int parent(const void* const* in, void* const* out, int B, int T) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const scalar_t* us = static_cast<const scalar_t*>(in[0]);
  const scalar_t* x0 = static_cast<const scalar_t*>(in[1]);
  scalar_t* xs = static_cast<scalar_t*>(out[0]);
  scalar_t* xT = static_cast<scalar_t*>(out[1]);
  for (int b = 0; b < B; ++b) {
    scalar_t x[NX];
    ipoc::load_col<scalar_t, NX>(x, x0, B, b);
    for (int t = 0; t < T; ++t) {
      scalar_t u[NU], xn[NX];
      ipoc::load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
      ipoc::store_col<scalar_t, NX>(xs + (size_t)t * NX * B, x, B, b);
      Model::template dynamics<scalar_t>(x, u, xn);
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    ipoc::store_col<scalar_t, NX>(xT, x, B, b);
  }
  return 0;
}

template <typename scalar_t>
int pick(int shape, const void* const* in, void* const* out, int B, int T) {
  if (shape == 0) return run<scalar_t, ipoc::rollout_chunk<scalar_t>()>(in, out, B, T);
  if (shape == 1) return run<scalar_t, 2>(in, out, B, T);
  if (shape == 2) return run<scalar_t, 4>(in, out, B, T);
  if (shape == 3) return run<scalar_t, 16>(in, out, B, T);
  if (shape == -1) return parent<scalar_t>(in, out, B, T);
  return -1;
}

extern "C" int host_rollout(int dtype, int shape, const void* const* in,
                            void* const* out, int B, int T) {
  if (dtype == 0) return pick<float>(shape, in, out, B, T);
  if (dtype == 1) return pick<double>(shape, in, out, B, T);
  return -1;
}

template <typename scalar_t>
void geometry_t(int B, int* out) {
  using R = ipoc::Rollout<Model, scalar_t>;
  out[0] = R::S;
  out[1] = ipoc::rollout_chunk<scalar_t>();
  out[2] = R::blocks(B);
}

extern "C" int host_rollout_geometry(int dtype, int B, int* out) {
  if (dtype == 0) return geometry_t<float>(B, out), 0;
  if (dtype == 1) return geometry_t<double>(B, out), 0;
  return -1;
}
"""

SCAN_SOURCE = r"""
#include <math.h>
#include <type_traits>
#include <vector>
#include "affine_scan.h"

template <typename scalar_t, int N, int P, bool R>
int run(const void* F, const void* c, void* Fo, void* co, int B, int T) {
  using Sc = ipoc::AffineScan<scalar_t, N, P, R>;
  std::vector<typename Sc::Lane> lanes(P);
  std::vector<scalar_t> sh(Sc::kShared, scalar_t(NAN));
  ipoc::affine_scan_host<scalar_t, N, P, R>(
      static_cast<const scalar_t*>(F), static_cast<const scalar_t*>(c),
      static_cast<scalar_t*>(Fo), static_cast<scalar_t*>(co), B, T, lanes.data(),
      sh.data());
  return 0;
}

template <typename scalar_t, int N, bool R>
int lanes(int P, const void* F, const void* c, void* Fo, void* co, int B, int T) {
  if (P == 32) return run<scalar_t, N, 32, R>(F, c, Fo, co, B, T);
  if (P == 64) return run<scalar_t, N, 64, R>(F, c, Fo, co, B, T);
  if (P == 128) return run<scalar_t, N, 128, R>(F, c, Fo, co, B, T);
  if (P == 256) return run<scalar_t, N, 256, R>(F, c, Fo, co, B, T);
  return -1;
}

template <typename scalar_t, int N>
int dir(int reverse, int P, const void* F, const void* c, void* Fo, void* co, int B, int T) {
  return reverse ? lanes<scalar_t, N, true>(P, F, c, Fo, co, B, T)
                 : lanes<scalar_t, N, false>(P, F, c, Fo, co, B, T);
}

template <typename scalar_t>
int shape(int n, int reverse, int P, const void* F, const void* c, void* Fo, void* co,
          int B, int T) {
  if (n == 2) return dir<scalar_t, 2>(reverse, P, F, c, Fo, co, B, T);
  if (n == 3) return dir<scalar_t, 3>(reverse, P, F, c, Fo, co, B, T);
  if (n == 4) return dir<scalar_t, 4>(reverse, P, F, c, Fo, co, B, T);
  if (n == 6) return dir<scalar_t, 6>(reverse, P, F, c, Fo, co, B, T);
  return -1;
}

extern "C" int host_affine_scan(int dtype, int n, int reverse, int P, const void* F,
                                const void* c, void* Fo, void* co, int B, int T) {
  if (dtype == 0) return shape<float>(n, reverse, P, F, c, Fo, co, B, T);
  if (dtype == 1) return shape<double>(n, reverse, P, F, c, Fo, co, B, T);
  return -1;
}

// A lane's stages in a tile, scenarios and threads per block, and shared
// bytes per block at n = 4.
template <typename scalar_t, int P>
void geometry_t(int* out) {
  using Sc = ipoc::AffineScan<scalar_t, 4, P, true>;
  out[0] = Sc::LT;
  out[1] = Sc::kScenarios;
  out[2] = Sc::kBlock;
  out[3] = Sc::kScenarios * Sc::kShared * static_cast<int>(sizeof(scalar_t));
}

// Shared bytes per block of the affine scan at (n, P) (par_newton.cu
// ScanLaunch::smem).
template <typename scalar_t, int N>
int scan_bytes(int P) {
  auto b = [](auto pp) {
    using Sc = ipoc::AffineScan<scalar_t, N, decltype(pp)::value, true>;
    return Sc::kScenarios * Sc::kShared * static_cast<int>(sizeof(scalar_t));
  };
  if (P == 32) return b(std::integral_constant<int, 32>());
  if (P == 64) return b(std::integral_constant<int, 64>());
  if (P == 128) return b(std::integral_constant<int, 128>());
  if (P == 256) return b(std::integral_constant<int, 256>());
  return -1;
}

template <typename scalar_t>
int scan_bytes_n(int n, int P) {
  if (n == 2) return scan_bytes<scalar_t, 2>(P);
  if (n == 3) return scan_bytes<scalar_t, 3>(P);
  if (n == 4) return scan_bytes<scalar_t, 4>(P);
  if (n == 6) return scan_bytes<scalar_t, 6>(P);
  return -1;
}

extern "C" int host_scan_bytes(int dtype, int n, int P) {
  return dtype == 0 ? scan_bytes_n<float>(n, P) : scan_bytes_n<double>(n, P);
}

extern "C" int host_scan_geometry(int dtype, int P, int* out) {
  auto go = [&](auto zero) {
    using scalar_t = decltype(zero);
    if (P == 32) return geometry_t<scalar_t, 32>(out), 0;
    if (P == 64) return geometry_t<scalar_t, 64>(out), 0;
    if (P == 128) return geometry_t<scalar_t, 128>(out), 0;
    if (P == 256) return geometry_t<scalar_t, 256>(out), 0;
    return -1;
  };
  if (dtype == 0) return go(0.0f);
  if (dtype == 1) return go(0.0);
  return -1;
}
"""

_LIBS = {}


def _compile(tmp_path_factory, key, text):
    """``text`` compiled with the host C++ compiler into a loaded library,
    once per module."""
    if key not in _LIBS:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            pytest.skip("no host C++ compiler")
        out = tmp_path_factory.mktemp(key)
        src, so = out / f"{key}.cpp", out / f"{key}.so"
        src.write_text(text)
        res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                              "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        _LIBS[key] = ctypes.CDLL(str(so))
    return _LIBS[key]


@pytest.fixture(scope="module", params=list(MODELS))
def roll(request, tmp_path_factory):
    """``(model, ocp, nx, lib)``: one model's generated struct (dt = 1/40)
    and rollout.h compiled with the host C++ compiler."""
    model, _, nx, nu, _ = MODELS[request.param]
    ocp = model.make_ocp(DT)
    lib = _compile(tmp_path_factory, f"rollout_{request.param}",
                   '#include "scalar_math.h"\n' + tf.model_struct(ocp, nx, nu)
                   + ROLLOUT_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_rollout.argtypes = [i, i, p, p, i, i]
    lib.host_rollout.restype = i
    lib.host_rollout_geometry.argtypes = [i, i, p]
    lib.host_rollout_geometry.restype = i
    return model, ocp, nx, lib


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """affine_scan.h compiled with the host C++ compiler: every dtype, n,
    direction and lane count."""
    lib = _compile(tmp_path_factory, "affine_scan", SCAN_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_affine_scan.argtypes = [i] * 4 + [p] * 4 + [i, i]
    lib.host_affine_scan.restype = i
    lib.host_scan_geometry.argtypes = [i, i, p]
    lib.host_scan_geometry.restype = i
    lib.host_scan_bytes.argtypes = [i, i, i]
    lib.host_scan_bytes.restype = i
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _rollout(lib, u, x0, shape=0):
    """The host build's rollout (``shape`` -1: the one-thread loop) on CPU
    tensors; outputs NaN-filled first."""
    T, _, B = u.shape
    nx = x0.shape[0]
    outs = [torch.full(s, float("nan"), dtype=u.dtype) for s in ((T, nx, B), (nx, B))]
    assert lib.host_rollout(cuda.dtype_code(u.dtype), shape, _ptrs((u, x0)),
                            _ptrs(outs), B, T) == 0
    return outs


def _lanes(model, nx, B, T, seed, dtype=torch.float64):
    """Packed controls and initial states from numpy: ``u (T, nu, B)``,
    ``x0 (nx, B)``."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    _, _, _, nu, centre = next(m for m in MODELS.values() if m[0] is model)
    u = torch.tensor(centre + 0.1 * rng.normal(size=(T, nu, B)), dtype=dtype)
    x0b = torch.tensor(x0[:, None] + 0.01 * rng.normal(size=(nx, B)), dtype=dtype)
    return u, x0b


def _offset(a):
    """``a`` as a contiguous view one scalar past its storage's start."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    return v


def _assert_close(got, ref, label):
    for k, (g, r) in enumerate(zip(got, ref)):
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= TOL * scale, (label, k)


@pytest.mark.parametrize("T", [1, 7, 40])
def test_host_rollout_matches_plain(roll, T):
    """Float64 at 1e-12 of scale, B in {1, 3, 37}: xs and xT against
    ``rollout_plain``; bit for bit the one-thread loop in both dtypes, at
    every chunk length; at B = 37 offset views to the bit of the aligned
    inputs."""
    model, ocp, nx, lib = roll
    for B in (1, 3, 37):
        u, x0 = _lanes(model, nx, B, T, seed=T + B)
        got = _rollout(lib, u, x0)
        _assert_close(got, tf.rollout_plain(ocp, u, x0), f"T={T} B={B}")
        for dtype in (torch.float64, torch.float32):
            ud, xd = u.to(dtype), x0.to(dtype)
            ref = _rollout(lib, ud, xd, shape=-1)
            for shape in range(len(ROLLOUT_CHUNKS)):
                for g, r in zip(_rollout(lib, ud, xd, shape), ref):
                    assert torch.equal(g, r), (T, B, dtype, ROLLOUT_CHUNKS[shape])
        if B == 37:
            for g, v in zip(got, _rollout(lib, _offset(u), _offset(x0))):
                assert torch.equal(g, v)


@pytest.mark.parametrize("B", [1, 3, 1024, 4096])
def test_rollout_launch_rule(roll, B):
    """One lane per scenario, 32 scenarios to a one-warp block, ceil(B / 32)
    blocks, chunks of 8 stages in float32 and 1 in float64, no shared
    memory."""
    lib = roll[3]
    for code, W in ((0, 8), (1, 1)):
        out = (ctypes.c_int * 3)()
        assert lib.host_rollout_geometry(code, B, out) == 0
        assert list(out) == [32, W, -(-B // 32)]
        assert out[2] == {1: 1, 3: 1, 1024: 32, 4096: 128}[B]


def _affine(rng, B, T, n, dtype=np.float64):
    """The scan tests' recipe (``tests/test_torch_scan.py``)."""
    F = rng.normal(size=(B, T, n, n)) * 0.5
    c = rng.normal(size=(B, T, n))
    return F.astype(dtype), c.astype(dtype)


def _scan(lib, F, c, reverse, P):
    B, T, n, _ = F.shape
    Fo, co = torch.full_like(F, float("nan")), torch.full_like(c, float("nan"))
    assert lib.host_affine_scan(cuda.dtype_code(F.dtype), n, int(reverse), P,
                                F.data_ptr(), c.data_ptr(), Fo.data_ptr(),
                                co.data_ptr(), B, T) == 0
    return Fo, co


@pytest.mark.parametrize("T", [1, 7, 33, 129, 1000])
@pytest.mark.parametrize("reverse", [True, False], ids=["suffix", "prefix"])
@pytest.mark.parametrize("n", sk.SCAN_N)
def test_host_scan_matches_plain(scan, n, reverse, T):
    """Float64, three scenarios, every lane count: F and c within 1e-12 of
    max(1, scale) of ``affine_scan_plain``."""
    F, c = (torch.tensor(a) for a in _affine(np.random.default_rng(T + n), 3, T, n))
    ref = sk.affine_scan_plain(F, c, reverse)
    for P in sk.SCAN_LANES:
        if sk.scan_shared_bytes(n, P, torch.float64) > cuda.MAX_SMEM:
            continue  # a block the card cannot hold: never launched
        _assert_close(_scan(scan, F, c, reverse, P), ref,
                      f"n={n} T={T} P={P} reverse={reverse}")


@pytest.mark.parametrize("n", sk.SCAN_N)
def test_scan_shared_bytes_and_lane_cap(scan, n):
    """``scan_shared_bytes`` against the header's constants at every dtype
    and lane count, and the rule's cap: a single long scenario gets 256
    lanes unless that block would pass the card's shared memory (then 128:
    n=6 in float64, 346,752 bytes)."""
    for dtype in (torch.float32, torch.float64):
        for P in sk.SCAN_LANES:
            assert sk.scan_shared_bytes(n, P, dtype) == scan.host_scan_bytes(
                cuda.dtype_code(dtype), n, P), (dtype, P)
        fits = sk.scan_shared_bytes(n, 256, dtype) <= cuda.MAX_SMEM
        assert fits == (n != 6 or dtype == torch.float32)
        assert sk.scan_lanes(1, 1001, dtype, n=n) == (256 if fits else 128)


@pytest.mark.parametrize("B", [1, 3, 1024, 4096])
def test_scan_launch_rule(scan, B):
    """``scan_lanes`` at B in {1, 3, 1024, 4096} in both dtypes (32 lanes
    doubled while below 256 and T and the launch fits one wave of the
    kernel's resident warps: 64 for a float32 batch of 1024, 32 for more
    or in float64), and the
    block shape it launches: tiles of 4 stages of each lane, a stage's
    slot 20 scalars apart in float32 and 22 in float64 (odd numbers of
    16-byte units), 128 / P scenarios per block below P = 128, the warp
    totals after the tile."""
    small = {1: 32, 31: 32, 33: 64, 101: 128, 129: 256, 1001: 256}
    batch = {1: 32, 31: 32, 33: 64, 101: 64, 129: 64, 1001: 64}
    expect = {torch.float32: small if B < 1024 else batch if B == 1024
              else dict.fromkeys(small, 32),
              torch.float64: small if B < 1024 else dict.fromkeys(small, 32)}
    for dtype, rule in expect.items():
        for T, lanes in rule.items():
            assert sk.scan_lanes(B, T, dtype) == lanes, (B, T, dtype)
    for code, size, stride in ((0, 4, 20), (1, 8, 22)):
        for P in sk.SCAN_LANES:
            out = (ctypes.c_int * 4)()
            assert scan.host_scan_geometry(code, P, out) == 0
            nw = P // 32
            shared = 4 * P * stride + (nw * 20 if nw > 1 else 0)
            assert list(out) == [4, max(1, 128 // P), max(P, 128),
                                 max(1, 128 // P) * shared * size]


# --- float32 against JAX's kernels in interpret mode ------------------------


@pytest.mark.parametrize("model", list(MODELS))
def test_host_rollout_matches_jax_kernel_f32(tmp_path_factory, model):
    """The kernel's schedule against ``rollout_batched`` (interpret mode, one
    sublane), T=17, B=3 (``tests/test_torch_fused_iter.py``'s case): x0
    equal, every state within 1e-6."""
    tm, jm, nx, nu, centre = MODELS[model]
    Tn, Bn = 17, 3
    ocp = tm.make_ocp(1.0 / Tn)
    lib = _compile(tmp_path_factory, f"rollout_{model}_T{Tn}",
                   '#include "scalar_math.h"\n' + tf.model_struct(ocp, nx, nu)
                   + ROLLOUT_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_rollout.argtypes = [i, i, p, p, i, i]
    lib.host_rollout.restype = i
    rng = np.random.default_rng(2)
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u = (centre + 0.1 * rng.normal(size=(Bn, Tn, nu))).astype(np.float32)
    x0b = (x0 + 0.02 * rng.normal(size=(Bn, nx))).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jf.rollout_batched(jm.make_ocp(1.0 / Tn).dynamics,
                                            jnp.asarray(u), jnp.asarray(x0b),
                                            sublanes=1, interpret=True))
    xs, xT = _rollout(lib, torch.as_tensor(np.ascontiguousarray(u.transpose(1, 2, 0))),
                      torch.as_tensor(x0b.T.copy()))
    got = tf.lanes_first(xs, xT).numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("reverse", [True, False], ids=["suffix", "prefix"])
@pytest.mark.parametrize("T", [5, 130])
def test_host_scan_matches_pallas_interpret(scan, T, reverse):
    """Float32, n = 4, at every lane count, against ``pallas_affine_scan``
    in interpret mode (``tests/test_torch_scan.py``'s tolerances)."""
    F, c = _affine(np.random.default_rng(T), 1, T, 4, np.float32)
    ref = pallas_affine_scan(jnp.asarray(F[0]), jnp.asarray(c[0]),
                             reverse=reverse, interpret=True)
    for P in sk.SCAN_LANES:
        Fo, co = _scan(scan, torch.tensor(F), torch.tensor(c), reverse, P)
        np.testing.assert_allclose(Fo[0].numpy(), ref[0], atol=2e-5)
        np.testing.assert_allclose(co[0].numpy(), ref[1], atol=2e-4)
