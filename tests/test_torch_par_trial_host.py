"""The one-launch parallel trial's schedule (``csrc/par_trial.h``), built
with the host C++ compiler, against the trial's plain version on the CPU.

``par_trial.h`` holds the CUDA kernel's per-lane phases (the chunk walks,
the rounds of the in-warp and cross-warp scans, the carries, the tree sum)
and the schedule that orders them; its host executor steps every lane of a
scenario through each step in turn.  Here it is compiled with ``g++`` and
held, in float64 at 1e-12 of scale with equal ``ok`` flags, to
``fused_newton_step_plain`` (the ``newton_lqt`` -> ``par_bwd_pass`` ->
``par_fwd_pass`` pipeline) at every lane count the launch rule can pick,
every instantiated ``(nx, nu)`` (the planar quadrotor's (6, 2) included),
horizons on both sides of a warp's 32 lanes, with an indefinite R on one
lane; at the lane counts the rule picks for B in {1, 3, 1024}; and in
float32 against JAX's ``fused_newton_step(..., interpret=True)`` at
``tests/test_torch_par_newton.py``'s tolerances.  The rule's shared-memory
count (``trial_shared_bytes``) equals the header's at every shape, dtype
and lane count, and caps P at 128 where a block of 256 lanes would not fit
(nx=6, float64).
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.ops.pallas.newton_kernel import fused_newton_step as j_fused
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import newton_kernel as nk

torch.set_num_threads(1)

HORIZONS = (1, 2, 31, 32, 33, 100, 129, 1000)
TOL = 1e-12

# An extern "C" entry over par_trial_host: float64 for every instantiated
# shape, float32 for the pendulum's (2, 1); every lane count.
HOST_SOURCE = r"""
#include <vector>
#include "par_trial.h"

template <typename scalar_t, int NX, int NU, int P>
int run(const void* const* in, void* const* out, int B, int T) {
  using Tr = ipoc::ParTrial<scalar_t, NX, NU, P>;
  std::vector<typename Tr::Lane> lanes(P);
  std::vector<scalar_t> sh(Tr::kShared);
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  ipoc::par_trial_host<scalar_t, NX, NU, P>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), O(0), O(1), O(2), O(3),
      static_cast<bool*>(out[4]), B, T, lanes.data(), sh.data());
  return 0;
}

template <typename scalar_t, int NX, int NU>
int lanes(int P, const void* const* in, void* const* out, int B, int T) {
  if (P == 32) return run<scalar_t, NX, NU, 32>(in, out, B, T);
  if (P == 64) return run<scalar_t, NX, NU, 64>(in, out, B, T);
  if (P == 128) return run<scalar_t, NX, NU, 128>(in, out, B, T);
  if (P == 256) return run<scalar_t, NX, NU, 256>(in, out, B, T);
  return -1;
}

extern "C" int host_par_trial(int dtype, int nx, int nu, int P,
                              const void* const* in, void* const* out,
                              int B, int T) {
  if (dtype == 1 && nx == 2 && nu == 1) return lanes<double, 2, 1>(P, in, out, B, T);
  if (dtype == 1 && nx == 4 && nu == 1) return lanes<double, 4, 1>(P, in, out, B, T);
  if (dtype == 1 && nx == 3 && nu == 2) return lanes<double, 3, 2>(P, in, out, B, T);
  if (dtype == 1 && nx == 6 && nu == 2) return lanes<double, 6, 2>(P, in, out, B, T);
  if (dtype == 0 && nx == 2 && nu == 1) return lanes<float, 2, 1>(P, in, out, B, T);
  return -1;
}

// A block's shared bytes (par_trial.cuh TrialLaunch::smem).
template <typename scalar_t, int NX, int NU, int P>
int bytes() {
  using Tr = ipoc::ParTrial<scalar_t, NX, NU, P>;
  return Tr::kScenarios * Tr::kShared * static_cast<int>(sizeof(scalar_t));
}

template <typename scalar_t, int NX, int NU>
int shape_bytes(int P) {
  if (P == 32) return bytes<scalar_t, NX, NU, 32>();
  if (P == 64) return bytes<scalar_t, NX, NU, 64>();
  if (P == 128) return bytes<scalar_t, NX, NU, 128>();
  if (P == 256) return bytes<scalar_t, NX, NU, 256>();
  return -1;
}

template <typename scalar_t>
int dtype_bytes(int nx, int nu, int P) {
  if (nx == 2 && nu == 1) return shape_bytes<scalar_t, 2, 1>(P);
  if (nx == 4 && nu == 1) return shape_bytes<scalar_t, 4, 1>(P);
  if (nx == 3 && nu == 2) return shape_bytes<scalar_t, 3, 2>(P);
  if (nx == 6 && nu == 2) return shape_bytes<scalar_t, 6, 2>(P);
  return -1;
}

extern "C" int host_par_shared_bytes(int dtype, int nx, int nu, int P) {
  return dtype == 0 ? dtype_bytes<float>(nx, nu, P) : dtype_bytes<double>(nx, nu, P);
}
"""


@pytest.fixture(scope="module")
def host_trial(tmp_path_factory):
    """par_trial.h compiled with the host C++ compiler (a few seconds)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("par_trial")
    src, so = out / "par_trial_host.cpp", out / "par_trial_host.so"
    src.write_text(HOST_SOURCE)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_par_trial.argtypes = [i, i, i, i, p, p, i, i]
    lib.host_par_trial.restype = i
    lib.host_par_shared_bytes.argtypes = [i, i, i, i]
    lib.host_par_shared_bytes.restype = i
    return lib


def _host(lib, args, lanes):
    """The host build's trial on CPU tensors: ``(du, dx, pred, ok)``."""
    ru, Q, R, M, fx, fu, XT = args
    B, T, nx, nu = fu.shape
    kw = dict(dtype=fu.dtype)
    outs = (torch.empty((B, T, nu * (1 + nx)), **kw),
            torch.empty((B, T, nu), **kw), torch.empty((B, T + 1, nx), **kw),
            torch.empty((B,), **kw), torch.empty((B,), dtype=torch.bool))
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    status = lib.host_par_trial(cuda.dtype_code(fu.dtype), nx, nu, lanes,
                                ptrs(args), ptrs(outs), B, T)
    assert status == 0
    return outs[1:]


def _random(B, T, nx, nu, seed, dtype=torch.float64):
    """Random well-posed trial data (the card tests' recipe): Q, R and XT
    positive definite."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: 0.3 * rng.normal(size=s)
    A = rnd(B, T, nx, nx)
    Q = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(nx)
    Br = rnd(B, T, nu, nu)
    R = Br @ np.swapaxes(Br, -1, -2) + 2 * np.eye(nu)
    Xa = rnd(B, nx, nx)
    XT = Xa @ np.swapaxes(Xa, -1, -2) + np.eye(nx)
    t = lambda a: torch.tensor(a, dtype=dtype).contiguous()
    return tuple(t(a) for a in (rnd(B, T, nu), Q, R, 0.1 * rnd(B, T, nx, nu),
                                rnd(B, T, nx, nx), rnd(B, T, nx, nu), XT))


def _assert_close(got, ref, tol, label):
    du, dx, pred, ok = got
    du_p, dx_p, pred_p, ok_p = ref
    assert torch.equal(ok, ok_p), label
    scale = float(du_p.abs().max())
    assert float((du - du_p).abs().max()) <= tol * scale, label
    assert float((dx - dx_p).abs().max()) <= tol * scale, label
    assert float(((pred - pred_p).abs() / pred_p.abs()).max()) <= tol, label


@pytest.mark.parametrize("T", HORIZONS)
@pytest.mark.parametrize("shape", nk.TRIAL_SHAPES, ids=lambda s: f"nx{s[0]}nu{s[1]}")
def test_host_trial_matches_plain(host_trial, shape, T):
    """Every lane count, one batch of three scenarios: below, at and above
    a warp's 32 lanes, one lane per stage (T=100 at 128 lanes) and long
    chunks (T=1000 at 32 lanes)."""
    args = _random(3, T, *shape, seed=T)
    ref = nk.fused_newton_step_plain(*args)
    assert bool(ref[3].all())
    for lanes in nk.TRIAL_LANES:
        if nk.trial_shared_bytes(shape[0], lanes, torch.float64) \
                > cuda.MAX_SMEM:
            continue  # a block the card cannot hold: never launched
        _assert_close(_host(host_trial, args, lanes), ref, TOL,
                      f"{shape} T={T} P={lanes}")


@pytest.mark.parametrize("shape", nk.TRIAL_SHAPES, ids=lambda s: f"nx{s[0]}nu{s[1]}")
def test_shared_bytes_and_lane_cap(host_trial, shape):
    """``trial_shared_bytes`` against the header's constants at every
    dtype and lane count, and the rule's cap: a single long scenario gets
    256 lanes unless that block would pass the card's shared memory (then
    128: the quadrotor's (6, 2) in float64, 255,552 bytes)."""
    nx, nu = shape
    for dtype in (torch.float32, torch.float64):
        for lanes in nk.TRIAL_LANES:
            assert nk.trial_shared_bytes(nx, lanes, dtype) == \
                host_trial.host_par_shared_bytes(cuda.dtype_code(dtype), nx,
                                                 nu, lanes), (dtype, lanes)
        fits = nk.trial_shared_bytes(nx, 256, dtype) <= cuda.MAX_SMEM
        assert fits == (shape != (6, 2) or dtype == torch.float32)
        assert nk.trial_lanes(1, 1000, nx=nx, dtype=dtype) == \
            (256 if fits else 128)


@pytest.mark.parametrize("B", [1, 3, 1024])
def test_host_trial_at_launch_rule(host_trial, B):
    """The launch rule (``trial_lanes``) at B in {1, 3, 1024}, and the
    host build at the lane count it picks, cartpole-shaped (4, 1)."""
    expect = {1: {1: 32, 31: 32, 33: 64, 100: 128, 129: 256, 1000: 256},
              3: {1: 32, 31: 32, 33: 64, 100: 128, 129: 256, 1000: 256},
              1024: {1: 32, 31: 32, 33: 32, 100: 32, 129: 32, 1000: 32}}[B]
    for T, lanes in expect.items():
        assert nk.trial_lanes(B, T) == lanes, (B, T)
    T = 100 if B == 1024 else 129
    args = _random(B, T, 4, 1, seed=B)
    _assert_close(_host(host_trial, args, nk.trial_lanes(B, T)),
                  nk.fused_newton_step_plain(*args), TOL, f"B={B}")


def test_host_trial_indefinite_lane(host_trial):
    """An indefinite R at one stage of lane 1 fails that lane only, at
    every lane count."""
    args = list(_random(3, 100, 4, 1, seed=7))
    args[2] = args[2].clone()
    args[2][1, 17] = -1.0
    ref = nk.fused_newton_step_plain(*args)
    assert ref[3].tolist() == [True, False, True]
    for lanes in nk.TRIAL_LANES:
        got = _host(host_trial, args, lanes)
        assert torch.equal(got[3], ref[3]), lanes
        keep = ref[3]
        _assert_close([g[keep] for g in got], [r[keep] for r in ref], TOL,
                      f"feasible lanes, P={lanes}")


def test_host_trial_matches_jax_kernel_interpret(host_trial):
    """Float32 against JAX's kernel in interpret mode, pendulum-shaped
    (2, 1) random data at T=16 (``tests/test_torch_par_newton.py``'s
    tolerances: du, dx 2e-5 of scale; pred rtol 1e-4; equal ok)."""
    args = _random(1, 16, 2, 1, seed=16, dtype=torch.float32)
    du_j, dx_j, pred_j, ok_j = j_fused(*(jnp.asarray(a[0].numpy())
                                         for a in args), interpret=True)
    du, dx, pred, ok = _host(host_trial, args, 32)
    scale = float(jnp.abs(du_j).max()) + 1e-6
    np.testing.assert_allclose(du[0].numpy(), du_j, atol=2e-5 * scale)
    np.testing.assert_allclose(dx[0].numpy(), dx_j, atol=2e-5 * scale)
    np.testing.assert_allclose(float(pred[0]), float(pred_j), rtol=1e-4)
    assert bool(ok[0]) == bool(ok_j) and bool(ok[0])
