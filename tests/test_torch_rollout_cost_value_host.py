"""The lane-open rollout-cost kernel's group schedule
(``csrc/rollout_cost.h``) and the value scan on the scans' lane schedule
(``csrc/affine_scan.h`` with ``ValueOp``), built with the host C++
compiler and held to their plain versions on the CPU.

The headers hold the CUDA kernels' per-lane code and the schedules that
order it.  The rollout cost's host executor steps a block's 32 lanes
(scenarios of G lanes) through every step in turn, block by block (those
past B included, on scenario B - 1's data, writing nothing), a shuffle
reading the lanes' values as they stood before it; the scan's steps every
lane of a scenario through each step, with the shared memory filled with
NaN first.  Here they are compiled with ``g++`` and held

* the rollout cost in float64 at 1e-12 of scale to ``rollout_cost_plain``
  (xs, xT, the barrier total cost, sum ||cu||^2), cartpole, pendulum and
  the planar quadrotor (nx=6, nu=2) and the unicycle (nx=3, nu=2) at dt = 1/40, B in {1, 3, 37} and T in {1, 7, 40}; to the one-thread
  loop it replaces (the parent kernel's, ``roll_cost`` whole, built by the
  same compiler) bit for bit in float64 and float32, at the kernel's group
  and chunk and at those timed against it; on inputs that start one scalar
  past a 16-byte boundary, to the bit of the aligned ones;
* the codegen's cut of ``roll_cost`` (``rollout_cost_parts``): the
  transition kernel's programs, composed to ``roll_cost`` to the bit;
* the value scan in float64 at 1e-12 of scale to ``value_scan_plain``
  (the association follows P, so not to the bit), n in {2, 3, 4, 6}, every
  lane count P in {32, 64, 128, 256} whose block fits the card's shared
  memory, T in {1, 7, 33, 129, 1000}; ``scan_shared_bytes(...,
  value=True)`` equal to the header's count at every n, dtype and P, and
  the cap it puts on P;
* the launch rules: the rollout cost's lanes per scenario, scenarios per
  block and blocks, and ``scan_lanes(..., value=True)`` with the value
  scan's block shape, at B in {1, 3, 1024, 4096};
* in float32 against JAX's kernels in interpret mode on the same
  numpy-seeded inputs: ``rollout_cost_packed``
  (``tests/test_torch_fused_iter.py``'s rtol and atol 5e-5) and
  ``pallas_value_scan`` (``tests/test_torch_scan.py``'s atol 5e-4).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.scan_kernels import pallas_value_scan
from ipoc_tpu.ops.pallas.seq_newton_kernel import _pack_s, _unpack_s
from ipoc_tpu.parallel import lqt as J
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops import scan_kernels as sk
from ipoc_tpu_torch.ops.codegen.scalarize import same_program
from tests.conftest import make_random_lqt

torch.set_num_threads(1)

TOL = 1e-12
DT = 1.0 / 40
# model: (port module, nx, nu, the controls' centre inside the box)
MODELS = {"cartpole": (t_cartpole, 4, 1, 0.0), "pendulum": (t_pendulum, 2, 1, 0.0),
          "quadrotor": (t_quadrotor, 6, 2, t_quadrotor.HOVER),
          "unicycle": (t_unicycle, 3, 2, 0.3)}
# (G lanes per scenario, W stages per chunk): the kernel's first, then
# those timed against it.
ROLL_SHAPES = ("kernel's", (8, 8), (4, 8), (1, 8))

ROLL_SOURCE = r"""
#include <math.h>
#include <vector>
#include "rollout_cost.h"

template <typename scalar_t, int G, int W>
int run(const void* const* in, void* const* out, int B, int T) {
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  ipoc::rollout_cost_host<Model, scalar_t, G, W>(I(0), I(1), I(2), O(0), O(1), O(2),
                                                  O(3), B, T);
  return 0;
}

// The one-thread loop of the kernel it replaces, lane by lane.
template <typename scalar_t>
int parent(const void* const* in, void* const* out, int B, int T) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const scalar_t* us = static_cast<const scalar_t*>(in[0]);
  const scalar_t* x0 = static_cast<const scalar_t*>(in[1]);
  const scalar_t* bp = static_cast<const scalar_t*>(in[2]);
  scalar_t* xs = static_cast<scalar_t*>(out[0]);
  scalar_t* xT = static_cast<scalar_t*>(out[1]);
  scalar_t* cost_o = static_cast<scalar_t*>(out[2]);
  scalar_t* cun_o = static_cast<scalar_t*>(out[3]);
  for (int b = 0; b < B; ++b) {
    const scalar_t bpv = bp[b];
    scalar_t x[NX];
    ipoc::load_col<scalar_t, NX>(x, x0, B, b);
    scalar_t cost = scalar_t(0), cun = scalar_t(0);
    for (int t = 0; t < T; ++t) {
      scalar_t u[NU], xn[NX], cst, cusq;
      ipoc::load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
      ipoc::store_col<scalar_t, NX>(xs + (size_t)t * NX * B, x, B, b);
      Model::template roll_cost<scalar_t>(x, u, &bpv, xn, &cst, &cusq);
      cost = cost + cst;
      cun = cun + cusq;
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    scalar_t cT;
    Model::template final_cost<scalar_t>(x, &cT);
    ipoc::store_col<scalar_t, NX>(xT, x, B, b);
    cost_o[b] = cost + cT;
    cun_o[b] = cun;
  }
  return 0;
}

template <typename scalar_t>
int pick(int shape, const void* const* in, void* const* out, int B, int T) {
  using Rc = ipoc::RollCost<Model, scalar_t>;
  if (shape == 0) return run<scalar_t, Rc::G, Rc::W>(in, out, B, T);
  if (shape == 1) return run<scalar_t, 8, 8>(in, out, B, T);
  if (shape == 2) return run<scalar_t, 4, 8>(in, out, B, T);
  if (shape == 3) return run<scalar_t, 1, 8>(in, out, B, T);
  if (shape == -1) return parent<scalar_t>(in, out, B, T);
  return -1;
}

extern "C" int host_rollout_cost(int dtype, int shape, const void* const* in,
                                 void* const* out, int B, int T) {
  if (dtype == 0) return pick<float>(shape, in, out, B, T);
  if (dtype == 1) return pick<double>(shape, in, out, B, T);
  return -1;
}

template <typename scalar_t>
void geometry_t(int B, int* out) {
  using Rc = ipoc::RollCost<Model, scalar_t>;
  out[0] = Rc::G;
  out[1] = Rc::S;
  out[2] = Rc::W;
  out[3] = Rc::blocks(B);
}

extern "C" int host_rollout_cost_geometry(int dtype, int B, int* out) {
  if (dtype == 0) return geometry_t<float>(B, out), 0;
  if (dtype == 1) return geometry_t<double>(B, out), 0;
  return -1;
}
"""

VALUE_SOURCE = r"""
#include <math.h>
#include <vector>
#include "affine_scan.h"

template <typename scalar_t, int N, int P>
int run(const void* const* in, void* const* out, int B, int T) {
  using Sc = ipoc::ValueScan<scalar_t, N, P>;
  std::vector<typename Sc::Lane> lanes(P);
  std::vector<scalar_t> sh(Sc::kShared, scalar_t(NAN));
  ipoc::lane_scan_host<Sc>(reinterpret_cast<const scalar_t* const*>(in),
                           reinterpret_cast<scalar_t* const*>(out), B, T, lanes.data(),
                           sh.data());
  return 0;
}

template <typename scalar_t, int N>
int lanes(int P, const void* const* in, void* const* out, int B, int T) {
  if (P == 32) return run<scalar_t, N, 32>(in, out, B, T);
  if (P == 64) return run<scalar_t, N, 64>(in, out, B, T);
  if (P == 128) return run<scalar_t, N, 128>(in, out, B, T);
  if (P == 256) return run<scalar_t, N, 256>(in, out, B, T);
  return -1;
}

// Float64 at every n, float32 at n = 4.
extern "C" int host_value_scan(int dtype, int n, int P, const void* const* in,
                               void* const* out, int B, int T) {
  if (dtype == 1 && n == 2) return lanes<double, 2>(P, in, out, B, T);
  if (dtype == 1 && n == 3) return lanes<double, 3>(P, in, out, B, T);
  if (dtype == 1 && n == 4) return lanes<double, 4>(P, in, out, B, T);
  if (dtype == 1 && n == 6) return lanes<double, 6>(P, in, out, B, T);
  if (dtype == 0 && n == 4) return lanes<float, 4>(P, in, out, B, T);
  return -1;
}

// Shared bytes per block of the value scan at (n, P) (par_newton.cu
// ScanLaunch::smem).
template <typename scalar_t, int N, int P>
int bytes() {
  using Sc = ipoc::ValueScan<scalar_t, N, P>;
  return Sc::kScenarios * Sc::kShared * static_cast<int>(sizeof(scalar_t));
}

template <typename scalar_t, int N>
int bytes_p(int P) {
  if (P == 32) return bytes<scalar_t, N, 32>();
  if (P == 64) return bytes<scalar_t, N, 64>();
  if (P == 128) return bytes<scalar_t, N, 128>();
  if (P == 256) return bytes<scalar_t, N, 256>();
  return -1;
}

template <typename scalar_t>
int bytes_n(int n, int P) {
  if (n == 2) return bytes_p<scalar_t, 2>(P);
  if (n == 3) return bytes_p<scalar_t, 3>(P);
  if (n == 4) return bytes_p<scalar_t, 4>(P);
  if (n == 6) return bytes_p<scalar_t, 6>(P);
  return -1;
}

extern "C" int host_value_bytes(int dtype, int n, int P) {
  return dtype == 0 ? bytes_n<float>(n, P) : bytes_n<double>(n, P);
}

// A lane's stages in a tile, a slot's stride in scalars, scenarios and
// threads per block, and shared bytes per block at n = 4.
template <typename scalar_t, int P>
void geometry_t(int* out) {
  using Sc = ipoc::ValueScan<scalar_t, 4, P>;
  out[0] = Sc::LT;
  out[1] = Sc::ES;
  out[2] = Sc::kScenarios;
  out[3] = Sc::kBlock;
  out[4] = Sc::kScenarios * Sc::kShared * static_cast<int>(sizeof(scalar_t));
}

extern "C" int host_value_geometry(int dtype, int P, int* out) {
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


def _roll_lib(tmp_path_factory, name, ocp, nx, nu=1):
    lib = _compile(tmp_path_factory, f"rollout_cost_{name}",
                   '#include "scalar_math.h"\n' + tf.model_struct(ocp, nx, nu)
                   + ROLL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_rollout_cost.argtypes = [i, i, p, p, i, i]
    lib.host_rollout_cost.restype = i
    lib.host_rollout_cost_geometry.argtypes = [i, i, p]
    lib.host_rollout_cost_geometry.restype = i
    return lib


@pytest.fixture(scope="module", params=list(MODELS))
def roll(request, tmp_path_factory):
    """``(model, ocp, nx, lib)``: one model's generated struct (dt = 1/40)
    and rollout_cost.h compiled with the host C++ compiler."""
    model, nx, nu, _ = MODELS[request.param]
    ocp = model.make_ocp(DT)
    return model, ocp, nx, _roll_lib(tmp_path_factory, request.param, ocp, nx,
                                     nu)


@pytest.fixture(scope="module")
def value(tmp_path_factory):
    """The value scan compiled with the host C++ compiler."""
    lib = _compile(tmp_path_factory, "value_scan", VALUE_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_value_scan.argtypes = [i, i, i, p, p, i, i]
    lib.host_value_scan.restype = i
    lib.host_value_geometry.argtypes = [i, i, p]
    lib.host_value_geometry.restype = i
    lib.host_value_bytes.argtypes = [i, i, i]
    lib.host_value_bytes.restype = i
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _rollout_cost(lib, u, x0, bp, shape=0):
    """The host build's rollout cost (``shape`` -1: the one-thread loop) on
    CPU tensors; outputs NaN-filled first."""
    T, _, B = u.shape
    nx = x0.shape[0]
    outs = [torch.full(s, float("nan"), dtype=u.dtype)
            for s in ((T, nx, B), (nx, B), (B,), (B,))]
    assert lib.host_rollout_cost(cuda.dtype_code(u.dtype), shape,
                                 _ptrs((u, x0, bp)), _ptrs(outs), B, T) == 0
    return outs


def _lanes(model, nx, B, T, seed, dtype=torch.float64):
    """Packed controls, initial states and barrier parameters from numpy:
    ``u (T, nu, B)``, ``x0 (nx, B)``, ``bp (B,)``."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    _, _, nu, centre = next(m for m in MODELS.values() if m[0] is model)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (t(centre + 0.1 * rng.normal(size=(T, nu, B))),
            t(x0[:, None] + 0.01 * rng.normal(size=(nx, B))),
            t(rng.uniform(0.01, 0.2, size=B)))


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
def test_host_rollout_cost_matches_plain(roll, T):
    """Float64 at 1e-12 of scale, B in {1, 3, 37}: xs, xT, the cost and
    sum ||cu||^2 against ``rollout_cost_plain``; bit for bit the one-thread
    loop in both dtypes, at every group and chunk; at B = 37 offset views
    to the bit of the aligned inputs."""
    model, ocp, nx, lib = roll
    for B in (1, 3, 37):
        u, x0, bp = _lanes(model, nx, B, T, seed=T + B)
        got = _rollout_cost(lib, u, x0, bp)
        _assert_close(got, tf.rollout_cost_plain(ocp, u, x0, bp), f"T={T} B={B}")
        for dtype in (torch.float64, torch.float32):
            ins = [a.to(dtype) for a in (u, x0, bp)]
            ref = _rollout_cost(lib, *ins, shape=-1)
            for shape in range(len(ROLL_SHAPES)):
                for g, r in zip(_rollout_cost(lib, *ins, shape=shape), ref):
                    assert torch.equal(g, r), (T, B, dtype, ROLL_SHAPES[shape])
        if B == 37:
            views = _rollout_cost(lib, *(_offset(a) for a in (u, x0, bp)))
            for g, v in zip(got, views):
                assert torch.equal(g, v)


@pytest.mark.parametrize("B", [1, 3, 1024, 4096])
def test_rollout_cost_launch_rule(roll, B):
    """4 lanes per scenario, 8 scenarios to a one-warp block, ceil(B / 8)
    blocks, chunks of 4 stages, in both dtypes."""
    lib = roll[3]
    for code in (0, 1):
        out = (ctypes.c_int * 4)()
        assert lib.host_rollout_cost_geometry(code, B, out) == 0
        assert list(out) == [4, 8, 4, -(-B // 8)]
    assert {1: 1, 3: 1, 1024: 128, 4096: 512}[B] == -(-B // 8)


def test_rollout_cost_parts_are_the_stage_program(roll):
    """``roll_cost`` cut at its inputs is the transition kernel's two
    programs (``same_program``), and they give roll_cost's next state, cost
    and ||cu||^2 (each the product of its pair) to the bit on the torch
    evaluators in float64."""
    _, ocp, nx, _ = roll
    nu = {4: 1, 2: 1, 6: 2, 3: 2}[nx]
    prog = tf.scalar_programs(ocp, nx, nu)["roll_cost"]
    step, ev = tf.rollout_cost_parts(ocp, nx, nu)
    t_step, t_ev = tf.transition_parts(ocp, nx, nu)
    assert same_program(step, t_step) and same_program(ev, t_ev)
    assert not same_program(step, ev)
    gen = torch.Generator().manual_seed(nx)
    x, u, bp = (0.1 + 0.4 * torch.rand(tuple(s) + (16,), generator=gen,
                                       dtype=torch.float64)
                for s in prog.in_shapes)
    xn, cost, cu = prog.evaluate(x, u, bp)
    (sn,) = step.evaluate(x, u)
    c, q = ev.evaluate(x, u, bp)
    assert torch.equal(sn, xn)
    assert torch.equal(c[0] * c[1], cost)
    assert torch.equal(q[0] * q[1], cu)


def _value_elems(seed, B, T, n, dtype=np.float64):
    """Value elements of random well-conditioned LQTs
    (``tests/conftest.py`` make_random_lqt, ``lqt._elements``) as torch
    tensors ``(B, T, ...)``."""
    rng = np.random.default_rng(seed)
    lqts = [make_random_lqt(rng, T=T, nx=n, nu=2) for _ in range(B)]
    elems = jax.jit(jax.vmap(J._elements))(
        jax.tree.map(lambda *a: jnp.stack(a), *lqts))
    return tuple(torch.tensor(np.asarray(e).astype(dtype)) for e in elems)


def _value_scan(lib, elems, P):
    B, T, n = elems[1].shape
    outs = [torch.full_like(e, float("nan")) for e in elems]
    assert lib.host_value_scan(cuda.dtype_code(elems[0].dtype), n, P,
                               _ptrs(elems), _ptrs(outs), B, T) == 0
    return outs


@pytest.mark.parametrize("T", [1, 7, 33, 129, 1000])
@pytest.mark.parametrize("n", sk.SCAN_N)
def test_host_value_scan_matches_plain(value, n, T):
    """Float64, two scenarios (one at T=1000), every lane count: A, b, C,
    eta and J within 1e-12 of max(1, scale) of ``value_scan_plain``."""
    elems = _value_elems(T + n, 1 if T == 1000 else 2, T, n)
    ref = sk.value_scan_plain(*elems)
    for P in sk.SCAN_LANES:
        if sk.scan_shared_bytes(n, P, torch.float64, value=True) \
                > cuda.MAX_SMEM:
            continue  # a block the card cannot hold: never launched
        _assert_close(_value_scan(value, elems, P), ref, f"n={n} T={T} P={P}")


@pytest.mark.parametrize("n", sk.SCAN_N)
def test_value_shared_bytes_and_lane_cap(value, n):
    """``scan_shared_bytes(..., value=True)`` against the header's
    constants at every dtype and lane count, and the rule's cap: a single
    long scenario gets 256 lanes unless that block would pass the card's
    shared memory (then 128: n=6 in float64, 255,488 bytes)."""
    for dtype in (torch.float32, torch.float64):
        for P in sk.SCAN_LANES:
            assert sk.scan_shared_bytes(n, P, dtype, value=True) == \
                value.host_value_bytes(cuda.dtype_code(dtype), n, P), (dtype, P)
        fits = sk.scan_shared_bytes(n, 256, dtype, value=True) <= cuda.MAX_SMEM
        assert fits == (n != 6 or dtype == torch.float32)
        assert sk.scan_lanes(1, 1001, dtype, value=True, n=n) == \
            (256 if fits else 128)


@pytest.mark.parametrize("B", [1, 3, 1024, 4096])
def test_value_launch_rule(value, B):
    """``scan_lanes(..., value=True)`` at B in {1, 3, 1024, 4096} in both
    dtypes (32 lanes doubled while below 256 and T and the launch fits one
    wave of the value scan's resident warps: 32 for a batch of 1024 or
    more), and the block shape it launches: at n = 4 tiles of 2 stages of
    each lane in float32 and 1 in float64, a stage's slot 57 scalars apart
    (odd), 128 / P scenarios per block below P = 128, the warp totals after
    the tile."""
    small = {1: 32, 31: 32, 33: 64, 101: 128, 129: 256, 1001: 256}
    expect = small if B < 1024 else dict.fromkeys(small, 32)
    for dtype in (torch.float32, torch.float64):
        for T, lanes in expect.items():
            assert sk.scan_lanes(B, T, dtype, value=True) == lanes, (B, T, dtype)
    for code, size, lt in ((0, 4, 2), (1, 8, 1)):
        for P in sk.SCAN_LANES:
            out = (ctypes.c_int * 5)()
            assert value.host_value_geometry(code, P, out) == 0
            nw = P // 32
            shared = lt * P * 57 + (nw * 56 if nw > 1 else 0)
            assert list(out) == [lt, 57, max(1, 128 // P), max(P, 128),
                                 max(1, 128 // P) * shared * size]


# --- float32 against JAX's kernels in interpret mode ------------------------

JB, JT = 128, 6


def test_host_rollout_cost_matches_jax_kernel_f32(tmp_path_factory):
    """The kernel's schedule against JAX's ``rollout_cost_packed``
    (interpret mode, one sublane), pendulum at dt = 1/6, 128 lanes: xs, xT,
    the cost and sum ||cu||^2."""
    tocp = t_pendulum.make_ocp(1.0 / JT)
    lib = _roll_lib(tmp_path_factory, f"pendulum_T{JT}", tocp, 2)
    rng = np.random.default_rng(3)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u = (0.1 * rng.normal(size=(JB, JT, 1))).astype(np.float32)
    x0b = (x0 + 0.02 * rng.normal(size=(JB, 2))).astype(np.float32)
    bp = np.full((JB,), 0.1, np.float32)
    pack = lambda a: (_pack_s(jnp.asarray(a), JB, 1) if a.ndim == 3  # noqa: E731
                      else jf._pack_vec(jnp.asarray(a), JB, 1))
    set_pallas_scans("on")
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(lambda: jf.rollout_cost_packed(
                j_pendulum.make_ocp(1.0 / JT), pack(u), pack(x0b),
                pack(bp[:, None]), interpret=True))()
    finally:
        set_pallas_scans("auto")
    got = _rollout_cost(lib, torch.as_tensor(np.ascontiguousarray(u.transpose(1, 2, 0))),
                        torch.as_tensor(x0b.T.copy()), torch.as_tensor(bp))
    tol = dict(rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got[0].permute(2, 0, 1).numpy(),
                               np.asarray(_unpack_s(ref[0], JB, (2,))), **tol)
    np.testing.assert_allclose(got[1].T.numpy(),
                               np.asarray(_unpack_s(ref[1][:, None], JB, (2,)))[:, 0],
                               **tol)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1)[:JB], **tol)


def test_host_value_scan_matches_pallas_interpret(value):
    """Float32, n = 4, T = 16, at every lane count, against
    ``pallas_value_scan`` in interpret mode (``tests/test_torch_scan.py``'s
    case and atol 5e-4)."""
    T = 16
    rng = np.random.default_rng(T)
    lqt = make_random_lqt(rng, T=T, nx=4, nu=2, dtype=jnp.float32)
    elems = J._elements(lqt)
    ref = pallas_value_scan(elems.A, elems.b, elems.C, elems.eta, elems.J,
                            interpret=True)
    ins = tuple(torch.tensor(np.asarray(e))[None] for e in elems)
    for P in sk.SCAN_LANES:
        for g, r in zip(_value_scan(value, ins, P), ref):
            np.testing.assert_allclose(g[0].numpy(), r, atol=5e-4)
