"""The group schedules of the fused forward sweep (``csrc/fused_fwd.h``) and
the stage-transition kernel (``csrc/transition.h``), built with the host
C++ compiler and held to the plain versions on the CPU, and the codegen's
cuts that they run.

The headers hold the CUDA kernels' per-lane parts and the schedules that
order them; their host executors step a block's 32 lanes (4 scenarios of
8 lanes) through every step in turn, block by block (those past B
included, on scenario B - 1's data, writing nothing), with the shared
memory filled with NaN first.  Here they are compiled with ``g++`` and held

* in float64 at 1e-12 of scale, cartpole, pendulum and the planar
  quadrotor (nx=6, nu=2) and the unicycle (nx=3, nu=2) at dt = 1/40, B in
  {1, 3, 37} and T in {1, 7, 40}: the forward sweep (on the gains of the
  host build of ``csrc/fused_bwd.h``) against the plain fused iteration's
  trial point, cost, maximum constraint value and sum ||cu||^2; the
  transition against ``transition_plain``; both also on inputs that start
  one scalar past a 16-byte boundary (the ring's one-scalar copies), to
  the bit of the aligned ones;
* the codegen's parts (``forward_parts``, ``transition_parts``): composed,
  ``stage_fwd`` and ``transition`` to the bit (torch evaluators, float64);
  their handoff and operation counts;
* the launch rule (lanes per scenario, scenarios per block, blocks) and
  the shared memory per block at B in {1, 3, 4096};
* in float32 against JAX's kernels in interpret mode (pendulum, T=6, 128
  lanes): ``fused_newton_iter_packed(..., merged=False, with_cu=True)``
  and ``transition_packed``, at ``tests/test_torch_fused_iter.py``'s
  tolerance (rtol and atol 5e-5);
* the unicycle's keep-out disc on the forward sweep and the rollout cost
  (``csrc/rollout_cost.h``), both dtypes: a lane whose states enter the
  disc at one constrained stage is infeasible, one whose only entry is
  the terminal state is not, as the plain versions and JAX judge them.
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
from ipoc_tpu.models import unicycle as j_unicycle
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.seq_newton_kernel import _pack_s, _unpack_s
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops.codegen.scalarize import ELEMENTARY_CALLS as CALLS
from ipoc_tpu_torch.ops.codegen.scalarize import same_program

torch.set_num_threads(1)

TOL = 1e-12
DT = 1.0 / 40
# model: (port module, nx, nu, the controls' centre inside the box)
MODELS = {"cartpole": (t_cartpole, 4, 1, 0.0), "pendulum": (t_pendulum, 2, 1, 0.0),
          "quadrotor": (t_quadrotor, 6, 2, t_quadrotor.HOVER),
          "unicycle": (t_unicycle, 3, 2, 0.3)}

SOURCE = r"""
#include <math.h>
#include <vector>
#include "fused_bwd.h"
#include "fused_fwd.h"
#include "transition.h"

template <typename scalar_t>
int run(int kernel, const void* const* in, void* const* out, int B, int T) {
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  if (kernel == 0) {
    std::vector<scalar_t> sh(ipoc::FusedBwd<Model, scalar_t>::kShared, scalar_t(NAN));
    ipoc::fused_bwd_host<Model, scalar_t>(I(0), I(1), I(2), I(3), I(4), O(0), O(1),
                                          O(2), O(3), O(4), B, T, sh.data());
  } else if (kernel == 1) {
    std::vector<scalar_t> sh(ipoc::FusedFwd<Model, scalar_t>::kShared, scalar_t(NAN));
    ipoc::fused_fwd_host<Model, scalar_t>(I(0), I(1), I(2), I(3), I(4), O(0), O(1),
                                          O(2), O(3), O(4), O(5), B, T, sh.data());
  } else if (kernel == 2) {
    std::vector<scalar_t> sh(ipoc::Transition<Model, scalar_t>::kShared, scalar_t(NAN));
    ipoc::transition_host<Model, scalar_t>(I(0), I(1), I(2), I(3), O(0), O(1), O(2),
                                           O(3), O(4), O(5), O(6), O(7), B, T,
                                           sh.data());
  } else {
    return -1;
  }
  return 0;
}

extern "C" int host_run(int dtype, int kernel, const void* const* in,
                        void* const* out, int B, int T) {
  if (dtype == 0) return run<float>(kernel, in, out, B, T);
  if (dtype == 1) return run<double>(kernel, in, out, B, T);
  return -1;
}

template <typename scalar_t>
void geometry_t(int kernel, int B, int* out) {
  using F = ipoc::FusedFwd<Model, scalar_t>;
  using Tr = ipoc::Transition<Model, scalar_t>;
  const bool fwd = kernel == 1;
  out[0] = fwd ? F::G : Tr::G;
  out[1] = fwd ? F::S : Tr::S;
  out[2] = fwd ? F::W : Tr::W;
  out[3] = fwd ? F::blocks(B) : Tr::blocks(B);
  out[4] = (fwd ? F::kShared : Tr::kShared) * static_cast<int>(sizeof(scalar_t));
}

extern "C" int host_geometry(int dtype, int kernel, int B, int* out) {
  if (kernel != 1 && kernel != 2) return -1;
  if (dtype == 0) return geometry_t<float>(kernel, B, out), 0;
  if (dtype == 1) return geometry_t<double>(kernel, B, out), 0;
  return -1;
}
"""
KERNEL = {"fused_bwd": 0, "fused_fwd": 1, "transition": 2}
_LIBS = {}


def _library(tmp_path_factory, name):
    """One model's generated struct (dt = 1/40) and the three schedules
    compiled with the host C++ compiler, once per module: ``(ocp, lib)``."""
    if name not in _LIBS:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            pytest.skip("no host C++ compiler")
        model, nx, nu, _ = MODELS[name]
        ocp = model.make_ocp(DT)
        out = tmp_path_factory.mktemp(f"fwd_{name}")
        src, so = out / "fwd.cpp", out / "fwd.so"
        src.write_text('#include "scalar_math.h"\n'
                       + tf.model_struct(ocp, nx, nu) + SOURCE)
        res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                              "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.host_run.argtypes = [i, i, p, p, i, i]
        lib.host_run.restype = i
        lib.host_geometry.argtypes = [i, i, i, p]
        lib.host_geometry.restype = i
        _LIBS[name] = ocp, lib
    return _LIBS[name]


@pytest.fixture(scope="module", params=list(MODELS))
def host(request, tmp_path_factory):
    """``(model, ocp, nx, lib)`` of one model's host build."""
    model, nx, _, _ = MODELS[request.param]
    ocp, lib = _library(tmp_path_factory, request.param)
    return model, ocp, nx, lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _run(lib, kernel, ins, out_shapes):
    """The host build's ``kernel`` on CPU tensors; outputs NaN-filled first."""
    dtype = ins[0].dtype
    T, B = ins[0].shape[0], ins[0].shape[-1]
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in out_shapes]
    assert lib.host_run(cuda.dtype_code(dtype), KERNEL[kernel], _ptrs(ins),
                        _ptrs(outs), B, T) == 0
    return outs


def _bwd(lib, xs, u, xT, bp, reg):
    T, nx, B = xs.shape
    return _run(lib, "fused_bwd", (xs, u, xT, bp, reg),
                [(T, (1 + nx) * u.shape[1], B)] + [(B,)] * 4)


def _fwd(lib, xs, u, xT, bp, Kk):
    T, nx, B = xs.shape
    return _run(lib, "fused_fwd", (xs, u, xT, bp, Kk),
                [(T, u.shape[1], B), (T, nx, B), (nx, B), (B,), (B,), (B,)])


def _transition(lib, u, up, x0, bp):
    T, _, B = u.shape
    nx = x0.shape[0]
    return _run(lib, "transition", (u, up, x0, bp),
                [(T, nx, B), (T, nx, B), (nx, B), (nx, B)] + [(B,)] * 4)


def _lanes(model, ocp, nx, B, T, seed, dtype=torch.float64):
    """Packed lane inputs at a random warm start: the open-loop trajectory
    of numpy-made controls, a second control set, a per-lane barrier and
    Levenberg parameter."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    _, _, nu, centre = next(m for m in MODELS.values() if m[0] is model)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    u = t(centre + 0.1 * rng.normal(size=(T, nu, B)))
    up = t(centre + 0.15 * rng.normal(size=(T, nu, B)))
    x0b = t(x0[:, None] + 0.01 * rng.normal(size=(nx, B)))
    bp = t(rng.uniform(0.01, 0.2, size=B))
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0b, bp)
    return xs, xT, u, up, x0b, bp, 100.0 * torch.sqrt(cunsq)


def _offset(a):
    """``a`` as a contiguous view one scalar past its storage's start."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    return v


def _assert_close(got, ref, label):
    for k, (g, r) in enumerate(zip(got, ref)):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= TOL * scale, (label, k)


@pytest.mark.parametrize("T", [1, 7, 40])
def test_host_fused_fwd_matches_plain(host, T):
    """Float64 at 1e-12 of scale, B in {1, 3, 37}: tu, tx, txT, the trial
    cost, its maximum constraint value and sum ||cu||^2 against the plain
    fused iteration, on the host backward sweep's gains; at B = 37 also on
    offset views, to the bit of the aligned inputs."""
    model, ocp, nx, lib = host
    for B in (1, 3, 37):
        xs, xT, u, _, _, bp, reg = _lanes(model, ocp, nx, B, T, seed=T + B)
        ref = tf.fused_newton_iter_plain(ocp, xs, xT, u, bp, reg)
        Kk = _bwd(lib, xs, u, xT, bp, reg)[0]
        got = _fwd(lib, xs, u, xT, bp, Kk)
        _assert_close(got, [ref[i] for i in (0, 1, 2, 4, 5, 9)],
                      f"fused_fwd T={T} B={B}")
        if B == 37:
            views = _fwd(lib, *(_offset(a) for a in (xs, u, xT, bp, Kk)))
            for g, v in zip(got, views):
                assert torch.equal(g, v)


@pytest.mark.parametrize("T", [1, 7, 40])
def test_host_transition_matches_plain(host, T):
    """Float64 at 1e-12 of scale, B in {1, 3, 37}: both candidates' states,
    costs and sums ||cu||^2 against ``transition_plain``; at B = 37 also on
    offset views, to the bit of the aligned inputs."""
    model, ocp, nx, lib = host
    for B in (1, 3, 37):
        _, _, u, up, x0, bp, _ = _lanes(model, ocp, nx, B, T, seed=2 * T + B)
        got = _transition(lib, u, up, x0, bp)
        _assert_close(got, tf.transition_plain(ocp, u, up, x0, bp),
                      f"transition T={T} B={B}")
        if B == 37:
            views = _transition(lib, *(_offset(a) for a in (u, up, x0, bp)))
            for g, v in zip(got, views):
                assert torch.equal(g, v)


@pytest.mark.parametrize("B", [1, 3, 4096])
def test_launch_rule(host, B):
    """G = 8 lanes per scenario, 4 scenarios per one-warp block, ceil(B / 4)
    blocks; forward chunks of 8 stages, transition chunks of 4; the shared
    memory per block that the source notes state."""
    _, _, nx, lib = host
    shared = {(1, 4): (11008, 22016), (1, 2): (6912, 13824),
              (1, 6): (20992, 41984), (2, 4): (2560, 5120),
              (2, 2): (2048, 4096), (2, 6): (3584, 7168),
              (1, 3): (13056, 26112), (2, 3): (2816, 5632)}
    for kernel in (1, 2):
        for code in (0, 1):
            out = (ctypes.c_int * 5)()
            assert lib.host_geometry(code, kernel, B, out) == 0
            assert list(out)[:4] == [8, 4, {1: 8, 2: 4}[kernel], -(-B // 4)]
            assert out[4] == shared[(kernel, nx)][code], (kernel, code)
    assert {1: 1, 3: 1, 4096: 1024}[B] == -(-B // 4)


def _args(prog, seed, B=16):
    gen = torch.Generator().manual_seed(seed)
    return [0.1 + 0.4 * torch.rand(tuple(s) + (B,), generator=gen,
                                   dtype=torch.float64)
            for s in prog.in_shapes]


def test_forward_parts_are_the_stage_program(host):
    """step(pre(x, u, bp, gains), dx) gives stage_fwd's tu, tx and dx_next,
    and eval(tx, tu, bp) its cost, maximum constraint value and ||cu||^2
    (each summand the product of its pair), to the bit on the torch
    evaluators in float64.  The handoff holds the inputs the chain reads
    (x, u, gains) and the elementary-function calls that do not read the
    deviation: 12 values at cartpole (sin and cos), 7 at pendulum (cos), 24
    at the quadrotor (sin and cos), 15 at the unicycle (sin and cos); the
    step computes the rest of the chain, 85, 15, 64 and 33 operations, the
    evaluation 36, 30, 64 and 66 (the unicycle's five barrier logs and the
    disc's row among the five of its maximum); pre makes no other call."""
    _, ocp, nx, _ = host
    nu = {4: 1, 2: 1, 6: 2, 3: 2}[nx]
    prog = tf.scalar_programs(ocp, nx, nu)["stage_fwd"]
    pre, step, ev = tf.forward_parts(ocp, nx, nu)
    assert {nd.op for nd in pre.order} <= CALLS | {"input"}
    assert {nd.op for nd in step.order} & CALLS == set()
    counts = {4: (12, 2, 85, 36), 2: (7, 1, 15, 30), 6: (24, 2, 64, 64),
              3: (15, 2, 33, 66)}[nx]
    assert (pre.out_shapes[0][0], pre.stats["ops"], step.stats["ops"],
            ev.stats["ops"]) == counts
    assert ev.out_shapes == [(2,), (), (2,)]
    x, u, bp, dx, g = _args(prog, nx)
    ref = prog.evaluate(x, u, bp, dx, g)
    tu, tx, dxn = step.evaluate(pre.evaluate(x, u, bp, g)[0], dx)
    cost, cmax, cu = ev.evaluate(tx, tu, bp)
    got = (tu, tx, dxn, cost[0] * cost[1], cmax, cu[0] * cu[1])
    for k, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), k


def test_transition_parts_are_the_stage_program(host):
    """Candidate a's cut, run on each candidate's data, gives transition's
    states, costs and sums ||cu||^2 to the bit (torch evaluators, float64);
    candidate b's own cut is the same program.  The step is the dynamics
    (28 operations at cartpole, 9 at pendulum, 22 at the quadrotor, 10 at
    the unicycle), the evaluation the stage cost and ||cu||^2 (35, 29, 61
    and 62)."""
    _, ocp, nx, _ = host
    nu = {4: 1, 2: 1, 6: 2, 3: 2}[nx]
    prog = tf.scalar_programs(ocp, nx, nu)["transition"]
    step, ev = tf.transition_parts(ocp, nx, nu)
    assert (step.stats["ops"], ev.stats["ops"]) == {
        4: (28, 35), 2: (9, 29), 6: (22, 61), 3: (10, 62)}[nx]
    xa, xb, u, up, bp = _args(prog, nx + 1)
    ref = prog.evaluate(xa, xb, u, up, bp)
    for c, (x, uu) in enumerate(((xa, u), (xb, up))):
        (xn,) = step.evaluate(x, uu)
        cost, cu = ev.evaluate(x, uu, bp)
        assert torch.equal(xn, ref[c])
        assert torch.equal(cost[0] * cost[1], ref[2 + c])
        assert torch.equal(cu[0] * cu[1], ref[4 + c])
    b_step = prog.cut([("in", 1), ("in", 3)], (1,), "transition_step")
    assert same_program(step, b_step)
    assert not same_program(step, ev)


# --- float32 against JAX's kernels in interpret mode ------------------------

JB, JT = 128, 6


def _jp(a):
    """(B, T, rows) or (B, rows) numpy -> JAX's packed layout (1 sublane)."""
    a = jnp.asarray(a)
    return _pack_s(a, JB, 1) if a.ndim == 3 else jf._pack_vec(a, JB, 1)


@pytest.fixture(scope="module")
def pendulum_f32(tmp_path_factory):
    """Pendulum lanes at dt = 1/40, T = 6, float32, in the port's and JAX's
    layouts, with the pendulum host build."""
    tocp, lib = _library(tmp_path_factory, "pendulum")
    jocp = j_pendulum.make_ocp(DT)
    rng = np.random.default_rng(3)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u = (0.1 * rng.normal(size=(JB, JT, 1))).astype(np.float32)
    up = (u + 0.05 * rng.normal(size=u.shape)).astype(np.float32)
    x0b = (x0 + 0.02 * rng.normal(size=(JB, 2))).astype(np.float32)
    bp = np.full((JB,), 0.1, np.float32)
    port = lambda a: torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))  # noqa: E731
    set_pallas_scans("on")
    yield jocp, tocp, lib, u, up, x0b, bp, port
    set_pallas_scans("auto")


def _stages(p, rows):
    return np.asarray(_unpack_s(p, JB, (rows,)))


def _vec(p, rows):
    return np.asarray(_unpack_s(p[:, None], JB, (rows,)))[:, 0]


def test_host_fused_fwd_matches_jax_kernel_f32(pendulum_f32):
    """The forward sweep on the host backward sweep's gains against JAX's
    two-launch fused iteration (interpret mode): tu, tx, txT, the trial
    cost, its maximum constraint value and sum ||cu||^2."""
    jocp, tocp, lib, u, _, x0b, bp, port = pendulum_f32
    ut, bpt = port(u), torch.as_tensor(bp)
    xs, xT, _, _ = tf.rollout_cost_plain(tocp, ut, torch.as_tensor(x0b.T.copy()),
                                         bpt)
    reg = np.full((JB,), 3.0, np.float32)
    xs_b, xT_b = xs.permute(2, 0, 1).numpy(), xT.T.numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.fused_newton_iter_packed(
            jocp, _jp(xs_b), _jp(xT_b), _jp(u), _jp(bp[:, None]),
            _jp(reg[:, None]), with_cu=True, merged=False,
            interpret=True))()
    Kk = _bwd(lib, xs, ut, xT, bpt, torch.as_tensor(reg))[0]
    tu, tx, txT, nc, mc, cun = _fwd(lib, xs, ut, xT, bpt, Kk)
    tol = dict(rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(tu.permute(2, 0, 1).numpy(), _stages(ref[0], 1), **tol)
    np.testing.assert_allclose(tx.permute(2, 0, 1).numpy(), _stages(ref[1], 2), **tol)
    np.testing.assert_allclose(txT.T.numpy(), _vec(ref[2], 2), **tol)
    for name, g, r in (("nc", nc, ref[4]), ("mc", mc, ref[5]), ("cun", cun, ref[9])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1)[:JB],
                                   err_msg=name, **tol)


def test_host_transition_matches_jax_kernel_f32(pendulum_f32):
    """The transition against JAX's ``transition_packed`` (interpret mode):
    both candidates' states, costs and sums ||cu||^2."""
    jocp, tocp, lib, u, up, x0b, bp, port = pendulum_f32
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.transition_packed(
            jocp, _jp(u), _jp(up), _jp(x0b), _jp(bp[:, None]),
            interpret=True))()
    got = _transition(lib, port(u), port(up), torch.as_tensor(x0b.T.copy()),
                      torch.as_tensor(bp))
    tol = dict(rtol=5e-5, atol=5e-5)
    for i in range(2):
        np.testing.assert_allclose(got[i].permute(2, 0, 1).numpy(),
                                   _stages(ref[i], 2), **tol)
        np.testing.assert_allclose(got[2 + i].T.numpy(), _vec(ref[2 + i], 2),
                                   **tol)
    for g, r in zip(got[4:], ref[4:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1)[:JB],
                                   **tol)


# --- the keep-out disc: which stage points are constrained -------------------


def disc_batch(T, stages, dtype=torch.float64):
    """Unicycle lanes (dt = 1/40) that drive straight along +x at v = 1.6
    on the chord 0.01 below the disc's top: one stage point every 0.04 of
    x, so lane b's only point inside the disc is at stage ``stages[b]``
    (T: the terminal state; past T: none).  Returns ``(u (T, 2, B), x0
    (3, B))``."""
    cx, cy = t_unicycle.CENTER
    v, h = 1.6, 0.01
    y = cy + float(np.sqrt(t_unicycle.RADIUS**2 - h**2))
    B = len(stages)
    u = torch.zeros((T, 2, B), dtype=dtype)
    u[:, 0] = v
    x0 = torch.zeros((3, B), dtype=dtype)
    x0[0] = torch.tensor([cx - v * DT * s for s in stages], dtype=dtype)
    x0[1] = y
    return u, x0


def test_disc_constrains_the_stage_points_alone(tmp_path_factory):
    """The unicycle's disc on the fused forward sweep (zero gains: the trial
    point is the iterate) and the rollout cost, float64 and float32, T=40:
    a lane whose states enter the disc at one constrained stage (0, 1, 20
    or 39) is infeasible (max_c > 0, a NaN barrier cost), one whose only
    entry is the terminal state, or that never enters, is not (max_c <= 0,
    finite costs): as the plain versions and JAX's ``_fused_reference``
    (``max(constraints(temp_x[:-1], temp_u))``) and ``total_cost`` judge
    them; the sweep's outputs within 1e-12 (float64) of the plain
    version's, the NaN costs where it has them."""
    ocp, lib = _library(tmp_path_factory, "unicycle")
    nx = 3
    from tests.test_torch_rollout_cost_value_host import (
        _roll_lib,
        _rollout_cost,
    )

    roll = _roll_lib(tmp_path_factory, "unicycle", ocp, nx, 2)
    T, stages = 40, (0, 1, 20, 39, 40, 43)
    inside = torch.tensor([s < T for s in stages])
    jocp = j_unicycle.make_ocp(DT)
    for dtype in (torch.float64, torch.float32):
        u, x0 = disc_batch(T, stages, dtype)
        bp = torch.full((len(stages),), 0.05, dtype=dtype)
        xs, xT = tf.rollout_plain(ocp, u, x0)
        x = tf.lanes_first(xs, xT)
        ub = u.permute(2, 0, 1)
        # JAX's verdict on the same trajectories.
        j_mc = np.asarray(jax.vmap(lambda xx, uu: jnp.max(jax.vmap(
            jocp.constraints)(xx[:-1], uu)))(x.double().numpy(),
                                            ub.double().numpy()))
        j_cost = np.asarray(jax.vmap(jocp.total_cost, (0, 0, None))(
            x.double().numpy(), ub.double().numpy(), 0.05))
        np.testing.assert_array_equal(j_mc > 0, inside.numpy())
        np.testing.assert_array_equal(np.isnan(j_cost), inside.numpy())
        # The forward sweep on zero gains, and its plain counterpart.
        Kk = torch.zeros((T, (1 + nx) * 2, len(stages)), dtype=dtype)
        tu, tx, txT, nc, mc, cun = _fwd(lib, xs, u, xT, bp, Kk)
        ref_mc = ocp.constraints(x[:, :-1], ub).flatten(1).amax(1)
        ref_nc = ocp.total_cost(x, ub, bp)
        assert torch.equal(tu, u) and torch.equal(tx, xs) and \
            torch.equal(txT, xT)
        assert torch.equal(mc > 0, inside) and torch.equal(ref_mc > 0, inside)
        assert torch.equal(torch.isnan(nc), inside)
        assert torch.equal(torch.isnan(ref_nc), inside)
        tol = TOL if dtype == torch.float64 else 1e-5
        for g, r in ((mc, ref_mc), (nc[~inside], ref_nc[~inside]),
                     (cun, tf._cu_sq(ocp, x, ub, bp))):
            assert float((g - r).abs().max()) <= tol * float(r.abs().max())
        # The rollout cost from the lanes' initial states.
        got = _rollout_cost(roll, u, x0, bp)
        ref = tf.rollout_cost_plain(ocp, u, x0, bp)
        assert torch.equal(torch.isnan(got[2]), inside)
        assert torch.equal(torch.isnan(ref[2]), inside)
        for k in (0, 1, 3):
            assert float((got[k] - ref[k]).abs().max()) <= tol * float(
                ref[k].abs().max()), k
        fin = ~inside
        assert float((got[2][fin] - ref[2][fin]).abs().max()) <= tol * float(
            ref[2][fin].abs().max())
