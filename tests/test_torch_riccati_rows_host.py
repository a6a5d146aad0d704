"""The cooperative Riccati step (``csrc/riccati_rows.h``) and the two group
schedules that run it, the sequential trial (``csrc/seq_trial.h``) and the
fused backward sweep (``csrc/fused_bwd.h``), built with the host C++
compiler and held to the plain versions on the CPU.

The headers hold the CUDA kernels' per-lane phases and the schedules that
order them; their host executors step the G lanes of each scenario's group
through every step in turn, every group of a block in turn (those past B
included, on scenario B - 1's data, writing nothing), with the block's
shared memory filled with NaN first.  Here they are compiled with ``g++``
and held

* in float64 at 1e-12 of scale with equal ``ok`` flags and pivots: the
  trial against ``seq_newton_trial_plain`` for every instantiated
  ``(nx, nu)``, T in {1, 2, 7, 33, 100} and B in {1, 3, 64}, on views that
  start one scalar past an aligned address and on an indefinite R at one
  stage of one lane; the fused backward sweep (the codegen's split of the
  stage program included) against the plain fused iteration, cartpole,
  pendulum, the quadrotor (nx=6, nu=2) and the unicycle (nx=3, nu=2), its gains through the closed-loop rollout they give; the
  split itself (post after pre is the stage program, to the bit);
* the launch rule (lanes per scenario, scenarios per block) against the
  headers' constants at B in {1, 3, 4096};
* in float32 against JAX: the trial against ``seq_newton_trial_batched(...,
  interpret=True)`` at ``tests/test_torch_seq_newton.py``'s tolerances, the
  fused backward sweep against ``fused_newton_iter_packed`` in interpret
  mode at ``tests/test_torch_fused_iter.py``'s.
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
from ipoc_tpu.ops.pallas.seq_newton_kernel import _pack_s
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    seq_newton_trial_batched as j_trial_kernel,
)
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops.codegen.scalarize import ELEMENTARY_CALLS as CALLS
from ipoc_tpu_torch.ops.cuda import seq_newton as sn
from ipoc_tpu_torch.ops.derivatives import compute_first_order

torch.set_num_threads(1)

TOL = 1e-12
HORIZONS = (1, 2, 7, 33, 100)
BATCHES = (1, 3, 64)

SEQ_SOURCE = r"""
#include <math.h>
#include <vector>
#include "seq_trial.h"

template <typename scalar_t, int NX, int NU>
int run(const void* const* in, void* const* out, int B, int T) {
  using Tr = ipoc::SeqTrial<scalar_t, NX, NU>;
  std::vector<scalar_t> sh(Tr::kShared, scalar_t(NAN));
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  ipoc::seq_trial_host<scalar_t, NX, NU>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), O(0), O(1), O(2), O(3),
      static_cast<bool*>(out[4]), B, T, sh.data());
  return 0;
}

template <typename scalar_t, int NX, int NU>
void geometry(int* out) {
  using Tr = ipoc::SeqTrial<scalar_t, NX, NU>;
  out[0] = Tr::G;
  out[1] = Tr::S;
  out[2] = Tr::kShared * static_cast<int>(sizeof(scalar_t));
}

extern "C" int host_seq_trial(int dtype, int nx, int nu, const void* const* in,
                              void* const* out, int B, int T) {
  if (dtype == 1 && nx == 2 && nu == 1) return run<double, 2, 1>(in, out, B, T);
  if (dtype == 1 && nx == 4 && nu == 1) return run<double, 4, 1>(in, out, B, T);
  if (dtype == 1 && nx == 3 && nu == 2) return run<double, 3, 2>(in, out, B, T);
  if (dtype == 1 && nx == 6 && nu == 2) return run<double, 6, 2>(in, out, B, T);
  if (dtype == 0 && nx == 4 && nu == 1) return run<float, 4, 1>(in, out, B, T);
  return -1;
}

extern "C" int host_seq_geometry(int dtype, int nx, int nu, int* out) {
  if (dtype == 1 && nx == 2 && nu == 1) return geometry<double, 2, 1>(out), 0;
  if (dtype == 1 && nx == 4 && nu == 1) return geometry<double, 4, 1>(out), 0;
  if (dtype == 1 && nx == 3 && nu == 2) return geometry<double, 3, 2>(out), 0;
  if (dtype == 0 && nx == 2 && nu == 1) return geometry<float, 2, 1>(out), 0;
  if (dtype == 0 && nx == 4 && nu == 1) return geometry<float, 4, 1>(out), 0;
  if (dtype == 0 && nx == 3 && nu == 2) return geometry<float, 3, 2>(out), 0;
  if (dtype == 0 && nx == 6 && nu == 2) return geometry<float, 6, 2>(out), 0;
  if (dtype == 1 && nx == 6 && nu == 2) return geometry<double, 6, 2>(out), 0;
  return -1;
}
"""


def _compile(tmp_path_factory, name, source, bind):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp(name)
    src, so = out / f"{name}.cpp", out / f"{name}.so"
    src.write_text(source)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    bind(lib)
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


@pytest.fixture(scope="module")
def host_seq(tmp_path_factory):
    """seq_trial.h compiled with the host C++ compiler (a few seconds)."""
    p, i = ctypes.c_void_p, ctypes.c_int

    def bind(lib):
        lib.host_seq_trial.argtypes = [i, i, i, p, p, i, i]
        lib.host_seq_trial.restype = i
        lib.host_seq_geometry.argtypes = [i, i, i, p]
        lib.host_seq_geometry.restype = i

    return _compile(tmp_path_factory, "seq_trial_host", SEQ_SOURCE, bind)


def _host_trial(lib, args):
    """The host build's trial on CPU tensors: ``(du, dx, pred, ok)``."""
    ru, Q, R, M, fx, fu, XT = args
    B, T, nx, nu = fu.shape
    kw = dict(dtype=fu.dtype)
    outs = (torch.full((B, T, (1 + nx) * nu), float("nan"), **kw),
            torch.full((B, T, nu), float("nan"), **kw),
            torch.full((B, T + 1, nx), float("nan"), **kw),
            torch.full((B,), float("nan"), **kw),
            torch.zeros((B,), dtype=torch.bool))
    status = lib.host_seq_trial(cuda.dtype_code(fu.dtype), nx, nu,
                                _ptrs(args), _ptrs(outs), B, T)
    assert status == 0
    return outs[1:]


def _random(B, T, nx, nu, seed, dtype=torch.float64):
    """Random well-posed trial data (the card tests' recipe): Q, R and XT
    positive definite."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: 0.3 * rng.normal(size=s)  # noqa: E731
    A = rnd(B, T, nx, nx)
    Q = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(nx)
    Br = rnd(B, T, nu, nu)
    R = Br @ np.swapaxes(Br, -1, -2) + 2 * np.eye(nu)
    Xa = rnd(B, nx, nx)
    XT = Xa @ np.swapaxes(Xa, -1, -2) + np.eye(nx)
    t = lambda a: torch.tensor(a, dtype=dtype).contiguous()  # noqa: E731
    return tuple(t(a) for a in (rnd(B, T, nu), Q, R, 0.1 * rnd(B, T, nx, nu),
                                rnd(B, T, nx, nx), rnd(B, T, nx, nu), XT))


def _offset_views(args):
    """Each input as a contiguous view that starts one scalar past its
    storage's start (so off every 16-byte boundary)."""
    out = []
    for a in args:
        buf = torch.empty(a.numel() + 1, dtype=a.dtype)
        v = buf[1:].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 != 0 and v.is_contiguous()
        out.append(v)
    return tuple(out)


def _assert_close(got, ref, tol, label):
    du, dx, pred, ok = got
    du_p, dx_p, pred_p, ok_p = ref
    assert torch.equal(ok, ok_p), label
    keep = ok_p
    scale = float(du_p[keep].abs().max())
    assert float((du - du_p)[keep].abs().max()) <= tol * scale, label
    assert float((dx - dx_p)[keep].abs().max()) <= tol * scale, label
    assert float(((pred - pred_p).abs() / pred_p.abs())[keep].max()) <= tol, label


@pytest.mark.parametrize("T", HORIZONS)
@pytest.mark.parametrize("shape", sn.TRIAL_SHAPES,
                         ids=lambda s: f"nx{s[0]}nu{s[1]}")
def test_host_seq_trial_matches_plain(host_seq, shape, T):
    """Every instantiated shape and B in {1, 3, 64} (3: a block's groups
    past B run and write nothing), float64 at 1e-12 of scale; and the same
    data through views off a 16-byte boundary (the ring's one-scalar
    copies) at B = 3."""
    for B in BATCHES:
        args = _random(B, T, *shape, seed=100 * T + B)
        ref = sn.seq_newton_trial_plain(*args)
        assert bool(ref[3].all())
        _assert_close(_host_trial(host_seq, args), ref, TOL,
                      f"{shape} T={T} B={B}")
        if B == 3:
            _assert_close(_host_trial(host_seq, _offset_views(args)), ref,
                          TOL, f"{shape} T={T} B={B} offset views")


def test_host_seq_trial_indefinite_lane(host_seq):
    """An indefinite R at one stage of lane 1 fails that lane only; the
    other lanes hold to the plain version."""
    args = list(_random(3, 33, 4, 1, seed=7))
    args[2] = args[2].clone()
    args[2][1, 17] = -1.0
    ref = sn.seq_newton_trial_plain(*args)
    assert ref[3].tolist() == [True, False, True]
    _assert_close(_host_trial(host_seq, args), ref, TOL, "indefinite R")


@pytest.mark.parametrize("B", [1, 3, 4096])
def test_launch_rule(host_seq, B):
    """The rule (``row_lanes``, ``row_geometry``) against the headers'
    constants: G lanes per scenario, 32 / G scenarios per one-warp block;
    the shared memory per block that the source notes state."""
    shared = {(0, 4, 1): 18560, (1, 4, 1): 37120, (0, 3, 2): 16256,
              (1, 3, 2): 32512, (0, 2, 1): 13184, (1, 2, 1): 25856,
              (0, 6, 2): 22400, (1, 6, 2): 44800}
    for (code, nx, nu), bytes_ in shared.items():
        out = (ctypes.c_int * 3)()
        assert host_seq.host_seq_geometry(code, nx, nu, out) == 0
        geo = sn.row_geometry(nx, B)
        assert geo["lanes_per_scenario"] == out[0] == {2: 2, 3: 4, 4: 4, 6: 8}[nx]
        assert geo["scenarios_per_block"] == out[1] == 32 // out[0]
        assert geo["threads_per_block"] == 32
        assert geo["blocks"] == -(-B // out[1])
        assert out[2] == bytes_, (code, nx, nu)
    assert sn.row_geometry(4, B)["blocks"] == {1: 1, 3: 1, 4096: 512}[B]


def test_host_seq_trial_matches_jax_kernel_interpret(host_seq):
    """Float32, cartpole-shaped (4, 1) random data at T=12, B=3, against
    JAX's kernel in interpret mode (``tests/test_torch_seq_newton.py``'s
    tolerances: du, dx 2e-5 of scale; pred rtol 1e-4; equal ok)."""
    args = _random(3, 12, 4, 1, seed=12, dtype=torch.float32)
    with jax.enable_x64(False):
        ref = j_trial_kernel(*(jnp.asarray(a.numpy()) for a in args),
                             interpret=True)
    du_j, dx_j, pred_j, ok_j = (np.asarray(r) for r in ref)
    du, dx, pred, ok = (g.numpy() for g in _host_trial(host_seq, args))
    scale = float(np.abs(du_j).max())
    np.testing.assert_allclose(du, du_j, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(dx, dx_j, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(pred, pred_j, rtol=1e-4)
    np.testing.assert_array_equal(ok, ok_j)
    assert ok.all()


# --- the fused backward sweep (csrc/fused_bwd.h) ---------------------------

# model: (port module, nx, nu, the controls' centre inside the box)
MODELS = {"cartpole": (t_cartpole, 4, 1, 0.0), "pendulum": (t_pendulum, 2, 1, 0.0),
          "quadrotor": (t_quadrotor, 6, 2, t_quadrotor.HOVER),
          "unicycle": (t_unicycle, 3, 2, 0.3)}
FT = 12  # the models' horizon (dt = 1 / FT)


def _fused_source(ocp, nx, nu=1):
    return ('#include <math.h>\n#include <vector>\n#include "fused_bwd.h"\n'
            + tf.model_struct(ocp, nx, nu) + r"""
template <typename scalar_t>
int run(const void* const* in, void* const* out, int B, int T) {
  using F = ipoc::FusedBwd<Model, scalar_t>;
  std::vector<scalar_t> sh(F::kShared, scalar_t(NAN));
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  ipoc::fused_bwd_host<Model, scalar_t>(I(0), I(1), I(2), I(3), I(4), O(0),
                                        O(1), O(2), O(3), O(4), B, T, sh.data());
  return 0;
}

extern "C" int host_fused_bwd(int dtype, const void* const* in,
                              void* const* out, int B, int T) {
  if (dtype == 0) return run<float>(in, out, B, T);
  if (dtype == 1) return run<double>(in, out, B, T);
  return -1;
}
""")


@pytest.fixture(scope="module", params=list(MODELS))
def host_fused(request, tmp_path_factory):
    """One model's generated struct and fused_bwd.h compiled with the host
    C++ compiler; returns (model, ocp, nx, the loaded library)."""
    model, nx, nu, _ = MODELS[request.param]
    ocp = model.make_ocp(1.0 / FT)
    p, i = ctypes.c_void_p, ctypes.c_int

    def bind(lib):
        lib.host_fused_bwd.argtypes = [i, p, p, i, i]
        lib.host_fused_bwd.restype = i

    lib = _compile(tmp_path_factory, f"fused_bwd_{request.param}",
                   _fused_source(ocp, nx, nu), bind)
    return model, ocp, nx, lib


def _host_fused_bwd(lib, xs, u, xT, bp, reg):
    """The host build's backward sweep: ``(Kk, cost, dv, piv, hu)``."""
    T, nx, B = xs.shape
    nu = u.shape[1]
    kw = dict(dtype=xs.dtype)
    outs = [torch.full((T, (1 + nx) * nu, B), float("nan"), **kw)] + [
        torch.full((B,), float("nan"), **kw) for _ in range(4)]
    ins = (xs, u, xT, bp, reg)
    assert lib.host_fused_bwd(cuda.dtype_code(xs.dtype), _ptrs(ins),
                              _ptrs(outs), B, T) == 0
    return outs


def _lane_inputs(model, ocp, nx, B, T, seed, dtype=torch.float64):
    """Packed lane inputs at a random warm start: the open-loop trajectory
    of numpy-made controls, a per-lane barrier parameter and Levenberg
    parameter."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    _, _, nu, centre = next(m for m in MODELS.values() if m[0] is model)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    u = t(centre + 0.1 * rng.normal(size=(T, nu, B)))
    x0b = t(x0[:, None] + 0.01 * rng.normal(size=(nx, B)))
    bp = t(rng.uniform(0.01, 0.2, size=B))
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0b, bp)
    reg = 100.0 * torch.sqrt(cunsq)
    return xs, xT, u, bp, reg


def _rollout_gains(ocp, xs, xT, u, bp, Kk):
    """The trial point the gains Kk give: du = k + K dx, dx+ = fx dx +
    fu du from dx0 = 0 -> ``(tu, tx, txT)`` batch-last."""
    T, nx, B = xs.shape
    nu = u.shape[1]
    x = tf.lanes_first(xs, xT)
    ub = u.permute(2, 0, 1)
    d = compute_first_order(ocp, x, ub, bp)
    dx = torch.zeros((B, nx), dtype=xs.dtype)
    dus, dxs = [], [dx]
    for t in range(T):
        k = Kk[t, :nu].T
        K = Kk[t, nu:].T.reshape(B, nu, nx)
        du = k + (K @ dx[..., None])[..., 0]
        dx = (d.fx[:, t] @ dx[..., None])[..., 0] + (d.fu[:, t] @ du[..., None])[..., 0]
        dus.append(du)
        dxs.append(dx)
    tu = u + torch.stack(dus).permute(0, 2, 1)
    tx_all = x + torch.stack(dxs, 1)
    tx, txT = tf.lanes_last(tx_all)
    return tu, tx, txT


def test_backward_halves_are_the_stage_program(host_fused):
    """The codegen's split of stage_bwd at the costate: post(pre(x, u, bp),
    lam) equals stage_bwd(x, u, bp, lam) to the bit on every output (torch
    evaluators of the DAGs, float64); the handoff values are the inputs and
    the elementary-function calls that post reads (10 per stage at
    cartpole, 8 at pendulum, 15 at the quadrotor, 13 at the unicycle;
    pre computes 10 operations at cartpole and pendulum, 14 at the
    quadrotor, 24 at the unicycle: its five barrier logs among them), and
    post computes every operation of the program but those calls
    and what only they read."""
    _, ocp, nx, _ = host_fused
    nu = {4: 1, 2: 1, 6: 2, 3: 2}[nx]
    prog = tf.scalar_programs(ocp, nx, nu)["stage_bwd"]
    pre, post = tf.backward_halves(ocp, nx, nu)
    assert pre.out_shapes == [({4: 10, 2: 8, 6: 15, 3: 13}[nx],)]
    assert {h.op for h in pre.outs[0]} <= CALLS | {"input"}
    assert {nd.op for nd in post.order} & CALLS == set()
    assert pre.stats["ops"] == {4: 10, 2: 10, 6: 14, 3: 24}[nx]
    assert post.stats["ops"] >= prog.stats["ops"] - pre.stats["ops"]
    gen = torch.Generator().manual_seed(nx)
    args = [0.1 + 0.4 * torch.rand(tuple(s) + (16,), generator=gen,
                                   dtype=torch.float64)
            for s in prog.in_shapes]
    got = post.evaluate(pre.evaluate(*args[:3])[0], args[3])
    for g, r in zip(got, prog.evaluate(*args)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("T", [1, 7, FT])
def test_host_fused_bwd_matches_plain(host_fused, T):
    """Float64 at 1e-12 of scale, B in {1, 3, 37}: cost, dV, the pivot and
    max|ru| against the plain fused iteration, and the trial point the
    gains give against its tu, tx, txT."""
    model, ocp, nx, lib = host_fused
    names = ("tu", "tx", "txT", "cost", "nc", "mc", "dv", "piv", "hu", "cun")
    for B in (1, 3, 37):
        xs, xT, u, bp, reg = _lane_inputs(model, ocp, nx, B, T, seed=T + B)
        ref = dict(zip(names, tf.fused_newton_iter_plain(ocp, xs, xT, u, bp,
                                                         reg)))
        Kk, cost, dv, piv, hu = _host_fused_bwd(lib, xs, u, xT, bp, reg)
        got = dict(zip(("cost", "dv", "piv", "hu"), (cost, dv, piv, hu)))
        got.update(zip(("tu", "tx", "txT"),
                       _rollout_gains(ocp, xs, xT, u, bp, Kk)))
        assert bool((ref["piv"] > 0).all())
        for k, g in got.items():
            r = ref[k]
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= TOL * scale, (k, T, B)


@pytest.fixture(scope="module")
def pendulum_packed():
    """Pendulum lanes, float32, in the port's and JAX's packed layouts
    (128 lanes, one sublane), as ``tests/test_torch_fused_iter.py`` makes
    them."""
    JB, JT = 128, 6
    jocp, tocp = j_pendulum.make_ocp(1.0 / JT), t_pendulum.make_ocp(1.0 / JT)
    rng = np.random.default_rng(3)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u = (0.1 * rng.normal(size=(JB, JT, 1))).astype(np.float32)
    x0b = (x0 + 0.02 * rng.normal(size=(JB, 2))).astype(np.float32)
    bp = np.full((JB,), 0.1, np.float32)
    ut = torch.as_tensor(np.ascontiguousarray(np.moveaxis(u, 0, -1)))
    xs, xT, _, _ = tf.rollout_cost_plain(tocp, ut, torch.as_tensor(x0b.T.copy()),
                                         torch.as_tensor(bp))
    set_pallas_scans("on")
    yield jocp, tocp, u, ut, bp, xs, xT
    set_pallas_scans("auto")


def test_host_fused_bwd_matches_jax_kernel_f32(pendulum_packed, tmp_path_factory):
    """Float32 against JAX's two-launch ``fused_newton_iter_packed``
    (interpret mode, pendulum, T=6, 128 lanes): cost, dV, the pivot and
    max|ru| at ``tests/test_torch_fused_iter.py``'s tolerance (rtol and atol
    5e-5)."""
    jocp, tocp, u, ut, bp, xs, xT = pendulum_packed
    JB, S = u.shape[0], 1
    p, i = ctypes.c_void_p, ctypes.c_int

    def bind(lib):
        lib.host_fused_bwd.argtypes = [i, p, p, i, i]
        lib.host_fused_bwd.restype = i

    lib = _compile(tmp_path_factory, "fused_bwd_pendulum_t6",
                   _fused_source(tocp, 2), bind)
    reg = np.full((JB,), 3.0, np.float32)
    xs_b, xT_b = xs.permute(2, 0, 1).numpy(), xT.T.numpy()
    pk = lambda a: (_pack_s(jnp.asarray(a), JB, S) if a.ndim == 3  # noqa: E731
                    else jf._pack_vec(jnp.asarray(a), JB, S))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.fused_newton_iter_packed(
            jocp, pk(xs_b), pk(xT_b), pk(u), pk(bp[:, None]),
            pk(reg[:, None]), with_cu=True, merged=False,
            interpret=True))()
    _, cost, dv, piv, hu = _host_fused_bwd(
        lib, xs, ut, xT, torch.as_tensor(bp), torch.as_tensor(reg))
    for name, g, r in (("cost", cost, ref[3]), ("dv", dv, ref[6]),
                       ("piv", piv, ref[7]), ("hu", hu, ref[8])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1)[:JB],
                                   rtol=5e-5, atol=5e-5, err_msg=name)
