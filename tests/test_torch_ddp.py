"""The port's DDP trial against the JAX package, float64 on the CPU.

* ``closed_loop_rollout``, the tensor-form ``compute_derivatives``,
  ``ddp_bwd_core``/``ddp_bwd_pass`` and the batched plain DDP trial
  (``fused_newton_iter_plain(..., ddp=True)``) equal JAX's
  (``closed_loop_rollout``, ``compute_derivatives``, ``ddp_bwd_core`` and
  ``_fused_ddp_reference``, vmapped) to 1e-12 of each output's scale; the
  port's Hamiltonian form of the Newton stage data equals the tensor form
  (``compute_lqr_params``) to 1e-12.
* The DDP stage programs (``_stage_ddp_fwd_fn``, ``_term_ddp_fwd_fn``):
  their scalarized DAGs equal ``torch.func`` and JAX's programs, and the
  emitted C, compiled with the host C++ compiler, equals ``torch.func``
  (``tests/test_torch_codegen.py``'s pattern and tolerance, 1e-12).
* ``solve_stream`` with ``FAST_CONFIG.replace(globalization="single",
  newton_impl="ddp")`` (the port's packed stream on its mega executor)
  equals JAX ``solve_stream`` (its unpacked DDP stream off the TPU):
  equal iterations on every scenario and equal steps, controls within 1e-8
  (``tests/test_ddp_stream.py::test_ddp_stream_batch``'s pool shape).

Inputs are made with numpy from a seed and handed to both packages.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import ipoc_tpu
from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops import derivatives as jd
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.solvers import ip_ddp as j_ddp
from ipoc_tpu.solvers.stream import solve_stream as j_solve_stream
from ipoc_tpu.utils import integrators as ji
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import derivatives as td
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.solvers import ip_ddp as t_ddp
from ipoc_tpu_torch.solvers.stream import solve_stream
from ipoc_tpu_torch.utils import integrators as ti
from tests.test_torch_codegen import _close, _host_source, _inputs

torch.set_num_threads(1)

RTOL = 1e-12
MODELS = {"pendulum": (j_pendulum, t_pendulum, 0),
          "cartpole": (j_cartpole, t_cartpole, 1)}
B, T = 5, 12


def _scaled(got, ref, name, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = np.abs(ref).max() + 1e-300
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    """A warm start of one model: trajectories, controls, bp, regs."""
    jm, tm, _ = MODELS[request.param]
    rng = np.random.default_rng(11)
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u = 0.1 * rng.normal(size=(B, T, 1))
    x0b = x0 + 0.01 * rng.normal(size=(B, x0.shape[0]))
    jocp, tocp = jm.make_ocp(1.0 / T), tm.make_ocp(1.0 / T)
    x = np.asarray(jax.vmap(lambda uu, xx: ji.rollout(jocp.dynamics, uu, xx))(
        jnp.asarray(u), jnp.asarray(x0b)))
    bp = rng.uniform(0.01, 0.1, size=B)
    reg = rng.uniform(0.1, 2.0, size=B)
    return request.param, jocp, tocp, x, u, bp, reg


def test_closed_loop_rollout_matches_jax(case):
    _, jocp, tocp, x, u, _, _ = case
    rng = np.random.default_rng(5)
    nx = x.shape[-1]
    gain = 0.3 * rng.normal(size=(B, T, 1, nx))
    ff = 0.05 * rng.normal(size=(B, T, 1))
    xs_j, us_j = jax.vmap(
        lambda g, k, xx, uu: ji.closed_loop_rollout(jocp.dynamics, g, k, xx,
                                                    uu))(
        *(jnp.asarray(a) for a in (gain, ff, x, u)))
    xs_t, us_t = ti.closed_loop_rollout(
        tocp.dynamics, *(torch.as_tensor(a) for a in (gain, ff, x, u)))
    _scaled(xs_t.numpy(), xs_j, "states")
    _scaled(us_t.numpy(), us_j, "controls")


def test_compute_derivatives_matches_jax(case):
    name, jocp, tocp, x, u, bp, _ = case
    dj = jax.vmap(lambda xx, uu, b: jd.compute_derivatives(jocp, xx, uu, b))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(bp))
    dt = td.compute_derivatives(tocp, torch.as_tensor(x), torch.as_tensor(u),
                                torch.as_tensor(bp))
    for field in dj._fields:
        _scaled(getattr(dt, field).numpy(), getattr(dj, field),
                f"{name}.{field}")


def test_hamiltonian_form_equals_tensor_form(case):
    """The Newton stage data two ways: one Hessian of the stage
    Hamiltonian per stage against the tensor form contracted with the
    costates."""
    name, _, tocp, x, u, bp, _ = case
    xt, ut, bpt = (torch.as_tensor(a) for a in (x, u, bp))
    lam = torch.as_tensor(np.random.default_rng(3).normal(size=x.shape))
    ham = td.compute_hamiltonian_lqr(tocp, xt, ut, lam, bpt)
    ten = td.compute_lqr_params(lam, td.compute_derivatives(tocp, xt, ut,
                                                            bpt))
    for field in ham._fields:
        _scaled(getattr(ham, field).numpy(), getattr(ten, field).numpy(),
                f"{name}.{field}")


def test_ddp_backward_pass_matches_jax(case):
    name, jocp, tocp, x, u, bp, reg = case
    dj = jax.vmap(lambda xx, uu, b: jd.compute_derivatives(jocp, xx, uu, b))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(bp))
    dt = td.compute_derivatives(tocp, torch.as_tensor(x), torch.as_tensor(u),
                                torch.as_tensor(bp))
    ref = jax.vmap(lambda xT, d, r: j_ddp.ddp_bwd_core(jocp.final_cost, xT, d,
                                                       r))(
        jnp.asarray(x[:, -1]), dj, jnp.asarray(reg))
    got = t_ddp.ddp_bwd_core(tocp.final_cost, torch.as_tensor(x[:, -1]), dt,
                             torch.as_tensor(reg))
    for i, what in enumerate(("ffgain", "gain", "pred", "feasible", "Qu")):
        if what == "feasible":
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
            assert bool(got[i].all())
        else:
            _scaled(got[i].numpy(), ref[i], f"{name}.{what}")
    ref = jax.vmap(lambda xT, d, r: j_ddp.ddp_bwd_pass(jocp.final_cost, xT, d,
                                                       r, 1e-6))(
        jnp.asarray(x[:, -1]), dj, jnp.asarray(reg))
    got = t_ddp.ddp_bwd_pass(tocp.final_cost, torch.as_tensor(x[:, -1]), dt,
                             torch.as_tensor(reg), 1e-6)
    _scaled(got[0].numpy(), ref[0], f"{name} ddp_bwd_pass ffgain")
    _scaled(got[2].numpy(), ref[2], f"{name} ddp_bwd_pass pred")


def test_plain_ddp_trial_matches_jax(case):
    """The batched plain DDP trial (the merged kernel's plain version)
    against JAX ``_fused_ddp_reference``; the port adds the minimum pivot
    (positive on these PD stages) and sum ||cu||^2 at the trial point."""
    name, jocp, tocp, x, u, bp, reg = case
    ref = jax.vmap(lambda xx, uu, b, r: jf._fused_ddp_reference(
        jocp, xx, uu, b, r))(*(jnp.asarray(a) for a in (x, u, bp, reg)))
    got = tf._fused_ddp_reference(tocp, *(torch.as_tensor(a)
                                          for a in (x, u, bp, reg)))
    names = ("temp_x", "temp_u", "cost", "new_cost_raw", "max_c", "pred",
             "ok", "hu")
    for i, what in enumerate(names):
        if what == "ok":
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
        else:
            _scaled(got[i].numpy(), ref[i], f"{name}.{what}")
    piv, cun = got[8], got[9]
    assert bool((piv > 0).all())
    jcun = jax.vmap(lambda xx, uu, b: jnp.sum(jax.vmap(
        lambda a, c: jax.grad(jocp.stage_cost, 1)(a, c, b))(xx[:-1], uu)
        ** 2))(ref[0], ref[1], jnp.asarray(bp))
    _scaled(cun.numpy(), jcun, f"{name}.cun")
    # The packed contract (batch-last) gives the same numbers.
    xs = torch.as_tensor(x[:, :-1]).permute(1, 2, 0).contiguous()
    xT = torch.as_tensor(x[:, -1]).T.contiguous()
    up = torch.as_tensor(u).permute(1, 2, 0).contiguous()
    packed = tf.fused_newton_iter_packed(
        tocp, xs, xT, up, torch.as_tensor(bp), torch.as_tensor(reg), ddp=True)
    _scaled(packed[0].permute(2, 0, 1).numpy(), ref[1], f"{name} packed tu")
    _scaled(packed[6].numpy(), ref[5], f"{name} packed pred")


@pytest.mark.parametrize("model", list(MODELS))
def test_ddp_stage_programs_match_torch_func_and_jax(model):
    jm, tm, angle = MODELS[model]
    nx = 4 if model == "cartpole" else 2
    jocp, tocp = jm.make_ocp(0.01), tm.make_ocp(0.01)
    progs = tf.scalar_programs(tocp, nx, 1)
    fns = tf.stage_programs(tocp, nx, 1)
    jax_fns = {"stage_ddp_fwd": jf._stage_ddp_fwd_fn(jocp, nx, 1,
                                                     with_cu=True),
               "term_ddp_fwd": jf._term_ddp_fwd_fn(jocp)}
    for name, jfn in jax_fns.items():
        fn, shapes = fns[name]
        args = _inputs(shapes, nx, angle, seed=len(name))
        got = progs[name].evaluate(*(torch.as_tensor(a).movedim(0, -1)
                                     for a in args))
        ref = vmap(fn)(*(torch.as_tensor(a) for a in args))
        jref = jax.vmap(jfn)(*(jnp.asarray(a) for a in args))
        assert len(got) == len(ref) == len(jref)
        for i, (g, r, j) in enumerate(zip(got, ref, jref)):
            g = g.movedim(-1, 0).numpy()
            _close(g, r.numpy(), f"{model}.{name}[{i}] vs torch.func")
            _close(g, np.asarray(j), f"{model}.{name}[{i}] vs JAX")


def test_ddp_stage_programs_emitted_c(tmp_path):
    """The DDP programs' emitted C, compiled with the host compiler and
    called through ctypes in float64, equals torch.func."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    tocp = t_cartpole.make_ocp(0.01)
    names = ("stage_ddp_fwd", "term_ddp_fwd")
    progs = {n: tf.scalar_programs(tocp, 4, 1)[n] for n in names}
    src, so = tmp_path / "ddp.cpp", tmp_path / "ddp.so"
    src.write_text(_host_source(progs))
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    fns = tf.stage_programs(tocp, 4, 1)
    for name, prog in progs.items():
        fn, shapes = fns[name]
        args = [torch.as_tensor(a) for a in _inputs(shapes, 4, 1, seed=3)]
        ref = vmap(fn)(*args)
        for b in range(args[0].shape[0]):
            ins = [a[b].contiguous() for a in args]
            outs = [torch.empty(s, dtype=torch.float64)
                    for s in prog.out_shapes]
            getattr(lib, f"host_{name}")(
                (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
                (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs)))
            for i, (o, r) in enumerate(zip(outs, ref)):
                _close(o.numpy(), r[b].reshape(o.shape).numpy(),
                       f"{name}[{i}] lane {b}")


def test_ddp_stream_matches_jax():
    """solve_stream with the DDP evaluator: a pendulum pool of 6 scenarios
    through 3 lanes, T=50, as tests/test_ddp_stream.py runs it."""
    cfg = ipoc_tpu.FAST_CONFIG.replace(globalization="single",
                                       newton_impl="ddp")
    Tn = 50
    rng = np.random.default_rng(3)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u0 = 0.1 * rng.normal(size=(6, Tn, 1))
    x0b = x0 + 0.05 * rng.normal(size=(6, 2))
    ref = jax.jit(lambda u, x: j_solve_stream(
        j_pendulum.make_ocp(1.0 / Tn), u, x, cfg, lanes=3))(
        jnp.asarray(u0), jnp.asarray(x0b))
    cuda.reset_launches()
    got = solve_stream(t_pendulum.make_ocp(1.0 / Tn),
                       *pool_from_numpy(u0, x0b), config_from_jax(cfg),
                       lanes=3)
    assert cuda.launches == dict.fromkeys(cuda.launches, 0)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert got.steps == int(ref.steps)
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(ref.controls),
                               rtol=0, atol=1e-8)
