"""The mega kernel's plain version (``ops/mega.py``) and the packed
stream's mega executor against the JAX package, on the CPU.

* ``mega_k_iterations`` (the plain version here: k masked
  ``packed_lane_iter`` steps) against JAX ``mega_k_iterations`` run as
  ``tests/test_mega_kernel.py`` runs it, the Pallas kernel in interpret
  mode: pendulum, B=1024, T=6, float32, k=4, ``max_newton_iters=2`` so
  that lanes roll over, Newton with the predictor on and off and DDP
  (``ddp=True``), at that test's tolerances: controls and states within
  2e-5, equal iterations, stage iterations and done flags, bp rtol 1e-6,
  rp rtol 1e-4, ``cun`` rtol 1e-4 / atol 1e-6, ``steps`` 4.  JAX's lanes
  are packed and unpacked with the JAX package's own helpers.
* float64: the plain version equals k port ``packed_lane_iter`` steps
  exactly, leaves inactive lanes exactly as they were, and counts as
  ``steps`` the iterations in which some active lane was unfinished when
  lanes finish inside the block.
* the plain version on the planar quadrotor (nx=6, nu=2), float64, Newton
  and DDP, against k JAX ``flat_lane_iter`` steps at
  ``tests/test_torch_packed_stream.py``'s bars (controls and trajectories
  within 1e-10, equal decisions).
* ``solve_stream`` under ``BATCH_CONFIG`` on the mega executor (the
  default) against the two-launch arm (``mega=False``) and against JAX
  ``solve_stream`` on ``tests/test_torch_packed_stream.py``'s pools: equal
  iterations on every scenario, equal steps, controls within 1e-8.
* The kernel's lane iteration (``csrc/lane.h``: trial, accept, convergence,
  transition, the ping-pong iterate and its copy-back), compiled with the
  host C++ compiler against the generated model source and run lane by
  lane with plain loads, against ``mega_k_iterations_plain`` in float64:
  pendulum, cartpole, the planar quadrotor (nx=6, nu=2) and the unicycle
  (nx=3, nu=2, the keep-out disc), B=8, T=12,
  two blocks of k=6 with the lane
  carried across them, ``max_newton_iters=2`` so that lanes roll over,
  Newton and DDP, predictor on and off.  Equal ``it``, ``stage_it``,
  ``done`` and ``steps``; every float field within 1e-12 of its scale
  (the same float64 program up to summation order and constant folding);
  lanes ending the block with the iterate in either buffer; an inactive
  lane left untouched.

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
from jax.experimental.pallas import tpu as pltpu

import ipoc_tpu
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.models import quadrotor as j_quadrotor
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.fused_iter_kernel import _pack_vec
from ipoc_tpu.ops.pallas.mega_kernel import mega_k_iterations as j_mega
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    LANES,
    _ceil_to,
    _pack_s,
    _unpack_s,
)
from ipoc_tpu.solvers.ip_newton import flat_lane_init as j_flat_lane_init
from ipoc_tpu.solvers.ip_newton import flat_lane_iter as j_flat_lane_iter
from ipoc_tpu.solvers.packed_stream import _pack_scal, _unpack_scal
from ipoc_tpu.solvers.packed_stream import packed_lane_init as j_lane_init
from ipoc_tpu.solvers.stream import solve_stream as j_solve_stream
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy, to_numpy
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops import mega
from ipoc_tpu_torch.solvers import packed_stream as ps
from ipoc_tpu_torch.solvers.stream import solve_stream
from tests.test_torch_packed_stream import MODELS, _pool

torch.set_num_threads(1)

B, T, S = 1024, 6, 8
CFG = ipoc_tpu.BATCH_CONFIG


@pytest.fixture(autouse=True)
def _restore_gate():
    yield
    set_pallas_scans("auto")


def _scenarios(n, Tn, dtype, seed=3):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    x0b = (x0 + 0.02 * rng.normal(size=(n, 2))).astype(dtype)
    u0 = (0.1 * rng.normal(size=(n, Tn, 1))).astype(dtype)
    return u0, x0b


def _port_lanes(tocp, u0, x0b, cfg):
    u, x0 = ps._pack(*pool_from_numpy(u0, x0b))
    n = u.shape[-1]
    full = lambda v: torch.full((n,), v, dtype=u.dtype)  # noqa: E731
    return ps.packed_lane_init(tocp, u, x0, full(cfg.bp_init),
                               full(cfg.reg_init), cfg)


def _jax_mega(cfg, u0, x0b, k, ddp):
    """JAX mega_k_iterations in interpret mode on packed lanes; returns
    the unpacked (u, xs, it, stage_it, bp, rp, cun, done, steps)."""
    ocp = j_pendulum.make_ocp(1.0 / T)
    Bp = _ceil_to(B, S * LANES)
    C = Bp // (S * LANES)
    f32 = jnp.float32
    set_pallas_scans("on")
    with pltpu.force_tpu_interpret_mode():
        lane = j_lane_init(
            ocp, _pack_s(jnp.asarray(u0), Bp, S),
            _pack_vec(jnp.asarray(x0b), Bp, S),
            _pack_scal(jnp.full((B,), cfg.bp_init, f32), Bp, C, S, LANES),
            _pack_scal(jnp.full((B,), cfg.reg_init, f32), Bp, C, S, LANES),
            cfg, interpret=True)
        active = jnp.ones_like(lane.done)
        (xs, _, u, _, cun, it, sit, rp, _, bp, done, steps) = jax.jit(
            lambda ln: j_mega(ocp, ln.xs, ln.xT, ln.u, ln.u_prev, ln.cun,
                              ln.it, ln.stage_it, ln.rp, ln.r_inc, ln.bp,
                              ln.bp0, ln.done, ln.x0, active, cfg, k,
                              interpret=True, ddp=ddp))(lane)
    scal = lambda a: np.asarray(_unpack_scal(a, B))  # noqa: E731
    return dict(u=np.asarray(_unpack_s(u, B, (1,))),
                xs=np.asarray(_unpack_s(xs, B, (2,))), it=scal(it),
                stage_it=scal(sit), bp=scal(bp), rp=scal(rp), cun=scal(cun),
                done=scal(done), steps=int(steps))


@pytest.mark.parametrize("predictor,ddp", [(True, False), (False, False),
                                           (True, True)],
                         ids=["newton-predictor", "newton", "ddp"])
def test_mega_plain_matches_jax_interpret(predictor, ddp):
    cfg = CFG.replace(max_newton_iters=2, stage_predictor=predictor,
                      newton_impl="ddp" if ddp else "fused")
    u0, x0b = _scenarios(B, T, np.float32)
    ref = _jax_mega(cfg, u0, x0b, 4, ddp)
    tcfg = config_from_jax(cfg)
    lane = _port_lanes(t_pendulum.make_ocp(1.0 / T), u0, x0b, tcfg)
    got, steps = mega.mega_k_iterations(
        t_pendulum.make_ocp(1.0 / T), lane, torch.ones(B, dtype=torch.bool),
        tcfg, 4, ddp)
    assert int(steps) == ref["steps"] == 4
    assert (ref["bp"] < cfg.bp_init).any(), "no lane rolled over"
    np.testing.assert_allclose(got.u.permute(2, 0, 1).numpy(), ref["u"],
                               atol=2e-5)
    np.testing.assert_allclose(got.xs.permute(2, 0, 1).numpy(), ref["xs"],
                               atol=2e-5)
    for field in ("it", "stage_it", "done"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      ref[field], err_msg=field)
    np.testing.assert_allclose(got.bp.numpy(), ref["bp"], rtol=1e-6)
    np.testing.assert_allclose(got.rp.numpy(), ref["rp"], rtol=1e-4)
    np.testing.assert_allclose(got.cun.numpy(), ref["cun"], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
def test_mega_plain_matches_jax_flat_nu2(ddp):
    """The planar quadrotor (nx=6, nu=2: the gains' (1 + nx) * nu rows, two
    controls a stage), float64: k=7 iterations of the plain version, two a
    barrier stage so that lanes roll over, the predictor on, against k
    JAX ``flat_lane_iter`` steps vmapped (the lane iteration that JAX's
    mega kernel is held to; interpret mode takes minutes at this shape):
    controls and trajectories within 1e-10, equal iterations, stage
    iterations and done flags, bp and rp within rtol 1e-14
    (``tests/test_torch_packed_stream.py``'s bars)."""
    Tq, Bq, k = 8, 6, 7
    cfg = CFG.replace(max_newton_iters=2,
                      newton_impl="ddp" if ddp else "fused")
    rng = np.random.default_rng(5)
    u0 = j_quadrotor.HOVER + 0.05 * rng.normal(size=(Bq, Tq, 2))
    x0b = 0.02 * rng.normal(size=(Bq, 6))
    jocp = j_quadrotor.make_ocp(1.0 / Tq)
    flat = jax.vmap(lambda u, x: j_flat_lane_init(jocp, u, x, cfg))(
        jnp.asarray(u0), jnp.asarray(x0b))
    step = jax.jit(jax.vmap(lambda ln: j_flat_lane_iter(jocp, ln, cfg,
                                                        ~ln.done)))
    for _ in range(k):
        flat = step(flat)
    tcfg = config_from_jax(cfg)
    tocp = t_quadrotor.make_ocp(1.0 / Tq)
    lane = _port_lanes(tocp, u0, x0b, tcfg)
    got, steps = mega.mega_k_iterations(
        tocp, lane, torch.ones(Bq, dtype=torch.bool), tcfg, k, ddp)
    assert int(steps) == k
    assert bool((got.bp < cfg.bp_init).any()), "no lane rolled over"
    np.testing.assert_allclose(got.u.permute(2, 0, 1).numpy(),
                               np.asarray(flat.u), rtol=0, atol=1e-10)
    x = torch.cat([got.xs, got.xT[None]]).permute(2, 0, 1).numpy()
    np.testing.assert_allclose(x, np.asarray(flat.x), rtol=0, atol=1e-10)
    for field in ("it", "stage_it", "done"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(flat, field)),
                                      err_msg=field)
    for field in ("bp", "rp"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(flat, field)),
                                   rtol=1e-14, err_msg=field)


@pytest.fixture(scope="module")
def lanes64():
    """Float64 pendulum lanes (B=16, T=8) and a config that rolls lanes
    over every second iteration."""
    cfg = config_from_jax(CFG.replace(max_newton_iters=2))
    tocp = t_pendulum.make_ocp(1.0 / 8)
    u0, x0b = _scenarios(16, 8, np.float64, seed=9)
    return tocp, cfg, _port_lanes(tocp, u0, x0b, cfg)


@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
def test_mega_plain_equals_packed_lane_iter_steps(lanes64, ddp):
    tocp, cfg, lane0 = lanes64
    cfg = cfg.replace(newton_impl="ddp" if ddp else "fused")
    active = torch.ones(16, dtype=torch.bool)
    got, steps = mega.mega_k_iterations(tocp, lane0, active, cfg, 5, ddp)
    ref = lane0
    for _ in range(5):
        ref = ps.packed_lane_iter(tocp, ref, cfg, active & ~ref.done)
    assert int(steps) == 5
    for name, a, b in zip(ps.PackedLane._fields, got, ref):
        assert torch.equal(a, b), name


def test_mega_leaves_inactive_lanes_untouched(lanes64):
    tocp, cfg, lane0 = lanes64
    active = torch.arange(16) % 3 != 0
    before = mega.clone_lane(lane0)
    got, _ = mega.mega_k_iterations(tocp, lane0, active, cfg, 5)
    full, _ = mega.mega_k_iterations(tocp, lane0, torch.ones_like(active),
                                     cfg, 5)
    for name, a, b, f in zip(ps.PackedLane._fields, got, before, full):
        assert torch.equal(a[..., ~active], b[..., ~active]), name
        assert torch.equal(a[..., active], f[..., active]), name
    assert bool((got.it[active] == 5).all())


def test_mega_steps_when_lanes_finish_inside_the_block(lanes64):
    """Lanes 0-7 run two barrier stages and lanes 8-15 one, so every lane
    finishes well inside k=64 and not all at once; lanes 0 and 1 are done
    before the block and lane 5 is inactive.  Steps is the most iterations
    any active lane ran."""
    tocp, cfg, lane0 = lanes64
    cfg = cfg.replace(bp_min=0.0041, max_newton_iters=3)
    bp = torch.where(torch.arange(16) < 8, lane0.bp, lane0.bp / 5)
    lane0 = lane0._replace(done=torch.arange(16) < 2, bp=bp, bp0=bp.clone())
    active = torch.arange(16) != 5
    got, steps = mega.mega_k_iterations(tocp, lane0, active, cfg, 64)
    ran = (got.it - lane0.it)[active]
    assert bool(got.done[active].all())
    assert int(ran[:2].max()) == 0 and int(got.it[5]) == 0
    assert len(set(ran[2:].tolist())) > 1, "every lane took as long"
    assert int(steps) == int(ran.max()) < 64


@pytest.fixture(scope="module", params=list(MODELS))
def solved(request):
    """One pool per model: the JAX stream, the port's mega executor (the
    default) and its two-launch arm."""
    jm, tm = MODELS[request.param]
    Tn = 16
    u0, x0b = _pool(jm, 24, Tn, seed=3, bad_lane=5)
    ref = jax.jit(lambda u, x: j_solve_stream(
        jm.make_ocp(1.0 / Tn), u, x, CFG, lanes=8, refill_every=4))(
        jnp.asarray(u0), jnp.asarray(x0b))
    tocp = tm.make_ocp(1.0 / Tn)
    cuda.reset_launches()
    got = solve_stream(tocp, *pool_from_numpy(u0, x0b), config_from_jax(CFG),
                       lanes=8, refill_every=4)
    two = ps.solve_stream_packed(tocp, *pool_from_numpy(u0, x0b),
                                 config_from_jax(CFG), lanes=8,
                                 refill_every=4, mega=False)
    assert cuda.launches == dict.fromkeys(cuda.launches, 0)
    return ref, to_numpy(got), to_numpy(two)


def test_mega_stream_matches_two_launch_arm_and_jax(solved):
    ref, got, two = solved
    for other, label in ((two, "two-launch arm"), (ref, "JAX")):
        np.testing.assert_array_equal(got.iterations,
                                      np.asarray(other.iterations),
                                      err_msg=label)
        assert got.steps == int(other.steps), label
        np.testing.assert_allclose(got.controls, np.asarray(other.controls),
                                   rtol=0, atol=1e-8, equal_nan=True,
                                   err_msg=label)


# --- the lane iteration's host build (csrc/lane.h) ---------------------------

# model: (port module, nx, nu, the controls' centre inside the box and
# their spread: wide enough at the quadrotor that some trials are rejected,
# so the blocks end with the iterate in both buffers)
HOST_MODELS = {"pendulum": (t_pendulum, 2, 1, 0.0, 0.1),
               "cartpole": (t_cartpole, 4, 1, 0.0, 0.1),
               "quadrotor": (t_quadrotor, 6, 2, t_quadrotor.HOVER, 1.0),
               "unicycle": (t_unicycle, 3, 2, 0.3, 0.8)}
HB, HT, HK = 8, 12, 6
INACTIVE = 3


def _host_mega_source(progs, nx, nu):
    """lane.h with the generated Model and an extern "C" float64 entry in
    the kernel's argument order (``ops/mega.py``), plus each lane's parity
    at the end."""
    lines = ['#include "lane.h"', "struct Model {",
             f"  static constexpr int NX = {nx};",
             f"  static constexpr int NU = {nu};"]
    lines += [p.c_source(indent="  ") for p in progs.values()]
    lines += [
        "};",
        'extern "C" void host_mega(int ddp, void* const* lane, '
        "void* const* ws, const double* cfg, int k, int B, int T, "
        "unsigned char* odd) {",
        "  const auto a = ipoc::mega_arrays<double>(lane, ws, B, T);",
        "  const auto c = ipoc::lane_scalars(cfg);",
        "  if (ddp) ipoc::mega_host<Model, double, true>(a, c, k, odd);",
        "  else ipoc::mega_host<Model, double, false>(a, c, k, odd);",
        "}"]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module", params=list(HOST_MODELS))
def host_lane(request, tmp_path_factory):
    """One model's generated source and lane.h compiled with the host C++
    compiler; returns (model module, ocp, the loaded library)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    model, nx, nu, centre, spread = HOST_MODELS[request.param]
    ocp = model.make_ocp(1.0 / HT)
    out = tmp_path_factory.mktemp(f"lane_{request.param}")
    src, so = out / "lane_host.cpp", out / "lane_host.so"
    src.write_text(_host_mega_source(tf.scalar_programs(ocp, nx, nu), nx, nu))
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_mega.argtypes = [i, p, p, p, i, i, i, p]
    lib.host_mega.restype = None
    return model, ocp, lib, nu, centre, spread


def _host_mega(lib, lane, active, cfg, k, ddp):
    """k iterations of the host build on ``lane`` in place; returns
    ``(steps, parity (B,) bool)``."""
    T, nx, B = lane.xs.shape
    ws = mega.mega_workspace(lane)
    steps = torch.zeros((1,), dtype=torch.int32)
    odd = torch.zeros((B,), dtype=torch.uint8)
    scalars = mega.lane_scalars(cfg)
    lib.host_mega(
        int(ddp),
        tf.pointers((lane.xs, lane.xT, lane.u, lane.u_prev, lane.cun,
                     lane.it, lane.stage_it, lane.rp, lane.r_inc, lane.bp,
                     lane.done, lane.x0, lane.bp0, active, steps)),
        tf.pointers(ws), (ctypes.c_double * len(scalars))(*scalars), k, B,
        T, odd.data_ptr())
    return int(steps[0]), odd.bool()


@pytest.mark.parametrize("ddp,predictor", [(False, True), (False, False),
                                           (True, True), (True, False)],
                         ids=["newton-predictor", "newton", "ddp-predictor",
                              "ddp"])
def test_lane_host_build_matches_plain(host_lane, ddp, predictor):
    model, ocp, lib, nu, centre, spread = host_lane
    nx = model.initial_state(torch.float64).shape[0]
    cfg = config_from_jax(CFG).replace(
        max_newton_iters=2, stage_predictor=predictor,
        newton_impl="ddp" if ddp else "fused")
    rng = np.random.default_rng(11)
    x0 = model.initial_state(torch.float64).numpy()
    u0 = centre + spread * rng.normal(size=(HB, HT, nu))
    x0b = x0 + 0.01 * rng.normal(size=(HB, nx))
    lane = _port_lanes(ocp, u0, x0b, cfg)
    active = torch.arange(HB) != INACTIVE
    ref = lane
    parities = torch.zeros(0, dtype=torch.bool)
    for block in range(2):
        before = mega.clone_lane(lane)
        ref, ref_steps = mega.mega_k_iterations_plain(ocp, ref, active, cfg,
                                                      HK, ddp)
        steps, odd = _host_mega(lib, lane, active, cfg, HK, ddp)
        assert steps == int(ref_steps), block
        for name, a, b, was in zip(ps.PackedLane._fields, lane, ref, before):
            assert torch.equal(a[..., INACTIVE], was[..., INACTIVE]), name
            if a.is_floating_point():
                fin = torch.isfinite(b)
                scale = float(b[fin].abs().max()) + 1e-300
                assert torch.equal(fin, torch.isfinite(a)), name
                err = float((a[fin] - b[fin]).abs().max())
                assert err <= 1e-12 * scale, (name, block, err, scale)
            else:
                assert torch.equal(a, b), (name, block)
        parities = torch.cat([parities, odd[active]])
    assert bool((ref.bp[active] < cfg.bp_init).any()), "no lane rolled over"
    assert bool(parities.any()) and not bool(parities.all()), \
        "the blocks did not end with the iterate in both buffers"
