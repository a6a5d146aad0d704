"""The obstacle-avoidance unicycle (nx=3, nu=2, a keep-out disc: the first
state constraint) in the port, against the JAX package on the CPU (the
kernels' plain versions), float64.

* ``tests/test_unicycle.py``'s single solve (T=60, dt 2/60,
  ``FAST_CONFIG``): the port's par, seq and DDP solves (DDP from the
  swerving warm start) take JAX's iterations with controls within 1e-8 of
  JAX's, reach the goal, are feasible at every constrained stage point
  and ride the disc (least distance within 1e-3 of ``RADIUS``).
* ``test_fused_batched_path``: ``solve_batch`` under ``BATCH_CONFIG`` on
  three scenarios against JAX's: equal iterations, controls within 1e-10.
* ``tests/test_multigrid.py``'s unicycle pool (T=40, four initial states,
  two lanes): ``solve_stream_multigrid`` with a Newton coarse level (the
  JAX test's) and with a DDP coarse level (bench.py's), and the
  single-grid ``solve_stream``, against JAX's: equal steps and iterations
  on both levels, the same scenarios sent to the cold start by the usable
  gate (JAX's read from the per-scenario ``bp_init`` its gate hands to the
  fine stream), controls within 1e-8, every solution feasible and
  completed.  On this pool the gate fires: the coarse solutions clip the
  disc on the fine grid.
* A fault of the reference algorithm in float32, kept by the port: a
  Newton step accepted on its linearized states can leave the rollout of
  its controls inside the disc (bench.py's pool, scenario 4921), and the
  port marks that scenario not completed.

Inputs are made with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
import ipoc_tpu.solvers.stream as j_stream
from ipoc_tpu.models import unicycle as j_unicycle
from ipoc_tpu.solvers.batched import solve_batch as j_solve_batch
from ipoc_tpu_torch import (
    BATCH_CONFIG,
    FAST_CONFIG,
    interior_point_ddp,
    par_interior_point_optimal_control,
    seq_interior_point_optimal_control,
    solve_batch,
    solve_stream,
    solve_stream_multigrid,
)
from ipoc_tpu_torch.interop import pool_from_numpy, to_numpy
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

T = 60
F64 = torch.float64
SOLVERS = {
    "par": (ipoc_tpu.par_interior_point_optimal_control,
            par_interior_point_optimal_control),
    "seq": (ipoc_tpu.seq_interior_point_optimal_control,
            seq_interior_point_optimal_control),
    "ddp": (ipoc_tpu.interior_point_ddp, interior_point_ddp),
}


def _warm_start(solver, horizon=T):
    """``tests/test_unicycle.py``'s warm start: straight ahead at v = 0.3;
    for DDP, whose closed-loop rollouts are more local, a swerving one
    (v = 1, omega = -1) that puts it in the go-around basin."""
    u = np.zeros((horizon, 2))
    u[:, 0] = 0.3
    if solver == "ddp":
        u[:, 0], u[:, 1] = 1.0, -1.0
    return u


def _distance(x):
    cx, cy = t_unicycle.CENTER
    return torch.sqrt((x[..., 0] - cx)**2 + (x[..., 1] - cy)**2)


def _assert_feasible(ocp, u, x0):
    """Every constrained stage point of ``u``'s rollout (the terminal
    state is not constrained) strictly inside the disc's complement and
    the boxes; returns the rollout."""
    x = rollout(ocp.dynamics, u, x0)
    assert float(ocp.constraints(x[..., :-1, :], u).max()) < 0.0
    return x


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_swerves_and_rides_the_disc(solver):
    j_solver, t_solver = SOLVERS[solver]
    u0 = _warm_start(solver)
    jocp = j_unicycle.make_ocp(2.0 / T)
    uj, ij = jax.jit(lambda u, x: j_solver(jocp, u, x, ipoc_tpu.FAST_CONFIG))(
        jnp.asarray(u0), j_unicycle.initial_state(jnp.float64))
    tocp = t_unicycle.make_ocp(2.0 / T)
    x0 = t_unicycle.initial_state(F64)
    u, it = t_solver(tocp, torch.tensor(u0), x0, FAST_CONFIG)
    assert int(it) == int(ij) > 0
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-8)
    x = _assert_feasible(tocp, u, x0)
    assert abs(float(x[-1, 0]) - t_unicycle.GOAL[0]) < 0.05
    d = _distance(x[:-1])
    assert float(d.min()) == pytest.approx(t_unicycle.RADIUS, abs=1e-3)
    assert float(u[:, 1].abs().max()) > 0.5  # it swerved


def test_fused_batched_path():
    """``solve_batch`` under ``BATCH_CONFIG`` (the fused trial; its plain
    version here) on three initial states 0, 0.005 and 0.01 off the
    origin in every coordinate."""
    B = 3
    u0 = np.broadcast_to(_warm_start("par"), (B, T, 2)).copy()
    x0b = np.linspace(0.0, 0.01, B)[:, None] * np.ones((B, 3))
    ref = jax.jit(lambda u, x: j_solve_batch(
        j_unicycle.make_ocp(2.0 / T), u, x, ipoc_tpu.BATCH_CONFIG))(
        jnp.asarray(u0), jnp.asarray(x0b))
    tocp = t_unicycle.make_ocp(2.0 / T)
    u0t, x0t = pool_from_numpy(u0, x0b)
    got = solve_batch(tocp, u0t, x0t, BATCH_CONFIG)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.controls.numpy(), np.asarray(ref.controls),
                               rtol=0, atol=1e-10)
    x = _assert_feasible(tocp, got.controls, x0t)
    assert (x[:, -1, 0] - t_unicycle.GOAL[0]).abs().max() < 0.1


def _mg_pool(horizon=40):
    """``tests/test_multigrid.py::test_multigrid_unicycle_state_constraint``'s
    pool: the straight warm start from the origin shifted by dy in {0,
    0.02, -0.02, 0.04}."""
    u0 = np.broadcast_to(_warm_start("par", horizon), (4, horizon, 2)).copy()
    x0b = np.zeros((4, 3))
    x0b[:, 1] = (0.0, 0.02, -0.02, 0.04)
    return u0, x0b


def _jax_multigrid(monkeypatch, u0, x0b, horizon, coarse_impl):
    """JAX's multigrid and the scenarios its usable gate sent to the cold
    start: those whose fine-level ``bp_init`` is ``cfg.bp_init`` (the gate
    hands ``fine_bp_init`` to the others)."""
    seen = {}
    real = j_stream.solve_stream

    def spy(*a, **k):
        if "bp_init" in k:
            seen["bp_init"] = k["bp_init"]
        return real(*a, **k)

    monkeypatch.setattr(j_stream, "solve_stream", spy)
    cfg = ipoc_tpu.BATCH_CONFIG
    sol, bp0 = jax.jit(lambda u, x: (j_stream.solve_stream_multigrid(
        j_unicycle.make_ocp(2.0 / horizon), j_unicycle.make_ocp(8.0 / horizon),
        4, u, x, cfg, lanes=2, coarse_impl=coarse_impl), seen["bp_init"]))(
        jnp.asarray(u0), jnp.asarray(x0b))
    return sol, np.asarray(bp0) == cfg.bp_init


@pytest.mark.parametrize("kind", ["multigrid_newton", "multigrid_ddp",
                                  "stream"])
def test_streams_match_jax(kind, monkeypatch):
    H = 40
    u0, x0b = _mg_pool(H)
    tocp = t_unicycle.make_ocp(2.0 / H)
    fields = ["iterations", "steps"]
    if kind == "stream":
        ref = jax.jit(lambda u, x: j_stream.solve_stream(
            j_unicycle.make_ocp(2.0 / H), u, x, ipoc_tpu.BATCH_CONFIG,
            lanes=2))(jnp.asarray(u0), jnp.asarray(x0b))
        got = solve_stream(tocp, *pool_from_numpy(u0, x0b), BATCH_CONFIG,
                           lanes=2)
    else:
        coarse_impl = "ddp" if kind == "multigrid_ddp" else None
        fields += ["iterations_coarse", "steps_coarse"]
        ref, fallback = _jax_multigrid(monkeypatch, u0, x0b, H, coarse_impl)
        got = solve_stream_multigrid(
            tocp, t_unicycle.make_ocp(8.0 / H), 4,
            *pool_from_numpy(u0, x0b), BATCH_CONFIG, lanes=2,
            coarse_impl=coarse_impl)
        assert fallback.any()  # the gate fires on this pool
        np.testing.assert_array_equal(got.fallback.numpy(), fallback)
    ctrl = got.controls
    got = to_numpy(got)
    for field in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert (got.iterations > 0).all() and got.completed.all()
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls),
                               rtol=0, atol=1e-8)
    _assert_feasible(tocp, ctrl, torch.tensor(x0b))


def test_float32_linearized_step_can_cross_the_disc():
    """A fault of the reference algorithm in float32, which the port keeps:
    the Newton trial is accepted on its linearized states ``x + dx``, and
    near the disc (the barrier's Hessian bp / c^2 at 1e7) a float32 step
    can take the linearized states around the disc while the rollout of
    its controls parts from them and crosses it.  The stage transition's
    rollout then has a non-finite cost and the solve stops there.  On
    bench.py's unicycle pool (``make_batch``, seed 1, H=100, 4 x 4096),
    scenario 4921 does so in float32 in both packages: JAX's stream and
    the port's return controls whose rollout enters the disc within 40
    iterations (a completed solve takes some 100), and the port marks the
    scenario not completed."""
    from ipoc_tpu_torch.solvers.batched import make_batch

    H, n = 100, 4921
    u_all, x_all = make_batch(torch.Generator().manual_seed(1),
                              t_unicycle.initial_state(torch.float32),
                              4 * 4096, H, 2, state_scale=0.01,
                              control_scale=0.1)
    u0, x0b = u_all[n:n + 1].numpy(), x_all[n:n + 1].numpy()
    ref = jax.jit(lambda u, x: j_stream.solve_stream(
        j_unicycle.make_ocp(1.0 / H), u, x, ipoc_tpu.BATCH_CONFIG,
        lanes=1))(jnp.asarray(u0), jnp.asarray(x0b))
    tocp = t_unicycle.make_ocp(1.0 / H)
    got = solve_stream(tocp, *pool_from_numpy(u0, x0b), BATCH_CONFIG,
                       lanes=1)
    x0 = torch.tensor(x0b, dtype=F64)
    for controls, iters in ((torch.tensor(np.asarray(ref.controls)),
                             ref.iterations), (got.controls, got.iterations)):
        x = rollout(tocp.dynamics, controls.double(), x0)
        assert float(tocp.constraints(x[:, :-1], controls.double()).max()) > 0
        assert int(iters[0]) < 40
    assert not bool(got.completed.any())
