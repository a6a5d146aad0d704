"""The planar quadrotor (nx=6, nu=2) and the double integrator in the
port, against the JAX package on the CPU (the kernels' plain versions),
float64.

* ``tests/test_quadrotor.py``'s single solve (dt 0.05, H=40, the hover
  start, ``FAST_CONFIG``): the port's par, seq and DDP solves take JAX's
  iterations, their controls within 1e-8 of JAX's; the par solve reaches
  the goal (0.02), keeps the thrust box and binds it; seq and DDP agree
  with par within 2e-3 (JAX's own bars).
* ``test_batched_fused_solver_nu2`` mirrored: ``solve_batch`` flat with
  the fused evaluator against the seq one (equal iterations, controls
  within 1e-12), then against JAX's fused ``solve_batch`` (equal
  iterations, controls within 1e-10).
* ``solve_stream_multigrid`` (a DDP coarse level) and ``solve_stream``
  (the packed stream on its mega executor's plain version) under
  ``BATCH_CONFIG`` on 8 scenarios at H=16 against JAX's: equal iterations
  on every scenario (both levels), equal steps, controls within 1e-8.
* The double integrator's par solve (dt 0.1, H=40) against the discrete
  Riccati solution of the exact linearization (``tests/test_solvers.py``
  ``_riccati_lqr_oracle``), within 1e-6, in at most 15 iterations.
* A card shape with no instantiation ((5, 1), and (6, 1) beside the
  quadrotor's (6, 2)) raises ``NotImplementedError`` in the seq and
  parallel trials, the costate recursion and both scans, before any launch.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import quadrotor as j_quadrotor
from ipoc_tpu.solvers.batched import solve_batch as j_solve_batch
from ipoc_tpu.solvers.stream import solve_stream as j_solve_stream
from ipoc_tpu.solvers.stream import solve_stream_multigrid as j_multigrid
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
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy, to_numpy
from ipoc_tpu_torch.models import double_integrator as t_double_integrator
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

DT, H = 0.05, 40
F64 = torch.float64


def _port_solve(solver, ocp):
    u, it = solver(ocp, t_quadrotor.hover_controls(H, F64),
                   t_quadrotor.initial_state(F64), FAST_CONFIG)
    return u.numpy(), int(it)


@pytest.fixture(scope="module")
def solved():
    """The par solve in both packages: ``(port ocp, port controls, port
    iterations, JAX controls, JAX iterations)``."""
    jocp = j_quadrotor.make_ocp(DT)
    uj, ij = jax.jit(lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
        jocp, u, x, ipoc_tpu.FAST_CONFIG))(
        j_quadrotor.hover_controls(H, jnp.float64),
        j_quadrotor.initial_state(jnp.float64))
    tocp = t_quadrotor.make_ocp(DT)
    u, it = _port_solve(par_interior_point_optimal_control, tocp)
    return tocp, u, it, np.asarray(uj), int(ij)


def test_par_matches_jax(solved):
    _, u, it, uj, ij = solved
    assert it == ij > 0
    np.testing.assert_allclose(u, uj, rtol=0, atol=1e-8)


def test_converges_to_goal(solved):
    tocp, u, _, _, _ = solved
    X = rollout(tocp.dynamics, torch.tensor(u),
                t_quadrotor.initial_state(F64))
    np.testing.assert_allclose(X[-1, :2].numpy(), [1.0, 1.0], atol=0.02)


def test_thrust_box_active_and_respected(solved):
    _, u, _, _, _ = solved
    assert u.min() > t_quadrotor.F_MIN
    assert u.max() < t_quadrotor.F_MAX
    assert u.max() > 0.9 * t_quadrotor.F_MAX  # the box binds (transient)


@pytest.mark.parametrize("method", ["seq", "ddp"])
def test_cross_solver_matches_jax(solved, method):
    tocp, u_par, _, _, _ = solved
    j_solver, t_solver = {
        "seq": (ipoc_tpu.seq_interior_point_optimal_control,
                seq_interior_point_optimal_control),
        "ddp": (ipoc_tpu.interior_point_ddp, interior_point_ddp)}[method]
    jocp = j_quadrotor.make_ocp(DT)
    uj, ij = jax.jit(lambda u, x: j_solver(jocp, u, x, ipoc_tpu.FAST_CONFIG))(
        j_quadrotor.hover_controls(H, jnp.float64),
        j_quadrotor.initial_state(jnp.float64))
    u, it = _port_solve(t_solver, tocp)
    assert it == int(ij)
    np.testing.assert_allclose(u, np.asarray(uj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(u, u_par, rtol=0, atol=2e-3)


def _pool(n, T, seed, state_scale, control_scale):
    rng = np.random.default_rng(seed)
    u0 = t_quadrotor.HOVER + control_scale * rng.normal(size=(n, T, 2))
    x0b = state_scale * rng.normal(size=(n, 6))
    return u0, x0b


def test_batched_fused_solver_nu2():
    """``solve_batch`` flat, the fused evaluator against the seq one and
    against JAX's (tests/test_quadrotor.py's scenarios: 3 at T=24, the
    states 0.02 about hover, the controls at hover thrust)."""
    T = 24
    u0, x0b = _pool(3, T, seed=7, state_scale=0.02, control_scale=0.0)
    cfg = ipoc_tpu.FAST_CONFIG.replace(globalization="single",
                                       barrier_mode="flat")
    tocp = t_quadrotor.make_ocp(DT)
    got = {impl: solve_batch(tocp, *pool_from_numpy(u0, x0b),
                             config_from_jax(cfg.replace(newton_impl=impl)))
           for impl in ("seq", "fused")}
    np.testing.assert_array_equal(got["fused"].iterations.numpy(),
                                  got["seq"].iterations.numpy())
    np.testing.assert_allclose(got["fused"].controls.numpy(),
                               got["seq"].controls.numpy(), rtol=0,
                               atol=1e-12)
    ref = jax.jit(lambda u, x: j_solve_batch(
        j_quadrotor.make_ocp(DT), u, x, cfg.replace(newton_impl="fused")))(
        jnp.asarray(u0), jnp.asarray(x0b))
    np.testing.assert_array_equal(got["fused"].iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got["fused"].controls.numpy(),
                               np.asarray(ref.controls), rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", ["multigrid", "stream"])
def test_streams_match_jax(kind):
    """8 scenarios at H=16 through 3 lanes, ``BATCH_CONFIG``: the
    multigrid with a DDP coarse level (coarsen 4) and the single-grid
    packed stream."""
    T = 16
    u0, x0b = _pool(8, T, seed=5, state_scale=0.01, control_scale=0.1)
    cfg = ipoc_tpu.BATCH_CONFIG
    fields = ["iterations", "steps"]
    if kind == "multigrid":
        fields += ["iterations_coarse", "steps_coarse"]
        ref = jax.jit(lambda u, x: j_multigrid(
            j_quadrotor.make_ocp(1.0 / T), j_quadrotor.make_ocp(4.0 / T), 4,
            u, x, cfg, lanes=3, coarse_impl="ddp"))(jnp.asarray(u0),
                                                    jnp.asarray(x0b))
        got = solve_stream_multigrid(
            t_quadrotor.make_ocp(1.0 / T), t_quadrotor.make_ocp(4.0 / T), 4,
            *pool_from_numpy(u0, x0b), BATCH_CONFIG, lanes=3,
            coarse_impl="ddp")
    else:
        ref = jax.jit(lambda u, x: j_solve_stream(
            j_quadrotor.make_ocp(1.0 / T), u, x, cfg, lanes=3))(
            jnp.asarray(u0), jnp.asarray(x0b))
        got = solve_stream(t_quadrotor.make_ocp(1.0 / T),
                           *pool_from_numpy(u0, x0b), BATCH_CONFIG, lanes=3)
    got = to_numpy(got)
    for field in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert (got.iterations > 0).all()
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls),
                               rtol=0, atol=1e-8)


def _riccati_lqr_oracle(ocp, H_, x0):
    """The closed-form discrete LQR by the backward Riccati recursion on
    the exact linearization (the dynamics are linear, so this is the
    global optimum)."""
    x0 = torch.as_tensor(x0, dtype=F64)
    u0 = torch.zeros(1, dtype=F64)
    A = torch.func.jacfwd(ocp.dynamics, 0)(x0, u0).numpy()
    B = torch.func.jacfwd(ocp.dynamics, 1)(x0, u0).numpy()
    Q = np.diag(t_double_integrator.STATE_WEIGHTS)
    R = np.array([[t_double_integrator.ACTION_WEIGHT]])
    P = Q.copy()
    Ks = []
    for _ in range(H_):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ A - A.T @ P @ B @ K
        Ks.append(K)
    x = x0.numpy()
    us = []
    for K in Ks[::-1]:
        u = -K @ x
        us.append(u)
        x = A @ x + B @ u
    return np.stack(us)


def test_double_integrator_matches_lqr_oracle():
    ocp = t_double_integrator.make_ocp(0.1)
    x0 = torch.tensor([2.0, 1.0], dtype=F64)
    u, it = par_interior_point_optimal_control(
        ocp, torch.zeros((40, 1), dtype=F64), x0)
    np.testing.assert_allclose(u.numpy(), _riccati_lqr_oracle(ocp, 40, x0),
                               atol=1e-6)
    assert 0 < int(it) <= 15


def _wrapper_args(kernel, nx, nu, B=2, T=3):
    z = lambda *s: torch.zeros(s, dtype=F64)  # noqa: E731
    trial = (z(B, T, nu), z(B, T, nx, nx), z(B, T, nu, nu), z(B, T, nx, nu),
             z(B, T, nx, nx), z(B, T, nx, nu), z(B, nx, nx))
    return {"seq_trial": trial, "par_trial": trial,
            "costates": (z(B, T, nx), z(B, T, nx, nx), z(B, nx)),
            "affine_scan": (z(B, T, nx, nx), z(B, T, nx)),
            "value_scan": (z(B, T, nx, nx), z(B, T, nx), z(B, T, nx, nx),
                           z(B, T, nx), z(B, T, nx, nx))}[kernel]


@pytest.mark.parametrize("kernel,shape", [
    ("seq_trial", (5, 1)), ("seq_trial", (6, 1)), ("par_trial", (5, 1)),
    ("par_trial", (6, 1)), ("costates", (5, 1)), ("affine_scan", (5, 1)),
    ("value_scan", (5, 1))], ids=lambda v: v if isinstance(v, str)
    else f"nx{v[0]}nu{v[1]}")
def test_uninstantiated_card_shape_raises(kernel, shape, monkeypatch):
    """A card tensor of a shape with no instantiation raises
    ``NotImplementedError`` before any launch (no plain-version fallback):
    the wrappers are called as on a card (``cuda.on_cpu`` false).  The
    trials are instantiated per (nx, nu), so (6, 1) raises beside the
    quadrotor's (6, 2); the costate and scan kernels per nx."""
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk
    from ipoc_tpu_torch.ops.cuda import seq_newton as sn

    fn = {"seq_trial": sn.seq_newton_trial_batched,
          "costates": sn.seq_costates_batched,
          "par_trial": nk.fused_newton_step, "affine_scan": sk.affine_scan,
          "value_scan": sk.value_scan}[kernel]
    launched = dict(cuda.launches)
    monkeypatch.setattr(cuda, "on_cpu", lambda name, *t: False)
    with pytest.raises(NotImplementedError, match="no kernel"):
        fn(*_wrapper_args(kernel, *shape))
    assert cuda.launches == launched
