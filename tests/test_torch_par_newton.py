"""The port's parallel-in-time Newton trial and solvers against the JAX
package's, on the CPU.

* The one-launch trial's plain version (``fused_newton_step`` on CPU
  tensors: the ``newton_lqt`` -> ``par_bwd_pass`` -> ``par_fwd_pass``
  pipeline) against JAX ``fused_newton_step(..., interpret=True)`` in
  float32 on ``tests/test_newton_kernel.py``'s pendulum T=16 stage data, at
  that test's tolerances (du, dx 2e-5 of scale; pred rtol 1e-4; equal ok),
  and the indefinite-R lane of ``test_fused_vmap_and_infeasible_flag_fast``.
* ``par_interior_point_optimal_control`` and
  ``seq_interior_point_optimal_control`` against JAX in float64 on pendulum
  and cartpole at T=20: ``DEFAULT_CONFIG``, then ``globalization="single"``
  and ``barrier_mode="flat"``; equal iterations, controls within 1e-8.
* The infeasible warm start (``tests/test_solvers.py``), ``solve_batch``
  lane by lane against the single solves, and ``solve`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.derivatives import compute_derivatives, compute_lqr_params
from ipoc_tpu.ops.pallas.newton_kernel import fused_newton_step as j_fused
from ipoc_tpu.parallel.costates import par_costates
from ipoc_tpu.solvers.ip_newton import _regularized
from ipoc_tpu.solvers.solution import solve as j_solve
from ipoc_tpu.utils.integrators import rollout
import ipoc_tpu_torch
from ipoc_tpu_torch.interop import config_from_jax
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.newton_kernel import fused_newton_step

torch.set_num_threads(1)

MODELS = {"pendulum": (j_pendulum, t_pendulum),
          "cartpole": (j_cartpole, t_cartpole)}


def _stage_data(model, T, rp=1.0, bp=0.1):
    """tests/test_newton_kernel.py's stage data (float32, JAX)."""
    ocp = model.make_ocp(1.0 / T)
    x0 = model.initial_state(jnp.float32)
    u0 = (0.1 * jax.random.normal(jax.random.PRNGKey(1), (T, 1))).astype(
        jnp.float32)
    X = rollout(ocp.dynamics, u0, x0)
    d = compute_derivatives(ocp, X, u0, jnp.float32(bp))
    lam = par_costates(ocp, X[-1], d)
    lin = _regularized(compute_lqr_params(lam, d), d, jnp.float32(rp), True)
    XT = jax.hessian(ocp.final_cost)(X[-1])
    return (lin.r, lin.Q, lin.R, lin.M, d.fx, d.fu, XT)


def test_fused_step_matches_jax_kernel_interpret():
    args = _stage_data(j_pendulum, 16)
    du_j, dx_j, pred_j, ok_j = j_fused(*args, interpret=True)
    cuda.reset_launches()
    du, dx, pred, ok = fused_newton_step(
        *(torch.tensor(np.asarray(a))[None] for a in args))
    assert cuda.launches["par_newton_trial"] == 0  # CPU: the plain version
    scale = float(jnp.abs(du_j).max()) + 1e-6
    np.testing.assert_allclose(du[0].numpy(), du_j, atol=2e-5 * scale)
    np.testing.assert_allclose(dx[0].numpy(), dx_j, atol=2e-5 * scale)
    np.testing.assert_allclose(float(pred[0]), float(pred_j), rtol=1e-4)
    assert bool(ok[0]) == bool(ok_j)


def test_fused_step_indefinite_lane():
    """Two lanes (JAX's recipe: the stage data scaled by 0.9 and 1.1), lane 1
    with an indefinite R at stage 3: only lane 1 is infeasible, and lane 0
    matches JAX's unbatched kernel."""
    args = _stage_data(j_pendulum, 8)
    lanes = [[np.asarray(a) * s for a in args] for s in (0.9, 1.1)]
    lanes[1][2] = lanes[1][2].copy()
    lanes[1][2][3] = -np.eye(1, dtype=np.float32)
    batch = [torch.tensor(np.stack(f)) for f in zip(*lanes)]
    du, _, pred, ok = fused_newton_step(*batch)
    assert ok.tolist() == [True, False]
    ref = [j_fused(*map(jnp.asarray, lane), interpret=True)
           for lane in lanes]
    assert [bool(r[3]) for r in ref] == [True, False]
    np.testing.assert_allclose(du[0].numpy(), ref[0][0], atol=1e-5)
    np.testing.assert_allclose(float(pred[0]), float(ref[0][2]), rtol=1e-5)


CONFIGS = {
    "par": ("par", ipoc_tpu.DEFAULT_CONFIG),
    "seq": ("seq", ipoc_tpu.DEFAULT_CONFIG),
    "par_single": ("par", ipoc_tpu.DEFAULT_CONFIG.replace(
        globalization="single")),
    "par_flat": ("par", ipoc_tpu.DEFAULT_CONFIG.replace(
        globalization="single", barrier_mode="flat")),
}


def _problem(name, T, seed=0):
    jm, tm = MODELS[name]
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u0 = 0.1 * np.random.default_rng(seed).normal(size=(T, 1))
    return jm.make_ocp(1.0 / T), tm.make_ocp(1.0 / T), u0, x0


@pytest.mark.parametrize("case", list(CONFIGS))
@pytest.mark.parametrize("model", list(MODELS))
def test_solver_matches_jax(model, case):
    method, cfg = CONFIGS[case]
    jocp, tocp, u0, x0 = _problem(model, 20)
    jf = getattr(ipoc_tpu, f"{method}_interior_point_optimal_control")
    tf = getattr(ipoc_tpu_torch, f"{method}_interior_point_optimal_control")
    u_j, it_j = jax.jit(lambda u, x: jf(jocp, u, x, cfg))(
        jnp.asarray(u0), jnp.asarray(x0))
    u_t, it_t = tf(tocp, torch.tensor(u0), torch.tensor(x0),
                   config_from_jax(cfg))
    assert int(it_t) == int(it_j) > 0
    assert it_t.dtype == torch.int32 and it_t.shape == ()
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-8)


def test_infeasible_warm_start_returns_input():
    """A warm start outside the control box (NaN barrier cost) returns its
    input unchanged after 0 iterations (tests/test_solvers.py)."""
    tocp = t_pendulum.make_ocp(0.02)
    x0 = t_pendulum.initial_state(torch.float64)
    u_bad = 10.0 * torch.ones((50, 1), dtype=torch.float64)
    for solver in (ipoc_tpu_torch.par_interior_point_optimal_control,
                   ipoc_tpu_torch.seq_interior_point_optimal_control):
        u, iters = solver(tocp, u_bad, x0)
        assert int(iters) == 0
        assert torch.equal(u, u_bad)


def test_solve_batch_lanes_equal_single_solves():
    """solve_batch(method="par") on three scenarios, one of them with an
    infeasible warm start: each lane equals its single solve (equal
    iterations, controls to 1e-12), the bad lane does not disturb the
    others; so does method="ddp"."""
    T = 20
    _, tocp, _, x0 = _problem("pendulum", T)
    rng = np.random.default_rng(3)
    u0 = 0.1 * rng.normal(size=(3, T, 1))
    u0[1] = 10.0
    x0b = x0 + 0.01 * rng.normal(size=(3, 2))
    U, X = torch.tensor(u0), torch.tensor(x0b)
    sol = ipoc_tpu_torch.solve_batch(tocp, U, X, method="par")
    assert sol.iterations.dtype == torch.int32 and int(sol.iterations[1]) == 0
    for i in range(3):
        u_i, it_i = ipoc_tpu_torch.par_interior_point_optimal_control(
            tocp, U[i], X[i])
        assert int(it_i) == int(sol.iterations[i])
        np.testing.assert_allclose(sol.controls[i].numpy(), u_i.numpy(),
                                   rtol=0, atol=1e-12)
    # method="ddp" solves too: the bad lane takes no iteration, the others
    # equal their single IP-DDP solves.
    sol = ipoc_tpu_torch.solve_batch(tocp, U, X, method="ddp")
    assert int(sol.iterations[1]) == 0 and torch.equal(sol.controls[1], U[1])
    for i in (0, 2):
        u_i, it_i = ipoc_tpu_torch.interior_point_ddp(tocp, U[i], X[i])
        assert int(it_i) == int(sol.iterations[i]) > 0
        np.testing.assert_allclose(sol.controls[i].numpy(), u_i.numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["par", "seq", "ddp"])
def test_solve_matches_jax(method):
    """solve() equals JAX's on every IPSolution field."""
    jocp, tocp, u0, x0 = _problem("pendulum", 20, seed=4)
    ref = jax.jit(lambda u, x: j_solve(jocp, u, x, method=method))(
        jnp.asarray(u0), jnp.asarray(x0))
    got = ipoc_tpu_torch.solve(tocp, torch.tensor(u0), torch.tensor(x0),
                               method=method)
    assert got._fields == ref._fields
    assert int(got.iterations) == int(ref.iterations)
    for f in ("controls", "states", "grad_norm", "cost"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-8,
                                   atol=1e-10, err_msg=f)
    for f in ("feasible", "converged"):
        assert bool(getattr(got, f)) == bool(getattr(ref, f)), f
    assert got.metrics().keys() == ref.metrics().keys()
