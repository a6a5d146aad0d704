"""The port's single-solve IP-DDP, ``interior_point_ddp``
(``solvers/ip_ddp.py``), against the JAX package and the reference's
goldens, float64 on the CPU (no kernel is on this path, as in JAX).

* The goldens (``tests/golden/{pendulum,cartpole}_h100.npz``) under
  ``tests/test_golden.py``'s ``PARITY_CFG``: the converged barrier cost
  within rtol 1e-8 of ``cost_ddp``, the controls within atol 5e-2 of
  ``u_ddp``, and the iterations equal to JAX's ``interior_point_ddp``.
* Flat DDP (``newton_impl="ddp"``, ``barrier_mode="flat"``) reaches the
  staged DDP's optimum (pendulum T=60, raw cost rel 1e-6, as
  ``tests/test_ddp_stream.py``).
* ``solve_batch(method="ddp")`` on four pendulum T=20 scenarios, one with
  a NaN warm start: each lane equals its single solve, and the NaN lane
  runs no iteration.
* The backward pass factors each stage's ``Quu`` once, for its PD test
  and its solve: ``cholesky_solve_factored`` on that factor equals
  ``cholesky_solve`` bit for bit, NaNs where the matrix is not PD.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
import ipoc_tpu_torch
from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu_torch.models import cartpole, pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.linalg import (
    cholesky,
    cholesky_solve,
    cholesky_solve_factored,
    sym,
)
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
HORIZON = 100
PARITY_CFG = ipoc_tpu_torch.DEFAULT_CONFIG.replace(stall_exit=False)
MODELS = {"pendulum": (j_pendulum, pendulum),
          "cartpole": (j_cartpole, cartpole)}


def _warm_start(T):
    """tests/test_golden.py's warm start (jax.random, then numpy)."""
    return np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(1), (T, 1),
                                              jnp.float64))


def _cost(ocp, u, x0, bp):
    x = rollout(ocp.dynamics, u, x0)
    return float(ocp.total_cost(x, u, torch.tensor(bp, dtype=u.dtype)))


@pytest.mark.parametrize("name", list(MODELS))
def test_golden_ddp(name):
    jm, tm = MODELS[name]
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}_h100.npz"))
    u0 = _warm_start(HORIZON)
    jocp = jm.make_ocp(1.0 / HORIZON)
    _, it_j = jax.jit(lambda u, x: ipoc_tpu.interior_point_ddp(
        jocp, u, x, ipoc_tpu.DEFAULT_CONFIG.replace(stall_exit=False)))(
        jnp.asarray(u0), jm.initial_state(jnp.float64))
    ocp = tm.make_ocp(1.0 / HORIZON)
    x0 = tm.initial_state(torch.float64)
    cuda.reset_launches()
    u, it = ipoc_tpu_torch.interior_point_ddp(ocp, torch.tensor(u0), x0,
                                              PARITY_CFG)
    assert cuda.launches == dict.fromkeys(cuda.launches, 0)
    assert int(it) == int(it_j)
    assert _cost(ocp, u, x0, float(data["final_bp"])) == pytest.approx(
        float(data["cost_ddp"]), rel=1e-8)
    np.testing.assert_allclose(u.numpy(), data["u_ddp"], atol=5e-2)


def test_flat_ddp_matches_staged_ddp():
    T = 60
    ocp = pendulum.make_ocp(1.0 / T)
    x0 = pendulum.initial_state(torch.float64)
    u0 = torch.tensor(_warm_start(T))
    cfg_flat = ipoc_tpu_torch.FAST_CONFIG.replace(
        globalization="single", newton_impl="ddp", barrier_mode="flat")
    u_flat, it_flat = ipoc_tpu_torch.par_interior_point_optimal_control(
        ocp, u0, x0, cfg_flat)
    u_ref, it_ref = ipoc_tpu_torch.interior_point_ddp(ocp, u0, x0)
    assert int(it_flat) > 0 and int(it_ref) > 0
    assert _cost(ocp, u_flat, x0, 1e-9) == pytest.approx(
        _cost(ocp, u_ref, x0, 1e-9), rel=1e-6)


def test_solve_batch_ddp_lanes_equal_single_solves():
    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(11)
    u0 = 0.1 * rng.normal(size=(4, T, 1))
    u0[2] = np.nan
    x0 = pendulum.initial_state(torch.float64).numpy()
    x0b = x0 + 0.01 * rng.normal(size=(4, 2))
    U, X = torch.tensor(u0), torch.tensor(x0b)
    cfg = ipoc_tpu_torch.FAST_CONFIG
    sol = ipoc_tpu_torch.solve_batch(ocp, U, X, cfg, method="ddp")
    assert sol.iterations.dtype == torch.int32
    assert int(sol.iterations[2]) == 0
    assert bool(torch.isnan(sol.controls[2]).all())
    for i in (0, 1, 3):
        u_i, it_i = ipoc_tpu_torch.interior_point_ddp(ocp, U[i], X[i], cfg)
        assert int(it_i) == int(sol.iterations[i]) > 0
        np.testing.assert_allclose(sol.controls[i].numpy(), u_i.numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_factored_solve_equals_cholesky_solve(n, dtype):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(7, n, n))
    A = torch.tensor(M @ M.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype)
    A[0] = -A[0]  # not PD: NaN entries
    b = torch.tensor(rng.normal(size=(7, n, 3)), dtype=dtype)
    got = cholesky_solve_factored(cholesky(sym(A)), b)
    want = cholesky_solve(A, b)
    assert bool(got[0].isnan().all()) and not bool(got[1:].isnan().any())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.equal(got.isnan(), want.isnan())
