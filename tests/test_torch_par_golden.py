"""The port's Newton solvers against the reference-generated goldens
(``tests/golden/{pendulum,cartpole}_h100.npz``), float64 on the CPU, under
``tests/test_golden.py``'s ``PARITY_CFG`` (``DEFAULT_CONFIG`` with
``stall_exit=False``) and tolerances: the sequential solve at atol 1e-6 on
the controls (its iterate path is the reference's); the parallel solve at
rtol 1e-8 on the converged barrier cost and atol 5e-2 on the controls (an
equally optimal point in the flat valley passes, a wrong optimum fails on
cost)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu_torch
from ipoc_tpu_torch.models import cartpole, pendulum
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
HORIZON = 100
PARITY_CFG = ipoc_tpu_torch.DEFAULT_CONFIG.replace(stall_exit=False)
MODELS = {"pendulum": pendulum, "cartpole": cartpole}


def _setup(name):
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}_h100.npz"))
    model = MODELS[name]
    ocp = model.make_ocp(1.0 / HORIZON)
    x0 = model.initial_state(torch.float64)
    # tests/test_golden.py's warm start (jax.random, then numpy).
    u0 = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                            (HORIZON, 1), jnp.float64))
    return data, ocp, x0, torch.tensor(u0)


@pytest.mark.parametrize("name", list(MODELS))
def test_golden_seq(name):
    data, ocp, x0, u0 = _setup(name)
    u, iters = ipoc_tpu_torch.seq_interior_point_optimal_control(
        ocp, u0, x0, PARITY_CFG)
    np.testing.assert_allclose(u.numpy(), data["u_seq"], atol=1e-6)
    assert int(iters) <= int(data["iters_seq"]) + 20


@pytest.mark.parametrize("name", list(MODELS))
def test_golden_par(name):
    data, ocp, x0, u0 = _setup(name)
    u, _ = ipoc_tpu_torch.par_interior_point_optimal_control(
        ocp, u0, x0, PARITY_CFG)
    bp = float(data["final_bp"])
    x = rollout(ocp.dynamics, u, x0)
    cost = float(ocp.total_cost(x, u, torch.tensor(bp, dtype=u.dtype)))
    assert cost == pytest.approx(float(data["cost_seq"]), rel=1e-8)
    np.testing.assert_allclose(u.numpy(), data["u_seq"], atol=5e-2)


def test_chip_smoke_warm_start_is_jax_draw():
    """chip_smoke.py imports no jax, so it carries the goldens' warm start
    as literals: they are JAX's draw, bit for bit."""
    import chip_smoke

    ref = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                             (HORIZON, 1), jnp.float64))
    got = np.asarray(chip_smoke.GOLDEN_WARM_START)[:, None]
    np.testing.assert_array_equal(got, ref)
