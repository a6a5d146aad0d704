"""The port's models against the JAX package's, float64, atol 1e-12.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.utils.integrators import rollout as j_rollout
from ipoc_tpu.utils.integrators import wrap_angle as j_wrap
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.utils.integrators import rollout as t_rollout
from ipoc_tpu_torch.utils.integrators import wrap_angle as t_wrap

torch.set_num_threads(1)

ATOL = 1e-12
MODELS = {
    "pendulum": (j_pendulum, t_pendulum, 2),
    "cartpole": (j_cartpole, t_cartpole, 4),
}


def _inputs(nx, B=5, T=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nx)) * 2.0
    x[:, :min(nx, 2)] -= 3.0  # negative angles, below -2 pi for some
    u = rng.normal(size=(B, T, 1)) * 0.5
    X = rng.normal(size=(B, T + 1, nx))
    bp = rng.uniform(0.01, 0.2, size=(B,))
    return x, u, X, bp


def test_wrap_angle_negative_and_large():
    a = np.array([-7.5, -6.3, -np.pi, -0.01, 0.0, 0.01, 3.0, 6.3, 13.0])
    np.testing.assert_allclose(t_wrap(torch.tensor(a)).numpy(),
                               np.asarray(j_wrap(jnp.asarray(a))),
                               rtol=0, atol=ATOL)
    assert (t_wrap(torch.tensor(a)).numpy() >= 0).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_model_functions_match_jax(name):
    jm, tm, nx = MODELS[name]
    dt = 0.01
    jocp, tocp = jm.make_ocp(dt), tm.make_ocp(dt)
    x, u, X, bp = _inputs(nx)
    ut = u[:, 0]
    t = torch.tensor

    dyn_j = jax.vmap(jocp.dynamics)(jnp.asarray(x), jnp.asarray(ut))
    np.testing.assert_allclose(tocp.dynamics(t(x), t(ut)).numpy(),
                               np.asarray(dyn_j), rtol=0, atol=ATOL)
    for uu in (ut, ut * 200.0):  # feasible, and outside the box (NaN)
        sc_j = jax.vmap(jocp.stage_cost)(jnp.asarray(x), jnp.asarray(uu),
                                         jnp.asarray(bp))
        np.testing.assert_allclose(
            tocp.stage_cost(t(x), t(uu), t(bp)).numpy(), np.asarray(sc_j),
            rtol=0, atol=ATOL, equal_nan=True)
        np.testing.assert_allclose(
            tocp.constraints(t(x), t(uu)).numpy(),
            np.asarray(jax.vmap(jocp.constraints)(jnp.asarray(x),
                                                  jnp.asarray(uu))),
            rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tocp.final_cost(t(x)).numpy(),
        np.asarray(jax.vmap(jocp.final_cost)(jnp.asarray(x))),
        rtol=0, atol=ATOL)
    tc_j = jax.vmap(jocp.total_cost)(jnp.asarray(X), jnp.asarray(u),
                                     jnp.asarray(bp))
    np.testing.assert_allclose(tocp.total_cost(t(X), t(u), t(bp)).numpy(),
                               np.asarray(tc_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tm.initial_state(torch.float64).numpy(),
        np.asarray(jm.initial_state(jnp.float64)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_rollout_matches_jax(name):
    jm, tm, nx = MODELS[name]
    jocp, tocp = jm.make_ocp(0.02), tm.make_ocp(0.02)
    x, u, _, _ = _inputs(nx, seed=1)
    X_j = jax.vmap(lambda uu, xx: j_rollout(jocp.dynamics, uu, xx))(
        jnp.asarray(u), jnp.asarray(x))
    X_t = t_rollout(tocp.dynamics, torch.tensor(u), torch.tensor(x))
    assert X_t.shape == (u.shape[0], u.shape[1] + 1, nx)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=0,
                               atol=ATOL)
