"""The port's models against the JAX package's, float64, atol 1e-12:
pendulum, cartpole, the planar quadrotor (nx=6, nu=2), the double
integrator (``unconstrained_ocp``, RK4 through ``discretize_dynamics``),
the unicycle (nx=3, nu=2, the keep-out disc) and cartpole with
BASELINE.json config 3's cart box;
``runge_kutta`` and ``discretize_dynamics`` with sub-steps on the
quadrotor's ODE; every model's constants (``interop.model_constants``).

Inputs are made with numpy from a seed and handed to both packages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import double_integrator as j_double_integrator
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.models import quadrotor as j_quadrotor
from ipoc_tpu.models import unicycle as j_unicycle
from ipoc_tpu.utils.integrators import discretize_dynamics as j_discretize
from ipoc_tpu.utils.integrators import rollout as j_rollout
from ipoc_tpu.utils.integrators import runge_kutta as j_runge_kutta
from ipoc_tpu.utils.integrators import wrap_angle as j_wrap
from ipoc_tpu_torch.interop import model_constants
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import double_integrator as t_double_integrator
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.utils.integrators import discretize_dynamics as t_discretize
from ipoc_tpu_torch.utils.integrators import rollout as t_rollout
from ipoc_tpu_torch.utils.integrators import runge_kutta as t_runge_kutta
from ipoc_tpu_torch.utils.integrators import wrap_angle as t_wrap

torch.set_num_threads(1)

ATOL = 1e-12


def boxed(module, limit=0.3):
    """A cartpole module whose ``make_ocp(dt)`` adds the cart box
    (``cart_limit`` 0.3: BASELINE.json config 3)."""
    return types.SimpleNamespace(**{
        **vars(module),
        "make_ocp": lambda dt: module.make_ocp(dt, cart_limit=limit)})


# model: (JAX module, port module, nx, nu, the controls' centre inside
# the box)
MODELS = {
    "pendulum": (j_pendulum, t_pendulum, 2, 1, 0.0),
    "cartpole": (j_cartpole, t_cartpole, 4, 1, 0.0),
    "quadrotor": (j_quadrotor, t_quadrotor, 6, 2, t_quadrotor.HOVER),
    "double_integrator": (j_double_integrator, t_double_integrator, 2, 1,
                          0.0),
    "unicycle": (j_unicycle, t_unicycle, 3, 2, 0.0),
    "cartpole_box": (boxed(j_cartpole), boxed(t_cartpole), 4, 1, 0.0),
}


def _inputs(nx, nu=1, B=5, T=7, seed=0, u_centre=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nx)) * 2.0
    x[:, :min(nx, 2)] -= 3.0  # negative angles, below -2 pi for some
    u = rng.normal(size=(B, T, nu)) * 0.5 + u_centre
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
    jm, tm, nx, nu, centre = MODELS[name]
    dt = 0.01
    jocp, tocp = jm.make_ocp(dt), tm.make_ocp(dt)
    x, u, X, bp = _inputs(nx, nu, u_centre=centre)
    ut = u[:, 0]
    t = torch.tensor

    dyn_j = jax.vmap(jocp.dynamics)(jnp.asarray(x), jnp.asarray(ut))
    np.testing.assert_allclose(tocp.dynamics(t(x), t(ut)).numpy(),
                               np.asarray(dyn_j), rtol=0, atol=ATOL)
    for uu in (ut, ut * 200.0):  # feasible, and outside a box (NaN)
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
    if hasattr(jm, "initial_state"):
        np.testing.assert_allclose(
            tm.initial_state(torch.float64).numpy(),
            np.asarray(jm.initial_state(jnp.float64)), rtol=0, atol=ATOL)
    if hasattr(jm, "hover_controls"):
        np.testing.assert_array_equal(
            tm.hover_controls(9, torch.float64).numpy(),
            np.asarray(jm.hover_controls(9, jnp.float64)))
    assert model_constants(tm) == model_constants(jm)


@pytest.mark.parametrize("name", list(MODELS))
def test_rollout_matches_jax(name):
    jm, tm, nx, nu, centre = MODELS[name]
    jocp, tocp = jm.make_ocp(0.02), tm.make_ocp(0.02)
    x, u, _, _ = _inputs(nx, nu, seed=1, u_centre=centre)
    X_j = jax.vmap(lambda uu, xx: j_rollout(jocp.dynamics, uu, xx))(
        jnp.asarray(u), jnp.asarray(x))
    X_t = t_rollout(tocp.dynamics, torch.tensor(u), torch.tensor(x))
    assert X_t.shape == (u.shape[0], u.shape[1] + 1, nx)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=0,
                               atol=ATOL)


def _pairwise_sum(c):
    """``stage_sum``'s order on one lane, in numpy: halves added until one
    stage is left, an odd last stage carried."""
    while c.shape[-1] > 1:
        h = c.shape[-1] // 2
        c = np.concatenate([c[:h] + c[h:2 * h], c[2 * h:]])
    return c[0]


@pytest.mark.parametrize("T", [1, 2, 3, 100, 101, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stage_sum_order_and_lanes(T, dtype):
    """``problem.stage_sum`` adds a lane's stages in a fixed pairwise order
    (the same bits alone and beside other lanes) and agrees with the sum;
    ``stage_norm`` is the square root of the squares' ``stage_sum``."""
    from ipoc_tpu_torch.problem import stage_norm, stage_sum

    c = np.random.default_rng(T).standard_normal((16, T)).astype(dtype)
    out = stage_sum(torch.tensor(c)).numpy()
    for b in range(16):
        assert out[b] == _pairwise_sum(c[b])
        assert stage_sum(torch.tensor(c[b:b + 1])).numpy()[0] == out[b]
    np.testing.assert_allclose(out, c.astype(np.float64).sum(-1),
                               rtol=1e-5 if dtype == np.float32 else 1e-12,
                               atol=1e-4 if dtype == np.float32 else 1e-12)
    c2 = np.random.default_rng(T + 1).standard_normal((16, T, 2)).astype(
        dtype)
    norm = stage_norm(torch.tensor(c2))
    squares = np.stack([_pairwise_sum((c2[b] * c2[b]).ravel())
                        for b in range(16)])
    assert torch.equal(norm, torch.sqrt(torch.tensor(squares)))
    np.testing.assert_allclose(
        norm.numpy(), np.linalg.norm(c2.astype(np.float64), axis=(1, 2)),
        rtol=1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("downsampling", [1, 3])
def test_runge_kutta_and_discretize_match_jax(downsampling):
    """``runge_kutta`` and ``discretize_dynamics`` (``downsampling`` RK4
    sub-steps) on the quadrotor's nonlinear ODE, batched over leading axes
    against JAX vmapped."""
    x, u, _, _ = _inputs(6, 2, seed=2, u_centre=t_quadrotor.HOVER)
    ut = u[:, 0]
    np.testing.assert_allclose(
        t_runge_kutta(torch.tensor(x), torch.tensor(ut), t_quadrotor.ode,
                      0.05).numpy(),
        np.asarray(jax.vmap(lambda xx, uu: j_runge_kutta(
            xx, uu, j_quadrotor.ode, 0.05))(jnp.asarray(x), jnp.asarray(ut))),
        rtol=0, atol=ATOL)
    t_dyn = t_discretize(t_quadrotor.ode, 0.05, downsampling)
    j_dyn = j_discretize(j_quadrotor.ode, 0.05, downsampling)
    np.testing.assert_allclose(
        t_dyn(torch.tensor(x), torch.tensor(ut)).numpy(),
        np.asarray(jax.vmap(j_dyn)(jnp.asarray(x), jnp.asarray(ut))),
        rtol=0, atol=ATOL)


def test_unconstrained_ocp_is_vacuous():
    """The double integrator's constraint is -1 on every stage, on any
    leading axes, and its stage cost ignores ``bp``."""
    ocp = t_double_integrator.make_ocp(0.1)
    x, u, X, bp = _inputs(2, seed=3)
    c = ocp.constraints(torch.tensor(X[:, :-1]), torch.tensor(u))
    assert c.shape == (5, 7, 1) and bool((c == -1.0).all())
    a = ocp.stage_cost(torch.tensor(x), torch.tensor(u[:, 0]),
                       torch.tensor(bp))
    b = ocp.stage_cost(torch.tensor(x), torch.tensor(u[:, 0]), 123.0)
    assert torch.equal(a, b)
