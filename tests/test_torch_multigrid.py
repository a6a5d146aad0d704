"""The port's ``solve_stream_multigrid`` against the JAX package's, float64
on the CPU, with the bench's DDP coarse level (``coarse_impl="ddp"``) and
``BATCH_CONFIG``: pendulum, T=40 on the fine grid, coarsen 4, 6 scenarios
through 3 lanes (``tests/test_multigrid.py``'s shapes).

* equal fine and coarse iterations on every scenario, equal fine and
  coarse steps, controls within 1e-8;
* a coarse solution that is infeasible on the fine grid (a coarse problem
  with a looser control box than the fine one) falls back to the cold
  single-grid solve, exactly as in JAX
  (``test_multigrid_infeasible_warmstart_falls_back``);
* a horizon not divisible by ``coarsen`` raises.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.problem import barrier_ocp as j_barrier_ocp
from ipoc_tpu.solvers.stream import solve_stream as j_solve_stream
from ipoc_tpu.solvers.stream import solve_stream_multigrid as j_multigrid
from ipoc_tpu.utils.integrators import euler as j_euler
from ipoc_tpu_torch import solve_stream, solve_stream_multigrid
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy, to_numpy
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.problem import barrier_ocp as t_barrier_ocp
from ipoc_tpu_torch.utils.integrators import euler as t_euler

torch.set_num_threads(1)

CFG = ipoc_tpu.BATCH_CONFIG
T = 40


def _pool(n=6, Tn=T, seed=7):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    return (0.1 * rng.normal(size=(n, Tn, 1)),
            x0 + 0.05 * rng.normal(size=(n, 2)))


def _compare(got, ref, fields):
    for field in fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls),
                               rtol=0, atol=1e-8)


def test_multigrid_ddp_coarse_matches_jax():
    u0, x0b = _pool()
    ref = jax.jit(lambda u, x: j_multigrid(
        j_pendulum.make_ocp(1.0 / T), j_pendulum.make_ocp(4.0 / T), 4, u, x,
        CFG, lanes=3, coarse_impl="ddp"))(jnp.asarray(u0), jnp.asarray(x0b))
    got = to_numpy(solve_stream_multigrid(
        t_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(4.0 / T), 4,
        *pool_from_numpy(u0, x0b), config_from_jax(CFG), lanes=3,
        coarse_impl="ddp"))
    _compare(got, ref, ("iterations", "iterations_coarse", "steps",
                        "steps_coarse"))
    assert (got.iterations_coarse > 0).all() and (got.iterations > 0).all()


def test_multigrid_infeasible_warmstart_falls_back():
    """Every coarse solution rides the looser box |u| <= 5 of the coarse
    problem and violates the fine problem's |u| <= 2.5 where the bound is
    active: those scenarios replay the cold single-grid solve."""
    u0, x0b = _pool()

    def j_tight(state, control):
        return jnp.concatenate([control - 2.5, -control - 2.5])

    def t_tight(state, control):
        return torch.cat([control - 2.5, -control - 2.5], -1)

    j_ocp = j_barrier_ocp(j_euler(j_pendulum.ode, 1.0 / T), j_tight,
                          j_pendulum.stage_cost, j_pendulum.final_cost)
    t_ocp = t_barrier_ocp(t_euler(t_pendulum.ode, 1.0 / T), t_tight,
                          t_pendulum.stage_cost, t_pendulum.final_cost)
    ref = jax.jit(lambda u, x: j_multigrid(
        j_ocp, j_pendulum.make_ocp(4.0 / T), 4, u, x, CFG, lanes=3,
        coarse_impl="ddp"))(jnp.asarray(u0), jnp.asarray(x0b))
    tcfg = config_from_jax(CFG)
    got = to_numpy(solve_stream_multigrid(
        t_ocp, t_pendulum.make_ocp(4.0 / T), 4, *pool_from_numpy(u0, x0b),
        tcfg, lanes=3, coarse_impl="ddp"))
    _compare(got, ref, ("iterations", "iterations_coarse", "steps",
                        "steps_coarse"))
    cold = to_numpy(solve_stream(t_ocp, *pool_from_numpy(u0, x0b), tcfg,
                                 lanes=3))
    fell_back = got.iterations == cold.iterations
    assert fell_back.any()
    np.testing.assert_allclose(got.controls[fell_back],
                               cold.controls[fell_back], rtol=1e-12,
                               atol=1e-12)
    jcold = jax.jit(lambda u, x: j_solve_stream(j_ocp, u, x, CFG, lanes=3))(
        jnp.asarray(u0), jnp.asarray(x0b))
    np.testing.assert_array_equal(cold.iterations,
                                  np.asarray(jcold.iterations))


def test_multigrid_rejects_bad_horizon():
    u0, x0b = _pool(Tn=42)
    with pytest.raises(ValueError, match="divisible"):
        solve_stream_multigrid(
            t_pendulum.make_ocp(1.0 / 42), t_pendulum.make_ocp(4.0 / 42), 4,
            *pool_from_numpy(u0, x0b), config_from_jax(CFG), lanes=3)
