"""The port's receding-horizon loops (``ipoc_tpu_torch/mpc.py``) against
the JAX package's (``ipoc_tpu/mpc.py``), float64 on the CPU.

* ``lqt_mpc_loop``, par and seq, against JAX's on
  ``examples/linear_mpc.py``'s ``build_lqt`` (T=5, 300 steps): within
  1e-10, and par equal to seq within 1e-10; regulation to the origin
  (T=10, dt 0.01, 2000 steps, ``||x|| < 1e-2``).
* ``nmpc_loop`` with ``par_interior_point_optimal_control`` against JAX's
  on pendulum (T=15, 10 steps, ``FAST_CONFIG`` capped at 20 Newton
  iterations a stage): within 1e-8.
* ``nmpc_loop_batched`` and ``nmpc_loop_batched_warm`` on
  ``solve_batch_packed`` (cold, and warm at ``bp_entry=0.02``) against the
  JAX loops with a vmapped flat-lane resolve (the per-lane semantics JAX
  pins its ``solve_batch_packed`` to; the warm one opened at the entry
  barrier with the cold fallback per lane), pendulum T=12, B=6, 4 steps:
  within 1e-8.
* ``nmpc_loop_batched_warm`` refuses ``n_steps=0``.
* ``chip_smoke.py``'s LQT (it imports no jax) is ``build_lqt``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import ipoc_tpu
import ipoc_tpu_torch
from ipoc_tpu import mpc as j_mpc
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.solvers.ip_newton import flat_lane_init as j_flat_lane_init
from ipoc_tpu.solvers.ip_newton import flat_lane_iter as j_flat_lane_iter
from ipoc_tpu_torch import mpc
from ipoc_tpu_torch.interop import config_from_jax
from ipoc_tpu_torch.models import pendulum
from ipoc_tpu_torch.parallel.lqt import LQT
from ipoc_tpu_torch.solvers.packed_stream import solve_batch_packed

torch.set_num_threads(1)

X0 = [2.0, 1.0]


def _lqts(T, dt):
    """JAX's LQT from ``examples/linear_mpc.py`` and the port's, one lane."""
    from examples.linear_mpc import build_lqt

    jl = build_lqt(T=T, dt=dt, dtype=jnp.float64)
    tl = LQT(*(torch.tensor(np.asarray(f))[None] for f in jl))
    return jl, tl


def test_lqt_mpc_matches_jax_and_par_equals_seq():
    jl, tl = _lqts(5, 1e-3)
    x0 = torch.tensor([X0], dtype=torch.float64)
    got = {m: mpc.lqt_mpc_loop(tl, x0, 300, m) for m in ("par", "seq")}
    for mode, (xs, us) in got.items():
        assert xs.shape == (300, 1, 2) and us.shape == (300, 1, 1)
        xj, uj = jax.jit(lambda x, m=mode: j_mpc.lqt_mpc_loop(jl, x, 300, m))(
            jnp.asarray(X0, jnp.float64))
        np.testing.assert_allclose(xs[:, 0].numpy(), np.asarray(xj),
                                   rtol=0, atol=1e-10, err_msg=mode)
        np.testing.assert_allclose(us[:, 0].numpy(), np.asarray(uj),
                                   rtol=0, atol=1e-10, err_msg=mode)
    for a, b in zip(got["par"], got["seq"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)
    with pytest.raises(ValueError):
        mpc.lqt_mpc_loop(tl, x0, 1, "bogus")


def test_lqt_mpc_regulates_to_origin():
    _, tl = _lqts(10, 0.01)
    xs, _ = mpc.lqt_mpc_loop(tl, torch.tensor([X0], dtype=torch.float64),
                             2000, "par")
    assert float(torch.linalg.vector_norm(xs[-1])) < 1e-2


def test_nmpc_loop_matches_jax():
    T, steps = 15, 10
    jcfg = ipoc_tpu.FAST_CONFIG.replace(max_newton_iters=20)
    jocp = j_pendulum.make_ocp(0.05)
    xj, uj = jax.jit(lambda x, u: j_mpc.nmpc_loop(
        lambda uu, xx: ipoc_tpu.par_interior_point_optimal_control(
            jocp, uu, xx, jcfg)[0],
        jocp.dynamics, x, u, steps))(j_pendulum.initial_state(jnp.float64),
                                     jnp.zeros((T, 1)))
    ocp, cfg = pendulum.make_ocp(0.05), config_from_jax(jcfg)
    xs, us = mpc.nmpc_loop(
        lambda uu, xx: ipoc_tpu_torch.par_interior_point_optimal_control(
            ocp, uu, xx, cfg)[0],
        ocp.dynamics, pendulum.initial_state(torch.float64),
        torch.zeros((T, 1), dtype=torch.float64), steps)
    assert xs.shape == (steps, 2) and us.shape == (steps, 1)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(us.numpy(), np.asarray(uj), rtol=0, atol=1e-8)
    assert float(us.abs().max()) <= pendulum.CONTROL_BOUND


T, B, STEPS, BP_ENTRY = 12, 6, 4, 0.02
COLD = ipoc_tpu.BATCH_CONFIG
WARM = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=12)


def _jax_resolver(jocp, cfg, bp_entry=None):
    """A vmapped flat-lane resolve: each lane opened cold, or at
    ``bp_entry`` where that open is feasible, iterated until done."""

    def one(u, x):
        lane = j_flat_lane_init(jocp, u, x, cfg)
        if bp_entry is not None:
            warm = j_flat_lane_init(jocp, u, x, cfg,
                                    bp0=jnp.asarray(bp_entry, u.dtype))
            lane = jax.tree.map(lambda w, c: jnp.where(warm.done, c, w),
                                warm, lane)
        lane = lax.while_loop(lambda ln: ~ln.done,
                              lambda ln: j_flat_lane_iter(jocp, ln, cfg,
                                                          ~ln.done), lane)
        return lane.u

    return jax.vmap(one)


def _batched_setup():
    rng = np.random.default_rng(5)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    x0s = x0 + 0.02 * rng.normal(size=(B, 2))
    return j_pendulum.make_ocp(1.0 / T), pendulum.make_ocp(1.0 / T), x0s


def _port_resolver(ocp, cfg, **kw):
    tcfg = config_from_jax(cfg)
    return lambda u, x: solve_batch_packed(ocp, u, x, tcfg, k_block=8,
                                           **kw)[0]


@pytest.mark.parametrize("warm", [False, True])
def test_nmpc_loop_batched_matches_jax(warm):
    jocp, ocp, x0s = _batched_setup()
    u_init = np.zeros((B, T, 1))
    if warm:
        xj, uj = jax.jit(lambda x, u: j_mpc.nmpc_loop_batched_warm(
            _jax_resolver(jocp, COLD), _jax_resolver(jocp, WARM, BP_ENTRY),
            jocp.dynamics, x, u, STEPS))(jnp.asarray(x0s),
                                         jnp.asarray(u_init))
        xs, us = mpc.nmpc_loop_batched_warm(
            _port_resolver(ocp, COLD),
            _port_resolver(ocp, WARM, bp_entry=BP_ENTRY), ocp.dynamics,
            torch.tensor(x0s), torch.tensor(u_init), STEPS)
    else:
        xj, uj = jax.jit(lambda x, u: j_mpc.nmpc_loop_batched(
            _jax_resolver(jocp, COLD), jocp.dynamics, x, u, STEPS))(
            jnp.asarray(x0s), jnp.asarray(u_init))
        xs, us = mpc.nmpc_loop_batched(
            _port_resolver(ocp, COLD), ocp.dynamics, torch.tensor(x0s),
            torch.tensor(u_init), STEPS)
    assert xs.shape == (STEPS, B, 2) and us.shape == (STEPS, B, 1)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(us.numpy(), np.asarray(uj), rtol=0, atol=1e-8)


def test_nmpc_loop_batched_warm_needs_a_step():
    """The warm loop refuses n_steps=0 (its first step is the cold
    resolve); the other loops return empty trajectories, as JAX's scan."""
    with pytest.raises(ValueError, match="n_steps >= 1"):
        mpc.nmpc_loop_batched_warm(None, None, None, torch.zeros((1, 2)),
                                   torch.zeros((1, 3, 1)), 0)
    _, tl = _lqts(5, 1e-3)
    xs, us = mpc.lqt_mpc_loop(tl, torch.zeros((1, 2), dtype=torch.float64),
                              0)
    assert xs.shape == (0, 1, 2) and us.shape == (0, 1, 1)
    xs, us = mpc.nmpc_loop(None, None, torch.zeros(2), torch.zeros((3, 1)),
                           0)
    assert xs.shape == (0, 2) and us.shape == (0, 1)
    xs, us = mpc.nmpc_loop_batched(None, None, torch.zeros((4, 2)),
                                   torch.zeros((4, 3, 1)), 0)
    assert xs.shape == (0, 4, 2) and us.shape == (0, 4, 1)


def test_chip_smoke_lqt_is_linear_mpc_build():
    import chip_smoke

    for T_, dt in ((5, 1e-3), (10, 0.01)):
        jl, tl = _lqts(T_, dt)
        got = chip_smoke.double_integrator_lqt(T_, dt, torch.float64, "cpu")
        for name, a, b in zip(LQT._fields, got, tl):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-15, err_msg=name)
