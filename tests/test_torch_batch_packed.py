"""The port's lockstep packed batch, ``solve_batch_packed``
(``solvers/packed_stream.py``), against the JAX package, float64 on the
CPU (the mega kernel's plain version).

* Newton and DDP, cold: equal to JAX's flat lanes (vmapped
  ``flat_lane_init``/``flat_lane_iter``, the per-lane semantics JAX pins
  its own ``solve_batch_packed`` to) on pendulum T=10, B=6 with one
  non-finite warm start: equal iterations, controls within 1e-8.
* ``bp_entry``: equal to JAX's flat lanes opened at ``bp0=bp_entry``,
  each lane falling back to its cold open where that open is infeasible
  (the fallback composed here), on a warm start with an infeasible lane.
* JAX's own criteria for the warm entry under ``BATCH_CONFIG``: an
  infeasible warm start (|u| = 10 > the bound 5) gives the cold call bit
  for bit; a warm resolve from the cold solution reaches the same raw
  costs (rel 2e-5) in fewer mean iterations.
* No kernel launch on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.solvers.ip_newton import flat_lane_init as j_flat_lane_init
from ipoc_tpu.solvers.ip_newton import flat_lane_iter as j_flat_lane_iter
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.solvers.packed_stream import solve_batch_packed
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

T, B = 10, 6
CFG = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=8, bp_init=0.1,
                                    bp_min=0.021)
BP_ENTRY = 0.05


def _pool(seed=7, bad_lane=2):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u0 = 0.1 * rng.normal(size=(B, T, 1))
    x0b = x0 + 0.02 * rng.normal(size=(B, 2))
    if bad_lane is not None:
        u0[bad_lane] = np.nan
    return u0, x0b


def _jax_flat(cfg, u0, x0b, bp0=None):
    """JAX's flat lanes to completion: cold, or with a warm open at ``bp0``
    kept where it is feasible (``done`` at init falls back to cold)."""
    jocp = j_pendulum.make_ocp(1.0 / T)
    u, x = jnp.asarray(u0), jnp.asarray(x0b)
    lanes = jax.vmap(lambda uu, xx: j_flat_lane_init(jocp, uu, xx, cfg))(u, x)
    if bp0 is not None:
        warm = jax.vmap(lambda uu, xx: j_flat_lane_init(
            jocp, uu, xx, cfg, bp0=jnp.asarray(bp0, jnp.float64)))(u, x)
        ok = ~warm.done

        def sel(w, c):
            return jnp.where(ok.reshape(ok.shape + (1,) * (w.ndim - 1)), w,
                             c)

        lanes = jax.tree.map(sel, warm, lanes)
    step = jax.jit(jax.vmap(lambda ln: j_flat_lane_iter(jocp, ln, cfg,
                                                        ~ln.done)))
    for _ in range(60):
        lanes = step(lanes)
    assert bool(jnp.all(lanes.done))
    return np.asarray(lanes.u), np.asarray(lanes.it)


def _port(cfg, u0, x0b, **kw):
    u, x = pool_from_numpy(u0, x0b)
    return solve_batch_packed(t_pendulum.make_ocp(1.0 / T), u, x,
                              config_from_jax(cfg), k_block=8, **kw)


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_matches_jax_flat_lanes(impl):
    cfg = CFG.replace(newton_impl=impl)
    u0, x0b = _pool()
    ref_u, ref_it = _jax_flat(cfg, u0, x0b)
    u, it = _port(cfg, u0, x0b)
    np.testing.assert_array_equal(it.numpy(), ref_it)
    assert int(it[2]) == 0, "the non-finite warm start must not iterate"
    ok = np.arange(B) != 2
    np.testing.assert_allclose(u.numpy()[ok], ref_u[ok], rtol=0, atol=1e-8)
    assert u.shape == (B, T, 1) and it.dtype == torch.int32


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_bp_entry_matches_jax_with_cold_fallback(impl):
    cfg = CFG.replace(newton_impl=impl)
    u0, x0b = _pool()
    u_cold, _ = _jax_flat(cfg, u0, x0b)
    warm = np.where(np.isfinite(u_cold), u_cold, 0.0)
    warm[4] = 10.0  # beyond the bound 5: falls back to the cold open
    ref_u, ref_it = _jax_flat(cfg, warm, x0b, bp0=BP_ENTRY)
    u, it = _port(cfg, warm, x0b, bp_entry=BP_ENTRY)
    np.testing.assert_array_equal(it.numpy(), ref_it)
    np.testing.assert_allclose(u.numpy(), ref_u, rtol=0, atol=1e-8)


def _raw_cost(ocp, u, x0):
    x = rollout(ocp.dynamics, u, x0)
    return ocp.total_cost(x, u, torch.zeros((), dtype=u.dtype)).numpy()


def test_bp_entry_criteria():
    """JAX ``test_batch_packed_bp_entry``'s criteria under BATCH_CONFIG."""
    cfg = ipoc_tpu.BATCH_CONFIG
    u0, x0b = _pool(seed=3, bad_lane=None)
    cuda.reset_launches()
    u_cold, it_cold = _port(cfg, u0, x0b)
    u_warm, it_warm = _port(cfg, u_cold.numpy(), x0b, bp_entry=0.02)
    bad = 10.0 * np.ones_like(u0)
    u_fb, it_fb = _port(cfg, bad, x0b, bp_entry=0.02)
    u_ref, it_ref = _port(cfg, bad, x0b)
    assert cuda.launches == dict.fromkeys(cuda.launches, 0)
    ocp = t_pendulum.make_ocp(1.0 / T)
    x = torch.as_tensor(x0b)
    c_c, c_w = _raw_cost(ocp, u_cold, x), _raw_cost(ocp, u_warm, x)
    rel = np.abs(c_w - c_c) / (np.abs(c_c) + 1e-9)
    assert float(rel.max()) < 2e-5, "warm re-entry drifted off the optimum"
    assert float(it_warm.double().mean()) < float(it_cold.double().mean())
    assert torch.equal(u_fb, u_ref) and torch.equal(it_fb, it_ref)


def test_refuses_what_the_packed_stream_refuses():
    u0, x0b = _pool(bad_lane=None)
    for bad in (CFG.replace(newton_impl="seq"),
                CFG.replace(globalization="retry"),
                CFG.replace(terminal_hessian="reference")):
        with pytest.raises(ValueError):
            _port(bad, u0, x0b)
