"""The input- and state-constrained cartpole (the cart-position box of
BASELINE.json config 3) in the port, against the JAX package on the CPU,
float64 (``tests/test_state_constraints.py`` mirrored).

* ``make_constraints(cart_limit)``: the force box's two rows, then the
  cart box's two, equal to JAX's on states inside and outside the box;
  without a limit the force box alone.
* The boxed par solve (dt 0.02, H=50, limit 0.12, a numpy warm start):
  JAX's iterations, controls within 1e-8 of JAX's, the iterates strictly
  inside both boxes, and the box binds (the cart comes within 5% of it).
* BASELINE.json config 3 as ``examples/p50_budget.py`` defines it
  (cartpole H=100, dt 0.01, ``cart_limit=0.3``, the par solve under
  ``FAST_CONFIG``): the same terms.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu_torch import FAST_CONFIG, par_interior_point_optimal_control
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

F64 = torch.float64


def test_state_constraint_function():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4)) * 0.4  # cart positions in and out of 0.5
    u = rng.normal(size=(6, 1)) * 30.0
    j_cons = j_cartpole.make_constraints(cart_limit=0.5)
    t_cons = t_cartpole.make_constraints(cart_limit=0.5)
    ref = np.asarray(jax.vmap(j_cons)(jnp.asarray(x), jnp.asarray(u)))
    got = t_cons(torch.tensor(x), torch.tensor(u)).numpy()
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        t_cons(torch.tensor([0.3, 0.1, 0.0, 0.0], dtype=F64),
               torch.tensor([10.0], dtype=F64)).numpy(),
        [10.0 - 50.0, -10.0 - 50.0, 0.3 - 0.5, -0.3 - 0.5])
    # a cart past the limit violates its row
    assert float(t_cons(torch.tensor([0.7, 0.0, 0.0, 0.0], dtype=F64),
                        torch.zeros(1, dtype=F64))[2]) > 0
    assert t_cartpole.make_constraints() is t_cartpole.constraints
    assert t_cartpole.make_ocp(0.02).constraints is t_cartpole.constraints


@pytest.mark.parametrize("case", ["boxed", "baseline_config3"])
def test_state_constrained_solve_matches_jax(case):
    """The boxed par solve (``tests/test_state_constraints.py``'s default
    configuration) and BASELINE.json config 3 (``FAST_CONFIG``)."""
    dt, H, limit, scale, jcfg, tcfg = {
        "boxed": (0.02, 50, 0.12, 0.05, ipoc_tpu.DEFAULT_CONFIG, None),
        "baseline_config3": (0.01, 100, 0.3, 0.1, ipoc_tpu.FAST_CONFIG,
                             FAST_CONFIG)}[case]
    u0 = scale * np.random.default_rng(1).normal(size=(H, 1))
    jocp = j_cartpole.make_ocp(dt, cart_limit=limit)
    uj, ij = jax.jit(lambda u, x: ipoc_tpu.par_interior_point_optimal_control(
        jocp, u, x, jcfg))(jnp.asarray(u0), j_cartpole.initial_state(
            jnp.float64))
    tocp = t_cartpole.make_ocp(dt, cart_limit=limit)
    x0 = t_cartpole.initial_state(F64)
    args = (tocp, torch.tensor(u0), x0) + ((tcfg,) if tcfg else ())
    u, it = par_interior_point_optimal_control(*args)
    assert int(it) == int(ij) > 0
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-8)
    assert bool(torch.isfinite(u).all())
    X = rollout(tocp.dynamics, u, x0)
    cart = float(X[:-1, 0].abs().max())
    assert float(u.abs().max()) < t_cartpole.CONTROL_BOUND
    assert cart < limit
    assert cart > 0.95 * limit  # the box binds
