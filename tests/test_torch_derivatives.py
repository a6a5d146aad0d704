"""The port's derivative engine and small linear algebra against the JAX
package's, float64, atol 1e-10.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops import derivatives as jd
from ipoc_tpu.ops import linalg as jl
from ipoc_tpu.parallel.costates import seq_costates as j_seq_costates
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import derivatives as td
from ipoc_tpu_torch.ops import linalg as tl

torch.set_num_threads(1)

ATOL = 1e-10
MODELS = {
    "pendulum": (j_pendulum, t_pendulum, 2),
    "cartpole": (j_cartpole, t_cartpole, 4),
}


def _trajectories(nx, B=3, T=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, T + 1, nx))
    U = rng.normal(size=(B, T, 1))
    U[1, 2, 0] = 80.0  # outside both models' boxes: infeasible lane
    bp = rng.uniform(0.01, 0.2, size=(B,))
    lam = rng.normal(size=(B, T + 1, nx))
    return X, U, bp, lam


@pytest.fixture(scope="module", params=list(MODELS))
def both(request):
    jm, tm, nx = MODELS[request.param]
    X, U, bp, lam = _trajectories(nx)
    jocp, tocp = jm.make_ocp(0.05), tm.make_ocp(0.05)
    return jocp, tocp, X, U, bp, lam


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL,
                               equal_nan=True)


def test_first_order_matches_jax(both):
    jocp, tocp, X, U, bp, _ = both
    dj = jax.vmap(lambda x, u, b: jd.compute_first_order(jocp, x, u, b))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(bp))
    dt = td.compute_first_order(tocp, torch.tensor(X), torch.tensor(U),
                                torch.tensor(bp))
    for name in ("cx", "cu", "fx", "fu"):
        _close(getattr(dt, name), getattr(dj, name))


def test_hamiltonian_lqr_matches_jax(both):
    jocp, tocp, X, U, bp, lam = both
    lj = jax.vmap(
        lambda x, u, l, b: jd.compute_hamiltonian_lqr(jocp, x, u, l, b))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(lam), jnp.asarray(bp))
    lt = td.compute_hamiltonian_lqr(tocp, torch.tensor(X), torch.tensor(U),
                                    torch.tensor(lam), torch.tensor(bp))
    for name in ("r", "Q", "R", "M"):
        _close(getattr(lt, name), getattr(lj, name))


def test_terminal_derivatives_and_costates_match_jax(both):
    """XT = hessian(final_cost), lam_T = grad(final_cost), and the costate
    recursion of ``parallel/costates.py`` on the CPU (plain version)."""
    from ipoc_tpu_torch.parallel.costates import seq_costates

    jocp, tocp, X, U, bp, _ = both
    xT = X[:, -1]
    _close(td.final_hessian(tocp, torch.tensor(xT)),
           jax.vmap(jax.hessian(jocp.final_cost))(jnp.asarray(xT)))
    _close(td.final_gradient(tocp, torch.tensor(xT)),
           jax.vmap(jax.grad(jocp.final_cost))(jnp.asarray(xT)))
    dj = jax.vmap(lambda x, u, b: jd.compute_first_order(jocp, x, u, b))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(bp))
    lam_j = jax.vmap(lambda x, d: j_seq_costates(jocp, x, d))(
        jnp.asarray(xT), dj)
    dt = td.compute_first_order(tocp, torch.tensor(X), torch.tensor(U),
                                torch.tensor(bp))
    lam_t = seq_costates(tocp, torch.tensor(xT), dt)
    scale = float(np.abs(np.asarray(lam_j)).max())
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=0,
                               atol=1e-12 * scale)


def test_feasibility_matches_jax(both):
    jocp, tocp, X, U, _, _ = both
    fj = jax.vmap(lambda x, u: jd.check_feasibility(jocp, x, u))(
        jnp.asarray(X), jnp.asarray(U))
    ft = td.check_feasibility(tocp, torch.tensor(X), torch.tensor(U))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert not bool(ft[1]) and bool(ft[0])


def test_float32_derivatives_stay_float32():
    """Every derivative of the float32 path is float32 (forward-mode
    torch.func promotes some of them to float64; the port uses reverse)."""
    X, U, bp, lam = _trajectories(4)
    ocp = t_cartpole.make_ocp(0.05)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    d = td.compute_first_order(ocp, f(X), f(U), f(bp))
    lin = td.compute_hamiltonian_lqr(ocp, f(X), f(U), f(lam), f(bp))
    outs = [d.cx, d.cu, d.fx, d.fu, *lin,
            td.final_hessian(ocp, f(X[:, -1])),
            td.final_gradient(ocp, f(X[:, -1]))]
    assert all(o.dtype == torch.float32 for o in outs)


def test_linalg_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 3, 3))
    spd = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(3)
    b = rng.normal(size=(4, 3, 2))
    _close(tl.sym(torch.tensor(A)), jl.sym(jnp.asarray(A)))
    _close(tl._cholesky_small(torch.tensor(spd)),
           jl._cholesky_small(jnp.asarray(spd)))
    _close(tl.cholesky_solve(torch.tensor(spd), torch.tensor(b)),
           jl.cholesky_solve(jnp.asarray(spd), jnp.asarray(b)))
    v = rng.normal(size=(3,))
    _close(tl.cholesky_solve(torch.tensor(spd[0]), torch.tensor(v)),
           jl.cholesky_solve(jnp.asarray(spd[0]), jnp.asarray(v)))
    for M in (spd, spd - 10 * np.eye(3)):
        assert bool(tl.is_posdef(torch.tensor(M))) == bool(
            jl.is_posdef(jnp.asarray(M)))
