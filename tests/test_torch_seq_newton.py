"""The sequential Newton trial and costate recursion of the port
(``ops/cuda/seq_newton.py``) against the JAX package.

On the CPU the wrappers run the plain versions, held here to

* the JAX scans (``_seq_trial_scan``, ``seq_costates``) in float64:
  du/dx atol 1e-9 * scale, pred rtol 1e-9, ok equal, lam atol 1e-12 * scale;
* the JAX Pallas kernels in interpret mode (``seq_newton_trial_batched``,
  ``seq_costates_batched``) in float32, at the JAX suite's own
  kernel-vs-scan tolerances: atol 2e-5 * scale, pred rtol 1e-4, ok equal,
  lam atol 1e-5 * scale.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them to the plain versions there (``chip_smoke.py`` does the same at
the slice's full width).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.derivatives import compute_first_order, compute_hamiltonian_lqr
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    seq_costates_batched as j_costates_kernel,
)
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    seq_newton_trial_batched as j_trial_kernel,
)
from ipoc_tpu.parallel.costates import seq_costates as j_seq_costates
from ipoc_tpu.problem import Derivatives, LinearizedOCP
from ipoc_tpu.solvers.ip_newton import _regularized, _seq_trial_scan
from ipoc_tpu.utils.integrators import rollout
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.cuda.seq_newton import (
    seq_costates_batched,
    seq_costates_plain,
    seq_newton_trial_batched,
    seq_newton_trial_plain,
)

torch.set_num_threads(1)

B = 3


def _slice_data(model, T, seed, dtype=jnp.float64, rp=1.0, bp=0.1):
    """Per-lane Newton stage data at a random warm start (lanes differ in
    their initial states and controls), with lam_T and the costates."""
    rng = np.random.default_rng(seed)
    ocp = model.make_ocp(1.0 / T)
    x0 = np.asarray(model.initial_state(jnp.float64))
    U = jnp.asarray(0.1 * rng.normal(size=(B, T, 1)), dtype)
    X0 = jnp.asarray(x0 + 0.01 * rng.normal(size=(B, x0.shape[0])), dtype)

    def lane(u, x0_):
        X = rollout(ocp.dynamics, u, x0_)
        d = compute_first_order(ocp, X, u, dtype(bp))
        lam = j_seq_costates(ocp, X[-1], d)
        lin = compute_hamiltonian_lqr(ocp, X, u, lam, dtype(bp))
        lin_reg = _regularized(lin, d, dtype(rp), True)
        XT = jax.hessian(ocp.final_cost)(X[-1])
        lam_T = jax.grad(ocp.final_cost)(X[-1])
        return (lin_reg.r, lin_reg.Q, lin_reg.R, lin_reg.M, d.fx, d.fu,
                XT), (d.cx, d.fx, lam_T), lam

    trial, cost_in, lam = jax.vmap(lane)(U, X0)
    as_np = lambda t: tuple(np.asarray(a) for a in t)
    return as_np(trial), as_np(cost_in), np.asarray(lam)


def _random_data(nx, nu, T, seed, dtype=np.float64):
    """Random well-conditioned stage data (the JAX suite's nu > 1 pin)."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: 0.3 * rng.normal(size=s)
    A = rnd(B, T, nx, nx)
    Q = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(nx)
    Br = rnd(B, T, nu, nu)
    R = Br @ np.swapaxes(Br, -1, -2) + 2 * np.eye(nu)
    Xa = rnd(B, nx, nx)
    XT = Xa @ np.swapaxes(Xa, -1, -2) + np.eye(nx)
    out = (rnd(B, T, nu), Q, R, 0.1 * rnd(B, T, nx, nu), rnd(B, T, nx, nx),
           rnd(B, T, nx, nu), XT)
    return tuple(a.astype(dtype) for a in out)


def _jax_scan(trial):
    ru, Q, R, M, fx, fu, XT = (jnp.asarray(a) for a in trial)

    def one(ru, Q, R, M, fx, fu, XT):
        d = Derivatives(None, None, None, None, None, fx, fu, None, None,
                        None)
        return _seq_trial_scan(LinearizedOCP(ru, Q, R, M), d, XT)

    return tuple(np.asarray(o) for o in jax.vmap(one)(ru, Q, R, M, fx, fu, XT))


def _assert_trial(got, ref, atol, pred_rtol):
    du, dx, pred, ok = (g.numpy() for g in got)
    du_r, dx_r, pred_r, ok_r = ref
    scale = float(np.abs(du_r).max()) + 1e-30
    np.testing.assert_allclose(du, du_r, rtol=0, atol=atol * scale)
    np.testing.assert_allclose(dx, dx_r, rtol=0, atol=atol * scale)
    np.testing.assert_allclose(pred, pred_r, rtol=pred_rtol)
    np.testing.assert_array_equal(ok, ok_r)


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@functools.cache
def _case(name):
    """float64 stage data of one case, built once per test process."""
    if name == "cartpole":
        return _slice_data(j_cartpole, 12, 0)[0]
    if name == "pendulum":
        return _slice_data(j_pendulum, 10, 1)[0]
    return _random_data(3, 2, 7, 2)


CASES = ("cartpole", "pendulum", "random_nx3_nu2")


@pytest.mark.parametrize("case", CASES)
def test_plain_trial_matches_jax_scan(case):
    """float64: the port's wrapper on CPU tensors (the plain version) ==
    the JAX sequential scan, lane by lane."""
    trial = _case(case)
    cuda.reset_launches()
    got = seq_newton_trial_batched(*_t(trial))
    _assert_trial(got, _jax_scan(trial), 1e-9, 1e-9)
    assert cuda.launches["seq_newton_trial"] == 0


@pytest.mark.parametrize("case", CASES)
def test_plain_trial_matches_jax_kernel_interpret(case):
    """float32: the plain version == the JAX Pallas trial kernel run in
    interpret mode, at the JAX suite's kernel-vs-scan tolerances."""
    trial = tuple(a.astype(np.float32) for a in _case(case))
    with jax.enable_x64(False):
        ref = j_trial_kernel(*(jnp.asarray(a) for a in trial),
                             interpret=True)
    ref = tuple(np.asarray(r) for r in ref)
    got = seq_newton_trial_plain(*_t(trial))
    assert got[0].dtype == torch.float32
    _assert_trial(got, ref, 2e-5, 1e-4)


def test_indefinite_control_weight_flags_infeasible():
    """R - 1e3 I must trip ok=False, in the port and in the JAX kernel."""
    trial = list(a.astype(np.float32) for a in _case("cartpole"))
    trial[2] = trial[2] - 1e3 * np.eye(1, dtype=np.float32)
    ok = seq_newton_trial_batched(*_t(trial))[3]
    assert not bool(ok.any())
    with jax.enable_x64(False):
        ok_j = j_trial_kernel(*(jnp.asarray(a) for a in trial),
                              interpret=True)[3]
    assert not bool(jnp.any(ok_j))
    trial64 = list(_case("random_nx3_nu2"))
    trial64[2] = trial64[2] - 1e3 * np.eye(2)
    ok64 = seq_newton_trial_batched(*_t(trial64))[3]
    np.testing.assert_array_equal(ok64.numpy(), _jax_scan(trial64)[3])
    assert not bool(ok64.any())


@pytest.fixture(scope="module")
def costate_data():
    _, cost_in, lam = _slice_data(j_cartpole, 12, 0, jnp.float64)
    return cost_in, lam


def test_plain_costates_match_jax(costate_data):
    """float64 against ``seq_costates`` (lam atol 1e-12 * scale), float32
    against the JAX costate kernel in interpret mode (atol 1e-5 * scale)."""
    cost_in, lam_ref = costate_data
    cuda.reset_launches()
    lam = seq_costates_batched(*_t(cost_in)).numpy()
    scale = float(np.abs(lam_ref).max())
    np.testing.assert_allclose(lam, lam_ref, rtol=0, atol=1e-12 * scale)
    assert cuda.launches["seq_costates"] == 0

    c32 = tuple(a.astype(np.float32) for a in cost_in)
    with jax.enable_x64(False):
        ref32 = np.asarray(j_costates_kernel(*(jnp.asarray(a) for a in c32),
                                             interpret=True))
    lam32 = seq_costates_plain(*_t(c32)).numpy()
    np.testing.assert_allclose(lam32, ref32, rtol=0, atol=1e-5 * scale)


def test_nx3_costates_match_jax_kernel_interpret():
    """nx=3 costates (the nu>1 pin's state size) against the JAX costate
    kernel in interpret mode, float32."""
    fx = _random_data(3, 2, 7, 4, np.float32)[4]
    rng = np.random.default_rng(5)
    cx = rng.normal(size=(B, 7, 3)).astype(np.float32)
    lam_T = rng.normal(size=(B, 3)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(j_costates_kernel(jnp.asarray(cx), jnp.asarray(fx),
                                           jnp.asarray(lam_T),
                                           interpret=True))
    got = seq_costates_batched(*_t((cx, fx, lam_T))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_wrappers_take_only_cpu_or_cuda():
    """Tensors on another device (or mixed devices) raise: the plain
    version serves CPU tensors only."""
    trial = _case("pendulum")
    meta = tuple(torch.empty(a.shape, dtype=torch.float64, device="meta")
                 for a in trial)
    with pytest.raises(ValueError, match="expected all on"):
        seq_newton_trial_batched(*meta)
    with pytest.raises(ValueError, match="expected all on"):
        seq_costates_batched(*meta[4:5], *meta[4:5], meta[6][..., 0])
