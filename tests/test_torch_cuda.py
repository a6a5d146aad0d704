"""The port's CUDA kernels on a card, held to their plain versions.

These tests need a CUDA device and skip without one; they import no jax, so
they also run where jax is not installed.  From the root of a checkout, on
a machine with a card:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up jax.)

Tolerances, kernel against plain version on the same card: float64
du/dx atol 1e-10 * scale, pred rtol 1e-10, lam atol 1e-12 * scale; float32
the JAX suite's kernel-vs-scan tolerances, atol 2e-5 * scale, pred rtol
1e-4, lam atol 1e-5 * scale; ok flags equal.
"""

import numpy as np
import pytest
import torch

from ipoc_tpu_torch import BATCH_CONFIG, solve_stream
from ipoc_tpu_torch.models import cartpole, pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.cuda.seq_newton import (
    seq_costates_batched,
    seq_costates_plain,
    seq_newton_trial_batched,
    seq_newton_trial_plain,
)
from ipoc_tpu_torch.ops.derivatives import (
    compute_first_order,
    compute_hamiltonian_lqr,
    final_gradient,
    final_hessian,
)
from ipoc_tpu_torch.solvers.ip_newton import _regularized
from ipoc_tpu_torch.utils.integrators import rollout

pytestmark = pytest.mark.cuda

TOLS = {torch.float64: (1e-10, 1e-10, 1e-12),
        torch.float32: (2e-5, 1e-4, 1e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _model_data(model, B, T, seed, dtype, device):
    """Trial and costate inputs at a random warm start of ``model``."""
    rng = np.random.default_rng(seed)
    ocp = model.make_ocp(1.0 / T)
    x0 = model.initial_state(torch.float64).numpy()
    u = torch.tensor(0.1 * rng.normal(size=(B, T, 1)), dtype=dtype,
                     device=device)
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(B, x0.shape[0])),
                       dtype=dtype, device=device)
    x = rollout(ocp.dynamics, u, x0b)
    bp = torch.full((B,), 0.1, dtype=dtype, device=device)
    d = compute_first_order(ocp, x, u, bp)
    lam_T = final_gradient(ocp, x[:, -1])
    lam = seq_costates_plain(d.cx, d.fx, lam_T)
    lin = _regularized(compute_hamiltonian_lqr(ocp, x, u, lam, bp), d,
                       torch.full((B,), 1.0, dtype=dtype, device=device),
                       True)
    trial = (lin.r, lin.Q, lin.R, lin.M, d.fx, d.fu,
             final_hessian(ocp, x[:, -1]))
    return (tuple(a.contiguous() for a in trial),
            tuple(a.contiguous() for a in (d.cx, d.fx, lam_T)))


def _random_data(B, T, nx, nu, seed, dtype, device):
    rng = np.random.default_rng(seed)
    rnd = lambda *s: 0.3 * rng.normal(size=s)
    A = rnd(B, T, nx, nx)
    Q = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(nx)
    Br = rnd(B, T, nu, nu)
    R = Br @ np.swapaxes(Br, -1, -2) + 2 * np.eye(nu)
    Xa = rnd(B, nx, nx)
    XT = Xa @ np.swapaxes(Xa, -1, -2) + np.eye(nx)
    fx = rnd(B, T, nx, nx)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device).contiguous()
    trial = tuple(t(a) for a in (rnd(B, T, nu), Q, R, 0.1 * rnd(B, T, nx, nu),
                                 fx, rnd(B, T, nx, nu), XT))
    return trial, (t(rnd(B, T, nx)), t(fx), t(rnd(B, nx)))


def _data(case, dtype, device):
    if case == "cartpole":
        return _model_data(cartpole, 64, 40, 0, dtype, device)
    if case == "pendulum":
        return _model_data(pendulum, 64, 40, 1, dtype, device)
    return _random_data(64, 40, 3, 2, 2, dtype, device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["cartpole", "pendulum", "random_nx3_nu2"])
def test_kernels_match_plain(card, case, dtype):
    tol, pred_rtol, lam_tol = TOLS[dtype]
    trial, costate = _data(case, dtype, card)
    cuda.reset_launches()
    du, dx, pred, ok = seq_newton_trial_batched(*trial)
    lam = seq_costates_batched(*costate)
    torch.cuda.synchronize()
    assert cuda.launches == {"seq_newton_trial": 1, "seq_costates": 1}
    du_p, dx_p, pred_p, ok_p = seq_newton_trial_plain(*trial)
    assert torch.equal(ok, ok_p) and bool(ok.all())
    scale = float(du_p.abs().max())
    assert float((du - du_p).abs().max()) <= tol * scale
    assert float((dx - dx_p).abs().max()) <= tol * scale
    assert float(((pred - pred_p).abs() / pred_p.abs()).max()) <= pred_rtol
    lam_p = seq_costates_plain(*costate)
    assert float((lam - lam_p).abs().max()) <= lam_tol * float(
        lam_p.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_indefinite_control_weight_flags_infeasible(card, dtype):
    trial, _ = _data("cartpole", dtype, card)
    ru, Q, R, M, fx, fu, XT = trial
    bad = (ru, Q, (R - 1e3).contiguous(), M, fx, fu, XT)
    assert not bool(seq_newton_trial_batched(*bad)[3].any())
    assert not bool(seq_newton_trial_plain(*bad)[3].any())


def test_uninstantiated_shape_raises(card):
    trial, costate = _random_data(4, 5, 5, 1, 3, torch.float32, card)
    with pytest.raises(NotImplementedError):
        seq_newton_trial_batched(*trial)
    with pytest.raises(NotImplementedError):
        seq_costates_batched(*costate)


def test_stream_on_card_matches_cpu(card):
    """A small float64 pendulum stream on the card (kernels) against the
    CPU (plain versions): both kernels launch once per step, and converged
    raw costs agree to rtol 1e-8 (an accept decision may flip within
    rounding, so iteration counts may differ on a lane)."""
    cfg = BATCH_CONFIG.replace(newton_impl="seq", bp_min=4.1e-3)
    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(4)
    x0 = pendulum.initial_state(torch.float64).numpy()
    u0 = torch.tensor(0.1 * rng.normal(size=(8, T, 1)))
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(8, 2)))
    cuda.reset_launches()
    got = solve_stream(ocp, u0.to(card), x0b.to(card), cfg, lanes=3,
                       refill_every=5)
    assert cuda.launches == {"seq_newton_trial": got.steps,
                             "seq_costates": got.steps}
    ref = solve_stream(ocp, u0, x0b, cfg, lanes=3, refill_every=5)
    assert int((got.iterations.cpu() != ref.iterations).sum()) <= 1

    def raw(u):
        return ocp.total_cost(rollout(ocp.dynamics, u, x0b), u,
                              torch.tensor(1e-9, dtype=torch.float64))

    np.testing.assert_allclose(raw(got.controls.cpu()).numpy(),
                               raw(ref.controls).numpy(), rtol=1e-8)
