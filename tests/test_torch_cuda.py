"""The port's CUDA kernels on a card, held to their plain versions.

These tests need a CUDA device and skip without one; they import no jax, so
they also run where jax is not installed.  From the root of a checkout, on
a machine with a card:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up jax.)

Tolerances, kernel against plain version on the same card: float64
du/dx atol 1e-10 * scale, pred rtol 1e-10, lam atol 1e-12 * scale; float32
the JAX suite's kernel-vs-scan tolerances, atol 2e-5 * scale, pred rtol
1e-4, lam atol 1e-5 * scale; ok flags equal.  The four fused kernels
(``ops/fused_iter.py``): every output within 1e-10 of its scale in
float64 and within 1e-4 of its scale in float32 (the generated stage code
runs the same float32 program in another operation order, with FMA
contraction, and the backward sweep carries rounding through T Riccati
steps), equal NaN and inf entries, ok flags equal; the seq trial and the
fused kernels at B=64, T=40 and at every B of {1, 33, 4096} with every T
of {1, 7, 100, 1000} (each scenario a group of lanes there), the seq
trial, the forward sweep and the transition also on inputs off a 16-byte
boundary (bit-equal to aligned ones); the merged trial
(``merged_trial``, Newton and DDP modes) likewise, and with the costate
recursion at every B of {1, 33, 4096} with every T of {1, 7, 25, 100,
1000}, on offset views too.  The mega kernel
(``ops/mega.py``) against its plain version in float64: on all lanes but
at most one (an accept decision may flip within rounding), equal
iteration counts, stage iterations and done flags and every float field
within 1e-10 of its scale; inactive lanes untouched; equal ``steps``; at
T=1000 (the streamed TPU kernel's horizons) likewise over two k-blocks of
2.  The mega kernel's stage ring and ping-pong iterate over T in {7, 25,
100, 1000} (none a multiple of the ring's slot in stages but 100 and 1000;
7 shorter than the ring) and B in {1, 33, 4096}, float64 and float32,
Newton and DDP, predictor on and off, two k-blocks of 2 carried across
launches: in float64 every lane equal, within 1e-12 of each field's scale,
to the two-launch kernels (the same generated code) and all but 1% (at
least one) within 1e-10 of the plain version; in float32 the same
decisions (it, stage_it, done) on all but 1% of lanes against both; in
DDP mode the lanes that the plain version ends as bad (its Cholesky
fails on an indefinite Quu, where the kernels reject the step) held to
the two-launch kernels only; the last lane inactive and untouched.  The rollout kernel: within 1e-12 (float64) and 1e-4 (float32) of its
plain version's scale, the first stage equal to x0.  The rollout kernel
and the rollout-cost kernel: bit for bit the one-thread loops they
replaced (the rollout cost at cartpole; at pendulum within FUSED_TOL).
The scans: within 1e-10 (float64) and 1e-4 (float32) of their plain
versions' scale at every lane count, up to T=1001.  ``solve_batch`` with
the fused and DDP evaluators on the card against the CPU: at most one lane
with other iterations, converged raw costs to rtol 1e-8.
"""

import functools

import numpy as np
import pytest
import torch

from ipoc_tpu_torch import BATCH_CONFIG, solve_stream
from ipoc_tpu_torch.models import cartpole, pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops import mega
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
from ipoc_tpu_torch.solvers import ip_newton
from ipoc_tpu_torch.solvers import packed_stream as ps
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


def _data(case, dtype, device, B=64, T=40):
    if case == "cartpole":
        return _model_data(cartpole, B, T, 0, dtype, device)
    if case == "pendulum":
        return _model_data(pendulum, B, T, 1, dtype, device)
    if case == "random_nx6_nu2":  # the planar quadrotor's shape
        return _random_data(B, T, 6, 2, 6, dtype, device)
    return _random_data(B, T, 3, 2, 2, dtype, device)


# (B, T) of the cases of the kernels that spread a scenario over a group
# of lanes (seq_trial, fused_bwd, fused_fwd, transition): B=64, T=40, and every B of
# {1, 33, 4096} (33: not a whole number of blocks) with every T of
# {1, 7, 100, 1000} (7: a partial chunk; 1000: the longest horizon).
SIZES = [(64, 40)] + [(B, T) for B in (1, 33, 4096) for T in (1, 7, 100, 1000)]


def _size_id(size):
    return f"B{size[0]}-T{size[1]}"


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["cartpole", "pendulum", "random_nx3_nu2",
                                  "random_nx6_nu2"])
def test_kernels_match_plain(card, case, dtype, size):
    tol, pred_rtol, lam_tol = TOLS[dtype]
    trial, costate = _data(case, dtype, card, *size)
    cuda.reset_launches()
    du, dx, pred, ok = seq_newton_trial_batched(*trial)
    lam = seq_costates_batched(*costate)
    torch.cuda.synchronize()
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                 seq_newton_trial=1, seq_costates=1)
    du_p, dx_p, pred_p, ok_p = seq_newton_trial_plain(*trial)
    assert torch.equal(ok, ok_p) and bool(ok.all())
    scale = float(du_p.abs().max())
    assert float((du - du_p).abs().max()) <= tol * scale
    assert float((dx - dx_p).abs().max()) <= tol * scale
    assert float(((pred - pred_p).abs() / pred_p.abs()).max()) <= pred_rtol
    # The costate kernel (a group of lanes per scenario, csrc/costates.h)
    # at every size in float64; in float32 up to T=100, the horizons its
    # 1e-5 was set for: over 1000 float32 stages of the cartpole recursion
    # its rounding and the plain version's part by 1e-5 of lam's scale of
    # 2e4 (on an H100, the one-thread parent kernel likewise).
    if dtype == torch.float64 or size[1] <= 100:
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_seq_trial_unaligned_views(card, dtype):
    """Inputs that are views one element past an allocation's start (off
    the 16-byte boundary of the ring's vector copies), at a B that is not a
    whole number of blocks, give what aligned copies give."""
    args, _ = _data("random_nx3_nu2", dtype, card, B=33, T=7)
    views = tuple(torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
                  for a in args)
    assert all(v.data_ptr() % 16 != 0 and v.is_contiguous() for v in views)
    for got, ref in zip(seq_newton_trial_batched(*views),
                        seq_newton_trial_batched(*args)):
        assert torch.equal(got, ref)


def test_uninstantiated_shape_raises(card):
    trial, costate = _random_data(4, 5, 5, 1, 3, torch.float32, card)
    with pytest.raises(NotImplementedError):
        seq_newton_trial_batched(*trial)
    with pytest.raises(NotImplementedError):
        seq_costates_batched(*costate)
    # (6, 1) beside the quadrotor's instantiated (6, 2).
    with pytest.raises(NotImplementedError):
        seq_newton_trial_batched(*_random_data(4, 5, 6, 1, 3, torch.float32,
                                               card)[0])


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
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                 seq_newton_trial=got.steps,
                                 seq_costates=got.steps)
    ref = solve_stream(ocp, u0, x0b, cfg, lanes=3, refill_every=5)
    assert int((got.iterations.cpu() != ref.iterations).sum()) <= 1

    def raw(u):
        return ocp.total_cost(rollout(ocp.dynamics, u, x0b), u,
                              torch.tensor(1e-9, dtype=torch.float64))

    np.testing.assert_allclose(raw(got.controls.cpu()).numpy(),
                               raw(ref.controls).numpy(), rtol=1e-8)


FUSED_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _close(got, ref, tol):
    """Equal NaN/inf entries; finite entries within ``tol`` of the scale."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], ref[inf])
    fin = torch.isfinite(ref)
    if bool(fin.any()):
        scale = float(ref[fin].abs().max())
        assert float((got[fin] - ref[fin]).abs().max()) <= tol * scale


def _lanes(model, B, T, seed, dtype, device, ocp=None):
    """Batch-last lane inputs: controls, a second control set, initial
    states; the model at dt = 1/T unless ``ocp`` is given."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    u = t(0.1 * rng.normal(size=(T, 1, B)))
    up = t(0.15 * rng.normal(size=(T, 1, B)))
    x0b = t(x0[:, None] + 0.01 * rng.normal(size=(x0.shape[0], B)))
    return ocp or model.make_ocp(1.0 / T), u, up, x0b


@functools.lru_cache(maxsize=None)
def _model_at_step(model, dt):
    """One OCP per model and time step, so that the cases of one model
    share its library (libraries are cached per OCP object)."""
    return model.make_ocp(dt)


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", [cartpole, pendulum],
                         ids=["cartpole", "pendulum"])
def test_fused_kernels_match_plain(card, model, dtype, size):
    """The four fused kernels against their plain versions for every
    (B, T) of SIZES, the model at dt = 1/40 (T=1000: dt = 1/1000, a 1 s
    horizon as at T=40; over 25 s the cartpole's open loop parts from
    itself at rounding)."""
    B, T = size
    tol = FUSED_TOL[dtype]
    ocp, u, up, x0 = _lanes(model, B, T, 5, dtype, card,
                            ocp=_model_at_step(model, 1.0 / (T if T == 1000
                                                             else 40)))
    bp = torch.full((B,), 0.05, dtype=dtype, device=card)
    cuda.reset_launches()
    got = tf.rollout_cost_packed(ocp, u, x0, bp)
    ref = tf.rollout_cost_plain(ocp, u, x0, bp)
    for g, r in zip(got, ref):
        _close(g, r, tol)
    xs, xT, _, cunsq = ref
    reg = 100.0 * torch.sqrt(cunsq)
    got = tf.fused_newton_iter_packed(ocp, xs, xT, u, bp, reg)
    ref = tf.fused_newton_iter_plain(ocp, xs, xT, u, bp, reg)
    for g, r in zip(got, ref):
        _close(g, r, tol)
    ok = [torch.isfinite(o[7]) & (o[7] > 0) & torch.isfinite(o[6])
          for o in (got, ref)]
    assert torch.equal(ok[0], ok[1]) and bool(ok[1].all())
    got = tf.transition_packed(ocp, u, up, x0, bp)
    ref = tf.transition_plain(ocp, u, up, x0, bp)
    for g, r in zip(got, ref):
        _close(g, r, tol)
    torch.cuda.synchronize()
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                 fused_bwd=1, fused_fwd=1, rollout_cost=1,
                                 transition=1)


@pytest.mark.parametrize("T", [7, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_fwd_and_transition_unaligned_views(card, dtype, T):
    """The forward sweep and the transition (csrc/fused_fwd.h,
    csrc/transition.h) on inputs that are views one element past an
    allocation's start (off the 16-byte boundary of their rings' vector
    copies), at B = 33 (not a whole number of 4-scenario blocks), give
    what aligned inputs give, to the bit."""
    B = 33
    ocp, u, up, x0 = _lanes(cartpole, B, T, 7, dtype, card,
                            ocp=_model_at_step(cartpole, 1.0 / 40))
    bp = torch.full((B,), 0.05, dtype=dtype, device=card)
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0, bp)
    Kk = tf.fused_bwd_launch(ocp, xs, xT, u, bp, 100.0 * torch.sqrt(cunsq))[0]

    def view(a):
        v = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
        assert v.data_ptr() % 16 != 0 and v.is_contiguous()
        return v

    fwd = (xs, xT, u, bp, Kk)
    for got, ref in zip(tf.fused_fwd_launch(ocp, *map(view, fwd)),
                        tf.fused_fwd_launch(ocp, *fwd)):
        assert torch.equal(got, ref)
    trans = (u, up, x0, bp)
    for got, ref in zip(tf.transition_packed(ocp, *map(view, trans)),
                        tf.transition_packed(ocp, *trans)):
        assert torch.equal(got, ref)


def test_fused_wrappers_raise_on_what_no_kernel_takes(card):
    ocp, u, up, x0 = _lanes(pendulum, 8, 5, 6, torch.float64, card)
    bp = torch.full((8,), 0.05, dtype=torch.float64, device=card)
    with pytest.raises(NotImplementedError):
        tf.rollout_cost_packed(ocp, u.half(), x0.half(), bp.half())
    with pytest.raises(ValueError):
        tf.rollout_cost_packed(ocp, u.transpose(0, 2).contiguous()
                               .transpose(0, 2), x0, bp)
    with pytest.raises(ValueError):
        tf.transition_packed(ocp, u, up.cpu(), x0, bp)


def test_fused_stream_on_card_matches_cpu(card):
    """A small float64 pendulum packed stream, two-launch arm, on the card
    (four kernels) against the CPU (plain versions): the Newton and transition kernels
    launch once per step, and converged raw costs agree to rtol 1e-8 (an
    accept decision may flip within rounding)."""
    cfg = BATCH_CONFIG.replace(bp_min=4.1e-3)
    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(4)
    x0 = pendulum.initial_state(torch.float64).numpy()
    u0 = torch.tensor(0.1 * rng.normal(size=(8, T, 1)))
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(8, 2)))
    cuda.reset_launches()
    got = ps.solve_stream_packed(ocp, u0.to(card), x0b.to(card), cfg,
                                 lanes=3, refill_every=5, mega=False)
    for k in ("fused_bwd", "fused_fwd", "transition"):
        assert cuda.launches[k] == got.steps, k
    assert 1 <= cuda.launches["rollout_cost"] <= got.steps
    assert cuda.launches["seq_newton_trial"] == 0
    ref = solve_stream(ocp, u0, x0b, cfg, lanes=3, refill_every=5)
    assert int((got.iterations.cpu() != ref.iterations).sum()) <= 1

    def raw(u):
        return ocp.total_cost(rollout(ocp.dynamics, u, x0b), u,
                              torch.tensor(1e-9, dtype=torch.float64))

    np.testing.assert_allclose(raw(got.controls.cpu()).numpy(),
                               raw(ref.controls).numpy(), rtol=1e-8)


# (B, T) of the redesigned merged trial and costate recursion
# (csrc/merged_trial.h, csrc/costates.h): every B of {1, 33, 4096} with
# every T of {1, 7, 25, 100, 1000} (25: the multigrid's coarse level; 7
# and 25: partial chunks).
GROUP_SIZES = [(B, T) for B in (1, 33, 4096) for T in (1, 7, 25, 100, 1000)]


def _offset_view(a):
    """``a`` as a contiguous view one element past an allocation's start
    (off the 16-byte boundary of the rings' vector copies)."""
    v = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    return v


@pytest.mark.parametrize("size", GROUP_SIZES, ids=_size_id)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["cartpole", "pendulum", "random_nx3_nu2"])
def test_costate_kernel_matches_plain(card, case, dtype, size):
    """The costate recursion against its plain version (float64 at every
    size, float32 up to T=100: test_kernels_match_plain's tolerances and
    reason), finite everywhere; at B = 33 on offset views, to the bit of
    the aligned inputs."""
    lam_tol = TOLS[dtype][2]
    B, T = size
    _, costate = _data(case, dtype, card, B, T)
    cuda.reset_launches()
    lam = seq_costates_batched(*costate)
    torch.cuda.synchronize()
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                 seq_costates=1)
    assert bool(torch.isfinite(lam).all())
    if dtype == torch.float64 or T <= 100:
        lam_p = seq_costates_plain(*costate)
        assert float((lam - lam_p).abs().max()) <= lam_tol * float(
            lam_p.abs().max())
    if B == 33:
        assert torch.equal(
            seq_costates_batched(*map(_offset_view, costate)), lam)


@pytest.mark.parametrize("size", [(64, 40)] + GROUP_SIZES, ids=_size_id)
@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", [cartpole, pendulum],
                         ids=["cartpole", "pendulum"])
def test_merged_trial_matches_plain(card, model, dtype, ddp, size):
    """The merged one-launch trial against the plain fused trial of its
    mode, B=64, T=40 and every (B, T) of GROUP_SIZES, the model at dt =
    1/40 (T=1000: dt = 1/1000, as test_fused_kernels_match_plain): every
    output within FUSED_TOL of its scale, equal ok flags; the DDP wrapper
    launches it; at B = 33 on offset views, to the bit of the aligned
    inputs."""
    B, T = size
    tol = FUSED_TOL[dtype]
    ocp, u, _, x0 = _lanes(model, B, T, 7, dtype, card,
                           ocp=_model_at_step(model, 1.0 / (T if T == 1000
                                                            else 40)))
    bp = torch.full((B,), 0.05, dtype=dtype, device=card)
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0, bp)
    reg = 100.0 * torch.sqrt(cunsq)
    cuda.reset_launches()
    got = (tf.fused_newton_iter_packed(ocp, xs, xT, u, bp, reg, ddp=True)
           if ddp else tf.merged_trial_launch(ocp, xs, xT, u, bp, reg))
    torch.cuda.synchronize()
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                 merged_trial=1)
    ref = tf.fused_newton_iter_plain(ocp, xs, xT, u, bp, reg, ddp=ddp)
    for g, r in zip(got, ref):
        _close(g, r, tol)
    ok = [torch.isfinite(o[7]) & (o[7] > 0) & torch.isfinite(o[6])
          for o in (got, ref)]
    assert torch.equal(ok[0], ok[1]) and bool(ok[1].all())
    if B == 33:
        views = tf.merged_trial_launch(
            ocp, *map(_offset_view, (xs, xT, u, bp, reg)), ddp=ddp)
        for g, v in zip(got, views):
            assert torch.equal(g, v)


def _agreeing_lanes(got, ref, tol):
    """Lanes on which two PackedLanes agree: equal integer and bool fields,
    float fields within ``tol`` of each field's scale."""
    agree = torch.ones_like(got.done)
    for a, b in zip(got, ref):
        if a.is_floating_point():
            scale = float(b[torch.isfinite(b)].abs().max()) + 1e-30
            close = ((a - b).abs() <= tol * scale) | (a == b)
            agree &= close.reshape(-1, close.shape[-1]).all(0)
        else:
            agree &= (a == b).reshape(-1, a.shape[-1]).all(0)
    return agree


@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
@pytest.mark.parametrize("model", [cartpole, pendulum],
                         ids=["cartpole", "pendulum"])
def test_mega_kernel_matches_plain(card, model, ddp):
    """k=4 then k=32 lane iterations in one launch each, float64, B=64,
    T=40, two iterations per barrier stage so that lanes roll over; every
    third lane inactive."""
    B, T = 64, 40
    cfg = BATCH_CONFIG.replace(max_newton_iters=2,
                               newton_impl="ddp" if ddp else "fused")
    ocp, u, _, x0 = _lanes(model, B, T, 8, torch.float64, card)
    bp0 = torch.full((B,), cfg.bp_init, dtype=torch.float64, device=card)
    lane = ps.packed_lane_init(ocp, u, x0, bp0,
                               torch.full_like(bp0, cfg.reg_init), cfg)
    active = torch.arange(B, device=card) % 3 != 0
    ref = lane
    for k in (4, 32):
        before = mega.clone_lane(lane)
        ref, ref_steps = mega.mega_k_iterations_plain(ocp, ref, active, cfg,
                                                      k, ddp)
        cuda.reset_launches()
        lane, steps = mega.mega_k_iterations(ocp, lane, active, cfg, k, ddp)
        torch.cuda.synchronize()
        assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0), mega=1)
        assert int(steps) == int(ref_steps)
        for name, a, b in zip(ps.PackedLane._fields, lane, before):
            assert torch.equal(a[..., ~active], b[..., ~active]), name
        assert int(_agreeing_lanes(lane, ref, 1e-10).sum()) >= B - 1
    assert bool((lane.bp[active] < cfg.bp_init).all())


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_mega_stream_on_card_matches_cpu(card, impl):
    """A small float64 pendulum packed stream on its mega executor, on the
    card against the CPU: one mega launch per refill round and no
    per-iteration kernel; converged raw costs agree to rtol 1e-8."""
    cfg = BATCH_CONFIG.replace(bp_min=4.1e-3, newton_impl=impl)
    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(4)
    x0 = pendulum.initial_state(torch.float64).numpy()
    u0 = torch.tensor(0.1 * rng.normal(size=(8, T, 1)))
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(8, 2)))
    cuda.reset_launches()
    got = solve_stream(ocp, u0.to(card), x0b.to(card), cfg, lanes=3,
                       refill_every=5)
    n = cuda.launches["mega"]
    assert 1 <= n <= got.steps
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0), mega=n,
                                 rollout_cost=cuda.launches["rollout_cost"])
    ref = solve_stream(ocp, u0, x0b, cfg, lanes=3, refill_every=5)
    assert int((got.iterations.cpu() != ref.iterations).sum()) <= 1

    def raw(u):
        return ocp.total_cost(rollout(ocp.dynamics, u, x0b), u,
                              torch.tensor(1e-9, dtype=torch.float64))

    np.testing.assert_allclose(raw(got.controls.cpu()).numpy(),
                               raw(ref.controls).numpy(), rtol=1e-8)


def test_mega_raises_on_aliased_lane(card):
    cfg = BATCH_CONFIG
    ocp, u, _, x0 = _lanes(pendulum, 8, 5, 9, torch.float64, card)
    bp0 = torch.full((8,), cfg.bp_init, dtype=torch.float64, device=card)
    lane = ps.packed_lane_init(ocp, u, x0, bp0, bp0.clone(), cfg)
    active = torch.ones(8, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="share"):
        mega.mega_k_iterations(ocp, lane._replace(u_prev=lane.u), active,
                               cfg, 2)
    ws = mega.mega_workspace(lane)
    assert ws._fields == ("tx", "tu", "Kk")
    for bad in (ws._replace(tu=lane.u), ws._replace(tx=lane.xs)):
        with pytest.raises(ValueError, match="share"):
            mega.mega_k_iterations(ocp, lane, active, cfg, 2,
                                   workspace=bad)


# One cartpole model (dt 0.01) for every horizon of the ring matrix: one
# library.
RING_OCP = cartpole.make_ocp(0.01)


def _decisions_equal(a, b):
    return (a.it == b.it) & (a.stage_it == b.stage_it) & (a.done == b.done)


@pytest.mark.parametrize("T", [7, 25, 100, 1000])
@pytest.mark.parametrize("B", [1, 33, 4096])
def test_mega_ring_matches_two_launch_and_plain(card, B, T):
    rng = np.random.default_rng(13)
    x0 = cartpole.initial_state(torch.float64).numpy()
    u0 = 0.1 * rng.normal(size=(T, 1, B))
    x0b = x0[:, None] + 0.01 * rng.normal(size=(4, B))
    active = torch.arange(B, device=card) != B - 1 if B > 1 else \
        torch.ones(B, dtype=torch.bool, device=card)
    slack = B // 100
    for dtype in (torch.float64, torch.float32):
        u = torch.tensor(u0, dtype=dtype, device=card)
        x = torch.tensor(x0b, dtype=dtype, device=card)
        for ddp in (False, True):
            for predictor in (True, False):
                cfg = BATCH_CONFIG.replace(
                    max_newton_iters=2, stage_predictor=predictor,
                    newton_impl="ddp" if ddp else "fused")
                label = (dtype, ddp, predictor)
                bp0 = torch.full((B,), cfg.bp_init, dtype=dtype, device=card)
                lane = ps.packed_lane_init(
                    RING_OCP, u, x, bp0, torch.full_like(bp0, cfg.reg_init),
                    cfg)
                before = mega.clone_lane(lane)
                plain = two = mega.clone_lane(lane)
                ws = mega.mega_workspace(lane)
                for _ in range(2):
                    cuda.reset_launches()
                    lane, steps = mega.mega_k_iterations(
                        RING_OCP, lane, active, cfg, 2, ddp, ws)
                    torch.cuda.synchronize()
                    assert cuda.launches["mega"] == 1, label
                    plain, plain_steps = mega.mega_k_iterations_plain(
                        RING_OCP, plain, active, cfg, 2, ddp)
                    for _ in range(2):
                        two = ps.packed_lane_iter(RING_OCP, two, cfg,
                                                  active & ~two.done)
                    assert int(steps) == int(plain_steps), label
                for name, a, b in zip(ps.PackedLane._fields, lane, before):
                    assert torch.equal(a[..., ~active], b[..., ~active]), \
                        (label, name)
                # The plain DDP trial solves Quu by Cholesky and ends a lane
                # whose Quu is indefinite as bad; the kernels (mega and
                # merged alike) eliminate without pivoting and reject the
                # step, so the lane goes on.  Those lanes, a small share,
                # are held to the two-launch kernels only.
                held = ~(plain.done & (plain.bp > cfg.bp_min)) if ddp \
                    else torch.ones_like(plain.done)
                dropped = int((~held).sum())
                assert dropped <= B // 10, (label, dropped)
                assert not bool((lane.done & ~held).any()), label
                if dtype == torch.float64:
                    assert bool(_agreeing_lanes(lane, two, 1e-12).all()), \
                        label
                    same = _agreeing_lanes(lane, plain, 1e-10)
                else:
                    assert int(_decisions_equal(lane, two).sum()) >= \
                        B - slack, label
                    same = _decisions_equal(lane, plain)
                n, m = int((same & held).sum()), int(held.sum())
                assert n >= m - slack, (label, n, m)
                if B > 1:
                    assert bool((lane.bp < cfg.bp_init).any()), label


ROLLOUT_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [17, 100, 1000])
@pytest.mark.parametrize("B", [1, 33, 4096])
def test_rollout_kernel_matches_plain(card, B, T, dtype):
    ocp, u, _, x0 = _lanes(cartpole, B, T, 10, dtype, card)
    cuda.reset_launches()
    got = tf.rollout_packed(ocp, u, x0)
    torch.cuda.synchronize()
    assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0), rollout=1)
    ref = tf.rollout_plain(ocp, u, x0)
    assert torch.equal(got[0][0], x0)
    for g, r in zip(got, ref):
        _close(g, r, ROLLOUT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 7, 40, 1000])
@pytest.mark.parametrize("model", [cartpole, pendulum],
                         ids=["cartpole", "pendulum"])
def test_rollout_kernel_matches_parent(card, model, T, dtype):
    """The rollout's lane loop (csrc/rollout.h) at the host tests'
    shapes, B in {1, 3, 37} (T=1000: B=256, dt 1/1000): equal to the
    one-thread loop it replaced (``rollout_reference``) bit for bit, within
    ROLLOUT_TOL of its plain version, and on inputs one scalar past a
    16-byte boundary equal to the aligned ones."""
    for B in ((256,) if T == 1000 else (1, 3, 37)):
        ocp, u, _, x0 = _lanes(model, B, T, B + T, dtype, card,
                               ocp=_model_at_step(model, 1.0 / max(T, 40)))
        cuda.reset_launches()
        got = tf.rollout_packed(ocp, u, x0)
        torch.cuda.synchronize()
        assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0), rollout=1)
        for g, r in zip(got, tf.rollout_reference(ocp, u, x0)):
            assert torch.equal(g, r), (B, T)
        for g, r in zip(got, tf.rollout_plain(ocp, u, x0)):
            _close(g, r, ROLLOUT_TOL[dtype])
        views = tf.rollout_packed(ocp, _offset_view(u), _offset_view(x0))
        for g, v in zip(got, views):
            assert torch.equal(g, v), (B, T)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 7, 100])
@pytest.mark.parametrize("model", [cartpole, pendulum],
                         ids=["cartpole", "pendulum"])
def test_rollout_cost_kernel_matches_parent(card, model, T, dtype):
    """The rollout cost's group schedule (csrc/rollout_cost.h) at B in
    {37, 256, 965 (the streams' median lane opening), 4096}, the model at
    dt = 1/100: at cartpole equal to the one-thread loop it replaced
    (``rollout_cost_reference``) bit for bit (at pendulum ``nvcc`` may
    contract the two programs apart: within FUSED_TOL of it), within
    FUSED_TOL of its plain version, and on inputs one scalar past a
    16-byte boundary equal to the aligned ones."""
    tol = FUSED_TOL[dtype]
    for B in (37, 256, 965, 4096):
        ocp, u, _, x0 = _lanes(model, B, T, B + T, dtype, card,
                               ocp=_model_at_step(model, 1.0 / 100))
        bp = torch.full((B,), 0.1, dtype=dtype, device=card)
        cuda.reset_launches()
        got = tf.rollout_cost_packed(ocp, u, x0, bp)
        torch.cuda.synchronize()
        assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0),
                                     rollout_cost=1)
        for g, r in zip(got, tf.rollout_cost_reference(ocp, u, x0, bp)):
            if model is cartpole:
                assert torch.equal(g, r), (B, T)
            else:
                _close(g, r, tol)
        for g, r in zip(got, tf.rollout_cost_plain(ocp, u, x0, bp)):
            _close(g, r, tol)
        views = tf.rollout_cost_packed(ocp, *(_offset_view(a)
                                              for a in (u, x0, bp)))
        for g, v in zip(got, views):
            assert torch.equal(g, v), (B, T)


def test_rollout_kernel_raises_on_what_it_does_not_take(card):
    ocp, u, _, x0 = _lanes(pendulum, 8, 5, 6, torch.float64, card)
    with pytest.raises(NotImplementedError):
        tf.rollout_packed(ocp, u.half(), x0.half())
    with pytest.raises(ValueError):
        tf.rollout_packed(ocp, u.transpose(0, 2).contiguous()
                          .transpose(0, 2), x0)
    with pytest.raises(ValueError):
        tf.rollout_packed(ocp, u, x0.float())
    with pytest.raises(ValueError):
        tf.rollout_packed(ocp, u, x0.cpu())
    with pytest.raises(ValueError):
        tf.rollout_packed(ocp, u, torch.cat([x0, x0[:, :1]], 1))


@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
def test_mega_kernel_matches_plain_at_T1000(card, ddp):
    """The streamed TPU kernel's matrix at T=1000: two k-blocks of 2 with
    the lane carried across the launches, two iterations per barrier stage
    with the predictor on, float64, cartpole, B=64."""
    B, T = 64, 1000
    cfg = BATCH_CONFIG.replace(max_newton_iters=2,
                               newton_impl="ddp" if ddp else "fused")
    ocp, u, _, x0 = _lanes(cartpole, B, T, 12, torch.float64, card)
    bp0 = torch.full((B,), cfg.bp_init, dtype=torch.float64, device=card)
    lane = ps.packed_lane_init(ocp, u, x0, bp0,
                               torch.full_like(bp0, cfg.reg_init), cfg)
    active = torch.ones(B, dtype=torch.bool, device=card)
    ref = lane
    for _ in range(2):
        ref, ref_steps = mega.mega_k_iterations_plain(ocp, ref, active, cfg,
                                                      2, ddp)
        cuda.reset_launches()
        lane, steps = mega.mega_k_iterations(ocp, lane, active, cfg, 2, ddp)
        torch.cuda.synchronize()
        assert cuda.launches == dict(dict.fromkeys(cuda.launches, 0), mega=1)
        assert int(steps) == int(ref_steps) == 2
    assert int(_agreeing_lanes(lane, ref, 1e-10).sum()) >= B - 1
    assert bool((lane.bp < cfg.bp_init).any()), "no lane rolled over"


@pytest.mark.parametrize("case", ["fused_staged", "fused_flat", "ddp_flat",
                                  "ddp_flat_no_predictor"])
def test_batch_on_card_matches_cpu(card, case, monkeypatch):
    """bench.py's batch mode (``solve_batch`` with the fused evaluators) on
    a float64 pendulum batch, card against CPU; on the card the trial is
    the fused kernels' once per lockstep iteration (DDP: the merged
    kernel), and the flat schedule opens its lanes with the rollout
    kernel."""
    from ipoc_tpu_torch import solve_batch

    impl, mode = case.split("_")[:2]
    cfg = BATCH_CONFIG.replace(newton_impl=impl, barrier_mode=mode,
                               stage_predictor=not case.endswith("predictor"))
    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(4)
    x0 = pendulum.initial_state(torch.float64).numpy()
    u0 = torch.tensor(0.1 * rng.normal(size=(8, T, 1)))
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(8, 2)))
    trials = []
    real = ip_newton._trial_eval

    def counted(*a, **k):
        trials.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ip_newton, "_trial_eval", counted)
    cuda.reset_launches()
    got = solve_batch(ocp, u0.to(card), x0b.to(card), cfg)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    monkeypatch.undo()
    trial_kernels = ({"merged_trial": len(trials)} if impl == "ddp" else
                     {"fused_bwd": len(trials), "fused_fwd": len(trials)})
    assert {k: launches[k] for k in trial_kernels} == trial_kernels
    assert (launches["rollout"] >= 1) == (mode == "flat")
    assert launches["seq_newton_trial"] == launches["par_newton_trial"] == 0
    ref = solve_batch(ocp, u0, x0b, cfg)
    assert int((got.iterations.cpu() != ref.iterations).sum()) <= 1

    def raw(u):
        return ocp.total_cost(rollout(ocp.dynamics, u, x0b), u,
                              torch.tensor(1e-9, dtype=torch.float64))

    np.testing.assert_allclose(raw(got.controls.cpu()).numpy(),
                               raw(ref.controls).numpy(), rtol=1e-8)


# ---------------------------------------------------------------------------
# The parallel-in-time kernels: affine scan, value scan, one-launch trial
# ---------------------------------------------------------------------------

SCAN_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def _random_lqt(B, T, nx, nu, seed, dtype, device):
    """A random well-conditioned LQT (tests/conftest.py make_random_lqt's
    recipe) with a leading lane axis."""
    from ipoc_tpu_torch.parallel.lqt import LQT

    rng = np.random.default_rng(seed)

    def psd(n, scale, *lead):
        A = rng.normal(size=lead + (n, n))
        return scale * (A @ np.swapaxes(A, -1, -2) + n * np.eye(n))

    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    eye = lambda n, *lead: t(np.broadcast_to(np.eye(n), lead + (n, n)))
    return LQT(
        A=t(0.5 * rng.normal(size=(B, T, nx, nx))),
        B=t(rng.normal(size=(B, T, nx, nu))),
        c=t(0.3 * rng.normal(size=(B, T, nx))),
        XT=t(psd(nx, 1.0, B)), HT=eye(nx, B), rT=t(rng.normal(size=(B, nx))),
        X=t(psd(nx, 0.5, B, T)), H=eye(nx, B, T),
        r=t(rng.normal(size=(B, T, nx))),
        U=t(psd(nu, 1.0, B, T)), Z=eye(nu, B, T),
        s=t(rng.normal(size=(B, T, nu))),
        M=t(0.2 * rng.normal(size=(B, T, nx, nu))))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_scan_kernels_match_plain(card, n, dtype):
    """Both affine-scan directions and the value scan against their plain
    versions (the associative scan) on the same card, at horizons below,
    at and above a multiple of 128 lanes, up to T=1001."""
    from ipoc_tpu_torch.ops import scan_kernels as sk
    from ipoc_tpu_torch.parallel.lqt import _elements

    tol = SCAN_TOL[dtype]
    rng = np.random.default_rng(n)
    for T in (1, 5, 7, 33, 128, 129, 130, 1001):
        F = torch.tensor(0.5 * rng.normal(size=(3, T, n, n)), dtype=dtype,
                         device=card)
        c = torch.tensor(rng.normal(size=(3, T, n)), dtype=dtype,
                         device=card)
        for reverse in (True, False):
            cuda.reset_launches()
            got = sk.affine_scan(F, c, reverse)
            assert cuda.launches["affine_scan"] == 1
            ref = sk.affine_scan_plain(F, c, reverse)
            for g, r in zip(got, ref):
                assert _rel_err(g, r) <= tol, (T, reverse)
        elems = [e.contiguous() for e in _elements(
            _random_lqt(3, T, n, 2, T, dtype, card))]
        cuda.reset_launches()
        got = sk.value_scan(*elems)
        assert cuda.launches["value_scan"] == 1
        for g, r in zip(got, sk.value_scan_plain(*elems)):
            assert _rel_err(g, r) <= tol, T


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_affine_scan_every_lane_count(card, n, dtype):
    """The affine scan's C entry at every lane count P in {32, 64, 128,
    256}, both directions, three scenarios at the host tests' horizons
    (1000 and 129: no multiple of P times the chunk), against the plain
    version; and at B=1024, T=1000 through the wrapper, at the lanes
    ``scan_lanes`` picks."""
    from ipoc_tpu_torch.ops import scan_kernels as sk

    tol = SCAN_TOL[dtype]
    rng = np.random.default_rng(10 + n)
    lib = cuda.library(cuda.PAR_NEWTON)
    code = cuda.dtype_code(dtype)
    stream = torch.cuda.current_stream().cuda_stream
    for B, T in [(3, T) for T in (1, 7, 33, 129, 1000)] + [(1024, 1000)]:
        F = torch.tensor(0.5 * rng.normal(size=(B, T, n, n)), dtype=dtype,
                         device=card)
        c = torch.tensor(rng.normal(size=(B, T, n)), dtype=dtype, device=card)
        for reverse in (True, False):
            ref = sk.affine_scan_plain(F, c, reverse)
            if B == 1024:
                got = sk.affine_scan(F, c, reverse)
                for g, r in zip(got, ref):
                    assert _rel_err(g, r) <= tol, (B, T, reverse)
                continue
            for P in sk.SCAN_LANES:
                Fo, co = torch.full_like(F, float("nan")), torch.full_like(c, float("nan"))
                cuda.check(lib.ipoc_affine_scan(
                    code, n, int(reverse), P, F.data_ptr(), c.data_ptr(),
                    Fo.data_ptr(), co.data_ptr(), B, T, stream), "affine_scan")
                torch.cuda.synchronize()
                for g, r in zip((Fo, co), ref):
                    assert _rel_err(g, r) <= tol, (T, reverse, P)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_value_scan_every_lane_count(card, n, dtype):
    """The value scan's C entry at every lane count P in {32, 64, 128,
    256}, three scenarios at the host tests' horizons and T=1001, against
    the plain version; and at B=1024, T=100 and B=1, T=1001 through the
    wrapper, at the lanes ``scan_lanes(..., value=True)`` picks."""
    from ipoc_tpu_torch.ops import scan_kernels as sk
    from ipoc_tpu_torch.parallel.lqt import _elements

    tol = SCAN_TOL[dtype]
    lib = cuda.library(cuda.PAR_NEWTON)
    code = cuda.dtype_code(dtype)
    stream = torch.cuda.current_stream().cuda_stream
    for B, T in ([(3, T) for T in (1, 7, 33, 129, 1000, 1001)]
                 + [(1024, 100), (1, 1001)]):
        elems = [e.contiguous() for e in _elements(
            _random_lqt(B, T, n, 2, T + n, dtype, card))]
        ref = sk.value_scan_plain(*elems)
        if B != 3:
            cuda.reset_launches()
            got = sk.value_scan(*elems)
            assert cuda.launches["value_scan"] == 1
            for g, r in zip(got, ref):
                assert _rel_err(g, r) <= tol, (B, T)
            continue
        for P in sk.SCAN_LANES:
            outs = [torch.full_like(e, float("nan")) for e in elems]
            cuda.check(lib.ipoc_value_scan(
                code, n, P, *(a.data_ptr() for a in (*elems, *outs)), B, T,
                stream), "value_scan")
            torch.cuda.synchronize()
            for g, r in zip(outs, ref):
                assert _rel_err(g, r) <= tol, (T, P)


# The trial's launch geometries: every lane count the launch rule picks
# (B=1 and B=3 spread T over 32-256 lanes, B=1024 keeps 32), horizons on
# both sides of a warp's 32 lanes; the (nx, nu) shape cycles with T.
TRIAL_GEOMETRIES = [(B, T) for B in (1, 3, 1024)
                    for T in (1, 2, 31, 33, 100, 129, 1000)]


def _trial_data(case, dtype, device):
    if case == "cartpole_T100":
        return _model_data(cartpole, 64, 100, 0, dtype, device)[0]
    if case == "cartpole_T1000":
        return _model_data(cartpole, 4, 1000, 5, dtype, device)[0]
    if case == "pendulum_T130":
        return _model_data(pendulum, 16, 130, 1, dtype, device)[0]
    if case.startswith("random_B"):
        B, T = (int(v) for v in case[len("random_B"):].split("_T"))
        nx, nu = ((2, 1), (4, 1), (3, 2))[T % 3]
        return _random_data(B, T, nx, nu, T, dtype, device)[0]
    return _random_data(16, 129, 3, 2, 2, dtype, device)[0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["cartpole_T100", "cartpole_T1000",
                                  "pendulum_T130", "random_nx3_nu2"]
                         + [f"random_B{B}_T{T}" for B, T in TRIAL_GEOMETRIES])
def test_par_newton_trial_matches_plain(card, case, dtype):
    """The one-launch trial against its plain version (the pipeline on the
    scans' plain versions) and against the pipeline on the scan kernels:
    du/dx within the kernels' tolerance of du's scale, pred relative,
    equal ok flags; the model cases and random data at every launch
    geometry of ``TRIAL_GEOMETRIES``."""
    from ipoc_tpu_torch.ops import newton_kernel as nk

    tol = SCAN_TOL[dtype]
    args = _trial_data(case, dtype, card)
    cuda.reset_launches()
    du, dx, pred, ok = nk.fused_newton_step(*args)
    assert cuda.launches["par_newton_trial"] == 1
    for ref in (nk.fused_newton_step_plain(*args),
                nk.newton_pipeline(*args)):
        du_p, dx_p, pred_p, ok_p = ref
        assert torch.equal(ok, ok_p) and bool(ok.all())
        scale = float(du_p.abs().max())
        assert float((du - du_p).abs().max()) <= tol * scale
        assert float((dx - dx_p).abs().max()) <= tol * scale
        assert float(((pred - pred_p).abs() / pred_p.abs()).max()) <= tol
    assert cuda.launches["value_scan"] == cuda.launches["affine_scan"] == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_par_newton_trial_indefinite_lane(card, dtype):
    """An indefinite R on one stage of one lane fails that lane only."""
    from ipoc_tpu_torch.ops import newton_kernel as nk

    ru, Q, R, M, fx, fu, XT = _trial_data("cartpole_T100", dtype, card)
    R = R.clone()
    R[3, 17] = -1.0
    ok = nk.fused_newton_step(ru, Q, R, M, fx, fu, XT)[3]
    ok_p = nk.fused_newton_step_plain(ru, Q, R, M, fx, fu, XT)[3]
    assert torch.equal(ok, ok_p)
    assert not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_par_newton_trial_unaligned_views(card, dtype):
    """Inputs that are views one element past an allocation's start (off
    the 16-byte boundary the kernel's vector loads need) give what aligned
    copies give."""
    from ipoc_tpu_torch.ops import newton_kernel as nk

    args = _trial_data("random_nx3_nu2", dtype, card)
    views = tuple(torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
                  for a in args)
    assert all(v.data_ptr() % 16 != 0 and v.is_contiguous() for v in views)
    for got, ref in zip(nk.fused_newton_step(*views),
                        nk.fused_newton_step(*args)):
        assert torch.equal(got, ref)


def test_scan_kernels_raise_on_uninstantiated_shape(card):
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk

    F = torch.zeros((2, 5, 5, 5), device=card)
    with pytest.raises(NotImplementedError):
        sk.affine_scan(F, torch.zeros((2, 5, 5), device=card))
    with pytest.raises(NotImplementedError):
        nk.fused_newton_step(*_random_data(2, 5, 5, 1, 3, torch.float32,
                                           card)[0])


def test_par_solve_on_card_matches_cpu(card):
    """The parallel-in-time solve of a float64 pendulum batch on the card
    (kernels) against the CPU (plain versions): equal iterations and
    controls within 1e-8 on every lane; in a single solve every Newton
    iteration is one affine scan and every trial one launch of the trial
    kernel."""
    from ipoc_tpu_torch import par_interior_point_optimal_control
    from ipoc_tpu_torch import DEFAULT_CONFIG, solve_batch

    T = 20
    ocp = pendulum.make_ocp(1.0 / T)
    rng = np.random.default_rng(6)
    x0 = pendulum.initial_state(torch.float64).numpy()
    u0 = torch.tensor(0.1 * rng.normal(size=(3, T, 1)))
    x0b = torch.tensor(x0 + 0.01 * rng.normal(size=(3, 2)))
    got = solve_batch(ocp, u0.to(card), x0b.to(card), DEFAULT_CONFIG)
    ref = solve_batch(ocp, u0, x0b, DEFAULT_CONFIG)
    assert torch.equal(got.iterations.cpu(), ref.iterations)
    np.testing.assert_allclose(got.controls.cpu().numpy(),
                               ref.controls.numpy(), rtol=0, atol=1e-8)
    cuda.reset_launches()
    _, it = par_interior_point_optimal_control(ocp, u0[0].to(card),
                                               x0b[0].to(card))
    assert int(it) == int(ref.iterations[0])
    assert cuda.launches["affine_scan"] == int(it)
    assert cuda.launches["par_newton_trial"] >= int(it)
