"""The port's packed stream (``solvers/packed_stream.py``) against the JAX
package, float64 on the CPU (plain versions of the four fused kernels).

* ``packed_lane_iter`` over several iterations, with a per-stage cap of 2
  so that stage transitions happen, equals JAX ``flat_lane_iter`` under the
  fused config (vmapped; off the TPU its evaluator is the unfused
  composition), with the stage predictor on and off: controls and
  trajectories within 1e-10, equal iteration counts, barrier parameters
  and done flags.
* ``solve_stream`` with ``BATCH_CONFIG`` unmodified (T=16, 24 scenarios,
  8 lanes, refill every 4, one scenario with a non-finite warm start)
  equals JAX ``solve_stream``: equal iterations on every scenario, equal
  ``steps``, controls within 1e-8.  The packed stream sums ``||cu||_F`` in
  another order than JAX's unpacked stream, which could flip an accept
  decision within rounding; on these pools none flipped.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.solvers.ip_newton import flat_lane_init as j_flat_lane_init
from ipoc_tpu.solvers.ip_newton import flat_lane_iter as j_flat_lane_iter
from ipoc_tpu.solvers.stream import solve_stream as j_solve_stream
from ipoc_tpu_torch.interop import (
    config_from_jax,
    model_constants,
    pool_from_numpy,
    to_numpy,
)
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.solvers import packed_stream as ps
from ipoc_tpu_torch.solvers.stream import solve_stream
from ipoc_tpu_torch.utils.integrators import rollout

torch.set_num_threads(1)

CFG = ipoc_tpu.BATCH_CONFIG
MODELS = {"pendulum": (j_pendulum, t_pendulum),
          "cartpole": (j_cartpole, t_cartpole)}


def _pool(jm, N, T, seed, bad_lane=None):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u0 = 0.1 * rng.normal(size=(N, T, 1))
    x0b = x0 + 0.01 * rng.normal(size=(N, x0.shape[0]))
    if bad_lane is not None:
        u0[bad_lane] = np.nan
    return u0, x0b


@pytest.mark.parametrize("predictor", [True, False])
def test_packed_lane_iter_matches_jax_flat(predictor):
    cfg = CFG.replace(max_newton_iters=2, stage_predictor=predictor)
    T, B = 10, 6
    jocp, tocp = j_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(1.0 / T)
    u0, x0b = _pool(j_pendulum, B, T, seed=4)
    flat = jax.vmap(lambda u, x: j_flat_lane_init(jocp, u, x, cfg))(
        jnp.asarray(u0), jnp.asarray(x0b))
    step = jax.jit(jax.vmap(lambda ln: j_flat_lane_iter(jocp, ln, cfg,
                                                        ~ln.done)))
    tcfg = config_from_jax(cfg)
    u, x0 = pool_from_numpy(u0, x0b)
    full = lambda v: torch.full((B,), v, dtype=torch.float64)  # noqa: E731
    lane = ps.packed_lane_init(tocp, u.permute(1, 2, 0).contiguous(),
                               x0.T.contiguous(), full(cfg.bp_init),
                               full(cfg.reg_init), tcfg)
    rolled = False
    for _ in range(7):
        flat = step(flat)
        lane = ps.packed_lane_iter(tocp, lane, tcfg, ~lane.done)
        rolled |= bool((lane.bp < cfg.bp_init).any())
    assert rolled, "no stage transition happened"
    np.testing.assert_allclose(lane.u.permute(2, 0, 1).numpy(),
                               np.asarray(flat.u), rtol=0, atol=1e-10)
    x = torch.cat([lane.xs, lane.xT[None]]).permute(2, 0, 1).numpy()
    np.testing.assert_allclose(x, np.asarray(flat.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lane.u_prev.permute(2, 0, 1).numpy(),
                               np.asarray(flat.u_prev), rtol=0, atol=1e-10)
    for field in ("it", "stage_it", "done"):
        np.testing.assert_array_equal(getattr(lane, field).numpy(),
                                      np.asarray(getattr(flat, field)),
                                      err_msg=field)
    # XLA may divide by the constant decay as a product with its
    # reciprocal: one rounding apart.
    for field in ("bp", "rp"):
        np.testing.assert_allclose(getattr(lane, field).numpy(),
                                   np.asarray(getattr(flat, field)),
                                   rtol=1e-14, err_msg=field)


@pytest.fixture(scope="module", params=list(MODELS))
def solved(request):
    """One pool per model, solved by the JAX stream (jit) and the port's."""
    jm, tm = MODELS[request.param]
    T = 16
    u0, x0b = _pool(jm, 24, T, seed=3, bad_lane=5)
    ref = jax.jit(lambda u, x: j_solve_stream(
        jm.make_ocp(1.0 / T), u, x, CFG, lanes=8, refill_every=4))(
        jnp.asarray(u0), jnp.asarray(x0b))
    cuda.reset_launches()
    got = solve_stream(tm.make_ocp(1.0 / T), *pool_from_numpy(u0, x0b),
                       config_from_jax(CFG), lanes=8, refill_every=4)
    return ref, to_numpy(got), dict(cuda.launches)


def test_solve_stream_batch_config_matches_jax(solved):
    ref, got, _ = solved
    np.testing.assert_array_equal(got.iterations, np.asarray(ref.iterations))
    assert got.steps == int(ref.steps)
    np.testing.assert_allclose(got.controls, np.asarray(ref.controls),
                               rtol=0, atol=1e-8, equal_nan=True)


def test_bad_warm_start_lane_done_at_once(solved):
    """A non-finite warm start is captured with iterations=0 and its input
    controls, without poisoning the other scenarios."""
    ref, got, _ = solved
    assert int(got.iterations[5]) == 0 == int(ref.iterations[5])
    assert np.isnan(got.controls[5]).all()
    others = np.delete(np.arange(24), 5)
    assert np.isfinite(got.controls[others]).all()
    assert (got.iterations[others] > 0).all()


def test_no_kernel_launch_on_cpu(solved):
    _, _, launches = solved
    assert launches == dict.fromkeys(cuda.launches, 0)


def test_fused_config_takes_the_packed_stream(monkeypatch):
    """solve_stream sends newton_impl='fused' to solve_stream_packed."""
    calls = []
    real = ps.solve_stream_packed

    def spy(*args, **kwargs):
        calls.append(args[3].newton_impl)
        return real(*args, **kwargs)

    monkeypatch.setattr(ps, "solve_stream_packed", spy)
    tocp = t_pendulum.make_ocp(0.25)
    u0, x0b = _pool(j_pendulum, 2, 4, seed=1)
    sol = solve_stream(tocp, *pool_from_numpy(u0, x0b),
                       config_from_jax(CFG.replace(bp_min=0.05)), lanes=2)
    assert calls == ["fused"] and sol.iterations.shape == (2,)


def test_ddp_and_warm_transfer_raise(monkeypatch):
    """newton_impl='ddp' reaches the packed stream; warm_transfer refuses
    per-scenario bp_init/rp_init (JAX's ValueError) and the unpacked
    stream, and the packed stream refuses 'seq'."""
    tocp = t_pendulum.make_ocp(0.1)
    u = torch.zeros((2, 10, 1), dtype=torch.float64)
    x = torch.zeros((2, 2), dtype=torch.float64)
    cfg = config_from_jax(CFG)
    per = torch.full((2,), 0.05, dtype=torch.float64)
    for kw in ({"bp_init": per}, {"rp_init": per}):
        with pytest.raises(ValueError, match="bp_init/rp_init"):
            solve_stream(tocp, u, x, cfg, warm_transfer=True, **kw)
    with pytest.raises(ValueError, match="packed stream"):
        solve_stream(tocp, u, x, cfg.replace(newton_impl="seq"),
                     warm_transfer=True)
    with pytest.raises(ValueError, match="fused"):
        ps.solve_stream_packed(tocp, u, x, cfg.replace(newton_impl="seq"))
    calls = []
    real = ps.solve_stream_packed

    def spy(*args, **kwargs):
        calls.append(args[3].newton_impl)
        return real(*args, **kwargs)

    monkeypatch.setattr(ps, "solve_stream_packed", spy)
    u0, x0b = _pool(j_pendulum, 2, 4, seed=1)
    sol = solve_stream(t_pendulum.make_ocp(0.25), *pool_from_numpy(u0, x0b),
                       cfg.replace(newton_impl="ddp", bp_min=0.05), lanes=2)
    assert calls == ["ddp"] and sol.iterations.shape == (2,)
    assert bool((sol.iterations > 0).all())


@pytest.mark.parametrize("mega", [True, False])
def test_warm_transfer_opens_from_the_finished_lane(monkeypatch, mega):
    """Warm transfer, on both executors: each transferred lane opens as JAX
    ``flat_lane_init(ocp, u_donor, x0_new, cfg, bp0=transfer_bp,
    rp0=reg_init)`` from the controls of the scenario its lane finished;
    and JAX ``test_warm_transfer_same_optima_fewer_iters``'s criteria on
    pendulum: the same optima as the cold stream (raw cost rel 1e-4) in
    fewer iterations after the first generation."""
    T, lanes, transfer_bp = 12, 8, 0.02
    jocp, tocp = j_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(1.0 / T)
    u0, x0b = _pool(j_pendulum, 3 * lanes, T, seed=6)
    u, x0 = pool_from_numpy(u0, x0b)
    cfg = config_from_jax(CFG)
    opens, real = [], ps.packed_lane_init

    def spy(ocp, uu, xx, bp0, rp0, c):
        lane = real(ocp, uu, xx, bp0, rp0, c)
        if bool((bp0 == transfer_bp).all()):
            opens.append((uu.clone(), xx.clone(), rp0.clone(), lane))
        return lane

    monkeypatch.setattr(ps, "packed_lane_init", spy)
    warm = ps.solve_stream_packed(tocp, u, x0, cfg, lanes=lanes,
                                  warm_transfer=True,
                                  transfer_bp=transfer_bp, mega=mega)
    monkeypatch.undo()
    cold = ps.solve_stream_packed(tocp, u, x0, cfg, lanes=lanes, mega=mega)
    assert sum(o[0].shape[-1] for o in opens) == 2 * lanes
    for uu, xx, rp0, lane in opens:
        assert bool((rp0 == cfg.reg_init).all())
        for k in range(uu.shape[-1]):
            donor = uu[..., k]
            # The donor is a finished scenario's solution, bit for bit.
            assert any(torch.equal(donor, c) for c in warm.controls)
            new = int(torch.nonzero((x0 == xx[:, k]).all(1))[0, 0])
            ref = j_flat_lane_init(jocp, jnp.asarray(donor.numpy()),
                                   jnp.asarray(x0b[new]), CFG,
                                   bp0=jnp.asarray(transfer_bp),
                                   rp0=jnp.asarray(CFG.reg_init))
            x = torch.cat([lane.xs[..., k], lane.xT[None, :, k]])
            np.testing.assert_allclose(x.numpy(), np.asarray(ref.x),
                                       rtol=0, atol=1e-12)
            assert bool(lane.done[k]) == bool(ref.done)
            assert float(lane.bp[k]) == transfer_bp
    ocp = t_pendulum.make_ocp(1.0 / T)

    def raw(sol):
        xs = rollout(ocp.dynamics, sol.controls, x0)
        return ocp.total_cost(xs, sol.controls,
                              torch.zeros((), dtype=x0.dtype)).numpy()

    rel = np.abs(raw(warm) - raw(cold)) / (np.abs(raw(cold)) + 1e-9)
    assert float(rel.max()) < 1e-4, "transferred optima drifted"
    later = slice(lanes, None)
    assert float(warm.iterations[later].double().mean()) < float(
        cold.iterations[later].double().mean())


def test_packed_lane_fields_own_their_storage():
    """packed_lane_init gives every field its own storage (the mega kernel
    writes u, u_prev, it and stage_it in place): an in-place write to one
    field leaves every other field and the caller's tensors as they were."""
    tocp = t_pendulum.make_ocp(0.25)
    u0, x0b = _pool(j_pendulum, 3, 4, seed=2)
    u, x0 = ps._pack(*pool_from_numpy(u0, x0b))
    bp0 = torch.full((3,), 0.1, dtype=torch.float64)
    rp0 = torch.ones(3, dtype=torch.float64)
    args = (u, x0, bp0, rp0)
    before = [a.clone() for a in args]
    lane = ps.packed_lane_init(tocp, *args, config_from_jax(CFG))
    for name in ps.PackedLane._fields:
        snapshot = [t.clone() for t in lane]
        field = getattr(lane, name)
        field.logical_not_() if field.dtype == torch.bool else field.add_(1)
        for other, a, b in zip(ps.PackedLane._fields, lane, snapshot):
            if other != name:
                assert torch.equal(a, b), f"{name} aliases {other}"
        for a, b in zip(args, before):
            assert torch.equal(a, b), f"{name} aliases an input"


@pytest.mark.parametrize("model", list(MODELS))
def test_models_and_batch_config_carry_across(model):
    """What the comparisons above rest on: the two packages' models carry
    the same constants, and BATCH_CONFIG crosses over unchanged."""
    jm, tm = MODELS[model]
    assert model_constants(jm) == model_constants(tm)
    assert set(model_constants(tm)) >= {"CONTROL_BOUND", "GOAL",
                                        "STATE_WEIGHTS", "ACTION_WEIGHT"}
    from ipoc_tpu_torch import BATCH_CONFIG

    assert config_from_jax(CFG) == BATCH_CONFIG
