"""The port's streaming executor against the JAX package's, float64.

``solve_stream`` of ``ipoc_tpu_torch`` (plain versions on the CPU) and of
``ipoc_tpu`` (the unpacked loop with the sequential scans) solve the same
pools, made with numpy from a seed: pendulum and cartpole, the BATCH_CONFIG
knobs with ``newton_impl="seq"`` (and, for the pendulum, also the plain
stage transition without the predictor) on the short 3-stage barrier
schedule of ``tests/test_stream.py``, fewer lanes than scenarios so that
refill runs, and one lane with a non-finite warm start.  Pass condition: equal
per-scenario iterations and ``steps``, controls within atol 1e-9.  No
accept decision flipped within rounding on these pools, so no lane needed
the converged-cost fallback comparison.
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
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy, to_numpy
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.solvers import ip_newton
from ipoc_tpu_torch.solvers.stream import solve_stream

torch.set_num_threads(1)

# BATCH_CONFIG's knobs (single-trial globalization, stage predictor,
# pred_floor, reg_init=100, reg_stage_init) on the sequential evaluator,
# with the 3-stage schedule of tests/test_stream.py.
CFG = ipoc_tpu.BATCH_CONFIG.replace(newton_impl="seq", bp_min=4.1e-3)
T_CFG = config_from_jax(CFG)
# The plain stage transition (no predictor, reference LM reset, no
# pred_floor): the flat-mode knobs of tests/test_stream.py.
PLAIN_CFG = ipoc_tpu.FAST_CONFIG.replace(
    globalization="single", newton_impl="seq", bp_min=4.1e-3)
CASES = {"pendulum": (j_pendulum, t_pendulum, CFG),
         "cartpole": (j_cartpole, t_cartpole, CFG),
         "pendulum_no_predictor": (j_pendulum, t_pendulum, PLAIN_CFG)}
LANES, REFILL = 3, 5


def _pool(jm, N, T, seed, bad_lane=None):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u0 = 0.1 * rng.normal(size=(N, T, 1))
    x0b = x0 + 0.01 * rng.normal(size=(N, x0.shape[0]))
    if bad_lane is not None:
        u0[bad_lane] = np.nan
    return u0, x0b


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    """One pool per case, solved once by the JAX stream (jit) and once by
    the port's."""
    jm, tm, cfg = CASES[request.param]
    T = 16
    u0, x0b = _pool(jm, 7, T, seed=3, bad_lane=2)
    jocp, tocp = jm.make_ocp(1.0 / T), tm.make_ocp(1.0 / T)
    ref = jax.jit(lambda u, x: j_solve_stream(
        jocp, u, x, cfg, lanes=LANES, refill_every=REFILL))(
        jnp.asarray(u0), jnp.asarray(x0b))
    cuda.reset_launches()
    got = solve_stream(tocp, *pool_from_numpy(u0, x0b), config_from_jax(cfg),
                       lanes=LANES, refill_every=REFILL)
    launches = dict(cuda.launches)
    return ref, to_numpy(got), launches


def test_stream_matches_jax(solved):
    ref, got, _ = solved
    np.testing.assert_array_equal(got.iterations,
                                  np.asarray(ref.iterations))
    assert got.steps == int(ref.steps)
    np.testing.assert_allclose(got.controls,
                               np.asarray(ref.controls), rtol=0, atol=1e-9,
                               equal_nan=True)


def test_stream_bad_warm_start_lane(solved):
    """A non-finite warm start is captured with iterations=0 and its input
    controls, without poisoning the other scenarios."""
    ref, got, _ = solved
    assert int(got.iterations[2]) == 0 == int(ref.iterations[2])
    assert np.isnan(got.controls[2]).all()
    assert np.isfinite(got.controls[[0, 1, 3, 4, 5, 6]]).all()
    assert int(got.iterations.min()) == 0 < int(np.sort(
        np.asarray(ref.iterations))[1])


def test_stream_launches_no_kernel_on_cpu(solved):
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _, _, launches = solved
    assert launches == dict.fromkeys(cuda.launches, 0)


def _lanes(B=4, T=12, seed=5):
    tocp = t_pendulum.make_ocp(1.0 / T)
    u0, x0b = _pool(j_pendulum, B, T, seed)
    u, x = pool_from_numpy(u0, x0b)
    return tocp, ip_newton.flat_lane_init(tocp, u, x, T_CFG), (u0, x0b)


def test_masked_lane_comes_back_unchanged():
    """adv=False lanes are returned exactly unchanged, field for field."""
    tocp, lane, _ = _lanes()
    for _ in range(3):
        lane = ip_newton.flat_lane_iter(tocp, lane, T_CFG)
    adv = torch.tensor([True, False, True, False])
    new = ip_newton.flat_lane_iter(tocp, lane, T_CFG, adv)
    for field, a, b in zip(lane._fields, lane, new):
        assert torch.equal(a[~adv], b[~adv]), field
        if field in ("x", "u", "it"):
            assert not torch.equal(a[adv], b[adv]), field


def test_transition_runs_only_on_rolling_lanes(monkeypatch):
    """The stage transition's rollouts run on exactly the lanes that roll
    over to a new stage, and not at all in an iteration where none does;
    per-lane results equal the JAX lane iteration, which evaluates the
    transition on every lane and selects."""
    tocp, lane, (u0, x0b) = _lanes()
    jocp = j_pendulum.make_ocp(1.0 / u0.shape[1])
    j_step = jax.jit(jax.vmap(
        lambda ln: j_flat_lane_iter(jocp, ln, CFG, ~ln.done)))
    j_lane = jax.vmap(lambda u, x: j_flat_lane_init(jocp, u, x, CFG))(
        jnp.asarray(u0), jnp.asarray(x0b))

    rolled = []
    real = ip_newton.rollout

    def counting_rollout(dynamics, controls, x0):
        rolled.append(controls.shape[0])
        return real(dynamics, controls, x0)

    monkeypatch.setattr(ip_newton, "rollout", counting_rollout)
    saw_skip = saw_subset = False
    for _ in range(40):
        rolled.clear()
        before = lane.bp
        lane = ip_newton.flat_lane_iter(tocp, lane, T_CFG, ~lane.done)
        j_lane = j_step(j_lane)
        n_roll = int(((lane.bp != before) & ~lane.done).sum())
        if n_roll == 0:
            assert rolled == []
            saw_skip = True
        else:
            assert rolled == [n_roll, n_roll]  # the two predictor candidates
            saw_subset |= n_roll < lane.bp.shape[0]
        for field in ("x", "u", "u_prev", "bp", "rp", "it"):
            np.testing.assert_allclose(
                getattr(lane, field).numpy(),
                np.asarray(getattr(j_lane, field)), rtol=0, atol=1e-12,
                err_msg=field)
    assert saw_skip and saw_subset


@pytest.mark.parametrize("impl", ["par", "fused", "ddp"])
def test_other_evaluators_raise(impl):
    """The flat lanes with the evaluators other than 'seq', which all used
    to raise and now run.  'par': the parallel-in-time evaluator's stream
    against JAX's, equal per-scenario iterations and steps, controls within
    1e-9.  'fused' and 'ddp' (the fused trial's kernels and the rollout and
    transition kernels on a card, their plain versions here): the port's
    flat lanes against JAX's vmapped flat_lane_init/flat_lane_iter over 12
    iterations, every field within 1e-10, lanes rolling over both with and
    without the stage predictor."""
    cfg = T_CFG.replace(newton_impl=impl)
    if impl == "par":
        T = 12
        u0, x0b = _pool(j_pendulum, 5, T, seed=7)
        jocp, tocp = j_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(1.0 / T)
        ref = jax.jit(lambda u, x: j_solve_stream(
            jocp, u, x, CFG.replace(newton_impl="par"), lanes=LANES,
            refill_every=REFILL))(jnp.asarray(u0), jnp.asarray(x0b))
        got = to_numpy(solve_stream(tocp, *pool_from_numpy(u0, x0b), cfg,
                                    lanes=LANES, refill_every=REFILL))
        np.testing.assert_array_equal(got.iterations,
                                      np.asarray(ref.iterations))
        assert got.steps == int(ref.steps)
        np.testing.assert_allclose(got.controls, np.asarray(ref.controls),
                                   rtol=0, atol=1e-9)
        return
    T = 12
    u0, x0b = _pool(j_pendulum, 4, T, seed=5)
    jocp, tocp = j_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(1.0 / T)
    for jcfg in (CFG.replace(newton_impl=impl, max_newton_iters=2),
                 CFG.replace(newton_impl=impl, max_newton_iters=2,
                             stage_predictor=False)):
        tcfg = config_from_jax(jcfg)
        j_step = jax.jit(jax.vmap(
            lambda ln: j_flat_lane_iter(jocp, ln, jcfg, ~ln.done)))
        j_lane = jax.vmap(lambda u, x: j_flat_lane_init(jocp, u, x, jcfg))(
            jnp.asarray(u0), jnp.asarray(x0b))
        lane = ip_newton.flat_lane_init(tocp, *pool_from_numpy(u0, x0b),
                                        tcfg)
        bp0 = lane.bp
        for _ in range(12):
            lane = ip_newton.flat_lane_iter(tocp, lane, tcfg, ~lane.done)
            j_lane = j_step(j_lane)
            for field, a in zip(lane._fields, lane):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(getattr(j_lane, field)), rtol=0,
                    atol=1e-10, err_msg=field)
        assert bool((lane.bp < bp0 / jcfg.bp_decay).any()), \
            "no lane reached a third stage"


def test_stream_requires_single_globalization():
    tocp = t_pendulum.make_ocp(0.1)
    with pytest.raises(ValueError, match="single"):
        solve_stream(tocp, torch.zeros((2, 10, 1)), torch.zeros((2, 2)),
                     config_from_jax(ipoc_tpu.FAST_CONFIG))
