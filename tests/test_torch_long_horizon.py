"""The mega kernel at long horizons: the port's one kernel covers the JAX
package's resident ``_mega_kernel`` and its streamed twin
``_mega_streamed_kernel`` (the lane state windowed through VMEM once it no
longer fits there).  On the CPU the wrapper runs its plain version, held
here to

* JAX's vmapped ``flat_lane_init``/``flat_lane_iter`` at a long horizon:
  pendulum T=640, B=8, float64, ``max_newton_iters=2`` (lanes roll over),
  the stage predictor on, two k-blocks of 2 with the lane carried across,
  Newton (``"fused"``) and DDP: equal ``it``, ``stage_it`` and ``done``,
  controls and states within 1e-10 (both sides run the same unfused
  compositions in float64; the packed lanes sum ``||cu||`` in another
  order);
* JAX's streamed kernel in interpret mode, as tests/test_mega_kernel.py's
  streamed pin runs it (``mega_fits`` forced False, a window of W=4 over
  T=8, k=2, B=1024, float32): controls and states within atol 2e-5, equal
  ``it``, ``stage_it`` and ``done``, 2 steps.

The card runs the kernel itself at T=1000 against the plain version
(tests/test_torch_cuda.py, chip_smoke.py phase O).

Run as a script, the file solves some of ``chip_smoke.py`` phase O's
scenarios (cartpole H=1000, the pool's recipe and seed, float64) with JAX's
vmapped ``flat_lane_init``/``flat_lane_iter`` under ``BATCH_CONFIG`` on the
CPU, and with the port's flat lanes (the same semantics, the plain
evaluators), and prints each scenario's iterations, to hold against the
card's (phase O5 reports the lanes that run to the iteration cap):

    PYTHONPATH=. python tests/test_torch_long_horizon.py 3 17 40

With ``--trace`` it steps the two in lockstep instead and prints where
their controls and decisions part, and JAX's iterations from controls
nudged by one unit in the last place (``phase_o_trace``):

    PYTHONPATH=. python tests/test_torch_long_horizon.py --trace 48 50
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ipoc_tpu
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.pallas import mega_kernel as mk
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.fused_iter_kernel import _pack_vec
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    LANES,
    _ceil_to,
    _pack_s,
    _unpack_s,
)
from ipoc_tpu.solvers.ip_newton import flat_lane_init as j_flat_lane_init
from ipoc_tpu.solvers.ip_newton import flat_lane_iter as j_flat_lane_iter
from ipoc_tpu.solvers.packed_stream import _pack_scal, _unpack_scal
from ipoc_tpu.solvers.packed_stream import packed_lane_init as j_lane_init
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import mega
from ipoc_tpu_torch.ops.fused_iter import lanes_first
from ipoc_tpu_torch.solvers import packed_stream as ps

torch.set_num_threads(1)


def _scenarios(n, T, dtype, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    x0b = (x0 + 0.02 * rng.normal(size=(n, 2))).astype(dtype)
    u0 = (0.1 * rng.normal(size=(n, T, 1))).astype(dtype)
    return u0, x0b


def _port_lanes(tocp, u0, x0b, cfg):
    u, x0 = ps._pack(*pool_from_numpy(u0, x0b))
    n = u.shape[-1]
    full = lambda v: torch.full((n,), v, dtype=u.dtype)  # noqa: E731
    return ps.packed_lane_init(tocp, u, x0, full(cfg.bp_init),
                               full(cfg.reg_init), cfg)


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_mega_plain_matches_jax_flat_lanes_at_T640(impl):
    T, B = 640, 8
    jcfg = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=2,
                                         newton_impl=impl)
    tcfg = config_from_jax(jcfg)
    u0, x0b = _scenarios(B, T, np.float64, seed=11)
    jocp, tocp = j_pendulum.make_ocp(1.0 / T), t_pendulum.make_ocp(1.0 / T)
    j_step = jax.jit(jax.vmap(
        lambda ln: j_flat_lane_iter(jocp, ln, jcfg, ~ln.done)))
    j_lane = jax.vmap(lambda u, x: j_flat_lane_init(jocp, u, x, jcfg))(
        jnp.asarray(u0), jnp.asarray(x0b))
    for _ in range(4):
        j_lane = j_step(j_lane)

    lane = _port_lanes(tocp, u0, x0b, tcfg)
    active = torch.ones(B, dtype=torch.bool)
    steps = 0
    for _ in range(2):  # two k-blocks of 2, the lane carried across
        lane, s = mega.mega_k_iterations(tocp, lane, active, tcfg, 2,
                                         ddp=impl == "ddp")
        steps += int(s)
    assert steps == 4
    assert bool((lane.bp < tcfg.bp_init).all()), "no lane rolled over"
    for field in ("it", "stage_it", "done"):
        np.testing.assert_array_equal(getattr(lane, field).numpy(),
                                      np.asarray(getattr(j_lane, field)),
                                      err_msg=field)
    np.testing.assert_allclose(lane.u.permute(2, 0, 1).numpy(),
                               np.asarray(j_lane.u), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lanes_first(lane.xs, lane.xT).numpy(),
                               np.asarray(j_lane.x), rtol=0, atol=1e-10)


def test_mega_plain_matches_jax_streamed_kernel(monkeypatch):
    T, B, S = 8, 1024, 8
    monkeypatch.setenv("IPOC_STREAM_WINDOW", "4")
    monkeypatch.setenv("IPOC_TIME_BLOCK", "2")  # small unroll: trace cost
    monkeypatch.setattr(mk, "mega_fits", lambda *a, **k: False)
    cfg = ipoc_tpu.BATCH_CONFIG
    u0, x0b = _scenarios(B, T, np.float32, seed=3)
    jocp = j_pendulum.make_ocp(1.0 / T)
    Bp = _ceil_to(B, S * LANES)
    C = Bp // (S * LANES)
    f32 = jnp.float32
    set_pallas_scans("on")
    try:
        with pltpu.force_tpu_interpret_mode():
            ln = j_lane_init(
                jocp, _pack_s(jnp.asarray(u0), Bp, S),
                _pack_vec(jnp.asarray(x0b), Bp, S),
                _pack_scal(jnp.full((B,), cfg.bp_init, f32), Bp, C, S, LANES),
                _pack_scal(jnp.full((B,), cfg.reg_init, f32), Bp, C, S, LANES),
                cfg, interpret=True)
            (xs, _, u, _, _, it, sit, _, _, _, done, steps) = \
                mk.mega_k_iterations(
                    jocp, ln.xs, ln.xT, ln.u, ln.u_prev, ln.cun, ln.it,
                    ln.stage_it, ln.rp, ln.r_inc, ln.bp, ln.bp0, ln.done,
                    ln.x0, jnp.ones_like(ln.done), cfg, 2, interpret=True)
    finally:
        set_pallas_scans("auto")
    tcfg = config_from_jax(cfg)
    tocp = t_pendulum.make_ocp(1.0 / T)
    got, got_steps = mega.mega_k_iterations(
        tocp, _port_lanes(tocp, u0, x0b, tcfg),
        torch.ones(B, dtype=torch.bool), tcfg, 2)
    assert int(got_steps) == int(steps) == 2
    np.testing.assert_allclose(got.u.permute(2, 0, 1).numpy(),
                               np.asarray(_unpack_s(u, B, (1,))), atol=2e-5)
    np.testing.assert_allclose(got.xs.permute(2, 0, 1).numpy(),
                               np.asarray(_unpack_s(xs, B, (2,))), atol=2e-5)
    for name, ref in (("it", it), ("stage_it", sit), ("done", done)):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(_unpack_scal(ref, B)),
                                      err_msg=name)


def _phase_o_pool(scenarios, horizon, seed):
    """Scenarios of ``chip_smoke.py`` phase O's pool (``make_batch`` with
    the seed, 4096 scenarios, float32 drawn), in float64 numpy."""
    from ipoc_tpu_torch.models import cartpole as t_cartpole
    from ipoc_tpu_torch.solvers.batched import make_batch

    u0, x0 = make_batch(torch.Generator().manual_seed(seed),
                        t_cartpole.initial_state(torch.float32), 4096,
                        horizon, 1, state_scale=0.01, control_scale=0.1)
    idx = list(scenarios)
    return idx, u0[idx].double().numpy(), x0[idx].double().numpy()


def _jax_lanes(u0, x0, horizon):
    """JAX's vmapped flat lanes under ``BATCH_CONFIG`` on cartpole: the
    opened lanes and the jitted iteration."""
    from ipoc_tpu.models import cartpole as j_cartpole

    cfg = ipoc_tpu.BATCH_CONFIG
    ocp = j_cartpole.make_ocp(1.0 / horizon)
    step = jax.jit(jax.vmap(lambda ln: j_flat_lane_iter(ocp, ln, cfg,
                                                        ~ln.done)))
    lane = jax.vmap(lambda u, x: j_flat_lane_init(ocp, u, x, cfg))(
        jnp.asarray(u0), jnp.asarray(x0))
    return lane, step


def _port_lanes_flat(u0, x0, horizon):
    """The port's flat lanes (plain evaluators) on the same scenarios: the
    opened lanes and one iteration."""
    from ipoc_tpu_torch.models import cartpole as t_cartpole
    from ipoc_tpu_torch.solvers import ip_newton

    tcfg = config_from_jax(ipoc_tpu.BATCH_CONFIG)
    tocp = t_cartpole.make_ocp(1.0 / horizon)
    lane = ip_newton.flat_lane_init(tocp, *pool_from_numpy(u0, x0), tcfg)
    return lane, lambda ln: ip_newton.flat_lane_iter(tocp, ln, tcfg,
                                                     ~ln.done)


def phase_o_iterations(scenarios, horizon=1000, seed=1):
    """JAX's flat lanes, then the port's, on scenarios of phase O's pool,
    solved in float64 under ``BATCH_CONFIG``: each scenario's iterations
    when it finished, or at the cap."""
    import time

    from ipoc_tpu.solvers.ip_newton import flat_total_cap

    idx, u0, x0 = _phase_o_pool(scenarios, horizon, seed)
    cap = flat_total_cap(ipoc_tpu.BATCH_CONFIG)
    out = {"scenarios": idx, "cap": cap}
    for name, (lane, step) in (("jax", _jax_lanes(u0, x0, horizon)),
                               ("port", _port_lanes_flat(u0, x0, horizon))):
        t0 = time.perf_counter()
        for _ in range(cap):
            if bool(np.asarray(lane.done).all()):
                break
            lane = step(lane)
        out[f"{name}_iterations"] = np.asarray(lane.it).tolist()
        out[f"{name}_seconds"] = time.perf_counter() - t0
    return out


def phase_o_trace(scenarios, horizon=1000, seed=1):
    """JAX's and the port's float64 flat lanes in lockstep on scenarios of
    phase O's pool.  Per scenario: the gap between the two controls, max
    |u_jax - u_port| / max |u_jax|, after iterations 1, 10, 100, ..., the
    first iteration at which it passes each of 1e-12 ... 1e-3, the first
    iteration whose decisions differ (``it``, ``stage_it``, ``done``, or
    ``bp`` beyond 1e-12 relative), and both final iteration counts.  Then
    JAX alone from the same controls nudged by one unit in the last place
    (``np.nextafter`` up and down): the iterations each reaches."""
    from ipoc_tpu.solvers.ip_newton import flat_total_cap

    idx, u0, x0 = _phase_o_pool(scenarios, horizon, seed)
    cap = flat_total_cap(ipoc_tpu.BATCH_CONFIG)
    (j, j_step), (t, t_step) = (_jax_lanes(u0, x0, horizon),
                                _port_lanes_flat(u0, x0, horizon))
    n = len(idx)
    marks = (1e-12, 1e-9, 1e-6, 1e-3)
    gap_at, crossed, parted = ([{} for _ in idx] for _ in range(3))
    for i in range(1, cap + 1):
        if bool(np.asarray(j.done).all()) and bool(t.done.all()):
            break
        j, t = j_step(j), t_step(t)
        uj = np.asarray(j.u)
        gap = (np.abs(uj - t.u.numpy()).max(axis=(1, 2))
               / np.abs(uj).max(axis=(1, 2)))
        same = ((np.asarray(j.it) == t.it.numpy())
                & (np.asarray(j.stage_it) == t.stage_it.numpy())
                & (np.asarray(j.done) == t.done.numpy())
                & np.isclose(np.asarray(j.bp), t.bp.numpy(), rtol=1e-12,
                             atol=0))
        for s in range(n):
            if i in (1, 10, 100, 200, 500, 1000) or i == cap:
                gap_at[s][i] = float(gap[s])
            for m in marks:
                if gap[s] > m and m not in crossed[s]:
                    crossed[s][m] = i
            if not same[s] and "iteration" not in parted[s]:
                parted[s] = {"iteration": i, "gap": float(gap[s]),
                             "jax": [int(np.asarray(j.it)[s]),
                                     int(np.asarray(j.stage_it)[s])],
                             "port": [int(t.it[s]), int(t.stage_it[s])]}
    out = {"scenarios": idx, "cap": cap,
           "jax_iterations": np.asarray(j.it).tolist(),
           "port_iterations": t.it.tolist(),
           "gap_after": gap_at, "gap_first_above": crossed,
           "decisions_first_differ": parted}
    for name, way in (("up", np.inf), ("down", -np.inf)):
        lane, step = _jax_lanes(np.nextafter(u0, way), x0, horizon)
        for _ in range(cap):
            if bool(np.asarray(lane.done).all()):
                break
            lane = step(lane)
        out[f"jax_iterations_nudged_{name}"] = np.asarray(lane.it).tolist()
    return out


if __name__ == "__main__":
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    args = sys.argv[1:]
    run = phase_o_trace if args[:1] == ["--trace"] else phase_o_iterations
    print(json.dumps(run(int(a) for a in args if a != "--trace")))
