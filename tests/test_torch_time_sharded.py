"""The port's horizon-sharded solve (``solvers/time_sharded.py``) against
the JAX package's, float64 on gloo CPU process groups of 2 and 4 ranks
(``tests/test_time_sharded_solve.py``'s cases).

The same numpy-seeded inputs go through the JAX function, on the
conftest's virtual devices with the same shard count, and through the
port's, every rank of which must hand back the same full result:

* ``sharded_rollout`` on pendulum T=64: stage and terminal states within
  rtol 1e-12, atol 1e-12;
* ``ip_newton_time_sharded`` on pendulum T=64 (``globalization="single"``),
  the ``terminal_hessian="reference"`` quirk at T=16 and the retry loop
  (``DEFAULT_CONFIG``) at T=32: equal iterations, controls within rtol
  1e-8, atol 1e-9;
* ``ip_newton_batch_time_sharded`` on a 2 x 2 (batch x time) mesh, with
  and without the stage predictor: the same;
* the validation errors.

Each process group is spawned once for the module and runs every case of
its size (``tests/torch_dist.py``); JAX is imported inside the tests only,
so that the spawned ranks import none.
"""

import numpy as np
import pytest
import torch

from tests.torch_dist import Group, case_result, run_cases

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = dict(rtol=1e-8, atol=1e-9)


def _inputs(case: str):
    """The numpy inputs of a case: ``(T, controls, initial states)``."""
    from ipoc_tpu_torch.models import pendulum

    x0 = pendulum.initial_state(torch.float64).numpy()
    if case == "batch":
        T, rng = 16, np.random.default_rng(7)
        u = 0.1 * rng.normal(size=(2, T, 1))
        return T, u, x0[None] + 0.02 * rng.normal(size=(2, 2))
    T, seed = {"rollout": (64, 0), "solve": (64, 1), "quirk": (16, 2),
               "retry": (32, 3)}[case]
    return T, 0.1 * np.random.default_rng(seed).normal(size=(T, 1)), x0


def _torch_config(name: str):
    import ipoc_tpu_torch as t

    single = t.DEFAULT_CONFIG.replace(globalization="single")
    return {"solve": single,
            "quirk": single.replace(terminal_hessian="reference"),
            "retry": t.DEFAULT_CONFIG,
            "batch": single,
            "batch_predictor": single.replace(stage_predictor=True)}[name]


# --- the ranks' cases ------------------------------------------------------


def _case_rollout(world, meshes):
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.parallel.sharding import gather_shards, shard
    from ipoc_tpu_torch.solvers.time_sharded import sharded_rollout

    T, u, x0 = _inputs("rollout")
    mesh = meshes["time"]
    group, idx = mesh.get_group("time"), mesh.get_local_rank("time")
    u_local = shard(torch.tensor(u)[None], idx, world, 1)
    xs, xT = sharded_rollout(pendulum.make_ocp(1.0 / T).dynamics, u_local,
                             torch.tensor(x0)[None], group)
    return {"xs": gather_shards(xs, group, 1)[0].numpy(),
            "xT": xT[0].numpy()}


def _solve_case(name):
    def case(world, meshes):
        from ipoc_tpu_torch.models import pendulum
        from ipoc_tpu_torch.solvers import ip_newton_time_sharded

        T, u, x0 = _inputs(name)
        got_u, it = ip_newton_time_sharded(
            pendulum.make_ocp(1.0 / T), torch.tensor(u), torch.tensor(x0),
            meshes["time"], _torch_config(name))
        return {"u": got_u.numpy(), "it": int(it)}

    return case


def _batch_case(name):
    def case(world, meshes):
        from ipoc_tpu_torch.models import pendulum
        from ipoc_tpu_torch.solvers import ip_newton_batch_time_sharded

        T, u, x0 = _inputs("batch")
        got_u, it = ip_newton_batch_time_sharded(
            pendulum.make_ocp(1.0 / T), torch.tensor(u), torch.tensor(x0),
            meshes["batch_time"], _torch_config(name))
        return {"u": got_u.numpy(), "it": it.numpy()}

    return case


def _case_validation(world, meshes):
    """The messages of the entry points' ValueErrors (raised before any
    collective, on every rank)."""
    import ipoc_tpu_torch as t
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.solvers import (
        ip_newton_batch_time_sharded, ip_newton_time_sharded)

    T = 32
    ocp = pendulum.make_ocp(1.0 / T)
    x0 = pendulum.initial_state(torch.float64)
    u0 = torch.zeros((T, 1), dtype=torch.float64)
    single = t.DEFAULT_CONFIG.replace(globalization="single")
    mesh = meshes["time"]
    calls = {
        "flat": lambda: ip_newton_time_sharded(
            ocp, u0, x0, mesh, t.DEFAULT_CONFIG.replace(
                barrier_mode="flat", globalization="flat")),
        "seq": lambda: ip_newton_time_sharded(
            ocp, u0, x0, mesh, single.replace(newton_impl="seq")),
        "horizon": lambda: ip_newton_time_sharded(ocp, u0[:31], x0, mesh,
                                                  single),
        "batch_retry": lambda: ip_newton_batch_time_sharded(
            ocp, u0[None], x0[None], mesh, t.DEFAULT_CONFIG),
        "batch_horizon": lambda: ip_newton_batch_time_sharded(
            ocp, u0[None, :31], x0[None], mesh, single),
    }
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[key] = "no error"
        except ValueError as exc:
            out[key] = str(exc)
    return out


CASES = {
    "rollout": _case_rollout,
    "solve": _solve_case("solve"),
    "quirk": _solve_case("quirk"),
    "retry": _solve_case("retry"),
    "batch": _batch_case("batch"),
    "batch_predictor": _batch_case("batch_predictor"),
    "validation": _case_validation,
}
# The (batch x time) cases need 2 x 2 ranks.
BATCH_CASES = ("batch", "batch_predictor")


def _worker(rank, world):
    from ipoc_tpu_torch.parallel.sharding import make_mesh

    meshes = {"time": make_mesh(1, world)}
    if world == 4:
        meshes["batch_time"] = make_mesh(2, 2)
    cases = {k: v for k, v in CASES.items()
             if world == 4 or k not in BATCH_CASES}
    return run_cases(cases, rank, world, meshes)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both process groups, started together; each test joins them when it
    first needs a result, so the JAX references are computed meanwhile."""
    started = {w: Group(_worker, w, tmp_path_factory.mktemp(f"ranks{w}"))
               for w in WORLDS}
    yield started
    for g in started.values():
        try:
            g.results()
        except RuntimeError:
            pass  # reported by the tests that read it


# --- the JAX references -------------------------------------------------


def _jax_config(name):
    import ipoc_tpu

    single = ipoc_tpu.DEFAULT_CONFIG.replace(globalization="single")
    return {"solve": single,
            "quirk": single.replace(terminal_hessian="reference"),
            "retry": ipoc_tpu.DEFAULT_CONFIG,
            "batch": single,
            "batch_predictor": single.replace(stage_predictor=True)}[name]


def test_configs_and_initial_state_match_jax():
    import jax.numpy as jnp
    from ipoc_tpu.models import pendulum as j_pendulum
    from ipoc_tpu_torch.interop import config_from_jax

    for name in ("solve", "quirk", "retry", "batch", "batch_predictor"):
        assert _torch_config(name) == config_from_jax(_jax_config(name))
    np.testing.assert_array_equal(
        _inputs("solve")[2], np.asarray(j_pendulum.initial_state(
            jnp.float64)))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rollout_matches_jax(groups, world):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ipoc_tpu.models import pendulum as j_pendulum
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.time_sharded import sharded_rollout

    T, u, x0 = _inputs("rollout")
    ocp = j_pendulum.make_ocp(1.0 / T)
    xs, xT = jax.jit(shard_map(
        lambda uu, xx: sharded_rollout(ocp.dynamics, uu, xx),
        mesh=make_mesh(time=world), in_specs=(P("time", None), P()),
        out_specs=(P("time", None), P()), check_vma=False,
    ))(jnp.asarray(u), jnp.asarray(x0))
    got = case_result(groups[world], "rollout")
    np.testing.assert_allclose(got["xs"], np.asarray(xs), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got["xT"], np.asarray(xT), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["solve", "quirk", "retry"])
def test_time_sharded_solve_matches_jax(groups, world, name):
    """Pendulum T=64 single-trial, the XT=Q[0] quirk (a cross-shard
    broadcast of the globally first stage) at T=16, and the retry loop at
    T=32, each against JAX's solve on as many shards."""
    import jax
    import jax.numpy as jnp
    from ipoc_tpu.models import pendulum as j_pendulum
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.time_sharded import ip_newton_time_sharded

    T, u, x0 = _inputs(name)
    ocp, cfg = j_pendulum.make_ocp(1.0 / T), _jax_config(name)
    mesh = make_mesh(time=world)
    u_ref, it_ref = jax.jit(
        lambda uu, xx: ip_newton_time_sharded(ocp, uu, xx, mesh, cfg)
    )(jnp.asarray(u), jnp.asarray(x0))
    got = case_result(groups[world], name)
    assert got["it"] == int(it_ref)
    np.testing.assert_allclose(got["u"], np.asarray(u_ref), **TOL)


@pytest.mark.parametrize("name", BATCH_CASES)
def test_batch_time_sharded_matches_jax(groups, name):
    """A 2 x 2 (batch x time) mesh solves 2 scenarios, each horizon on two
    ranks, in masked flat mode, with and without the stage predictor."""
    import jax
    import jax.numpy as jnp
    from ipoc_tpu.models import pendulum as j_pendulum
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.solvers.time_sharded import ip_newton_batch_time_sharded

    T, u, x0 = _inputs("batch")
    ocp, cfg = j_pendulum.make_ocp(1.0 / T), _jax_config(name)
    mesh = make_mesh(batch=2, time=2)
    u_ref, it_ref = jax.jit(
        lambda uu, xx: ip_newton_batch_time_sharded(ocp, uu, xx, mesh, cfg)
    )(jnp.asarray(u), jnp.asarray(x0))
    got = case_result(groups[4], name)
    np.testing.assert_array_equal(got["it"], np.asarray(it_ref))
    np.testing.assert_allclose(got["u"], np.asarray(u_ref), **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_validation(groups, world):
    got = case_result(groups[world], "validation")
    assert "single" in got["flat"]
    assert "par" in got["seq"]
    assert "divisible" in got["horizon"]
    assert "single" in got["batch_retry"]
    assert "divisible" in got["batch_horizon"]


def test_stage_helpers_match_jax():
    """``first_order_stages`` and ``hamiltonian_lqr_stages`` on explicit
    stage slices against JAX's, and equal to the trajectory forms they
    now serve."""
    import jax.numpy as jnp
    from ipoc_tpu.models import cartpole as j_cartpole
    from ipoc_tpu.ops import derivatives as jd
    from ipoc_tpu_torch.models import cartpole as t_cartpole
    from ipoc_tpu_torch.ops import derivatives as td

    T = 12
    rng = np.random.default_rng(11)
    xs = np.asarray(j_cartpole.initial_state(jnp.float64)) \
        + 0.1 * rng.normal(size=(T, 4))
    u = 0.1 * rng.normal(size=(T, 1))
    lam = rng.normal(size=(T, 4))
    j_ocp, t_ocp = j_cartpole.make_ocp(1.0 / T), t_cartpole.make_ocp(1.0 / T)
    bp = 0.1
    jd1 = jd.first_order_stages(j_ocp, jnp.asarray(xs), jnp.asarray(u), bp)
    td1 = td.first_order_stages(t_ocp, torch.tensor(xs)[None],
                                torch.tensor(u)[None], bp)
    for f in ("cx", "cu", "fx", "fu"):
        np.testing.assert_allclose(getattr(td1, f)[0].numpy(),
                                   np.asarray(getattr(jd1, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    jl = jd.hamiltonian_lqr_stages(j_ocp, jnp.asarray(xs), jnp.asarray(u),
                                   jnp.asarray(lam), bp)
    tl = td.hamiltonian_lqr_stages(t_ocp, torch.tensor(xs)[None],
                                   torch.tensor(u)[None],
                                   torch.tensor(lam)[None], bp)
    for f in ("r", "Q", "R", "M"):
        np.testing.assert_allclose(getattr(tl, f)[0].numpy(),
                                   np.asarray(getattr(jl, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
