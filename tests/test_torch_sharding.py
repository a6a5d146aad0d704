"""The port's distribution layer (``parallel/sharding.py``,
``parallel/distributed.py``, ``parallel/time_sharded.py``, the
batch-sharded solves and streams) on gloo CPU process groups of 2 and 4
ranks, float64 (``tests/test_sharding.py``'s cases).

* The cross-shard affine scan, forward and reverse, both as
  ``sharded_associative_scan`` and as the solver runs it (the scan
  wrapper's local scan, then ``combine_across_shards``), the value scan's
  cross-shard combine, and the time-sharded LQT solve, against JAX's on
  the conftest's virtual devices with the same shard count: rtol 1e-12,
  atol 1e-12.
* ``solve_batch_sharded``, ``solve_stream_sharded`` and
  ``solve_stream_multigrid_sharded`` (lanes=2, ``BATCH_CONFIG``) against
  the port's unsharded runs on the same pool: equal iterations, controls
  within 1e-12.
* The mesh's coordinates and groups, ``global_mesh``'s errors,
  ``initialize`` in a single process, ``scaling_report``.

Every rank must hand back the same full result.  Each process group is
spawned once for the module and runs every case (``tests/torch_dist.py``);
JAX is imported inside the tests only, so that the spawned ranks import
none.
"""

import os

import numpy as np
import pytest
import torch

import ipoc_tpu_torch as t
from tests.torch_dist import Group, case_result, run_cases

torch.set_num_threads(1)

WORLDS = (2, 4)
SCAN_TOL = dict(rtol=1e-12, atol=1e-12)
# Pools of the batch and stream cases (pendulum), the same at every world.
POOL, T_BATCH, T_STREAM, COARSEN = 8, 16, 8, 2


def _affine_elems(seed, T, n):
    rng = np.random.default_rng(seed)
    return 0.5 * rng.normal(size=(T, n, n)), rng.normal(size=(T, n))


def _random_lqt(seed, T=16, nx=3, nu=2):
    """A well-conditioned random LQT with cross terms and drift, as numpy
    arrays in the field order ``A, B, c, XT, HT, rT, X, H, r, U, Z, s, M``
    (``tests/conftest.py``'s recipe)."""
    rng = np.random.default_rng(seed)

    def psd(n, scale):
        a = rng.normal(size=(n, n))
        return scale * (a @ a.T + n * np.eye(n))

    A = 0.5 * rng.normal(size=(T, nx, nx))
    B = rng.normal(size=(T, nx, nu))
    c = 0.3 * rng.normal(size=(T, nx))
    X = np.stack([psd(nx, 0.5) for _ in range(T)])
    U = np.stack([psd(nu, 1.0) for _ in range(T)])
    M = 0.2 * rng.normal(size=(T, nx, nu))
    r = rng.normal(size=(T, nx))
    s = rng.normal(size=(T, nu))
    H = np.broadcast_to(np.eye(nx), (T, nx, nx)).copy()
    Z = np.broadcast_to(np.eye(nu), (T, nu, nu)).copy()
    XT, HT, rT = psd(nx, 1.0), np.eye(nx), rng.normal(size=(nx,))
    return (A, B, c, XT, HT, rT, X, H, r, U, Z, s, M), rng.normal(size=(nx,))


def _pool(T, seed):
    from ipoc_tpu_torch.models import pendulum

    rng = np.random.default_rng(seed)
    x0 = pendulum.initial_state(torch.float64).numpy()
    return (0.1 * rng.normal(size=(POOL, T, 1)),
            x0 + 0.05 * rng.normal(size=(POOL, 2)))


# --- the ranks' cases ------------------------------------------------------


def _time_group(meshes):
    
    mesh = meshes["time"]
    return mesh.get_group("time"), mesh.get_local_rank("time")


def _local(a, idx, world):
    """This rank's slice of a ``(T, ...)`` array, with a lane axis."""
    from ipoc_tpu_torch.parallel.sharding import shard

    return shard(torch.tensor(a)[None], idx, world, 1)


def _gathered(elems, group):
    from ipoc_tpu_torch.parallel.sharding import gather_shards

    return [gather_shards(e, group, 1)[0].numpy() for e in elems]


def _scan_case(reverse):
    def case(world, meshes):
        from ipoc_tpu_torch.ops.scan_kernels import affine_scan
        from ipoc_tpu_torch.parallel.costates import affine_combine
        from ipoc_tpu_torch.parallel.sharding import (
            combine_across_shards, sharded_associative_scan)

        group, idx = _time_group(meshes)
        F, c = (_local(a, idx, world) for a in
                _affine_elems(8 if reverse else 7, 16, 2 if reverse else 3))
        # fn(earlier, later): the reverse scan composes earlier after
        # later (the costates), the forward one later after earlier.
        fn = (affine_combine if reverse
              else (lambda a, b: affine_combine(b, a)))
        generic = sharded_associative_scan(fn, (F, c), group, reverse=reverse)
        wrapped = combine_across_shards(fn, affine_scan(F, c, reverse=reverse),
                                        group, reverse=reverse)
        return dict(zip(("F", "c", "F_wrapper", "c_wrapper"),
                        _gathered(generic, group) + _gathered(wrapped, group)))

    return case


def _case_value_scan(world, meshes):
    from ipoc_tpu_torch.ops.scan_kernels import value_scan
    from ipoc_tpu_torch.parallel.lqt import LQT, _elements, value_combine
    from ipoc_tpu_torch.parallel.sharding import combine_across_shards

    group, idx = _time_group(meshes)
    fields, _ = _random_lqt(5)
    elems = _elements(LQT(*(torch.tensor(f)[None] for f in fields)))
    local = [_local(e[0].numpy(), idx, world).contiguous() for e in elems]
    out = combine_across_shards(value_combine, value_scan(*local), group,
                                reverse=True)
    return dict(zip("AbCeJ", _gathered(out, group)))


def _case_lqt(world, meshes):
    from ipoc_tpu_torch.parallel.lqt import LQT
    from ipoc_tpu_torch.parallel.time_sharded import solve_lqt_time_sharded

    fields, x0 = _random_lqt(3)
    u, x = solve_lqt_time_sharded(LQT(*(torch.tensor(f)[None]
                                        for f in fields)),
                                  torch.tensor(x0)[None], meshes["time"])
    return {"u": u[0].numpy(), "x": x[0].numpy()}


def _case_batch(world, meshes):
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.solvers import solve_batch_sharded

    u, x0 = _pool(T_BATCH, 1)
    sol = solve_batch_sharded(pendulum.make_ocp(1.0 / T_BATCH),
                              torch.tensor(u), torch.tensor(x0),
                              meshes["batch"], t.FAST_CONFIG)
    return {"u": sol.controls.numpy(), "it": sol.iterations.numpy()}


def _case_stream(world, meshes):
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.solvers import solve_stream_sharded

    u, x0 = _pool(T_STREAM, 2)
    sol = solve_stream_sharded(pendulum.make_ocp(1.0 / T_STREAM),
                               torch.tensor(u), torch.tensor(x0),
                               meshes["batch"], t.BATCH_CONFIG, lanes=2,
                               refill_every=4)
    out = {"u": sol.controls.numpy(), "it": sol.iterations.numpy(),
           "steps": sol.steps}
    try:
        solve_stream_sharded(pendulum.make_ocp(1.0 / T_STREAM),
                             torch.tensor(u), torch.tensor(x0),
                             meshes["batch"], t.BATCH_CONFIG,
                             bp_init=torch.full((POOL,), 0.1))
        out["refused"] = "no error"
    except ValueError as exc:
        out["refused"] = str(exc)
    return out


def _case_multigrid(world, meshes):
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.solvers import solve_stream_multigrid_sharded

    u, x0 = _pool(T_STREAM, 3)
    sol = solve_stream_multigrid_sharded(
        pendulum.make_ocp(1.0 / T_STREAM),
        pendulum.make_ocp(COARSEN / T_STREAM), COARSEN, torch.tensor(u),
        torch.tensor(x0), meshes["batch"], t.BATCH_CONFIG, lanes=2,
        refill_every=4, coarse_impl="ddp")
    return {"u": sol.controls.numpy(), "it": sol.iterations.numpy(),
            "it_coarse": sol.iterations_coarse.numpy(), "steps": sol.steps,
            "steps_coarse": sol.steps_coarse}


def _case_mesh(world, meshes):
    """Every rank's coordinates and the groups' ranks, gathered so that
    every rank returns the whole table; ``global_mesh``'s errors and a
    second ``initialize``."""
    import torch.distributed as dist

    from ipoc_tpu_torch.parallel import distributed
    from ipoc_tpu_torch.parallel.sharding import (
        all_gather, axis_size)

    mesh = meshes["grid"]
    row = torch.tensor([
        dist.get_rank(), mesh.get_local_rank("batch"),
        mesh.get_local_rank("time"), axis_size(mesh, "batch"),
        axis_size(mesh, "time"), dist.get_world_size(mesh.get_group("time")),
        dist.get_world_size(mesh.get_group("batch"))])
    out = {"table": all_gather(row, None).numpy()}
    distributed.initialize("file:///nonexistent", world, 0)  # initialized
    errors = {"indivisible": (3, None), "span": (2, "1"), "straddle": (2, "3")}
    for key, (time, local) in errors.items():
        saved = os.environ.get("LOCAL_WORLD_SIZE")
        if local is not None:
            os.environ["LOCAL_WORLD_SIZE"] = local
        try:
            distributed.global_mesh(time)
            out[key] = "no error"
        except ValueError as exc:
            out[key] = str(exc)
        finally:
            if saved is None:
                os.environ.pop("LOCAL_WORLD_SIZE", None)
            else:
                os.environ["LOCAL_WORLD_SIZE"] = saved
    out["global_shape"] = np.array(distributed.global_mesh(2).shape)
    return out


CASES = {
    "scan_forward": _scan_case(False),
    "scan_reverse": _scan_case(True),
    "value_scan": _case_value_scan,
    "lqt": _case_lqt,
    "batch": _case_batch,
    "stream": _case_stream,
    "multigrid": _case_multigrid,
    "mesh": _case_mesh,
}


def _worker(rank, world):
    from ipoc_tpu_torch.parallel.sharding import make_mesh

    meshes = {"time": make_mesh(1, world), "batch": make_mesh(world, 1),
              "grid": make_mesh(world // 2, 2)}
    return run_cases(CASES, rank, world, meshes)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both process groups, started together; each test joins them when it
    first needs a result, so the references are computed meanwhile."""
    started = {w: Group(_worker, w, tmp_path_factory.mktemp(f"ranks{w}"))
               for w in WORLDS}
    yield started
    for g in started.values():
        try:
            g.results()
        except RuntimeError:
            pass  # reported by the tests that read it


# --- the references -------------------------------------------------------


def _jax_sharded_scan(fn, elems, world, reverse, element=tuple):
    """JAX's ``sharded_associative_scan`` over ``world`` virtual devices;
    ``element`` rebuilds the element (a tuple, or the NamedTuple that
    ``fn`` returns)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ipoc_tpu.parallel.sharding import (
        make_mesh, sharded_associative_scan)

    specs = element(P("time") for _ in elems)
    return jax.jit(shard_map(
        lambda e: sharded_associative_scan(fn, e, "time", reverse=reverse),
        mesh=make_mesh(time=world), in_specs=(specs,), out_specs=specs,
        check_vma=False,
    ))(element(jnp.asarray(e) for e in elems))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forward", "reverse"])
def test_sharded_affine_scan_matches_jax(groups, world, reverse):
    from ipoc_tpu.parallel.costates import affine_combine

    fn = affine_combine if reverse else (lambda a, b: affine_combine(b, a))
    F, c = _affine_elems(8 if reverse else 7, 16, 2 if reverse else 3)
    ref = _jax_sharded_scan(fn, (F, c), world, reverse)
    got = case_result(groups[world],
                      "scan_reverse" if reverse else "scan_forward")
    for suffix in ("", "_wrapper"):
        np.testing.assert_allclose(got["F" + suffix], np.asarray(ref[0]),
                                   **SCAN_TOL)
        np.testing.assert_allclose(got["c" + suffix], np.asarray(ref[1]),
                                   **SCAN_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_value_scan_matches_jax(groups, world):
    import jax.numpy as jnp
    from ipoc_tpu.parallel.lqt import (
        LQT, ValueElement, _elements, value_combine)

    fields, _ = _random_lqt(5)
    elems = _elements(LQT(*(jnp.asarray(f) for f in fields)))
    ref = _jax_sharded_scan(value_combine, elems, world, True,
                            element=lambda e: ValueElement(*e))
    got = case_result(groups[world], "value_scan")
    for key, r in zip("AbCeJ", ref):
        np.testing.assert_allclose(got[key], np.asarray(r), **SCAN_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_lqt_solve_matches_jax(groups, world):
    import jax.numpy as jnp
    from ipoc_tpu.parallel.lqt import LQT
    from ipoc_tpu.parallel.sharding import make_mesh
    from ipoc_tpu.parallel.time_sharded import solve_lqt_time_sharded

    fields, x0 = _random_lqt(3)
    u, x = solve_lqt_time_sharded(LQT(*(jnp.asarray(f) for f in fields)),
                                  jnp.asarray(x0), make_mesh(time=world))
    got = case_result(groups[world], "lqt")
    np.testing.assert_allclose(got["u"], np.asarray(u), **SCAN_TOL)
    np.testing.assert_allclose(got["x"], np.asarray(x), **SCAN_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_solve_batch_sharded_matches_unsharded(groups, world):
    from ipoc_tpu_torch.models import pendulum

    u, x0 = _pool(T_BATCH, 1)
    ref = t.solve_batch(pendulum.make_ocp(1.0 / T_BATCH), torch.tensor(u),
                        torch.tensor(x0), t.FAST_CONFIG)
    got = case_result(groups[world], "batch")
    np.testing.assert_array_equal(got["it"], ref.iterations.numpy())
    np.testing.assert_allclose(got["u"], ref.controls.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_solve_stream_sharded_matches_unsharded(groups, world):
    from ipoc_tpu_torch.models import pendulum

    u, x0 = _pool(T_STREAM, 2)
    ref = t.solve_stream(pendulum.make_ocp(1.0 / T_STREAM), torch.tensor(u),
                         torch.tensor(x0), t.BATCH_CONFIG, lanes=2,
                         refill_every=4)
    got = case_result(groups[world], "stream")
    np.testing.assert_array_equal(got["it"], ref.iterations.numpy())
    np.testing.assert_allclose(got["u"], ref.controls.numpy(), rtol=0,
                               atol=1e-12)
    # Each rank drains POOL / world scenarios through the same 2 lanes.
    assert 0 < got["steps"] <= ref.steps
    assert "bp_init" in got["refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_solve_stream_multigrid_sharded_matches_unsharded(groups, world):
    from ipoc_tpu_torch.models import pendulum

    u, x0 = _pool(T_STREAM, 3)
    ref = t.solve_stream_multigrid(
        pendulum.make_ocp(1.0 / T_STREAM),
        pendulum.make_ocp(COARSEN / T_STREAM), COARSEN, torch.tensor(u),
        torch.tensor(x0), t.BATCH_CONFIG, lanes=2, refill_every=4,
        coarse_impl="ddp")
    got = case_result(groups[world], "multigrid")
    np.testing.assert_array_equal(got["it"], ref.iterations.numpy())
    np.testing.assert_array_equal(got["it_coarse"],
                                  ref.iterations_coarse.numpy())
    np.testing.assert_allclose(got["u"], ref.controls.numpy(), rtol=0,
                               atol=1e-12)
    assert 0 < got["steps"] <= ref.steps
    assert 0 < got["steps_coarse"] <= ref.steps_coarse


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_coordinates_and_global_mesh(groups, world):
    got = case_result(groups[world], "mesh")
    ranks = np.arange(world)
    # Rank b * time + t sits at (b, t) of the (world // 2, 2) mesh, as JAX
    # reshapes its devices.
    np.testing.assert_array_equal(got["table"], np.stack(
        [ranks, ranks // 2, ranks % 2, np.full(world, world // 2),
         np.full(world, 2), np.full(world, 2), np.full(world, world // 2)],
        axis=1))
    assert "not divisible" in got["indivisible"]
    assert "span hosts" in got["span"]
    assert "straddle" in got["straddle"]
    np.testing.assert_array_equal(got["global_shape"], [world // 2, 2])


def test_initialize_single_process_and_scaling_report():
    import torch.distributed as dist

    from ipoc_tpu_torch.parallel.distributed import (
        initialize, scaling_report)

    saved = os.environ.pop("WORLD_SIZE", None)
    try:
        initialize()
        initialize(num_processes=1)
        assert not dist.is_initialized()
    finally:
        if saved is not None:
            os.environ["WORLD_SIZE"] = saved
    rep = scaling_report(300.0, 4, 100.0)
    assert rep == {"chips": 4, "solves_per_sec": 300.0, "ideal": 400.0,
                   "efficiency": 0.75}
