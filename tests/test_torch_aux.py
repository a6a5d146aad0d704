"""The port's auxiliaries against the JAX package's (mirrors
tests/test_aux.py): the JSONL logger, the checkpointed campaign runner
(resume, partial resume, the identity guard, and campaign directories
that cross between the two packages' runners), the timing protocol and a
CPU trace.  float64 on the CPU; inputs made with numpy from a seed."""

import json
import os
import shutil
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
import ipoc_tpu.solvers.checkpoint as j_ckpt
import ipoc_tpu_torch
import ipoc_tpu_torch.solvers.checkpoint as t_ckpt
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from ipoc_tpu_torch.models import pendulum
from ipoc_tpu_torch.solvers.batched import BatchSolution, solve_batch
from ipoc_tpu_torch.utils import profiling, timing
from ipoc_tpu_torch.utils.logging import JsonlLogger

torch.set_num_threads(1)
F64 = torch.float64


def scenarios(seed, n, horizon):
    """``(u0 (n, horizon, 1), x0 (n, 2))`` as numpy: noise warm starts
    about pendulum's initial state."""
    rng = np.random.default_rng(seed)
    x0 = pendulum.initial_state(F64).numpy()
    return (0.1 * rng.standard_normal((n, horizon, 1)),
            x0[None] + 0.02 * rng.standard_normal((n, 2)))


def tensors(*arrays):
    return tuple(torch.as_tensor(a, dtype=F64) for a in arrays)


def test_jsonl_logger(tmp_path):
    """The port's records are the JAX logger's, apart from ``ts``; with and
    without the ``with`` block."""
    records = [{"a": 1}, {"b": 2.5, "s": "x"}, {"n": [1, 2]}]
    paths = {}
    for name, cls in (("port", JsonlLogger), ("jax", JaxJsonlLogger)):
        paths[name] = str(tmp_path / name / "log.jsonl")
        with cls(paths[name]) as lg:
            for r in records[:2]:
                lg.log(r)
        cls(paths[name]).log(records[2])
    lines = {k: [json.loads(line) for line in open(p)]
             for k, p in paths.items()}
    assert all("ts" in rec for rec in lines["port"])
    strip = [{k: v for k, v in rec.items() if k != "ts"}
             for rec in lines["port"]]
    assert strip == records
    assert strip == [{k: v for k, v in rec.items() if k != "ts"}
                     for rec in lines["jax"]]
    assert [list(r) for r in lines["port"]] == [list(r)
                                                 for r in lines["jax"]]


def test_checkpoint_resume(tmp_path):
    ocp = pendulum.make_ocp(0.05)
    u0, x0b = tensors(*scenarios(0, 6, 15))
    cfg = ipoc_tpu_torch.FAST_CONFIG.replace(max_newton_iters=40)
    calls = []

    def counting_solve(u, x):
        calls.append(u.shape[0])
        return solve_batch(ocp, u, x, cfg)

    runner = t_ckpt.CheckpointedBatchRunner(str(tmp_path / "ckpt"),
                                            chunk_size=2)
    sol1 = runner.run(ocp, u0, x0b, cfg, solve_fn=counting_solve)
    assert sol1.controls.shape == (6, 15, 1)
    assert sol1.iterations.dtype == torch.int32
    assert len(calls) == 3  # 3 chunks solved
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert files == [f"chunk_{i:06d}.npz" for i in range(3)] + [
        "manifest.json"]
    with np.load(tmp_path / "ckpt" / "chunk_000001.npz") as data:
        assert sorted(data.files) == ["controls", "iterations"]
        assert data["iterations"].dtype == np.int32

    # Resume: no chunk re-solved, identical results.
    calls.clear()
    runner2 = t_ckpt.CheckpointedBatchRunner(str(tmp_path / "ckpt"),
                                             chunk_size=2)
    sol2 = runner2.run(ocp, u0, x0b, cfg, solve_fn=counting_solve)
    assert calls == []
    assert torch.equal(sol1.controls, sol2.controls)
    assert torch.equal(sol1.iterations, sol2.iterations)


def test_checkpoint_partial_resume(tmp_path):
    """Simulate a crash after one chunk: only remaining chunks are solved."""
    ocp = pendulum.make_ocp(0.05)
    u0, x0b = tensors(*scenarios(2, 4, 12))
    cfg = ipoc_tpu_torch.FAST_CONFIG.replace(max_newton_iters=30)

    runner = t_ckpt.CheckpointedBatchRunner(str(tmp_path / "ck2"),
                                            chunk_size=2)
    # Solve only chunk 0 by hand, mark it done.
    sol0 = solve_batch(ocp, u0[:2], x0b[:2], cfg)
    runner._save_chunk(0, BatchSolution(sol0.controls, sol0.iterations))

    calls = []

    def counting_solve(u, x):
        calls.append(u.shape[0])
        return solve_batch(ocp, u, x, cfg)

    sol = runner.run(ocp, u0, x0b, cfg, solve_fn=counting_solve)
    assert calls == [2]  # only chunk 1
    assert torch.equal(sol.controls[:2], sol0.controls)


@pytest.fixture(scope="module")
def solved_campaign(tmp_path_factory):
    """A directory of a finished default-solve campaign (4 scenarios in
    chunks of 2, ``FAST_CONFIG`` capped at 30 iterations) and its inputs."""
    ocp = pendulum.make_ocp(0.05)
    u0, x0b = tensors(*scenarios(1, 4, 12))
    cfg = ipoc_tpu_torch.FAST_CONFIG.replace(max_newton_iters=30)
    path = tmp_path_factory.mktemp("campaign") / "ckid"
    sol = t_ckpt.CheckpointedBatchRunner(str(path), chunk_size=2).run(
        ocp, u0, x0b, cfg)
    return path, ocp, u0, x0b, cfg, sol


# Each change of the campaign's identity, as (chunk_size, run arguments).
IDENTITY_CHANGES = {
    "chunk_size": lambda u, x, c: (1, (u, x, c)),
    "shape": lambda u, x, c: (2, (u[:2], x[:2], c)),
    "horizon": lambda u, x, c: (2, (u[:, :6], x, c)),
    "cfg": lambda u, x, c: (2, (u, x, c.replace(tol=1e-6))),
    "method": lambda u, x, c: (2, (u, x, c, "seq")),
    "custom_solve_fn": lambda u, x, c: (2, (u, x, c, "par",
                                            lambda *a: None)),
    "dtype": lambda u, x, c: (2, (u.float(), x.float(), c)),
}


class Interrupted(RuntimeError):
    """A campaign stopped in the middle."""


def counted_solve_batch(module, monkeypatch, stop_after=None):
    """Replace ``module.solve_batch`` (the runner's default solve) by one
    that records each chunk's size and raises once ``stop_after`` chunks
    were solved: a run interrupted there."""
    real, calls = module.solve_batch, []

    def solve(ocp, u, x, cfg, method):
        if stop_after is not None and len(calls) == stop_after:
            raise Interrupted("interrupted")
        calls.append(int(u.shape[0]))
        return real(ocp, u, x, cfg, method)

    monkeypatch.setattr(module, "solve_batch", solve)
    return calls


@pytest.mark.parametrize("change", list(IDENTITY_CHANGES))
def test_checkpoint_identity_guard(solved_campaign, tmp_path, monkeypatch,
                                   change):
    """Resuming with a different chunk_size, campaign shape, cfg, method
    or dtype must REFUSE (index-keyed chunk files would splice at wrong
    offsets, or chunks solved under other settings would mix), not
    silently mix stale chunks into the result; the unchanged identity
    still resumes, solving nothing."""
    path, ocp, u0, x0b, cfg, sol = solved_campaign
    ckdir = tmp_path / "ckid"
    shutil.copytree(path, ckdir)
    chunk_size, args = IDENTITY_CHANGES[change](u0, x0b, cfg)
    with pytest.raises(ValueError, match="chunk"):
        t_ckpt.CheckpointedBatchRunner(str(ckdir), chunk_size).run(ocp,
                                                                   *args)
    calls = counted_solve_batch(t_ckpt, monkeypatch)
    same = t_ckpt.CheckpointedBatchRunner(str(ckdir), chunk_size=2)
    again = same.run(ocp, u0, x0b, cfg)
    assert calls == []
    assert torch.equal(again.controls, sol.controls)
    assert torch.equal(again.iterations, sol.iterations)


def test_checkpoint_backfills_old_manifest(solved_campaign, tmp_path,
                                          monkeypatch):
    """A manifest written before the identity grew its semantics keys
    (cfg digest, method, dtype) still resumes, and gets them back-filled;
    the JAX runner then resumes it too, solving nothing."""
    path, ocp, u0, x0b, cfg, sol = solved_campaign
    ckdir = tmp_path / "old"
    shutil.copytree(path, ckdir)
    manifest = json.loads((ckdir / "manifest.json").read_text())
    full = dict(manifest["identity"])
    manifest["identity"] = {k: full[k]
                            for k in ("chunk_size", "n", "horizon", "nu")}
    (ckdir / "manifest.json").write_text(json.dumps(manifest))
    calls = counted_solve_batch(t_ckpt, monkeypatch)
    again = t_ckpt.CheckpointedBatchRunner(str(ckdir), 2).run(
        ocp, u0, x0b, cfg)
    assert calls == []
    assert torch.equal(again.controls, sol.controls)
    assert json.loads((ckdir / "manifest.json").read_text())[
        "identity"] == full
    assert full["dtype"] == "float64" and full["method"] == "par"

    j_calls = counted_solve_batch(j_ckpt, monkeypatch)
    j_sol = j_ckpt.CheckpointedBatchRunner(str(ckdir), 2).run(
        j_pendulum.make_ocp(0.05), jnp.asarray(u0.numpy()),
        jnp.asarray(x0b.numpy()),
        ipoc_tpu.FAST_CONFIG.replace(max_newton_iters=30))
    assert j_calls == []
    np.testing.assert_array_equal(np.asarray(j_sol.controls),
                                  sol.controls.numpy())


# ---------------------------------------------------------------------------
# Campaign directories across the two packages
# ---------------------------------------------------------------------------

CROSS_N, CROSS_T, CROSS_CHUNK = 6, 15, 2


class Package(NamedTuple):
    name: str
    module: object      # the package's solvers.checkpoint
    ocp: object
    inputs: tuple       # (u0, x0b) in the package's array type
    cfg: object


@pytest.fixture(scope="module")
def packages():
    u0, x0b = scenarios(5, CROSS_N, CROSS_T)
    jax_side = Package("jax", j_ckpt, j_pendulum.make_ocp(0.05),
                       (jnp.asarray(u0), jnp.asarray(x0b)),
                       ipoc_tpu.DEFAULT_CONFIG)
    port_side = Package("port", t_ckpt, pendulum.make_ocp(0.05),
                        tensors(u0, x0b), ipoc_tpu_torch.DEFAULT_CONFIG)
    # The campaign identity holds a digest of repr(cfg): the two packages'
    # configs must print alike.
    assert repr(jax_side.cfg) == repr(port_side.cfg)
    return {"jax": jax_side, "port": port_side}


@pytest.fixture(scope="module")
def jax_uninterrupted(packages, tmp_path_factory):
    """JAX's runner on the whole campaign, in one run."""
    p = packages["jax"]
    sol = j_ckpt.CheckpointedBatchRunner(
        str(tmp_path_factory.mktemp("jax_whole")), CROSS_CHUNK).run(
        p.ocp, *p.inputs, p.cfg)
    return np.asarray(sol.controls), np.asarray(sol.iterations)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resumes_across_packages(packages, jax_uninterrupted,
                                            tmp_path, monkeypatch, first,
                                            second):
    """One package's runner solves chunk 0 of the campaign and is
    interrupted; the other's resumes the directory, solving only chunks 1
    and 2, and returns JAX's uninterrupted result (equal iterations,
    controls within 1e-8).  The resuming package still refuses the
    directory under another cfg, method or dtype."""
    a, b = packages[first], packages[second]
    ckdir = str(tmp_path / "campaign")
    calls_a = counted_solve_batch(a.module, monkeypatch, stop_after=1)
    with pytest.raises(Interrupted):
        a.module.CheckpointedBatchRunner(ckdir, CROSS_CHUNK).run(
            a.ocp, *a.inputs, a.cfg)
    assert calls_a == [CROSS_CHUNK]
    manifest = json.loads(open(os.path.join(ckdir, "manifest.json")).read())
    assert manifest["chunks_done"] == [0]
    assert manifest["identity"]["dtype"] == "float64"

    u, x = b.inputs
    for kwargs in ({"cfg": b.cfg.replace(tol=1e-6)},
                   {"cfg": b.cfg, "method": "seq"}):
        with pytest.raises(ValueError, match="chunk"):
            b.module.CheckpointedBatchRunner(ckdir, CROSS_CHUNK).run(
                b.ocp, u, x, **kwargs)
    low = ((u.float(), x.float()) if b.name == "port"
           else (u.astype(jnp.float32), x.astype(jnp.float32)))
    with pytest.raises(ValueError, match="chunk"):
        b.module.CheckpointedBatchRunner(ckdir, CROSS_CHUNK).run(
            b.ocp, *low, b.cfg)

    calls_b = counted_solve_batch(b.module, monkeypatch)
    sol = b.module.CheckpointedBatchRunner(ckdir, CROSS_CHUNK).run(
        b.ocp, u, x, b.cfg)
    assert calls_b == [CROSS_CHUNK, CROSS_CHUNK]
    controls, iterations = jax_uninterrupted
    got_u, got_it = (np.asarray(v) if b.name == "jax"
                     else v.numpy() for v in sol)
    np.testing.assert_array_equal(got_it, iterations)
    np.testing.assert_allclose(got_u, controls, rtol=0, atol=1e-8)
    if b.name == "port":
        assert sol.iterations.dtype == torch.int32


def test_checkpoint_dtype_under_numpy_name():
    assert t_ckpt.dtype_name(torch.float32) == "float32"
    assert t_ckpt.dtype_name(torch.float64) == str(
        jnp.result_type(jnp.zeros(1, jnp.float64)))


# ---------------------------------------------------------------------------
# Timing and profiling
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_time_fn_protocol():
    """``warmup`` untimed calls, then ``reps`` timed ones; returns
    ``(mean_s, median_s, times)``."""
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    out = timing.time_fn(fn, torch.ones(3), reps=3, warmup=2)
    mean_s, median_s, times = out
    assert len(out) == 3 and len(times) == 3 and len(calls) == 5
    assert all(t >= 0 for t in times)
    assert mean_s == pytest.approx(sum(times) / 3)
    assert median_s == sorted(times)[1]


def test_sync_named_tuple():
    """``sync`` returns the tree as numpy, its NamedTuples kept."""
    tree = (Pair(torch.arange(3), torch.ones(2, dtype=F64)), torch.zeros(1))
    out = timing.sync(tree)
    assert isinstance(out, tuple) and isinstance(out[0], Pair)
    assert isinstance(out[0].a, np.ndarray) and out[0].a.tolist() == [0, 1, 2]
    assert out[0].b.dtype == np.float64 and isinstance(out[1], np.ndarray)


def test_sync_list_and_dict():
    """``sync`` takes any container of results, lists and dicts too, and
    returns it as numpy."""
    out = timing.sync([torch.arange(2), {"u": torch.ones(1, dtype=F64)}])
    assert isinstance(out, list) and isinstance(out[0], np.ndarray)
    assert isinstance(out[1], dict) and out[1]["u"].dtype == np.float64


def test_trace_writes_annotated_chrome_trace(tmp_path):
    """A CPU trace: one Chrome trace file in ``logdir`` holding the
    ``annotate`` span, and no device activity on a machine without one."""
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as d:
        assert d == logdir
        with profiling.annotate("ipoc_span"):
            torch.ones(8).cumsum(0)
    (name,) = os.listdir(logdir)
    assert name.endswith(".json")
    events = json.load(open(os.path.join(logdir, name)))["traceEvents"]
    spans = [e for e in events if e.get("name") == "ipoc_span"]
    assert spans and spans[0]["cat"] == "user_annotation"
    if not torch.cuda.is_available():
        assert not any(e.get("cat") in ("kernel", "gpu_memcpy")
                       for e in events)
