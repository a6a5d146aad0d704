"""The port's examples (``examples/torch_*.py``) on the CPU in float64,
each held to the JAX functions on the same inputs, at tiny sizes; and
each refusing to run on the CPU unless asked to."""

import csv
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import double_integrator as j_double_integrator
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.mpc import lqt_mpc_loop, nmpc_loop

torch.set_num_threads(1)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
CPU64 = ["--device", "cpu", "--dtype", "float64"]
NAMES = ("linear_demo", "runtime_benchmark", "sweep_agreement",
         "nonlinear_mpc", "linear_mpc", "p50_budget")


def example(name):
    """The module of ``examples/torch_<name>.py``; for ``"jax:<name>"``,
    of the JAX script ``examples/<name>.py``."""
    stem = (name.removeprefix("jax:") if name.startswith("jax:")
            else f"torch_{name}")
    spec = importlib.util.spec_from_file_location(
        f"_example_{stem}", os.path.join(EXAMPLES, f"{stem}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_cpu_by_default(name, tmp_path):
    """Without ``--device cpu`` an example asks for the card and raises
    where there is none, before any work: it never falls back."""
    with pytest.raises(RuntimeError, match="--device cpu"):
        example(name).main(["--outdir", str(tmp_path)]
                           if name in ("runtime_benchmark",
                                       "sweep_agreement") else [])


def test_linear_demo_matches_jax():
    out = example("linear_demo").main(CPU64)
    ocp = j_double_integrator.make_ocp(0.1)
    solve = ipoc_tpu.par_interior_point_optimal_control
    u, iters = jax.jit(lambda u, x: solve(ocp, u, x))(
        jnp.zeros((40, 1)), jnp.array([2.0, 1.0]))
    assert out["iterations"] == int(iters)
    np.testing.assert_allclose(out["u"], np.asarray(u).ravel(), rtol=0,
                               atol=1e-8)
    assert np.abs(out["final_state"]).max() < 1e-2


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """torch_runtime_benchmark.py's pendulum H=20 sweep of par and seq,
    float64 on the CPU, with its controls saved."""
    outdir = str(tmp_path_factory.mktemp("sweep"))
    records = example("runtime_benchmark").main(
        ["--model", "pendulum", "--horizons", "20", "--solvers", "par,seq",
         "--reps", "1", "--save-controls", "--outdir", outdir] + CPU64)
    return outdir, records


def test_runtime_benchmark_matches_jax(sweep):
    """The sweep's records, CSVs, JSONL and npz, with JAX's solvers'
    iterations on the same warm start."""
    outdir, records = sweep
    module = example("runtime_benchmark")
    u0 = module.warm_start("pendulum", 20, torch.float64, "cpu").numpy()
    ocp = j_pendulum.make_ocp(1.0 / 20)
    x0 = j_pendulum.initial_state(jnp.float64)
    solvers = {"par": ipoc_tpu.par_interior_point_optimal_control,
               "seq": ipoc_tpu.seq_interior_point_optimal_control}
    assert [r["solver"] for r in records] == ["par", "seq"]
    saved = np.load(os.path.join(outdir, "pendulum_controls_float64.npz"))
    assert sorted(saved.files) == ["par_h20", "seq_h20"]
    for rec in records:
        u, iters = jax.jit(lambda u, x, s=solvers[rec["solver"]]: s(
            ocp, u, x, ipoc_tpu.DEFAULT_CONFIG))(jnp.asarray(u0), x0)
        assert rec["iterations"] == int(iters), rec
        np.testing.assert_allclose(saved[f"{rec['solver']}_h20"],
                                   np.asarray(u), rtol=0, atol=1e-8)
        assert rec["horizon"] == 20 and rec["dt"] == 0.05
        assert 0 < rec["median_s"] and 0 < rec["mean_s"]
    lines = [json.loads(line) for line in
             open(os.path.join(outdir, "pendulum_runtime.jsonl"))]
    assert [{k: v for k, v in rec.items() if k != "ts"}
            for rec in lines] == records
    for name in ("par", "seq"):
        rows = list(csv.reader(open(
            os.path.join(outdir, f"pendulum_ip_{name}.csv"))))
        assert rows[0] == ["horizon", "mean_s", "median_s"]
        assert len(rows) == 2 and rows[1][0] == "20"


def test_sweep_agreement_gates_pass(tmp_path, monkeypatch):
    """torch_sweep_agreement.py and JAX's examples/sweep_agreement.py on
    the same float32 npz (torch_runtime_benchmark.py's pendulum H=20 sweep
    of par and seq, float32 on the CPU): every record's gates pass, and
    each key equals JAX's record.  Each script solves its float64 reference
    from its own warm start (numpy's draw, ``jax.random``'s), and both
    reach the same optimum: controls within 1e-8."""
    outdir, j_outdir = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(j_outdir)
    example("runtime_benchmark").main(
        ["--model", "pendulum", "--horizons", "20", "--solvers", "par,seq",
         "--reps", "1", "--save-controls", "--outdir", outdir, "--device",
         "cpu", "--dtype", "float32"])
    npz = os.path.join(outdir, "pendulum_controls_float32.npz")
    assert np.load(npz)["par_h20"].dtype == np.float32
    records = example("sweep_agreement").main(
        ["--model", "pendulum", "--outdir", outdir, "--f32-npz", npz,
         "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [
        "sweep_agreement.py", "--model", "pendulum", "--outdir", j_outdir,
        "--f32-npz", npz])
    with pytest.raises(SystemExit) as exited:
        example("jax:sweep_agreement").main()
    assert exited.value.code == 0
    j_records = [json.loads(line) for line in
                 open(os.path.join(j_outdir, "pendulum_agreement.jsonl"))]
    assert [json.loads(line) for line in open(os.path.join(
        outdir, "pendulum_agreement.jsonl"))] == records
    assert [r["solver"] for r in records] == ["par", "seq"]
    for rec, j_rec in zip(records, j_records, strict=True):
        assert rec["pass"] and j_rec["pass"], (rec, j_rec)
        assert rec["bound_active_stages"] > 0
        assert list(rec) == list(j_rec)
        for key in ("model", "solver", "horizon", "bound_active_stages",
                    "switch_shift_stages", "pass"):
            assert rec[key] == j_rec[key], key
        # the float32 controls are shared: a float64 optimum within 1e-8
        # moves each deviation by at most that, and each cost by its square
        for key in ("max_abs_du", "max_abs_dx", "bound_active_du",
                    "bound_active_du_max"):
            assert rec[key] == pytest.approx(j_rec[key], rel=0, abs=1e-8), key
        for key in ("cost_f32", "cost_f64"):
            assert rec[key] == pytest.approx(j_rec[key], rel=1e-12), key
        assert rec["rel_cost_delta"] == pytest.approx(
            j_rec["rel_cost_delta"], rel=0, abs=1e-12)


def test_nonlinear_mpc_matches_jax():
    """Three closed-loop steps of one controller at H=20: the port's states
    and controls within 1e-8 of JAX's ``nmpc_loop`` on the same solve."""
    out = example("nonlinear_mpc").main(["--steps", "3", "--horizon", "20"]
                                        + CPU64)
    ocp = j_pendulum.make_ocp(0.02)
    cfg = ipoc_tpu.BATCH_CONFIG.replace(max_newton_iters=25)

    def solve(u, x):
        return ipoc_tpu.par_interior_point_optimal_control(ocp, u, x, cfg)[0]

    xs, us = jax.jit(lambda x, u: nmpc_loop(solve, ocp.dynamics, x, u, 3))(
        j_pendulum.initial_state(jnp.float64), jnp.zeros((20, 1)))
    np.testing.assert_allclose(out["states"], np.asarray(xs), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out["controls"], np.asarray(us), rtol=0,
                               atol=1e-8)
    assert out["finite"] and out["max_abs_u"] <= 5.0


def test_linear_mpc_matches_jax():
    """``build_lqt`` equal to the JAX example's to 1e-12; 50 steps of the
    loop, par and seq, within 1e-10 of JAX's ``lqt_mpc_loop``."""
    j_lqt = example("jax:linear_mpc").build_lqt(dtype=jnp.float64)
    t_lqt = example("linear_mpc").build_lqt(dtype=torch.float64)
    for field, j in zip(j_lqt._fields, j_lqt):
        t = getattr(t_lqt, field)
        assert t.shape == (1,) + j.shape, field
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12, err_msg=field)
    out = example("linear_mpc").main(["--steps", "50", "--reps", "1"]
                                     + CPU64)
    assert out["metric"] == "linear_mpc_50_step_loop"
    for mode in ("par", "seq"):
        xs, _ = jax.jit(lambda x, m=mode: lqt_mpc_loop(j_lqt, x, 50, m))(
            jnp.array([2.0, 1.0]))
        np.testing.assert_allclose(out[mode]["final_state"],
                                   np.asarray(xs[-1]), rtol=0, atol=1e-10)
        assert out[mode]["final_state_norm"] == pytest.approx(
            float(jnp.linalg.norm(xs[-1])), abs=1e-10)


def test_p50_budget_single_config_matches_jax_keys():
    """``single_config`` on BASELINE config 2 (pendulum H=100 par) at reps
    1: JAX's keys and budgets.  JAX's row comes from its ``single_config``
    around a solver that returns its warm start; the port's solves, its
    iterations capped at 2 and one solve a chain, to stay small."""
    module = example("p50_budget")
    (name, ocp, u0, x0, solver, cfg, H, dt) = module.single_configs(
        torch.float64, torch.device("cpu"))[1]
    assert (name, H, dt) == ("pendulum H=100 par", 100, 0.01)
    row = module.single_config(name, ocp, u0, x0, solver,
                               cfg.replace(max_newton_iters=2), H, dt, 1,
                               K=1)
    j_row = example("jax:p50_budget").single_config(
        name, j_pendulum.make_ocp(dt), jnp.asarray(u0.numpy()),
        jnp.asarray(x0.numpy()), lambda ocp, u, x, cfg: (u, 0),
        ipoc_tpu.FAST_CONFIG, H, dt, 1, K=1)
    assert list(row) == list(j_row)
    for key in ("config", "horizon", "dt", "budget_h_dt_s",
                "budget_replan_s"):
        assert row[key] == j_row[key], key
    assert row["p50_call_s"] > 0 and row["p50_chip_s"] > 0
    assert row["within_h_dt"] == (row["p50_chip_s"] <= H * dt)
