"""p50 solve latency vs real-time budget for the five BASELINE configs on
the PyTorch port (counterpart of examples/p50_budget.py).

BASELINE.json's metric is "solves/s/chip at H=100 cartpole; p50 solve
latency vs real-time budget".  This script measures the p50 (median)
latency of each of the five BASELINE configs and compares it against the
per-solve real-time budget H*dt (and, for the MPC-flavored configs, the
replan period dt — the budget that matters for a receding-horizon loop).

Two latency columns per single-solve config:

* ``p50_call_s`` — the call's latency (reference protocol: 1 warmup + N
  reps, each waiting for the device).
* ``p50_chip_s`` — K solves run back to back, each warm start carrying a
  negligible data-dependent epsilon of the previous solve, one sync at the
  end, / K (``torch_runtime_benchmark.py --amortize``).  On a card these
  solves are host-paced (each reads its convergence tests back), so the two
  columns stay close.

Configs 4 and 5 drain a pool through ``solve_stream_multigrid`` (coarsen 4,
4096 lanes, refill every 16): 4096 scenarios, then ``--pool`` (BASELINE's
65k) on one card.  ``platform`` in the JSON is the device's name.

Usage: python examples/torch_p50_budget.py [--reps 10] [--out bench_results/p50_budget.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

EXAMPLES = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(EXAMPLES), EXAMPLES]

import numpy as np
import torch

import ipoc_tpu_torch
from ipoc_tpu_torch.interop import pick_device
from ipoc_tpu_torch.models import cartpole, double_integrator, pendulum
from ipoc_tpu_torch.solvers.batched import make_batch
from ipoc_tpu_torch.solvers.stream import solve_stream_multigrid
from ipoc_tpu_torch.utils.timing import sync
from torch_runtime_benchmark import chained

BATCH = 4096


def p50(fn, *args, reps):
    sync(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def single_config(name, model_ocp, u0, x0, solver, cfg, H, dt, reps, K=8):
    call = p50(lambda u, x: solver(model_ocp, u, x, cfg)[0], u0, x0,
               reps=reps)
    chip = p50(chained(solver, model_ocp, cfg, K), u0, x0,
               reps=max(3, reps // 3)) / K
    return {
        "config": name,
        "horizon": H,
        "dt": dt,
        "p50_call_s": round(call, 6),
        "p50_chip_s": round(chip, 6),
        "budget_h_dt_s": H * dt,
        "budget_replan_s": dt,
        "within_h_dt": bool(chip <= H * dt),
        "within_replan": bool(chip <= dt),
    }


def single_configs(dtype, device):
    """BASELINE configs 1-3: ``(name, ocp, u0, x0, solver, cfg, H, dt)``."""
    def noise(H):
        z = np.random.default_rng(1).standard_normal((H, 1))
        return torch.as_tensor(0.1 * z, dtype=dtype, device=device)

    fast = ipoc_tpu_torch.FAST_CONFIG
    par = ipoc_tpu_torch.par_interior_point_optimal_control
    H, dt = 60, 0.001
    # 1. Linear MPC analog: double integrator, H=60, sequential IP Newton
    #    (reference linear_mpc_parallel.py:24-81 uses dt=0.001 — the
    #    budget is the replan period), its initial state [2, 1].
    rows = [("linear-mpc double-integrator H=60 seq",
             double_integrator.make_ocp(dt),
             torch.zeros((H, 1), dtype=dtype, device=device),
             torch.tensor([2.0, 1.0], dtype=dtype, device=device),
             ipoc_tpu_torch.seq_interior_point_optimal_control, fast, H, dt)]
    H, dt = 100, 0.01
    # 2. Constrained pendulum swing-up H=100, parallel-scan IP Newton.
    rows.append(("pendulum H=100 par", pendulum.make_ocp(dt), noise(H),
                 pendulum.initial_state(dtype).to(device), par, fast, H, dt))
    # 3. Cartpole H=100, parallel IP, input+STATE constraints (the cart
    #    box; BASELINE config 3).
    rows.append(("cartpole H=100 par input+state",
                 cartpole.make_ocp(dt, cart_limit=0.3), noise(H),
                 cartpole.initial_state(dtype).to(device), par, fast, H, dt))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="bench_results/p50_budget.json")
    ap.add_argument("--pool", type=int, default=65536,
                    help="config-5 scenario pool (BASELINE: 65k)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    args = ap.parse_args(argv)
    device, dtype = pick_device(args.device), getattr(torch, args.dtype)
    reps = args.reps

    rows = [single_config(*c, reps) for c in single_configs(dtype, device)]

    # 4. Batched cartpole: 4096 scenarios on one card (the multigrid
    #    stream, the headline executor).  p50 = whole-batch latency;
    #    per-solve is amortized across the batch.
    H, dt = 100, 0.01
    ocp = cartpole.make_ocp(dt)
    ocp_c = cartpole.make_ocp(dt * 4)
    x0 = cartpole.initial_state(dtype)
    u0b, x0b = (a.to(device) for a in make_batch(
        torch.Generator().manual_seed(1), x0, BATCH, H, 1, state_scale=0.01,
        control_scale=0.1, dtype=dtype))
    cfg = ipoc_tpu_torch.BATCH_CONFIG

    def step(u, x):
        return solve_stream_multigrid(ocp, ocp_c, 4, u, x, cfg, lanes=BATCH,
                                      refill_every=16).iterations

    t = p50(step, u0b, x0b, reps=max(3, reps // 2))
    rows.append({
        "config": f"batched cartpole {BATCH} scenarios (mg stream)",
        "horizon": H, "dt": dt,
        "p50_batch_s": round(t, 6),
        "p50_chip_s": round(t / BATCH, 9),
        "budget_h_dt_s": H * dt, "budget_replan_s": dt,
        "within_h_dt": bool(t / BATCH <= H * dt),
        "within_replan": bool(t / BATCH <= dt),
        "note": "p50_chip_s is batch-amortized per solve",
    })

    # 5. Pool scale: the pool drained on ONE card (BASELINE shards it over
    #    a multi-host slice; streams are embarrassingly parallel,
    #    solve_stream_multigrid_sharded).
    N = args.pool
    tiles = max(1, N // BATCH)
    u0N = u0b.repeat(tiles, 1, 1)[:N]
    x0N = x0b.repeat(tiles, 1)[:N]
    t = p50(step, u0N, x0N, reps=3)
    rows.append({
        "config": f"pool {N} scenarios (one card)",
        "horizon": H, "dt": dt,
        "p50_pool_s": round(t, 6),
        "p50_chip_s": round(t / N, 9),
        "solves_per_sec": round(N / t, 1),
        "budget_h_dt_s": H * dt, "budget_replan_s": dt,
        "within_h_dt": bool(t / N <= H * dt),
        "within_replan": bool(t / N <= dt),
        "note": "pool-amortized per solve; one card",
    })

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    platform = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    payload = {"platform": platform, "dtype": args.dtype, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    for r in rows:
        print(json.dumps(r))
    print(f"wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
