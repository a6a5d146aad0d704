"""Warm-started nonlinear MPC on the PyTorch port: amortized interior-point
resolves (counterpart of examples/nonlinear_mpc.py).

The throughput story for deployment: a receding-horizon controller re-solves
the IP problem from the previous plan every step, so per-step Newton
iteration counts collapse versus cold starts.  The closed loop is
``ipoc_tpu_torch.mpc``'s Python loop over the steps, on the device of its
inputs.

One controller runs ``par_interior_point_optimal_control`` under
``BATCH_CONFIG``, whose Newton step is the fused sequential one (on a card
the fused sweeps' kernels), as the JAX script's does.  ``--batch B`` runs B
independent controllers in lockstep: from 1024 controllers on, the replan
step is the packed batch resolver on the mega kernel (``solve_batch_packed``
with k-blocks of 8), the first resolve cold, the later ones re-entering the
barrier at 0.02 from each controller's own plan
(``nmpc_loop_batched_warm``; the JAX script takes that path where its
packed gate passes, and the port has no such gate); fewer controllers run
``solve_batch`` under the same configuration on every lane.

Usage: python examples/torch_nonlinear_mpc.py [--steps 50] [--batch 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import ipoc_tpu_torch
from ipoc_tpu_torch.interop import pick_device
from ipoc_tpu_torch.models import pendulum
from ipoc_tpu_torch.mpc import (
    nmpc_loop,
    nmpc_loop_batched,
    nmpc_loop_batched_warm,
)
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.solvers.packed_stream import solve_batch_packed
from ipoc_tpu_torch.utils.timing import sync

PACKED_MIN_BATCH = 1024


def finite(*arrays) -> bool:
    return all(bool(np.isfinite(a).all()) for a in arrays)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--horizon", type=int, default=40)
    p.add_argument("--batch", type=int, default=1,
                   help=">1: B independent closed-loop controllers in "
                   "lockstep")
    p.add_argument("--dt", type=float, default=0.02,
                   help="the time step (a card builds the model's kernels "
                   "once per time step)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    args = p.parse_args(argv)
    device, dtype = pick_device(args.device), getattr(torch, args.dtype)

    ocp = pendulum.make_ocp(args.dt)
    # Warm-started resolves converge in a handful of iterations; cap tightly.
    cfg = ipoc_tpu_torch.BATCH_CONFIG.replace(max_newton_iters=25)

    def solve(u_warm, x):
        u, _ = ipoc_tpu_torch.par_interior_point_optimal_control(
            ocp, u_warm, x, cfg)
        return u

    x0 = pendulum.initial_state(dtype).to(device)
    out = {"steps": args.steps, "horizon": args.horizon, "dt": args.dt,
           "batch": args.batch, "device": str(device), "dtype": args.dtype}

    if args.batch > 1:
        # B independent closed-loop controllers stepping in lockstep.
        noise = np.random.default_rng(0).standard_normal(
            (args.batch, x0.shape[0]))
        x0b = x0[None, :] + torch.as_tensor(0.05 * noise, dtype=dtype,
                                            device=device)
        u0b = torch.zeros((args.batch, args.horizon, 1), dtype=dtype,
                          device=device)
        if args.batch >= PACKED_MIN_BATCH:
            wcfg = ipoc_tpu_torch.BATCH_CONFIG.replace(max_newton_iters=12)

            def solve_full(u_warm, x):
                u, _ = solve_batch_packed(ocp, u_warm, x,
                                          ipoc_tpu_torch.BATCH_CONFIG,
                                          k_block=8)
                return u

            def solve_warm(u_warm, x):
                u, _ = solve_batch_packed(ocp, u_warm, x, wcfg, k_block=8,
                                          bp_entry=0.02)
                return u

            def loop(x, u):
                return nmpc_loop_batched_warm(solve_full, solve_warm,
                                              ocp.dynamics, x, u, args.steps)
            out["resolver"] = "solve_batch_packed (warm re-entry at 0.02)"
        else:
            def solve_lanes(u_warm, x):
                return ipoc_tpu_torch.solve_batch(ocp, u_warm, x, cfg).controls

            def loop(x, u):
                return nmpc_loop_batched(solve_lanes, ocp.dynamics, x, u,
                                         args.steps)
            out["resolver"] = "solve_batch (fused)"
        sync(loop(x0b, u0b))  # the first call loads the kernels
        cuda.reset_launches()
        t0 = time.perf_counter()
        xs, us = sync(loop(x0b, u0b))
        wall = time.perf_counter() - t0
        # the batched layout is (steps, B, ...); report (B, steps, ...)
        xs, us = np.swapaxes(xs, 0, 1), np.swapaxes(us, 0, 1)
        n_resolves = args.batch * args.steps
        out.update(wall_s=wall, resolves_per_s=n_resolves / wall,
                   max_abs_u=float(np.abs(us).max()),
                   mean_final_abs_theta=float(np.abs(xs[:, -1, 0]).mean()),
                   finite=finite(xs, us))
        print(f"{args.batch} controllers x {args.steps} MPC steps in "
              f"{wall:.3f}s ({n_resolves / wall:.0f} warm-started "
              "resolves/s)")
        print("max |u|:", out["max_abs_u"], "(bound 5)")
        print("mean final |theta|:", out["mean_final_abs_theta"])
    else:
        u_init = torch.zeros((args.horizon, 1), dtype=dtype, device=device)
        sync(nmpc_loop(solve, ocp.dynamics, x0, u_init, args.steps))
        cuda.reset_launches()
        t0 = time.perf_counter()
        xs, us = sync(nmpc_loop(solve, ocp.dynamics, x0, u_init, args.steps))
        wall = time.perf_counter() - t0
        out.update(wall_s=wall, resolves_per_s=args.steps / wall,
                   ms_per_step=wall / args.steps * 1e3,
                   budget_ms_per_step=args.dt * 1e3,
                   max_abs_u=float(np.abs(us).max()),
                   final_state=xs[-1].tolist(),
                   finite=finite(xs, us))
        print(f"{args.steps} MPC steps in {wall:.3f}s "
              f"({args.steps / wall:.1f} resolves/s); "
              f"real-time budget per step: {args.dt * 1e3:.0f} ms, "
              f"actual: {wall / args.steps * 1e3:.2f} ms")
        print("max |u|:", out["max_abs_u"], "(bound 5)")
        print("final state:", xs[-1])
    if device.type == "cuda":  # the kernels the timed loop launched
        out["launches"] = {k: v for k, v in cuda.launches.items() if v}
    print(json.dumps(out))
    out.update(states=xs, controls=us)
    return out


if __name__ == "__main__":
    main()
