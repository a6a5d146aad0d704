"""Linear MPC loop on the PyTorch port: parallel vs sequential LQT passes
(counterpart of examples/linear_mpc.py).

Reference examples/linear_mpc_parallel.py semantics: a double integrator,
RK4 dt=0.001, LQT horizon T=5, 5000 receding-horizon steps, Q=diag(100,1),
R=0.1, x0=[2,1]; each MPC step re-solves the LQT and applies u[0]
(``ipoc_tpu_torch.mpc.lqt_mpc_loop``, a Python loop over the steps; on a
card the parallel passes run the value-scan and affine-scan kernels).
Times par vs seq full-loop wall clock.

Usage: python examples/torch_linear_mpc.py [--steps 5000] [--reps 5] [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from ipoc_tpu_torch.interop import pick_device
from ipoc_tpu_torch.models import double_integrator
from ipoc_tpu_torch.mpc import lqt_mpc_loop
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.parallel.lqt import LQT
from ipoc_tpu_torch.utils.integrators import discretize_dynamics
from ipoc_tpu_torch.utils.timing import sync, time_fn


def build_lqt(T=5, dt=1e-3, dtype=torch.float32, device=None) -> LQT:
    """The reference's LQT as the port's batch-first LQT of one lane: the
    double integrator's RK4 step linearized at the origin, tiled over T."""
    dynamics = discretize_dynamics(double_integrator.ode, dt, 1)
    kw = dict(dtype=dtype, device=device)
    x_lin, u_lin = torch.zeros(2, **kw), torch.zeros(1, **kw)
    A = torch.func.jacfwd(dynamics, 0)(x_lin, u_lin)
    B = torch.func.jacfwd(dynamics, 1)(x_lin, u_lin)
    nx, nu = 2, 1
    Q = torch.diag(torch.tensor([1e2, 1e0], **kw))
    R = 1e-1 * torch.eye(nu, **kw)

    def tile(M):
        return M.expand((1, T) + M.shape).contiguous()

    def zeros(*shape):
        return torch.zeros((1,) + shape, **kw)

    return LQT(
        A=tile(A), B=tile(B), c=zeros(T, nx),
        XT=Q[None], HT=torch.eye(nx, **kw)[None], rT=zeros(nx),
        X=tile(Q), H=tile(torch.eye(nx, **kw)), r=zeros(T, nx),
        U=tile(R), Z=tile(torch.eye(nu, **kw)), s=zeros(T, nu),
        M=zeros(T, nx, nu),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", default="",
                   help="also write the result to this file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    args = p.parse_args(argv)
    device, dtype = pick_device(args.device), getattr(torch, args.dtype)

    n_steps, reps = args.steps, args.reps
    lqt = build_lqt(dtype=dtype, device=device)
    x0 = torch.tensor([[2.0, 1.0]], dtype=dtype, device=device)

    result = {
        "metric": f"linear_mpc_{n_steps}_step_loop",
        "protocol": "reference examples/linear_mpc_parallel.py:86-100 "
                    f"(T=5, dt=0.001, {n_steps} receding-horizon LQT "
                    "re-solves, a Python loop over the steps); "
                    "torch.cuda.synchronize + host copy after each loop, 1 "
                    f"warmup + median of {reps} reps",
        "n_steps": n_steps,
        "device": str(device), "dtype": args.dtype,
    }
    for mode in ("par", "seq"):
        def loop(x, m=mode):
            return lqt_mpc_loop(lqt, x, n_steps, mode=m)

        cuda.reset_launches()
        xs, us = sync(loop(x0))  # warmup + result for quality stats
        launched = {k: v for k, v in cuda.launches.items() if v}
        mean_s, dt, _ = time_fn(loop, x0, reps=reps, warmup=0)
        final = xs[-1, 0]
        norm = float((final.astype("float64") ** 2).sum() ** 0.5)
        result[mode] = {
            "loop_s_median": dt,
            "loop_s_mean": mean_s,
            "steps_per_sec": n_steps / dt,
            "final_state_norm": norm,
            "final_state": final.tolist(),
        }
        if device.type == "cuda":  # the kernels one loop launched
            result[mode]["launches"] = launched
        print(f"{mode}: {dt:.3f}s for {n_steps} MPC steps "
              f"({n_steps / dt:.0f} steps/s); final |x| = {norm:.2e}")
    result["par_speedup_vs_seq"] = (
        result["seq"]["loop_s_median"] / result["par"]["loop_s_median"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
