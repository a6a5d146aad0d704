"""Cross-precision agreement check for the (dt, H) runtime sweep on the
PyTorch port (counterpart of examples/sweep_agreement.py).

Loads the converged float32 controls saved by
``torch_runtime_benchmark.py --save-controls`` and, for each (solver,
horizon) configuration, solves the same problem in float64, then reports:

* ``rel_cost_delta`` — |J(u_f32) - J(u_f64)| / |J(u_f64)| at the final
  barrier stage, evaluated in float64.  The sharp agreement gate (default
  1e-5): both precisions must land on the same optimum.
* ``max_abs_du`` — control-space deviation.  Reported, not gated: with
  gradient tolerance 1e-4 and control curvature ~R = 1e-3, the flat valley
  admits ~1e-1 control slack.
* ``max_abs_dx`` — state-trajectory deviation: both precisions' converged
  controls rolled through the float64 dynamics.  GATED (--dx-atol).
* ``bound_active_du`` — the p95 control deviation over bound-active stages
  (|u_f64| within --active-frac of the bound).  GATED (--bound-du-rtol,
  relative to the bound).  The max over active stages is reported ungated
  (``bound_active_du_max``) with ``switch_shift_stages`` (count with
  deviation > 1% of the bound): a sub-dt shift of a switching time moves
  the few stages at the arc edges by O(bound).

The float64 reference is solved on ``--device``: JAX's script forces its
CPU because a TPU lacks float64 LU; ``--device cpu`` gives that setting,
and a card solves float64 natively.

Usage (after the float32 sweep on the card):

    python examples/torch_runtime_benchmark.py --model pendulum --save-controls
    python examples/torch_sweep_agreement.py --model pendulum --device cpu

Writes ``{outdir}/{model}_agreement.jsonl`` and exits nonzero if any
configuration misses a gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXAMPLES = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(EXAMPLES), EXAMPLES]

import numpy as np
import torch

import ipoc_tpu_torch
from ipoc_tpu_torch.interop import pick_device
from ipoc_tpu_torch.models import cartpole, pendulum, quadrotor
from ipoc_tpu_torch.utils.integrators import rollout
from torch_runtime_benchmark import warm_start

FINAL_BP = 0.1 / 5.0**4
MODELS = {"pendulum": pendulum, "cartpole": cartpole, "quadrotor": quadrotor}
SOLVERS = {
    "par": ipoc_tpu_torch.par_interior_point_optimal_control,
    "seq": ipoc_tpu_torch.seq_interior_point_optimal_control,
    "ddp": ipoc_tpu_torch.interior_point_ddp,
}
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=list(MODELS), default="pendulum")
    p.add_argument("--outdir", default="bench_results")
    p.add_argument("--cost-rtol", type=float, default=1e-5)
    p.add_argument("--dx-atol", type=float, default=2e-2,
                   help="gate on max state-trajectory deviation")
    p.add_argument("--bound-du-rtol", type=float, default=1e-3,
                   help="gate on bound-active control deviation, relative "
                   "to the control bound")
    p.add_argument("--active-frac", type=float, default=1e-3,
                   help="a stage is bound-active when |u_f64| >= "
                   "(1 - active_frac) * bound")
    p.add_argument("--f32-npz", default=None,
                   help="controls npz (default "
                   "{outdir}/{model}_controls_float32.npz)")
    p.add_argument("--device", default="cuda",
                   help="where the float64 reference is solved")
    args = p.parse_args(argv)
    device = pick_device(args.device)
    f64 = torch.float64

    model = MODELS[args.model]
    npz_path = args.f32_npz or os.path.join(
        args.outdir, f"{args.model}_controls_float32.npz")
    data = np.load(npz_path)
    cfg = ipoc_tpu_torch.DEFAULT_CONFIG
    out_path = os.path.join(args.outdir, f"{args.model}_agreement.jsonl")
    failures, records = 0, []

    with open(out_path, "w") as out:
        for key in sorted(data.files):
            name, h = key.rsplit("_h", 1)
            H = int(h)
            dt = 1.0 / H
            ocp = model.make_ocp(dt)
            x0 = model.initial_state(f64).to(device)
            u0 = warm_start(args.model, H, f64, device)
            u64, _ = SOLVERS[name](ocp, u0, x0, cfg)
            u32 = torch.as_tensor(data[key], dtype=f64, device=device)

            def cost(u):
                x = rollout(ocp.dynamics, u, x0)
                return float(ocp.total_cost(x, u, FINAL_BP))

            c32, c64 = cost(u32), cost(u64)
            rel = abs(c32 - c64) / max(abs(c64), 1e-12)

            # State-trajectory deviation: both controls through f64 dynamics.
            x32 = rollout(ocp.dynamics, u32, x0)
            x64 = rollout(ocp.dynamics, u64, x0)
            max_abs_dx = float((x32 - x64).abs().max())

            # Bound-active control agreement: stages riding |u| = bound.
            bound = getattr(model, "CONTROL_BOUND", None)
            u64n, u32n = u64.cpu().numpy(), u32.cpu().numpy()
            if bound is not None:
                active = np.abs(u64n) >= (1.0 - args.active_frac) * bound
                du = np.abs(u32n - u64n)
                act_du = np.sort(du[active]) if active.any() else None
                # Gate the 95th percentile: the body of the active set is
                # pinned by the constraint; the tail above p95 is the few
                # stages within a switching-time shift of the arc edges.
                bound_active_du = float(
                    act_du[int(0.95 * (len(act_du) - 1))]) \
                    if act_du is not None else None
                bound_active_du_max = float(act_du[-1]) \
                    if act_du is not None else None
                n_active = int(active.sum())
                n_shift = int((du[active] > 0.01 * bound).sum()) \
                    if active.any() else 0
            else:  # multi-input box models expose no single scalar bound
                bound_active_du, bound_active_du_max = None, None
                n_active, n_shift = 0, 0

            ok = rel <= args.cost_rtol and max_abs_dx <= args.dx_atol
            if bound_active_du is not None:
                ok = ok and bound_active_du <= args.bound_du_rtol * bound
            rec = {
                "model": args.model, "solver": name, "horizon": H,
                "rel_cost_delta": rel,
                "max_abs_du": float(np.abs(u32n - u64n).max()),
                "max_abs_dx": max_abs_dx,
                "bound_active_du": bound_active_du,
                "bound_active_du_max": bound_active_du_max,
                "bound_active_stages": n_active,
                "switch_shift_stages": n_shift,
                "cost_f32": c32, "cost_f64": c64,
                "pass": bool(ok),
            }
            failures += not rec["pass"]
            print(json.dumps(rec))
            out.write(json.dumps(rec) + "\n")
            records.append(rec)

    print(f"wrote {out_path}; {failures} failures", file=sys.stderr)
    return records


if __name__ == "__main__":
    sys.exit(0 if all(r["pass"] for r in main()) else 1)
