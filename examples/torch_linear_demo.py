"""Unconstrained LQR sanity demo on the PyTorch port (counterpart of
examples/linear_demo.py; reference examples/linear_demo_cuda.py).

The parallel IP Newton method on a linear-quadratic problem must converge in
~one Newton iteration per barrier stage to the closed-form LQR solution.

Usage:
    python examples/torch_linear_demo.py                  # on the card
    python examples/torch_linear_demo.py --device cpu --dtype float64
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import ipoc_tpu_torch
from ipoc_tpu_torch.interop import pick_device
from ipoc_tpu_torch.models import double_integrator
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.utils.integrators import rollout


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    args = p.parse_args(argv)
    device, dtype = pick_device(args.device), getattr(torch, args.dtype)

    ocp = double_integrator.make_ocp(0.1)
    horizon = 40
    x0 = torch.tensor([2.0, 1.0], dtype=dtype, device=device)
    u0 = torch.zeros((horizon, 1), dtype=dtype, device=device)

    cuda.reset_launches()
    u, iters = ipoc_tpu_torch.par_interior_point_optimal_control(ocp, u0, x0)
    X = rollout(ocp.dynamics, u, x0)
    out = {"iterations": int(iters),
           "u": u.cpu().double().ravel().tolist(),
           "final_state": X[-1].cpu().double().tolist(),
           "device": str(device), "dtype": args.dtype}
    if device.type == "cuda":  # the kernels the solve launched
        out["launches"] = {k: v for k, v in cuda.launches.items() if v}
    print("Newton iterations:", out["iterations"])
    print("u[:5] =", out["u"][:5])
    print("final state:", out["final_state"], "(drives to origin)")
    print(json.dumps({k: v for k, v in out.items() if k != "u"}))
    return out


if __name__ == "__main__":
    main()
