"""Solve API with per-solve metrics (counterpart of
``ipoc_tpu/solvers/solution.py``): :func:`solve` returns an
:class:`IPSolution` with the converged trajectory, the iterations, the
final stationarity, the barrier-free cost and the feasibility."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.ops.derivatives import (
    check_feasibility,
    compute_first_order,
)
from ipoc_tpu_torch.parallel.costates import par_costates
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.barrier import n_barrier_stages
from ipoc_tpu_torch.solvers.batched import solve_batch
from ipoc_tpu_torch.utils.integrators import rollout


class IPSolution(NamedTuple):
    """Solution and health metrics of one interior-point solve."""

    controls: torch.Tensor    # (T, nu)
    states: torch.Tensor      # (T+1, nx)
    iterations: torch.Tensor  # () int32 total Newton iterations
    grad_norm: torch.Tensor   # () ||grad_u H||_inf at the final barrier
    cost: torch.Tensor        # () barrier-free total cost
    feasible: torch.Tensor    # () bool: all constraints satisfied
    converged: torch.Tensor   # () bool: grad_norm < tol

    def metrics(self) -> dict:
        """Host-side dict of the scalar metrics (for logging)."""
        return {
            "iterations": int(self.iterations),
            "grad_norm": float(self.grad_norm),
            "cost": float(self.cost),
            "feasible": bool(self.feasible),
            "converged": bool(self.converged),
        }


def solve(
    ocp: OCP,
    controls,
    initial_state,
    cfg: SolverConfig = DEFAULT_CONFIG,
    method: str = "par",
) -> IPSolution:
    """Full interior-point solve of one scenario (``method`` "par", "seq"
    or "ddp") with structured metrics, on the device of ``controls``."""
    u, iters = solve_batch(ocp, controls[None], initial_state[None], cfg,
                           method)
    x = rollout(ocp.dynamics, u, initial_state[None])
    # Stationarity of the final barrier stage actually solved:
    # ||grad_u H||_inf = max |cu + fu^T lam|, a first-order quantity.
    n_stages = n_barrier_stages(cfg)
    bp_final = cfg.bp_init / cfg.bp_decay ** (n_stages - 1)
    d = compute_first_order(ocp, x, u, bp_final)
    lam = par_costates(ocp, x[:, -1], d)
    ru = d.cu + torch.einsum("btiu,bti->btu", d.fu, lam[:, 1:])
    grad_norm = ru.abs().amax()
    cost = ocp.total_cost(x, u, torch.zeros((), dtype=x.dtype,
                                            device=x.device))[0]
    return IPSolution(
        controls=u[0],
        states=x[0],
        iterations=iters[0],
        grad_norm=grad_norm,
        cost=cost,
        feasible=check_feasibility(ocp, x, u)[0],
        converged=grad_norm < cfg.tol,
    )
