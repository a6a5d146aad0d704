"""Double-integrator model (counterpart of
``ipoc_tpu/models/double_integrator.py``): the linear, unconstrained LQR
sanity problem, RK4-discretized.  Batched over leading axes."""

from __future__ import annotations

import torch

from ipoc_tpu_torch.problem import OCP, unconstrained_ocp
from ipoc_tpu_torch.utils.integrators import discretize_dynamics

STATE_WEIGHTS = (1e2, 1e0)
ACTION_WEIGHT = 1e-1


def ode(state, control):
    """xdot = [[0, 1], [0, 0]] x + [[0], [1]] u."""
    return torch.stack([state[..., 1], control[..., 0]], dim=-1)


def _weighted_sq(state):
    return sum(w * state[..., i]**2 for i, w in enumerate(STATE_WEIGHTS))


def stage_cost(state, control):
    return (0.5 * _weighted_sq(state)
            + 0.5 * ACTION_WEIGHT * (control**2).sum(-1))


def final_cost(state):
    return 0.5 * _weighted_sq(state)


def make_ocp(dt: float, downsampling: int = 1) -> OCP:
    """RK4-discretized unconstrained LQR problem."""
    return unconstrained_ocp(discretize_dynamics(ode, dt, downsampling),
                             stage_cost, final_cost)
