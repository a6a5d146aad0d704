"""Constrained pendulum swing-up model (counterpart of
``ipoc_tpu/models/pendulum.py``): torque box |u| <= 5, quadratic tracking
costs with angle wrapping, damped pendulum ODE.  Batched over leading axes."""

from __future__ import annotations

import math

import torch

from ipoc_tpu_torch.problem import OCP, barrier_ocp
from ipoc_tpu_torch.utils.integrators import euler, wrap_angle

GRAVITY = 9.81
LENGTH = 1.0
MASS = 1.0
DAMPING = 1e-3

CONTROL_BOUND = 5.0
GOAL = (math.pi, 0.0)  # upright
STATE_WEIGHTS = (1.0, 1e-1)
ACTION_WEIGHT = 1e-3


def ode(state, action):
    """Damped pendulum dynamics."""
    position, velocity = state[..., 0], state[..., 1]
    accel = (
        -GRAVITY / LENGTH * torch.sin(position)
        + (action[..., 0] - DAMPING * velocity) / (MASS * LENGTH**2)
    )
    return torch.stack([velocity, accel], dim=-1)


def constraints(state, control):
    """Torque box as two inequalities c <= 0."""
    return torch.cat([control - CONTROL_BOUND, -control - CONTROL_BOUND],
                     dim=-1)


def _error(state):
    return torch.stack([wrap_angle(state[..., 0]) - GOAL[0],
                        state[..., 1] - GOAL[1]], dim=-1)


def _weighted_sq(err):
    # Python-float weights: no constant tensor is built (on a card, a
    # host-to-device copy) per call.
    return sum(w * err[..., i]**2 for i, w in enumerate(STATE_WEIGHTS))


def stage_cost(state, action):
    """Raw quadratic stage cost (the barrier is added by the solver layer)."""
    return (0.5 * _weighted_sq(_error(state))
            + 0.5 * ACTION_WEIGHT * (action**2).sum(-1))


def final_cost(state):
    """Terminal cost, same weights as the stage cost."""
    return 0.5 * _weighted_sq(_error(state))


def make_ocp(dt: float) -> OCP:
    """Euler-discretized constrained pendulum OCP."""
    return barrier_ocp(euler(ode, dt), constraints, stage_cost, final_cost)


def initial_state(dtype=torch.float32):
    """Benchmark initial state."""
    x = torch.tensor([0.1, -0.1], dtype=dtype)
    return torch.stack([wrap_angle(x[0]), x[1]])
