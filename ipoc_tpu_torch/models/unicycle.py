"""Unicycle (differential-drive) obstacle avoidance (counterpart of
``ipoc_tpu/models/unicycle.py``): the model zoo's nonlinear *state*
constraint, a circular keep-out disc, beside a box on each control.
Batched over leading axes.

State ``x = (px, py, theta)``, controls ``u = (v, omega)``:

    px' = v cos(theta),  py' = v sin(theta),  theta' = omega

Constraints (all ``<= 0``):

    v - V_MAX, -v - V_MAX, omega - W_MAX, -omega - W_MAX     control boxes
    RADIUS^2 - ||p - CENTER||^2                              keep-out disc

The scenario drives from the origin to ``GOAL`` past a disc that blocks
the straight line (its centre slightly off the axis, so that the straight
line is no symmetric saddle): the solution swerves and rides the disc's
boundary.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.problem import OCP, barrier_ocp
from ipoc_tpu_torch.utils.integrators import euler

V_MAX = 2.0
W_MAX = 4.0
CENTER = (1.0, 0.06)
RADIUS = 0.3
GOAL = (2.0, 0.0, 0.0)
STATE_WEIGHTS = (1.0, 1.0, 0.01)
ACTION_WEIGHTS = (0.05, 0.01)
FINAL_WEIGHT = 20.0


def ode(state, control):
    theta = state[..., 2]
    v, omega = control[..., 0], control[..., 1]
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta), omega],
                       dim=-1)


def constraints(state, control):
    """Control boxes and the keep-out disc, all as ``c <= 0``."""
    v, omega = control[..., 0], control[..., 1]
    d2 = (state[..., 0] - CENTER[0])**2 + (state[..., 1] - CENTER[1])**2
    return torch.stack([v - V_MAX, -v - V_MAX, omega - W_MAX,
                        -omega - W_MAX, RADIUS**2 - d2], dim=-1)


def _weighted_sq(state):
    # Python-float weights: no constant tensor is built (on a card, a
    # host-to-device copy) per call.
    return sum(w * (state[..., i] - g)**2
               for i, (w, g) in enumerate(zip(STATE_WEIGHTS, GOAL)))


def stage_cost(state, control):
    """Raw quadratic stage cost (the barrier is added by the solver layer)."""
    return 0.5 * _weighted_sq(state) + 0.5 * sum(
        r * control[..., i]**2 for i, r in enumerate(ACTION_WEIGHTS))


def final_cost(state):
    return 0.5 * FINAL_WEIGHT * _weighted_sq(state)


def make_ocp(dt: float) -> OCP:
    """Euler-discretized obstacle-avoidance unicycle OCP."""
    return barrier_ocp(euler(ode, dt), constraints, stage_cost, final_cost)


def initial_state(dtype=torch.float32, device=None):
    """Origin, pointing at the goal (the disc blocks the straight line)."""
    return torch.zeros((3,), dtype=dtype, device=device)
