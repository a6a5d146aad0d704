"""Planar quadrotor (PVTOL) hover-to-target model (counterpart of
``ipoc_tpu/models/quadrotor.py``): six states, two rotor thrusts, each in
a box.  Batched over leading axes.

State ``x = (px, py, theta, vx, vy, omega)``, controls ``u = (f1, f2)``:

    px' = vx,  py' = vy,  theta' = omega
    vx' = -(f1 + f2) sin(theta) / m
    vy' =  (f1 + f2) cos(theta) / m - g
    omega' = arm * (f2 - f1) / inertia

Constraints: ``f_min <= f_i <= f_max`` as four inequalities ``c <= 0``.
"""

from __future__ import annotations

import torch

from ipoc_tpu_torch.problem import OCP, barrier_ocp
from ipoc_tpu_torch.utils.integrators import euler

GRAVITY = 9.81
MASS = 1.0
ARM = 0.2
INERTIA = 0.02

F_MIN = 0.1
F_MAX = 12.0
HOVER = MASS * GRAVITY / 2.0  # per-rotor hover thrust, well inside the box

GOAL = (1.0, 1.0, 0.0, 0.0, 0.0, 0.0)
STATE_WEIGHTS = (1.0, 1.0, 0.5, 0.1, 0.1, 0.05)
ACTION_WEIGHT = 1e-2


def ode(state, action):
    """Planar quadrotor dynamics."""
    theta, vx, vy, omega = (state[..., i] for i in range(2, 6))
    f1, f2 = action[..., 0], action[..., 1]
    thrust = f1 + f2
    s, c = torch.sin(theta), torch.cos(theta)
    return torch.stack([
        vx,
        vy,
        omega,
        -thrust * s / MASS,
        thrust * c / MASS - GRAVITY,
        ARM * (f2 - f1) / INERTIA,
    ], dim=-1)


def constraints(state, control):
    """Per-rotor thrust box as four inequalities c <= 0."""
    return torch.cat([control - F_MAX, F_MIN - control], dim=-1)


def _weighted_sq(state):
    # Python-float weights: no constant tensor is built (on a card, a
    # host-to-device copy) per call.
    return sum(w * (state[..., i] - g)**2
               for i, (w, g) in enumerate(zip(STATE_WEIGHTS, GOAL)))


def stage_cost(state, action):
    """Raw quadratic stage cost (the barrier is added by the solver layer)."""
    du = action - HOVER
    return 0.5 * _weighted_sq(state) + 0.5 * ACTION_WEIGHT * (du**2).sum(-1)


def final_cost(state):
    return 5.0 * _weighted_sq(state)


def make_ocp(dt: float) -> OCP:
    """Euler-discretized thrust-boxed planar quadrotor OCP."""
    return barrier_ocp(euler(ode, dt), constraints, stage_cost, final_cost)


def initial_state(dtype=torch.float32, device=None):
    """Hover at the origin; the goal is (1, 1) with zero attitude."""
    return torch.zeros((6,), dtype=dtype, device=device)


def hover_controls(horizon: int, dtype=torch.float32, device=None):
    """Feasible warm start: per-rotor hover thrust."""
    return torch.full((horizon, 2), HOVER, dtype=dtype, device=device)
