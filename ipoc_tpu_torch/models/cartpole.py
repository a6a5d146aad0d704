"""Constrained cartpole swing-up model (counterpart of
``ipoc_tpu/models/cartpole.py``): force box |u| <= 50, quadratic costs with
pole-angle wrapping, underactuated.mit.edu cartpole ODE.  Batched over
leading axes.  ``make_ocp(dt, cart_limit)`` adds the cart-position state
box ``|x_cart| <= cart_limit`` (BASELINE.json config 3)."""

from __future__ import annotations

import math

import torch

from ipoc_tpu_torch.problem import OCP, barrier_ocp
from ipoc_tpu_torch.utils.integrators import euler, wrap_angle

GRAVITY = 9.81
POLE_LENGTH = 0.5
CART_MASS = 10.0
POLE_MASS = 1.0

CONTROL_BOUND = 50.0
GOAL = (0.0, math.pi, 0.0, 0.0)  # pole upright
STATE_WEIGHTS = (1.0, 10.0, 1e-1, 1e-1)
ACTION_WEIGHT = 1e-3


def ode(state, action):
    """Cartpole dynamics."""
    pole_pos = state[..., 1]
    cart_vel = state[..., 2]
    pole_vel = state[..., 3]
    total_mass = CART_MASS + POLE_MASS
    u = action[..., 0]

    sth = torch.sin(pole_pos)
    cth = torch.cos(pole_pos)
    denom = CART_MASS + POLE_MASS * sth**2

    cart_acc = (
        u + POLE_MASS * sth * (POLE_LENGTH * pole_vel**2 + GRAVITY * cth)
    ) / denom
    pole_acc = (
        -u * cth
        - POLE_MASS * POLE_LENGTH * pole_vel**2 * cth * sth
        - total_mass * GRAVITY * sth
    ) / (POLE_LENGTH * denom)

    return torch.stack([cart_vel, pole_vel, cart_acc, pole_acc], dim=-1)


def constraints(state, control):
    """Force box as two inequalities c <= 0."""
    return torch.stack([control[..., 0] - CONTROL_BOUND,
                        -control[..., 0] - CONTROL_BOUND], dim=-1)


def make_constraints(cart_limit: float | None = None):
    """The force box, and with ``cart_limit`` the cart-position state box
    ``|x_cart| <= cart_limit`` after it, all as ``c <= 0``."""
    if cart_limit is None:
        return constraints

    def cons(state, control):
        return torch.cat([
            constraints(state, control),
            torch.stack([state[..., 0] - cart_limit,
                         -state[..., 0] - cart_limit], dim=-1)], dim=-1)

    return cons


def _error(state):
    return torch.stack([state[..., 0] - GOAL[0],
                        wrap_angle(state[..., 1]) - GOAL[1],
                        state[..., 2] - GOAL[2],
                        state[..., 3] - GOAL[3]], dim=-1)


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


def make_ocp(dt: float, cart_limit: float | None = None) -> OCP:
    """Euler-discretized constrained cartpole OCP; ``cart_limit`` adds the
    state box ``|x_cart| <= cart_limit``."""
    return barrier_ocp(euler(ode, dt), make_constraints(cart_limit),
                       stage_cost, final_cost)


def initial_state(dtype=torch.float32):
    """Benchmark initial state."""
    x = torch.tensor([0.01, -0.01, 0.01, -0.01], dtype=dtype)
    return torch.stack([x[0], wrap_angle(x[1]), x[2], x[3]])
