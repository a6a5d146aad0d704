"""Integrators and trajectory rollout (counterpart of
``ipoc_tpu/utils/integrators.py``), batched over leading axes."""

from __future__ import annotations

import math
from typing import Callable

import torch


def wrap_angle(x):
    """Wrap angle into [0, 2*pi).

    ``torch.remainder`` takes the sign of the divisor, as ``jnp.remainder``
    does, so negative angles wrap up into the interval.
    """
    return torch.remainder(x, 2.0 * math.pi)


def euler(ode: Callable, simulation_step: float):
    """Forward-Euler discretizer."""

    def dynamics(state, action):
        return state + simulation_step * ode(state, action)

    return dynamics


def rollout(dynamics: Callable, controls, initial_state):
    """Open-loop rollout: ``(..., T, nu)`` controls from ``(..., nx)`` states
    give the ``(..., T+1, nx)`` trajectory; a Python loop over T, each step
    one batched dynamics call."""
    states = [initial_state]
    x = initial_state
    for t in range(controls.shape[-2]):
        x = dynamics(x, controls[..., t, :])
        states.append(x)
    return torch.stack(states, dim=-2)
