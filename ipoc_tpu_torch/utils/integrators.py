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


def runge_kutta(state, action, ode: Callable, step: float):
    """Classic RK4 step with zero-order-hold action."""
    k1 = ode(state, action)
    k2 = ode(state + 0.5 * step * k1, action)
    k3 = ode(state + 0.5 * step * k2, action)
    k4 = ode(state + step * k3, action)
    return state + (step / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize_dynamics(ode: Callable, simulation_step: float,
                        downsampling: int = 1):
    """RK4 discretizer with ``downsampling`` sub-steps per control step (a
    Python loop where the JAX package has ``lax.fori_loop``)."""

    def dynamics(state, action):
        for _ in range(downsampling):
            state = runge_kutta(state, action, ode, simulation_step)
        return state

    return dynamics


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


def closed_loop_rollout(dynamics: Callable, gain, ffgain, nominal_states,
                        nominal_controls):
    """Nonlinear closed-loop rollout ``u = u_nom + k + K (x - x_nom)``
    through the true dynamics.

    ``gain (..., T, nu, nx)``, ``ffgain (..., T, nu)``, the nominal
    ``(..., T+1, nx)`` states and ``(..., T, nu)`` controls; returns the
    ``(..., T+1, nx)`` states and ``(..., T, nu)`` controls, starting from
    the nominal initial state."""
    x_hat = nominal_states[..., 0, :]
    states, controls = [x_hat], []
    for t in range(nominal_controls.shape[-2]):
        dx = x_hat - nominal_states[..., t, :]
        u_hat = (nominal_controls[..., t, :] + ffgain[..., t, :]
                 + (gain[..., t, :, :] @ dx.unsqueeze(-1)).squeeze(-1))
        x_hat = dynamics(x_hat, u_hat)
        states.append(x_hat)
        controls.append(u_hat)
    return torch.stack(states, dim=-2), torch.stack(controls, dim=-2)
