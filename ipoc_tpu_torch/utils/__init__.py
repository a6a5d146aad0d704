"""Integrators and rollout; the auxiliaries ``timing``, ``logging`` and
``profiling`` are imported as modules, as in the JAX package."""

from ipoc_tpu_torch.utils.integrators import (
    closed_loop_rollout,
    discretize_dynamics,
    euler,
    rollout,
    runge_kutta,
    wrap_angle,
)
