"""Integrators and rollout."""
