"""Models (counterpart of ``ipoc_tpu/models``): pendulum and cartpole."""
