"""Models (counterpart of ``ipoc_tpu/models``): pendulum, cartpole, the
planar quadrotor and the double integrator."""
