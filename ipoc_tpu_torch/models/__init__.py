"""Models (counterpart of ``ipoc_tpu/models``): pendulum, cartpole (with
its optional cart-position box), the planar quadrotor, the double
integrator and the unicycle with its keep-out disc."""

from ipoc_tpu_torch.models import (
    cartpole,
    double_integrator,
    pendulum,
    quadrotor,
    unicycle,
)
