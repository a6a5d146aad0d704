"""bench.py's ``batch`` mode in the port: ``solve_batch`` with the fused
(``newton_impl="fused"``) and DDP (``"ddp"``) step evaluators, staged and
flat, against the JAX package on the CPU (the kernels' plain versions).

* Against JAX ``solve_batch`` on the same config, pendulum dt=0.02, T=50,
  B=4, float64 (the cases of tests/test_fused_iter.py and
  tests/test_ddp_stream.py): equal iterations, controls within 1e-10.  Both
  sides run the same unfused compositions, so agreement is at rounding
  level.
* Port ``"fused"`` against port ``"seq"`` (the same trial, the same
  accept/reject and Levenberg-Marquardt sequence): equal iterations,
  controls within 1e-12.
* The ``BATCH_CONFIG`` flat batch against the port's packed stream on the
  same scenarios, float64: per-lane semantics are equal but for the
  summation order of ``||cu||_F``, so equal iterations and controls within
  1e-8.
* The ``ValueError``s for ``terminal_hessian="reference"`` and for the retry
  globalization.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipoc_tpu
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.solvers.batched import solve_batch as j_solve_batch
from ipoc_tpu_torch import BATCH_CONFIG, FAST_CONFIG, solve_batch
from ipoc_tpu_torch.interop import config_from_jax, pool_from_numpy
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.solvers.stream import solve_stream

torch.set_num_threads(1)

T, B, DT = 50, 4, 0.02
SINGLE = ipoc_tpu.FAST_CONFIG.replace(globalization="single")


def _pool(n=B, horizon=T, seed=3):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u0 = 0.1 * rng.normal(size=(n, horizon, 1))
    x0b = x0 + 0.05 * rng.normal(size=(n, 2))
    return u0, x0b


def _port(cfg, u0, x0b, dt=DT):
    cuda.reset_launches()
    sol = solve_batch(t_pendulum.make_ocp(dt), *pool_from_numpy(u0, x0b),
                      config_from_jax(cfg))
    assert cuda.launches == dict.fromkeys(cuda.launches, 0), \
        "CPU tensors take the plain versions"
    return sol.controls.numpy(), sol.iterations.numpy()


@pytest.fixture(scope="module")
def pool():
    return _pool()


@pytest.mark.parametrize("mode", ["staged", "flat"])
@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_solve_batch_matches_jax(pool, impl, mode):
    cfg = SINGLE.replace(newton_impl=impl, barrier_mode=mode)
    jocp = j_pendulum.make_ocp(DT)
    ref = jax.jit(lambda u, x: j_solve_batch(jocp, u, x, cfg))(
        *(jnp.asarray(a) for a in pool))
    u, it = _port(cfg, *pool)
    np.testing.assert_array_equal(it, np.asarray(ref.iterations))
    np.testing.assert_allclose(u, np.asarray(ref.controls), rtol=0,
                               atol=1e-10)
    assert (it > 0).all()


@pytest.mark.parametrize("mode", ["staged", "flat"])
def test_fused_equals_seq(pool, mode):
    cfg = SINGLE.replace(barrier_mode=mode)
    u_f, it_f = _port(cfg.replace(newton_impl="fused"), *pool)
    u_s, it_s = _port(cfg.replace(newton_impl="seq"), *pool)
    np.testing.assert_array_equal(it_f, it_s)
    np.testing.assert_allclose(u_f, u_s, rtol=0, atol=1e-12)


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_flat_batch_matches_packed_stream(impl):
    """The flat batch (unpacked lanes, ``||cu||`` from a gradient pass) and
    the packed stream (``||cu||`` summed in the kernels, lanes refilled)
    on one pool with a non-finite warm start on lane 2."""
    Tn = 16
    u0, x0b = _pool(n=6, horizon=Tn, seed=5)
    u0[2] = np.nan
    cfg = BATCH_CONFIG.replace(barrier_mode="flat", newton_impl=impl)
    ocp = t_pendulum.make_ocp(1.0 / Tn)
    u, x = pool_from_numpy(u0, x0b)
    flat = solve_batch(ocp, u, x, cfg)
    stream = solve_stream(ocp, u, x, cfg, lanes=4, refill_every=5)
    assert torch.equal(flat.iterations, stream.iterations)
    assert int(flat.iterations[2]) == 0
    np.testing.assert_allclose(flat.controls.numpy(),
                               stream.controls.numpy(), rtol=0, atol=1e-8,
                               equal_nan=True)


@pytest.mark.parametrize("mode", ["staged", "flat"])
def test_fused_requires_exact_terminal_hessian(mode):
    cfg = FAST_CONFIG.replace(globalization="single", newton_impl="fused",
                              barrier_mode=mode,
                              terminal_hessian="reference")
    with pytest.raises(ValueError, match="terminal_hessian"):
        solve_batch(t_pendulum.make_ocp(DT), torch.zeros((2, 10, 1)),
                    torch.zeros((2, 2)), cfg)


@pytest.mark.parametrize("impl", ["fused", "ddp"])
def test_fused_requires_single_globalization(impl):
    cfg = FAST_CONFIG.replace(newton_impl=impl)
    with pytest.raises(ValueError, match="single"):
        solve_batch(t_pendulum.make_ocp(DT), torch.zeros((2, 10, 1)),
                    torch.zeros((2, 2)), cfg)
