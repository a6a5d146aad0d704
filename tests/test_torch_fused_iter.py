"""The fused iteration and the packed rollout kernels of the port
(``ops/fused_iter.py``) against the JAX package.

On the CPU the wrappers run the plain versions, held here to

* JAX ``_fused_reference`` (vmapped) in float64, cartpole and pendulum:
  every output within 1e-10 of its scale (the same unfused composition on
  both sides, so agreement is at rounding level), ``ok`` equal;
* the JAX Pallas kernels in interpret mode (``fused_newton_iter_packed``
  two-launch with ``with_cu``, ``rollout_cost_packed``,
  ``transition_packed``), pendulum, T=6, B=1024 lanes (8 sublanes x 128)
  in float32, at the JAX suite's own kernel-vs-reference tolerance
  (rtol 5e-5, atol 5e-5; tests/test_fused_iter.py);
* the rollout kernel's JAX original, ``rollout_batched`` (interpret mode,
  one sublane, cartpole and pendulum, T=17, B=3, float32): the port's
  ``rollout_packed`` (its plain version here) within atol 1e-6
  (test_rollout_kernel_matches_scan);
* the unpacked twins of the last two, ``rollout_cost_batched`` and
  ``transition_batched`` (interpret mode, cartpole and pendulum, float32),
  whose outputs the packed kernels compute too: states 1e-6, costs
  rtol/atol 2e-5 (test_rollout_cost_kernel_matches_composition).

Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernels run only on a card: ``tests/test_torch_cuda.py`` holds them to
these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.seq_newton_kernel import _pack_s, _unpack_s
from ipoc_tpu.utils.integrators import rollout as j_rollout
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf

torch.set_num_threads(1)

MODELS = {"cartpole": (j_cartpole, t_cartpole),
          "pendulum": (j_pendulum, t_pendulum)}
NAMES = ("temp_x", "temp_u", "cost", "new_cost", "max_c", "pred", "ok", "hu")


def _pool(jm, B, T, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jm.initial_state(jnp.float64))
    u = 0.1 * rng.normal(size=(B, T, 1))
    x0b = x0 + 0.02 * rng.normal(size=(B, x0.shape[0]))
    return u.astype(dtype), x0b.astype(dtype)


@pytest.mark.parametrize("model", list(MODELS))
def test_fused_reference_matches_jax_f64(model):
    jm, tm = MODELS[model]
    B, T = 3, 8
    jocp, tocp = jm.make_ocp(1.0 / T), tm.make_ocp(1.0 / T)
    u, x0 = _pool(jm, B, T, seed=7)
    x = np.array(jax.vmap(lambda uu, xx: j_rollout(jocp.dynamics, uu, xx))(
        jnp.asarray(u), jnp.asarray(x0)))
    bp = np.full((B,), 0.1)
    reg = np.array([3.0, 0.5, 20.0])
    ref = jax.vmap(lambda a, b, c, d: jf._fused_reference(jocp, a, b, c, d))(
        *(jnp.asarray(v) for v in (x, u, bp, reg)))
    got = tf._fused_reference(tocp, *(torch.as_tensor(v)
                                      for v in (x, u, bp, reg)))
    for nm, g, r in zip(NAMES, got, ref):
        g, r = g.numpy(), np.asarray(r)
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=nm)
        else:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-10 * (np.abs(r).max() + 1),
                                       err_msg=nm)
    assert got[6].all(), "every lane's trial should be convex here"


# --- against the JAX Pallas kernels (interpret mode), float32 -------------

JB, JT, S = 1024, 6, 8
TOL = dict(rtol=5e-5, atol=5e-5)


def _to_port(a):
    """(B, T, rows) -> batch-last (T, rows, B)."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))


def _from_jax_stages(p, rows):
    return np.asarray(_unpack_s(p, JB, (rows,)))          # (B, T, rows)


def _from_jax_vec(p, rows):
    return np.asarray(_unpack_s(p[:, None], JB, (rows,)))[:, 0]


def _from_jax_scal(p):
    return np.asarray(p).reshape(-1)[:JB]


@pytest.fixture(scope="module")
def packed_case():
    """Pendulum lanes in both layouts, float32: the open-loop trajectory of
    numpy-made controls (port rollout, handed to JAX as well)."""
    jocp, tocp = j_pendulum.make_ocp(1.0 / JT), t_pendulum.make_ocp(1.0 / JT)
    u, x0 = _pool(j_pendulum, JB, JT, seed=3, dtype=np.float32)
    bp = np.full((JB,), 0.1, np.float32)
    xs, xT, _, _ = tf.rollout_cost_plain(
        tocp, _to_port(u), torch.as_tensor(x0.T.copy()), torch.as_tensor(bp))
    xs_b = xs.permute(2, 0, 1).numpy()          # (B, T, nx)
    xT_b = xT.T.numpy()                          # (B, nx)
    set_pallas_scans("on")
    yield jocp, tocp, u, x0, bp, xs_b, xT_b
    set_pallas_scans("auto")


def _jp(a):
    """(B, T, rows) or (B, rows) numpy -> the JAX kernels' packed layout."""
    a = jnp.asarray(a)
    return _pack_s(a, JB, S) if a.ndim == 3 else jf._pack_vec(a, JB, S)


def test_fused_iter_plain_matches_jax_kernel_f32(packed_case):
    jocp, tocp, u, _, bp, xs_b, xT_b = packed_case
    reg = np.full((JB,), 3.0, np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.fused_newton_iter_packed(
            jocp, _jp(xs_b), _jp(xT_b), _jp(u), _jp(bp[:, None]),
            _jp(reg[:, None]), with_cu=True, merged=False,
            interpret=True))()
    got = tf.fused_newton_iter_packed(
        tocp, _to_port(xs_b), torch.as_tensor(xT_b.T.copy()), _to_port(u),
        torch.as_tensor(bp), torch.as_tensor(reg))
    names = ("tu", "tx", "txT", "cost", "nc", "mc", "dv", "piv", "hu", "cun")
    for nm, g, r in zip(names, got, ref):
        if nm in ("tu", "tx"):
            r = _from_jax_stages(r, g.shape[1])
            g = g.permute(2, 0, 1).numpy()
        elif nm == "txT":
            r, g = _from_jax_vec(r, g.shape[0]), g.T.numpy()
        else:
            r, g = _from_jax_scal(r), g.numpy()
        np.testing.assert_allclose(g, r, **TOL, err_msg=nm)


def test_rollout_cost_plain_matches_jax_kernel_f32(packed_case):
    jocp, tocp, u, x0, bp, _, _ = packed_case
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.rollout_cost_packed(
            jocp, _jp(u), _jp(x0), _jp(bp[:, None]), interpret=True))()
    got = tf.rollout_cost_packed(tocp, _to_port(u),
                                 torch.as_tensor(x0.T.copy()),
                                 torch.as_tensor(bp))
    np.testing.assert_allclose(got[0].permute(2, 0, 1).numpy(),
                               _from_jax_stages(ref[0], 2), **TOL)
    np.testing.assert_allclose(got[1].T.numpy(), _from_jax_vec(ref[1], 2),
                               **TOL)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), _from_jax_scal(r), **TOL)


def test_transition_plain_matches_jax_kernel_f32(packed_case):
    jocp, tocp, u, x0, _, _, _ = packed_case
    rng = np.random.default_rng(11)
    up = (u + 0.05 * rng.normal(size=u.shape)).astype(np.float32)
    bp = np.full((JB,), 0.02, np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda: jf.transition_packed(
            jocp, _jp(u), _jp(up), _jp(x0), _jp(bp[:, None]),
            interpret=True))()
    got = tf.transition_packed(tocp, _to_port(u), _to_port(up),
                               torch.as_tensor(x0.T.copy()),
                               torch.as_tensor(bp))
    for i in range(2):
        np.testing.assert_allclose(got[i].permute(2, 0, 1).numpy(),
                                   _from_jax_stages(ref[i], 2), **TOL)
        np.testing.assert_allclose(got[2 + i].T.numpy(),
                                   _from_jax_vec(ref[2 + i], 2), **TOL)
    for g, r in zip(got[4:], ref[4:]):
        np.testing.assert_allclose(g.numpy(), _from_jax_scal(r), **TOL)


@pytest.mark.parametrize("model", list(MODELS))
def test_wrappers_run_plain_versions_on_cpu(model):
    """CPU tensors take the plain versions (no launch is counted), and the
    fused trial's outputs are consistent with the rollout kernel's: the
    trial's current cost is the rollout cost of the same iterate."""
    jm, tm = MODELS[model]
    B, T = 5, 7
    tocp = tm.make_ocp(1.0 / T)
    u, x0 = _pool(jm, B, T, seed=1)
    bp = torch.full((B,), 0.05, dtype=torch.float64)
    cuda.reset_launches()
    xs, xT, cost, cun = tf.rollout_cost_packed(
        tocp, _to_port(u), torch.as_tensor(x0.T.copy()), bp)
    out = tf.fused_newton_iter_packed(tocp, xs, xT, _to_port(u), bp,
                                      torch.ones(B, dtype=torch.float64))
    trans = tf.transition_packed(tocp, _to_port(u), _to_port(u),
                                 torch.as_tensor(x0.T.copy()), bp)
    assert cuda.launches == dict.fromkeys(cuda.launches, 0)
    np.testing.assert_allclose(out[3].numpy(), cost.numpy(), rtol=1e-13)
    for a, b in ((trans[0], xs), (trans[1], xs), (trans[4], cost),
                 (trans[7], cun)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13)
    assert out[0].shape == (T, 1, B) and out[2].shape == (xT.shape[0], B)


@pytest.mark.parametrize("kernel", ["rollout_cost", "transition"])
@pytest.mark.parametrize("model", list(MODELS))
def test_packed_kernels_cover_the_unpacked_twins(model, kernel):
    """The port has one layout: its packed rollout-cost and transition
    kernels also give what JAX's unpacked twins (_rollout_cost_kernel,
    _transition_kernel) compute, held here through their plain versions."""
    jm, tm = MODELS[model]
    B, T = 3, 13
    jocp, tocp = jm.make_ocp(1.0 / T), tm.make_ocp(1.0 / T)
    u, x0 = _pool(jm, B, T, seed=4, dtype=np.float32)
    up = (u + 0.05).astype(np.float32)
    bp = np.full((B,), 0.05, np.float32)
    x0t = torch.as_tensor(x0.T.copy())
    with jax.enable_x64(False):
        if kernel == "rollout_cost":
            ref_x, ref_c = jf.rollout_cost_batched(
                jocp, jnp.asarray(u), jnp.asarray(x0), jnp.asarray(bp),
                sublanes=1, interpret=True)
            refs = [(np.asarray(ref_x), np.asarray(ref_c))]
            xs, xT, cost, _ = tf.rollout_cost_packed(
                tocp, _to_port(u), x0t, torch.as_tensor(bp))
            gots = [(xs, xT, cost)]
        else:
            xa, xb, ca, cb = jf.transition_batched(
                jocp, jnp.asarray(u), jnp.asarray(up), jnp.asarray(x0),
                jnp.asarray(bp), sublanes=1, interpret=True)
            refs = [(np.asarray(xa), np.asarray(ca)),
                    (np.asarray(xb), np.asarray(cb))]
            out = tf.transition_packed(tocp, _to_port(u), _to_port(up), x0t,
                                       torch.as_tensor(bp))
            gots = [(out[0], out[2], out[4]), (out[1], out[3], out[5])]
    for (xs, xT, cost), (ref_x, ref_c) in zip(gots, refs):
        x = torch.cat([xs, xT[None]]).permute(2, 0, 1).numpy()
        np.testing.assert_allclose(x[:, 1:], ref_x[:, 1:], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(x[:, 0], ref_x[:, 0])
        np.testing.assert_allclose(cost.numpy(), ref_c, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("model", list(MODELS))
def test_rollout_plain_matches_jax_kernel(model):
    jm, tm = MODELS[model]
    Tn, Bn = 17, 3
    jocp, tocp = jm.make_ocp(1.0 / Tn), tm.make_ocp(1.0 / Tn)
    u, x0 = _pool(jm, Bn, Tn, seed=2, dtype=np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jf.rollout_batched(jocp.dynamics, jnp.asarray(u),
                                            jnp.asarray(x0), sublanes=1,
                                            interpret=True))
    cuda.reset_launches()
    xs, xT = tf.rollout_packed(tocp, _to_port(u), torch.as_tensor(x0.T.copy()))
    assert cuda.launches["rollout"] == 0
    assert xs.shape == (Tn, x0.shape[1], Bn) and xs.dtype == torch.float32
    got = tf.lanes_first(xs, xT).numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
