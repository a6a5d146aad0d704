"""The port's associative scans (the plain versions of the scan kernels)
and parallel costates against the JAX package's, on the CPU.

* float64: ``affine_scan`` (suffix and prefix) and ``value_scan`` against
  JAX's ``lax.associative_scan`` paths at 1e-12 of scale (the port's scan
  is a copy of JAX's recursion, so the two combine in the same tree);
* float32: against the JAX Pallas kernels in interpret mode at
  ``tests/test_pallas.py``'s tolerances (atol 2e-5 on F, 2e-4 on c, 5e-4
  on value elements); interpret mode traces in x32, so float32 is its only
  dtype;
* ``par_costates`` against JAX's and against the port's ``seq_costates``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.ops.derivatives import compute_first_order as j_first_order
from ipoc_tpu.ops.pallas.scan_kernels import (
    pallas_affine_scan,
    pallas_value_scan,
)
from ipoc_tpu.parallel import costates as JC
from ipoc_tpu.parallel import lqt as J
from ipoc_tpu.utils.integrators import rollout as j_rollout
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.ops import scan_kernels as sk
from ipoc_tpu_torch.ops.derivatives import compute_first_order
from ipoc_tpu_torch.parallel import costates as TC
from ipoc_tpu_torch.parallel.scan import associative_scan
from tests.conftest import make_random_lqt

torch.set_num_threads(1)


def _close(got, ref, tol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _affine(rng, B, T, n, dtype):
    F = rng.normal(size=(B, T, n, n)) * 0.5
    c = rng.normal(size=(B, T, n))
    return F.astype(dtype), c.astype(dtype)


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("T", [5, 7, 130])
def test_affine_scan_matches_lax(rng, T, n, reverse):
    F, c = _affine(rng, 2, T, n, np.float64)
    ref = jax.jit(jax.vmap(lambda F, c: lax.associative_scan(
        lambda a, b: JC.affine_combine(b, a), (F, c), reverse=reverse,
        axis=0)))(jnp.asarray(F), jnp.asarray(c))
    got = sk.affine_scan(torch.tensor(F), torch.tensor(c), reverse)
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("T", [5, 7, 130])
def test_value_scan_matches_lax(rng, T, n):
    lqts = [make_random_lqt(rng, T=T, nx=n, nu=2) for _ in range(2)]
    elems = jax.jit(jax.vmap(J._elements))(
        jax.tree.map(lambda *a: jnp.stack(a), *lqts))
    ref = jax.jit(jax.vmap(lambda e: lax.associative_scan(
        lambda a, b: J.value_combine(b, a), e, reverse=True, axis=0)))(elems)
    got = sk.value_scan(*(torch.tensor(np.asarray(e)) for e in elems))
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)


def test_associative_scan_is_a_scan():
    """Inclusive scans of sums on odd and even lengths, both directions,
    along a non-leading axis."""
    x = torch.arange(1.0, 12.0).reshape(1, 11).repeat(2, 1)
    for n in (1, 2, 7, 11):
        xs = x[:, :n]
        fwd, = associative_scan(lambda a, b: (a[0] + b[0],), (xs,), dim=1)
        rev, = associative_scan(lambda a, b: (a[0] + b[0],), (xs,),
                                reverse=True, dim=1)
        assert torch.equal(fwd, xs.cumsum(1))
        assert torch.equal(rev, xs.flip(1).cumsum(1).flip(1))


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("T", [5, 130])
def test_affine_scan_matches_pallas_interpret(rng, T, reverse):
    F, c = _affine(rng, 1, T, 4, np.float32)
    got = sk.affine_scan(torch.tensor(F), torch.tensor(c), reverse)
    ref = pallas_affine_scan(jnp.asarray(F[0]), jnp.asarray(c[0]),
                             reverse=reverse, interpret=True)
    np.testing.assert_allclose(got[0][0].numpy(), ref[0], atol=2e-5)
    np.testing.assert_allclose(got[1][0].numpy(), ref[1], atol=2e-4)


def test_value_scan_matches_pallas_interpret(rng):
    lqt = make_random_lqt(rng, T=16, nx=4, nu=2, dtype=jnp.float32)
    elems = J._elements(lqt)
    ref = pallas_value_scan(elems.A, elems.b, elems.C, elems.eta, elems.J,
                            interpret=True)
    got = sk.value_scan(*(torch.tensor(np.asarray(e))[None] for e in elems))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[0].numpy(), r, atol=5e-4)


def test_par_costates_match_jax_and_seq(rng):
    """par_costates on cartpole stage data (T=40, B=3) against JAX's
    par_costates (vmapped) and the port's seq_costates, float64."""
    T, B = 40, 3
    jocp, tocp = j_cartpole.make_ocp(1.0 / T), t_cartpole.make_ocp(1.0 / T)
    x0 = np.asarray(j_cartpole.initial_state(jnp.float64))
    u = 0.1 * rng.normal(size=(B, T, 1))
    x0b = x0 + 0.01 * rng.normal(size=(B, 4))
    X = jax.vmap(lambda uu, xx: j_rollout(jocp.dynamics, uu, xx))(
        jnp.asarray(u), jnp.asarray(x0b))
    bp = 0.1
    d_j = jax.jit(jax.vmap(lambda x, uu: j_first_order(jocp, x, uu, bp)))(
        X, jnp.asarray(u))
    ref = jax.jit(jax.vmap(lambda x, d: JC.par_costates(jocp, x[-1], d)))(
        X, d_j)
    Xt = torch.tensor(np.asarray(X))
    d_t = compute_first_order(tocp, Xt, torch.tensor(u), bp)
    got = TC.par_costates(tocp, Xt[:, -1], d_t)
    _close(got, ref, 1e-12)
    _close(got, TC.seq_costates(tocp, Xt[:, -1], d_t), 1e-12)
