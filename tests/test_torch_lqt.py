"""The port's LQT passes and small linear algebra against the JAX package's,
float64 on the CPU.

Three random well-conditioned LQT problems (``tests/conftest.py``
``make_random_lqt``, numpy from a seed) are stacked into one batch of B=3:
the port runs them on its leading lane axis, JAX under ``vmap``.  Every
output agrees to 1e-10 of its scale (the same algorithm in the same
association order; the associative scan is a copy of JAX's recursion).
The brute-force QP oracle and the per-lane feasibility flag mirror
``tests/test_lqt.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoc_tpu.ops import linalg as jl
from ipoc_tpu.parallel import lqt as J
from ipoc_tpu_torch.ops import linalg as tl
from ipoc_tpu_torch.parallel import lqt as P
from tests.conftest import lqt_total_cost, make_random_lqt

torch.set_num_threads(1)

SHAPES = [(8, 3, 2), (8, 2, 1), (4, 4, 4)]
TOL = 1e-10


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _batch(rng, B, **kw):
    """B random LQTs: the JAX batch (stacked fields) and the port's."""
    lqts = [make_random_lqt(rng, **kw) for _ in range(B)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *lqts)
    port = P.LQT(*(torch.tensor(np.asarray(a)) for a in stacked))
    return stacked, port


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_elements_and_value_combine_match_jax(rng, shape, cross):
    T, nx, nu = shape
    jb, tb = _batch(rng, 3, T=T, nx=nx, nu=nu, cross=cross)
    j_el = jax.vmap(J._elements)(jb)
    t_el = P._elements(tb)
    for g, r in zip(t_el, j_el):
        _close(g, r)
    # Combine stage k with stage k+1 (earlier, later) over the horizon.
    j_c = jax.vmap(lambda e: J.value_combine(
        jax.tree.map(lambda a: a[:-1], e), jax.tree.map(lambda a: a[1:], e)))(
        j_el)
    t_c = P.value_combine(P.ValueElement(*(a[:, :-1] for a in t_el)),
                          P.ValueElement(*(a[:, 1:] for a in t_el)))
    for g, r in zip(t_c, j_c):
        _close(g, r)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_passes_match_jax(rng, shape, cross):
    """stage_gains, par_bwd_pass, seq_bwd_pass_full, par_fwd_pass and
    seq_fwd_pass against JAX (vmapped over the batch) at 1e-10."""
    T, nx, nu = shape
    jb, tb = _batch(rng, 3, T=T, nx=nx, nu=nu, cross=cross)
    x0 = rng.normal(size=(3, nx))
    for jf, tf in ((J.par_bwd_pass, P.par_bwd_pass),
                   (J.seq_bwd_pass_full, P.seq_bwd_pass_full)):
        ref = jax.vmap(jf)(jb)
        got = tf(tb)
        for g, r in zip(got, ref):
            _close(g, r)
        assert bool(got[5].all())
    K, d, S, v, _, _ = P.par_bwd_pass(tb)
    Kj, dj, Sj, vj, _, _ = jax.vmap(J.par_bwd_pass)(jb)
    gains = P.stage_gains(P.lqt_stages(tb), S[:, 1:], v[:, 1:])
    gains_j = jax.vmap(J.stage_gains)(J.lqt_stages(jb), Sj[:, 1:], vj[:, 1:])
    for g, r in zip(gains, gains_j):
        _close(g, r)
    for jf, tf in ((J.par_fwd_pass, P.par_fwd_pass),
                   (J.seq_fwd_pass, P.seq_fwd_pass)):
        ref = jax.vmap(jf)(jb, jnp.asarray(x0), Kj, dj)
        got = tf(tb, torch.tensor(x0), K, d)
        for g, r in zip(got, ref):
            _close(g, r)


def test_optimal_vs_brute_force(rng):
    """The port's parallel passes minimize the QP exactly (the oracle of
    tests/test_lqt.py: the Hessian and gradient of the flat objective)."""
    T, nx, nu = 7, 3, 2
    jb, tb = _batch(rng, 2, T=T, nx=nx, nu=nu)
    x0 = rng.normal(size=(2, nx))
    K, d, *_ = P.par_bwd_pass(tb)
    u, _ = P.par_fwd_pass(tb, torch.tensor(x0), K, d)
    for i in range(2):
        lqt_i = jax.tree.map(lambda a: a[i], jb)

        def flat_cost(uflat):
            return lqt_total_cost(lqt_i, uflat.reshape(T, nu), x0[i])

        g = jax.grad(flat_cost)(jnp.zeros(T * nu))
        Hm = jax.hessian(flat_cost)(jnp.zeros(T * nu))
        u_star = -np.linalg.solve(np.array(Hm), np.array(g))
        np.testing.assert_allclose(u[i].numpy().ravel(), u_star, atol=1e-9)


def test_infeasible_flag_per_lane(rng):
    """One lane of two has an indefinite U on one stage: only that lane is
    infeasible, in both backward passes (JAX reduces per lane under vmap;
    the port's per-lane is_posdef keeps the batch axis)."""
    jb, tb = _batch(rng, 2, T=6, nx=3, nu=2)
    U = tb.U.clone()
    U[1, 2] = -torch.eye(2, dtype=U.dtype)
    tb = tb._replace(U=U)
    jb = jb._replace(U=jnp.asarray(U.numpy()))
    for jf, tf in ((J.par_bwd_pass, P.par_bwd_pass),
                   (J.seq_bwd_pass_full, P.seq_bwd_pass_full)):
        assert tf(tb)[5].tolist() == [True, False]
        assert np.asarray(jax.vmap(jf)(jb)[5]).tolist() == [True, False]


def test_seq_bwd_pass_public_interface(rng):
    _, tb = _batch(rng, 2, T=5, nx=2, nu=1)
    K, d, S, v = P.seq_bwd_pass(tb)
    assert K.shape == (2, 5, 1, 2) and d.shape == (2, 5, 1)
    assert S.shape == (2, 6, 2, 2) and v.shape == (2, 6, 2)


@pytest.mark.parametrize("pivot", [True, False])
def test_linalg_solve_matches_jax(rng, pivot):
    """The unrolled small solves (partial pivoting and unpivoted) and the
    Cholesky factor against JAX's on batched systems, vector and matrix
    right-hand sides."""
    A = rng.normal(size=(5, 4, 4)) + 4 * np.eye(4)
    if pivot:
        A[:, 0, 0] = 1e-3  # a small leading entry: pivoting swaps rows
    b = rng.normal(size=(5, 4, 3))
    _close(tl.solve(torch.tensor(A), torch.tensor(b), pivot=pivot),
           jl.solve(jnp.asarray(A), jnp.asarray(b), pivot=pivot))
    _close(tl.solve(torch.tensor(A[0]), torch.tensor(b[0, :, 0]),
                    pivot=pivot),
           jl.solve(jnp.asarray(A[0]), jnp.asarray(b[0, :, 0]), pivot=pivot))
    S = A @ np.swapaxes(A, -1, -2)
    _close(tl.cholesky(torch.tensor(S)), jl.cholesky(jnp.asarray(S)))


def test_is_posdef_per_lane():
    """``is_posdef(A, batch_dims=1)`` flags each lane of a (B, T, n, n)
    stack; the default reduces over every axis, as JAX's does."""
    U = np.broadcast_to(np.eye(2), (3, 4, 2, 2)).copy()
    U[1, 2] = -np.eye(2)
    assert tl.is_posdef(torch.tensor(U), batch_dims=1).tolist() == [
        True, False, True]
    assert not bool(tl.is_posdef(torch.tensor(U)))
    assert bool(tl.is_posdef(torch.tensor(U[0]))) == bool(
        jl.is_posdef(jnp.asarray(U[0])))
