"""The per-lane stage sums of the predicted reduction go through
``problem.stage_sum`` (a fixed pairwise order: a lane's total then rounds
with its own horizon alone, where ``torch.sum`` on a CUDA tensor splits the
reduction by the whole batch's shape, ``scripts/batch_size_witness.py``).

In ``parallel/lqt.py``'s ``par_bwd_pass`` and ``seq_bwd_pass_full``,
``solvers/ip_newton.py``'s ``seq_bwd_newton`` and, on a one-rank gloo
group, ``parallel/time_sharded.py``'s ``par_bwd_pass_time_sharded``, the
returned reduction equals ``stage_sum`` of the stages' terms to the bit,
float64 and float32: the LQT passes' terms recomputed from their own
``S, v`` by ``stage_gains``; the other two's recorded as the solver hands
them to ``stage_sum``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ipoc_tpu_torch import FAST_CONFIG
from ipoc_tpu_torch.models import pendulum
from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_plain
from ipoc_tpu_torch.ops.derivatives import (
    compute_first_order,
    compute_hamiltonian_lqr,
    final_gradient,
    final_hessian,
)
from ipoc_tpu_torch.parallel import lqt as L
from ipoc_tpu_torch.parallel import time_sharded as ts
from ipoc_tpu_torch.problem import stage_sum
from ipoc_tpu_torch.solvers import ip_newton
from ipoc_tpu_torch.utils.integrators import rollout
from tests.conftest import make_random_lqt

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]


def _lqt(dtype, B=5, T=13):
    rng = np.random.default_rng(4)
    lqts = [make_random_lqt(rng, T=T, nx=3, nu=2) for _ in range(B)]
    return L.LQT(*(torch.tensor(np.stack([np.asarray(f) for f in fields]),
                                dtype=dtype)
                   for fields in zip(*lqts)))


def _newton_data(dtype, B=6, T=21):
    """Pendulum lanes' cold-start Newton data: ``(ocp, x, lin, d)``."""
    ocp = pendulum.make_ocp(1.0 / T)
    gen = torch.Generator().manual_seed(2)
    u = 0.1 * torch.randn((B, T, 1), generator=gen, dtype=dtype)
    x0 = pendulum.initial_state(dtype) + 0.01 * torch.randn(
        (B, 2), generator=gen, dtype=dtype)
    x = rollout(ocp.dynamics, u, x0)
    bp = torch.tensor(0.1, dtype=dtype)
    d = compute_first_order(ocp, x, u, bp)
    lam = seq_costates_plain(d.cx, d.fx, final_gradient(ocp, x[:, -1]))
    lin = ip_newton._regularized(
        compute_hamiltonian_lqr(ocp, x, u, lam, bp), d,
        torch.ones(B, dtype=dtype), True, FAST_CONFIG.reg_scale_floor)
    return ocp, x, lin, d


class _Recorded:
    """``module.stage_sum`` replaced by a wrapper that records its
    arguments."""

    def __init__(self, monkeypatch, module):
        self.calls = []

        def spy(c):
            self.calls.append(c.clone())
            return stage_sum(c)

        monkeypatch.setattr(module, "stage_sum", spy)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["par", "seq"])
def test_lqt_pass_reduction_is_stage_sum(dtype, which):
    lqt = _lqt(dtype)
    if which == "par":
        _, _, S, v, pred, _ = L.par_bwd_pass(lqt, plain=True)
    else:
        _, _, S, v, pred, _ = L.seq_bwd_pass_full(lqt)
    dV = L.stage_gains(L.lqt_stages(lqt), S[:, 1:], v[:, 1:])[4]
    assert dV.shape == lqt.B.shape[:2]
    assert torch.equal(pred, stage_sum(dV))


@pytest.mark.parametrize("dtype", DTYPES)
def test_seq_bwd_newton_reduction_is_stage_sum(dtype, monkeypatch):
    ocp, x, lin, d = _newton_data(dtype)
    rec = _Recorded(monkeypatch, ip_newton)
    _, _, pred, _ = ip_newton.seq_bwd_newton(
        ocp.final_cost, x[:, -1], lin, d, torch.full((x.shape[0],), 0.5,
                                                     dtype=dtype))
    (terms,) = rec.calls
    assert terms.shape == lin.r.shape[:2]
    assert torch.equal(pred, stage_sum(terms))


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_sharded_reduction_is_stage_sum(dtype, monkeypatch, tmp_path):
    """On a one-rank group the gathered total is the local part."""
    lqt = _lqt(dtype)
    rec = _Recorded(monkeypatch, ts)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        *_, pred, _ = ts.par_bwd_pass_time_sharded(lqt, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    (terms,) = rec.calls
    assert terms.shape == lqt.B.shape[:2]
    assert torch.equal(pred, stage_sum(terms))
    _, _, _, _, ref, _ = L.par_bwd_pass(lqt, plain=True)
    torch.testing.assert_close(pred, ref, rtol=1e-5 if dtype == torch.float32
                               else 1e-12, atol=0)
