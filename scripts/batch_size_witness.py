#!/usr/bin/env python3
"""Find the first tensor operation of ``solve_batch`` (or of the LQT
passes) whose result for a lane depends on how many lanes run beside it.

Run from the root of a checkout (on a CUDA card, or with ``--device cpu``):

    python3 scripts/batch_size_witness.py [--device cuda] [--ops 20000]
        [--runs par,seq,lqt]

For each run and dtype (float64, then float32) the script runs it on the
pendulum scenarios of ``chip_smoke.py`` phase S (seed 1, T=100) twice: the
first 8 alone, and all 16.  The runs: ``par`` and ``seq``, ``solve_batch``
with FAST_CONFIG's single-trial globalization and ``method="par"`` (the
parallel trial) or ``method="seq"`` (the sequential validation solve,
``seq_bwd_newton``'s Riccati pass); ``lqt``, the LQT passes on the
scenarios' cold-start Newton data (``newton_lqt``, ``par_bwd_pass``,
``seq_bwd_pass_full``, ``par_fwd_pass``).  It prints, per run and dtype,
one JSON line with

* the whole run: for the solves the iterations of the first 8 lanes in
  both runs and the largest difference of their controls; for the LQT
  passes the largest difference of the first 8 lanes' gains and predicted
  reductions, and whether the reductions are the same bits;
* the first ``--ops`` ATen operations of both runs, logged by a
  ``TorchDispatchMode`` and compared in order: each tensor of the 16-lane
  run is cut to the first 8 lanes along the one dimension where its size
  is twice the 8-lane run's.  Operations whose inputs have a lane
  dimension and whose outputs have none (a reduction over the lanes) are
  not compared; nor are the ``empty`` factories; views are not logged.
  ``events`` lists the first operations whose outputs differ, each with
  its name, whether its inputs were equal (if not, a kernel launched
  outside the dispatcher, or an operation past the log, made them differ)
  and the innermost lines of the port that called it;
* ``witness``: the first operation whose inputs are equal and whose
  outputs differ, run again alone on its two logged inputs, three times
  each on the device (same bits each time: not a race) and once on CPU
  copies;
* ``sum_8_vs_16_bit_equal``: ``torch.sum(-1)`` and the solver's
  fixed-order ``problem.stage_sum`` over seeded ``(16, T)`` stage costs,
  on the device and on the CPU: whether the first 8 lanes' totals are the
  same bits alone and beside the other 8.

The hand-written kernels are plain-C functions called through ``ctypes``:
they do not pass the dispatcher and are not in the log.
"""

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ipoc_tpu_torch import FAST_CONFIG, solve_batch  # noqa: E402
from ipoc_tpu_torch.models import pendulum  # noqa: E402
from ipoc_tpu_torch.problem import stage_sum  # noqa: E402
from ipoc_tpu_torch.solvers.batched import make_batch  # noqa: E402

SEED, T, B = 1, 100, 16
PORT = str(ROOT / "ipoc_tpu_torch")
# Not logged, so that both runs log the same sequence: views (indexing
# skips a slice over a whole dimension, so the 16-lane run makes fewer)
# and constants' lifts.
SKIP = (torch.ops.aten.lift_fresh.default,)


def tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def clone(tree):
    return pytree.tree_map(
        lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
        tree)


def caller():
    """The innermost three lines of the port on the stack."""
    f, out = sys._getframe(2), []
    while f is not None and len(out) < 3:
        if f.f_code.co_filename.startswith(PORT):
            out.append(f"{Path(f.f_code.co_filename).relative_to(ROOT)}:"
                       f"{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return out


def cut(small, big):
    """``big`` cut to ``small``'s lanes, or None where the shapes do not
    differ by a doubled dimension; ``"same"`` where they are equal."""
    if small.shape == big.shape:
        return "same"
    if small.dim() != big.dim():
        return None
    dims = [d for d in range(small.dim()) if small.shape[d] != big.shape[d]]
    if len(dims) != 1 or big.shape[dims[0]] != 2 * small.shape[dims[0]]:
        return None
    return big.narrow(dims[0], 0, small.shape[dims[0]])


def equal(small, big):
    """Bit equality of ``small`` with ``big`` cut to its lanes (NaN equal
    to NaN); None where they cannot be aligned."""
    c = cut(small, big)
    if c is None:
        return None
    c = big if isinstance(c, str) else c
    if small.dtype != c.dtype:
        return False
    if small.is_floating_point():
        both_nan = torch.isnan(small) & torch.isnan(c)
        return bool(((small == c) | both_nan).all())
    return bool(torch.equal(small, c))


class OpLog(TorchDispatchMode):
    """Log (``ref`` None) or compare with ``ref`` the first ``limit`` ATen
    operations."""

    def __init__(self, limit, ref=None):
        super().__init__()
        self.limit, self.ref, self.n = limit, ref, 0
        self.log, self.events, self.witness = [], [], None
        self.cross_lane = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func in SKIP:
            return func(*args, **kwargs)
        i = self.n
        self.n += 1
        if i >= self.limit:
            return func(*args, **kwargs)
        ins = clone((args, kwargs))
        out = func(*args, **kwargs)
        name = str(func)
        if self.ref is None:
            self.log.append((name, ins, clone(out)))
            return out
        if i >= len(self.ref.log) or self.ref.log[i][0] != name:
            self.events.append({"op": i, "name": name, "sequence": "diverged"})
            self.limit = i
            return out
        _, ins8, out8 = self.ref.log[i]
        a8, a16 = tensors(ins8), tensors(ins)
        o8, o16 = tensors(out8), tensors(out)
        lane_in = any(x.shape != y.shape for x, y in zip(a8, a16))
        if "empty" in name:
            return out
        if lane_in and any(x.shape == y.shape for x, y in zip(o8, o16)):
            self.cross_lane += 1
            return out
        out_eq = [equal(x, y) for x, y in zip(o8, o16)]
        if all(out_eq):
            return out
        in_eq = all(equal(x, y) is not False for x, y in zip(a8, a16))
        ev = {"op": i, "name": name, "inputs_equal": in_eq,
              "shapes": [list(y.shape) for y in o16],
              "dtypes": [str(y.dtype) for y in o16], "where": caller()}
        if len(self.events) < 12:
            self.events.append(ev)
        if in_eq and self.witness is None:
            self.witness = (func, ins8, ins, ev)
        return out


def rerun(func, ins8, ins16):
    """The logged operation alone on its two inputs: on the device three
    times each, then on CPU copies."""
    def run(ins, dev=None):
        if dev is not None:
            ins = pytree.tree_map(
                lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                ins)
        a, k = clone(ins)
        return tensors(func(*a, **k))

    dev8 = [run(ins8) for _ in range(3)]
    dev16 = [run(ins16) for _ in range(3)]
    repeat = all(equal(x, y) for r in dev8[1:] for x, y in zip(dev8[0], r)) \
        and all(equal(x, y) for r in dev16[1:] for x, y in zip(dev16[0], r))
    cpu8, cpu16 = run(ins8, "cpu"), run(ins16, "cpu")
    diff = [float((x - cut(x, y) if not isinstance(cut(x, y), str)
                   else x - y).abs().max())
            for x, y in zip(dev8[0], dev16[0]) if x.is_floating_point()]
    return {"device_repeats_bit_equal": repeat,
            "device_8_vs_16_bit_equal": all(
                equal(x, y) for x, y in zip(dev8[0], dev16[0])),
            "device_8_vs_16_max_abs_diff": diff,
            "cpu_8_vs_16_bit_equal": all(
                equal(x, y) for x, y in zip(cpu8, cpu16)),
            "device_vs_cpu_16_bit_equal": all(
                equal(x.cpu(), y) for x, y in zip(dev16[0], cpu16))}


def sum_witness(dtype, dev):
    """``torch.sum(-1)`` and ``problem.stage_sum`` of seeded ``(16, T)``
    stage costs: is each of the first 8 lanes' totals the same bits alone
    and beside the other 8?"""
    c = torch.randn((B, T), generator=torch.Generator().manual_seed(SEED),
                    dtype=dtype)
    out = {}
    for where in (dev, torch.device("cpu")):
        x = c.to(where)
        for name, fn in (("torch_sum", lambda t: t.sum(-1)),
                         ("stage_sum", stage_sum)):
            out[f"{name}_{where.type}"] = bool(torch.equal(
                fn(x[:B // 2]), fn(x)[:B // 2]))
    return out


def lqt_passes(ocp, u, x0):
    """The LQT passes on the lanes' cold-start Newton data (bp=0.1, the
    Levenberg parameter 1 scaled by ||cu||): ``(par gains K, d, par
    predicted reduction, seq gains K, seq predicted reduction, du)``."""
    from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_plain
    from ipoc_tpu_torch.ops.derivatives import (
        compute_first_order,
        compute_hamiltonian_lqr,
        final_gradient,
        final_hessian,
    )
    from ipoc_tpu_torch.parallel import lqt as L
    from ipoc_tpu_torch.solvers.ip_newton import _regularized
    from ipoc_tpu_torch.utils.integrators import rollout

    x = rollout(ocp.dynamics, u, x0)
    bp = torch.tensor(0.1, dtype=u.dtype, device=u.device)
    d = compute_first_order(ocp, x, u, bp)
    lam = seq_costates_plain(d.cx, d.fx, final_gradient(ocp, x[:, -1]))
    lin = _regularized(compute_hamiltonian_lqr(ocp, x, u, lam, bp), d,
                       torch.ones(u.shape[0], dtype=u.dtype, device=u.device),
                       True, FAST_CONFIG.reg_scale_floor)
    lqt = L.newton_lqt(lin, d, final_hessian(ocp, x[:, -1]))
    K, kff, _, _, pred, _ = L.par_bwd_pass(lqt)
    Ks, _, _, _, pred_s, _ = L.seq_bwd_pass_full(lqt)
    du, _ = L.par_fwd_pass(lqt, torch.zeros_like(x0), K, kff)
    return K, kff, pred, Ks, pred_s, du


def whole_run(name, ocp, cfg, u, x0):
    """Run ``name`` on the first 8 lanes and on all 16: the record of how
    the first 8 lanes' results compare."""
    half = B // 2
    if name == "lqt":
        r8, r16 = (lqt_passes(ocp, u[:n], x0[:n]) for n in (half, B))
        diff = [float((a - b[:half]).abs().max()) for a, b in zip(r8, r16)]
        return {"max_abs_diff_K_d_pred_Kseq_predseq_du": diff,
                "pred_bit_equal": bool(torch.equal(r8[2], r16[2][:half])),
                "pred_seq_bit_equal": bool(torch.equal(r8[4],
                                                       r16[4][:half]))}
    s8 = solve_batch(ocp, u[:half], x0[:half], cfg, method=name)
    s16 = solve_batch(ocp, u, x0, cfg, method=name)
    return {"iterations_8": s8.iterations.tolist(),
            "iterations_16_first_8": s16.iterations[:half].tolist(),
            "max_abs_du": float((s8.controls - s16.controls[:half])
                                .abs().max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ops", type=int, default=20000)
    ap.add_argument("--runs", default="par,seq,lqt",
                    help="comma-separated: par, seq (solve_batch's methods) "
                         "and lqt (the LQT passes)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card: pass --device cpu")
    cfg = FAST_CONFIG.replace(globalization="single")
    ocp = pendulum.make_ocp(1.0 / T)
    for name, dtype in ((n, dt) for n in args.runs.split(",")
                        for dt in (torch.float64, torch.float32)):
        u, x0 = make_batch(torch.Generator().manual_seed(SEED),
                           pendulum.initial_state(dtype), B, T, 1,
                           state_scale=0.01, control_scale=0.1, dtype=dtype)
        u, x0 = u.to(dev), x0.to(dev)
        half = B // 2

        def run(n):
            if name == "lqt":
                return lqt_passes(ocp, u[:n], x0[:n])
            return solve_batch(ocp, u[:n], x0[:n], cfg, method=name)

        # The whole runs first (the kernels built), then the logged ones.
        whole = whole_run(name, ocp, cfg, u, x0)
        ref = OpLog(args.ops)
        with ref:
            run(half)
        cmp = OpLog(args.ops, ref)
        with cmp:
            run(B)
        rec = {"run": name, "dtype": str(dtype), "device": str(dev),
               "card": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
               **whole,
               "ops_compared": min(cmp.limit, len(ref.log)),
               "ops_in_8_lane_solve": ref.n,
               "cross_lane_ops_skipped": cmp.cross_lane,
               "events": cmp.events, "witness": None,
               "sum_8_vs_16_bit_equal": sum_witness(dtype, dev)}
        if cmp.witness is not None:
            func, ins8, ins16, ev = cmp.witness
            rec["witness"] = dict(ev, **rerun(func, ins8, ins16))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
