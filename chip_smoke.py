#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipoc_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ipoc_tpu_torch/csrc`` and then
runs four phases, each printing one JSON line:

  0. the device: its name, power limit, and the kernels' build time;
  A. each kernel against its plain PyTorch version on the card, on stage
     data taken from the real slice (cartpole, T=100, B=4096), in float32
     and float64, on random nx=3, nu=2 data, and on an indefinite R that
     must fail the PD test; then each kernel's time beside the plain
     version's;
  B. ``solve_stream`` on 256 cartpole scenarios in float64: the card
     (kernels) against the CPU (plain versions);
  C. ``solve_stream`` at the bench's width: cartpole H=100, float32,
     ``BATCH_CONFIG.replace(newton_impl="seq")``, 4096 lanes, refill every
     32, a pool of 4 x 4096 scenarios.

Every check raises on failure, so any failed phase exits non-zero.  The
line before the last holds the kernels' record; the last line is
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset (default:
all).  Without a card, or outside a checkout of the repository, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 1
T = 100
DT = 1.0 / T
LANES = 4096
POOL = 4 * LANES  # the bench's pool is 32 x lanes; 4 x keeps this smoke short
REFILL = 32


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Median of per-call CUDA-event timings, in ms, after one warm call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slice_stage_data(pool, dtype, device, bp=0.1, rp=100.0):
    """The trial's and the costate recursion's inputs at the pool's cold
    start, as the stream's first iteration computes them."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_plain
    from ipoc_tpu_torch.ops.derivatives import (
        compute_first_order,
        compute_hamiltonian_lqr,
        final_gradient,
        final_hessian,
    )
    from ipoc_tpu_torch.solvers.ip_newton import _regularized
    from ipoc_tpu_torch.utils.integrators import rollout

    ocp = cartpole.make_ocp(DT)
    u, x0 = (a.to(device, dtype) for a in pool)
    B = u.shape[0]
    x = rollout(ocp.dynamics, u, x0)
    bpt = torch.full((B,), bp, dtype=dtype, device=device)
    d = compute_first_order(ocp, x, u, bpt)
    lam_T = final_gradient(ocp, x[:, -1])
    lam = seq_costates_plain(d.cx, d.fx, lam_T)
    lin = compute_hamiltonian_lqr(ocp, x, u, lam, bpt)
    lin = _regularized(lin, d, torch.full((B,), rp, dtype=dtype,
                                          device=device),
                       True, BATCH_CONFIG.reg_scale_floor)
    XT = final_hessian(ocp, x[:, -1])
    trial = tuple(a.contiguous() for a in (lin.r, lin.Q, lin.R, lin.M, d.fx,
                                           d.fu, XT))
    costate = tuple(a.contiguous() for a in (d.cx, d.fx, lam_T))
    return trial, costate


def random_stage_data(gen, B, T_, nx, nu, dtype, device):
    """Random well-conditioned stage data (the JAX suite's nu > 1 pin)."""
    import torch

    def rnd(*s):
        return 0.3 * torch.randn(s, generator=gen, dtype=torch.float64)

    ru = rnd(B, T_, nu)
    A = rnd(B, T_, nx, nx)
    Q = A @ A.mT + 2 * torch.eye(nx, dtype=torch.float64)
    Br = rnd(B, T_, nu, nu)
    R = Br @ Br.mT + 2 * torch.eye(nu, dtype=torch.float64)
    M = 0.1 * rnd(B, T_, nx, nu)
    fx = rnd(B, T_, nx, nx)
    fu = rnd(B, T_, nx, nu)
    Xa = rnd(B, nx, nx)
    XT = Xa @ Xa.mT + torch.eye(nx, dtype=torch.float64)
    cx = rnd(B, T_, nx)
    lam_T = rnd(B, nx)
    trial = tuple(a.to(device, dtype).contiguous()
                  for a in (ru, Q, R, M, fx, fu, XT))
    costate = tuple(a.to(device, dtype).contiguous() for a in (cx, fx, lam_T))
    return trial, costate


def compare_trial(args, tol, pred_rtol, label):
    from ipoc_tpu_torch.ops.cuda.seq_newton import (
        seq_newton_trial_batched,
        seq_newton_trial_plain,
    )

    du_k, dx_k, pred_k, ok_k = seq_newton_trial_batched(*args)
    du_p, dx_p, pred_p, ok_p = seq_newton_trial_plain(*args)
    ok_same = bool((ok_k == ok_p).all())
    check(ok_same, f"{label}: ok flags differ")
    check(bool(ok_p.any()), f"{label}: no feasible lane to compare")
    # Errors over the lanes both versions call feasible (an infeasible
    # lane's step may be NaN in both).
    du_k, du_p, dx_k, dx_p = du_k[ok_p], du_p[ok_p], dx_k[ok_p], dx_p[ok_p]
    pred_k, pred_p = pred_k[ok_p], pred_p[ok_p]
    scale = float(du_p.abs().max()) + 1e-30
    err = max(float((du_k - du_p).abs().max()),
              float((dx_k - dx_p).abs().max()))
    pred_err = float(((pred_k - pred_p).abs()
                      / (pred_p.abs() + 1e-30)).max())
    check(err <= tol * scale, f"{label}: |d(du,dx)| {err} > {tol}*{scale}")
    check(pred_err <= pred_rtol, f"{label}: pred rel err {pred_err}")
    return {"max_abs_err": err, "scale": scale, "pred_max_rel_err": pred_err,
            "ok_equal": ok_same, "ok_frac": float(ok_k.float().mean())}


def compare_costates(args, tol, label):
    from ipoc_tpu_torch.ops.cuda.seq_newton import (
        seq_costates_batched,
        seq_costates_plain,
    )

    lam_k = seq_costates_batched(*args)
    lam_p = seq_costates_plain(*args)
    scale = float(lam_p.abs().max()) + 1e-30
    err = float((lam_k - lam_p).abs().max())
    check(err <= tol * scale, f"{label}: |d lam| {err} > {tol}*{scale}")
    return {"max_abs_err": err, "scale": scale}


def phase_device():
    import torch

    from ipoc_tpu_torch.ops import cuda

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    power = smi.stdout.strip().splitlines()[0]
    print(power, flush=True)
    t0 = time.perf_counter()
    cuda.library()
    build_s = time.perf_counter() - t0
    cuda.disable_tf32()
    emit({"phase": "0", "device": name, "nvidia_smi": power,
          "count": torch.cuda.device_count(), "kernel_build_s": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, power


def phase_kernels(pool, dev):
    import torch

    from ipoc_tpu_torch.ops.cuda.seq_newton import (
        seq_costates_batched,
        seq_costates_plain,
        seq_newton_trial_batched,
        seq_newton_trial_plain,
    )

    out = {"phase": "A"}
    record = {}
    for dtype, tol, prt, ltol in ((torch.float64, 1e-10, 1e-10, 1e-12),
                                  (torch.float32, 2e-5, 1e-4, 1e-5)):
        tag = str(dtype).split(".")[-1]
        trial, costate = slice_stage_data(pool, dtype, dev)
        out[f"cartpole_{tag}_trial"] = compare_trial(trial, tol, prt,
                                                     f"cartpole {tag}")
        out[f"cartpole_{tag}_costates"] = compare_costates(
            costate, ltol, f"cartpole {tag} costates")
        ru, Q, R, M, fx, fu, XT = trial
        eye = torch.eye(R.shape[-1], dtype=dtype, device=dev)
        bad = (ru, Q, (R - 1e3 * eye).contiguous(), M, fx, fu, XT)
        ok_k = seq_newton_trial_batched(*bad)[3]
        ok_p = seq_newton_trial_plain(*bad)[3]
        check(not bool(ok_k.any()) and not bool(ok_p.any()),
              f"R - 1e3 I must give ok=False ({tag})")
        out[f"indefinite_R_{tag}_ok_any"] = bool(ok_k.any())
        gen = torch.Generator().manual_seed(SEED)
        trial32, costate32 = random_stage_data(gen, LANES, T, 3, 2, dtype,
                                               dev)
        out[f"random_nx3_nu2_{tag}_trial"] = compare_trial(
            trial32, tol, prt, f"random nx=3 nu=2 {tag}")
        out[f"random_nx3_{tag}_costates"] = compare_costates(
            costate32, ltol, f"random nx=3 {tag} costates")
        if dtype == torch.float32:
            record["seq_newton_trial"] = {
                "max_abs_err": out[f"cartpole_{tag}_trial"]["max_abs_err"],
                "ms": cuda_ms(lambda: seq_newton_trial_batched(*trial), 20),
                "plain_ms": cuda_ms(lambda: seq_newton_trial_plain(*trial),
                                    5),
            }
            record["seq_costates"] = {
                "max_abs_err": out[f"cartpole_{tag}_costates"]["max_abs_err"],
                "ms": cuda_ms(lambda: seq_costates_batched(*costate), 20),
                "plain_ms": cuda_ms(lambda: seq_costates_plain(*costate), 5),
            }
    out["timing"] = {k: {"ms": v["ms"], "plain_ms": v["plain_ms"]}
                     for k, v in record.items()}
    out["timing_shape"] = f"B={LANES}, T={T}, float32, median of CUDA events"
    emit(out)
    return record


def phase_card_vs_cpu(pool64, dev):
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream
    from ipoc_tpu_torch.models import cartpole

    cfg = BATCH_CONFIG.replace(newton_impl="seq")
    ocp = cartpole.make_ocp(DT)
    u, x0 = (a[:256] for a in pool64)
    t0 = time.perf_counter()
    card = solve_stream(ocp, u.to(dev), x0.to(dev), cfg, lanes=64,
                        refill_every=REFILL)
    card.iterations.cpu()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = solve_stream(ocp, u, x0, cfg, lanes=64, refill_every=REFILL)
    t_cpu = time.perf_counter() - t0
    it_card, it_cpu = card.iterations.cpu(), cpu.iterations
    same = it_card == it_cpu
    n_diff = int((~same).sum())
    du = float((card.controls.cpu()[same] - cpu.controls[same]).abs().max())
    # Lanes whose iteration counts differ: their converged raw costs.
    diff = (~same).nonzero().squeeze(1)
    c_card = raw_costs(ocp, card.controls.cpu()[diff], x0[diff])
    c_cpu = raw_costs(ocp, cpu.controls[diff], x0[diff])
    emit({"phase": "B", "scenarios": 256, "lanes": 64, "dtype": "float64",
          "lanes_with_different_iterations": n_diff,
          "different_lanes": [
              {"scenario": int(i), "iterations_card": int(it_card[i]),
               "iterations_cpu": int(it_cpu[i]), "raw_cost_card": float(a),
               "raw_cost_cpu": float(b)}
              for i, a, b in zip(diff, c_card, c_cpu)],
          "max_abs_du_on_equal_lanes": du, "steps_card": card.steps,
          "steps_cpu": cpu.steps, "wall_s_card": t_card, "wall_s_cpu": t_cpu})
    check(n_diff <= 0.01 * 256, f"{n_diff} of 256 lanes differ in iterations")
    check(du <= 1e-6, f"controls differ by {du} on equal lanes")


def raw_costs(ocp, u, x0):
    import torch

    from ipoc_tpu_torch.utils.integrators import rollout

    x = rollout(ocp.dynamics, u, x0)
    return ocp.total_cost(x, u, torch.tensor(1e-9, dtype=u.dtype,
                                             device=u.device))


def busy_share(ocp, u, x0, cfg, warm_iters=90, window=5):
    """Device busy share over a window of lane iterations on the full lane
    batch, after ``warm_iters`` iterations (lanes then sit in several
    barrier stages): device time from the profiler over the window divided
    by the host-clock time of the same window run without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ipoc_tpu_torch.solvers.ip_newton import flat_lane_init, flat_lane_iter

    lane = flat_lane_init(ocp, u, x0, cfg)
    for _ in range(warm_iters):
        lane = flat_lane_iter(ocp, lane, cfg, ~lane.done)

    def run():
        ln = lane
        for _ in range(window):
            ln = flat_lane_iter(ocp, ln, cfg, ~ln.done)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    # Kernel rows only: an operator's row carries its kernels' device time
    # too, so summing every row would count it twice.
    dev_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                 if evt.device_type == DeviceType.CUDA)
    return (dev_us / wall_us if dev_us > 0 else None), wall_us / window / 1e3


def phase_bench_size(pool32, pool64, dev):
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.ops import cuda

    cfg = BATCH_CONFIG.replace(newton_impl="seq")
    ocp = cartpole.make_ocp(DT)
    u, x0 = (a.to(dev) for a in pool32)
    # Warm-up: a small stream (library load, allocator, torch.func caches).
    solve_stream(ocp, u[:256], x0[:256], cfg, lanes=256,
                 refill_every=REFILL).iterations.cpu()

    cuda.reset_launches()
    t0 = time.perf_counter()
    sol = solve_stream(ocp, u, x0, cfg, lanes=LANES, refill_every=REFILL)
    sol.iterations.cpu()  # waits for the device
    wall = time.perf_counter() - t0
    counts = dict(cuda.launches)

    costs = raw_costs(ocp, sol.controls, x0).double().cpu()
    iters = sol.iterations.cpu().double()
    finite = bool(torch.isfinite(sol.controls).all())
    umax = float(sol.controls.abs().max())
    nonfinite = float((~torch.isfinite(costs)).double().mean())

    # f32 against f64 on the card, first 512 scenarios (no hard check).
    u64, x64 = (a[:512].to(dev) for a in pool64)
    sol64 = solve_stream(ocp, u64, x64, cfg, lanes=512, refill_every=REFILL)
    c64 = raw_costs(ocp, sol64.controls, x64).cpu()
    c32 = costs[:512]
    agree = float(((c32 - c64).abs() <= 1e-3 * c64.abs()).double().mean())

    busy, step_ms = busy_share(ocp, u[:LANES], x0[:LANES], cfg)
    emit({"phase": "C", "model": "cartpole", "horizon": T, "dtype": "float32",
          "config": "BATCH_CONFIG.replace(newton_impl='seq')",
          "lanes": LANES, "refill_every": REFILL, "scenarios": POOL,
          "pool_note": "4 x lanes (the bench's pool is 32 x lanes) to keep "
                       "the smoke inside its time limit",
          "wall_s": wall, "solves_per_s": POOL / wall, "steps": sol.steps,
          "mean_iterations": float(iters.mean()),
          "max_iterations": int(iters.max()),
          "mean_raw_cost": float(costs.mean()),
          "frac_nonfinite_cost": nonfinite, "launches": counts,
          "max_abs_u": umax,
          "frac_f32_cost_within_1e-3_of_f64_first512": agree,
          "device_busy_share": busy,
          "busy_window": "5 iterations of 4096 lanes after 90, profiler "
                         "device time / unprofiled host time",
          "window_ms_per_iteration": step_ms})
    check(finite, "non-finite controls")
    check(umax <= 50.0 + 1e-4, f"|u| = {umax} exceeds the bound 50")
    check(nonfinite == 0.0, f"non-finite raw cost share {nonfinite}")
    check(counts["seq_newton_trial"] > 0 and counts["seq_costates"] > 0,
          f"a kernel of the path never launched: {counts}")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="0ABC",
                        help="subset of phases to run (default: 0ABC)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.solvers.batched import make_batch

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name, _ = phase_device()

    # The bench's pool recipe (bench.py make_batch call), on the CPU; the
    # float64 runs take the float32 pool's exact values.
    pool32 = make_batch(torch.Generator().manual_seed(SEED),
                        cartpole.initial_state(torch.float32), POOL, T, 1,
                        state_scale=0.01, control_scale=0.1)
    pool64 = tuple(a.double() for a in pool32)
    record = {}
    if "A" in args.phases:
        record = phase_kernels(tuple(a[:LANES] for a in pool32), dev)
    if "B" in args.phases:
        phase_card_vs_cpu(pool64, dev)
    counts = {}
    if "C" in args.phases:
        counts = phase_bench_size(pool32, pool64, dev)
    replaces = {
        "seq_newton_trial": "ipoc_tpu/ops/pallas/seq_newton_kernel.py:557",
        "seq_costates": "ipoc_tpu/ops/pallas/seq_newton_kernel.py:622",
    }
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": "ipoc_tpu_torch/csrc/seq_newton.cu",
         "replaces": replaces[k], "launches": counts.get(k),
         **record.get(k, {})}
        for k in replaces]})
    print(f"# total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
