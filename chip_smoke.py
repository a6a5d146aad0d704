#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipoc_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ipoc_tpu_torch/csrc`` (the seq
library and one fused library per model, generated from the model and
compiled by parallel ``nvcc`` calls) and then runs its phases, each printing
one JSON line:

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
     32, a pool of 4 x 4096 scenarios;
  D. the four fused kernels against their plain versions on the fused
     slice's data (cartpole T=100, the pool's first 4096 lanes, at bp=0.1
     and at bp=0.004), float64 then float32, and on pendulum at B=256;
     then each kernel's time beside its plain version's;
  E. ``solve_stream`` with ``BATCH_CONFIG`` (the packed fused stream) on
     256 cartpole scenarios in float64: the card against the CPU;
  F. the packed fused stream at the bench's width: cartpole H=100,
     float32, ``BATCH_CONFIG`` unmodified, 4096 lanes, refill every 32, a
     pool of 4 x 4096 scenarios, with the device busy share and every
     kernel's launch count; then the first 512 raw costs against the
     float64 solve on the card.

Phases B and E run last: their CPU halves run meanwhile, in one child
process each, started at the beginning.  A failed check fails its phase;
the other phases still run, and any failure exits non-zero.  The
line before the last holds the kernels' record; the last line is
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset of A-F
(default: all; phase 0, the device and the build, always runs).  Without a card, or outside a checkout of the repository, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
import traceback

SEED = 1
T = 100
DT = 1.0 / T
LANES = 4096
POOL = 4 * LANES  # the bench's pool is 32 x lanes; 4 x keeps this smoke short
REFILL = 32
# Phase D's float32 tolerance (kernel against plain version, relative to
# each output's largest entry): the two evaluate the same float32 program
# in another operation order (and the kernel contracts products into FMAs),
# and the backward sweep carries rounding through T=100 Riccati steps.
F32_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean time per call in ms, from CUDA events around ``reps``
    back-to-back calls after one warm call: the queue stays full, so the
    host's work between launches is hidden wherever the card is slower."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    from ipoc_tpu_torch.models import cartpole, pendulum
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import fused_iter

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    power = smi.stdout.strip().splitlines()[0]
    print(power, flush=True)
    t0 = time.perf_counter()
    specs = [cuda.SEQ_NEWTON,
             fused_iter.model_spec(cartpole.make_ocp(DT), 4, 1),
             fused_iter.model_spec(pendulum.make_ocp(DT), 2, 1)]
    codegen_s = time.perf_counter() - t0
    paths = cuda.build_all(specs)
    build_s = time.perf_counter() - t0
    cuda.library()
    cuda.disable_tf32()
    emit({"phase": "0", "device": name, "nvidia_smi": power,
          "count": torch.cuda.device_count(), "codegen_s": codegen_s,
          "kernel_build_s": build_s,
          "libraries": [str(p.relative_to(p.parents[3])) for p in paths],
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
    out["timing_shape"] = (f"B={LANES}, T={T}, float32, CUDA events "
                           "around back-to-back calls")
    emit(out)
    return record


CARD_VS_CPU = {"B": "BATCH_CONFIG.replace(newton_impl='seq')",
               "E": "BATCH_CONFIG"}


def card_vs_cpu_config(phase):
    from ipoc_tpu_torch import BATCH_CONFIG

    return (BATCH_CONFIG.replace(newton_impl="seq") if phase == "B"
            else BATCH_CONFIG)


def cpu_reference_solve(phase):
    """The CPU half of phase B or E: ``solve_stream`` with the plain
    versions on the 256 float64 scenarios.  Runs in a child process
    (``--cpu-reference B|E``, one thread) while the card works through the
    other phases; returns ``(controls, iterations, steps, wall_s)``."""
    import torch

    from ipoc_tpu_torch import solve_stream
    from ipoc_tpu_torch.models import cartpole

    torch.set_num_threads(1)
    u, x0 = (a[:256].double() for a in make_pool(cartpole, POOL,
                                                  torch.float32))
    t0 = time.perf_counter()
    sol = solve_stream(cartpole.make_ocp(DT), u, x0,
                       card_vs_cpu_config(phase), lanes=64,
                       refill_every=REFILL)
    return (sol.controls, sol.iterations, sol.steps,
            time.perf_counter() - t0)


def phase_card_vs_cpu(phase, pool64, dev, cpu_ref):
    """Phases B (seq stream) and E (packed fused stream): 256 float64
    scenarios through 64 lanes, the card (kernels) against the CPU (plain
    versions, ``cpu_ref``)."""
    from ipoc_tpu_torch import solve_stream
    from ipoc_tpu_torch.models import cartpole

    ocp = cartpole.make_ocp(DT)
    u, x0 = (a[:256] for a in pool64)
    t0 = time.perf_counter()
    card = solve_stream(ocp, u.to(dev), x0.to(dev), card_vs_cpu_config(phase),
                        lanes=64, refill_every=REFILL)
    card.iterations.cpu()
    t_card = time.perf_counter() - t0
    u_cpu, it_cpu, steps_cpu, t_cpu = cpu_ref
    u_card, it_card = card.controls.cpu(), card.iterations.cpu()
    same = it_card == it_cpu
    n_diff = int((~same).sum())
    du_lane = (u_card - u_cpu).abs().flatten(1).amax(1)
    du = float(du_lane[same].max())
    # Lanes whose iteration counts or controls differ: converged raw costs.
    odd = (~same | (du_lane > 1e-9)).nonzero().squeeze(1)
    c_card = raw_costs(ocp, u_card[odd], x0[odd])
    c_cpu = raw_costs(ocp, u_cpu[odd], x0[odd])
    emit({"phase": phase, "config": CARD_VS_CPU[phase], "scenarios": 256,
          "lanes": 64, "dtype": "float64",
          "lanes_with_different_iterations": n_diff,
          "max_abs_du_on_equal_lanes": du,
          "equal_lanes_with_du_above": {
              f"{t:g}": int((same & (du_lane > t)).sum())
              for t in (1e-9, 1e-8, 1e-7, 1e-6)},
          "lanes_differing_above_1e-9": [
              {"scenario": int(i), "iterations_card": int(it_card[i]),
               "iterations_cpu": int(it_cpu[i]),
               "max_abs_du": float(du_lane[i]), "raw_cost_card": float(a),
               "raw_cost_cpu": float(b),
               "raw_cost_rel_diff": float(abs(a - b) / abs(b))}
              for i, a, b in zip(odd, c_card, c_cpu)],
          "lanes_agreeing": int((same & (du_lane <= 1e-6)).sum()),
          "steps_card": card.steps, "steps_cpu": steps_cpu,
          "wall_s_card": t_card, "wall_s_cpu_child": t_cpu})
    # A lane agrees if its iteration count is equal and its controls are
    # within 1e-6; at least 99% must.  Rounding differences between the
    # kernels and the plain versions can flip an accept decision or, over
    # some 300 Newton steps that stop at the solver's tolerance, move the
    # controls along a flat valley: every lane's converged raw cost must
    # still agree to the goldens' rtol 1e-8.
    agree = same & (du_lane <= 1e-6)
    n_bad = 256 - int(agree.sum())
    rel = float(((c_card - c_cpu).abs() / c_cpu.abs()).max()) if len(odd) \
        else 0.0
    check(n_bad <= 0.01 * 256,
          f"{n_bad} of 256 lanes differ in iterations or controls")
    check(rel <= 1e-8, f"converged raw costs differ by {rel} relative")


def raw_costs(ocp, u, x0):
    import torch

    from ipoc_tpu_torch.utils.integrators import rollout

    x = rollout(ocp.dynamics, u, x0)
    return ocp.total_cost(x, u, torch.tensor(1e-9, dtype=u.dtype,
                                             device=u.device))


def busy_share(lane, step, warm_iters=90, window=10):
    """Device busy share over a window of lane iterations on the full lane
    batch, after ``warm_iters`` iterations (lanes then sit in several
    barrier stages): device time of the profiler's kernel rows over the
    window divided by the host-clock time of the same window run without
    the profiler.  Returns ``(share, ms per iteration, device ms per
    iteration of the largest kernels)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm_iters):
        lane = step(lane)

    def run():
        ln = lane
        for _ in range(window):
            ln = step(ln)
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
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key.split("(")[0][:60]
            per_kernel[key] = (per_kernel.get(key, 0.0)
                               + e.self_device_time_total / window / 1e3)
    dev_ms = sum(per_kernel.values())
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    step_ms = wall_us / window / 1e3
    return (dev_ms / step_ms if dev_ms > 0 else None), step_ms, top


def phase_stream_at_width(phase, cfg, cfg_name, pool32, pool64, dev,
                          lane_fns, openings=()):
    """Phases C (seq) and F (packed fused): ``solve_stream`` at the bench's
    width on the whole pool, float32, its launch counts, the quality of
    what comes out, the first 512 raw costs against the float64 solve on
    the card, and the device busy share over a window of ``lane_fns =
    (open lanes, one lane iteration)``.  ``openings`` is a list that grows
    by one per lane opening; the record counts those of the measured run.
    Returns the emitted record."""
    import torch

    from ipoc_tpu_torch import solve_stream
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.ops import cuda

    ocp = cartpole.make_ocp(DT)
    u, x0 = (a.to(dev) for a in pool32)
    # Warm-up: a small stream (library load, allocator, torch.func caches).
    solve_stream(ocp, u[:256], x0[:256], cfg, lanes=256,
                 refill_every=REFILL).iterations.cpu()

    cuda.reset_launches()
    n_open = len(openings)
    t0 = time.perf_counter()
    sol = solve_stream(ocp, u, x0, cfg, lanes=LANES, refill_every=REFILL)
    sol.iterations.cpu()  # waits for the device
    wall = time.perf_counter() - t0
    counts = dict(cuda.launches)
    n_open = len(openings) - n_open

    costs = raw_costs(ocp, sol.controls, x0).double().cpu()
    iters = sol.iterations.cpu().double()
    finite = bool(torch.isfinite(sol.controls).all())
    umax = float(sol.controls.abs().max())
    nonfinite = float((~torch.isfinite(costs)).double().mean())

    u64, x64 = (a[:512].to(dev) for a in pool64)
    sol64 = solve_stream(ocp, u64, x64, cfg, lanes=512, refill_every=REFILL)
    c64 = raw_costs(ocp, sol64.controls, x64).cpu()
    agree = float(((costs[:512] - c64).abs() <= 1e-3 * c64.abs())
                  .double().mean())

    open_lanes, step = lane_fns
    busy, step_ms, top = busy_share(open_lanes(ocp, u[:LANES], x0[:LANES]),
                                    lambda ln: step(ocp, ln))
    record = {
        "phase": phase, "model": "cartpole", "horizon": T,
        "dtype": "float32", "config": cfg_name, "lanes": LANES,
        "refill_every": REFILL, "scenarios": POOL,
        "pool_note": "4 x lanes (the bench's pool is 32 x lanes) to keep "
                     "the smoke inside its time limit",
        "wall_s": wall, "solves_per_s": POOL / wall, "steps": sol.steps,
        "ms_per_step_whole_run": wall / max(sol.steps, 1) * 1e3,
        "mean_iterations": float(iters.mean()),
        "max_iterations": int(iters.max()),
        "mean_raw_cost": float(costs.mean()),
        "frac_nonfinite_cost": nonfinite, "launches": counts,
        "lane_openings": n_open, "max_abs_u": umax,
        "frac_f32_cost_within_1e-3_of_f64_first512": agree,
        "device_busy_share": busy,
        "busy_window": f"10 iterations of {LANES} lanes after 90, profiler "
                       "kernel-row device time / unprofiled host time",
        "window_ms_per_iteration": step_ms,
        "window_device_ms_per_iteration_top_kernels": top}
    emit(record)
    check(finite, "non-finite controls")
    check(umax <= 50.0 + 1e-4, f"|u| = {umax} exceeds the bound 50")
    check(nonfinite == 0.0, f"non-finite raw cost share {nonfinite}")
    return record


def phase_bench_size(pool32, pool64, dev):
    """Phase C: the seq stream at the bench's width."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.solvers.ip_newton import flat_lane_init, flat_lane_iter

    cfg = BATCH_CONFIG.replace(newton_impl="seq")
    rec = phase_stream_at_width(
        "C", cfg, "BATCH_CONFIG.replace(newton_impl='seq')", pool32, pool64,
        dev, (lambda ocp, u, x0: flat_lane_init(ocp, u, x0, cfg),
              lambda ocp, ln: flat_lane_iter(ocp, ln, cfg, ~ln.done)))
    counts = rec["launches"]
    check(counts["seq_newton_trial"] > 0 and counts["seq_costates"] > 0,
          f"a kernel of the path never launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# The packed fused stream (BATCH_CONFIG): phases D, E, F
# ---------------------------------------------------------------------------

def compare_out(label, got, ref, tol):
    """``got`` against ``ref``: equal NaN/inf patterns and, on the finite
    entries, ``max |got - ref| <= tol * max |ref|``.  Returns ``(max abs
    error, max abs error / max |ref|)``."""
    import torch

    check(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
    got, ref = got.double(), ref.double()
    check(torch.equal(torch.isnan(got), torch.isnan(ref)),
          f"{label}: NaN patterns differ")
    inf = torch.isinf(ref)
    check(torch.equal(torch.isinf(got), inf)
          and torch.equal(got[inf], ref[inf]), f"{label}: inf entries differ")
    fin = torch.isfinite(ref)
    if not bool(fin.any()):
        return 0.0, 0.0
    scale = float(ref[fin].abs().max()) + 1e-30
    err = float((got[fin] - ref[fin]).abs().max())
    check(err <= tol * scale, f"{label}: max err {err} > {tol} * {scale}")
    return err, err / scale


def fused_inputs(pool, dtype, device, bp, rp=100.0):
    """Packed lane inputs of the fused kernels from the pool (controls
    ``u``, initial states, a second control set for the predictor), in the
    batch-last layout, with the open-loop trajectory and the Levenberg
    parameter the stream would use at this iterate."""
    import torch

    u_all, x0_all = (a.to(device, dtype) for a in pool)
    B = u_all.shape[0] // 2
    u = u_all[:B].permute(1, 2, 0).contiguous()
    u_other = u_all[B:2 * B].permute(1, 2, 0).contiguous()
    x0 = x0_all[:B].T.contiguous()
    bpt = torch.full((B,), bp, dtype=dtype, device=device)
    return u, u_other, x0, bpt, rp


def compare_fused(ocp, pool, dtype, device, bp, tol, label):
    """All four kernels against their plain versions on one input set;
    returns each kernel's largest absolute and relative error over its
    outputs."""
    import torch

    from ipoc_tpu_torch.ops import fused_iter as tf

    u, u_other, x0, bpt, rp = fused_inputs(pool, dtype, device, bp)
    up = (u + 0.2 * (u - u_other)).contiguous()
    ref_roll = tf.rollout_cost_plain(ocp, u, x0, bpt)
    xs, xT, _, cunsq = ref_roll
    reg = rp * torch.clamp(torch.sqrt(cunsq), min=1e-6)
    got_it = tf.fused_newton_iter_packed(ocp, xs, xT, u, bpt, reg)
    ref_it = tf.fused_newton_iter_plain(ocp, xs, xT, u, bpt, reg)
    names = ("tu", "tx", "txT", "cost", "nc", "mc", "dv", "piv", "hu", "cun")
    # Each kernel's outputs: (name, got, ref).
    outputs = {
        "rollout_cost": zip(range(4), tf.rollout_cost_packed(ocp, u, x0, bpt),
                            ref_roll),
        "fused_bwd": [(n, got_it[i], ref_it[i]) for i, n in enumerate(names)
                      if n in ("cost", "dv", "piv", "hu")],
        "fused_fwd": [(n, got_it[i], ref_it[i]) for i, n in enumerate(names)
                      if n not in ("cost", "dv", "piv", "hu")],
        "transition": zip(range(8), tf.transition_packed(ocp, u, up, x0, bpt),
                          tf.transition_plain(ocp, u, up, x0, bpt)),
    }
    out = {}
    for kernel, triples in outputs.items():
        errs = [compare_out(f"{label} {kernel}[{n}]", g, r, tol)
                for n, g, r in triples]
        out[kernel] = {"max_abs_err": max(e[0] for e in errs),
                       "max_rel_err": max(e[1] for e in errs)}
    ok = [torch.isfinite(o[7]) & (o[7] > 0) & torch.isfinite(o[6])
          for o in (got_it, ref_it)]
    check(torch.equal(ok[0], ok[1]), f"{label}: ok flags differ")
    out["ok_frac"] = float(ok[1].double().mean())
    out["lanes"] = u.shape[-1]
    return out


def phase_fused_kernels(pool32, dev):
    """Phase D: the four fused kernels against their plain versions."""
    import torch

    from ipoc_tpu_torch.models import cartpole, pendulum
    from ipoc_tpu_torch.ops import fused_iter as tf

    out = {"phase": "D"}
    cp = cartpole.make_ocp(DT)
    pool = tuple(a[:2 * LANES] for a in pool32)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, F32_TOL)):
        tag = str(dtype).split(".")[-1]
        for bp in (0.1, 0.004):
            out[f"cartpole_{tag}_bp{bp}"] = compare_fused(
                cp, pool, dtype, dev, bp, tol, f"cartpole {tag} bp={bp}")
        pd = pendulum.make_ocp(DT)
        pp = make_pool(pendulum, 512, torch.float32, seed=SEED + 1)
        out[f"pendulum_{tag}"] = compare_fused(
            pd, pp, dtype, dev, 0.1, tol, f"pendulum {tag}")

    # Times at the slice's shape (cartpole, B=4096, T=100, float32).
    u, u_other, x0, bpt, rp = fused_inputs(pool, torch.float32, dev, 0.1)
    xs, xT, _, cunsq = tf.rollout_cost_plain(cp, u, x0, bpt)
    reg = rp * torch.clamp(torch.sqrt(cunsq), min=1e-6)
    up = (u + 0.2 * (u - u_other)).contiguous()
    Kk = tf.fused_bwd_launch(cp, xs, xT, u, bpt, reg)[0]
    plain_iter = cuda_ms(lambda: tf.fused_newton_iter_plain(
        cp, xs, xT, u, bpt, reg), 3)
    record = {
        "fused_bwd": {
            "ms": cuda_ms(lambda: tf.fused_bwd_launch(
                cp, xs, xT, u, bpt, reg), 20),
            "plain_ms": plain_iter},
        "fused_fwd": {
            "ms": cuda_ms(lambda: tf.fused_fwd_launch(
                cp, xs, xT, u, bpt, Kk), 20),
            "plain_ms": plain_iter},
        "rollout_cost": {
            "ms": cuda_ms(lambda: tf.rollout_cost_packed(cp, u, x0, bpt), 20),
            "plain_ms": cuda_ms(lambda: tf.rollout_cost_plain(cp, u, x0, bpt),
                                3)},
        "transition": {
            "ms": cuda_ms(lambda: tf.transition_packed(cp, u, up, x0, bpt),
                          20),
            "plain_ms": cuda_ms(lambda: tf.transition_plain(
                cp, u, up, x0, bpt), 3)},
    }
    f32 = [out[f"cartpole_float32_bp{bp}"] for bp in (0.1, 0.004)]
    for k in tf.KERNELS:
        record[k]["max_abs_err"] = max(o[k]["max_abs_err"] for o in f32)
    out["timing"] = record
    out["timing_shape"] = (f"B={LANES}, T={T}, float32, CUDA events "
                           "around back-to-back calls; the plain time of "
                           "fused_bwd and "
                           "fused_fwd is the plain fused iteration, which "
                           "covers both launches")
    out["errors"] = ("largest absolute error, and error / largest |plain|, "
                     "over each kernel's outputs")
    out["float32_tolerance"] = F32_TOL
    emit(out)
    return record


def phase_fused_bench_size(pool32, pool64, dev):
    """Phase F: the packed fused stream at the bench's width; every
    per-iteration kernel launches once per step, rollout_cost once per
    lane opening, and 99% of the first 512 float32 raw costs are within
    1e-3 of the float64 solve."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.solvers import packed_stream as ps

    cfg = BATCH_CONFIG

    def open_lanes(ocp, u, x0):
        bp0 = torch.full((u.shape[0],), cfg.bp_init, dtype=u.dtype,
                         device=u.device)
        return ps.packed_lane_init(ocp, u.permute(1, 2, 0).contiguous(),
                                   x0.T.contiguous(), bp0,
                                   torch.full_like(bp0, cfg.reg_init), cfg)

    opened = []
    real_init = ps.packed_lane_init

    def counting_init(*a, **k):
        opened.append(1)
        return real_init(*a, **k)

    ps.packed_lane_init = counting_init
    try:
        rec = phase_stream_at_width(
            "F", cfg, "BATCH_CONFIG", pool32, pool64, dev,
            (open_lanes, lambda ocp, ln: ps.packed_lane_iter(
                ocp, ln, cfg, ~ln.done)), opened)
    finally:
        ps.packed_lane_init = real_init
    counts, steps = rec["launches"], rec["steps"]
    for k in ("fused_bwd", "fused_fwd", "transition"):
        check(counts[k] == steps, f"{k} launched {counts[k]} times in "
              f"{steps} steps")
    check(counts["rollout_cost"] == rec["lane_openings"] > 0,
          f"rollout_cost launched {counts['rollout_cost']} times for "
          f"{rec['lane_openings']} lane openings")
    check(rec["frac_f32_cost_within_1e-3_of_f64_first512"] >= 0.99,
          "fewer than 99% of 512 float32 costs within 1e-3 of float64")
    return counts


def make_pool(model, n, dtype, seed=SEED):
    """The bench's pool recipe (bench.py make_batch call), on the CPU."""
    import torch

    from ipoc_tpu_torch.solvers.batched import make_batch

    return make_batch(torch.Generator().manual_seed(seed),
                      model.initial_state(dtype), n, T, 1,
                      state_scale=0.01, control_scale=0.1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="ABCDEF",
                        help="subset of phases A-F to run after phase 0, "
                             "which always runs (default: ABCDEF)")
    parser.add_argument("--cpu-reference", choices=list(CARD_VS_CPU),
                        help=argparse.SUPPRESS)  # a child process
    args = parser.parse_args(argv)

    import torch

    if args.cpu_reference:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        pickle.dump(cpu_reference_solve(args.cpu_reference),
                    sys.stdout.buffer)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ipoc_tpu_torch.models import cartpole

    from ipoc_tpu_torch.ops import fused_iter

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    children = {}

    def reference(phase):
        out, _ = children[phase].communicate()
        check(children[phase].returncode == 0,
              f"the CPU reference process of phase {phase} failed")
        return pickle.loads(out)

    failures, record, counts = [], {}, {}

    def run(phase, fn, *a):
        if phase not in args.phases:
            return None
        t0 = time.perf_counter()
        try:
            return fn(*a)
        except Exception as exc:  # report, go on with the other phases
            failures.append(f"phase {phase}: {exc!r}")
            traceback.print_exc()
            return None
        finally:
            print(f"# phase {phase}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)

    try:
        name, _ = phase_device()
        # The CPU halves of phases B and E run meanwhile, one child process
        # each (started after the build, which they would slow down).
        children.update({
            ph: subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu-reference",
                 ph], stdout=subprocess.PIPE)
            for ph in CARD_VS_CPU if ph in args.phases})
        # The bench's pool recipe (bench.py make_batch call), on the CPU;
        # the float64 runs take the float32 pool's exact values.
        pool32 = make_pool(cartpole, POOL, torch.float32)
        pool64 = tuple(a.double() for a in pool32)
        # Phases B and E last: their CPU halves run meanwhile.
        record.update(run("A", phase_kernels,
                          tuple(a[:LANES] for a in pool32), dev) or {})
        counts.update({k: v for k, v in (run(
            "C", phase_bench_size, pool32, pool64, dev) or {}).items()
            if k.startswith("seq")})
        record.update(run("D", phase_fused_kernels, pool32, dev) or {})
        counts.update({k: v for k, v in (run(
            "F", phase_fused_bench_size, pool32, pool64, dev) or {}).items()
            if k in fused_iter.KERNELS})
        for ph in CARD_VS_CPU:
            run(ph, lambda ph=ph: phase_card_vs_cpu(ph, pool64, dev,
                                                    reference(ph)))
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    pallas = "ipoc_tpu/ops/pallas/"
    kernels = {
        "seq_newton_trial": ("seq_newton.cu", "seq_newton_kernel.py:557"),
        "seq_costates": ("seq_newton.cu", "seq_newton_kernel.py:622"),
        "fused_bwd": ("fused_iter.cuh", "fused_iter_kernel.py:1261"),
        "fused_fwd": ("fused_iter.cuh", "fused_iter_kernel.py:1298"),
        "rollout_cost": ("fused_iter.cuh", "fused_iter_kernel.py:1956"),
        "transition": ("fused_iter.cuh", "fused_iter_kernel.py:2053"),
    }
    print(f"# total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    if failures:
        print("chip_smoke: FAILED\n" + "\n".join(failures), file=sys.stderr)
        return 1
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"ipoc_tpu_torch/csrc/{src}",
         "replaces": pallas + rep, "launches": counts.get(k),
         **record.get(k, {})}
        for k, (src, rep) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
