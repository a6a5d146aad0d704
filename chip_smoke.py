#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipoc_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ipoc_tpu_torch/csrc`` (the seq
and parallel-in-time libraries and one fused library per model and time
step, generated from the model: cartpole at dt 0.01, 0.04, 0.001 and 0.004,
pendulum at 0.01, the planar quadrotor at 0.025 and 0.1, the unicycle at
0.01 and 0.04, each model traced
in a worker process of its own; parallel ``nvcc`` calls, one per source,
those of the seq and parallel-in-time libraries started before the
tracing) and then runs its phases, each printing one JSON line:

  0. the device: its name, power limit, the kernels' build time, the
     registers and spills ``ptxas`` reports for the mega kernel, the
     merged trial and the three parallel-in-time kernels (the trial per
     lane count, with its resident blocks per SM and shared memory per
     block), and the mega kernel's and the merged trial's stage ring
     (stages per slot W, slots S, dynamic shared memory per block); for
     the kernels that spread a scenario over a group of lanes (the seq
     trial per shape; the fused backward and forward sweeps and the
     transition of cartpole and pendulum), per dtype, registers, spills,
     shared memory per block, resident blocks per SM and scenarios per
     block (checked to hold a B=4096 launch in one wave), and the SASS of
     their stage loops; the rollout-cost kernel's group schedule among
     them, and the value scan per lane count with its residency (checked
     against the launch rule's);
  A. each kernel against its plain PyTorch version on the card, on stage
     data taken from the real slice (cartpole, T=100, B=4096), in float32
     and float64, on random nx=3, nu=2 data, and on an indefinite R that
     must fail the PD test; then each kernel's time beside the plain
     version's (the trial in both dtypes, through its wrapper and its C
     entry alone, also in SM cycles per stage);
  B. ``solve_stream`` on 128 cartpole scenarios in float64 (cut from 256
     when phase U came): the card
     (kernels) against the CPU (plain versions);
  C. ``solve_stream`` at the bench's width: cartpole H=100, float32,
     ``BATCH_CONFIG.replace(newton_impl="seq")``, 4096 lanes, refill every
     32, a pool of 1 x 4096 scenarios (cut from 4 x 4096 to keep the
     script inside its time limit: this host-bound path takes some 60 s at
     4 x 4096), its busy window (as F's) after 30 iterations (after 90
     until phase U came);
  D. the five fused kernels against their plain versions on the fused
     slice's data (cartpole T=100, the pool's first 4096 lanes, at bp=0.1
     and at bp=0.004), float64 then float32, and on pendulum at B=256;
     the rollout kernel also on cartpole T=1000 at B=256 (float64 within
     1e-12 of scale); the rollout-cost kernel bit for bit the one-thread
     loop it replaced at cartpole (pendulum's parting recorded), also at
     T 1 and 7 on B=37 and on offset views; then each kernel's time beside
     its plain version's (the backward and forward sweeps and the
     transition also in float64, and through their C entries alone, in SM
     cycles per stage), and the rollout-cost kernel's C entry against the
     one-thread loop's in turns at B=4096 and at the streams' median lane
     opening (OPEN_B), both dtypes;
  E. ``solve_stream`` with ``BATCH_CONFIG`` (the packed stream on its mega
     executor) on 256 cartpole scenarios in float64: the card against the
     CPU;
  F. the packed stream's two-launch arm (``mega=False``) at the bench's
     width: cartpole H=100, float32, ``BATCH_CONFIG`` unmodified, 4096
     lanes, refill every 32, a pool of 4 x 4096 scenarios, with the device
     busy share over a window of 10 iterations (the whole run's, profiled
     again, was cut when phase U came), every kernel's launch count and
     the lane openings' B (count, min, median, max; so too H, I and O);
     then the first 512 raw costs against the float64 solve on the card;
  G. the merged trial (Newton at T=100, DDP at T=25) and the mega kernel
     (Newton at T=100 and DDP at T=25, k=4 with two iterations per barrier
     stage so that lanes roll over, then k=32) against their plain
     versions, and the mega kernel against k steps of ``packed_lane_iter``
     on the two-launch kernels, on 4096 lanes of the pool at bp 0.1 and
     0.004 (the k=32 launch against its plain version on its first 1024:
     cut from 4096 when phase U came), float64 then float32; then each
     kernel's time beside its plain
     version's, the mega launch beside 32 two-launch iterations, and its
     time per serial stage-iteration
     (ms / (steps x T), and in cycles at the SM clock ``nvidia-smi``
     reported);
  H. the single-grid stream on the mega executor (``solve_stream``,
     ``BATCH_CONFIG``) at F's width, with launch counts: ``mega`` once per
     refill round, no per-iteration kernel;
  I. ``solve_stream_multigrid`` at bench.py's default: cartpole H=100,
     coarsen 4, ``coarse_impl="ddp"``, 4096 lanes, refill every 32, a pool
     of 4 x 4096, float32: both levels' steps and iterations, the busy
     share, the basin-switch fraction against H's solutions; then the
     coarse level again on the two-launch arm (the merged trial's path);
  J. ``solve_stream_multigrid`` on 256 cartpole scenarios in float64: the
     card against the CPU;
  K. the parallel-in-time kernels (the affine scan in both directions, the
     value scan, the one-launch trial) against their plain versions on
     cartpole stage data at T=100 and T=1000, B=1 and B=1024, and on
     random nx=3, nu=2 data at T=129, float64 (1e-10 of scale) then
     float32 (1e-4); an indefinite R on one lane; the trial against the
     public LQT passes on the scan kernels, whose launches are counted
     there; then each kernel's time beside its plain version's (the trial
     in float32 and float64, with the lanes and blocks it launched,
     through its wrapper and its C entry alone; the scans with the lanes
     per scenario their launch rule picked);
  L. ``par_interior_point_optimal_control``: the goldens (pendulum and
     cartpole H=100, float64) against tests/golden/*.npz and the CPU run,
     pendulum's seq solve beside them (cartpole's cut when phase U came);
     cartpole H=1000 under FAST_CONFIG in float32 and float64 with
     iterations, trials, wall time (one solve; cut from the median of 5
     to 3 when phases N and O came, to 1 when S came), host reads and
     launches per solve, and, in float32 (float64's cut when U came), the
     busy share over the first barrier stage with the trial's share of
     its device time and wall;
  M. ``solve_batch(method="par")`` on the pool's first 1024 scenarios in
     float32 under FAST_CONFIG (the busy share over its first 11 lockstep
     iterations, and the trial's share of them); then 128 scenarios (cut
     from 256) in float64, the card against the CPU;
  N. bench.py's batch mode: ``solve_batch(ocp, u, x0, cfg)`` on the pool's
     first 4096 cartpole H=100 scenarios in float32 under ``BATCH_CONFIG``
     (staged), its flat schedule, ``newton_impl="ddp"`` and flat DDP
     without the stage predictor: wall, iterations, lockstep iterations,
     host reads, the busy share over the first 11 lockstep iterations, and
     every kernel's launches held to their exact counts (the fused trial's
     kernels or the merged trial once per lockstep iteration, the rollout
     kernel once per flat open and once per rollover iteration without the
     predictor, the transition kernel once per rollover iteration with
     it); the flat batch against the packed stream on the same scenarios;
     then (Nflat, Nddp) 128 scenarios in float64, the card against the CPU;
  O. the long horizon, cartpole H=1000 (dt 1e-3), where the JAX package
     runs its streamed mega kernel: the mega kernel against its plain
     version with that kernel's test matrix (Newton and DDP, two k-blocks
     of 2, two iterations per stage) on 256 lanes, float64 then float32;
     one k=2 launch on 4096 lanes beside its plain version and bound, and
     k=32 launches (DDP at T=250), each also per serial stage-iteration;
     ``solve_stream(BATCH_CONFIG)`` on a pool
     of 1 x 4096 and ``solve_stream_multigrid`` (a DDP coarse level at
     T=250) on the same pool, with launch counts; in float64 on 256
     scenarios the mega executor against the two-launch arm, Newton and
     DDP, with the scenarios that run to the iteration cap.
  P. bench.py's nmpc mode (``bench.py:193-311``): cartpole H=100, float32,
     4096 controllers from the pool's first states, zero initial plans, 25
     closed-loop steps of ``nmpc_loop_batched_warm`` on
     ``solve_batch_packed`` (the first resolve cold under BATCH_CONFIG,
     the others warm at ``bp_entry=0.02`` capped at 12 iterations a
     stage, k-blocks of 8): resolves/s and ms per step (median of 3)
     against the 10 ms replan budget, max |u|, the cold and warm resolves'
     iterations, the fallback lanes per step, host reads, the busy share
     and the launches held to their exact counts (the mega kernel once
     per k-block, the rollout-cost kernel once for the cold resolve and
     twice for each warm one); then the r4 protocol (every resolve cold,
     capped at 25, k-blocks of 32); then (P64) float64 on 64 controllers
     x 5 steps, the card against the CPU; and ``lqt_mpc_loop`` par
     against seq on the card (``examples/linear_mpc.py``'s LQT, T=5, 300
     steps, within 1e-10) with the scans' launches and each loop's ms
     per step (the example times 5000 steps);
  Q. ``interior_point_ddp`` in float64 (plain tensor code, no kernel, as
     in JAX): the pendulum golden on the card against
     tests/golden/pendulum_h100.npz and the CPU run, the cartpole golden
     on the CPU child against its file; ``solve_batch(method="ddp")`` on
     4 pool scenarios under FAST_CONFIG (wall, lockstep iterations, mean
     and max iterations, lanes at a stage's cap, non-finite costs; against
     the CPU lane by lane; cut from 256, and from 16 when phase U came:
     the plain solve is host-bound, some 0.3-0.5 s per lockstep iteration
     on the card whatever the lanes, and more lanes take more lockstep
     iterations); no float32
     solve is timed (P, Q and R together are held near 120 s);
  R. warm transfer in the packed stream at H's width (4096 lanes, refill
     32, a pool of 4 x 4096, float32): on pendulum H=100 against the cold
     stream (raw costs within 1e-4 relative on every scenario, fewer mean
     iterations after the first generation, the transferred and fallback
     lanes), on cartpole the basin-switch fraction against H's solutions
     (reported, no limit), with launch counts; then 256 cartpole
     scenarios in float64, the card against the CPU.
  S. the distribution layer (``__graft_entry__.py``'s ``dryrun_multichip``
     on one card): two ranks share cuda:0 in a gloo group (NCCL refuses
     two ranks on one device) and run, each on its half, the time-sharded
     cartpole T=1024 solve in float64 (``ip_newton_time_sharded``,
     FAST_CONFIG single-trial; against the unsharded solve on the card:
     equal iterations, controls within rtol 1e-7, atol 1e-8), the sharded
     multigrid at the bench's width (4096 lanes a rank, refill 32, a DDP
     coarse level, a pool of 2 x 4 x 4096, float32; against one process's
     run on the same pool: equal iterations, bit-equal controls) and
     ``solve_batch_sharded`` on 2 x 8 pendulum scenarios (float32,
     FAST_CONFIG single-trial; against one ``solve_batch`` of all 16:
     equal iterations, bit-equal controls); a one-rank NCCL group runs the
     time-sharded LQT solve at H=1000.  The references run
     first, in the parent: a third process busy on the card slows the
     ranks' host-bound loops severalfold.  Each rank counts its launches from
     zero; S fails unless the rollout-cost, mega, both scan and the
     parallel trial kernels were launched, if a rank raises or outlives
     its 120 s join, or if the card's compute mode forbids two processes.
  T. the planar quadrotor (nx=6, nu=2) through every path: (T1) every
     kernel at (6, 2) against its plain version, float64 then float32, at
     B in {33, 4096} (the merged trial and one k=8 mega launch per mode:
     Newton at T=40, DDP at T=10), with phases A, D, G and K's tolerances
     (the value scan and the parallel trial against the float64 result
     where the data amplify rounding: ``par_f64_conditioned``,
     ``par_f32_vs_f64``), then each kernel's time at B=4096, T=40 in
     float32 beside its plain version and bound; (T2) bench.py's
     quadrotor configuration (H=40, dt 1/40, BATCH_CONFIG, float32, 4096
     lanes, refill 32, the warm start about hover thrust) on 4 x 4096
     scenarios: the single-grid stream on the mega executor and on the
     two-launch arm, the multigrid (a DDP coarse level at T=10) and its
     coarse level on the two-launch arm: solves/s, the busy share, steps
     and iterations per level, lanes at the cap, the non-finite raw-cost
     share (0), the controls' range (strictly inside the thrust box) and
     the basin-switch fraction; (T3, last) the multigrid on 128 of those
     scenarios in float64, the card against the CPU, as J; (T4) the single
     solves of tests/test_quadrotor.py (par, seq, and par with the seq
     trial) and a double-integrator par solve, float64, against the CPU
     child's: equal iterations, controls within 1e-8.
  U. the state constraints: the unicycle (nx=3, nu=2) with its keep-out
     disc, and BASELINE.json config 3's cart box.  (U1) every generated
     kernel at (3, 2) against its plain version, float64 then float32, at
     B in {33, 4096} and bp in {0.1, 0.004} (at 0.1 the pool's cold
     start; at 0.004 each level's iterates converged at that barrier
     stage, which ride the disc): the fused five on the fine grid, the
     merged trial and one k=8 mega launch per mode (Newton at T=100, DDP
     at T=25; at B=4096 held on its first 1024 lanes), with phases D and
     G's tolerances and, where the disc's barrier makes every evaluation
     order round apart, the plain version's own one-ulp spread; the disc
     batches (a
     single interior stage inside the disc: max_c > 0 and NaN barrier
     costs, kernel and plain version alike; only the terminal state
     inside: feasible); then each generated kernel's float32 time at
     B=4096, T=100 on the iterates at bp 0.004; (U2) bench.py's unicycle
     configuration (IPOC_BENCH_MODEL=unicycle: H=100, dt 1/100,
     BATCH_CONFIG, float32, 4096 lanes, refill 32) on 4 x 4096
     scenarios: the single grid on the mega executor and the two-launch
     arm, the multigrid (a DDP coarse level at T=25) with the lanes its
     usable gate sent to the cold start, and its coarse level on the
     two-launch arm: solves/s, busy share, steps and iterations per level,
     lanes at the cap, the non-finite raw-cost share (0), every lane's
     largest constraint over its stage points (<= 0), the least distance
     to the disc's centre (>= its radius), the basin-switch fraction
     (reported, no limit); (U3) ``solve_batch`` under BATCH_CONFIG on
     1024 scenarios, its launches held to their exact counts, every lane
     feasible; (U4) tests/test_unicycle.py's par and seq solves and
     config 3's par solve (examples/p50_budget.py: cartpole H=100,
     cart_limit 0.3) in float64 against the CPU child's (equal
     iterations, controls within 1e-8; the unicycle riding the disc
     within 1e-3), config 3 in float32 (median wall of 3, |x_cart| < 0.3);
     (U5, last) the multigrid on 128 of U2's scenarios in float64, the
     card against the CPU: equal steps and iterations on both levels, the
     same fallback lanes, controls within 1e-8.

Phases B, E, J, the second halves of M and N, R's float64 check, T3, P64
and U5 run last: their CPU halves (and L's and Q's CPU golden solves) run
meanwhile, in one child process each, started at the beginning (P's, Q's,
R's, T's and U's when phase P starts).  A failed
check fails its phase; the other phases still run, and any failure exits
non-zero.  The line before the last holds the kernels' record; the last
line is ``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset of
A-U (default: all; phase 0, the device and the build, always runs).  The line before the kernels' record gives the
script's total seconds.  Without a card, or outside a checkout of the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import re
import subprocess
import sys
import time
import traceback

SEED = 1
T = 100
DT = 1.0 / T
LANES = 4096
# The median B of the streams' lane openings (phases F and H record them:
# 965 and 963 at this pool and seed), where phase D also times the
# rollout-cost kernel.
OPEN_B = 965
POOL = 4 * LANES  # the bench's pool is 32 x lanes; 4 x keeps this smoke short
REFILL = 32
COARSEN = 4  # the multigrid's coarse level: T=25 at 4 x the time step
# Phase D's float32 tolerance (kernel against plain version, relative to
# each output's largest entry): the two evaluate the same float32 program
# in another operation order (and the kernel contracts products into FMAs),
# and the backward sweep carries rounding through T=100 Riccati steps.
F32_TOL = 1e-4
# The card's peaks for a kernel's bound (NVIDIA's data sheet for the H100
# SXM at 700 W): device memory, and float32 outside
# the tensor cores (an FMA counts two operations).  Every timed launch below
# runs in float32, but for phase K's float64 trial, bound by the data
# sheet's float64 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12
# The reference sweep's longest horizon (H * dt = 1 s): phase L's single
# solve and phase O's streams.
LONG_T = 1000
# The parallel-in-time slice: the goldens' horizon and the longest, and
# the batch of phase M.
PAR_HORIZONS = (T, LONG_T)
PAR_BATCH = 1024
# Phase L's goldens whose seq solve also runs on the card (cartpole's, some
# 40 s of host-bound tensor code, was cut when phase U came).
GOLDEN_SEQ = ("pendulum",)
# Scenarios of the card-against-CPU phases (256 unless listed).
CARD_VS_CPU_SCENARIOS = {"B": 128, "M": 128, "Nflat": 128, "Nddp": 128,
                         "T3": 128, "U5": 128}
# Phase T: bench.py's quadrotor configuration (IPOC_BENCH_MODEL=quadrotor
# IPOC_BENCH_HORIZON=40: H=40, dt=1/40; the multigrid's coarse level T=10),
# the batches of its kernel checks, and tests/test_quadrotor.py's single
# solve (dt 0.05, H=40) and a double-integrator solve (dt 0.01, H=100).
QUAD_T = 40
QUAD_CHECK_B = (33, LANES)
QUAD_SOLVE = (2, QUAD_T)   # (coarsen, horizon): dt = 2 / 40 = 0.05
DI_SOLVE = (1, 100)        # dt = 0.01
# Phase U: bench.py's unicycle configuration (IPOC_BENCH_MODEL=unicycle:
# H=100, dt 1/100; the multigrid's coarse level T=25), the batches and
# barrier parameters of its kernel checks, tests/test_unicycle.py's single
# solve (T=60, dt 2/60) and BASELINE.json config 3 (cartpole H=100, dt
# 0.01, the cart box |x_cart| <= 0.3; examples/p50_budget.py).
UNI_CHECK_B = (33, LANES)
UNI_BPS = (0.1, 0.004)
UNI_SOLVE = (2, 60)
CART_LIMIT = 0.3
UNI_SCENARIOS = 1024       # U3's batch

def model_ocp(name, coarsen=1, horizon=T):
    """One OCP object per model, horizon and coarsening (the time step is
    ``coarsen / horizon``: H * dt = 1 s), shared by every phase: the fused
    library and its generated code are cached per OCP object."""
    return _model_ocp(name, coarsen, horizon)


def model_module(name):
    """The port's model module ``name``."""
    from ipoc_tpu_torch.models import (
        cartpole,
        double_integrator,
        pendulum,
        quadrotor,
        unicycle,
    )

    return {"cartpole": cartpole, "pendulum": pendulum,
            "quadrotor": quadrotor, "double_integrator": double_integrator,
            "unicycle": unicycle, "cartpole_box": cartpole}[name]


@functools.lru_cache(maxsize=None)
def _model_ocp(name, coarsen, horizon):
    dt = coarsen * (1.0 / horizon)
    if name == "cartpole_box":
        return model_module(name).make_ocp(dt, cart_limit=CART_LIMIT)
    return model_module(name).make_ocp(dt)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(obj):
    """Print one JSON line, and append it to build/chip_smoke.jsonl, so that
    the whole record survives where only the end of the standard output is
    kept."""
    line = json.dumps(obj)
    print(line, flush=True)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


class SmClock:
    """The SM clock that ``nvidia-smi`` reports while the ``with`` block
    runs, sampled every 20 ms by one ``nvidia-smi`` process (stopped at the
    end): ``mhz`` is the median sample (None without samples)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        samples = sorted(int(v) for v in out.split() if v.isdigit())
        self.mhz = samples[len(samples) // 2] if samples else None


def per_stage_iteration(ms, steps, horizon, mhz):
    """A mega launch's time per serial stage-iteration: ``ms / (steps *
    horizon)`` in microseconds, and in SM cycles at ``mhz``."""
    us = 1e3 * ms / (steps * horizon) if steps else None
    return {"us_per_stage_iteration": us,
            "cycles_per_stage_iteration": us * mhz if us and mhz else None,
            "sm_clock_mhz": mhz}


def nbytes(*objs):
    """Bytes of the tensors in ``objs`` (nested tuples and lists too)."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif hasattr(o, "element_size"):
            total += o.numel() * o.element_size()
    return total


def bound(bytes_moved, ops, library_ms=None, ops_per_s=PEAK_F32_OPS_PER_S):
    """A kernel's bound: the larger of its bytes (each input read once,
    each output written once) over the card's memory rate and its
    operations over the card's peak for their type (float32 unless
    ``ops_per_s`` says otherwise); ``library_ms`` is the time of one
    PyTorch call computing the same function, where there is one (none of
    this port's kernels has one)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_moved), "ops": int(ops),
            "library_ms": library_ms}


# Operation counts (a multiply-add counts two) of the kernels' arithmetic,
# from the shapes, term by term as the kernels compute it.

def mm_ops(n, k, m):
    return n * m * (2 * k - 1)


def solve_ops(n, m):
    """An unpivoted elimination of an n x n system against m columns."""
    ops = 0
    for k in range(n):
        ops += 1 + (n - k - 1) + m + 2 * (n - k - 1) * ((n - k - 1) + m)
    return ops + sum(2 * (n - 1 - i) * m for i in range(n - 1))


def affine_combine_ops(n):
    return mm_ops(n, n, n) + mm_ops(n, n, 1) + n


def fold_ops(n):
    """The eta and J halves of a value combine (the terminal fold)."""
    return (mm_ops(n, n, n) + n + mm_ops(n, n, 1) + n + solve_ops(n, n + 1)
            + mm_ops(n, n, 1) + n + 2 * mm_ops(n, n, n) + n * n)


def value_combine_ops(n):
    return (fold_ops(n) + mm_ops(n, n, n) + n + mm_ops(n, n, 1) + n
            + solve_ops(n, 2 * n + 1) + mm_ops(n, n, n) + mm_ops(n, n, 1) + n
            + 2 * mm_ops(n, n, n) + n * n)


def par_trial_ops(B, T, nx, nu):
    """The one-launch trial: per stage the reference trick and element,
    the fold, the gains, the closed-loop element and the state step; T-1
    value and affine combines."""
    element = (solve_ops(nx, nu) + mm_ops(nu, nx, nu) + nu * nu
               + solve_ops(nu, 1) + mm_ops(nx, nu, 1) + solve_ops(nu, nu)
               + mm_ops(nu, nu, nx) + 2 * (mm_ops(nx, nu, nx) + nx * nx)
               + mm_ops(nx, nu, nu) + mm_ops(nu, nx, 1) + nu
               + mm_ops(nx, nu, 1) + mm_ops(nx, nx, 1) + mm_ops(nx, nu, nx))
    gains = (2 * mm_ops(nx, nx, nu) + mm_ops(nu, nx, nu) + nu * nu + nx * nu
             + mm_ops(nu, nu, 1) + 2 * mm_ops(nu, nx, 1) + 3 * nu
             + solve_ops(nu, 1 + nx) + 2 * mm_ops(nu, nu, 1) + 4 * nu + 2)
    closed = mm_ops(nx, nu, nx) + nx * nx + mm_ops(nx, nu, 1)
    step = mm_ops(nu, nx, 1) + nu + mm_ops(nx, nx, 1) + nx
    per_stage = element + fold_ops(nx) + gains + closed + step
    return B * (T * per_stage + (T - 1) * (value_combine_ops(nx)
                                           + affine_combine_ops(nx)))


def riccati_ops(nx, nu):
    """riccati.cuh's backward step (Newton mode) and the forward step of the
    sequential trial, per stage."""
    bwd = (mm_ops(nx, nx, nx) + mm_ops(nx, nx, nu)
           + nx * (nx + 1) // 2 * 2 * nx + nu * (nu + 1) // 2 * 2 * nx
           + nx * nu * 2 * nx + mm_ops(nx, nx, 1) + nu * 2 * nx
           + solve_ops(nu, 1 + nx) + solve_ops(nu, 0) + nu * (1 + nx)
           + nx * 2 * nu + nx * (nx + 1) // 2 * 2 * nu + 4 * nu
           + mm_ops(nu, nu, 1) + 2)
    fwd = nu * 2 * nx + nx * (2 * nx + 2 * nu)
    return bwd + fwd


def program_ops(ocp, nx, nu):
    """Operations per call of each generated stage program (the scalar
    DAG's non-input nodes)."""
    from ipoc_tpu_torch.ops import fused_iter

    return {name: sum(1 for nd in prog.order if nd.op != "input")
            for name, prog in fused_iter.scalar_programs(ocp, nx, nu).items()}


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


def slice_stage_data(pool, dtype, device, bp=0.1, rp=100.0, model="cartpole",
                     horizon=T):
    """The trial's and the costate recursion's inputs at the pool's cold
    start, as the stream's first iteration computes them (``model`` at
    ``horizon``, H * dt = 1 s)."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_plain
    from ipoc_tpu_torch.ops.derivatives import (
        compute_first_order,
        compute_hamiltonian_lqr,
        final_gradient,
        final_hessian,
    )
    from ipoc_tpu_torch.solvers.ip_newton import _regularized
    from ipoc_tpu_torch.utils.integrators import rollout

    ocp = model_ocp(model, 1, horizon)
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


# The fused libraries phase 0 builds: (model, coarsen, horizon, nx, nu);
# then phase T's planar quadrotor, fine (T=40) and coarse (T=10), and
# phase U's unicycle, fine (T=100) and coarse (T=25).
FUSED_MODELS = (("cartpole", 1, T, 4, 1), ("cartpole", COARSEN, T, 4, 1),
                ("pendulum", 1, T, 2, 1), ("cartpole", 1, LONG_T, 4, 1),
                ("cartpole", COARSEN, LONG_T, 4, 1),
                ("quadrotor", 1, QUAD_T, 6, 2),
                ("quadrotor", COARSEN, QUAD_T, 6, 2),
                ("unicycle", 1, T, 3, 2), ("unicycle", COARSEN, T, 3, 2))


def traced_programs(name, coarsen, horizon, nx, nu):
    """One model's scalarized stage programs, traced in a worker process
    (``phase_device`` runs one per model, all at once)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ipoc_tpu_torch.ops import fused_iter

    return fused_iter.scalar_programs(model_ocp(name, coarsen, horizon), nx,
                                      nu)


def phase_device():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import torch

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
    # The fixed-shape libraries need no codegen: their nvcc calls (the
    # longest, par_newton.cu, some 150 s) start now, in a thread, while
    # the codegen traces each model's stage programs (some 15 s of Python
    # per model on the card's host) in one worker process per model.
    with ThreadPoolExecutor(1) as compiling:
        fixed = compiling.submit(cuda.build_all,
                               [cuda.SEQ_NEWTON, cuda.PAR_NEWTON])
        with ProcessPoolExecutor(len(FUSED_MODELS),
                                 multiprocessing.get_context(
                                     "spawn")) as pool:
            traced = list(pool.map(traced_programs, *zip(*FUSED_MODELS)))
        specs = []
        for (model, coarsen, horizon, nx, nu), progs in zip(FUSED_MODELS,
                                                            traced):
            ocp = model_ocp(model, coarsen, horizon)
            fused_iter.scalar_programs(ocp, nx, nu, traced=progs)
            specs.append(fused_iter.model_spec(ocp, nx, nu))
        codegen_s = time.perf_counter() - t0
        paths = cuda.build_all(specs)
        paths = fixed.result() + paths
    build_s = time.perf_counter() - t0
    cuda.library()
    cuda.library(cuda.PAR_NEWTON)
    cuda.disable_tf32()
    emit({"phase": "0", "device": name, "nvidia_smi": power,
          "count": torch.cuda.device_count(), "codegen_s": codegen_s,
          "kernel_build_s": build_s, "compile_s": cuda.compile_seconds,
          "libraries": [str(p.relative_to(p.parents[3])) for p in paths],
          "ptxas_cartpole": ptxas_report(
              paths[2], model_ocp(*FUSED_MODELS[0][:3]), 4, 1),
          "ptxas_quadrotor": {
              level: ptxas_report(paths[i], model_ocp(*FUSED_MODELS[i - 2][:3]),
                                  6, 2)
              for level, i in (("fine_T40", 7), ("coarse_T10", 8))},
          "ptxas_unicycle": {
              level: ptxas_report(paths[i], model_ocp(*FUSED_MODELS[i - 2][:3]),
                                  3, 2)
              for level, i in (("fine_T100", 9), ("coarse_T25", 10))},
          "sass_cartpole": sass_mix(paths[2]),
          "ptxas_par_newton": par_ptxas_report(paths[1]),
          "rows_kernels": rows_report(paths[0], {
              "cartpole": (model_ocp(*FUSED_MODELS[0][:3]), 4, 1, paths[2]),
              "pendulum": (model_ocp(*FUSED_MODELS[2][:3]), 2, 1, paths[4]),
              "quadrotor": (model_ocp(*FUSED_MODELS[5][:3]), 6, 2,
                            paths[7]),
              "unicycle": (model_ocp(*FUSED_MODELS[7][:3]), 3, 2,
                           paths[9])}),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, power


def ptxas_entries(text, pattern):
    """What ``ptxas -v`` reported (``text``) for each entry function whose
    mangled name matches ``pattern``, keyed by the match's groups:
    registers, stack frame, spill and static shared-memory bytes."""
    found = {}
    for block in re.split(r"Compiling entry function '", text)[1:]:
        m = re.search(pattern, block.split("'")[0])
        if m is None:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        found[m.groups()] = {
            "registers": int(regs.group(1)) if regs else None,
            "stack_frame_bytes": int(frame.group(1)) if frame else None,
            "spill_store_bytes": int(frame.group(2)) if frame else None,
            "spill_load_bytes": int(frame.group(3)) if frame else None,
            "static_shared_bytes": int(smem.group(1)) if smem else 0}
    return found


def ptxas_report(lib, ocp, nx, nu):
    """Registers, stack frame, spill and static shared-memory bytes that
    ``ptxas -v`` reported for the mega kernel and the merged trial of one
    library (``ocp``'s; the build keeps the report beside it), per dtype
    and mode, with the mega kernel's stage ring: stages per slot W, slots S
    and the dynamic shared memory per block (``ipoc_ring_layout``;
    ``ptxas`` reports static shared memory only).  The merged trial's group
    schedule is in ``rows_report``."""
    import torch

    from ipoc_tpu_torch.ops import mega

    out = {}
    for (kernel, dt, ddp), rec in ptxas_entries(
            lib.with_suffix(".ptxas.txt").read_text(),
            r"_ZN4ipoc\d+(mega_kernel|merged_trial_kernel)"
            r"I5Model([fd])Lb([01])E").items():
        dt = "float32" if dt == "f" else "float64"
        key = f"{kernel}_{dt}_{'ddp' if ddp == '1' else 'newton'}"
        out[key] = rec
        if kernel == "mega_kernel":
            out[key]["ring"] = mega.ring_layout(ocp, nx, nu, getattr(torch, dt))
    check(len(out) == 8, f"ptxas report incomplete: {sorted(out)}")
    return out


def sass_functions(lib):
    """The SASS of the library at ``lib`` (``cuobjdump -sass``): a list of
    (mangled function name, [(address, opcode, operands), ...])."""
    from ipoc_tpu_torch.ops import cuda

    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600).stdout
    return [(block.split("\n")[0].strip(), [
        (int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
            r"([^;\n]*);", block)])
        for block in re.split(r"\n\s*Function : ", text)[1:]]


def sass_loops(ins, min_loop):
    """The loops of one function's SASS with ``min_loop`` or more
    instructions (a backward branch and its target, in address order):
    each loop's opcodes."""
    loops = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)\s*$", rest)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            body = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
            if len(body) >= min_loop:
                loops.append(body)
    return loops


def sass_mix(lib):
    """Instructions of the mega kernel's and the merged trial's SASS in the
    library at ``lib``, per dtype and mode: the floating-point multiply,
    add and fused multiply-add counts, the total, and the instructions in
    each loop of 300 or more (for the mega kernel the backward sweep's
    stage loop, the forward sweep's, the transitions' and the iteration
    loop around them)."""
    out = {}
    for name, ins in sass_functions(lib):
        m = re.match(r"_ZN4ipoc\d+(mega_kernel|merged_trial_kernel)"
                     r"I5Model([fd])Lb([01])E", name)
        if m is None:
            continue
        ops = [op for _, op, _ in ins]
        key = (f"{m.group(1)}_{'float32' if m.group(2) == 'f' else 'float64'}"
               f"_{'ddp' if m.group(3) == '1' else 'newton'}")
        out[key] = {op: ops.count(op) for op in
                    ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD")}
        out[key]["total"] = len(ops)
        out[key]["loops"] = [len(body) for body in sass_loops(ins, 300)]
    return out


def sass_stage_loops(lib, pattern, min_loop=30):
    """The loops of the functions whose name matches ``pattern`` in the
    library at ``lib``: per function, keyed by its template arguments, its
    instruction count and, for each loop of ``min_loop`` or more
    instructions, their count and their floating-point, memory and select
    mix."""
    mix = ("FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "MUFU", "LDG",
           "STG", "LDS", "STS", "LDGSTS", "SEL", "FSEL")
    out = {}
    for name, ins in sass_functions(lib):
        m = re.search(pattern + r"I(\w+?)EEv", name)
        if m is None:
            continue
        out[m.group(1)] = {"total": len(ins), "loops": [
            {"n": len(body), **{k: body.count(k) for k in mix if body.count(k)}}
            for body in sass_loops(ins, min_loop)]}
    return out


def rows_report(seq_lib, fused):
    """The group-schedule kernels: the two that run the cooperative
    Riccati step (seq_trial, fused_bwd), the forward sweep and the
    transition (fused_fwd, transition), the merged trial in both modes
    (merged_trial, both sweeps) and the costate recursion (costates):
    registers and spill bytes as ``ptxas -v`` reported them, the card's
    view (resident blocks per SM, threads, shared bytes and scenarios per
    block), per dtype and shape (``fused``: model name -> (ocp, nx, nu,
    library path)), checked to hold a B=4096 launch in one wave of resident
    blocks (the quadrotor's (6, 2) and nx=6 kernels: the waves recorded);
    and the SASS of their loops (the float32 and float64 cartpole-shaped
    ones; the merged trial's and the costate recursion's also pendulum's
    and nx=2's)."""
    import torch

    from ipoc_tpu_torch.ops import fused_iter as tf
    from ipoc_tpu_torch.ops.cuda import seq_newton as sn

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def one_wave(key, rec, occ, held=True):
        blocks = -(-LANES // occ["scenarios_per_block"])
        waves = -(-blocks // max(occ["blocks_per_sm"] * sms, 1))
        check(waves == 1 or not held, f"{key}: {blocks} blocks at B={LANES} "
              f"take {waves} waves of {occ['blocks_per_sm']} x {sms} "
              "resident blocks")
        out[key] = {**rec, **occ, f"blocks_b{LANES}": blocks,
                    f"waves_b{LANES}": waves}

    out = {}
    dtypes = {"f": torch.float32, "d": torch.float64}
    seq = ptxas_entries(seq_lib.with_suffix(".ptxas.txt").read_text(),
                        r"seq_trial_kernelI([fd])Li(\d)ELi(\d)E")
    for (dt, nx, nu), rec in sorted(seq.items()):
        nx, nu = int(nx), int(nu)
        one_wave(f"seq_trial_{str(dtypes[dt])[6:]}_nx{nx}_nu{nu}", rec,
                 sn.trial_occupancy(dtypes[dt], nx, nu), nx < 6)
    costates = ptxas_entries(seq_lib.with_suffix(".ptxas.txt").read_text(),
                             r"costate_kernelI([fd])Li(\d)E")
    for (dt, nx), rec in sorted(costates.items()):
        one_wave(f"costates_{str(dtypes[dt])[6:]}_nx{nx}", rec,
                 sn.costate_occupancy(dtypes[dt], int(nx)), int(nx) < 6)
    for name, (ocp, nx, nu, lib) in fused.items():
        report = lib.with_suffix(".ptxas.txt").read_text()
        for kernel in tf.GROUP_KERNELS:
            for (dt,), rec in sorted(ptxas_entries(
                    report, rf"{kernel}_kernelI5Model([fd])E").items()):
                one_wave(f"{kernel}_{name}_{str(dtypes[dt])[6:]}", rec,
                         tf.group_occupancy(ocp, nx, nu, dtypes[dt], kernel),
                         nx < 6)
        for (dt, ddp), rec in sorted(ptxas_entries(
                report, r"merged_trial_kernelI5Model([fd])Lb([01])E").items()):
            one_wave(f"merged_trial_{name}_{str(dtypes[dt])[6:]}_"
                     f"{'ddp' if ddp == '1' else 'newton'}", rec,
                     tf.merged_occupancy(ocp, nx, nu, dtypes[dt], ddp == "1"),
                     nx < 6)
    check(len(out) == 2 * len(sn.TRIAL_SHAPES) + 2 * len(sn.COSTATE_NX)
          + len(fused) * (2 * len(tf.GROUP_KERNELS) + 4),
          f"rows report incomplete: {sorted(out)}")
    out["sass_seq_trial"] = sass_stage_loops(seq_lib, "seq_trial_kernel")
    out["sass_costates"] = sass_stage_loops(seq_lib, "costate_kernel")
    for kernel in tf.GROUP_KERNELS:
        out[f"sass_{kernel}_cartpole"] = sass_stage_loops(
            fused["cartpole"][3], f"{kernel}_kernel")
    for name in ("cartpole", "pendulum"):
        out[f"sass_merged_trial_{name}"] = sass_stage_loops(
            fused[name][3], "merged_trial_kernel")
    return out


def par_ptxas_report(lib):
    """Registers and spill bytes of each instantiation of the three
    parallel-in-time kernels (``csrc/par_newton.cu``), keyed by kernel,
    dtype and template shape (the affine scan's: n, lanes per scenario P
    and the direction; the value scan's: n and P; the trial's: nx, nu and
    P); for the trial, the value scan and the affine scan's suffix mode
    also the card's view (``trial_occupancy``, ``scan_occupancy``):
    resident blocks per SM, threads, shared bytes and scenarios per block,
    checked against the launch rules' resident warps (RESIDENT_WARPS for
    the trial's (4, 1) shape, SCAN_RESIDENT_WARPS and VALUE_RESIDENT_WARPS
    for the scans at n = 4)."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk

    out = {}
    for (kernel, dt, args), rec in ptxas_entries(
            lib.with_suffix(".ptxas.txt").read_text(),
            r"(affine_scan_kernel|value_scan_kernel|"
            r"par_newton_trial_kernel)I([fd])((?:L[ib]\d+E)*)E").items():
        shape = "_".join(re.findall(r"L[ib](\d+)E", args))
        key = (f"{kernel.replace('_kernel', '')}_"
               f"{'float32' if dt == 'f' else 'float64'}_{shape}")
        out[key] = rec
        if kernel == "par_newton_trial_kernel":
            nx, nu, lanes = map(int, shape.split("_"))
            dtype = torch.float32 if dt == "f" else torch.float64
            occ = nk.trial_occupancy(dtype, nx, nu, lanes)
            out[key].update(occ)
            warps = occ["blocks_per_sm"] * occ["threads_per_block"] // 32
            check((nx, nu) != (4, 1) or warps == nk.RESIDENT_WARPS,
                  f"{key}: {warps} resident warps per SM, the launch rule "
                  f"assumes {nk.RESIDENT_WARPS}")
        value = kernel == "value_scan_kernel"
        if value or (kernel == "affine_scan_kernel" and shape.endswith("_1")):
            n, lanes = map(int, shape.split("_")[:2])
            dtype = torch.float32 if dt == "f" else torch.float64
            occ = sk.scan_occupancy(dtype, n, lanes, value=value)
            out[key].update(occ)
            warps = occ["blocks_per_sm"] * occ["threads_per_block"] // 32
            assumed = (sk.VALUE_RESIDENT_WARPS if value
                       else sk.SCAN_RESIDENT_WARPS)[dtype][lanes]
            check(n != 4 or warps == assumed,
                  f"{key}: {warps} resident warps per SM, the launch rule "
                  f"assumes {assumed}")
    # Every instantiation whose block fits in shared memory.
    expect = sum(
        sum(sk.scan_shared_bytes(n, P, dtype, v) <= cuda.MAX_SMEM
            for n in sk.SCAN_N for P in sk.SCAN_LANES for v in (0, 0, 1))
        + sum(nk.trial_shared_bytes(nx, P, dtype) <= cuda.MAX_SMEM
              for nx, _ in nk.TRIAL_SHAPES for P in nk.TRIAL_LANES)
        for dtype in (torch.float32, torch.float64))
    check(len(out) == expect,
          f"par_newton ptxas report incomplete: {sorted(out)}")
    return out


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
        # Times at the slice's shape (B=4096, T=100), in both dtypes: the
        # trial and the costate recursion, each through its wrapper (ms)
        # and its C entry on outputs allocated once (entry_ms, also per
        # stage in SM cycles).
        B, T_, nx, nu = trial[5].shape
        peak = (PEAK_F32_OPS_PER_S if dtype == torch.float32
                else PEAK_F64_OPS_PER_S)
        entry = seq_trial_entry(trial)
        with SmClock() as clock:
            busy(entry, 0.5)
            rec = {"ms": cuda_ms(lambda: seq_newton_trial_batched(*trial), 50),
                   "entry_ms": cuda_ms(entry, 50)}
        rec.update({
            "max_abs_err": out[f"cartpole_{tag}_trial"]["max_abs_err"],
            "plain_ms": cuda_ms(lambda: seq_newton_trial_plain(*trial), 5),
            "entry": per_stage(rec["entry_ms"], T_, clock.mhz),
            **bound(nbytes(trial, seq_newton_trial_batched(*trial)),
                    B * T_ * riccati_ops(nx, nu), ops_per_s=peak)})
        centry = costate_entry(costate)
        with SmClock() as clock:
            busy(centry, 0.5)
            crec = {"ms": cuda_ms(lambda: seq_costates_batched(*costate), 50),
                    "entry_ms": cuda_ms(centry, 50)}
        crec.update({
            "max_abs_err": out[f"cartpole_{tag}_costates"]["max_abs_err"],
            "plain_ms": cuda_ms(lambda: seq_costates_plain(*costate), 5),
            "entry": per_stage(crec["entry_ms"], T_, clock.mhz),
            **bound(nbytes(costate, seq_costates_batched(*costate)),
                    B * T_ * 2 * nx * nx, ops_per_s=peak)})
        if dtype == torch.float32:
            record["seq_newton_trial"] = rec
            record["seq_costates"] = crec
        else:
            out["timing_float64"] = {"seq_newton_trial": rec,
                                     "seq_costates": crec}
    out["timing"] = record
    out["timing_shape"] = (f"B={LANES}, T={T}, float32 (timing_float64: "
                           "float64), CUDA events around back-to-back calls; "
                           "the trial and the costate recursion through their "
                           "wrappers (ms) and their C entries on outputs "
                           "allocated once (entry_ms), per stage at the "
                           "median SM clock nvidia-smi reported")
    emit(out)
    return record


def busy(fn, seconds):
    """Launch ``fn`` back to back for ``seconds`` of wall clock (so that
    ``SmClock``'s sampler, which reads every 20 ms, sees the card under
    this load)."""
    import torch

    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()


def per_stage(ms, horizon, mhz):
    """A launch's time per stage of its serial sweep: ``ms / horizon`` in
    microseconds, and in SM cycles at ``mhz``."""
    us = 1e3 * ms / horizon
    return {"us_per_stage": us, "cycles_per_stage": us * mhz if mhz else None,
            "sm_clock_mhz": mhz}


def seq_trial_entry(trial):
    """One launch of the seq library's C entry, ``ipoc_seq_trial``, on
    ``trial`` with outputs allocated once: back-to-back calls time the
    kernel, not the wrapper's host work."""
    import torch

    from ipoc_tpu_torch.ops import cuda

    B, T_, nx, nu = trial[5].shape
    kw = dict(dtype=trial[5].dtype, device=trial[5].device)
    outs = (torch.empty((B, T_, (1 + nx) * nu), **kw),
            torch.empty((B, T_, nu), **kw), torch.empty((B, T_ + 1, nx), **kw),
            torch.empty((B,), **kw),
            torch.empty((B,), dtype=torch.bool, device=kw["device"]))
    ptrs = [a.data_ptr() for a in (*trial, *outs)]
    lib, code = cuda.library(), cuda.dtype_code(kw["dtype"])

    def call():
        status = lib.ipoc_seq_trial(code, nx, nu, *ptrs, B, T_,
                                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"seq trial launch status {status}")
        return outs[1:]
    return call


def costate_entry(costate):
    """One launch of the seq library's C entry, ``ipoc_seq_costates``, on
    ``costate`` with its output allocated once."""
    import torch

    from ipoc_tpu_torch.ops import cuda

    B, T_, nx = costate[0].shape
    lam = torch.empty((B, T_ + 1, nx), dtype=costate[0].dtype,
                      device=costate[0].device)
    ptrs = [a.data_ptr() for a in (*costate, lam)]
    lib, code = cuda.library(), cuda.dtype_code(lam.dtype)

    def call():
        status = lib.ipoc_seq_costates(code, nx, *ptrs, B, T_,
                                       torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"costate launch status {status}")
        return lam
    return call


CARD_VS_CPU = {"B": "BATCH_CONFIG.replace(newton_impl='seq')",
               "E": "BATCH_CONFIG",
               "J": "solve_stream_multigrid(coarsen=4, coarse_impl='ddp'), "
                    "BATCH_CONFIG",
               "M": "solve_batch(method='par'), FAST_CONFIG",
               "Nflat": "solve_batch, BATCH_CONFIG.replace(barrier_mode="
                        "'flat')",
               "Nddp": "solve_batch, BATCH_CONFIG.replace(newton_impl='ddp')",
               "R": "solve_stream(warm_transfer=True), BATCH_CONFIG",
               "T3": "quadrotor H=40, solve_stream_multigrid(coarsen=4, "
                     "coarse_impl='ddp'), BATCH_CONFIG"}
# Phase U5's, which runs apart from the loop over CARD_VS_CPU.
U5_CONFIG = ("unicycle H=100, solve_stream_multigrid(coarsen=4, "
             "coarse_impl='ddp'), BATCH_CONFIG")
# The model of a card-against-CPU phase other than cartpole H=100:
# model_ocp's arguments.
CARD_VS_CPU_MODEL = {"T3": ("quadrotor", 1, QUAD_T)}


def card_vs_cpu_solve(phase, u, x0):
    """The solve that phase B, E, J, M, N or R runs on both sides: 256
    scenarios through 64 lanes for the streams, 128 in one lockstep batch
    for M and N.  Returns ``(controls, iterations, steps, extra)``,
    ``extra`` the coarse level's iterations and steps for J."""
    from ipoc_tpu_torch import (
        BATCH_CONFIG,
        FAST_CONFIG,
        solve_batch,
        solve_stream,
        solve_stream_multigrid,
    )

    ocp = model_ocp(*CARD_VS_CPU_MODEL.get(phase, ("cartpole", 1, T)))
    if phase == "T3":
        sol = solve_stream_multigrid(
            ocp, model_ocp("quadrotor", COARSEN, QUAD_T), COARSEN, u, x0,
            BATCH_CONFIG, lanes=64, refill_every=REFILL, coarse_impl="ddp")
        return (sol.controls, sol.iterations.cpu(), sol.steps,
                {"iterations_coarse": sol.iterations_coarse.cpu(),
                 "steps_coarse": sol.steps_coarse})
    if phase in ("M", "Nflat", "Nddp"):
        cfg = (FAST_CONFIG if phase == "M" else
               batch_cfg("flat" if phase == "Nflat" else "ddp"))
        sol = solve_batch(ocp, u, x0, cfg, method="par")
        return sol.controls, sol.iterations.cpu(), None, {}
    if phase == "J":
        sol = solve_stream_multigrid(
            ocp, model_ocp("cartpole", COARSEN), COARSEN, u, x0,
            BATCH_CONFIG, lanes=64, refill_every=REFILL, coarse_impl="ddp")
        return (sol.controls, sol.iterations.cpu(), sol.steps,
                {"iterations_coarse": sol.iterations_coarse.cpu(),
                 "steps_coarse": sol.steps_coarse})
    cfg = (BATCH_CONFIG.replace(newton_impl="seq") if phase == "B"
           else BATCH_CONFIG)
    sol = solve_stream(ocp, u, x0, cfg, lanes=64, refill_every=REFILL,
                       warm_transfer=phase == "R")
    return sol.controls, sol.iterations.cpu(), sol.steps, {}


def cpu_reference_solve(phase):
    """The CPU half of phase B, E, J, M or N: the solve with the plain
    versions on the float64 scenarios.  Runs in a child process
    (``--cpu-reference B|E|J|M|N``) while the card works through the other
    phases; returns ``(controls, iterations, steps, extra, wall_s)``, for N
    a dict of those for Nflat and Nddp, which one process runs in turn.
    For L, the goldens' parallel solves (:func:`golden_par_cpu`); for P,
    the nmpc loop (:func:`nmpc_cpu`); for Q, a dict of the goldens' IP-DDP
    solves (Qgolden) and IP-DDP on the first DDP_SCENARIOS (Qddp)."""
    import torch

    from ipoc_tpu_torch.models import cartpole

    # M's lockstep batch does larger tensor ops than the streams' 64
    # lanes; a second thread keeps its CPU half off the script's critical
    # path.
    torch.set_num_threads(2 if phase == "M" else 1)
    if phase == "L":
        return golden_par_cpu()
    if phase == "T":
        return quad_cpu()
    if phase == "U":
        return uni_cpu()
    if phase == "P":
        return nmpc_cpu()
    pool = make_pool(cartpole, POOL, torch.float32)
    if phase == "Q":
        from ipoc_tpu_torch import FAST_CONFIG, solve_batch

        u, x0 = (a[:DDP_SCENARIOS].double() for a in pool)
        t0 = time.perf_counter()
        sol = solve_batch(model_ocp("cartpole"), u, x0, FAST_CONFIG,
                          method="ddp")
        return {"Qgolden": ddp_golden_cpu(),
                "Qddp": (sol.controls, sol.iterations, None, {},
                         time.perf_counter() - t0)}
    out = {}
    for ph in ("Nflat", "Nddp") if phase == "N" else (phase,):
        n = CARD_VS_CPU_SCENARIOS.get(ph, 256)
        u, x0 = (a[:n].double() for a in pool)
        t0 = time.perf_counter()
        out[ph] = (*card_vs_cpu_solve(ph, u, x0), time.perf_counter() - t0)
    return out if phase == "N" else out[phase]


def phase_card_vs_cpu(phase, pool64, dev, cpu_ref):
    """Phases B (seq stream), E (packed stream), J (multigrid) and the
    second halves of M and N (solve_batch): 256 float64 scenarios, 128 for
    M and N, the card (kernels) against the CPU (plain versions,
    ``cpu_ref``); T3 the quadrotor's multigrid on 128 of phase T's
    scenarios."""
    ocp = model_ocp(*CARD_VS_CPU_MODEL.get(phase, ("cartpole", 1, T)))
    n = CARD_VS_CPU_SCENARIOS.get(phase, 256)
    u, x0 = (a[:n] for a in pool64)
    t0 = time.perf_counter()
    u_card, it_card, steps_card, extra_card = card_vs_cpu_solve(
        phase, u.to(dev), x0.to(dev))
    t_card = time.perf_counter() - t0
    u_cpu, it_cpu, steps_cpu, extra_cpu, t_cpu = cpu_ref
    u_card = u_card.cpu()
    same = it_card == it_cpu
    n_diff = int((~same).sum())
    du_lane = (u_card - u_cpu).abs().flatten(1).amax(1)
    du = float(du_lane[same].max())
    # Lanes whose iteration counts or controls differ: converged raw costs.
    odd = (~same | (du_lane > 1e-9)).nonzero().squeeze(1)
    c_card = raw_costs(ocp, u_card[odd], x0[odd])
    c_cpu = raw_costs(ocp, u_cpu[odd], x0[odd])
    emit({"phase": phase, "config": CARD_VS_CPU[phase], "scenarios": n,
          "lanes": 64 if steps_card is not None else n, "dtype": "float64",
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
          "steps_card": steps_card, "steps_cpu": steps_cpu,
          **coarse_agreement(extra_card, extra_cpu),
          "wall_s_card": t_card, "wall_s_cpu_child": t_cpu})
    # A lane agrees if its iteration count is equal and its controls are
    # within 1e-6; at least 99% must.  Rounding differences between the
    # kernels and the plain versions can flip an accept decision or, over
    # some 300 Newton steps that stop at the solver's tolerance, move the
    # controls along a flat valley: every lane's converged raw cost must
    # still agree to the goldens' rtol 1e-8.
    agree = same & (du_lane <= 1e-6)
    n_bad = len(agree) - int(agree.sum())
    rel = float(((c_card - c_cpu).abs() / c_cpu.abs()).max()) if len(odd) \
        else 0.0
    check(n_bad <= 0.01 * len(agree),
          f"{n_bad} of {len(agree)} lanes differ in iterations or controls")
    check(rel <= 1e-8, f"converged raw costs differ by {rel} relative")


def coarse_agreement(card, cpu):
    """Phase J's coarse level, card against CPU (empty for B and E)."""
    if not card:
        return {}
    same = card["iterations_coarse"] == cpu["iterations_coarse"]
    frac = float(same.double().mean())
    check(frac >= 0.99, f"coarse iterations equal on only {frac} of lanes")
    return {"coarse_lanes_with_different_iterations": int((~same).sum()),
            "steps_coarse_card": card["steps_coarse"],
            "steps_coarse_cpu": cpu["steps_coarse"]}


def raw_costs(ocp, u, x0):
    import torch

    from ipoc_tpu_torch.utils.integrators import rollout

    x = rollout(ocp.dynamics, u, x0)
    return ocp.total_cost(x, u, torch.tensor(1e-9, dtype=u.dtype,
                                             device=u.device))


def kernel_ms(prof, per=1):
    """Device ms per kernel of a profile, divided by ``per``.  Kernel rows
    only: an operator's row carries its kernels' device time too, so
    summing every row would count it twice."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # "void (anonymous namespace)::name<...>(...)": drop the
            # namespace so that each kernel keeps a row of its own.
            key = e.key.replace("(anonymous namespace)::", "")
            key = key.split("(")[0][:60]
            per_kernel[key] = (per_kernel.get(key, 0.0)
                               + e.self_device_time_total / per / 1e3)
    return per_kernel


def top_kernels(per_kernel, n=8):
    return dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:n])


def busy_share(lane, step, warm_iters=30, window=10):
    """Device busy share over a window of lane iterations on the full lane
    batch, after ``warm_iters`` iterations (lanes then sit in several
    barrier stages): device time of the profiler's kernel rows over the
    window divided by the host-clock time of the same window run without
    the profiler.  Returns ``(share, ms per iteration, device ms per
    iteration of the largest kernels)``."""
    import torch
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
    per_kernel = kernel_ms(prof, window)
    dev_ms = sum(per_kernel.values())
    step_ms = wall_us / window / 1e3
    return (dev_ms / step_ms if dev_ms > 0 else None), step_ms, \
        top_kernels(per_kernel)


def run_busy_share(run, wall_s):
    """Device busy share of one whole run: the profiler's kernel-row
    device time of ``run()`` (which waits for the device) divided by
    ``wall_s``, the host-clock time of the same run without the profiler.
    Returns ``(share, device ms of the largest kernels)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    per_kernel = kernel_ms(prof)
    dev_ms = sum(per_kernel.values())
    return dev_ms / (wall_s * 1e3), top_kernels(per_kernel)


def solve_at_width(ocp, u, x0, cfg, lanes):
    """The default stream: ``solve_stream`` (the mega executor for the
    packed configurations)."""
    from ipoc_tpu_torch import solve_stream

    return solve_stream(ocp, u, x0, cfg, lanes=lanes, refill_every=REFILL)


def two_launch_at_width(ocp, u, x0, cfg, lanes):
    """The packed stream's two-launch arm."""
    from ipoc_tpu_torch.solvers.packed_stream import solve_stream_packed

    return solve_stream_packed(ocp, u, x0, cfg, lanes=lanes,
                               refill_every=REFILL, mega=False)


def phase_stream_at_width(phase, cfg, cfg_name, pool32, pool64, dev,
                          lane_fns=None, counters=None, solve=solve_at_width,
                          whole_run_busy=False, ocp=None):
    """Phases C (seq), F (two-launch arm) and H (mega executor): a stream at
    the bench's width on ``pool32``, float32, its launch counts, the
    quality of what comes out, the first 512 raw costs against the float64
    solve on the card, and the device busy share over a window of
    ``lane_fns = (open lanes, one lane iteration)`` and/or, with
    ``whole_run_busy``, over a second whole run.  ``counters`` maps a
    record key to a list that grows by one per event (a lane opening, a
    refill round); the record counts those of the measured run.  Returns
    ``(the emitted record, the solution)``."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap

    ocp = ocp or model_ocp("cartpole")
    u, x0 = (a.to(dev) for a in pool32)
    n = u.shape[0]
    # Warm-up: a small stream (library load, allocator, torch.func caches).
    # Warm-up (libraries loaded, every kernel of the path launched once):
    # one iteration a barrier stage, a few steps even where a step is
    # host-bound (C).
    solve(ocp, u[:256], x0[:256], cfg.replace(max_newton_iters=1),
          256).iterations.cpu()

    counters = counters or {}
    cuda.reset_launches()
    before = {k: len(v) for k, v in counters.items()}
    t0 = time.perf_counter()
    sol = solve(ocp, u, x0, cfg, LANES)
    sol.iterations.cpu()  # waits for the device
    wall = time.perf_counter() - t0
    counts = dict(cuda.launches)
    events = {k: len(v) - before[k] for k, v in counters.items()}
    for k, v in counters.items():
        # A counter that records each call's size (lane openings: B).
        if any(x is not None for x in v[before[k]:]):
            events[f"{k}_B"] = size_summary(v[before[k]:])

    costs = raw_costs(ocp, sol.controls, x0).double().cpu()
    iters = sol.iterations.cpu().double()
    cap = flat_total_cap(cfg)
    finite = bool(torch.isfinite(sol.controls).all())
    umax = float(sol.controls.abs().max())
    nonfinite = float((~torch.isfinite(costs)).double().mean())

    u64, x64 = (a[:512].to(dev) for a in pool64)
    sol64 = solve(ocp, u64, x64, cfg, 512)
    c64 = raw_costs(ocp, sol64.controls, x64).cpu()
    agree = float(((costs[:512] - c64).abs() <= 1e-3 * c64.abs())
                  .double().mean())

    record = {
        "phase": phase, "model": "cartpole", "horizon": u.shape[1],
        "dtype": "float32", "config": cfg_name, "lanes": LANES,
        "refill_every": REFILL, "scenarios": n,
        "pool_note": f"{n // LANES} x lanes (the bench's pool is 32 x "
                     "lanes) to keep the smoke inside its time limit",
        "wall_s": wall, "solves_per_s": n / wall, "steps": sol.steps,
        "ms_per_step_whole_run": wall / max(sol.steps, 1) * 1e3,
        "mean_iterations": float(iters.mean()),
        "max_iterations": int(iters.max()),
        "lanes_at_iteration_cap": {f"{cap}": int((iters >= cap).sum())},
        "mean_raw_cost": float(costs.mean()),
        "frac_nonfinite_cost": nonfinite, "launches": counts, **events,
        "max_abs_u": umax,
        "frac_f32_cost_within_1e-3_of_f64_first512": agree}
    if lane_fns is not None:
        open_lanes, step = lane_fns
        busy, step_ms, top = busy_share(
            open_lanes(ocp, u[:LANES], x0[:LANES]), lambda ln: step(ocp, ln))
        record.update({
            "device_busy_share": busy,
            "busy_window": f"10 iterations of {LANES} lanes after 30, "
                           "profiler kernel-row device time / unprofiled "
                           "host time",
            "window_ms_per_iteration": step_ms,
            "window_device_ms_per_iteration_top_kernels": top})
    if whole_run_busy:
        busy, top = run_busy_share(
            lambda: solve(ocp, u, x0, cfg, LANES).iterations.cpu(), wall)
        record.update({
            "device_busy_share_whole_run": busy,
            "whole_run_device_ms_top_kernels": top})
    emit(record)
    check(finite, "non-finite controls")
    check(umax <= 50.0 + 1e-4, f"|u| = {umax} exceeds the bound 50")
    check(nonfinite == 0.0, f"non-finite raw cost share {nonfinite}")
    return record, sol


def phase_bench_size(pool32, pool64, dev):
    """Phase C: the seq stream at the bench's width, on one pool of
    ``LANES`` scenarios."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.solvers.ip_newton import flat_lane_init, flat_lane_iter

    cfg = BATCH_CONFIG.replace(newton_impl="seq")
    rec, _ = phase_stream_at_width(
        "C", cfg, "BATCH_CONFIG.replace(newton_impl='seq')",
        tuple(a[:LANES] for a in pool32), pool64, dev,
        (lambda ocp, u, x0: flat_lane_init(ocp, u, x0, cfg),
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


def rollout_tol(dtype):
    """The rollout kernel's tolerance against its plain version, relative to
    each output's scale: no reduction and no Riccati sweep, only the
    dynamics' rounding carried through T steps."""
    import torch

    return 1e-12 if dtype == torch.float64 else F32_TOL


def compare_rollout(ocp, u, x0, label, offset=False):
    """The rollout kernel against the one-thread loop it replaced
    (``rollout_reference``) to the bit and against its plain version; the
    first stage must be x0 itself.  With ``offset``, also on inputs one
    scalar past a 16-byte boundary, to the bit of the aligned ones."""
    import torch

    from ipoc_tpu_torch.ops import fused_iter as tf

    got = tf.rollout_packed(ocp, u, x0)
    check(torch.equal(got[0][0], x0), f"{label} rollout: xs[0] != x0")
    check(all(torch.equal(g, r) for g, r in zip(
        got, tf.rollout_reference(ocp, u, x0))),
        f"{label} rollout: not bit for bit the one-thread loop")
    if offset:
        views = tf.rollout_packed(ocp, *(offset_view(a) for a in (u, x0)))
        check(all(torch.equal(g, v) for g, v in zip(got, views)),
              f"{label} rollout: offset views differ from aligned inputs")
    errs = [compare_out(f"{label} rollout[{i}]", g, r, rollout_tol(u.dtype))
            for i, (g, r) in enumerate(zip(got, tf.rollout_plain(ocp, u, x0)))]
    return {"max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs),
            "equal_to_one_thread_loop": True, "offset_views_equal": offset}


def compare_rollout_cost(ocp, u, x0, bp, label, exact, offset=False):
    """The rollout-cost kernel against the one-thread loop it replaced
    (``rollout_cost_reference``): bit for bit where ``exact`` (cartpole;
    elsewhere ``nvcc`` may contract the two programs apart), else the
    outputs that part and by how much.  With ``offset``, also on inputs one
    scalar past a 16-byte boundary, to the bit of the aligned ones."""
    import torch

    from ipoc_tpu_torch.ops import fused_iter as tf

    got = tf.rollout_cost_packed(ocp, u, x0, bp)
    ref = tf.rollout_cost_reference(ocp, u, x0, bp)
    parted = [i for i, (g, r) in enumerate(zip(got, ref))
              if not torch.equal(g, r)]
    check(not exact or not parted, f"{label} rollout_cost: outputs {parted} "
          "not bit for bit the one-thread loop")
    rec = {"equal_to_one_thread_loop": not parted}
    if parted:
        rec["parted_outputs"] = parted
        rec["max_rel_diff_vs_one_thread_loop"] = max(
            float((got[i] - ref[i]).abs().max() / ref[i].abs().max())
            for i in parted)
    if offset:
        views = tf.rollout_cost_packed(ocp, *(offset_view(a)
                                              for a in (u, x0, bp)))
        check(all(torch.equal(g, v) for g, v in zip(got, views)),
              f"{label} rollout_cost: offset views differ from aligned "
              "inputs")
        rec["offset_views_equal"] = True
    return rec


def offset_view(a):
    """``a`` as a contiguous view one scalar past an allocation's start
    (off the 16-byte boundary of the kernels' vector copies)."""
    import torch

    v = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    check(v.data_ptr() % 16 != 0 and v.is_contiguous(), "offset view")
    return v


def compare_fused(ocp, pool, dtype, device, bp, tol, label):
    """All five kernels against their plain versions on one input set;
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
    out = {"rollout": compare_rollout(ocp, u, x0, label)}
    for kernel, triples in outputs.items():
        errs = [compare_out(f"{label} {kernel}[{n}]", g, r, tol)
                for n, g, r in triples]
        out[kernel] = {"max_abs_err": max(e[0] for e in errs),
                       "max_rel_err": max(e[1] for e in errs)}
    out["rollout_cost"].update(compare_rollout_cost(
        ocp, u, x0, bpt, label, label.startswith("cartpole")))
    ok = [torch.isfinite(o[7]) & (o[7] > 0) & torch.isfinite(o[6])
          for o in (got_it, ref_it)]
    check(torch.equal(ok[0], ok[1]), f"{label}: ok flags differ")
    out["ok_frac"] = float(ok[1].double().mean())
    out["lanes"] = u.shape[-1]
    return out


def phase_fused_kernels(pool32, dev):
    """Phase D: the five fused kernels against their plain versions."""
    import torch

    from ipoc_tpu_torch.models import cartpole, pendulum
    from ipoc_tpu_torch.ops import fused_iter as tf

    out = {"phase": "D"}
    cp = model_ocp("cartpole")
    pool = tuple(a[:2 * LANES] for a in pool32)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, F32_TOL)):
        tag = str(dtype).split(".")[-1]
        for bp in (0.1, 0.004):
            out[f"cartpole_{tag}_bp{bp}"] = compare_fused(
                cp, pool, dtype, dev, bp, tol, f"cartpole {tag} bp={bp}")
        pd = model_ocp("pendulum")
        pp = make_pool(pendulum, 512, torch.float32, seed=SEED + 1)
        out[f"pendulum_{tag}"] = compare_fused(
            pd, pp, dtype, dev, 0.1, tol, f"pendulum {tag}")
        # The rollout kernel at the reference sweep's longest horizon, and
        # at a partial first chunk and a part block, offset views too.
        u1k, x1k = (a.to(dev, dtype) for a in make_pool(
            cartpole, 256, torch.float32, horizon=LONG_T))
        out[f"cartpole_T{LONG_T}_B256_{tag}_rollout"] = compare_rollout(
            model_ocp("cartpole", 1, LONG_T), u1k.permute(1, 2, 0)
            .contiguous(), x1k.T.contiguous(), f"cartpole T={LONG_T} {tag}",
            offset=True)
        for name, model in (("cartpole", cartpole), ("pendulum", pendulum)):
            for T_ in (1, 7):
                us, xs0 = (a.to(dev, dtype) for a in make_pool(
                    model, 37, torch.float32, seed=SEED + T_, horizon=T_))
                us, xs0 = us.permute(1, 2, 0).contiguous(), xs0.T.contiguous()
                out[f"{name}_T{T_}_B37_{tag}_rollout"] = compare_rollout(
                    model_ocp(name), us, xs0, f"{name} T={T_} B=37 {tag}",
                    offset=True)
                # The rollout-cost kernel at a partial chunk and a part
                # block, offset views too.
                bp37 = torch.full((37,), 0.1, dtype=dtype, device=dev)
                out[f"{name}_T{T_}_B37_{tag}_rollout_cost"] = \
                    compare_rollout_cost(
                        model_ocp(name), us, xs0, bp37,
                        f"{name} T={T_} B=37 {tag}", name == "cartpole",
                        offset=True)

    # Times at the slice's shape (cartpole, B=4096, T=100, float32; the
    # three group-schedule kernels also float64).
    u, u_other, x0, bpt, rp = fused_inputs(pool, torch.float32, dev, 0.1)
    xs, xT, _, cunsq = tf.rollout_cost_plain(cp, u, x0, bpt)
    reg = rp * torch.clamp(torch.sqrt(cunsq), min=1e-6)
    up = (u + 0.2 * (u - u_other)).contiguous()
    T_, nx, B = xs.shape
    record = fused_times(cp, xs, xT, u, up, x0, bpt, reg)
    f32 = [out[f"cartpole_float32_bp{bp}"] for bp in (0.1, 0.004)]
    for k in tf.KERNELS:
        record[k]["max_abs_err"] = max(o[k]["max_abs_err"] for o in f32)
    # Bounds at the timed shapes: bytes of each launch's inputs and outputs,
    # operations of its generated stage programs and Riccati steps.
    ops = program_ops(cp, nx, 1)
    Kk = tf.fused_bwd_launch(cp, xs, xT, u, bpt, reg)[0]
    per_lane = {
        "fused_bwd": T_ * (ops["stage_bwd"] + riccati_ops(nx, 1)) + ops["term"],
        "fused_fwd": T_ * ops["stage_fwd"] + ops["term_fwd"],
        "rollout": T_ * ops["dynamics"],
        "rollout_cost": T_ * ops["roll_cost"] + ops["final_cost"],
        "transition": T_ * ops["transition"] + 2 * ops["final_cost"],
    }

    def ios(xs, xT, u, bpt, reg, Kk):
        return {
            "fused_bwd": ((xs, xT, u, bpt, reg),
                          tf.fused_bwd_launch(cp, xs, xT, u, bpt, reg)),
            "fused_fwd": ((xs, xT, u, bpt, Kk),
                          tf.fused_fwd_launch(cp, xs, xT, u, bpt, Kk)),
            "rollout": ((u, x0), tf.rollout_packed(cp, u, x0)),
            "rollout_cost": ((u, x0, bpt),
                             tf.rollout_cost_packed(cp, u, x0, bpt)),
            "transition": ((u, up, x0, bpt),
                           tf.transition_packed(cp, u, up, x0, bpt)),
        }

    for k, (ins, outs) in ios(xs, xT, u, bpt, reg, Kk).items():
        record[k].update(bound(nbytes(ins, outs), B * per_lane[k]))
    # The rollout-cost kernel against the loop it replaced, at the slice's
    # width and at the streams' median lane opening, both dtypes.
    turns = {}
    for dtype in (torch.float32, torch.float64):
        for b in (B, OPEN_B):
            ins = (u[..., :b], x0[:, :b], bpt[:b])
            turns[f"B={b} {str(dtype)[6:]}"] = rollout_cost_turns(
                cp, *(a.to(dtype).contiguous() for a in ins))
    out["rollout_cost_turns"] = turns
    # Float64 too, on the same lanes.
    xs, xT, u, up, x0, bpt, reg = (a.double() for a in (xs, xT, u, up, x0,
                                                        bpt, reg))
    rec64 = fused_times(cp, xs, xT, u, up, x0, bpt, reg)
    Kk = tf.fused_bwd_launch(cp, xs, xT, u, bpt, reg)[0]
    io64 = ios(xs, xT, u, bpt, reg, Kk)
    for k in rec64:
        rec64[k].update(bound(nbytes(*io64[k]), B * per_lane[k],
                              ops_per_s=PEAK_F64_OPS_PER_S))
    out["timing_float64"] = rec64
    out["timing"] = record
    out["timing_shape"] = (f"B={LANES}, T={T}, float32 (timing_float64: "
                           "float64), CUDA events around back-to-back calls; "
                           "each kernel through its wrapper (ms) and its C "
                           "entry on outputs allocated once (entry_ms), per "
                           "stage at the median SM clock nvidia-smi "
                           "reported; the plain time of fused_bwd and "
                           "fused_fwd is the plain fused iteration, which "
                           "covers both launches")
    out["errors"] = ("largest absolute error, and error / largest |plain|, "
                     "over each kernel's outputs")
    out["float32_tolerance"] = F32_TOL
    out["rollout_float64_tolerance"] = rollout_tol(torch.float64)
    emit(out)
    return record


def rollout_cost_turns(ocp, u, x0, bp):
    """The rollout-cost kernel's C entry and the one-thread loop's
    (``ipoc_rollout_cost_reference``) on the same inputs with outputs
    allocated once, timed in turns (loop, kernel, kernel, loop) at the SM
    clock: ms, and cycles per stage of the faster of each pair."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import fused_iter as tf

    T_, _, B = u.shape
    nx = x0.shape[0]
    lib, code = tf.library(ocp, nx, 1), cuda.dtype_code(u.dtype)
    ip = tf.pointers((u, x0, bp))
    calls = {}
    for name in ("rollout_cost_reference", "rollout_cost"):
        outs = [torch.empty(sh, dtype=u.dtype, device=u.device)
                for sh in ((T_, nx, B), (nx, B), (B,), (B,))]
        op, fn = tf.pointers(outs), getattr(lib, f"ipoc_{name}")

        def call(fn=fn, op=op, outs=outs, name=name):
            status = fn(code, ip, op, B, T_,
                        torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"{name} launch status {status}")
        calls[name] = call
    order = ("rollout_cost_reference", "rollout_cost", "rollout_cost",
             "rollout_cost_reference")
    with SmClock() as clock:
        busy(calls["rollout_cost"], 0.3)
        ms = [cuda_ms(calls[n], 50) for n in order]
    return {"B": B, "entry_ms": ms[1:3], "reference_entry_ms": [ms[0], ms[3]],
            "entry": per_stage(min(ms[1:3]), T_, clock.mhz),
            "reference_entry": per_stage(min(ms[0], ms[3]), T_, clock.mhz)}


def fused_times(ocp, xs, xT, u, up, x0, bpt, reg):
    """The five fused kernels through their wrappers (ms) and through the
    model library's C entries on outputs allocated once (entry_ms, also per
    stage in SM cycles), beside their plain versions' times."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import fused_iter as tf

    T_, nx, B = xs.shape
    nu = u.shape[1]
    kw = dict(dtype=xs.dtype, device=xs.device)
    lib, code = tf.library(ocp, nx, nu), cuda.dtype_code(xs.dtype)
    Kk = tf.fused_bwd_launch(ocp, xs, xT, u, bpt, reg)[0]
    plain_iter = cuda_ms(lambda: tf.fused_newton_iter_plain(
        ocp, xs, xT, u, bpt, reg), 3)
    kernels = {
        "fused_bwd": ((xs, u, xT, bpt, reg),
                      [(T_, (1 + nx) * nu, B)] + [(B,)] * 4,
                      lambda: tf.fused_bwd_launch(ocp, xs, xT, u, bpt, reg),
                      lambda: plain_iter),
        "fused_fwd": ((xs, u, xT, bpt, Kk),
                      [(T_, nu, B), (T_, nx, B), (nx, B)] + [(B,)] * 3,
                      lambda: tf.fused_fwd_launch(ocp, xs, xT, u, bpt, Kk),
                      lambda: plain_iter),
        "rollout": ((u, x0), [(T_, nx, B), (nx, B)],
                    lambda: tf.rollout_packed(ocp, u, x0),
                    lambda: cuda_ms(lambda: tf.rollout_plain(ocp, u, x0), 3)),
        "rollout_cost": ((u, x0, bpt), [(T_, nx, B), (nx, B), (B,), (B,)],
                         lambda: tf.rollout_cost_packed(ocp, u, x0, bpt),
                         lambda: cuda_ms(lambda: tf.rollout_cost_plain(
                             ocp, u, x0, bpt), 3)),
        "transition": ((u, up, x0, bpt),
                       [(T_, nx, B)] * 2 + [(nx, B)] * 2 + [(B,)] * 4,
                       lambda: tf.transition_packed(ocp, u, up, x0, bpt),
                       lambda: cuda_ms(lambda: tf.transition_plain(
                           ocp, u, up, x0, bpt), 3)),
    }
    record = {}
    for name, (ins, shapes, wrapper, plain_ms) in kernels.items():
        outs = [torch.empty(s, **kw) for s in shapes]
        ip, op = tf.pointers(ins), tf.pointers(outs)
        fn = getattr(lib, f"ipoc_{name}")

        def entry(fn=fn, ip=ip, op=op, name=name):
            status = fn(code, ip, op, B, T_,
                        torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"{name} launch status {status}")
        with SmClock() as clock:
            busy(entry, 0.5)
            rec = {"ms": cuda_ms(wrapper, 50), "entry_ms": cuda_ms(entry, 50)}
        rec["entry"] = per_stage(rec["entry_ms"], T_, clock.mhz)
        rec["plain_ms"] = plain_ms()
        record[name] = rec
    return record


class counting:
    """Count the calls of ``module.name`` inside the ``with`` block: one
    entry appended to ``self.calls`` per call, ``size(*args, **kwargs)``
    where ``size`` is given, else None."""

    def __init__(self, module, name, size=None):
        self.module, self.name, self.calls = module, name, []
        self.size = size

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls.append(self.size(*a, **k) if self.size else None)
            return self.real(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def opened_lanes(ocp, u, *a, **k):
    """B of a ``packed_lane_init`` call: the lanes it opens."""
    return int(u.shape[-1])


def size_summary(sizes):
    """Count, min, lower median and max of the sizes a ``counting`` block
    recorded."""
    s = sorted(sizes)
    if not s:
        return {"count": 0}
    return {"count": len(s), "min": s[0], "median": s[(len(s) - 1) // 2],
            "max": s[-1]}


def open_packed(ocp, u, x0, cfg, bp):
    """Packed lanes from scenario rows ``u (N, T, nu)``, ``x0 (N, nx)`` at
    barrier parameter ``bp`` (one rollout-cost launch on a card)."""
    import torch

    from ipoc_tpu_torch.solvers import packed_stream as ps

    bp0 = torch.full((u.shape[0],), bp, dtype=u.dtype, device=u.device)
    return ps.packed_lane_init(ocp, u.permute(1, 2, 0).contiguous(),
                               x0.T.contiguous(), bp0,
                               torch.full_like(bp0, cfg.reg_init), cfg)


def phase_fused_bench_size(pool32, pool64, dev):
    """Phase F: the packed stream's two-launch arm at the bench's width;
    every per-iteration kernel launches once per step, rollout_cost once
    per lane opening, and 99% of the first 512 float32 raw costs are
    within 1e-3 of the float64 solve."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.solvers import packed_stream as ps

    cfg = BATCH_CONFIG
    with counting(ps, "packed_lane_init", opened_lanes) as opened:
        rec, _ = phase_stream_at_width(
            "F", cfg, "BATCH_CONFIG, two-launch arm (mega=False)", pool32,
            pool64, dev,
            (lambda ocp, u, x0: open_packed(ocp, u, x0, cfg, cfg.bp_init),
             lambda ocp, ln: ps.packed_lane_iter(ocp, ln, cfg, ~ln.done)),
            {"lane_openings": opened.calls}, solve=two_launch_at_width)
    counts, steps = rec["launches"], rec["steps"]
    for k in ("fused_bwd", "fused_fwd", "transition"):
        check(counts[k] == steps, f"{k} launched {counts[k]} times in "
              f"{steps} steps")
    check(counts["rollout_cost"] == rec["lane_openings"] > 0,
          f"rollout_cost launched {counts['rollout_cost']} times for "
          f"{rec['lane_openings']} lane openings")
    check(rec["frac_f32_cost_within_1e-3_of_f64_first512"] >= 0.99,
          "fewer than 99% of 512 float32 costs within 1e-3 of float64")
    check(counts["mega"] == counts["merged_trial"] == 0,
          f"the two-launch arm launched the mega or merged kernel: {counts}")
    return counts


# ---------------------------------------------------------------------------
# The mega kernel, the merged trial and the multigrid: phases G, H, I, J
# ---------------------------------------------------------------------------

TRIAL_OUTS = ("tu", "tx", "txT", "cost", "nc", "mc", "dv", "piv", "hu",
              "cun")
LEVELS = {"newton": (1, False), "ddp": (COARSEN, True)}  # (coarsen, ddp)


def level_inputs(pool32, level, dtype, dev):
    """One level's scenario rows from the pool's first ``LANES``: the fine
    grid (Newton, T=100) or the coarse grid (DDP, T=25, every 4th control
    as the multigrid takes them), with that level's model."""
    coarsen, _ = LEVELS[level]
    u, x0 = (a[:LANES].to(dev, dtype) for a in pool32)
    return (model_ocp("cartpole", coarsen), u[:, ::coarsen].contiguous(),
            x0)


def ended_bad(lane, cfg):
    """Lanes that finished on a non-finite gradient or cost (``bad``), not
    by reaching ``bp_min``: a finished lane keeps its barrier parameter
    only then."""
    return lane.done & (lane.bp > cfg.bp_min)


# The lanes a long mega launch is held to its plain version on (G's k=32,
# U1's k=8 at B=4096): the kernel runs every lane, its plain version, some
# 0.3 s an iteration at 4096 lanes and T=100, the first PLAIN_LANES of
# them (a lane's iterations read no other lane; cut from all when phase U
# came).
PLAIN_LANES = 1024


def first_lanes(lane, n):
    """The packed lanes' first ``n`` lanes (each field's last axis)."""
    return type(lane)(*(a[..., :n].contiguous() for a in lane))


def compare_lanes(got, ref, tol):
    """Two packed lanes.  A lane's decisions agree when its ``it``,
    ``stage_it`` and ``done`` are equal; it agrees when, besides, every
    float field is within ``tol`` of that field's largest finite |ref|
    (equal inf and NaN entries are equal).  Returns both shares, the
    largest relative error over the lanes whose decisions agree, and the
    largest absolute and relative errors over the agreeing lanes."""
    import torch

    B = got.done.shape[0]
    same = torch.ones(B, dtype=torch.bool, device=got.done.device)
    close = same.clone()
    floats = []
    for a, b in zip(got, ref):
        a, b = a.reshape(-1, B), b.reshape(-1, B)
        if a.is_floating_point():
            a, b = a.double(), b.double()
            fin = torch.isfinite(b)
            scale = (float(b[fin].abs().max()) if bool(fin.any()) else 0.0) \
                + 1e-30
            equal = (a == b) | (torch.isnan(a) & torch.isnan(b))
            close &= (equal | ((a - b).abs() <= tol * scale)).all(0)
            floats.append((a, b, scale))
        else:
            same &= (a == b).all(0)
    agree = same & close

    def largest(mask):
        err = rel = 0.0
        for a, b, scale in floats:
            d = (a - b)[:, mask]
            d = d[torch.isfinite(d)]
            if d.numel():
                e = float(d.abs().max())
                err, rel = max(err, e), max(rel, e / scale)
        return err, rel

    err, rel = largest(agree)
    return {"decisions_equal_frac": float(same.double().mean()),
            "agree_frac": float(agree.double().mean()),
            "max_rel_err_equal_decisions": largest(same)[1],
            "max_abs_err": err, "max_rel_err": rel}


def two_launch_iterations(ocp, lane, cfg, k):
    """Up to ``k`` calls of ``packed_lane_iter`` on the two-launch kernels,
    as the two-launch arm runs a refill round (one host read per step).
    Returns ``(lane, steps)``."""
    from ipoc_tpu_torch.solvers.packed_stream import packed_lane_iter

    steps = 0
    for _ in range(k):
        adv = ~lane.done
        if not bool(adv.any()):
            break
        lane = packed_lane_iter(ocp, lane, cfg, adv)
        steps += 1
    return lane, steps


def event_ms(fn, reps, setup=lambda: None, warm=True):
    """Mean device-clock ms of ``fn(setup())`` over ``reps`` calls, after
    one warm call with ``warm``; ``setup`` runs outside the timed span
    (CUDA events around each call, the device idle before it)."""
    import torch

    if warm:
        fn(setup())
    total = 0.0
    for _ in range(reps):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_mega_kernels(pool32, dev):
    """Phase G: the merged trial and the mega kernel against their plain
    versions, the mega kernel against the two-launch kernels, and their
    times."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import fused_iter as tf
    from ipoc_tpu_torch.ops import mega

    out = {"phase": "G"}
    problems = []
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, F32_TOL)):
        tag = str(dtype).split(".")[-1]
        for level, (_, ddp) in LEVELS.items():
            ocp, u, x0 = level_inputs(pool32, level, dtype, dev)
            impl = "ddp" if ddp else "fused"
            for bp in (0.1, 0.004):
                label = f"{level} T={u.shape[1]} {tag} bp={bp}"
                lane = open_packed(ocp, u, x0, BATCH_CONFIG, bp)
                reg = 100.0 * torch.clamp(lane.cun, min=1e-6)
                args = (ocp, lane.xs, lane.xT, lane.u, lane.bp, reg)
                got = tf.merged_trial_launch(*args, ddp=ddp)
                ref = tf.fused_newton_iter_plain(*args, ddp=ddp)
                errs = [compare_out(f"{label} merged[{n}]", g, r, tol)
                        for n, g, r in zip(TRIAL_OUTS, got, ref)]
                ok = [torch.isfinite(o[7]) & (o[7] > 0) & torch.isfinite(o[6])
                      for o in (got, ref)]
                check(torch.equal(ok[0], ok[1]), f"{label}: ok flags differ")
                rec = {"merged_trial": {
                    "max_abs_err": max(e[0] for e in errs),
                    "max_rel_err": max(e[1] for e in errs),
                    "ok_frac": float(ok[1].double().mean())}}
                for k, cap in ((4, 2), (32, BATCH_CONFIG.max_newton_iters)):
                    cfg = BATCH_CONFIG.replace(newton_impl=impl,
                                               max_newton_iters=cap)
                    lane0 = open_packed(ocp, u, x0, cfg, bp)
                    active = torch.ones_like(lane0.done)
                    got, steps = mega.mega_k_iterations(
                        ocp, mega.clone_lane(lane0), active, cfg, k, ddp)
                    n = LANES if k == 4 else PLAIN_LANES
                    ref, ref_steps = mega.mega_k_iterations_plain(
                        ocp, first_lanes(lane0, n), active[:n], cfg, k, ddp)
                    two, two_steps = two_launch_iterations(ocp, lane0, cfg, k)
                    vs_plain = compare_lanes(first_lanes(got, n), ref, tol)
                    vs_two = compare_lanes(got, two, tol)
                    # Against the two-launch kernels (the same generated
                    # code) and over k=4 against the plain version, each
                    # element within phase D's tolerance on 99% of lanes.
                    # Over k=32 the plain version's rounding (torch.func
                    # derivatives, another operation order) grows through
                    # the cold start's Newton steps past that per-element
                    # tolerance: there 99% of lanes must take the same
                    # decisions (it, stage_it, done), as phase E requires.
                    # In float64 the mega kernel equals the two-launch
                    # kernels on every lane.
                    held = [("two-launch", vs_two, "agree_frac",
                             1.0 if dtype == torch.float64 else 0.99),
                            ("plain", vs_plain,
                             "agree_frac" if k == 4 else
                             "decisions_equal_frac", 0.99)]
                    for name, cmp, key, least in held:
                        if cmp[key] < least:
                            problems.append(f"{label} mega k={k} vs {name}: "
                                            f"{key} {cmp[key]}")
                    rolled = float((got.bp < lane0.bp).double().mean())
                    rec[f"mega_k{k}"] = {
                        "steps": int(steps), "plain_steps": int(ref_steps),
                        "two_launch_steps": two_steps,
                        "rolled_over_frac": rolled,
                        "ended_bad": {"kernel": int(ended_bad(got, cfg).sum()),
                                      "plain": int(ended_bad(ref, cfg).sum())},
                        "vs_plain": vs_plain, "vs_two_launch": vs_two}
                    if vs_two["agree_frac"] == 1.0 and int(steps) != two_steps:
                        problems.append(f"{label} k={k}: steps {int(steps)} "
                                        f"!= two-launch {two_steps}")
                    if k == 4 and rolled == 0:
                        problems.append(f"{label}: no lane rolled over in "
                                        "k=4")
                out[f"{level}_{tag}_bp{bp}"] = rec

    # Times at the path's shapes, float32, bp=0.1: the merged trial in DDP
    # mode at T=25, the mega kernel (k=32) at both levels beside its plain
    # version and beside 32 two-launch iterations on the same lanes.
    timing = {}
    for level, (_, ddp) in LEVELS.items():
        ocp, u, x0 = level_inputs(pool32, level, torch.float32, dev)
        cfg = BATCH_CONFIG.replace(newton_impl="ddp" if ddp else "fused")
        lane0 = open_packed(ocp, u, x0, cfg, 0.1)
        reg = 100.0 * torch.clamp(lane0.cun, min=1e-6)
        args = (ocp, lane0.xs, lane0.xT, lane0.u, lane0.bp, reg)
        active = torch.ones_like(lane0.done)
        ws = mega.mega_workspace(lane0)
        with SmClock() as clock:
            rec = {
                "horizon": u.shape[1],
                "merged_trial_ms": cuda_ms(
                    lambda: tf.merged_trial_launch(*args, ddp=ddp), 20),
                "plain_trial_ms": cuda_ms(
                    lambda: tf.fused_newton_iter_plain(*args, ddp=ddp), 3),
                "mega_k32_ms": event_ms(
                    lambda ln: mega.mega_k_iterations(ocp, ln, active, cfg,
                                                      REFILL, ddp, ws),
                    5, lambda: mega.clone_lane(lane0)),
                "plain_k32_ms": event_ms(
                    lambda ln: mega.mega_k_iterations_plain(
                        ocp, ln, active, cfg, REFILL, ddp),
                    1, lambda: lane0, warm=False),
                "two_launch_32_iterations_ms": event_ms(
                    lambda ln: two_launch_iterations(ocp, ln, cfg, REFILL),
                    3, lambda: lane0)}
        _, steps = mega.mega_k_iterations(ocp, mega.clone_lane(lane0),
                                          active, cfg, REFILL, ddp, ws)
        rec["mega_k32_steps"] = int(steps)
        rec["mega_k32"] = per_stage_iteration(
            rec["mega_k32_ms"], int(steps), u.shape[1], clock.mhz)
        timing[level] = rec
    # The merged trial alone at the paths' shapes, both dtypes: Newton at
    # T=100, DDP at T=25 (I's two-launch arm) and at T=100 (phase N's DDP
    # configurations), through its wrapper and its C entry on outputs
    # allocated once (also per stage in SM cycles).
    merged = {}
    for label, level, coarsen in (("newton_T100", "newton", 1),
                                  ("ddp_T25", "ddp", COARSEN),
                                  ("ddp_T100", "ddp", 1)):
        ddp = LEVELS[level][1]
        for dtype in (torch.float32, torch.float64):
            ocp = model_ocp("cartpole", coarsen)
            _, u, x0 = level_inputs(pool32, "newton" if coarsen == 1 else "ddp",
                                    dtype, dev)
            cfg = BATCH_CONFIG.replace(newton_impl="ddp" if ddp else "fused")
            lane0 = open_packed(ocp, u, x0, cfg, 0.1)
            reg = 100.0 * torch.clamp(lane0.cun, min=1e-6)
            args = (ocp, lane0.xs, lane0.xT, lane0.u, lane0.bp, reg)
            entry = merged_entry(*args, ddp)
            with SmClock() as clock:
                busy(entry, 0.5)
                rec = {"ms": cuda_ms(
                    lambda: tf.merged_trial_launch(*args, ddp=ddp), 50),
                    "entry_ms": cuda_ms(entry, 50)}
            rec["entry"] = per_stage(rec["entry_ms"], u.shape[1], clock.mhz)
            merged[f"{label}_{str(dtype)[6:]}"] = rec
    out["merged_trial_timing"] = merged
    out["timing"] = timing
    out["timing_shape"] = (f"B={LANES} lanes opened at bp=0.1, float32, "
                           "CUDA events; newton T=100, ddp T=25 (the "
                           "multigrid's coarse level); per stage-iteration "
                           "at the median SM clock nvidia-smi reported "
                           "during the level's timing; merged_trial_timing "
                           "also float64 and DDP at T=100, through the "
                           "wrapper (ms) and the C entry (entry_ms, per "
                           "stage at the median SM clock)")
    out["float32_tolerance"] = F32_TOL
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))
    f32 = [out[f"{lv}_float32_bp{bp}"] for lv in LEVELS for bp in (0.1, 0.004)]
    # Bounds at the timed shapes: the merged trial in DDP mode at T=25; the
    # mega kernel over the lane iterations its k=32 launch actually ran
    # (lanes that finish stop working), each a Newton trial.
    ocp, u, x0 = level_inputs(pool32, "ddp", torch.float32, dev)
    cfg = BATCH_CONFIG.replace(newton_impl="ddp")
    lane0 = open_packed(ocp, u, x0, cfg, 0.1)
    reg = 100.0 * torch.clamp(lane0.cun, min=1e-6)
    args = (lane0.xs, lane0.xT, lane0.u, lane0.bp, reg)
    T_, nx, B = lane0.xs.shape
    ops = program_ops(ocp, nx, 1)
    merged_bound = bound(
        nbytes(args, tf.merged_trial_launch(ocp, *args, ddp=True)),
        B * (T_ * (ops["stage_bwd"] + riccati_ops(nx, 1)
                   + ops["stage_ddp_fwd"]) + ops["term"]
             + ops["term_ddp_fwd"]))
    ocp, u, x0 = level_inputs(pool32, "newton", torch.float32, dev)
    cfg = BATCH_CONFIG
    lane0 = open_packed(ocp, u, x0, cfg, 0.1)
    got, _ = mega.mega_k_iterations(ocp, mega.clone_lane(lane0),
                                    torch.ones_like(lane0.done), cfg, REFILL,
                                    False)
    lane_iters = int((got.it - lane0.it).sum())
    T_, nx, B = lane0.xs.shape
    ops = program_ops(ocp, nx, 1)
    mega_bound = bound(
        2 * nbytes(tuple(lane0)),
        lane_iters * (T_ * (ops["stage_bwd"] + riccati_ops(nx, 1)
                            + ops["stage_fwd"]) + ops["term"]
                      + ops["term_fwd"]))
    return {
        "merged_trial": {
            "max_abs_err": max(r["merged_trial"]["max_abs_err"] for r in f32),
            "ms": timing["ddp"]["merged_trial_ms"],
            "entry_ms": merged["ddp_T25_float32"]["entry_ms"],
            "plain_ms": timing["ddp"]["plain_trial_ms"], **merged_bound},
        "mega": {
            "max_abs_err": max(r["mega_k4"]["vs_plain"]["max_abs_err"]
                               for r in f32),
            "ms": timing["newton"]["mega_k32_ms"],
            "plain_ms": timing["newton"]["plain_k32_ms"], **mega_bound}}


def merged_entry(ocp, xs, xT, u, bp, reg, ddp):
    """One launch of the model library's C entry, ``ipoc_merged_trial``,
    on outputs allocated once."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import fused_iter as tf

    T_, nx, B = xs.shape
    nu = u.shape[1]
    kw = dict(dtype=xs.dtype, device=xs.device)
    outs = [torch.empty(sh, **kw) for sh in
            [(T_, nu, B), (T_, nx, B), (nx, B)] + [(B,)] * 7
            + [(T_, (1 + nx) * nu, B)]]
    ip, op = tf.pointers((xs, u, xT, bp, reg)), tf.pointers(outs)
    lib, code = tf.library(ocp, nx, nu), cuda.dtype_code(xs.dtype)

    def call():
        status = lib.ipoc_merged_trial(code, int(ddp), ip, op, B, T_,
                                       torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"merged trial launch status {status}")
    return call


def check_mega_path(counts, rounds, openings, gates=0):
    """The mega executor's launches: ``mega`` once per refill round,
    ``rollout_cost`` once per lane opening (plus ``gates`` usable-gate
    launches), no per-iteration kernel."""
    check(counts["mega"] == rounds > 0,
          f"mega launched {counts['mega']} times in {rounds} rounds")
    check(counts["rollout_cost"] == openings + gates,
          f"rollout_cost launched {counts['rollout_cost']} times for "
          f"{openings} openings and {gates} gates")
    for k in ("fused_bwd", "fused_fwd", "transition", "merged_trial"):
        check(counts[k] == 0, f"{k} launched {counts[k]} times on the mega "
              "path")


def phase_mega_stream(pool32, pool64, dev):
    """Phase H: the single-grid stream on the mega executor at the bench's
    width.  Returns the launch counts and the solution (phase I's
    single-grid reference)."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps

    cfg = BATCH_CONFIG
    with counting(ps, "packed_lane_init", opened_lanes) as opened, \
            counting(mega, "mega_k_iterations") as rounds:
        rec, sol = phase_stream_at_width(
            "H", cfg, "BATCH_CONFIG (mega executor)", pool32, pool64, dev,
            counters={"lane_openings": opened.calls,
                      "refill_rounds": rounds.calls},
            whole_run_busy=True)
    counts = rec["launches"]
    check_mega_path(counts, rec["refill_rounds"], rec["lane_openings"])
    check(rec["frac_f32_cost_within_1e-3_of_f64_first512"] >= 0.99,
          "fewer than 99% of 512 float32 costs within 1e-3 of float64")
    return counts, sol


def multigrid_at_width(phase, pool32, dev, single_grid, horizon=T,
                       model="cartpole"):
    """``solve_stream_multigrid`` at bench.py's default (coarsen 4, a DDP
    coarse level, 4096 lanes, refill every 32) on ``pool32``, float32, on
    ``model`` at ``horizon`` (H * dt = 1 s on both levels): its launch
    counts (the mega
    executor's), the whole run's busy share and the quality against the
    single-grid solutions ``single_grid``.  Returns ``(record, solution,
    solve, raw costs)``; ``solve(u, x0, **kw)`` runs it again."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream_multigrid
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps

    cfg = BATCH_CONFIG
    ocp = model_ocp(model, 1, horizon)
    ocp_c = model_ocp(model, COARSEN, horizon)
    u, x0 = (a.to(dev) for a in pool32)
    n = u.shape[0]

    def solve(uu, xx, lanes=LANES, **kw):
        return solve_stream_multigrid(ocp, ocp_c, COARSEN, uu, xx, cfg,
                                      lanes=lanes, refill_every=REFILL,
                                      coarse_impl="ddp", **kw)

    solve(u[:256], x0[:256], lanes=256).iterations.cpu()  # warm-up
    with counting(ps, "packed_lane_init", opened_lanes) as opened, \
            counting(mega, "mega_k_iterations") as rounds:
        cuda.reset_launches()
        t0 = time.perf_counter()
        sol = solve(u, x0)
        sol.iterations.cpu()
        wall = time.perf_counter() - t0
        counts = dict(cuda.launches)
        n_open, n_rounds = len(opened.calls), len(rounds.calls)
        open_b = size_summary(opened.calls)
    busy, top = run_busy_share(lambda: solve(u, x0).iterations.cpu(), wall)

    c_mg = raw_costs(ocp, sol.controls, x0).double().cpu()
    c_sg = raw_costs(ocp, single_grid.controls, x0).double().cpu()
    rel = (c_mg - c_sg).abs() / c_sg.abs().clamp(min=1e-12)
    switched = rel > 1e-3  # another local basin, not noise (bench.py)
    finite = bool(torch.isfinite(sol.controls).all())
    umax = float(sol.controls.abs().max())
    it_f, it_c = (a.cpu().double() for a in (sol.iterations,
                                               sol.iterations_coarse))
    rec = {
        "phase": phase, "model": model, "horizon": horizon,
        "coarsen": COARSEN, "coarse_impl": "ddp", "dtype": "float32",
        "config": "BATCH_CONFIG", "lanes": LANES, "refill_every": REFILL,
        "scenarios": n, "wall_s": wall, "solves_per_s": n / wall,
        "coarse": {"steps": sol.steps_coarse,
                   "mean_iterations": float(it_c.mean()),
                   "max_iterations": int(it_c.max())},
        "fine": {"steps": sol.steps, "mean_iterations": float(it_f.mean()),
                 "max_iterations": int(it_f.max())},
        "launches": counts, "refill_rounds": n_rounds,
        "lane_openings": n_open, "lane_openings_B": open_b,
        "fallback_lanes": int(sol.fallback.sum()),
        "max_abs_u": umax,
        "basin_switch_frac_vs_single_grid": float(switched.double().mean()),
        "mean_signed_rel_cost_delta_switched": float(
            ((c_mg - c_sg) / c_sg.abs().clamp(min=1e-12))[switched].mean())
        if bool(switched.any()) else 0.0,
        "max_rel_cost_delta_matched": float(rel[~switched].max()),
        "finite_controls": finite,
        "device_busy_share_whole_run": busy,
        "whole_run_device_ms_top_kernels": top}
    return rec, sol, solve, c_mg


def check_multigrid(rec, hold_switch=True):
    """The checks of a :func:`multigrid_at_width` record (after it is
    emitted); ``hold_switch`` holds the basin-switch fraction to bench.py's
    5%, which was measured at H=100 only."""
    check(rec["finite_controls"], "non-finite controls")
    check(rec["max_abs_u"] <= 50.0 + 1e-4,
          f"|u| = {rec['max_abs_u']} exceeds the bound 50")
    check(not hold_switch or rec["basin_switch_frac_vs_single_grid"] <= 0.05,
          "basin-switch fraction "
          f"{rec['basin_switch_frac_vs_single_grid']} > 5%")
    check_mega_path(rec["launches"], rec["refill_rounds"],
                    rec["lane_openings"], gates=1)


def phase_multigrid(pool32, dev, single_grid):
    """Phase I: ``solve_stream_multigrid`` at bench.py's default, its
    launch counts and quality against the single-grid solutions
    ``single_grid`` (phase H); then the coarse level on the two-launch arm,
    the merged trial's path."""
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import packed_stream as ps

    ocp = model_ocp("cartpole")
    u, x0 = (a.to(dev) for a in pool32)
    rec, sol, solve, c_mg = multigrid_at_width("I", pool32, dev, single_grid)

    # The coarse level on the two-launch arm: the merged trial once per
    # coarse step; the fine level stays on the mega executor.
    def two_launch_coarse(o, uc, xx, c, lanes, refill_every):
        return ps.solve_stream_packed(o, uc, xx, c, lanes=lanes,
                                      refill_every=refill_every, mega=False)

    cuda.reset_launches()
    sol2 = solve(u, x0, coarse_solver=two_launch_coarse)
    sol2.iterations.cpu()
    counts2 = dict(cuda.launches)
    same_c = sol2.iterations_coarse.cpu() == sol.iterations_coarse.cpu()
    same_f = sol2.iterations.cpu() == sol.iterations.cpu()
    c2 = raw_costs(ocp, sol2.controls, x0).double().cpu()
    near = float(((c2 - c_mg).abs() <= 1e-3 * c_mg.abs()).double().mean())
    rec["coarse_two_launch"] = {
        "launches": counts2, "steps_coarse": sol2.steps_coarse,
        "steps": sol2.steps,
        "frac_equal_coarse_iterations_vs_mega": float(
            same_c.double().mean()),
        "frac_equal_fine_iterations_vs_mega": float(same_f.double().mean()),
        "frac_raw_cost_within_1e-3_vs_mega": near}
    emit(rec)
    check_multigrid(rec)
    check(counts2["merged_trial"] == counts2["transition"]
          == sol2.steps_coarse > 0,
          f"merged_trial launched {counts2['merged_trial']} times in "
          f"{sol2.steps_coarse} coarse steps")
    # Both arms run the same trial code; their float32 glue rounds
    # differently, so accept decisions flip on some lanes and a few land in
    # another basin: the solutions are held to the basin-switch bound.
    check(near >= 0.95, f"only {near} of the two-launch coarse arm's "
          "solutions within 1e-3 of the mega run's raw costs")
    return rec["launches"], counts2


# ---------------------------------------------------------------------------
# The parallel-in-time slice: phases K, L, M
# ---------------------------------------------------------------------------

# tests/test_golden.py's warm start, 0.1 * jax.random.normal(PRNGKey(1),
# (100, 1)) in float64, written out because this script imports no jax;
# tests/test_torch_par_golden.py holds it to JAX's draw.
GOLDEN_WARM_START = (
    -0.11842844218378551, -0.011617040844628399, 0.017269028009903428,
    0.09573071790540393, -0.08329541450744178, 0.06908051716286406,
    0.007545020754047458, -0.07645270989348373, -0.005064538917471915,
    -0.1352474213301947, -0.0985917341545191, -0.11198478915637924,
    0.047528386801689415, 0.05933369331746692, 0.1281290415640692,
    -0.06461786382589661, 0.07496310575619733, -0.048255831614092394,
    0.13608633612173524, 0.016367777491860438, -0.12559112836204597,
    -0.14894827238927302, 0.1094408412345168, 0.04482111004887972,
    0.22928366253554794, -0.07643387370573117, 0.1350904340556187,
    -0.03451453097725925, 0.0367125428285667, 0.010898000348012271,
    0.0035276497405441806, 0.07905961731079757, 0.05465778641720681,
    -0.2104645576573327, 0.2852279828152687, 0.10644858480771671,
    -0.03162467206008989, -0.07811220936346991, 0.015006970352093384,
    0.25803731986246886, -0.05856053363405975, -0.16387337250700462,
    -0.055103642705170264, 0.12132236940964612, -0.0017399022997577358,
    0.01908949755215974, 0.23381403500912754, -0.03797890594728668,
    0.012998894901574784, -0.05413653142590367, -0.18315929966046376,
    0.1187706504213959, -0.0015734571705448433, -0.1468879929810107,
    -0.0006954086998909839, 0.12856023857129553, 0.05153416714435425,
    -0.06053759249440922, 0.06083738024071479, 0.021711397575949688,
    -0.08748549960008549, 0.17864132564813517, -0.111872731206387,
    0.06496266367209362, 0.006701764798569827, -0.02613683694271575,
    -0.05837135236569579, -0.06330983663306441, 0.06312029227334444,
    0.032496859553296634, -0.03287366345550891, -0.1913302558084512,
    -0.18326345809866365, 0.1626055554224045, 0.055867975676351725,
    -0.04812694913695275, -0.04530961694701566, -0.012955049797916153,
    0.0016328319351252, 0.044215978230800146, -0.11409040287957697,
    -0.1169147962095632, -0.2554408121361101, 0.12199858065725105,
    0.1607009287926262, 0.051965466815536945, 0.027957746997006556,
    0.15588819165701753, 0.20543476319111253, -0.18897968907426008,
    -0.22862533080315262, 0.05393380895353225, -0.009858133730438567,
    0.07170683476584756, -0.0486799347374337, 0.2163138673923172,
    -0.14909893736198096, 0.0022147157384965073, 0.06096970581057207,
    -0.0896091910195345,
)
PAR_TRIAL_TOL = {"float64": (1e-10, 1e-10), "float32": (2e-5, 1e-4)}


def horizon_ocp(T_):
    """Cartpole at horizon ``T_`` with H * dt = 1 s (the reference sweep)."""
    return model_ocp("cartpole", 1, T_)


def par_inputs(T_, B, dtype, dev, seed=SEED, model="cartpole"):
    """The parallel trial's inputs at a cold start of ``model`` at horizon
    ``T_`` (cartpole: random controls; the quadrotor: random controls about
    hover thrust), as a solve's first iteration computes them (bp=0.1, the
    Levenberg parameter 1 scaled by ||cu||), and the three scans' inputs
    on the same data: the costate elements (T+1 of them, suffix), the value
    elements of the Newton LQT (T), and the closed-loop elements from its
    gains (T, prefix).  Returns ``(trial, scans)``, ``scans`` a dict of
    argument tuples."""
    import torch

    from ipoc_tpu_torch import FAST_CONFIG
    from ipoc_tpu_torch.ops.derivatives import (
        compute_first_order,
        compute_hamiltonian_lqr,
        final_gradient,
        final_hessian,
    )
    from ipoc_tpu_torch.ops.scan_kernels import affine_scan_plain
    from ipoc_tpu_torch.solvers.ip_newton import _regularized
    from ipoc_tpu_torch.utils.integrators import rollout

    ocp = model_ocp(model, 1, T_)
    mod = model_module(model)
    hover = getattr(mod, "HOVER", 0.0)
    x_base = mod.initial_state(torch.float64)
    nx, nu = x_base.shape[0], 2 if model == "quadrotor" else 1
    gen = torch.Generator().manual_seed(seed)
    u = hover + 0.1 * torch.randn((B, T_, nu), generator=gen,
                                  dtype=torch.float64)
    x0 = x_base + 0.01 * torch.randn((B, nx), generator=gen,
                                     dtype=torch.float64)
    u, x0 = u.to(dev, dtype), x0.to(dev, dtype)
    x = rollout(ocp.dynamics, u, x0)
    bp = torch.tensor(0.1, dtype=dtype, device=dev)
    d = compute_first_order(ocp, x, u, bp)
    lam_T = final_gradient(ocp, x[:, -1])
    F = torch.cat([d.fx.transpose(-1, -2), torch.zeros_like(d.fx[:, :1])], 1)
    c = torch.cat([d.cx, lam_T[:, None]], 1)
    costate = (F.contiguous(), c.contiguous())
    lam = affine_scan_plain(*costate, reverse=True)[1]
    lin = _regularized(compute_hamiltonian_lqr(ocp, x, u, lam, bp), d,
                       torch.ones((B,), dtype=dtype, device=dev), True,
                       FAST_CONFIG.reg_scale_floor)
    trial = tuple(a.contiguous() for a in (lin.r, lin.Q, lin.R, lin.M, d.fx,
                                           d.fu, final_hessian(ocp, x[:, -1])))
    return trial, scan_inputs(trial, costate)


def scan_inputs(trial, costate=None):
    """The value scan's and the forward pass's affine scan's inputs from a
    trial's stage data (the pipeline's own intermediates)."""
    import torch

    from ipoc_tpu_torch.parallel import lqt as L
    from ipoc_tpu_torch.problem import Derivatives, LinearizedOCP

    ru, Q, R, M, fx, fu, XT = trial
    d = Derivatives(None, None, None, None, None, fx, fu, None, None, None)
    lqt = L.newton_lqt(LinearizedOCP(ru, Q, R, M), d, XT)
    K, kff = L.par_bwd_pass(lqt, plain=True)[:2]
    F, e = L._closed_loop(lqt, K, kff)
    F = torch.cat([torch.zeros_like(F[:, :1]), F[:, 1:]], 1)
    scans = {"value": tuple(a.contiguous() for a in L._elements(lqt)),
             "prefix": (F.contiguous(), e.contiguous())}
    if costate is not None:
        scans["suffix"] = costate
    return scans


def compare_scans(scans, tol, label):
    """Each scan kernel against its plain version: the largest error of
    each output relative to that output's largest entry."""
    from ipoc_tpu_torch.ops import scan_kernels as sk

    out = {}
    for kind, args in scans.items():
        if kind == "value":
            got, ref = sk.value_scan(*args), sk.value_scan_plain(*args)
        else:
            rev = kind == "suffix"
            got = sk.affine_scan(*args, reverse=rev)
            ref = sk.affine_scan_plain(*args, reverse=rev)
        errs = [compare_out(f"{label} {kind} scan[{i}]", g, r, tol)
                for i, (g, r) in enumerate(zip(got, ref))]
        out[f"{kind}_scan"] = {"max_abs_err": max(e[0] for e in errs),
                               "max_rel_err": max(e[1] for e in errs)}
    return out


def compare_par_trial(trial, tol, label):
    """The one-launch trial against its plain version (the pipeline on the
    scans' plain versions, tolerance ``tol`` of each output's scale) and
    against the pipeline on the scan kernels (``PAR_TRIAL_TOL``: du, dx of
    du's scale, pred relative); equal ok flags."""
    from ipoc_tpu_torch.ops import newton_kernel as nk

    tag = str(trial[0].dtype).split(".")[-1]
    got = nk.fused_newton_step(*trial)
    plain = nk.fused_newton_step_plain(*trial)
    pipe = nk.newton_pipeline(*trial)
    out = {}
    for name, ref in (("vs_plain", plain), ("vs_pipeline", pipe)):
        check(bool((got[3] == ref[3]).all()), f"{label} {name}: ok differs")
        ok = ref[3]
        check(bool(ok.any()), f"{label}: no feasible lane")
        scale = float(ref[0][ok].abs().max()) + 1e-30
        err = max(float((got[i][ok] - ref[i][ok]).abs().max())
                  for i in (0, 1))
        prel = float(((got[2][ok] - ref[2][ok]).abs()
                      / ref[2][ok].abs()).max())
        dtol, ptol = ((tol, tol) if name == "vs_plain"
                      else PAR_TRIAL_TOL[tag])
        check(err <= dtol * scale, f"{label} {name}: |d(du,dx)| {err} > "
              f"{dtol} * {scale}")
        check(prel <= ptol, f"{label} {name}: pred rel err {prel}")
        out[name] = {"max_abs_err": err, "rel_err": err / scale,
                     "pred_max_rel_err": prel}
    out["ok_frac"] = float(got[3].double().mean())
    return out


def phase_par_kernels(dev):
    """Phase K: the affine scan (both directions), the value scan and the
    one-launch trial against their plain versions on cartpole stage data
    (T=100 and T=1000, B=1 and B=1024) and random nx=3, nu=2 data (T=129),
    float64 then float32; an indefinite R on one lane; the trial against
    the pipeline on the scan kernels, a path of its own (the public LQT
    passes), whose launch counts are read here; then each kernel's time
    beside its plain version's."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk

    out = {"phase": "K"}
    cases = [(T_, B) for T_ in PAR_HORIZONS for B in (1, PAR_BATCH)]
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, F32_TOL)):
        tag = str(dtype).split(".")[-1]
        for T_, B in cases:
            label = f"cartpole T={T_} B={B} {tag}"
            trial, scans = par_inputs(T_, B, dtype, dev)
            out[label] = {**compare_scans(scans, tol, label),
                          "trial": compare_par_trial(trial, tol, label)}
        # The scans alone at a horizon below one lane each, a partial
        # chunk and one past a warp of lanes.
        for T_ in (1, 7, 33):
            label = f"cartpole T={T_} B={PAR_BATCH} {tag}"
            out[label] = compare_scans(
                par_inputs(T_, PAR_BATCH, dtype, dev)[1], tol, label)
        gen = torch.Generator().manual_seed(SEED)
        trial, _ = random_stage_data(gen, PAR_BATCH, 129, 3, 2, dtype, dev)
        label = f"random nx=3 nu=2 T=129 B={PAR_BATCH} {tag}"
        out[label] = {**compare_scans(scan_inputs(trial), tol, label),
                      "trial": compare_par_trial(trial, tol, label)}
        # One stage of one lane with an indefinite R: that lane only fails.
        ru, Q, R, M, fx, fu, XT = par_inputs(T, PAR_BATCH, dtype, dev)[0]
        R = R.clone()
        R[3, 17] = -1.0
        bad = (ru, Q, R, M, fx, fu, XT)
        ok_k = nk.fused_newton_step(*bad)[3]
        ok_p = nk.fused_newton_step_plain(*bad)[3]
        check(torch.equal(ok_k, ok_p) and not bool(ok_k[3])
              and int(ok_k.sum()) == PAR_BATCH - 1,
              f"indefinite R on lane 3 ({tag}): ok kernel "
              f"{int(ok_k.sum())}, plain {int(ok_p.sum())} of {PAR_BATCH}")
        out[f"indefinite_R_lane3_{tag}_ok_count"] = int(ok_k.sum())

    # The public LQT passes on a card (newton_lqt -> par_bwd_pass ->
    # par_fwd_pass): counts from 0, one value scan and one prefix affine
    # scan, no trial kernel.
    trial, scans = par_inputs(T, PAR_BATCH, torch.float32, dev)
    cuda.reset_launches()
    nk.newton_pipeline(*trial)
    torch.cuda.synchronize()
    pipeline_counts = {k: v for k, v in cuda.launches.items() if v}
    check(pipeline_counts == {"value_scan": 1, "affine_scan": 1},
          f"the LQT passes launched {pipeline_counts}")
    out["lqt_passes_launches"] = pipeline_counts

    # Times: B=1024 at T=100 (phase M's batch) and B=1 at T=1000 (phase
    # L's single solve), float32 and float64; the trial with the launch
    # geometry its wrapper picked, the affine scan with its lanes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timing = {}
    for T_, B in ((T, PAR_BATCH), (1000, 1)):
        for dtype in (torch.float32, torch.float64):
            trial, scans = par_inputs(T_, B, dtype, dev)
            nx, nu = trial[5].shape[-2:]
            fns = {"par_newton_trial": (
                lambda: nk.fused_newton_step(*trial),
                lambda: nk.fused_newton_step_plain(*trial), trial,
                par_trial_ops(B, T_, nx, nu))}
            for kind in ("suffix", "prefix"):
                name = "affine_scan" + ("" if kind == "suffix" else "_prefix")
                rev = kind == "suffix"
                fns[name] = (
                    lambda a=scans[kind], r=rev: sk.affine_scan(*a, r),
                    lambda a=scans[kind], r=rev: sk.affine_scan_plain(*a, r),
                    scans[kind], B * scans[kind][1].shape[1]
                    * affine_combine_ops(nx))
            fns["value_scan"] = (
                lambda: sk.value_scan(*scans["value"]),
                lambda: sk.value_scan_plain(*scans["value"]),
                scans["value"], B * (T_ - 1) * value_combine_ops(nx))
            peak = (PEAK_F32_OPS_PER_S if dtype == torch.float32
                    else PEAK_F64_OPS_PER_S)
            rec = {}
            for name, (kernel, plain, ins, ops) in fns.items():
                rec[name] = {"ms": cuda_ms(kernel, 50),
                             "plain_ms": cuda_ms(plain, 3),
                             **bound(nbytes(ins, kernel()), ops,
                                     ops_per_s=peak)}
                if name != "par_newton_trial":
                    # The scan's C entry on outputs allocated once, also
                    # per element of its horizon in SM cycles.
                    entry = scan_entry(name, ins)
                    with SmClock() as clock:
                        busy(entry, 0.3)
                        rec[name]["entry_ms"] = cuda_ms(entry, 50)
                    rec[name]["entry"] = per_stage(
                        rec[name]["entry_ms"], ins[1].shape[1], clock.mhz)
                    rec[name]["lanes"] = sk.scan_lanes(
                        B, ins[1].shape[1], dtype, sms,
                        value=name == "value_scan", n=nx)
            # Through its wrapper (ms) the trial is paced by the wrapper's
            # host work at these shapes: its C entry on preallocated
            # outputs (entry_ms) gives the kernel's time.
            trial_rec = rec["par_newton_trial"]
            trial_rec["entry_ms"] = cuda_ms(trial_entry(
                cuda.library(cuda.PAR_NEWTON), trial, sms), 50)
            lanes = nk.trial_lanes(B, T_, sms, nx, dtype)
            occ = nk.trial_occupancy(dtype, nx, nu, lanes)
            trial_rec["geometry"] = {
                "lanes": lanes, "blocks": -(-B // occ["scenarios_per_block"]),
                "threads_per_block": occ["threads_per_block"]}
            tag = "" if dtype == torch.float32 else " float64"
            timing[f"T={T_} B={B}{tag}"] = rec
    out["timing"] = timing
    out["timing_shape"] = ("float32 and float64, CUDA events around "
                           "back-to-back calls after a warm one; each kernel "
                           "through its wrapper (ms) and its C entry on "
                           "preallocated outputs (entry_ms; the scans' also "
                           "per element of their horizon in SM cycles); the "
                           "affine scan in its suffix mode on the costate "
                           "elements (T+1), affine_scan_prefix on the LQT "
                           "forward pass's closed-loop elements (T)")
    out["float32_tolerance"] = F32_TOL
    emit(out)
    f32 = [v for k, v in out.items() if k.endswith("float32")]
    record = {}
    for name in ("affine_scan", "value_scan", "par_newton_trial"):
        if name == "par_newton_trial":
            err = max(r["trial"]["vs_plain"]["max_abs_err"] for r in f32
                      if "trial" in r)
        else:
            err = max(r[k]["max_abs_err"] for r in f32 for k in r
                      if k.endswith("_scan")
                      and (k == "value_scan") == (name == "value_scan"))
        record[name] = {"max_abs_err": err,
                        **timing[f"T={T} B={PAR_BATCH}"][name]}
    return record, pipeline_counts


def scan_entry(name, args):
    """One launch of a scan's C entry (``ipoc_affine_scan`` in the suffix
    mode, or in the prefix mode for ``affine_scan_prefix``;
    ``ipoc_value_scan``), at the wrapper's lanes per scenario, on ``args``
    with outputs allocated once."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import scan_kernels as sk

    lib = cuda.library(cuda.PAR_NEWTON)
    B, T_, n = args[1].shape
    outs = [torch.empty_like(a) for a in args]
    ptrs = [a.data_ptr() for a in (*args, *outs)]
    code = cuda.dtype_code(args[0].dtype)
    sms = cuda.sm_count(args[0].device)
    if name == "value_scan":
        fn, head = lib.ipoc_value_scan, (
            code, n, sk.scan_lanes(B, T_, args[0].dtype, sms, value=True,
                                   n=n))
    else:
        fn, head = lib.ipoc_affine_scan, (
            code, n, int(name == "affine_scan"),
            sk.scan_lanes(B, T_, args[0].dtype, sms, n=n))

    def call():
        status = fn(*head, *ptrs, B, T_,
                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"{name} launch status {status}")
    return call


def trial_entry(lib, trial, sms):
    """One launch of the trial library's C entry, ``ipoc_par_newton_trial``,
    on ``trial`` with outputs allocated once, at the wrapper's lanes per
    scenario: back-to-back calls time the kernel, not the wrapper's host
    work."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk

    check(all(a.data_ptr() % 16 == 0 for a in trial),
          "the trial's entry needs 16-byte aligned inputs")
    B, T_, nx, nu = trial[5].shape
    kw = dict(dtype=trial[5].dtype, device=trial[5].device)
    outs = (torch.empty((B, T_, nu * (1 + nx)), **kw),
            torch.empty((B, T_, nu), **kw), torch.empty((B, T_ + 1, nx), **kw),
            torch.empty((B,), **kw),
            torch.empty((B,), dtype=torch.bool, device=kw["device"]))
    head = (cuda.dtype_code(kw["dtype"]), nx, nu,
            nk.trial_lanes(B, T_, sms, nx, kw["dtype"]))
    ptrs = [a.data_ptr() for a in (*trial, *outs)]

    def call():
        status = lib.ipoc_par_newton_trial(
            *head, *ptrs, B, T_, torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"trial launch status {status}")
        return outs[1:]
    return call


def golden_setup(name):
    import numpy as np
    import torch

    from ipoc_tpu_torch.models import cartpole, pendulum

    here = os.path.dirname(os.path.abspath(__file__))
    data = np.load(os.path.join(here, "tests", "golden", f"{name}_h100.npz"))
    model = {"cartpole": cartpole, "pendulum": pendulum}[name]
    u0 = torch.tensor(GOLDEN_WARM_START, dtype=torch.float64)[:, None]
    return data, model_ocp(name), u0, model.initial_state(torch.float64)


PARITY = "DEFAULT_CONFIG.replace(stall_exit=False)"


def golden_par_cpu():
    """The CPU half of phase L: the goldens' float64 parallel solves with the
    plain versions, ``{model: (controls, iterations)}``."""
    from ipoc_tpu_torch import DEFAULT_CONFIG
    from ipoc_tpu_torch import par_interior_point_optimal_control as par

    out = {}
    for name in ("pendulum", "cartpole"):
        _, ocp, u0, x0 = golden_setup(name)
        u, it = par(ocp, u0, x0, DEFAULT_CONFIG.replace(stall_exit=False))
        out[name] = (u, int(it))
    return out


def counted_solve(solve, *args):
    """One solve with the launch counts from 0, the trials (calls of
    ``par_newton_step``), the Newton iterations' costate scans (calls of
    ``_costates``) and the host reads (``bool()`` of a tensor: the loop
    predicates) counted: ``(result, launches, trials, costate calls, host
    reads)``."""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import ip_newton

    with counting(ip_newton, "par_newton_step") as trials, \
            counting(ip_newton, "_costates") as scans, \
            counting(torch.Tensor, "__bool__") as reads:
        cuda.reset_launches()
        res = solve(*args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.launches.items() if v}
    return (res, launches, len(trials.calls), len(scans.calls),
            len(reads.calls))


def window_busy(run):
    """Device busy share over one window of an eager solve, ``run()``
    (which waits for the device): its kernel time from a CUDA-only profile
    over its host-clock time without the profiler.  A whole eager solve
    issues 10^5-10^6 kernels, which the profiler takes minutes to collect,
    so the callers pass a window: the first barrier stage, or its first
    lockstep iterations.  Returns ``(share, window wall s, device ms per
    kernel)``."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    run()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    per_kernel = kernel_ms(prof)
    return sum(per_kernel.values()) / (wall_s * 1e3), wall_s, per_kernel


def trial_share(per_kernel, wall_s, window_trials, trials, solve_wall_s):
    """The parallel trial kernel's device ms in a window's profile (of
    ``window_trials`` launches) and its share of the window's device time
    and of its wall; and, at the window's ms per launch, the share of a
    whole solve's wall (``trials`` launches in ``solve_wall_s``)."""
    trial = sum(v for k, v in per_kernel.items()
                if "par_newton_trial_kernel" in k)
    device = sum(per_kernel.values())
    per_launch = trial / window_trials if window_trials else None
    return {"device_ms": trial, "launches": window_trials,
            "ms_per_launch": per_launch,
            "share_of_device_time": trial / device if device else None,
            "share_of_wall": trial / (wall_s * 1e3),
            "solve_share_of_wall": (per_launch * trials / (solve_wall_s * 1e3)
                                    if per_launch else None)}


def window_trials(run):
    """``window_busy(run)`` and the trial launches of one run of the
    window (it runs twice: timed, then profiled)."""
    from ipoc_tpu_torch.ops import cuda

    cuda.reset_launches()
    busy, wall_s, per_kernel = window_busy(run)
    return busy, wall_s, per_kernel, cuda.launches["par_newton_trial"] // 2


def phase_single_solve(dev, cpu_ref):
    """Phase L: ``par_interior_point_optimal_control`` on the card.  The
    goldens (pendulum and cartpole H=100, float64, PARITY_CFG) against
    tests/golden/*.npz and against the CPU run's iterations, with the seq
    solve beside them; then cartpole at H=1000 under FAST_CONFIG in float32
    and float64: iterations, trials, wall time (one solve), host reads
    and each kernel's launches per solve, and the busy share over the first
    barrier stage."""
    import numpy as np
    import torch

    from ipoc_tpu_torch import DEFAULT_CONFIG, FAST_CONFIG
    from ipoc_tpu_torch import par_interior_point_optimal_control as par
    from ipoc_tpu_torch import seq_interior_point_optimal_control as seq
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.ops.derivatives import check_feasibility
    from ipoc_tpu_torch.utils.integrators import rollout

    cfg_parity = DEFAULT_CONFIG.replace(stall_exit=False)
    out = {"phase": "L", "golden_config": PARITY}
    for name in ("pendulum", "cartpole"):
        t_golden = time.perf_counter()
        data, ocp, u0, x0 = golden_setup(name)
        (u, it), launches, trials, scans, _ = counted_solve(
            par, ocp, u0.to(dev), x0.to(dev), cfg_parity)
        u, it = u.cpu(), int(it)
        bp = torch.tensor(float(data["final_bp"]), dtype=torch.float64)
        cost = float(ocp.total_cost(rollout(ocp.dynamics, u, x0), u, bp))
        cost_rel = abs(cost - float(data["cost_seq"])) / abs(
            float(data["cost_seq"]))
        du = float(np.abs(u.numpy() - data["u_seq"]).max())
        u_cpu, it_cpu = cpu_ref[name]
        out[f"golden_{name}"] = {
            "par_iterations": it, "par_iterations_cpu": it_cpu,
            "trials": trials, "launches": launches,
            "cost_rel_err_vs_golden": cost_rel,
            "max_abs_du_vs_golden": du,
            "max_abs_du_vs_cpu": float((u - u_cpu).abs().max()),
            "par_wall_s": time.perf_counter() - t_golden}
        check(cost_rel <= 1e-8, f"{name} par cost rel err {cost_rel}")
        check(du <= 5e-2, f"{name} par |du| vs golden {du}")
        if name in GOLDEN_SEQ:
            t_seq = time.perf_counter()
            u_s, it_s = seq(ocp, u0.to(dev), x0.to(dev), cfg_parity)
            du_seq = float(np.abs(u_s.cpu().numpy() - data["u_seq"]).max())
            out[f"golden_{name}"].update({
                "seq_iterations": int(it_s), "seq_iterations_golden": int(
                    data["iters_seq"]), "seq_max_abs_du_vs_golden": du_seq,
                "seq_wall_s": time.perf_counter() - t_seq})
            check(du_seq <= 1e-6, f"{name} seq |du| vs golden {du_seq}")
        check(it == it_cpu, f"{name} par iterations card {it}, CPU {it_cpu}")
        check(launches == {"affine_scan": scans, "par_newton_trial": trials}
              and scans == it,
              f"{name}: launches {launches}, {it} iterations, {trials} "
              "trials")

    T_ = PAR_HORIZONS[-1]
    ocp = horizon_ocp(T_)
    gen = torch.Generator().manual_seed(SEED)
    u0 = 0.1 * torch.randn((T_, 1), generator=gen, dtype=torch.float64)
    x0 = cartpole.initial_state(torch.float64)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        uu, xx = u0.to(dev, dtype), x0.to(dev, dtype)

        def solve():
            u, it = par(ocp, uu, xx, FAST_CONFIG)
            return u.cpu(), int(it)

        # One timed solve, also counted (the counters cost a Python call
        # per counted event); cut from the median of 3 when phase S came.
        t0 = time.perf_counter()
        (u, it), launches, trials, scans, reads = counted_solve(solve)
        wall = time.perf_counter() - t0
        x = rollout(ocp.dynamics, u.double(), x0)
        feasible = bool(check_feasibility(ocp, x, u.double()))
        raw = float(ocp.total_cost(x, u.double(),
                                   torch.tensor(1e-9, dtype=torch.float64)))
        out[f"H{T_}_{tag}"] = {
            "config": "FAST_CONFIG", "iterations": it, "trials": trials,
            "costate_scans": scans, "launches_per_solve": launches,
            "wall_s": wall, "host_reads_per_solve": reads,
            "max_abs_u": float(u.abs().max()), "feasible": feasible,
            "raw_cost": raw}
        if dtype == torch.float32:
            # The busy share over the first barrier stage, float32 only
            # (float64's was cut when phase U came).
            first = FAST_CONFIG.replace(bp_min=FAST_CONFIG.bp_init * 0.99)
            busy, wall_first, per_kernel, n_window = window_trials(
                lambda: par(ocp, uu, xx, first)[0].cpu())
            out[f"H{T_}_{tag}"].update({
                "device_busy_share_first_stage": busy,
                "first_stage_wall_s": wall_first,
                "first_stage_device_ms_top_kernels": top_kernels(per_kernel),
                "first_stage_trial": trial_share(per_kernel, wall_first,
                                                 n_window, trials, wall)})
        check(bool(torch.isfinite(u).all()) and feasible and it > 0,
              f"H={T_} {tag}: infeasible or non-finite solution")
        check(launches == {"affine_scan": scans, "par_newton_trial": trials}
              and scans == it,
              f"H={T_} {tag}: launches {launches}, {it} iterations, "
              f"{trials} trials")
    emit(out)
    return out


def phase_batch_solve(pool32, dev):
    """Phase M: ``solve_batch(method="par")`` on the pool's first 1024
    cartpole H=100 scenarios in float32 under FAST_CONFIG: wall time,
    iterations, busy share; the kernels launched once per lockstep Newton
    iteration (affine scan) and once per lockstep trial (the trial)."""
    import torch

    from ipoc_tpu_torch import FAST_CONFIG, solve_batch

    ocp = model_ocp("cartpole")
    u, x0 = (a[:PAR_BATCH].to(dev) for a in pool32)

    def solve(cfg=FAST_CONFIG):
        return solve_batch(ocp, u, x0, cfg)

    # Phases K and L ran this path's code and kernels already: no warm-up.
    t0 = time.perf_counter()
    sol, launches, trials, scans, reads = counted_solve(solve)
    wall = time.perf_counter() - t0
    # The busy share over the first 11 lockstep Newton iterations of the
    # first barrier stage (the cold start, two thirds of the wall).
    window = FAST_CONFIG.replace(bp_min=FAST_CONFIG.bp_init * 0.99,
                                 max_newton_iters=10)
    busy, wall_window, per_kernel, n_window = window_trials(
        lambda: solve(window).iterations.cpu())
    it = sol.iterations.cpu().double()
    costs = raw_costs(ocp, sol.controls.double(), x0.double()).cpu()
    rec = {"phase": "M", "model": "cartpole", "horizon": T,
           "dtype": "float32", "config": "FAST_CONFIG", "method": "par",
           "scenarios": PAR_BATCH, "wall_s": wall,
           "solves_per_s": PAR_BATCH / wall,
           "mean_iterations": float(it.mean()),
           "max_iterations": int(it.max()),
           "lockstep_newton_iterations": scans, "lockstep_trials": trials,
           "host_reads": reads, "launches": launches,
           "device_busy_share_window": busy,
           "busy_window": "the first 11 lockstep Newton iterations of the "
                          "first barrier stage",
           "window_wall_s": wall_window,
           "window_device_ms_top_kernels": top_kernels(per_kernel),
           "window_trial": trial_share(per_kernel, wall_window, n_window,
                                       trials, wall),
           "max_abs_u": float(sol.controls.abs().max()),
           "frac_nonfinite_cost": float((~torch.isfinite(costs)).double()
                                        .mean())}
    emit(rec)
    check(bool(torch.isfinite(sol.controls).all()), "non-finite controls")
    check(rec["max_abs_u"] <= 50.0 + 1e-4, "|u| exceeds the bound 50")
    check(rec["frac_nonfinite_cost"] == 0.0, "non-finite raw costs")
    check(launches == {"affine_scan": scans, "par_newton_trial": trials},
          f"launches {launches}: {scans} lockstep iterations, {trials} "
          "lockstep trials")
    return launches


# ---------------------------------------------------------------------------
# bench.py's batch mode and the long horizon: phases N, O
# ---------------------------------------------------------------------------

# bench.py's batch mode (IPOC_BENCH_MODE=batch): BATCH_CONFIG, and its
# IPOC_BENCH_BARRIER=flat, IPOC_BENCH_IMPL=ddp and IPOC_BENCH_DDP_PREDICTOR=0
# variants.
BATCH_MODES = {
    "staged": ("BATCH_CONFIG", {}),
    "flat": ("BATCH_CONFIG.replace(barrier_mode='flat')",
             {"barrier_mode": "flat"}),
    "ddp": ("BATCH_CONFIG.replace(newton_impl='ddp')",
            {"newton_impl": "ddp"}),
    "ddp_flat_no_predictor": (
        "BATCH_CONFIG.replace(newton_impl='ddp', barrier_mode='flat', "
        "stage_predictor=False)",
        {"newton_impl": "ddp", "barrier_mode": "flat",
         "stage_predictor": False}),
}


def batch_cfg(mode):
    from ipoc_tpu_torch import BATCH_CONFIG

    return BATCH_CONFIG.replace(**BATCH_MODES[mode][1])


class rolling:
    """Inside the ``with`` block, keep for each call of
    ``ip_newton.flat_lane_iter`` whether some lane rolled over to a new
    barrier stage (its bp changed and it is not done), as a device flag
    (no host read); :meth:`count` sums them afterwards."""

    def __enter__(self):
        from ipoc_tpu_torch.solvers import ip_newton

        self.module, self.real, self.flags = (ip_newton,
                                              ip_newton.flat_lane_iter, [])

        def wrapped(ocp, lane, cfg, adv=None):
            new = self.real(ocp, lane, cfg, adv)
            self.flags.append(((new.bp != lane.bp) & ~new.done).any())
            return new

        ip_newton.flat_lane_iter = wrapped
        return self

    def __exit__(self, *exc):
        self.module.flat_lane_iter = self.real

    def count(self):
        import torch

        return int(torch.stack(self.flags).sum()) if self.flags else 0


def expected_batch_launches(cfg, lockstep, rolls):
    """The exact launches of one ``solve_batch`` with the fused evaluators:
    the trial's kernels once per lockstep iteration; with the flat
    schedule the rollout kernel once to open the lanes and, without the
    predictor, once per iteration in which some lane rolls over, and the
    transition kernel once per such iteration with it."""
    from ipoc_tpu_torch.ops import cuda

    want = dict.fromkeys(cuda.launches, 0)
    if cfg.newton_impl == "ddp":
        want["merged_trial"] = lockstep
    else:
        want["fused_bwd"] = want["fused_fwd"] = lockstep
    if cfg.barrier_mode == "flat":
        want["rollout"] = 1 + (0 if cfg.stage_predictor else rolls)
        want["transition"] = rolls if cfg.stage_predictor else 0
    return want


def phase_batch_modes(pool32, dev):
    """Phase N: bench.py's batch mode, ``solve_batch(ocp, u, x0, cfg)`` on
    the pool's first 4096 cartpole H=100 scenarios, float32, in its four
    configurations (``BATCH_MODES``): wall, iterations, lockstep
    iterations, host reads, the busy share over the first 11 lockstep
    iterations of the first barrier stage, and every kernel's launches,
    held to their exact counts; then the flat configuration against the
    packed stream (``solve_stream``, the mega executor) on the same
    scenarios.  Returns the rollout kernel's launches."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_batch, solve_stream
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import ip_newton

    ocp = model_ocp("cartpole")
    u, x0 = (a[:LANES].to(dev) for a in pool32)
    out = {"phase": "N", "model": "cartpole", "horizon": T,
           "dtype": "float32", "scenarios": LANES,
           "busy_window": "the first 11 lockstep iterations of the first "
                          "barrier stage"}
    problems, sols, rollouts, merged = [], {}, 0, 0
    for mode, (name, _) in BATCH_MODES.items():
        cfg = batch_cfg(mode)
        window = cfg.replace(bp_min=cfg.bp_init * 0.99, max_newton_iters=10)
        solve_batch(ocp, u[:64], x0[:64], window).iterations.cpu()  # warm-up
        with counting(ip_newton, "_trial_eval") as trials, \
                rolling() as rolls, \
                counting(torch.Tensor, "__bool__") as reads, \
                counting(torch.Tensor, "nonzero") as nonzero:
            cuda.reset_launches()
            t0 = time.perf_counter()
            sol = solve_batch(ocp, u, x0, cfg)
            it = sol.iterations.cpu().double()
            wall = time.perf_counter() - t0
            launches = dict(cuda.launches)
        sols[mode] = sol
        lockstep, n_roll = len(trials.calls), rolls.count()
        busy, wall_window, per_kernel = window_busy(
            lambda: solve_batch(ocp, u, x0, window).iterations.cpu())
        top = top_kernels(per_kernel)
        costs = raw_costs(ocp, sol.controls, x0).double().cpu()
        umax = float(sol.controls.abs().max())
        nonfinite = float((~torch.isfinite(costs)).double().mean())
        out[mode] = {
            "config": name, "wall_s": wall, "solves_per_s": LANES / wall,
            "mean_iterations": float(it.mean()),
            "max_iterations": int(it.max()),
            "lockstep_iterations": lockstep,
            "iterations_with_a_rollover": n_roll,
            "host_reads": len(reads.calls) + len(nonzero.calls),
            "launches": {k: v for k, v in launches.items() if v},
            "device_busy_share_window": busy, "window_wall_s": wall_window,
            "window_device_ms_top_kernels": top, "max_abs_u": umax,
            "frac_nonfinite_cost": nonfinite,
            "mean_raw_cost": float(costs.mean())}
        want = expected_batch_launches(cfg, lockstep, n_roll)
        if launches != want:
            problems.append(f"{mode}: launches {out[mode]['launches']}, "
                            f"expected { {k: v for k, v in want.items() if v} }")
        if not (bool(torch.isfinite(sol.controls).all())
                and umax <= 50.0 + 1e-4 and nonfinite == 0.0):
            problems.append(f"{mode}: |u| {umax}, non-finite cost share "
                            f"{nonfinite}")
        if cfg.barrier_mode == "flat":
            rollouts += launches["rollout"]
        merged += launches["merged_trial"]

    # The flat batch and the packed stream run the same per-lane semantics
    # but for the summation order of ||cu||: in float64 equal iterations
    # and controls within 1e-6 (the first 128 scenarios); in float32 the
    # order flips accept and convergence decisions near the cost's
    # rounding (pred_floor's 1e-7 of the cost is that rounding's size), so
    # iteration counts are reported and the converged raw costs held to
    # 1e-3.
    stream = solve_stream(ocp, u, x0, BATCH_CONFIG, lanes=LANES,
                          refill_every=REFILL)
    c_stream = raw_costs(ocp, stream.controls, x0).double().cpu()
    c_flat = raw_costs(ocp, sols["flat"].controls, x0).double().cpu()
    same = stream.iterations.cpu() == sols["flat"].iterations.cpu()
    near = (c_flat - c_stream).abs() <= 1e-3 * c_stream.abs()
    u64, x64 = u[:128].double(), x0[:128].double()
    flat64 = solve_batch(ocp, u64, x64, batch_cfg("flat"))
    stream64 = solve_stream(ocp, u64, x64, BATCH_CONFIG, lanes=128,
                            refill_every=REFILL)
    same64 = (flat64.iterations == stream64.iterations).cpu()
    du64 = (flat64.controls - stream64.controls).abs().flatten(1).amax(1)
    agree64 = same64 & (du64.cpu() <= 1e-6)
    cross = {
        "float32_frac_equal_iterations": float(same.double().mean()),
        "float32_mean_iterations_batch_stream": [
            float(sols["flat"].iterations.double().mean()),
            float(stream.iterations.double().mean())],
        "float32_frac_raw_cost_within_1e-3": float(near.double().mean()),
        "float32_stream_steps": stream.steps,
        "float64_first128_frac_equal_iterations": float(
            same64.double().mean()),
        "float64_first128_frac_agreeing": float(agree64.double().mean())}
    out["flat_vs_packed_stream"] = cross
    if (cross["float32_frac_raw_cost_within_1e-3"] < 0.99
            or cross["float64_first128_frac_agreeing"] < 0.99):
        problems.append(f"flat batch against the packed stream: {cross}")
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))
    return {"rollout": rollouts, "merged_trial": merged}


def phase_long_horizon(dev):
    """Phase O: cartpole at H=1000 (dt=1e-3), the horizons at which the JAX
    package runs the streamed mega kernel.  (1) The mega kernel against its
    plain version with the streamed kernel's test matrix on 256 lanes,
    float64 then float32; (2) one k=2 launch on 4096 lanes beside its plain
    version and its bound, and one k=32 launch (DDP: at T=250, the coarse
    level); (3) ``solve_stream(BATCH_CONFIG)`` on a pool of 1 x 4096;
    (4) ``solve_stream_multigrid`` with a DDP coarse level at T=250 on the
    same pool; (5) float64, the first 256 scenarios: the mega executor
    against the two-launch arm, Newton and DDP.  Returns ``(record of the
    kernel at T=1000, launches)``."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.models import cartpole
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps
    from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap

    ocp = model_ocp("cartpole", 1, LONG_T)
    pool32 = make_pool(cartpole, LANES, torch.float32, horizon=LONG_T)
    pool64 = tuple(a.double() for a in pool32)
    out = {"phase": "O", "model": "cartpole", "horizon": LONG_T,
           "replaces": "mega_kernel.py:1240 _mega_streamed_kernel"}
    problems = []

    # 1. Newton and DDP, max_newton_iters=2 with the predictor, two k-blocks
    #    of 2 with the lane carried across the launches.
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, F32_TOL)):
        tag = str(dtype).split(".")[-1]
        u, x0 = (a[:256].to(dev, dtype) for a in pool32)
        for level, ddp in (("newton", False), ("ddp", True)):
            cfg = BATCH_CONFIG.replace(max_newton_iters=2,
                                       newton_impl="ddp" if ddp else "fused")
            lane0 = open_packed(ocp, u, x0, cfg, cfg.bp_init)
            active = torch.ones_like(lane0.done)
            got, ref, steps = mega.clone_lane(lane0), lane0, []
            for _ in range(2):
                got, st = mega.mega_k_iterations(ocp, got, active, cfg, 2,
                                                 ddp)
                ref, rs = mega.mega_k_iterations_plain(ocp, ref, active,
                                                       cfg, 2, ddp)
                steps.append((int(st), int(rs)))
            cmp = compare_lanes(got, ref, tol)
            rolled = float((got.bp < lane0.bp).double().mean())
            label = f"{level} {tag}"
            out[f"matrix_{level}_{tag}"] = {
                "steps_kernel_plain": steps, "rolled_over_frac": rolled,
                "ended_bad": {"kernel": int(ended_bad(got, cfg).sum()),
                              "plain": int(ended_bad(ref, cfg).sum())},
                **cmp}
            held = (cmp["agree_frac"] if dtype == torch.float64
                    else cmp["decisions_equal_frac"])
            if held < (1.0 if dtype == torch.float64 else 0.99):
                problems.append(f"{label}: {cmp}")
            if steps != [(2, 2), (2, 2)] or rolled == 0:
                problems.append(f"{label}: steps {steps}, rolled {rolled}")

    # 2. Times, float32, 4096 lanes opened at bp_init: k=2 beside its plain
    #    version, and k=32; DDP k=32 at T=250, the multigrid's coarse level.
    timing = {}
    ops_cp = program_ops(ocp, 4, 1)
    for level, lv_ocp, ddp in (
            ("newton", ocp, False),
            ("ddp", model_ocp("cartpole", COARSEN, LONG_T), True)):
        u, x0 = (a.to(dev) for a in pool32)
        if ddp:
            u = u[:, ::COARSEN].contiguous()
        cfg = BATCH_CONFIG.replace(newton_impl="ddp" if ddp else "fused")
        lane0 = open_packed(lv_ocp, u, x0, cfg, cfg.bp_init)
        active = torch.ones_like(lane0.done)
        ws = mega.mega_workspace(lane0)
        rec = {"horizon": u.shape[1]}
        ks = (2, REFILL) if not ddp else (REFILL,)
        with SmClock() as clock:
            for k in ks:
                rec[f"k{k}_ms"] = event_ms(
                    lambda ln: mega.mega_k_iterations(lv_ocp, ln, active,
                                                      cfg, k, ddp, ws),
                    3, lambda: mega.clone_lane(lane0))
        for k in ks:
            ran, steps = mega.mega_k_iterations(lv_ocp,
                                                mega.clone_lane(lane0),
                                                active, cfg, k, ddp, ws)
            lane_iters = int((ran.it - lane0.it).sum())
            rec[f"k{k}_lane_iterations"] = lane_iters
            rec[f"k{k}_steps"] = int(steps)
            rec[f"k{k}"] = per_stage_iteration(rec[f"k{k}_ms"], int(steps),
                                               u.shape[1], clock.mhz)
            if not ddp:
                rec[f"k{k}_bound"] = bound(
                    2 * nbytes(tuple(lane0)),
                    lane_iters * (LONG_T * (ops_cp["stage_bwd"]
                                            + riccati_ops(4, 1)
                                            + ops_cp["stage_fwd"])
                                  + ops_cp["term"] + ops_cp["term_fwd"]))
        if not ddp:
            rec["k2_plain_ms"] = event_ms(
                lambda ln: mega.mega_k_iterations_plain(ocp, ln, active, cfg,
                                                        2),
                1, lambda: lane0, warm=False)
        timing[level] = rec
    out["timing"] = timing
    out["timing_shape"] = ("4096 lanes opened at bp_init, float32, CUDA "
                           "events; newton T=1000, ddp T=250; per "
                           "stage-iteration at the median SM clock "
                           "nvidia-smi reported during the timing")

    # 3. The single-grid stream on the mega executor.
    with counting(ps, "packed_lane_init", opened_lanes) as opened, \
            counting(mega, "mega_k_iterations") as rounds:
        rec3, single = phase_stream_at_width(
            "O3", BATCH_CONFIG, "BATCH_CONFIG (mega executor)", pool32,
            pool64, dev, counters={"lane_openings": opened.calls,
                                   "refill_rounds": rounds.calls},
            whole_run_busy=True, ocp=ocp)
    check_mega_path(rec3["launches"], rec3["refill_rounds"],
                    rec3["lane_openings"])

    # 4. The multigrid, a DDP coarse level at T=250.
    rec4, _, _, _ = multigrid_at_width("O4", pool32, dev, single,
                                       horizon=LONG_T)
    emit(rec4)
    check_multigrid(rec4, hold_switch=False)

    # 5. Float64, the first 256 scenarios: the mega executor against the
    #    two-launch arm, two independent executors of the same lanes.  A
    #    lane that runs to the iteration cap (every stage to its cap: it
    #    never converges) ends wherever its last iterate is, which rounding
    #    moves: those lanes are counted, and the lanes that converge in both
    #    are held to equal iterations and controls within 1e-6 on 99%.
    u, x0 = (a[:256].to(dev) for a in pool64)
    cap = flat_total_cap(BATCH_CONFIG)
    for impl in ("fused", "ddp"):
        cfg = BATCH_CONFIG.replace(newton_impl=impl)
        a, b = (ps.solve_stream_packed(ocp, u, x0, cfg, lanes=256,
                                       refill_every=REFILL, mega=m)
                for m in (True, False))
        it_a, it_b = a.iterations.cpu(), b.iterations.cpu()
        conv = (it_a < cap) & (it_b < cap)
        du = (a.controls - b.controls).abs().flatten(1).amax(1).cpu()
        agree = (it_a == it_b) & (du <= 1e-6)
        odd = (~agree).nonzero().squeeze(1)
        c_a = raw_costs(ocp, a.controls[odd], x0[odd]).cpu()
        c_b = raw_costs(ocp, b.controls[odd], x0[odd]).cpu()
        rec = {"frac_equal_iterations": float((it_a == it_b).double().mean()),
               "lanes_at_cap_mega_two_launch": [int((it_a >= cap).sum()),
                                                int((it_b >= cap).sum())],
               "frac_agreeing_of_converged": float(
                   agree[conv].double().mean()),
               "lanes_not_agreeing": [
                   {"scenario": int(i), "iterations": [int(it_a[i]),
                                                       int(it_b[i])],
                    "max_abs_du": float(du[i]),
                    "raw_costs": [float(ca), float(cb)]}
                   for i, ca, cb in zip(odd, c_a, c_b)],
               "steps": [a.steps, b.steps],
               "mean_iterations": float(it_a.double().mean()),
               "scenarios_at_cap_mega": (it_a >= cap).nonzero()
               .squeeze(1).tolist(),
               "iterations_mega": it_a.tolist()}
        out[f"mega_vs_two_launch_{impl}_float64"] = rec
        if rec["frac_agreeing_of_converged"] < 0.99:
            problems.append(f"mega vs two-launch {impl}: {rec}")
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))
    f32 = [out[f"matrix_{lv}_float32"] for lv in ("newton", "ddp")]
    newton = timing["newton"]
    record = {"max_abs_err": max(r["max_abs_err"] for r in f32),
              "ms": newton["k2_ms"], "plain_ms": newton["k2_plain_ms"],
              **newton["k2_bound"]}
    launches = rec3["launches"]["mega"] + rec4["launches"]["mega"]
    return record, launches


# bench.py's nmpc protocol (phase P): 25 closed-loop steps of 4096
# controllers, the first resolve cold (BATCH_CONFIG), the others warm at
# NMPC_WARM_BP, capped at NMPC_WARM_CAP a stage; k-blocks of NMPC_K.  The
# r4 protocol resolves every step cold, capped at NMPC_CAP, k-blocks of 32.
NMPC_STEPS = 25
NMPC_K = 8
NMPC_WARM_BP = 0.02
NMPC_WARM_CAP = 12
NMPC_CAP = 25
# Phase P's float64 card-against-CPU run: controllers, steps.
NMPC_CARD_VS_CPU = (64, 5)
# examples/linear_mpc.py's LQT loop, checked and timed (the example times
# 5000 steps; a par step is host-bound at some 5 ms on the card).
LQT_STEPS = 300
# Phase Q's IP-DDP batch, held to the CPU lane by lane: cut from 256
# scenarios, since the plain solve is host-bound at some 0.3-0.5 s per
# lockstep iteration on the card whatever the lanes (and from 16 to 4 when
# phase U came: fewer lanes take fewer lockstep iterations).
DDP_SCENARIOS = 4


def double_integrator_lqt(T_, dt, dtype, device):
    """``examples/linear_mpc.py`` ``build_lqt`` as the port's one-lane LQT:
    the double integrator x'' = u under one RK4 step of ``dt`` (exact for
    it: A = I + dt Ac, B = dt Bc + dt^2/2 Ac Bc), Q = diag(100, 1), R =
    0.1, no drift, no cross term, tracking the origin."""
    import torch

    from ipoc_tpu_torch.parallel.lqt import LQT

    kw = dict(dtype=dtype, device=device)
    A = torch.tensor([[1.0, dt], [0.0, 1.0]], **kw)
    B = torch.tensor([[0.5 * dt * dt], [dt]], **kw)
    Q = torch.diag(torch.tensor([1e2, 1e0], **kw))
    R = 1e-1 * torch.eye(1, **kw)

    def tile(M):
        return M.expand((1, T_) + M.shape).contiguous()

    z = lambda *s: torch.zeros(s, **kw)  # noqa: E731
    return LQT(A=tile(A), B=tile(B), c=z(1, T_, 2), XT=Q[None],
               HT=torch.eye(2, **kw)[None], rT=z(1, 2), X=tile(Q),
               H=tile(torch.eye(2, **kw)), r=z(1, T_, 2), U=tile(R),
               Z=tile(torch.eye(1, **kw)), s=z(1, T_, 1), M=z(1, T_, 2, 1))


def nmpc_warm_loop(ocp, x0s, steps, iters=None):
    """bench.py's nmpc loop (``nmpc_loop_batched_warm`` on
    ``solve_batch_packed``) from zero plans; each resolve's iterations
    (device tensors) appended to ``iters["cold"]`` / ``iters["warm"]``."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.mpc import nmpc_loop_batched_warm
    from ipoc_tpu_torch.solvers.packed_stream import solve_batch_packed

    iters = {"cold": [], "warm": []} if iters is None else iters
    wcfg = BATCH_CONFIG.replace(max_newton_iters=NMPC_WARM_CAP)

    def cold(u, x):
        u, it = solve_batch_packed(ocp, u, x, BATCH_CONFIG, k_block=NMPC_K)
        iters["cold"].append(it)
        return u

    def warm(u, x):
        u, it = solve_batch_packed(ocp, u, x, wcfg, k_block=NMPC_K,
                                   bp_entry=NMPC_WARM_BP)
        iters["warm"].append(it)
        return u

    u0 = torch.zeros((x0s.shape[0], T, 1), dtype=x0s.dtype,
                     device=x0s.device)
    return nmpc_loop_batched_warm(cold, warm, ocp.dynamics, x0s, u0, steps)


def nmpc_cpu():
    """The CPU half of phase P: the nmpc loop in float64 on the pool's
    first controllers, ``(states, controls, iterations (steps, B))``."""
    import torch

    from ipoc_tpu_torch.models import cartpole

    n, steps = NMPC_CARD_VS_CPU
    x0s = make_pool(cartpole, n, torch.float32)[1].double()
    iters = {"cold": [], "warm": []}
    xs, us = nmpc_warm_loop(model_ocp("cartpole"), x0s, steps, iters)
    return xs, us, torch.stack(iters["cold"] + iters["warm"])


def iteration_stats(its):
    """Mean and max of a list of per-lane iteration tensors."""
    import torch

    a = torch.stack(its).double().cpu()
    return {"resolves": len(its), "mean": float(a.mean()),
            "max": int(a.max())}


def phase_nmpc(pool32, dev):
    """Phase P: bench.py's nmpc mode (``bench.py:193-311``) at full width,
    then its r4 protocol, then ``lqt_mpc_loop``.  Returns the launches of
    the measured warm-protocol run and of the par LQT loop."""
    import statistics

    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.mpc import lqt_mpc_loop, nmpc_loop_batched
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps

    ocp = model_ocp("cartpole")
    x0s = pool32[1][:LANES].to(dev)
    n = x0s.shape[0]
    out = {"phase": "P", "model": "cartpole", "horizon": T,
           "dtype": "float32", "controllers": n, "steps": NMPC_STEPS,
           "protocol": f"nmpc_loop_batched_warm: the first resolve "
                       f"BATCH_CONFIG (k_block {NMPC_K}), the others "
                       f"max_newton_iters={NMPC_WARM_CAP}, bp_entry="
                       f"{NMPC_WARM_BP}, k_block {NMPC_K}; zero initial "
                       "plans, the pool's first states",
           "replan_budget_ms": DT * 1e3}
    nmpc_warm_loop(ocp, x0s[:256], 2)[1].cpu()  # warm-up
    iters = {"cold": [], "warm": []}
    with counting(mega, "mega_k_iterations") as blocks, \
            counting(ps, "select_lanes",
                     lambda ok, new, old: (~ok).sum()) as fallback, \
            counting(torch.Tensor, "__bool__") as reads:
        cuda.reset_launches()
        t0 = time.perf_counter()
        xs, us = nmpc_warm_loop(ocp, x0s, NMPC_STEPS, iters)
        us.cpu()
        counted_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        nmpc_warm_loop(ocp, x0s, NMPC_STEPS)[1].cpu()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    busy, top = run_busy_share(
        lambda: nmpc_warm_loop(ocp, x0s, NMPC_STEPS)[1].cpu(), wall)
    umax = float(us.abs().max())
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(us).all())
    want = dict.fromkeys(cuda.launches, 0)
    want.update(mega=len(blocks.calls), rollout_cost=1 + 2 * (NMPC_STEPS - 1))
    out.update({
        "wall_s_median_of_3": wall, "wall_s": times,
        "counted_run_wall_s": counted_s,
        "resolves_per_s": n * NMPC_STEPS / wall,
        "ms_per_step": wall / NMPC_STEPS * 1e3,
        "within_replan_budget": wall / NMPC_STEPS * 1e3 <= DT * 1e3,
        "max_abs_u": umax, "finite": finite,
        "iterations_cold": iteration_stats(iters["cold"]),
        "iterations_warm": iteration_stats(iters["warm"]),
        "fallback_lanes_per_warm_step": [int(f) for f in fallback.calls],
        "k_blocks": len(blocks.calls), "host_reads": len(reads.calls),
        "launches": {k: v for k, v in launches.items() if v},
        "device_busy_share_whole_run": busy,
        "whole_run_device_ms_top_kernels": top})
    problems = []
    if launches != want:
        problems.append(f"launches {out['launches']}, expected "
                        f"{ {k: v for k, v in want.items() if v} }")
    if not finite or umax > 50.0 + 1e-4:
        problems.append(f"max |u| {umax}, finite {finite}")

    # The r4 protocol: every step a cold resolve capped at NMPC_CAP.
    ncfg = BATCH_CONFIG.replace(max_newton_iters=NMPC_CAP)
    r4_iters = []

    def resolve(u, x):
        u, it = ps.solve_batch_packed(ocp, u, x, ncfg)
        r4_iters.append(it)
        return u

    with counting(mega, "mega_k_iterations") as r4_blocks:
        t0 = time.perf_counter()
        xs4, us4 = nmpc_loop_batched(
            resolve, ocp.dynamics, x0s,
            torch.zeros((n, T, 1), dtype=x0s.dtype, device=dev), NMPC_STEPS)
        us4.cpu()
        wall4 = time.perf_counter() - t0
    out["r4_protocol"] = {
        "config": f"BATCH_CONFIG.replace(max_newton_iters={NMPC_CAP}), "
                  "k_block 32, every resolve cold",
        "wall_s": wall4, "resolves_per_s": n * NMPC_STEPS / wall4,
        "ms_per_step": wall4 / NMPC_STEPS * 1e3,
        "iterations": iteration_stats(r4_iters),
        "k_blocks": len(r4_blocks.calls),
        "max_abs_u": float(us4.abs().max())}
    if not bool(torch.isfinite(us4).all()) or float(us4.abs().max()) > 50.0:
        problems.append("r4 protocol: non-finite or out-of-bound controls")

    # examples/linear_mpc.py's loop, par against seq, each timed.
    lqt = double_integrator_lqt(5, 1e-3, torch.float64, dev)
    x0 = torch.tensor([[2.0, 1.0]], dtype=torch.float64, device=dev)
    loops, ms = {}, {}
    for mode in ("par", "seq"):
        cuda.reset_launches()
        t0 = time.perf_counter()
        loops[mode] = lqt_mpc_loop(lqt, x0, LQT_STEPS, mode)
        loops[mode][0].cpu()
        ms[mode] = (time.perf_counter() - t0) / LQT_STEPS * 1e3
        if mode == "par":
            lqt_launches = {k: v for k, v in cuda.launches.items() if v}
    (xp, up), (xq, uq) = loops["par"], loops["seq"]
    err = max(float((xp - xq).abs().max()), float((up - uq).abs().max()))
    out["lqt_mpc"] = {
        "problem": "examples/linear_mpc.py build_lqt: T=5, dt 1e-3, "
                   "float64", "steps": LQT_STEPS,
        "par_vs_seq_max_abs_err": err, "launches_par": lqt_launches,
        "par_ms_per_step": ms["par"], "seq_ms_per_step": ms["seq"],
        "final_state_norm": float(torch.linalg.vector_norm(xp[-1]))}
    if err > 1e-10:
        problems.append(f"lqt_mpc_loop par against seq: {err}")
    if lqt_launches != {"value_scan": LQT_STEPS, "affine_scan": LQT_STEPS}:
        problems.append(f"lqt_mpc_loop launches {lqt_launches}")
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))
    return {"mega": launches["mega"],
            "rollout_cost": launches["rollout_cost"], **lqt_launches}


def phase_nmpc_card_vs_cpu(dev, cpu_ref):
    """Phase P's float64 half: the nmpc loop on the first controllers, the
    card against the CPU."""
    import torch

    from ipoc_tpu_torch.models import cartpole

    n, steps = NMPC_CARD_VS_CPU
    x0s = make_pool(cartpole, n, torch.float32)[1].double().to(dev)
    iters = {"cold": [], "warm": []}
    xs, us = nmpc_warm_loop(model_ocp("cartpole"), x0s, steps, iters)
    it = torch.stack(iters["cold"] + iters["warm"]).cpu()
    xs_c, us_c, it_c = cpu_ref
    du = (us.cpu() - us_c).abs().amax(dim=(0, 2))
    dx = (xs.cpu() - xs_c).abs().amax(dim=(0, 2))
    same = (it == it_c).all(0)
    agree = same & (du <= 1e-6)
    emit({"phase": "P64", "dtype": "float64", "controllers": n,
          "steps": steps, "controllers_with_different_iterations": int(
              (~same).sum()),
          "max_abs_du": float(du.max()), "max_abs_dx": float(dx.max()),
          "controllers_agreeing": int(agree.sum())})
    # A controller agrees when every resolve took the same iterations and
    # every applied control is within 1e-6; one in 32 may part within
    # rounding (phase E's float64 check parts 2 of 256 lanes along a flat
    # valley), and then its applied controls must stay within 1e-4.
    check(int((~agree).sum()) <= n // 32,
          f"{int((~agree).sum())} of {n} controllers differ")
    check(float(du.max()) <= 1e-4, f"applied controls differ by {du.max()}")


def ddp_golden_cpu():
    """The CPU half of phase Q's goldens: ``{model: (controls,
    iterations)}`` of ``interior_point_ddp`` under PARITY_CFG."""
    from ipoc_tpu_torch import DEFAULT_CONFIG, interior_point_ddp

    out = {}
    for name in ("pendulum", "cartpole"):
        _, ocp, u0, x0 = golden_setup(name)
        u, it = interior_point_ddp(ocp, u0, x0,
                                   DEFAULT_CONFIG.replace(stall_exit=False))
        out[name] = (u, int(it))
    return out


class stage_iterations:
    """Inside the ``with`` block, keep each barrier stage's per-lane
    iterations that ``ip_ddp._ddp_stage`` returns (device tensors)."""

    def __enter__(self):
        from ipoc_tpu_torch.solvers import ip_ddp

        self.module, self.real, self.stages = ip_ddp, ip_ddp._ddp_stage, []

        def wrapped(*a, **k):
            x, u, it = self.real(*a, **k)
            self.stages.append(it)
            return x, u, it

        ip_ddp._ddp_stage = wrapped
        return self

    def __exit__(self, *exc):
        self.module._ddp_stage = self.real


def phase_ddp(pool64, dev, cpu_ref):
    """Phase Q: ``interior_point_ddp`` in float64, the reference's
    precision, plain tensor code (no kernel, as in JAX): the pendulum
    golden on the card against tests/golden/pendulum_h100.npz and the CPU,
    the cartpole golden held on the CPU child alone (the card's host-bound
    solve would take 30 s), ``solve_batch(method="ddp")`` on DDP_SCENARIOS
    pool scenarios under FAST_CONFIG (against the CPU, lane by lane).
    ``cpu_ref(key)`` gives the CPU child's Qgolden and Qddp, read after
    the card's solves (the child runs beside them)."""
    import numpy as np
    import torch

    from ipoc_tpu_torch import (
        DEFAULT_CONFIG,
        FAST_CONFIG,
        interior_point_ddp,
        solve_batch,
    )
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import ip_ddp
    from ipoc_tpu_torch.utils.integrators import rollout

    out = {"phase": "Q", "golden_config": PARITY}
    problems = []

    def against_golden(name, u):
        """``u``'s barrier cost and controls against the golden file."""
        data, ocp, _, x0 = golden_setup(name)
        bp = torch.tensor(float(data["final_bp"]), dtype=torch.float64)
        cost = float(ocp.total_cost(rollout(ocp.dynamics, u, x0), u, bp))
        rel = abs(cost - float(data["cost_ddp"])) / abs(
            float(data["cost_ddp"]))
        du = float(np.abs(u.numpy() - data["u_ddp"]).max())
        if rel > 1e-8 or du > 5e-2:
            problems.append(f"{name}: cost rel {rel}, |du| {du}")
        return {"iterations_golden": int(data["iters_ddp"]),
                "cost_rel_err_vs_golden": rel, "max_abs_du_vs_golden": du}

    cuda.reset_launches()
    _, ocp, u0, x0 = golden_setup("pendulum")
    with counting(ip_ddp, "compute_derivatives") as outer, \
            counting(ip_ddp, "ddp_bwd_pass") as trials:
        t0 = time.perf_counter()
        u_pend, it_pend = interior_point_ddp(
            ocp, u0.to(dev), x0.to(dev),
            DEFAULT_CONFIG.replace(stall_exit=False))
        u_pend, it_pend = u_pend.cpu(), int(it_pend)
        wall = time.perf_counter() - t0
    out["golden_pendulum"] = {
        "iterations": it_pend, "outer_iterations": len(outer.calls),
        "trials": len(trials.calls), "wall_s": wall,
        **against_golden("pendulum", u_pend)}

    ocp = model_ocp("cartpole")
    u, x0 = (a[:DDP_SCENARIOS].to(dev) for a in pool64)
    with counting(ip_ddp, "compute_derivatives") as outer, \
            stage_iterations() as stages:
        t0 = time.perf_counter()
        sol = solve_batch(ocp, u, x0, FAST_CONFIG, method="ddp")
        it = sol.iterations.cpu()
        wall = time.perf_counter() - t0
    capped = (torch.stack(stages.stages).cpu()
              > FAST_CONFIG.max_ddp_iters).any(0)
    costs = raw_costs(ocp, sol.controls, x0).cpu()
    nonfinite = int((~torch.isfinite(costs)).sum())
    out["batch"] = {
        "config": "FAST_CONFIG", "scenarios": DDP_SCENARIOS, "wall_s": wall,
        "solves_per_s": DDP_SCENARIOS / wall,
        "lockstep_iterations": len(outer.calls),
        "mean_iterations": float(it.double().mean()),
        "max_iterations": int(it.max()),
        "lanes_at_a_stage_cap": int(capped.sum()),
        "nonfinite_raw_costs": nonfinite,
        "max_abs_u": float(sol.controls.abs().max())}
    if nonfinite or not bool(torch.isfinite(sol.controls).all()):
        problems.append(f"batch: {nonfinite} non-finite raw costs")
    launched = {k: v for k, v in cuda.launches.items() if v}
    out["launches"] = launched
    if launched:
        problems.append(f"IP-DDP launched kernels: {launched}")

    # The CPU's goldens (the card's pendulum against it, its cartpole
    # against the file), and its batch of the same scenarios lane by lane.
    u_cpu, it_cpu = cpu_ref("Qgolden")["pendulum"]
    out["golden_pendulum"].update({
        "iterations_cpu": it_cpu,
        "max_abs_du_vs_cpu": float((u_pend - u_cpu).abs().max())})
    if it_pend != it_cpu:
        problems.append(f"pendulum: iterations {it_pend} (CPU {it_cpu})")
    u_cpu, it_cpu = cpu_ref("Qgolden")["cartpole"]
    out["golden_cartpole_cpu"] = {"iterations": it_cpu,
                                  **against_golden("cartpole", u_cpu)}
    u_cpu, it_cpu, _, _, wall_cpu = cpu_ref("Qddp")
    n = it_cpu.shape[0]
    same = it == it_cpu
    du = (sol.controls.cpu() - u_cpu).abs().flatten(1).amax(1)
    c_card = raw_costs(ocp, sol.controls.cpu(), x0.cpu())
    c_cpu = raw_costs(ocp, u_cpu, x0.cpu())
    rel = float(((c_card - c_cpu).abs() / c_cpu.abs()).max())
    agree = same & (du <= 1e-6)
    out["card_vs_cpu"] = {
        "scenarios": n, "lanes_with_different_iterations": int(
            (~same).sum()),
        "lanes_agreeing": int(agree.sum()), "max_abs_du": float(du.max()),
        "max_raw_cost_rel_diff": rel, "wall_s_cpu_child": wall_cpu}
    # As phase N's DDP check: one lane may take another accept path within
    # rounding; every converged raw cost agrees to the goldens' rtol.
    if int((~agree).sum()) > 1 or rel > 1e-8:
        problems.append(f"card against CPU: {out['card_vs_cpu']}")
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))


def phase_warm_transfer(pool32, dev, single_grid=None):
    """Phase R: warm transfer in the packed stream at phase H's width, on
    pendulum H=100 against the cold stream (raw costs within 1e-4 relative
    on every scenario, fewer mean iterations after the first generation),
    then on cartpole, with the basin-switch fraction against the
    single-grid solutions (phase H's, or a cold stream here) reported with
    no limit.  Returns the launches of the pendulum warm run."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps

    cfg = BATCH_CONFIG
    out = {"phase": "R", "config": "BATCH_CONFIG", "dtype": "float32",
           "lanes": LANES, "refill_every": REFILL, "transfer_bp": 0.02}
    problems = []

    def stream(ocp, u, x0, lanes=LANES, **kw):
        return solve_stream(ocp, u, x0, cfg, lanes=lanes,
                            refill_every=REFILL, **kw)

    def measured(ocp, u, x0):
        """The warm-transfer stream with its launches, refill rounds, lane
        openings and transfers counted."""
        with counting(ps, "packed_lane_init", opened_lanes) as opened, \
                counting(mega, "mega_k_iterations") as rounds, \
                counting(ps, "select_lanes",
                         lambda ok, new, old: ok.sum()) as kept:
            cuda.reset_launches()
            t0 = time.perf_counter()
            sol = stream(ocp, u, x0, warm_transfer=True)
            sol.iterations.cpu()
            wall = time.perf_counter() - t0
            counts = dict(cuda.launches)
        transferred = int(sum(int(k) for k in kept.calls))
        refilled = sum(opened.calls[1:]) // 2  # each refill opens twice
        rec = {"wall_s": wall, "solves_per_s": u.shape[0] / wall,
               "steps": sol.steps, "launches": counts,
               "refill_rounds": len(rounds.calls),
               "lane_openings": len(opened.calls),
               "transferred_lanes": transferred,
               "fallback_lanes": refilled - transferred}
        return sol, rec

    for name in ("pendulum", "cartpole"):
        ocp = model_ocp(name)
        pool = (make_pool(pendulum, POOL, torch.float32) if name == "pendulum"
                else pool32)
        u, x0 = (a.to(dev) for a in pool)
        stream(ocp, u[:256], x0[:256], lanes=256,
               warm_transfer=True).iterations.cpu()  # warm-up
        if name == "cartpole" and single_grid is not None:
            cold = single_grid
            cold_from = "phase H"
        else:
            cold = stream(ocp, u, x0)
            cold_from = "this phase"
        warm, rec = measured(ocp, u, x0)
        c_c = raw_costs(ocp, cold.controls, x0).double().cpu()
        c_w = raw_costs(ocp, warm.controls, x0).double().cpu()
        rel = (c_w - c_c).abs() / c_c.abs().clamp(min=1e-12)
        it_c, it_w = (s.iterations.cpu().double() for s in (cold, warm))
        later = slice(LANES, None)
        umax = float(warm.controls.abs().max())
        rec.update({
            "scenarios": u.shape[0], "cold_from": cold_from,
            "mean_iterations_cold": float(it_c.mean()),
            "mean_iterations_warm": float(it_w.mean()),
            "mean_iterations_after_first_generation": {
                "cold": float(it_c[later].mean()),
                "warm": float(it_w[later].mean())},
            "max_raw_cost_rel_diff": float(rel.max()),
            "basin_switch_frac": float((rel > 1e-3).double().mean()),
            "frac_nonfinite_cost": float((~torch.isfinite(c_w)).double()
                                         .mean()),
            "max_abs_u": umax})
        out[name] = rec
        try:
            check_mega_path(rec["launches"], rec["refill_rounds"],
                            rec["lane_openings"])
        except RuntimeError as exc:
            problems.append(f"{name}: {exc}")
        if not bool(torch.isfinite(warm.controls).all()) or umax > 50 + 1e-4:
            problems.append(f"{name}: max |u| {umax}")
        if name == "pendulum":
            if float(rel.max()) > 1e-4:
                problems.append(f"pendulum: raw costs part by {rel.max()}")
            if not it_w[later].mean() < it_c[later].mean():
                problems.append("pendulum: no fewer iterations after the "
                                "first generation")
            counts = rec["launches"]
    out["problems"] = problems
    emit(out)
    check(not problems, "; ".join(problems))
    return {"mega": counts["mega"], "rollout_cost": counts["rollout_cost"]}


# Phase S: the distribution layer on the one card.  Two gloo ranks share
# cuda:0 (NCCL refuses two ranks on one device); one more process runs a
# one-rank NCCL group.
SHARD_RANKS = 2
# The time-sharded solve's horizon: tests/test_time_sharded_solve.py's long
# cartpole (T=1024, FAST_CONFIG single-trial), float64.
SHARD_T = 1024
SHARD_POOL = SHARD_RANKS * POOL  # the multigrid's pool: 2 x 4 x 4096
# Pendulum scenarios a rank of solve_batch_sharded (method "par"): its
# lockstep iterations, not its lanes, set its time.
SHARD_BATCH = 8
SHARD_TIMEOUT_S = 120  # the groups' collectives, and the join


def shard_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase_s")


def shard_inputs():
    """What every rank and the parent make alike from the seed: the
    time-sharded solve's controls and initial state (float64, CPU), the
    multigrid's cartpole pool (float32) and solve_batch_sharded's pendulum
    scenarios (float32)."""
    import torch

    from ipoc_tpu_torch.models import cartpole, pendulum

    gen = torch.Generator().manual_seed(SEED)
    u = 0.1 * torch.randn((SHARD_T, 1), generator=gen, dtype=torch.float64)
    pool = make_pool(cartpole, SHARD_POOL, torch.float32)
    batch = make_pool(pendulum, SHARD_RANKS * SHARD_BATCH, torch.float32)
    return u, cartpole.initial_state(torch.float64), pool, batch


def shard_config():
    """FAST_CONFIG with the single-trial globalization (the time-sharded
    solve's, and solve_batch_sharded's: the retry loop's lockstep trials
    would set the batch's time)."""
    from ipoc_tpu_torch import FAST_CONFIG

    return FAST_CONFIG.replace(globalization="single")


def shard_save(name, fn):
    """Run ``fn()`` and save its result (or its traceback) as
    build/phase_s/``name``.pt for the parent."""
    import torch

    try:
        out = fn()
    except Exception:  # the parent fails phase S with it
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(shard_dir(), f"{name}.pt"))


def shard_rank(rank, init_file, programs):
    """Rank ``rank`` of phase S's two gloo ranks on cuda:0: the
    time-sharded solve, the sharded multigrid and solve_batch_sharded, the
    launch counts from zero before them; the outputs go to the parent."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()

    def progress(what):
        print(f"# phase S rank {rank}: {what} at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    def run():
        import datetime

        import torch

        from ipoc_tpu_torch import BATCH_CONFIG
        from ipoc_tpu_torch.ops import cuda, fused_iter
        from ipoc_tpu_torch.parallel.distributed import initialize
        from ipoc_tpu_torch.parallel.sharding import make_mesh
        from ipoc_tpu_torch.solvers import (
            ip_newton_time_sharded,
            solve_batch_sharded,
            solve_stream_multigrid_sharded,
        )

        initialize(f"file://{init_file}", SHARD_RANKS, rank, backend="gloo",
                   timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        time_mesh = make_mesh(1, SHARD_RANKS)
        batch_mesh = make_mesh(SHARD_RANKS, 1)
        # The parent's traced stage programs (the libraries are built).
        for (name, coarsen, horizon, nx, nu), progs in programs:
            fused_iter.scalar_programs(model_ocp(name, coarsen, horizon), nx,
                                       nu, traced=progs)
        u_long, x_long, pool, batch = shard_inputs()
        # The rank's card (DeviceMesh selected it): the inputs go there, so
        # that the gloo group carries CUDA tensors.
        dev = torch.device("cuda", torch.cuda.current_device())
        cfg = shard_config()
        out = {"device": str(dev)}
        progress("set up")
        cuda.reset_launches()
        t0 = time.perf_counter()
        u, it = ip_newton_time_sharded(horizon_ocp(SHARD_T), u_long.to(dev),
                                       x_long.to(dev), time_mesh, cfg)
        out.update(u_long=u.cpu(), it_long=int(it),
                   time_sharded_s=time.perf_counter() - t0)
        progress("time-sharded solve")
        t0 = time.perf_counter()
        mg = solve_stream_multigrid_sharded(
            model_ocp("cartpole"), model_ocp("cartpole", COARSEN), COARSEN,
            *(a.to(dev) for a in pool), batch_mesh, BATCH_CONFIG,
            lanes=LANES, refill_every=REFILL, coarse_impl="ddp")
        out.update(mg_u=mg.controls.cpu(), mg_it=mg.iterations.cpu(),
                   mg_it_coarse=mg.iterations_coarse.cpu(),
                   mg_steps=mg.steps, mg_steps_coarse=mg.steps_coarse,
                   multigrid_s=time.perf_counter() - t0)
        progress("multigrid")
        t0 = time.perf_counter()
        bt = solve_batch_sharded(model_ocp("pendulum"),
                                 *(a.to(dev) for a in batch), batch_mesh,
                                 cfg)
        out.update(batch_u=bt.controls.cpu(), batch_it=bt.iterations.cpu(),
                   batch_s=time.perf_counter() - t0)
        progress("batch")
        out["launches"] = dict(cuda.launches)
        torch.distributed.destroy_process_group()
        return out

    shard_save(f"rank{rank}", run)


def shard_nccl_rank(init_file):
    """Phase S's one-rank NCCL group: the time-sharded LQT solve at time=1
    on the parallel trial's cartpole H=1000 data, launches counted, then
    against the unsharded parallel passes."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    def run():
        import datetime

        import torch
        import torch.distributed as dist

        from ipoc_tpu_torch import par_bwd_pass, par_fwd_pass
        from ipoc_tpu_torch.ops import cuda
        from ipoc_tpu_torch.parallel.lqt import newton_lqt
        from ipoc_tpu_torch.parallel.sharding import make_mesh
        from ipoc_tpu_torch.parallel.time_sharded import (
            solve_lqt_time_sharded)
        from ipoc_tpu_torch.problem import Derivatives, LinearizedOCP

        dist.init_process_group(
            "nccl", init_method=f"file://{init_file}", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        mesh = make_mesh(1, 1)
        dev = torch.device("cuda", torch.cuda.current_device())
        trial, _ = par_inputs(LONG_T, 1, torch.float64, dev)
        r, Q, R, M, fx, fu, XT = trial
        lqt = newton_lqt(LinearizedOCP(r, Q, R, M),
                         Derivatives(None, None, None, None, None, fx, fu,
                                     None, None, None), XT)
        x0 = torch.full((1, 4), 0.01, dtype=torch.float64, device=dev)
        cuda.reset_launches()
        u, x = solve_lqt_time_sharded(lqt, x0, mesh)
        torch.cuda.synchronize()
        launches = dict(cuda.launches)
        K, d, *_ = par_bwd_pass(lqt)
        u_ref, x_ref = par_fwd_pass(lqt, x0, K, d)
        out = {"backend": dist.get_backend(), "launches": launches,
               "u_rel_err": float((u - u_ref).abs().max()
                                  / u_ref.abs().max()),
               "x_rel_err": float((x - x_ref[:, :-1]).abs().max()
                                  / x_ref.abs().max())}
        dist.destroy_process_group()
        return out

    shard_save("nccl", run)


def phase_sharded(dev, power):
    """Phase S: the distribution layer on the one card (the port's
    counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``).  Two
    gloo ranks on cuda:0 run, each on its half: the time-sharded cartpole
    T=1024 solve (float64, FAST_CONFIG single-trial; held to the unsharded
    ``par_interior_point_optimal_control`` on the card: equal iterations,
    controls within rtol 1e-7, atol 1e-8), the sharded multigrid at the
    bench's width (4096 lanes a rank, refill 32, a DDP coarse level, a pool
    of 2 x 4 x 4096 float32; held scenario by scenario to one process's run
    on the same pool: equal iterations, bit-equal controls) and
    ``solve_batch_sharded`` on 2 x 8 pendulum scenarios (float32,
    FAST_CONFIG single-trial; against one ``solve_batch`` of all 16: equal
    iterations, bit-equal controls).  A one-rank NCCL group
    runs the time-sharded LQT solve.  The references run in this process
    before the two ranks start.  Returns the children's launches,
    summed."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from ipoc_tpu_torch import (
        BATCH_CONFIG,
        par_interior_point_optimal_control,
        solve_batch,
        solve_stream_multigrid,
    )
    from ipoc_tpu_torch.ops import fused_iter

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    mode = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"unknown: {smi.stderr.strip()}")
    rec = {"phase": "S", "nvidia_smi": power, "compute_mode": mode,
           "ranks": SHARD_RANKS, "backend": "gloo", "horizon": SHARD_T,
           "pool": SHARD_POOL, "lanes_a_rank": LANES}
    if mode != "Default":
        emit(rec)
        check(False, f"compute mode {mode}: two processes cannot share the "
                     "card, so phase S cannot run its two ranks")
    d = shard_dir()
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    programs = [(spec, fused_iter.scalar_programs(model_ocp(*spec[:3]),
                                                  *spec[3:]))
                for spec in FUSED_MODELS[:2]]
    ctx = mp.get_context("spawn")
    nccl_proc = ctx.Process(target=shard_nccl_rank,
                            args=(os.path.join(d, "nccl"),))
    procs = [ctx.Process(target=shard_rank,
                         args=(r, os.path.join(d, "gloo"), programs))
             for r in range(SHARD_RANKS)]

    def join(ps):
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        for p in ps:
            p.join(max(0.0, deadline - time.monotonic()))

    try:
        # The references first, in this process (with the NCCL rank): a
        # third process busy on the card slows the two ranks' host-bound
        # loops severalfold, each waiting its turn on the card.
        nccl_proc.start()
        t0 = time.perf_counter()
        u_long, x_long, pool, batch = shard_inputs()
        cfg = shard_config()
        u_ref, it_ref = par_interior_point_optimal_control(
            horizon_ocp(SHARD_T), u_long.to(dev), x_long.to(dev), cfg)
        u_ref, it_ref = u_ref.cpu(), int(it_ref)
        rec["unsharded_s"] = time.perf_counter() - t0
        mg_ref = solve_stream_multigrid(
            model_ocp("cartpole"), model_ocp("cartpole", COARSEN), COARSEN,
            *(a.to(dev) for a in pool), BATCH_CONFIG, lanes=LANES,
            refill_every=REFILL, coarse_impl="ddp")
        # One solve_batch of the whole batch: a lane's arithmetic is its
        # own (the costs' stage sums in a fixed order), so the ranks'
        # halves match it bit for bit.
        bt_ref = solve_batch(model_ocp("pendulum"),
                             *(a.to(dev) for a in batch), cfg)
        rec["references_s"] = time.perf_counter() - t0
        print(f"# phase S references: {rec['references_s']:.1f} s",
              file=sys.stderr, flush=True)
        join([nccl_proc])
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        join(procs)
        rec["ranks_s"] = time.perf_counter() - t0
        procs.append(nccl_proc)
        late = [i for i, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs + [nccl_proc]:
            if p.is_alive():
                p.kill()
                p.join()
    names = [f"rank{r}" for r in range(SHARD_RANKS)] + ["nccl"]
    check(not late, f"phase S: {[names[i] for i in late]} did not finish "
                    f"within {SHARD_TIMEOUT_S} s of the join")
    outs = {}
    for name, p in zip(names, procs):
        path = os.path.join(d, f"{name}.pt")
        check(os.path.exists(path),
              f"phase S: {name} left no result (exit code {p.exitcode})")
        outs[name] = torch.load(path, weights_only=False)
        check("error" not in outs[name],
              f"phase S: {name} failed:\n{outs[name].get('error')}")
    r0, nccl = outs["rank0"], outs["nccl"]
    for r in range(1, SHARD_RANKS):
        other = outs[f"rank{r}"]
        for key in ("u_long", "mg_u", "mg_it", "mg_it_coarse", "batch_u",
                    "batch_it"):
            check(torch.equal(other[key], r0[key]),
                  f"rank {r}'s {key} differs from rank 0's")
    launches = {}
    for out in outs.values():
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    du_long = (r0["u_long"] - u_ref).abs()
    mg_u_ref = mg_ref.controls.cpu()
    mg_equal = (r0["mg_u"] == mg_u_ref).flatten(1).all(1)
    mg_it_equal = ((r0["mg_it"] == mg_ref.iterations.cpu())
                   & (r0["mg_it_coarse"] == mg_ref.iterations_coarse.cpu()))
    bt_equal = (r0["batch_u"] == bt_ref.controls.cpu()).flatten(1).all(1)
    rec.update({
        "wall_s": time.perf_counter() - t_start,
        "time_sharded": {
            "config": "FAST_CONFIG.replace(globalization='single')",
            "dtype": "float64", "iterations": r0["it_long"],
            "iterations_unsharded": it_ref, "s": r0["time_sharded_s"],
            "unsharded_s": rec.pop("unsharded_s"),
            "max_abs_du": float(du_long.max()),
            "within_rtol_1e-7_atol_1e-8": bool(torch.allclose(
                r0["u_long"], u_ref, rtol=1e-7, atol=1e-8))},
        "multigrid": {
            "config": "BATCH_CONFIG", "dtype": "float32", "coarsen": COARSEN,
            "coarse_impl": "ddp", "refill_every": REFILL,
            "s": r0["multigrid_s"], "steps_max_rank": r0["mg_steps"],
            "steps_coarse_max_rank": r0["mg_steps_coarse"],
            "steps_single_process": mg_ref.steps,
            "steps_coarse_single_process": mg_ref.steps_coarse,
            "scenarios_bit_equal": int(mg_equal.sum()),
            "scenarios_equal_iterations": int(mg_it_equal.sum()),
            "max_abs_du": float((r0["mg_u"] - mg_u_ref).abs().max()),
            "finite_controls": bool(torch.isfinite(r0["mg_u"]).all())},
        "batch": {
            "config": "FAST_CONFIG.replace(globalization='single')",
            "dtype": "float32", "model": "pendulum",
            "scenarios": SHARD_RANKS * SHARD_BATCH, "s": r0["batch_s"],
            "scenarios_bit_equal": int(bt_equal.sum()),
            "scenarios_equal_iterations": int(
                (r0["batch_it"] == bt_ref.iterations.cpu()).sum()),
            "max_abs_du": float(
                (r0["batch_u"] - bt_ref.controls.cpu()).abs().max())},
        "nccl": {"backend": nccl["backend"], "horizon": LONG_T,
                 "u_rel_err": nccl["u_rel_err"],
                 "x_rel_err": nccl["x_rel_err"],
                 "launches": nccl["launches"]},
        "launches": launches, "rank_devices": [outs[n]["device"]
                                               for n in names[:-1]]})
    emit(rec)
    ts, mg, bt = rec["time_sharded"], rec["multigrid"], rec["batch"]
    check(ts["iterations"] == it_ref,
          f"time-sharded iterations {ts['iterations']}, unsharded {it_ref}")
    check(ts["within_rtol_1e-7_atol_1e-8"],
          f"time-sharded controls part by {ts['max_abs_du']}")
    check(mg["scenarios_bit_equal"] == SHARD_POOL
          and mg["scenarios_equal_iterations"] == SHARD_POOL,
          f"sharded multigrid: {mg['scenarios_bit_equal']} of {SHARD_POOL} "
          f"scenarios bit-equal, {mg['scenarios_equal_iterations']} with "
          "equal iterations, against one process")
    check(bt["scenarios_bit_equal"] == bt["scenarios"]
          and bt["scenarios_equal_iterations"] == bt["scenarios"],
          f"solve_batch_sharded: {bt['scenarios_bit_equal']} of "
          f"{bt['scenarios']} scenarios bit-equal, "
          f"{bt['scenarios_equal_iterations']} with equal iterations, "
          "against one solve_batch")
    check(nccl["backend"] == "nccl" and nccl["u_rel_err"] <= 1e-12
          and nccl["x_rel_err"] <= 1e-12,
          f"the NCCL rank's LQT solve: {rec['nccl']}")
    for k in ("rollout_cost", "mega", "affine_scan", "value_scan",
              "par_newton_trial"):
        check(launches.get(k, 0) > 0, f"phase S launched no {k}")
    return launches


# ---------------------------------------------------------------------------
# Phase T: the planar quadrotor (nx=6, nu=2)
# ---------------------------------------------------------------------------


def quad_pool():
    """Phase T's pool: bench.py's recipe for the quadrotor (H=40, 4 x 4096
    scenarios, the warm start about hover thrust), float32 on the CPU."""
    import torch

    return make_pool(model_module("quadrotor"), POOL, torch.float32,
                     horizon=QUAD_T)


def quad_single_solve(name, dev):
    """Phase T4's single solves, float64: ``par`` and ``seq`` are
    tests/test_quadrotor.py's (dt 0.05, H=40, the hover start,
    FAST_CONFIG; ``seq`` the sequential validation solve, whose Riccati
    pass is plain tensor code beside the costate kernel), ``newton_seq``
    the par solve's Newton iteration with the sequential trial
    (``newton_impl="seq"``: the seq trial and costate kernels), and
    ``double_integrator`` tests/test_solvers.py's par solve at dt 0.01,
    H=100 from x0 = (2, 1) and zero controls.  Returns ``(controls on the
    CPU, iterations)``."""
    import torch

    from ipoc_tpu_torch import (
        FAST_CONFIG,
        par_interior_point_optimal_control,
        seq_interior_point_optimal_control,
    )

    f64 = torch.float64
    if name == "double_integrator":
        ocp = model_ocp(name, *DI_SOLVE)
        u0 = torch.zeros((DI_SOLVE[1], 1), dtype=f64, device=dev)
        x0 = torch.tensor([2.0, 1.0], dtype=f64, device=dev)
        u, it = par_interior_point_optimal_control(ocp, u0, x0)
    else:
        quad = model_module("quadrotor")
        solve = (seq_interior_point_optimal_control if name == "seq"
                 else par_interior_point_optimal_control)
        cfg = (FAST_CONFIG.replace(newton_impl="seq") if name == "newton_seq"
               else FAST_CONFIG)
        u, it = solve(model_ocp("quadrotor", *QUAD_SOLVE),
                      quad.hover_controls(QUAD_T, f64, dev),
                      quad.initial_state(f64, dev), cfg)
    return u.cpu(), int(it)


QUAD_SOLVES = ("par", "seq", "newton_seq", "double_integrator")


def quad_cpu():
    """Phase T's CPU child: T3's multigrid on the pool's first 128
    scenarios in float64 and T4's single solves, with the plain versions."""
    u, x0 = (a[:CARD_VS_CPU_SCENARIOS["T3"]].double() for a in quad_pool())
    t0 = time.perf_counter()
    t3 = (*card_vs_cpu_solve("T3", u, x0), time.perf_counter() - t0)
    return {"T3": t3, "T4": {name: quad_single_solve(name, "cpu")
                             for name in QUAD_SOLVES}}


def quad_levels(pool, B, dtype, dev):
    """The pool's first B scenarios on each multigrid level: Newton on the
    fine grid (T=40), DDP on the coarse grid (T=10, every 4th control as
    the multigrid takes them), each with its model: level -> (ocp, u, x0,
    ddp)."""
    u, x0 = (a[:B].to(dev, dtype) for a in pool)
    return {level: (model_ocp("quadrotor", coarsen, QUAD_T),
                    u[:, ::coarsen].contiguous(), x0, ddp)
            for level, (coarsen, ddp) in LEVELS.items()}


# Phase T1's mega launch: k iterations, each barrier stage capped at two
# so that lanes roll over.  Against its plain version every lane must take
# the same decisions (it, stage_it, done) on 99% of lanes, and in float64
# also agree element by element within the tolerance (phase G's rules:
# past G's k=4, float32 rounding through the cold start's Newton steps
# outgrows the per-element tolerance).
QUAD_MEGA_K = 8


def quad_kernel_checks(pool, dev):
    """Phase T1's checks: every kernel of the port at the quadrotor's
    (6, 2) against its plain version at B in QUAD_CHECK_B, float64 then
    float32, with phases A, D, G and K's tolerances."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import fused_iter as tf
    from ipoc_tpu_torch.ops import mega

    out = {}
    problems = []
    ocp = model_ocp("quadrotor", 1, QUAD_T)
    for dtype, tol, prt, ltol in ((torch.float64, 1e-10, 1e-10, 1e-12),
                                  (torch.float32, 2e-5, 1e-4, 1e-5)):
        tag = str(dtype).split(".")[-1]
        dtol = 1e-10 if dtype == torch.float64 else F32_TOL
        for B in QUAD_CHECK_B:
            label = f"quadrotor B={B} {tag}"
            trial, costate = slice_stage_data(
                tuple(a[:B] for a in pool), dtype, dev, model="quadrotor",
                horizon=QUAD_T)
            rec = {"seq_trial": compare_trial(trial, tol, prt, label),
                   "costates": compare_costates(costate, ltol, label),
                   "fused": compare_fused(ocp, tuple(a[:2 * B] for a in pool),
                                          dtype, dev, 0.1, dtol, label)}
            for level, (ocp_l, u, x0, ddp) in quad_levels(
                    pool, B, dtype, dev).items():
                lab = f"{label} {level} T={u.shape[1]}"
                lane = open_packed(ocp_l, u, x0, BATCH_CONFIG, 0.1)
                reg = 100.0 * torch.clamp(lane.cun, min=1e-6)
                args = (ocp_l, lane.xs, lane.xT, lane.u, lane.bp, reg)
                got = tf.merged_trial_launch(*args, ddp=ddp)
                ref = tf.fused_newton_iter_plain(*args, ddp=ddp)
                errs = [compare_out(f"{lab} merged[{n}]", g, r, dtol)
                        for n, g, r in zip(TRIAL_OUTS, got, ref)]
                cfg = BATCH_CONFIG.replace(
                    newton_impl="ddp" if ddp else "fused", max_newton_iters=2)
                lane0 = open_packed(ocp_l, u, x0, cfg, 0.1)
                active = torch.ones_like(lane0.done)
                got, steps = mega.mega_k_iterations(
                    ocp_l, mega.clone_lane(lane0), active, cfg, QUAD_MEGA_K,
                    ddp)
                ref, ref_steps = mega.mega_k_iterations_plain(
                    ocp_l, lane0, active, cfg, QUAD_MEGA_K, ddp)
                vs_plain = compare_lanes(got, ref, dtol)
                key = ("agree_frac" if dtype == torch.float64
                       else "decisions_equal_frac")
                if vs_plain[key] < 0.99:
                    problems.append(f"{lab} mega k={QUAD_MEGA_K} vs plain: "
                                    f"{key} {vs_plain[key]}")
                rolled = float((got.bp < lane0.bp).double().mean())
                if rolled == 0:
                    problems.append(f"{lab}: no lane rolled over")
                rec[f"{level}_T{u.shape[1]}"] = {
                    "merged_trial": {"max_abs_err": max(e[0] for e in errs),
                                     "max_rel_err": max(e[1] for e in errs)},
                    f"mega_k{QUAD_MEGA_K}": {
                        "steps": int(steps), "plain_steps": int(ref_steps),
                        "rolled_over_frac": rolled, "vs_plain": vs_plain}}
            trial_p, scans = par_inputs(QUAD_T, B, dtype, dev,
                                        model="quadrotor")
            rec.update(compare_scans({k: scans[k] for k in
                                      ("suffix", "prefix")}, dtol, label))
            rec.update(par_f64_conditioned(trial_p, scans, label)
                       if dtype == torch.float64
                       else par_f32_vs_f64(trial_p, scans, label))
            out[label] = rec
    out["problems"] = problems
    return out


def lane_errors(outs, refs):
    """Per lane (the leading axis), the largest error of ``outs`` against
    ``refs`` relative to each output's largest |ref|."""
    import torch

    err = None
    for o, r in zip(outs, refs):
        r = r.double()
        e = ((o.double() - r).abs().flatten(1).amax(1)
             / (float(r.abs().max()) + 1e-30))
        err = e if err is None else torch.maximum(err, e)
    return err


def par_f64_conditioned(trial, scans, label):
    """Phase T1's float64 check of the value scan and the parallel trial at
    the quadrotor's (6, 2): against the plain version at phase K's 1e-10
    of scale, or at the float64 image of the data's own rounding
    amplification where that is larger: 8 x (float64 eps / float32 eps) x
    the largest lane error of the plain version run in float32 on the same
    inputs against its float64 result (:func:`par_f32_vs_f64`: up to 8e-2
    at B=4096, an amplification of some 1e6 that puts float64 rounding
    near 1e-10); equal ok flags; the trial also against the pipeline on
    the scan kernels at the same tolerance."""
    import torch

    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk

    ratio = torch.finfo(torch.float64).eps / torch.finfo(torch.float32).eps
    f32 = lambda args: tuple(a.float() for a in args)  # noqa: E731
    pairs = {
        "value_scan": (sk.value_scan(*scans["value"]),
                       sk.value_scan_plain(*scans["value"]),
                       sk.value_scan_plain(*f32(scans["value"])), None),
        "par_trial": (nk.fused_newton_step(*trial),
                      nk.fused_newton_step_plain(*trial),
                      nk.fused_newton_step_plain(*f32(trial)),
                      nk.newton_pipeline(*trial))}
    out = {}
    for name, (got, ref, ref32, pipe) in pairs.items():
        floats = slice(0, 2) if name == "par_trial" else slice(None)
        amp = float(lane_errors(ref32[floats], ref[floats]).max())
        tol = max(1e-10, 8 * ratio * amp)
        rec = {"tolerance": tol, "plain_float32_vs_float64_max": amp}
        for who, o in (("plain", got), ("pipeline", pipe)):
            if o is None:
                continue
            if name == "par_trial":
                check(torch.equal(o[3], ref[3]), f"{label} {name} vs {who}: "
                      "ok differs")
                prel = float(((o[2] - ref[2]).abs() / ref[2].abs()).max())
                check(prel <= tol, f"{label} {name} vs {who}: pred rel err "
                      f"{prel} > {tol}")
                rec[f"vs_{who}_pred_max_rel_err"] = prel
            err = float(lane_errors(o[floats], ref[floats]).max())
            check(err <= tol, f"{label} {name} vs {who}: {err} of scale > "
                  f"{tol}")
            rec[f"vs_{who}_max_rel_err"] = err
        out[name] = rec
    return out


def par_f32_vs_f64(trial, scans, label):
    """Phase T1's float32 check of the value scan and the parallel trial at
    the quadrotor's (6, 2).  On this data (a T=40 cold start, bp=0.1) the
    parallel LQT's float32 rounding is amplified lane by lane: the plain
    version's own float32 result lies up to 8e-2 of scale from its
    float64 result on the same inputs (B=4096; 1e-3 at B=33), and JAX's
    Pallas trial in interpret mode up to 0.61 (B=256), so no float32
    association meets phase K's 1e-4 against another.  Each kernel and its
    plain version are held against the plain version in float64 on the
    same float32 inputs: the median lane within F32_TOL (K's tolerance),
    equal ok flags, finite outputs; the largest and 99th-percentile lane
    errors of both are recorded."""
    import torch

    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk

    out = {}
    pairs = {
        "value_scan": (sk.value_scan(*scans["value"]),
                       sk.value_scan_plain(*scans["value"]),
                       sk.value_scan_plain(*(a.double()
                                             for a in scans["value"]))),
        "par_trial": (nk.fused_newton_step(*trial),
                      nk.fused_newton_step_plain(*trial),
                      nk.fused_newton_step_plain(*(a.double()
                                                   for a in trial)))}
    q = torch.tensor([0.5, 0.99], dtype=torch.float64)
    for name, (got, plain, ref) in pairs.items():
        floats = slice(0, 2) if name == "par_trial" else slice(None)
        if name == "par_trial":
            check(torch.equal(got[3], plain[3]) and torch.equal(
                plain[3].cpu(), ref[3].cpu()), f"{label} {name}: ok differs")
        check(all(bool(torch.isfinite(g).all()) for g in got[floats]),
              f"{label} {name}: non-finite output")
        rec = {}
        for who, o in (("kernel", got), ("plain", plain)):
            e = lane_errors(o[floats], ref[floats])
            med, p99 = torch.quantile(e, q.to(e.device)).tolist()
            rec[f"{who}_vs_float64"] = {"median": med, "p99": p99,
                                        "max": float(e.max())}
        rec["kernel_vs_plain_max"] = float(lane_errors(got[floats],
                                                       plain[floats]).max())
        check(rec["kernel_vs_float64"]["median"] <= F32_TOL,
              f"{label} {name}: median lane {rec['kernel_vs_float64']} "
              f"from float64 > {F32_TOL}")
        out[name] = rec
    return out


def timed_kernel(rec, name, wrapper, entry, horizon, plain_ms, ins, ops):
    """One kernel's float32 times into ``rec[name]``: through its wrapper
    (ms) and its C entry on outputs allocated once (entry_ms, per stage in
    SM cycles), beside its plain version's ``plain_ms`` and its bound."""
    with SmClock() as clock:
        busy(entry, 0.3)
        r = {"ms": cuda_ms(wrapper, 20), "entry_ms": cuda_ms(entry, 20)}
    r["entry"] = per_stage(r["entry_ms"], horizon, clock.mhz)
    r["plain_ms"] = plain_ms
    r.update(bound(nbytes(ins, wrapper()), ops))
    rec[name] = r


def codegen_kernel_times(model, horizon, fine, levels, dev, bp=0.1):
    """The times of one model's generated kernels at B=4096 in float32
    (``fine``: at least 2 x 4096 scenario rows of the fine grid; ``levels``:
    :func:`quad_levels`' layout): the five fused kernels (wrapper, C
    entry, plain version) at ``horizon``, then the merged trial and one
    k=8 mega launch on each level (Newton on the fine grid, DDP on the
    coarse), each beside its bound."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import fused_iter as tf
    from ipoc_tpu_torch.ops import mega

    ocp = model_ocp(model, 1, horizon)
    dtype, peak, rec = torch.float32, PEAK_F32_OPS_PER_S, {}
    u, u_other, x0, bpt, rp = fused_inputs(
        tuple(a[:2 * LANES] for a in fine), dtype, dev, bp)
    T_, nu, B = u.shape
    nx = x0.shape[0]
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0, bpt)
    reg = rp * torch.clamp(torch.sqrt(cunsq), min=1e-6)
    up = (u + 0.2 * (u - u_other)).contiguous()
    fused = fused_times(ocp, xs, xT, u, up, x0, bpt, reg)
    ops = program_ops(ocp, nx, nu)
    Kk = tf.fused_bwd_launch(ocp, xs, xT, u, bpt, reg)[0]
    per_lane = {
        "fused_bwd": (T_ * (ops["stage_bwd"] + riccati_ops(nx, nu))
                      + ops["term"], (xs, xT, u, bpt, reg),
                      tf.fused_bwd_launch(ocp, xs, xT, u, bpt, reg)),
        "fused_fwd": (T_ * ops["stage_fwd"] + ops["term_fwd"],
                      (xs, xT, u, bpt, Kk),
                      tf.fused_fwd_launch(ocp, xs, xT, u, bpt, Kk)),
        "rollout": (T_ * ops["dynamics"], (u, x0),
                    tf.rollout_packed(ocp, u, x0)),
        "rollout_cost": (T_ * ops["roll_cost"] + ops["final_cost"],
                         (u, x0, bpt),
                         tf.rollout_cost_packed(ocp, u, x0, bpt)),
        "transition": (T_ * ops["transition"] + 2 * ops["final_cost"],
                       (u, up, x0, bpt),
                       tf.transition_packed(ocp, u, up, x0, bpt))}
    for k, (n_ops, ins, outs) in per_lane.items():
        fused[k].update(bound(nbytes(ins, outs), B * n_ops,
                              ops_per_s=peak))
    rec.update(fused)
    for level, (ocp_l, ul, xl, ddp) in levels.items():
        cfg = BATCH_CONFIG.replace(newton_impl="ddp" if ddp else "fused")
        lane0 = open_packed(ocp_l, ul, xl, cfg, bp)
        reg = 100.0 * torch.clamp(lane0.cun, min=1e-6)
        args = (ocp_l, lane0.xs, lane0.xT, lane0.u, lane0.bp, reg)
        Tl = ul.shape[1]
        ops = program_ops(ocp_l, nx, nu)
        fwd = ops["stage_ddp_fwd" if ddp else "stage_fwd"]
        trial_ops = (Tl * (ops["stage_bwd"] + riccati_ops(nx, nu) + fwd)
                     + ops["term"]
                     + ops["term_ddp_fwd" if ddp else "term_fwd"])
        timed_kernel(rec, f"merged_trial_{level}_T{Tl}",
                     lambda: tf.merged_trial_launch(*args, ddp=ddp),
                     merged_entry(*args, ddp), Tl,
                     cuda_ms(lambda: tf.fused_newton_iter_plain(
                         *args, ddp=ddp), 3), args[1:], B * trial_ops)
        active = torch.ones_like(lane0.done)
        ws = mega.mega_workspace(lane0)
        got, steps = mega.mega_k_iterations(
            ocp_l, mega.clone_lane(lane0), active, cfg, QUAD_MEGA_K, ddp,
            ws)
        lane_iters = int((got.it - lane0.it).sum())
        with SmClock() as clock:
            ms = event_ms(lambda ln: mega.mega_k_iterations(
                ocp_l, ln, active, cfg, QUAD_MEGA_K, ddp, ws), 5,
                lambda: mega.clone_lane(lane0))
        rec[f"mega_{level}_T{Tl}_k{QUAD_MEGA_K}"] = {
            "ms": ms, "steps": int(steps),
            "per_stage_iteration": per_stage_iteration(ms, int(steps),
                                                       Tl, clock.mhz),
            "plain_ms": event_ms(lambda ln: mega.mega_k_iterations_plain(
                ocp_l, ln, active, cfg, QUAD_MEGA_K, ddp), 1,
                lambda: lane0, warm=False),
            **bound(2 * nbytes(tuple(lane0)), lane_iters * trial_ops,
                    ops_per_s=peak)}
    return rec


def quad_kernel_times(pool, dev):
    """Phase T1's times at B=4096, T=40, float32 (the merged trial and the
    mega kernel: Newton at T=40, DDP at T=10): each kernel through its
    wrapper (ms) and its C entry on outputs allocated once (entry_ms, per
    stage in SM cycles), beside its plain version and its bound.  (No
    float64 times: they were cut to hold the whole smoke near its time
    budget; PERF.md keeps a measurement of them.)"""
    import torch

    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.ops import scan_kernels as sk
    from ipoc_tpu_torch.ops.cuda import seq_newton as sn

    dtype, rec = torch.float32, {}

    def plain(fn):
        return cuda_ms(fn, 3)

    def timed(*a):
        timed_kernel(rec, *a)

    trial, costate = slice_stage_data(
        tuple(a[:LANES] for a in pool), dtype, dev, model="quadrotor",
        horizon=QUAD_T)
    B, T_, nx, nu = trial[5].shape
    timed("seq_newton_trial",
          lambda: sn.seq_newton_trial_batched(*trial),
          seq_trial_entry(trial), T_,
          plain(lambda: sn.seq_newton_trial_plain(*trial)), trial,
          B * T_ * riccati_ops(nx, nu))
    timed("seq_costates", lambda: sn.seq_costates_batched(*costate),
          costate_entry(costate), T_,
          plain(lambda: sn.seq_costates_plain(*costate)), costate,
          B * T_ * 2 * nx * nx)
    # The generated kernels (fused_times times wrapper, entry and plain
    # version; the merged trial and one k=8 mega launch in each mode).
    rec.update(codegen_kernel_times("quadrotor", QUAD_T, pool,
                                    quad_levels(pool, LANES, dtype, dev),
                                    dev))
    # The parallel-in-time kernels at B=4096, T=40.
    trial_p, scans = par_inputs(QUAD_T, LANES, dtype, dev,
                                model="quadrotor")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timed("par_newton_trial", lambda: nk.fused_newton_step(*trial_p),
          trial_entry(cuda.library(cuda.PAR_NEWTON), trial_p, sms), T_,
          plain(lambda: nk.fused_newton_step_plain(*trial_p)), trial_p,
          par_trial_ops(B, T_, nx, nu))
    rec["par_newton_trial"]["lanes"] = nk.trial_lanes(B, T_, sms, nx,
                                                      dtype)
    for name, kind in (("affine_scan", "suffix"),
                       ("affine_scan_prefix", "prefix"),
                       ("value_scan", "value")):
        a = scans[kind]
        if kind == "value":
            wrapper = lambda a=a: sk.value_scan(*a)  # noqa: E731
            pl = lambda a=a: sk.value_scan_plain(*a)  # noqa: E731
            n_ops = B * (a[1].shape[1] - 1) * value_combine_ops(nx)
        else:
            rev = kind == "suffix"
            wrapper = lambda a=a, r=rev: sk.affine_scan(*a, r)  # noqa
            pl = lambda a=a, r=rev: sk.affine_scan_plain(*a, r)  # noqa
            n_ops = B * a[1].shape[1] * affine_combine_ops(nx)
        timed(name, wrapper, scan_entry(name, a), a[1].shape[1],
              plain(pl), a, n_ops)
        rec[name]["lanes"] = sk.scan_lanes(
            B, a[1].shape[1], dtype, sms, value=kind == "value", n=nx)
    return rec


def bench_stream(pool, dev, cfg, mega_path=True, model="quadrotor",
                 horizon=QUAD_T, quality=None):
    """bench.py's single-grid stream of ``model`` at ``horizon`` (the
    quadrotor's by default) at the bench's width (``solve_stream``, 4096
    lanes, refill every 32; the two-launch arm without ``mega_path``): its
    record, with ``quality(ocp, controls, x0)``'s (the quadrotor's by
    default), and solution."""
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.solvers import packed_stream as ps
    from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap

    ocp = model_ocp(model, 1, horizon)
    u, x0 = (a.to(dev) for a in pool)
    solve = solve_at_width if mega_path else two_launch_at_width
    solve(ocp, u[:256], x0[:256], cfg.replace(max_newton_iters=1),
          256).iterations.cpu()
    with counting(ps, "packed_lane_init", opened_lanes) as opened, \
            counting(mega, "mega_k_iterations") as rounds:
        cuda.reset_launches()
        t0 = time.perf_counter()
        sol = solve(ocp, u, x0, cfg, LANES)
        sol.iterations.cpu()
        wall = time.perf_counter() - t0
        counts = dict(cuda.launches)
    rec = {"wall_s": wall, "solves_per_s": u.shape[0] / wall,
           "steps": sol.steps, "launches": counts,
           "lane_openings": len(opened.calls),
           "refill_rounds": len(rounds.calls),
           **iteration_summary(sol.iterations, flat_total_cap(cfg))}
    if mega_path:
        busy, top = run_busy_share(
            lambda: solve(ocp, u, x0, cfg, LANES).iterations.cpu(), wall)
        rec.update({"device_busy_share_whole_run": busy,
                    "whole_run_device_ms_top_kernels": top})
    rec.update((quality or quad_quality)(ocp, sol.controls, x0,
                                         sol.completed))
    return rec, sol


def iteration_summary(iterations, cap):
    it = iterations.cpu().double()
    return {"mean_iterations": float(it.mean()),
            "max_iterations": int(it.max()),
            "lanes_at_iteration_cap": {f"{cap}": int((it >= cap).sum())}}


def quad_quality(ocp, controls, x0, completed=None):
    """The non-finite raw-cost share and the controls' range (each must lie
    strictly inside the thrust box); with ``completed``, the scenarios
    whose solve stopped before bp_min."""
    import torch

    costs = raw_costs(ocp, controls, x0).double().cpu()
    out = {"frac_nonfinite_cost": float((~torch.isfinite(costs))
                                        .double().mean()),
           "mean_raw_cost": float(costs.mean()),
           "u_min": float(controls.min()), "u_max": float(controls.max())}
    if completed is not None:
        out["lanes_incomplete"] = int((~completed).sum())
    return out


def check_quad_quality(rec, label):
    quad = model_module("quadrotor")
    check(rec["frac_nonfinite_cost"] == 0.0,
          f"{label}: non-finite raw cost share {rec['frac_nonfinite_cost']}")
    check(quad.F_MIN < rec["u_min"] and rec["u_max"] < quad.F_MAX,
          f"{label}: controls in [{rec['u_min']}, {rec['u_max']}], not "
          f"strictly inside ({quad.F_MIN}, {quad.F_MAX})")


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_quadrotor(dev, cpu_ref):
    """Phase T: the planar quadrotor through every path of the port.
    Returns the launch counts of its paths (T2's streams, T3's card
    multigrid, T4's single solves, the LQT passes) and the kernels'
    record (T1's times at B=4096, T=40)."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.ops import newton_kernel as nk
    from ipoc_tpu_torch.solvers import packed_stream as ps
    from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap

    t_start = time.perf_counter()
    pool32 = quad_pool()
    out = {"phase": "T", "model": "quadrotor", "nx": 6, "nu": 2,
           "horizon": QUAD_T, "dt": 1.0 / QUAD_T}
    counts = {}
    # T1: the kernels against their plain versions, then their times.
    t0 = time.perf_counter()
    checks = quad_kernel_checks(pool32, dev)
    record = quad_kernel_times(pool32, dev)
    trial, _ = par_inputs(QUAD_T, LANES, torch.float32, dev,
                          model="quadrotor")
    cuda.reset_launches()
    nk.newton_pipeline(*trial)
    torch.cuda.synchronize()
    lqt = {k: v for k, v in cuda.launches.items() if v}
    add_counts(counts, lqt)
    out["T1"] = {"checks": checks, "timing": record,
                 "lqt_passes_launches": lqt,
                 "s": time.perf_counter() - t0}
    # T2: bench.py's quadrotor configuration: the single grid on the mega
    # executor, the multigrid, and each on the two-launch arm (the
    # single grid's per-iteration kernels; the coarse level's merged
    # trial).
    t0 = time.perf_counter()
    cfg = BATCH_CONFIG
    sg, sol_sg = bench_stream(pool32, dev, cfg)
    add_counts(counts, sg["launches"])
    two, _ = bench_stream(pool32, dev, cfg, mega_path=False)
    add_counts(counts, two["launches"])
    mg, sol_mg, solve, _ = multigrid_at_width(
        "T2", pool32, dev, sol_sg, horizon=QUAD_T, model="quadrotor")
    add_counts(counts, mg["launches"])
    mg.pop("phase")
    mg.update(quad_quality(model_ocp("quadrotor", 1, QUAD_T),
                           sol_mg.controls, pool32[1].to(dev)))
    mg["fine"].update(iteration_summary(sol_mg.iterations,
                                        flat_total_cap(cfg)))
    mg["coarse"].update(iteration_summary(sol_mg.iterations_coarse,
                                          flat_total_cap(cfg)))

    def two_launch_coarse(o, uc, xx, c, lanes, refill_every):
        return ps.solve_stream_packed(o, uc, xx, c, lanes=lanes,
                                      refill_every=refill_every, mega=False)

    u, x0 = (a.to(dev) for a in pool32)
    cuda.reset_launches()
    sol2 = solve(u, x0, coarse_solver=two_launch_coarse)
    sol2.iterations.cpu()
    mg["coarse_two_launch"] = {"launches": dict(cuda.launches),
                               "steps_coarse": sol2.steps_coarse,
                               "steps": sol2.steps}
    add_counts(counts, cuda.launches)
    out["T2"] = {"config": "BATCH_CONFIG", "dtype": "float32",
                 "lanes": LANES, "refill_every": REFILL,
                 "scenarios": POOL, "single_grid": sg,
                 "single_grid_two_launch": two, "multigrid": mg,
                 "s": time.perf_counter() - t0}
    # T4: the single solves, the card against the CPU child's.
    t0 = time.perf_counter()
    solves, card_u = {}, {}
    for name in QUAD_SOLVES:
        cuda.reset_launches()
        t1 = time.perf_counter()
        card_u[name], it_card = quad_single_solve(name, dev)
        wall = time.perf_counter() - t1
        launches = {k: v for k, v in cuda.launches.items() if v}
        add_counts(counts, launches)
        solves[name] = {"iterations": it_card, "wall_s": wall,
                        "launches": launches}
    out["T4"] = {"solves": solves, "config": "FAST_CONFIG (quadrotor; "
                 "newton_seq with newton_impl='seq'), the default (double "
                 "integrator)", "dtype": "float64"}
    # The references: the CPU child's (started with the others).
    t1 = time.perf_counter()
    for name, (u_cpu, it_cpu) in cpu_ref().items():
        solves[name].update({
            "iterations_cpu": it_cpu,
            "max_abs_du": float((card_u[name] - u_cpu).abs().max())})
    out["T4"]["waited_for_cpu_child_s"] = time.perf_counter() - t1
    out["T4"]["s"] = time.perf_counter() - t0
    out["s"] = time.perf_counter() - t_start
    emit(out)
    problems = checks["problems"]
    for label, rec in (("T2 single grid", sg), ("T2 multigrid", mg)):
        check_quad_quality(rec, label)
    check_mega_path(sg["launches"], sg["refill_rounds"], sg["lane_openings"])
    check_mega_path(mg["launches"], mg["refill_rounds"], mg["lane_openings"],
                    gates=1)
    for k in ("fused_bwd", "fused_fwd", "transition"):
        check(two["launches"][k] == two["steps"] > 0,
              f"T2 two-launch arm: {k} launched {two['launches'][k]} times "
              f"in {two['steps']} steps")
    check(mg["coarse_two_launch"]["launches"]["merged_trial"]
          == sol2.steps_coarse > 0,
          f"T2 coarse two-launch arm: {mg['coarse_two_launch']}")
    check(lqt == {"value_scan": 1, "affine_scan": 1},
          f"the LQT passes launched {lqt}")
    for name, rec in solves.items():
        check(rec["iterations"] == rec["iterations_cpu"]
              and rec["max_abs_du"] <= 1e-8,
              f"T4 {name}: card {rec['iterations']} iterations, CPU "
              f"{rec['iterations_cpu']}, controls {rec['max_abs_du']} apart")
    kernels = {"par": ("affine_scan", "par_newton_trial"),
               "seq": ("seq_costates",),
               "newton_seq": ("seq_newton_trial", "seq_costates"),
               "double_integrator": ("affine_scan", "par_newton_trial")}
    for name, ks in kernels.items():
        for k in ks:
            check(solves[name]["launches"].get(k, 0) > 0,
                  f"T4 {name} launched no {k}")
    check(not problems, "; ".join(problems))
    return counts, record


def quad_kernel_record(timing, kernel):
    """A kernel's phase T times in the kernels' line (the merged trial's at
    the multigrid's coarse level, DDP at T=10; the mega kernel's Newton
    k=8 launch at T=40)."""
    key = {"merged_trial": f"merged_trial_ddp_T{QUAD_T // COARSEN}",
           "mega": f"mega_newton_T{QUAD_T}_k{QUAD_MEGA_K}"}.get(kernel, kernel)
    rec = timing.get(key)
    if rec is None:
        return None
    return {f: rec.get(f) for f in ("ms", "entry_ms", "plain_ms", "bound_ms",
                                    "bound_by")}


# ---------------------------------------------------------------------------
# Phase U: state constraints (the unicycle's keep-out disc, the cart box)
# ---------------------------------------------------------------------------


def uni_pool():
    """Phase U's pool: bench.py's recipe for the unicycle (H=100, 4 x 4096
    scenarios, both controls about zero), float32 on the CPU."""
    import torch

    return make_pool(model_module("unicycle"), POOL, torch.float32)


def uni_stage_data(pool, dev):
    """U1's scenario rows, bp -> level -> ``(u, x0)`` on the CPU, 2 x 4096
    of them: at bp 0.1 the pool's cold start (the coarse level every 4th
    control, as the multigrid takes them); at bp 0.004 the iterates of
    each level's stream (Newton on the fine grid, DDP on the coarse; the
    mega executor, float32) converged at that barrier stage, which ride
    the disc."""
    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream

    u, x0 = (a[:2 * LANES] for a in pool)
    cold, solved = {}, {}
    for level, (coarsen, ddp) in LEVELS.items():
        uc = u[:, ::coarsen].contiguous()
        cold[level] = (uc, x0)
        cfg = BATCH_CONFIG.replace(bp_min=UNI_BPS[1] * 0.99)
        if ddp:
            cfg = cfg.replace(newton_impl="ddp")
        sol = solve_stream(model_ocp("unicycle", coarsen), uc.to(dev),
                           x0.to(dev), cfg, lanes=LANES, refill_every=REFILL)
        solved[level] = (sol.controls.cpu(), x0)
    return {UNI_BPS[0]: cold, UNI_BPS[1]: solved}


def disc_lanes(stages, dtype, dev):
    """Unicycle lanes at T=100, dt 0.01, that drive straight along +x at
    v = 1.6 on the chord 0.005 below the disc's top: a stage point every
    0.016 of x, so lane b's only point inside the disc is at stage
    ``stages[b]`` (T: the terminal state; past T: none).  Returns ``(u
    (T, 2, B), x0 (3, B))``, batch-last."""
    import math

    import torch

    uni = model_module("unicycle")
    cx, cy = uni.CENTER
    v, h = 1.6, 0.005
    B = len(stages)
    u = torch.zeros((T, 2, B), dtype=dtype)
    u[:, 0] = v
    x0 = torch.zeros((3, B), dtype=dtype)
    x0[0] = torch.tensor([cx - v * DT * s for s in stages], dtype=dtype)
    x0[1] = cy + math.sqrt(uni.RADIUS**2 - h * h)
    return u.to(dev), x0.to(dev)


def uni_disc_checks(dtype, dev):
    """U1's disc batches: lanes whose states enter the disc at one
    constrained stage (0, 1, 50, 99: infeasible) and lanes whose only entry
    is the terminal state or that never enter (feasible).  The forward
    sweep on zero gains (its trial point is the iterate) against the plain
    version's ``max(constraints(temp_x[:-1], temp_u))``; the rollout cost
    and both candidates of the transition against their plain versions:
    NaN barrier costs on the infeasible lanes alone, in both."""
    import torch

    from ipoc_tpu_torch.ops import fused_iter as tf

    ocp = model_ocp("unicycle")
    stages = (0, 1, T // 2, T - 1, T, T + 3)
    inside = torch.tensor([s < T for s in stages], device=dev)
    u, x0 = disc_lanes(stages, dtype, dev)
    bp = torch.full((len(stages),), 0.05, dtype=dtype, device=dev)
    xs, xT = tf.rollout_plain(ocp, u, x0)
    x, ub = tf.lanes_first(xs, xT), u.permute(2, 0, 1)
    Kk = torch.zeros((T, (1 + 3) * 2, len(stages)), dtype=dtype, device=dev)
    _, tx, _, nc, mc, _ = tf.fused_fwd_launch(ocp, xs, xT, u, bp, Kk)
    mc_plain = ocp.constraints(x[:, :-1], ub).flatten(1).amax(1)
    nc_plain = ocp.total_cost(x, ub, bp)
    roll = tf.rollout_cost_packed(ocp, u, x0, bp)[2]
    roll_plain = tf.rollout_cost_plain(ocp, u, x0, bp)[2]
    tr = tf.transition_packed(ocp, u, u, x0, bp)
    tr_plain = tf.transition_plain(ocp, u, u, x0, bp)
    label = f"U1 disc {str(dtype)[6:]}"
    check(torch.equal(tx, xs), f"{label}: the zero-gain trial moved")
    for name, got in (("fused_fwd max_c", mc > 0),
                      ("plain max_c", mc_plain > 0),
                      ("fused_fwd cost", torch.isnan(nc)),
                      ("plain cost", torch.isnan(nc_plain)),
                      ("rollout_cost", torch.isnan(roll)),
                      ("rollout_cost plain", torch.isnan(roll_plain)),
                      ("transition a", torch.isnan(tr[4])),
                      ("transition b", torch.isnan(tr[5])),
                      ("transition plain", torch.isnan(tr_plain[4]))):
        check(torch.equal(got, inside), f"{label} {name}: infeasible lanes "
              f"{got.tolist()}, expected {inside.tolist()}")
    err = float((mc - mc_plain).abs().max() / mc_plain.abs().max())
    check(err <= (1e-12 if dtype == torch.float64 else F32_TOL),
          f"{label}: max_c {err} of scale from the plain version's")
    return {"entry_stages": list(stages), "max_c": mc.tolist(),
            "max_c_plain": mc_plain.tolist(), "max_c_rel_err": err}


def nudged(tensors):
    """The floating tensors of ``tensors`` one ulp up (x * (1 + eps)),
    the others as they are."""
    import torch

    return tuple(t * (1 + torch.finfo(t.dtype).eps)
                 if t.is_floating_point() else t for t in tensors)


def conditioned_compare(label, got, ref, near, tol, problems):
    """``got`` (the kernel's output) against ``ref`` (its plain version's),
    held as phases D and G hold them, to ``tol`` of the output's largest
    finite |ref|, plus eight times ``|ref - near|``, what the plain
    version itself moves when its inputs move by one ulp (``near()``,
    evaluated only where ``got`` is not within ``tol`` already): at an
    iterate that rides the disc the barrier's Hessian terms
    (bp / c^2) outgrow the pivots that they sum to by many orders, and
    every evaluation order rounds them apart by that much.  NaN and inf
    entries must be the same as ``ref``'s on every lane where ``near``
    has ``ref``'s; a lane where the one-ulp nudge itself changes them is
    on a knife edge and counted apart.  Failures go to ``problems``;
    returns the record."""
    import torch

    got, ref = got.double(), ref.double()
    lead = ref.shape[-1]  # the lanes: batch-last
    fin = torch.isfinite(ref) & torch.isfinite(got)
    scale = float(ref[fin].abs().max()) + 1e-30 if bool(fin.any()) else 1.0
    err = (got - ref).abs()
    if torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.equal(
            got[torch.isinf(ref)], ref[torch.isinf(ref)]) and not bool(
            torch.isinf(got).ne(torch.isinf(ref)).any()) and not bool(
            (err[fin] > tol * scale).any()):
        return {"max_rel_err": float(err[fin].max()) / scale
                if bool(fin.any()) else 0.0}
    near = near().double()

    def by_lane(mask):
        return mask.reshape(-1, lead).any(0) if mask.dim() > 1 else mask

    pattern = lambda a: torch.isnan(a) | torch.isinf(a)  # noqa: E731
    edge = by_lane((pattern(ref) != pattern(near))
                   | (torch.isinf(ref) & (ref != near)))
    same = torch.where(torch.isnan(ref), torch.isnan(got), got == ref)
    bad_pattern = by_lane(pattern(ref) & ~same) | by_lane(
        pattern(got) & ~pattern(ref))
    if bool((bad_pattern & ~edge).any()):
        problems.append(f"{label}: NaN/inf entries differ on "
                        f"{int((bad_pattern & ~edge).sum())} lanes")
    fin = fin & torch.isfinite(near)
    keep = fin & ~(edge if ref.dim() == 1 else edge.expand_as(
        ref.reshape(-1, lead)).reshape(ref.shape))
    spread = (ref - near).abs()
    bound = tol * scale + 8 * spread
    over = keep & (err > bound)
    if bool(over.any()):
        problems.append(f"{label}: {int(over.sum())} entries past "
                        f"{tol} of scale {scale} + 8 x the one-ulp spread "
                        f"(worst {float((err - bound)[over].max())})")
    plain = keep & (err > tol * scale)
    return {"max_rel_err": float(err[keep].max()) / scale
            if bool(keep.any()) else 0.0,
            "max_spread_rel": float(spread[keep].max()) / scale
            if bool(keep.any()) else 0.0,
            "entries_past_tol_within_spread": int(plain.sum()),
            "knife_edge_lanes": int(edge.sum())}


def lazy(fn):
    """``fn()``, computed at the first call and kept."""
    box = []

    def get():
        if not box:
            box.append(fn())
        return box[0]

    return get


def trial_ok(outs):
    """A trial's accept precondition per lane: a finite positive minimum
    pivot and a finite predicted reduction."""
    import torch

    piv, pred = outs[7], outs[6]
    return torch.isfinite(piv) & (piv > 0) & torch.isfinite(pred)


def check_ok_flags(label, got, ref, near, problems):
    """The kernel's and the plain version's ok flags equal but on the
    lanes where a one-ulp nudge of the inputs (``near()``) flips the plain
    version's."""
    import torch

    ok = [trial_ok(o) for o in (got, ref)]
    if torch.equal(ok[0], ok[1]):
        return {"ok_frac": float(ok[1].double().mean())}
    ok.append(trial_ok(near()))
    differ = (ok[0] != ok[1]) & (ok[1] == ok[2])
    if bool(differ.any()):
        problems.append(f"{label}: ok flags differ on {int(differ.sum())} "
                        "lanes")
    return {"ok_frac": float(ok[1].double().mean()),
            "ok_knife_edge_lanes": int((ok[1] != ok[2]).sum())}


def uni_kernel_checks(data, dev):
    """Phase U1's checks: every generated kernel at the unicycle's (3, 2)
    against its plain version at B in UNI_CHECK_B and bp in UNI_BPS,
    float64 then float32, with phases D and G's tolerances plus the plain
    version's own one-ulp spread (:func:`conditioned_compare`): the fused
    five on the fine grid, the merged trial and a k=8 mega launch on each
    level (Newton at T=100, DDP at T=25), and the disc batches."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import fused_iter as tf
    from ipoc_tpu_torch.ops import mega

    out, problems = {}, []
    ocp = model_ocp("unicycle")
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        dtol = 1e-10 if dtype == torch.float64 else F32_TOL
        out[f"disc_{tag}"] = uni_disc_checks(dtype, dev)
        for B in UNI_CHECK_B:
            for bp in UNI_BPS:
                label = f"unicycle B={B} bp={bp} {tag}"
                u, u_other, x0, bpt, rp = fused_inputs(
                    tuple(a[:2 * B] for a in data[bp]["newton"]), dtype, dev,
                    bp)
                up = (u + 0.2 * (u - u_other)).contiguous()
                xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0, bpt)
                reg = rp * torch.clamp(torch.sqrt(cunsq), min=1e-6)
                fused = {
                    "rollout_cost": (tf.rollout_cost_packed,
                                     tf.rollout_cost_plain, (u, x0, bpt)),
                    "two_launch_trial": (
                        tf.fused_newton_iter_packed,
                        tf.fused_newton_iter_plain, (xs, xT, u, bpt, reg)),
                    "transition": (tf.transition_packed, tf.transition_plain,
                                   (u, up, x0, bpt))}
                rec = {"rollout": compare_rollout(ocp, u, x0, label)}
                for name, (kernel, plain, args) in fused.items():
                    got = kernel(ocp, *args)
                    ref = plain(ocp, *args)
                    near = lazy(lambda plain=plain, args=args: plain(
                        ocp, *nudged(args)))
                    rec[name] = [conditioned_compare(
                        f"{label} {name}[{i}]", g, r,
                        lambda i=i, near=near: near()[i], dtol, problems)
                        for i, (g, r) in enumerate(zip(got, ref))]
                    if name == "two_launch_trial":
                        rec["two_launch_ok"] = check_ok_flags(
                            f"{label} {name}", got, ref, near, problems)
                for level, (coarsen, ddp) in LEVELS.items():
                    ocp_l = model_ocp("unicycle", coarsen)
                    ul, xl = (a[:B].to(dev, dtype) for a in data[bp][level])
                    lab = f"{label} {level} T={ul.shape[1]}"
                    lane = open_packed(ocp_l, ul, xl, BATCH_CONFIG, bp)
                    reg = 100.0 * torch.clamp(lane.cun, min=1e-6)
                    args = (lane.xs, lane.xT, lane.u, lane.bp, reg)
                    got = tf.merged_trial_launch(ocp_l, *args, ddp=ddp)
                    ref = tf.fused_newton_iter_plain(ocp_l, *args, ddp=ddp)
                    near = lazy(lambda ocp_l=ocp_l, args=args, ddp=ddp:
                                tf.fused_newton_iter_plain(
                                    ocp_l, *nudged(args), ddp=ddp))
                    merged = {n: conditioned_compare(
                        f"{lab} merged[{n}]", g, r,
                        lambda i=i, near=near: near()[i], dtol, problems)
                        for i, (n, g, r) in enumerate(zip(TRIAL_OUTS, got,
                                                          ref))}
                    merged["ok"] = check_ok_flags(f"{lab} merged", got, ref,
                                                  near, problems)
                    cfg = BATCH_CONFIG.replace(
                        newton_impl="ddp" if ddp else "fused",
                        max_newton_iters=2)
                    lane0 = open_packed(ocp_l, ul, xl, cfg, bp)
                    active = torch.ones_like(lane0.done)
                    got, steps = mega.mega_k_iterations(
                        ocp_l, mega.clone_lane(lane0), active, cfg,
                        QUAD_MEGA_K, ddp)
                    n = min(B, PLAIN_LANES)
                    ref, ref_steps = mega.mega_k_iterations_plain(
                        ocp_l, first_lanes(lane0, n), active[:n], cfg,
                        QUAD_MEGA_K, ddp)
                    vs_plain = compare_lanes(first_lanes(got, n), ref, dtol)
                    key = ("agree_frac" if dtype == torch.float64
                           else "decisions_equal_frac")
                    if vs_plain[key] < 0.99:
                        problems.append(f"{lab} mega k={QUAD_MEGA_K} vs "
                                        f"plain: {key} {vs_plain[key]}")
                    rolled = float((got.bp < lane0.bp).double().mean())
                    if rolled == 0:
                        problems.append(f"{lab}: no lane rolled over")
                    rec[f"{level}_T{ul.shape[1]}"] = {
                        "merged_trial": merged,
                        f"mega_k{QUAD_MEGA_K}": {
                            "steps": int(steps), "plain_steps": int(ref_steps),
                            "rolled_over_frac": rolled,
                            "ended_bad_frac": float(ended_bad(
                                ref, cfg).double().mean()),
                            "vs_plain": vs_plain}}
                out[label] = rec
    out["problems"] = problems
    return out


def uni_levels(data, bp, dev):
    """:func:`quad_levels`' layout for the unicycle from U1's rows at
    ``bp``, float32, the first 4096."""
    import torch

    return {level: (model_ocp("unicycle", coarsen),
                    *(a[:LANES].to(dev, torch.float32)
                      for a in data[bp][level]), ddp)
            for level, (coarsen, ddp) in LEVELS.items()}


def uni_quality(ocp, controls, x0, completed=None):
    """The non-finite raw-cost share, every lane's largest constraint value
    over its stage points (the terminal state is not constrained) and the
    least distance of a stage point to the disc's centre, over the
    scenarios whose solve ran to bp_min (``completed``; all where None),
    and the same over every scenario beside them: a solve that stopped on
    a non-finite cost returns its last iterate, whose rollout may cross
    the disc (a float32 Newton step accepted on its linearized states;
    JAX's float32 stream returns the same, ROADMAP section 3)."""
    import torch

    from ipoc_tpu_torch.utils.integrators import rollout

    uni = model_module("unicycle")
    costs = raw_costs(ocp, controls, x0).double().cpu()
    x = rollout(ocp.dynamics, controls, x0)[:, :-1]
    c = ocp.constraints(x, controls).flatten(1).amax(1).double().cpu()
    d = torch.sqrt((x[..., 0] - uni.CENTER[0])**2
                   + (x[..., 1] - uni.CENTER[1])**2).amin(1).double().cpu()

    def stats(mask):
        return {"frac_nonfinite_cost": float((~torch.isfinite(costs[mask]))
                                             .double().mean()),
                "mean_raw_cost": float(costs[mask].mean()),
                "max_constraint": float(c[mask].max()),
                "lanes_infeasible": int((c[mask] > 0).sum()),
                "min_distance_to_centre": float(d[mask].min()),
                "frac_lanes_within_1e-2_of_radius": float(
                    (d[mask] <= uni.RADIUS + 1e-2).double().mean())}

    if completed is None:
        return stats(torch.ones_like(c, dtype=torch.bool))
    done = completed.cpu()
    out = stats(done)
    infeasible = (c > 0) | ~torch.isfinite(costs)
    out.update({"lanes_incomplete": int((~done).sum()),
                "frac_completed": float(done.double().mean()),
                "every_lane": stats(torch.ones_like(done)),
                "infeasible_lanes": infeasible.nonzero().squeeze(1)[
                    :16].tolist(),
                "infeasible_lanes_all_incomplete": bool(
                    (~done[infeasible]).all())})
    return out


def check_uni_quality(rec, label):
    """Every completed scenario's solution feasible, finite and off the
    disc; at least 98% of them completed."""
    uni = model_module("unicycle")
    check(rec["frac_nonfinite_cost"] == 0.0,
          f"{label}: non-finite raw cost share {rec['frac_nonfinite_cost']}")
    check(rec["max_constraint"] <= 0.0 and rec["lanes_infeasible"] == 0,
          f"{label}: {rec['lanes_infeasible']} infeasible lanes, max "
          f"constraint {rec['max_constraint']}")
    check(rec["min_distance_to_centre"] >= uni.RADIUS,
          f"{label}: a stage point {rec['min_distance_to_centre']} from "
          f"the centre, inside the disc of radius {uni.RADIUS}")
    check(rec.get("frac_completed", 1.0) >= 0.98,
          f"{label}: only {rec.get('frac_completed')} of the scenarios ran "
          "to bp_min")


def uni_single_solve(name, dev, dtype=None):
    """Phase U4's single solves: ``par`` and ``seq`` are
    tests/test_unicycle.py's (T=60, dt 2/60, straight ahead at v = 0.3,
    FAST_CONFIG), ``box`` BASELINE.json config 3 (examples/p50_budget.py:
    cartpole H=100, dt 0.01, cart_limit 0.3, the par solve under
    FAST_CONFIG from 0.1 * a standard normal draw, tests/test_golden.py's
    warm start).  Float64 unless ``dtype``.  Returns ``(controls on the
    CPU, iterations)``."""
    import torch

    from ipoc_tpu_torch import (
        FAST_CONFIG,
        par_interior_point_optimal_control,
        seq_interior_point_optimal_control,
    )

    dtype = dtype or torch.float64
    if name == "box":
        ocp = model_ocp("cartpole_box")
        u0 = torch.tensor(GOLDEN_WARM_START, dtype=dtype,
                          device=dev).reshape(T, 1)
        x0 = model_module("cartpole").initial_state(dtype).to(dev)
        u, it = par_interior_point_optimal_control(ocp, u0, x0, FAST_CONFIG)
        return u.cpu(), int(it)
    uni = model_module("unicycle")
    Tn = UNI_SOLVE[1]
    u0 = torch.zeros((Tn, 2), dtype=dtype, device=dev)
    u0[:, 0] = 0.3
    solve = (seq_interior_point_optimal_control if name == "seq"
             else par_interior_point_optimal_control)
    u, it = solve(model_ocp("unicycle", *UNI_SOLVE), u0,
                  uni.initial_state(dtype, dev), FAST_CONFIG)
    return u.cpu(), int(it)


UNI_SOLVES = ("par", "seq", "box")


def uni_multigrid(u, x0):
    """Phase U5's solve, on either side: bench.py's unicycle multigrid (a
    DDP coarse level at T=25) through 64 lanes, refill 32.  Returns
    ``(controls, iterations, coarse iterations, steps, coarse steps,
    fallback)``, all but the controls on the CPU."""
    from ipoc_tpu_torch import BATCH_CONFIG, solve_stream_multigrid

    sol = solve_stream_multigrid(
        model_ocp("unicycle"), model_ocp("unicycle", COARSEN), COARSEN, u,
        x0, BATCH_CONFIG, lanes=64, refill_every=REFILL, coarse_impl="ddp")
    return (sol.controls, sol.iterations.cpu(), sol.iterations_coarse.cpu(),
            sol.steps, sol.steps_coarse, sol.fallback.cpu())


def uni_cpu():
    """Phase U's CPU child: U4's single solves and U5's multigrid on the
    pool's first 128 scenarios in float64, with the plain versions."""
    u, x0 = (a[:CARD_VS_CPU_SCENARIOS["U5"]].double() for a in uni_pool())
    t0 = time.perf_counter()
    mg = uni_multigrid(u, x0)
    return {"U5": (mg, time.perf_counter() - t0),
            "U4": {name: uni_single_solve(name, "cpu")
                   for name in UNI_SOLVES}}


def uni_path_checks(pool32, dev, single_grid_record=None):
    """Phase U2: bench.py's unicycle configuration at the bench's width:
    the single grid on the mega executor and on the two-launch arm, the
    multigrid (a DDP coarse level at T=25) and its coarse level on the
    two-launch arm.  Returns ``(record, launch counts, the multigrid's
    solve)``."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import packed_stream as ps
    from ipoc_tpu_torch.solvers.ip_newton import flat_total_cap

    cfg, counts = BATCH_CONFIG, {}
    sg, sol_sg = bench_stream(pool32, dev, cfg, model="unicycle", horizon=T,
                              quality=uni_quality)
    add_counts(counts, sg["launches"])
    two, _ = bench_stream(pool32, dev, cfg, mega_path=False,
                          model="unicycle", horizon=T, quality=uni_quality)
    add_counts(counts, two["launches"])
    mg, sol_mg, solve, _ = multigrid_at_width("U2", pool32, dev, sol_sg,
                                              model="unicycle")
    add_counts(counts, mg["launches"])
    mg.pop("phase")
    mg.update(uni_quality(model_ocp("unicycle"), sol_mg.controls,
                          pool32[1].to(dev), sol_mg.completed))
    mg["fine"].update(iteration_summary(sol_mg.iterations,
                                        flat_total_cap(cfg)))
    mg["coarse"].update(iteration_summary(sol_mg.iterations_coarse,
                                          flat_total_cap(cfg)))

    def two_launch_coarse(o, uc, xx, c, lanes, refill_every):
        return ps.solve_stream_packed(o, uc, xx, c, lanes=lanes,
                                      refill_every=refill_every, mega=False)

    u, x0 = (a.to(dev) for a in pool32)
    cuda.reset_launches()
    sol2 = solve(u, x0, coarse_solver=two_launch_coarse)
    sol2.iterations.cpu()
    mg["coarse_two_launch"] = {
        "launches": dict(cuda.launches), "steps_coarse": sol2.steps_coarse,
        "steps": sol2.steps, "fallback_lanes": int(sol2.fallback.sum())}
    add_counts(counts, cuda.launches)
    rec = {"config": "BATCH_CONFIG", "dtype": "float32", "lanes": LANES,
           "refill_every": REFILL, "scenarios": POOL, "single_grid": sg,
           "single_grid_two_launch": two, "multigrid": mg}
    return rec, counts, sol2


def phase_state_constraints(dev, cpu_ref):
    """Phase U: the unicycle's keep-out disc and the cartpole's cart box
    through every path of the port.  Returns the launch counts of its
    paths (U2's streams, U3's batch, U4's single solves) and the kernels'
    record (U1's times at B=4096, T=100 in float32)."""
    import torch

    from ipoc_tpu_torch import BATCH_CONFIG, solve_batch
    from ipoc_tpu_torch.ops import cuda
    from ipoc_tpu_torch.solvers import ip_newton
    from ipoc_tpu_torch.utils.integrators import rollout

    t_start = time.perf_counter()
    uni = model_module("unicycle")
    pool32 = uni_pool()
    out = {"phase": "U", "model": "unicycle", "nx": 3, "nu": 2,
           "horizon": T, "dt": DT}
    counts = {}
    # U1: the generated kernels against their plain versions, then their
    # times on the iterates at bp 0.004.
    t0 = time.perf_counter()
    data = uni_stage_data(pool32, dev)
    checks = uni_kernel_checks(data, dev)
    t1 = time.perf_counter()
    record = codegen_kernel_times("unicycle", T, data[UNI_BPS[1]]["newton"],
                                  uni_levels(data, UNI_BPS[1], dev), dev,
                                  UNI_BPS[1])
    out["U1"] = {"checks": checks, "timing": record,
                 "checks_s": t1 - t0, "timing_s": time.perf_counter() - t1,
                 "s": time.perf_counter() - t0}
    # U2: bench.py's unicycle configuration.
    t0 = time.perf_counter()
    out["U2"], c2, _ = uni_path_checks(pool32, dev)
    add_counts(counts, c2)
    out["U2"]["s"] = time.perf_counter() - t0
    # U3: bench.py's batch mode on 1024 scenarios, its launches held to
    # their exact counts.
    t0 = time.perf_counter()
    ocp = model_ocp("unicycle")
    u, x0 = (a[:UNI_SCENARIOS].to(dev) for a in pool32)
    cfg = BATCH_CONFIG
    with counting(ip_newton, "_trial_eval") as trials, rolling() as rolls:
        cuda.reset_launches()
        t1 = time.perf_counter()
        sol = solve_batch(ocp, u, x0, cfg)
        it = sol.iterations.cpu().double()
        wall = time.perf_counter() - t1
        launches = dict(cuda.launches)
    lockstep, n_roll = len(trials.calls), rolls.count()
    want = expected_batch_launches(cfg, lockstep, n_roll)
    add_counts(counts, launches)
    out["U3"] = {"config": "BATCH_CONFIG", "scenarios": UNI_SCENARIOS,
                 "wall_s": wall, "solves_per_s": UNI_SCENARIOS / wall,
                 "mean_iterations": float(it.mean()),
                 "max_iterations": int(it.max()),
                 "lockstep_iterations": lockstep,
                 "iterations_with_a_rollover": n_roll,
                 "launches": {k: v for k, v in launches.items() if v},
                 **uni_quality(ocp, sol.controls, x0),
                 "s": time.perf_counter() - t0}
    # U4: the single solves in float64 (then config 3 in float32, timed),
    # the card against the CPU child's.
    t0 = time.perf_counter()
    solves, card_u = {}, {}
    for name in UNI_SOLVES:
        cuda.reset_launches()
        t1 = time.perf_counter()
        card_u[name], it_card = uni_single_solve(name, dev)
        wall = time.perf_counter() - t1
        launches = {k: v for k, v in cuda.launches.items() if v}
        add_counts(counts, launches)
        solves[name] = {"iterations": it_card, "wall_s": wall,
                        "launches": launches}
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        u32, it32 = uni_single_solve("box", dev, torch.float32)
        walls.append(time.perf_counter() - t1)
    box = model_ocp("cartpole_box").dynamics
    x_box = model_module("cartpole").initial_state(torch.float64)
    solves["box_float32"] = {
        "iterations": it32, "wall_s_median_of_3": sorted(walls)[1],
        "wall_s": walls, "max_abs_x_cart": float(rollout(
            box, u32.double(), x_box)[:-1, 0].abs().max())}
    solves["box"]["max_abs_x_cart"] = float(rollout(
        box, card_u["box"], x_box)[:-1, 0].abs().max())
    for name in ("par", "seq"):
        xx = rollout(model_ocp("unicycle", *UNI_SOLVE).dynamics,
                     card_u[name], uni.initial_state(torch.float64))[:-1]
        solves[name]["min_distance_to_centre"] = float(torch.sqrt(
            (xx[:, 0] - uni.CENTER[0])**2
            + (xx[:, 1] - uni.CENTER[1])**2).min())
    t1 = time.perf_counter()
    for name, (u_cpu, it_cpu) in cpu_ref()["U4"].items():
        solves[name].update({
            "iterations_cpu": it_cpu,
            "max_abs_du": float((card_u[name] - u_cpu).abs().max())})
    out["U4"] = {"solves": solves, "dtype": "float64 (box_float32: "
                 "float32)", "config": "FAST_CONFIG",
                 "waited_for_cpu_child_s": time.perf_counter() - t1,
                 "s": time.perf_counter() - t0}
    out["s"] = time.perf_counter() - t_start
    emit(out)
    problems = list(checks["problems"])
    u2 = out["U2"]
    for label, rec in (("U2 single grid", u2["single_grid"]),
                       ("U2 multigrid", u2["multigrid"]),
                       ("U3 batch", out["U3"])):
        check_uni_quality(rec, label)
    sg, mg = u2["single_grid"], u2["multigrid"]
    check_mega_path(sg["launches"], sg["refill_rounds"], sg["lane_openings"])
    check_mega_path(mg["launches"], mg["refill_rounds"], mg["lane_openings"],
                    gates=1)
    two = u2["single_grid_two_launch"]
    for k in ("fused_bwd", "fused_fwd", "transition"):
        check(two["launches"][k] == two["steps"] > 0,
              f"U2 two-launch arm: {k} launched {two['launches'][k]} times "
              f"in {two['steps']} steps")
    c2 = mg["coarse_two_launch"]
    check(c2["launches"]["merged_trial"] == c2["steps_coarse"] > 0,
          f"U2 coarse two-launch arm: {c2}")
    check(out["U3"]["launches"] == {k: v for k, v in want.items() if v},
          f"U3 launches {out['U3']['launches']}, expected "
          f"{ {k: v for k, v in want.items() if v} }")
    for name in ("par", "seq", "box"):
        rec = solves[name]
        check(rec["iterations"] == rec["iterations_cpu"]
              and rec["max_abs_du"] <= 1e-8,
              f"U4 {name}: card {rec['iterations']} iterations, CPU "
              f"{rec['iterations_cpu']}, controls {rec['max_abs_du']} apart")
    for name in ("par", "seq"):
        d = solves[name]["min_distance_to_centre"]
        check(abs(d - uni.RADIUS) <= 1e-3,
              f"U4 {name}: least distance {d}, not on the disc")
    for name in ("box", "box_float32"):
        check(solves[name]["max_abs_x_cart"] < CART_LIMIT,
              f"U4 {name}: |x_cart| reached {solves[name]['max_abs_x_cart']}")
    kernels = {"par": ("affine_scan", "par_newton_trial"),
               "seq": ("seq_costates",),
               "box": ("affine_scan", "par_newton_trial")}
    for name, ks in kernels.items():
        for k in ks:
            check(solves[name]["launches"].get(k, 0) > 0,
                  f"U4 {name} launched no {k}")
    check(not problems, "; ".join(problems))
    return counts, record


def phase_multigrid_card_vs_cpu(dev, cpu_ref):
    """Phase U5: bench.py's unicycle multigrid on the pool's first 128
    scenarios in float64, the card (kernels) against the CPU (plain
    versions): equal steps and iterations on both levels, the same lanes
    sent to the cold start by the usable gate, controls within 1e-8."""
    n = CARD_VS_CPU_SCENARIOS["U5"]
    u, x0 = (a[:n].double().to(dev) for a in uni_pool())
    t0 = time.perf_counter()
    card = uni_multigrid(u, x0)
    t_card = time.perf_counter() - t0
    (cpu, t_cpu) = cpu_ref
    du = float((card[0].cpu() - cpu[0]).abs().max())
    rec = {"phase": "U5", "config": U5_CONFIG, "scenarios": n,
           "lanes": 64, "dtype": "float64",
           "lanes_with_different_iterations": int((card[1] != cpu[1]).sum()),
           "coarse_lanes_with_different_iterations": int(
               (card[2] != cpu[2]).sum()),
           "steps_card": card[3], "steps_cpu": cpu[3],
           "steps_coarse_card": card[4], "steps_coarse_cpu": cpu[4],
           "fallback_lanes_card": int(card[5].sum()),
           "fallback_lanes_cpu": int(cpu[5].sum()),
           "max_abs_du": du, "wall_s_card": t_card,
           "wall_s_cpu_child": t_cpu}
    emit(rec)
    check(rec["lanes_with_different_iterations"] == 0
          and rec["coarse_lanes_with_different_iterations"] == 0
          and card[3] == cpu[3] and card[4] == cpu[4],
          f"U5: iterations or steps differ: {rec}")
    check(bool((card[5] == cpu[5]).all()), "U5: the fallback lanes differ")
    check(du <= 1e-8, f"U5: controls {du} apart")


def uni_kernel_record(timing, kernel):
    """A kernel's phase U times in the kernels' line (the merged trial's at
    the multigrid's coarse level, DDP at T=25; the mega kernel's Newton
    k=8 launch at T=100); the fixed-shape kernels, which U times not, have
    none."""
    key = {"merged_trial": f"merged_trial_ddp_T{T // COARSEN}",
           "mega": f"mega_newton_T{T}_k{QUAD_MEGA_K}"}.get(kernel, kernel)
    rec = timing.get(key)
    if rec is None:
        return None
    return {f: rec.get(f) for f in ("ms", "entry_ms", "plain_ms", "bound_ms",
                                    "bound_by")}


def make_pool(model, n, dtype, seed=SEED, horizon=T):
    """The bench's pool recipe (bench.py make_batch call), on the CPU: two
    inputs for the quadrotor and the unicycle, one for the others; for the
    quadrotor the warm start shifted to hover thrust, as bench.py shifts
    it."""
    import torch

    from ipoc_tpu_torch.solvers.batched import make_batch

    hover = getattr(model, "hover_controls", None)
    nu = 2 if model.__name__.rsplit(".", 1)[-1] in ("quadrotor",
                                                     "unicycle") else 1
    u, x0 = make_batch(torch.Generator().manual_seed(seed),
                       model.initial_state(dtype), n, horizon, nu,
                       state_scale=0.01, control_scale=0.1)
    return (u, x0) if hover is None else (u + hover(horizon, dtype), x0)


# The child processes of the card-against-CPU phases (N's one runs both of
# its configurations, Q's its goldens and its batch) and of L's goldens.
# P's, Q's, R's and T's start when phase P does: they run beside Q's
# host-bound solves instead of slowing A-O's.
CPU_CHILDREN = ["B", "E", "J", "M", "N", "L", "T", "U", "P", "Q", "R"]
LATE_CHILDREN = ("P", "Q", "R", "T", "U")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="ABCDEFGHIJKLMNOPQRSTU",
                        help="subset of phases A-U to run after phase 0, "
                             "which always runs (default: "
                             "ABCDEFGHIJKLMNOPQRSTU); I needs H")
    parser.add_argument("--cpu-reference", choices=CPU_CHILDREN,
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
    children, references = {}, {}

    def reference(phase):
        """The CPU half of ``phase`` (Nflat and Nddp: of N's child)."""
        child = phase[0]
        if child not in references:
            out, _ = children[child].communicate()
            check(children[child].returncode == 0,
                  f"the CPU reference process of phase {child} failed")
            references[child] = pickle.loads(out)
        ref = references[child]
        return ref[phase] if child in ("N", "Q", "T", "U") else ref

    failures, record, counts = [], {}, {}

    def run(phase, fn, *a):
        if phase[0] not in args.phases:
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
        name, power = phase_device()
        # The CPU halves of phases B, E, J, M, N and L run meanwhile, one
        # child process each (started after the build, which they would
        # slow down); P's, Q's, R's and T's before phase P.
        def start(phases):
            children.update({
                ph: subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cpu-reference", ph], stdout=subprocess.PIPE)
                for ph in phases if ph in args.phases})

        start(ph for ph in CPU_CHILDREN if ph not in LATE_CHILDREN)
        # The bench's pool recipe (bench.py make_batch call), on the CPU;
        # the float64 runs take the float32 pool's exact values.
        pool32 = make_pool(cartpole, POOL, torch.float32)
        pool64 = tuple(a.double() for a in pool32)
        # Phases B, E and J last: their CPU halves run meanwhile.  Each
        # kernel's launch count is read from the path that runs it: the
        # seq kernels from C, the two-launch kernels from F, the mega
        # kernel from H and I (the bench's default path), the merged trial
        # from I's coarse level on the two-launch arm.
        record.update(run("A", phase_kernels,
                          tuple(a[:LANES] for a in pool32), dev) or {})
        counts.update({k: v for k, v in (run(
            "C", phase_bench_size, pool32, pool64, dev) or {}).items()
            if k.startswith("seq")})
        record.update(run("D", phase_fused_kernels, pool32, dev) or {})
        counts.update({k: v for k, v in (run(
            "F", phase_fused_bench_size, pool32, pool64, dev) or {}).items()
            if k in fused_iter.KERNELS})
        record.update(run("G", phase_mega_kernels, pool32, dev) or {})
        counts_h, single_grid = run("H", phase_mega_stream, pool32, pool64,
                                    dev) or ({}, None)
        if "I" in args.phases and single_grid is None:
            failures.append("phase I: needs phase H's solutions")
        else:
            counts_i, counts_i2 = run("I", phase_multigrid, pool32, dev,
                                      single_grid) or ({}, {})
            if counts_h or counts_i:
                counts["mega"] = counts_h.get("mega", 0) + counts_i.get(
                    "mega", 0)
            if counts_i2:
                counts["merged_trial"] = counts_i2["merged_trial"]
        # The parallel-in-time slice.  value_scan's count is read from the
        # public LQT passes (phase K); the affine scan's and the trial's
        # from solve_batch at width (phase M).
        par_record, lqt_counts = run("K", phase_par_kernels, dev) or ({}, {})
        record.update(par_record)
        if lqt_counts:
            counts["value_scan"] = lqt_counts["value_scan"]
        run("L", lambda: phase_single_solve(dev, reference("L")))
        counts.update(run("M", phase_batch_solve, pool32, dev) or {})
        # bench.py's batch mode (the rollout kernel's count, and the merged
        # trial's in its two DDP configurations, added to I's) and the long
        # horizon (the mega kernel at T=1000, row 14's record and count).
        counts_n = run("N", phase_batch_modes, pool32, dev) or {}
        if "rollout" in counts_n:
            counts["rollout"] = counts_n["rollout"]
        if "merged_trial" in counts_n:
            counts["merged_trial"] = (counts.get("merged_trial", 0)
                                      + counts_n["merged_trial"])
        long_record, long_launches = run("O", phase_long_horizon,
                                         dev) or ({}, None)
        record["mega_streamed"] = long_record
        counts["mega_streamed"] = long_launches
        # bench.py's nmpc mode, the single-solve IP-DDP and warm transfer:
        # their mega, rollout-cost and LQT scans' launches are added to the
        # kernels' counts above.
        start(LATE_CHILDREN)
        counts_p = run("P", phase_nmpc, pool32, dev) or {}
        run("Q", lambda: phase_ddp(pool64, dev, reference))
        counts_r = run("R", phase_warm_transfer, pool32, dev,
                       single_grid) or {}
        counts_s = run("S", phase_sharded, dev, power) or {}
        for k in ("mega", "rollout_cost", "value_scan", "affine_scan",
                  "par_newton_trial"):
            if k in counts_p or k in counts_r or k in counts_s:
                counts[k] = (counts.get(k) or 0) + counts_p.get(k, 0) \
                    + counts_r.get(k, 0) + counts_s.get(k, 0)
        # The planar quadrotor through every path: its launches are added
        # to every kernel's count, its (6, 2) times kept beside the
        # cartpole-shaped ones.
        counts_t, record["quadrotor"] = run(
            "T", lambda: phase_quadrotor(dev, lambda: reference("T4"))) \
            or ({}, {})
        for k, v in counts_t.items():
            counts[k] = (counts.get(k) or 0) + v
        # The state constraints (the unicycle's disc, the cart box) through
        # every path: their launches too, their (3, 2) times beside.
        counts_u, record["unicycle"] = run(
            "U", lambda: phase_state_constraints(dev, lambda: {
                "U4": reference("U4")})) or ({}, {})
        for k, v in counts_u.items():
            counts[k] = (counts.get(k) or 0) + v
        quad64 = (tuple(a.double() for a in quad_pool())
                  if "T" in args.phases else None)
        for ph in CARD_VS_CPU:
            run(ph, lambda ph=ph: phase_card_vs_cpu(
                ph, quad64 if ph == "T3" else pool64, dev, reference(ph)))
        run("P64", lambda: phase_nmpc_card_vs_cpu(dev, reference("P64")))
        run("U5", lambda: phase_multigrid_card_vs_cpu(dev, reference("U5")))
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    pallas = "ipoc_tpu/ops/pallas/"
    kernels = {
        "seq_newton_trial": ("seq_newton.cu", "seq_newton_kernel.py:557"),
        "seq_costates": ("costates.h", "seq_newton_kernel.py:622"),
        "fused_bwd": ("fused_bwd.h", "fused_iter_kernel.py:1261"),
        "fused_fwd": ("fused_fwd.h", "fused_iter_kernel.py:1298"),
        "rollout": ("rollout.h", "fused_iter_kernel.py:1577"),
        "rollout_cost": ("rollout_cost.h", "fused_iter_kernel.py:1956"),
        "transition": ("transition.h", "fused_iter_kernel.py:2053"),
        "merged_trial": ("merged_trial.h", "fused_iter_kernel.py:1206"),
        "mega": ("mega.cuh", "mega_kernel.py:1148"),
        "mega_streamed": ("mega.cuh", "mega_kernel.py:1240"),
        "affine_scan": ("affine_scan.h", "scan_kernels.py:252"),
        "value_scan": ("affine_scan.h", "scan_kernels.py:252"),
        "par_newton_trial": ("par_trial.cuh", "newton_kernel.py:229"),
    }
    total_s = time.perf_counter() - t_start
    print(f"# total {total_s:.1f} s", file=sys.stderr)
    if failures:
        print("chip_smoke: FAILED\n" + "\n".join(failures), file=sys.stderr)
        return 1
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"total_s": total_s, "phases": args.phases})
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"ipoc_tpu_torch/csrc/{src}",
         "replaces": pallas + rep, "launches": counts.get(k),
         **{f: record.get(k, {}).get(f) for f in keys},
         # The C entry alone, where a phase timed it (all but the mega
         # kernel's two rows); phase T's times at the quadrotor's (6, 2).
         **{f: record[k][f] for f in ("entry_ms",) if f in record.get(k, {})},
         **({"quadrotor_6_2": quad_kernel_record(record["quadrotor"], k)}
            if record.get("quadrotor") else {}),
         **({"unicycle_3_2": uni_kernel_record(record["unicycle"], k)}
            if record.get("unicycle") else {})}
        for k, (src, rep) in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
