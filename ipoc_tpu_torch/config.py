"""Typed solver configuration (counterpart of ``ipoc_tpu/config.py``).

A verbatim copy of the JAX package's ``SolverConfig`` and its presets: pure
data, so the two packages share every knob and default.  It is copied
rather than imported because importing ``ipoc_tpu.config`` runs
``ipoc_tpu/__init__.py``, which imports jax; :func:`ipoc_tpu_torch.interop.
config_from_jax` carries a JAX config across field by field.

The comments below are the JAX package's; where they quote a measurement,
it was taken on a TPU through the JAX package, not through this port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Knobs for the interior-point solvers.

    Defaults replicate the reference semantics exactly (file:line cites are
    into the reference library's ``noc/`` package).
    """

    # --- barrier schedule (par_interior_point_newton.py:233-248) ---
    bp_init: float = 0.1
    bp_decay: float = 5.0
    bp_min: float = 1e-4

    # --- convergence (par:199-202, seq:157-161, ddp:167-171) ---
    tol: float = 1e-4
    # Stage-adaptive tolerance (0.0 = off, reference parity): the effective
    # per-stage tolerance is ``max(tol, stage_tol_scale * bp)`` — early
    # barrier subproblems are solved loosely and only the final stage (bp ~
    # bp_min) is driven to ``tol``.  Classic inexact-interior-point
    # strategy; the reference grinds every stage to the full 1e-4
    # (par:199-202), which in f32 can hit iteration caps on gradients that
    # cannot reach 1e-4 at large bp.
    stage_tol_scale: float = 0.0

    # --- Levenberg-Marquardt / trust-region (par:134-135, 166-173) ---
    reg_init: float = 1.0
    reg_inc_init: float = 2.0
    reg_min: float = 1e-16
    reg_max: float = 1e16

    # --- iteration caps (par:180, 201; ddp:150, 169) ---
    # The reference seq solver has NO outer cap (seq:157-161) — we always cap
    # to keep solves bounded on hardware; max_newton_iters=1000 reproduces the
    # par solver cap.
    max_newton_iters: int = 1000
    max_inner_iters: int = 500
    max_ddp_iters: int = 500

    # Early convergence on negligible predicted reduction (0.0 = off,
    # reference semantics): when the backward pass is convex and the model
    # predicts |dV| < pred_floor * (1 + |cost|), the stage is at numerical
    # stationarity for the working precision — stop instead of grinding at
    # the gradient tolerance.  Used by the f32 batch preset.
    pred_floor: float = 0.0

    # Stall exit (deviation from the reference, default on): once a trial
    # step at the maximum regularization reg_max has been rejected, no later
    # trial in the stage can succeed (the reference then spins through its
    # remaining 500x1000 iteration budget re-trying the same step, e.g.
    # whenever tol is unattainable in float32).  Set False to replicate the
    # reference's unbounded retrying exactly.
    stall_exit: bool = True

    # Globalization structure for the parallel solver:
    #   "retry"  — reference semantics (par:184-188): an inner while_loop
    #              retries the trial with growing regularization until
    #              accepted.  Best single-solve convergence.
    #   "single" — one trial per Newton iteration with explicit accept/
    #              reject (the reference's own seq-solver structure,
    #              seq:139-146).  Under vmap the retry loop runs in lockstep
    #              across lanes (any lane retrying makes every lane pay a
    #              full LQT solve), so this mode is markedly faster for
    #              batched throughput.
    globalization: str = "retry"

    # Barrier-schedule structure:
    #   "staged" — reference semantics (par:228-254): an outer while_loop
    #              over barrier stages, each stage an inner Newton loop.
    #              Under vmap every lane waits for the batch's slowest lane
    #              AT EVERY STAGE — the lockstep cost is
    #              sum_stages max_lanes(stage iterations).
    #   "flat"   — ONE while_loop carrying a per-lane barrier parameter that
    #              decays in-loop when that lane's stage converges.  Identical
    #              per-lane iterate sequence (same trials, same reg resets,
    #              same stage tolerances), but lanes advance through stages
    #              independently, so the lockstep cost drops to
    #              max_lanes(total iterations).  Requires
    #              globalization="single".
    barrier_mode: str = "staged"

    # Newton-step evaluator for the parallel entry point:
    #   "par" — parallel-in-time LQT scans (O(log T) span; reference
    #           semantics, the latency winner for single solves).
    #   "seq" — sequential-in-time Riccati recursion (O(T) work per solve;
    #           same stationary points).  For BATCHED solves this is the
    #           TPU throughput winner: the scenario batch fills the VPU
    #           lanes (fused kernel, ops/pallas/seq_newton_kernel.py) and
    #           each solve does log2(T)-times less combine work than the
    #           parallel scan.
    #   "fused" — "seq" semantics with the ENTIRE trial evaluation (model
    #           derivatives re-derived in-kernel, costates, Riccati,
    #           deviation rollout, both cost evaluations, feasibility) as
    #           two Pallas launches reading only (x, u)
    #           (ops/pallas/fused_iter_kernel.py) — the fastest batched
    #           path; requires globalization="single" and
    #           terminal_hessian="exact".  Off-TPU/f64 it falls back to an
    #           identical unfused composition.
    #   "ddp" — the IP-DDP trial (full derivative set, Vx-contracted
    #           backward pass, NONLINEAR closed-loop re-rollout; reference
    #           ddp:28-90) as the per-iteration evaluator, which plugs DDP
    #           into the same single-trial/flat/stream throughput machinery
    #           as the Newton step.  Requires globalization="single";
    #           ``interior_point_ddp`` keeps the reference's retry-loop
    #           structure for single solves.
    newton_impl: str = "par"

    # LM reset value at barrier-stage transitions in flat/stream mode
    # (None -> reg_init, reference parity: each newton_oc call restarts at
    # rp0, par:134-135).  Cold-start presets set reg_init large (heavy
    # damping pays off on the first stage) but later stages open
    # warm-started near their optimum, where a large reset just burns
    # ~log(reg_init/useful)/log(3) accepted iterations shrinking it back
    # down — give them a small reset instead.  Flat/stream only (the staged
    # solvers keep reference semantics).
    reg_stage_init: Optional[float] = None

    # Continuation predictor across barrier stages (flat mode / stream only;
    # deviation from the reference, which warm-starts each stage with the
    # previous stage's controls unchanged, par:236-237).  On a stage
    # transition bp -> bp/decay, extrapolate along the central path:
    # ``u_pred = u_k + (u_k - u_{k-1}) / bp_decay`` (first-order predictor in
    # bp — exact in the asymptotic regime where the path is affine in bp),
    # then keep whichever of {u_pred, u_k} has the lower barrier cost at the
    # new bp (an infeasible/overflowing prediction has NaN/Inf cost and is
    # always rejected).  Converged solutions are unchanged (same stage
    # tolerances); only the warm-start point differs.  Applied from the
    # second transition on (the first has no on-path predecessor).
    stage_predictor: bool = False

    # --- semantics switches ---
    # Reference par/ddp scale the regularizer by ||cu|| (par:116-118,
    # ddp:34-35); the seq solver adds it unscaled (seq:51).
    scale_reg_by_grad: bool = True
    # Floor for the ||cu|| scale.  The reference multiplies the regularizer
    # by exactly ||cu|| (par:116-118): elegant scale-invariance, but at
    # points where cu vanishes identically — e.g. a zero warm start with a
    # symmetric barrier, where R u = 0 and the barrier gradient cancels —
    # regularization is multiplied by zero, no retry can shrink an
    # infeasible step, and the stage stalls out returning its input.  A
    # positive floor restores LM behavior there at the cost of a whisper of
    # damping on problems where cu = 0 is benign (e.g. exact-Newton linear
    # solves lose their one-step machine-precision property).  Default 0.0
    # = exact reference parity; the FAST/BATCH presets use 1e-6.
    reg_scale_floor: float = 0.0
    # Reference quirk (par:74): the LQT terminal weight is set to Q[0]
    # instead of hessian(final_cost)(xT).  "exact" fixes it (documented
    # deliberate deviation, SURVEY §7 "Hard parts"); "reference" replicates.
    terminal_hessian: str = "exact"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()

# Benchmark-friendly config: identical math, tighter iteration caps so a
# non-converging lane cannot consume 1000 Newton iterations of wall clock,
# plus the regularization-scale floor for arbitrary (e.g. zero) warm starts.
FAST_CONFIG = SolverConfig(
    max_newton_iters=200, max_inner_iters=60, reg_scale_floor=1e-6
)

# Batched-throughput config: single-trial globalization (no lockstep retry
# loop), the sequential-in-time Newton step (batch-in-lanes fused kernel;
# O(T) work per solve vs O(T log T) for the parallel scan), and the
# predicted-reduction convergence floor (stop at f32 numerical stationarity
# instead of grinding the gradient norm at the noise floor: measured
# solution cost stays within ~2e-7 relative of the f64 optimum, see
# docs/PERFORMANCE.md) on top of FAST_CONFIG.
# reg_init=100: cold-started batches start heavily damped (early steps are
# near-gradient steps that are almost always accepted) and LM shrinks the
# damping within a few accepted iterations; measured to cut the lockstep
# iteration tail by ~25% on both pendulum and cartpole cold starts with
# unchanged solution cost.  Warm-started (MPC) solves should prefer the
# reference reg_init=1.
# newton_impl="fused": the whole trial evaluation as two Pallas launches
# with model derivatives re-derived in-kernel (reads (x, u) instead of the
# ~42-floats-per-stage Newton stage data; measured +16% stream throughput
# over "seq" at B=2048, docs/PERFORMANCE.md).  Off-TPU it falls back to the
# identical unfused composition.
# stage_predictor + reg_stage_init: cold-start stage transitions extrapolate
# the central path and restart the LM damping small (the warm-started stage
# is near its optimum; resetting to reg_init=100 burns ~10 accepted
# iterations shrinking it back).  Measured on the cartpole H=100 cold-start
# stream: mean iterations 147.4 -> 122.9 with converged raw costs unchanged
# (docs/PERFORMANCE.md).
BATCH_CONFIG = FAST_CONFIG.replace(
    globalization="single", newton_impl="fused", pred_floor=1e-7,
    reg_init=100.0, stage_predictor=True, reg_stage_init=0.1,
)
