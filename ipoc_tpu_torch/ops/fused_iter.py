"""The fused Newton and DDP trials and the rollout kernels: stage programs,
plain versions and wrappers (counterpart of
``ipoc_tpu/ops/pallas/fused_iter_kernel.py``).

Hand-written CUDA kernels (``csrc/fused_iter.cuh``, ``csrc/mega.cuh``)
carry the packed stream and the flat lanes' fused and DDP evaluators
(``solvers/ip_newton.py``) on a card:

* ``fused_bwd`` and ``fused_fwd`` -- one Newton trial from the iterate
  ``(x, u)`` and the per-lane ``(bp, reg)``: in-kernel stage derivatives,
  costates, Riccati gains, the current cost, dV, the minimum pivot and
  max|ru|; then the deviation rollout with the trial's cost, its maximum
  constraint value and its sum ||cu||^2;
* ``merged_trial`` -- the same trial in one launch, in Newton mode or in
  DDP mode (the stage data contracted with the value gradient, then the
  nonlinear closed-loop re-rollout): the DDP evaluator;
* ``rollout`` -- the open-loop rollout alone (the flat lanes' open and
  their re-rollout at a stage transition without the predictor);
* ``rollout_cost`` -- rollout, barrier cost and sum ||cu||^2 (lane open and
  refill);
* ``transition`` -- both stage-transition candidates, ``u`` and the
  central-path prediction, with their costs and sums ||cu||^2;
* ``mega`` -- k whole lane iterations per launch (``ops/mega.py``), built
  into the same library.

Their per-stage code is generated from the model: the stage programs below
are written with ``torch.func`` on one element (shapes ``(nx,)``, ``(nu,)``,
``()``), and ``ops/codegen/scalarize.py`` lowers each to a straight-line
function of a generated ``Model`` struct; ``fused_bwd`` runs ``stage_bwd``
split at the costate into its two halves (:func:`backward_halves`),
``fused_fwd`` runs ``stage_fwd`` cut at the deviation and at the trial
point into three parts (:func:`forward_parts`), ``merged_trial`` runs
those halves and parts, in DDP mode ``stage_ddp_fwd`` cut at the trial
point (:func:`ddp_forward_parts`), ``transition`` runs ``transition`` cut
per candidate (:func:`transition_parts`), ``rollout_cost`` runs
``roll_cost`` cut into the same two programs (:func:`rollout_cost_parts`).
One library per model is built from that text (:func:`model_spec`).

Layout (the packed stream's, batch-last): stage arrays ``(T, rows, B)``,
terminal and initial states ``(nx, B)``, per-lane scalars ``(B,)``.  Each
wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a card; anything else raises, and nothing falls back
from the kernel to the plain version.  The plain versions are the unfused
compositions of the port's derivative engine, trial and rollout, on
``(B, ...)`` tensors; on a card they are what the kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import grad, vjp

from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops.codegen.scalarize import same_program, scalarize
from ipoc_tpu_torch.ops.cuda.seq_newton import (
    seq_costates_plain,
    seq_trial_pivot_plain,
)
from ipoc_tpu_torch.ops.derivatives import (
    compute_derivatives,
    compute_first_order,
    compute_hamiltonian_lqr,
    final_gradient,
    final_hessian,
    over_leading,
    stage_barrier,
)
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.ip_ddp import _ddp_bwd
from ipoc_tpu_torch.utils.integrators import closed_loop_rollout, rollout

# ---------------------------------------------------------------------------
# Stage programs (one element; traced and scalarized for the kernels)
# ---------------------------------------------------------------------------


def _jacobian_rows(fn, args, n_out):
    """Rows of the Jacobian of ``fn`` (one vector output of size
    ``n_out``) with respect to each of ``args``: one reverse-mode product
    per row, no ``vmap``, so the trace is the same on every torch version.
    Returns ``(value, rows)`` with ``rows[i]`` a tuple of d fn_i / d arg."""
    value, pullback = vjp(fn, *args)
    basis = torch.eye(n_out, dtype=value.dtype, device=value.device)
    return value, [pullback(basis[i]) for i in range(n_out)]


def _stage_bwd_fn(ocp: OCP, nx: int, nu: int):
    """Backward stage data from one linearization point (JAX
    ``_stage_bwd_fn``): ``(ru, Q, R, M, fx, fu, lam_new, cost)``, matrices
    row-major flattened.  ``(lam_new, ru)`` is the Hamiltonian gradient;
    its Jacobian rows give the Hessian blocks, of which Q and R keep the
    upper triangle and mirror it, so the lower-triangle nodes are dead code
    in the generated program."""

    def stage(x, u, bp, lam_next):
        def ham(xx, uu):
            return (ocp.stage_cost(xx, uu, bp)
                    + (lam_next * ocp.dynamics(xx, uu)).sum(-1))

        def gradient(xx, uu):
            return torch.cat(grad(ham, argnums=(0, 1))(xx, uu))

        g, hrows = _jacobian_rows(gradient, (x, u), nx + nu)
        _, frows = _jacobian_rows(ocp.dynamics, (x, u), nx)
        Q = torch.stack([hrows[min(i, j)][0][max(i, j)]
                         for i in range(nx) for j in range(nx)])
        R = torch.stack([hrows[nx + min(i, j)][1][max(i, j)]
                         for i in range(nu) for j in range(nu)])
        M = torch.stack([hrows[i][1][j] for i in range(nx)
                         for j in range(nu)])
        fx = torch.cat([r[0] for r in frows])
        fu = torch.cat([r[1] for r in frows])
        return (g[nx:], Q, R, M, fx, fu, g[:nx], ocp.stage_cost(x, u, bp))

    return stage


def _term_fn(ocp: OCP, nx: int):
    """Terminal costate, Hessian and cost (JAX ``_term_fn``)."""

    def term(xT):
        lamT, rows = _jacobian_rows(grad(ocp.final_cost), (xT,), nx)
        return lamT, torch.cat([r[0] for r in rows]), ocp.final_cost(xT)

    return term


def _stage_fwd_fn(ocp: OCP, nx: int, nu: int):
    """Forward stage (JAX ``_stage_fwd_fn(with_cu=True)``): gains -> trial
    point -> ``(tu, tx, dx_next, cost, max constraint, sum cu^2)``.  The
    deviation step is the Jacobian-vector product ``fx dx + fu du`` (the
    Jacobian's rows contracted with the deviation); ``sum cu^2`` at the
    trial point is the next iterate's Levenberg scale if the trial is
    accepted."""

    def stage(x, u, bp, dx, Kk):
        k = Kk[:nu]
        K = Kk[nu:].reshape(nu, nx)
        du = k + (K * dx).sum(-1)
        tu = u + du
        tx = x + dx
        _, rows = _jacobian_rows(ocp.dynamics, (x, u), nx)
        dxn = torch.stack([(rx * dx).sum(-1) + (ru * du).sum(-1)
                           for rx, ru in rows])
        cu = grad(ocp.stage_cost, argnums=1)(tx, tu, bp)
        return (tu, tx, dxn, ocp.stage_cost(tx, tu, bp),
                ocp.constraints(tx, tu).amax(-1), (cu * cu).sum(-1))

    return stage


def _term_fwd_fn(ocp: OCP):
    def term(xT, dxT):
        txT = xT + dxT
        return txT, ocp.final_cost(txT)

    return term


def _stage_ddp_fwd_fn(ocp: OCP, nx: int, nu: int):
    """DDP forward stage (JAX ``_stage_ddp_fwd_fn(with_cu=True)``): the
    nonlinear closed-loop re-rollout, whose carry is the trial state itself
    (not a deviation): ``du = k + K (tx - x)``, ``tx+ = f(tx, u + du)``;
    returns ``(tu, tx, tx+, cost, max constraint, sum cu^2)`` at the trial
    point."""

    def stage(x, u, bp, tx, Kk):
        k = Kk[:nu]
        K = Kk[nu:].reshape(nu, nx)
        tu = u + (k + (K * (tx - x)).sum(-1))
        cu = grad(ocp.stage_cost, argnums=1)(tx, tu, bp)
        return (tu, tx, ocp.dynamics(tx, tu), ocp.stage_cost(tx, tu, bp),
                ocp.constraints(tx, tu).amax(-1), (cu * cu).sum(-1))

    return stage


def _term_ddp_fwd_fn(ocp: OCP):
    def term(xT, txT):
        return txT, ocp.final_cost(txT)

    return term


def _stage_roll_cost_cu_fn(ocp: OCP):
    """Rollout step with the stage cost and sum cu^2 (JAX
    ``_stage_roll_cost_cu_fn``)."""

    def stage(x, u, bp):
        cu = grad(ocp.stage_cost, argnums=1)(x, u, bp)
        return (ocp.dynamics(x, u), ocp.stage_cost(x, u, bp),
                (cu * cu).sum(-1))

    return stage


def _stage_transition_fn(ocp: OCP):
    """Both transition candidates' steps, costs and sums cu^2 (JAX
    ``_stage_transition_fn(with_cu=True)``)."""

    def stage(xa, xb, u, up, bp):
        cua = grad(ocp.stage_cost, argnums=1)(xa, u, bp)
        cub = grad(ocp.stage_cost, argnums=1)(xb, up, bp)
        return (ocp.dynamics(xa, u), ocp.dynamics(xb, up),
                ocp.stage_cost(xa, u, bp), ocp.stage_cost(xb, up, bp),
                (cua * cua).sum(-1), (cub * cub).sum(-1))

    return stage


def stage_programs(ocp: OCP, nx: int, nu: int) -> dict:
    """The model's stage programs as ``name -> (fn, input shapes)``; the
    names are the generated C functions'."""
    ng = (1 + nx) * nu
    return {
        "stage_bwd": (_stage_bwd_fn(ocp, nx, nu), [(nx,), (nu,), (), (nx,)]),
        "term": (_term_fn(ocp, nx), [(nx,)]),
        "stage_fwd": (_stage_fwd_fn(ocp, nx, nu),
                      [(nx,), (nu,), (), (nx,), (ng,)]),
        "term_fwd": (_term_fwd_fn(ocp), [(nx,), (nx,)]),
        "stage_ddp_fwd": (_stage_ddp_fwd_fn(ocp, nx, nu),
                          [(nx,), (nu,), (), (nx,), (ng,)]),
        "term_ddp_fwd": (_term_ddp_fwd_fn(ocp), [(nx,), (nx,)]),
        "roll_cost": (_stage_roll_cost_cu_fn(ocp), [(nx,), (nu,), ()]),
        "transition": (_stage_transition_fn(ocp),
                       [(nx,), (nx,), (nu,), (nu,), ()]),
        "final_cost": (ocp.final_cost, [(nx,)]),
        "dynamics": (ocp.dynamics, [(nx,), (nu,)]),
    }


_PROGRAMS: dict = {}


def scalar_programs(ocp: OCP, nx: int, nu: int, traced=None) -> dict:
    """The scalarized stage programs (traced once per model and shape).
    ``traced``, this function's result for the same model and time step
    from another process (the programs pickle), is taken as ``ocp``'s
    instead of tracing here."""
    key = (ocp, nx, nu)
    if traced is not None:
        _PROGRAMS[key] = traced
    if key not in _PROGRAMS:
        _PROGRAMS[key] = {name: scalarize(fn, shapes, name)
                          for name, (fn, shapes)
                          in stage_programs(ocp, nx, nu).items()}
    return _PROGRAMS[key]


_HALVES: dict = {}


def backward_halves(ocp: OCP, nx: int, nu: int) -> tuple:
    """The fused backward kernel's two halves of ``stage_bwd``
    (``csrc/fused_bwd.h``; ``ScalarProgram.split`` at the costate, argument
    3): ``stage_bwd_pre``, the elementary-function calls that do not read
    the costate, and ``stage_bwd_post``, the rest of the stage from pre's
    handoff values and the costate."""
    key = (ocp, nx, nu)
    if key not in _HALVES:
        _HALVES[key] = scalar_programs(ocp, nx, nu)["stage_bwd"].split(
            3, ("stage_bwd_pre", "stage_bwd_post"))
    return _HALVES[key]


def forward_parts(ocp: OCP, nx: int, nu: int) -> tuple:
    """The fused forward kernel's three parts of ``stage_fwd``
    (``csrc/fused_fwd.h``): ``stage_fwd_pre``, the elementary-function
    calls that do not read the deviation (``ScalarProgram.split`` at
    argument 3, as :func:`backward_halves`); ``stage_fwd_step``, the trial
    point and the next deviation from pre's handoff values and the
    deviation, all of their arithmetic; and ``stage_fwd_eval``, the trial
    point's cost, maximum constraint value and ``||cu||^2`` from the trial
    state, control and ``bp`` (the program cut at its outputs ``tu`` and
    ``tx``), each summand as the pair of operands whose product it is."""
    key = (ocp, nx, nu, "fwd")
    if key not in _HALVES:
        prog = scalar_programs(ocp, nx, nu)["stage_fwd"]
        pre, step = prog.split(3, ("stage_fwd_pre", "stage_fwd_step"),
                               outputs=(0, 1, 2))
        ev = prog.cut([("out", 1), ("out", 0), ("in", 2)], (3, 4, 5),
                      "stage_fwd_eval", factor=(3, 5))
        _HALVES[key] = pre, step, ev
    return _HALVES[key]


def ddp_forward_parts(ocp: OCP, nx: int, nu: int) -> tuple:
    """The merged trial's DDP forward sweep's two parts of
    ``stage_ddp_fwd`` (``csrc/merged_trial.h``): ``stage_ddp_fwd_step(x,
    u, tx, gains) -> (tu, tx, tx+)``, the closed-loop step that runs on the
    chain (the program cut at its inputs but ``bp``); and its evaluation,
    the trial point's cost, maximum constraint value and ``||cu||^2`` from
    ``(tx, tu, bp)``, each summand as the pair of operands whose product it
    is.  Raises ``ValueError`` unless the evaluation is
    :func:`forward_parts`' ``stage_fwd_eval`` program, which the kernel
    runs for it."""
    key = (ocp, nx, nu, "ddp_fwd")
    if key not in _HALVES:
        prog = scalar_programs(ocp, nx, nu)["stage_ddp_fwd"]
        step = prog.cut([("in", 0), ("in", 1), ("in", 3), ("in", 4)],
                        (0, 1, 2), "stage_ddp_fwd_step")
        ev = prog.cut([("out", 1), ("out", 0), ("in", 2)], (3, 4, 5),
                      "stage_fwd_eval", factor=(3, 5))
        if not same_program(ev, forward_parts(ocp, nx, nu)[2]):
            raise ValueError("stage_ddp_fwd: its evaluation is not "
                             "stage_fwd_eval's program")
        _HALVES[key] = step, ev
    return _HALVES[key]


def transition_parts(ocp: OCP, nx: int, nu: int) -> tuple:
    """The transition kernel's per-candidate parts of ``transition``
    (``csrc/transition.h``), cut at candidate a's inputs:
    ``transition_step(x, u) -> x_next`` and ``transition_eval(x, u, bp)
    -> (cost, ||cu||^2)``, each summand as the pair of operands whose
    product it is.  Raises ``ValueError`` unless candidate b's parts are
    the same programs, so that both candidates run the same code."""
    key = (ocp, nx, nu, "transition")
    if key not in _HALVES:
        prog = scalar_programs(ocp, nx, nu)["transition"]
        parts = []
        for x, u, out, cost, cu in ((0, 2, 0, 2, 4), (1, 3, 1, 3, 5)):
            parts.append((
                prog.cut([("in", x), ("in", u)], (out,), "transition_step"),
                prog.cut([("in", x), ("in", u), ("in", 4)], (cost, cu),
                         "transition_eval", factor=(cost, cu))))
        for a, b in zip(*parts):
            if not same_program(a, b):
                raise ValueError(f"transition: candidate b's {b.name} is "
                                 "not candidate a's program")
        _HALVES[key] = parts[0]
    return _HALVES[key]


def rollout_cost_parts(ocp: OCP, nx: int, nu: int) -> tuple:
    """The rollout-cost kernel's parts of ``roll_cost``
    (``csrc/rollout_cost.h``), cut at its inputs: the dynamics ``(x, u) ->
    x_next`` and the evaluation ``(x, u, bp) -> (cost, ||cu||^2)``, each
    summand as the pair of operands whose product it is.  Raises
    ``ValueError`` unless they are :func:`transition_parts`' programs,
    ``transition_step`` and ``transition_eval``, which the kernel runs for
    them."""
    key = (ocp, nx, nu, "roll_cost")
    if key not in _HALVES:
        prog = scalar_programs(ocp, nx, nu)["roll_cost"]
        parts = (prog.cut([("in", 0), ("in", 1)], (0,), "transition_step"),
                 prog.cut([("in", 0), ("in", 1), ("in", 2)], (1, 2),
                          "transition_eval", factor=(1, 2)))
        for a, b in zip(parts, transition_parts(ocp, nx, nu)):
            if not same_program(a, b):
                raise ValueError(f"roll_cost: its cut {a.name} is not the "
                                 "transition kernel's program")
        _HALVES[key] = parts
    return _HALVES[key]


def model_struct(ocp: OCP, nx: int, nu: int) -> str:
    """The generated ``struct Model``: the shapes, the handoff counts of
    ``stage_bwd_pre`` (NH) and ``stage_fwd_pre`` (NHF), every scalarized
    stage program and the parts of those that the kernels split (the DDP
    forward sweep's evaluation is ``stage_fwd_eval``, so only its step is
    emitted; the rollout-cost kernel's parts are the transition's, so
    :func:`rollout_cost_parts` only checks them)."""
    rollout_cost_parts(ocp, nx, nu)
    pre, post = backward_halves(ocp, nx, nu)
    fwd = forward_parts(ocp, nx, nu)
    progs = [*scalar_programs(ocp, nx, nu).values(), pre, post, *fwd,
             ddp_forward_parts(ocp, nx, nu)[0],
             *transition_parts(ocp, nx, nu)]
    body = "\n\n".join(p.c_source(indent="  ") for p in progs)
    return ("struct Model {\n"
            f"  static constexpr int NX = {nx};\n"
            f"  static constexpr int NU = {nu};\n"
            f"  static constexpr int NH = {pre.out_shapes[0][0]};\n"
            f"  static constexpr int NHF = {fwd[0].out_shapes[0][0]};\n\n"
            f"{body}\n"
            "};\n")


def model_source(ocp: OCP, nx: int, nu: int) -> str:
    """The generated ``.cu`` of one model's fused-kernel library."""
    return (
        "// Generated by ipoc_tpu_torch/ops/codegen/scalarize.py from the\n"
        "// model's stage programs (ipoc_tpu_torch/ops/fused_iter.py).\n"
        '#include "fused_iter.cuh"\n'
        '#include "mega.cuh"\n\n'
        f"{model_struct(ocp, nx, nu)}\n"
        "IPOC_FUSED_ENTRY_POINTS(Model)\n")


def model_spec(ocp: OCP, nx: int, nu: int) -> cuda.LibSpec:
    """The fused-kernel library of one model: ``fused_iter.cuh`` with the
    generated stage code, both dtypes, one ``nvcc`` call."""
    tag = f"fused_nx{nx}_nu{nu}"
    return cuda.LibSpec(tag, (), ((f"{tag}.cu",
                                   model_source(ocp, nx, nu)),))


_LIBS: dict = {}
# The five kernels with the uniform entry point (dtype, ins, outs, B, T,
# stream); the merged trial and the mega kernel (``ops/mega.py``) take a
# mode and more.
KERNELS = ("fused_bwd", "fused_fwd", "rollout", "rollout_cost", "transition")
# The kernels launched in one-warp blocks of several scenarios
# (csrc/fused_bwd.h, fused_fwd.h, transition.h, rollout.h, rollout_cost.h),
# each with an occupancy entry.
GROUP_KERNELS = ("fused_bwd", "fused_fwd", "transition", "rollout",
                 "rollout_cost")


def library(ocp: OCP, nx: int, nu: int) -> ctypes.CDLL:
    """One model's loaded fused-kernel library, generated and built at
    first use (then cached per model and shape)."""
    key = (ocp, nx, nu)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(cuda.build(model_spec(ocp, nx, nu))))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in KERNELS + ("rollout_reference", "rollout_cost_reference"):
            fn = getattr(lib, f"ipoc_{name}")
            fn.argtypes = [i, p, p, i, i, p]
            fn.restype = i
        lib.ipoc_merged_trial.argtypes = [i, i, p, p, i, i, p]
        lib.ipoc_merged_trial.restype = i
        lib.ipoc_merged_trial_occupancy.argtypes = [i, i, p]
        lib.ipoc_merged_trial_occupancy.restype = i
        lib.ipoc_mega.argtypes = [i, i, p, p, p, i, i, i, p]
        lib.ipoc_mega.restype = i
        lib.ipoc_ring_layout.argtypes = [i, p]
        lib.ipoc_ring_layout.restype = i
        for name in GROUP_KERNELS:
            fn = getattr(lib, f"ipoc_{name}_occupancy")
            fn.argtypes = [i, p]
            fn.restype = i
        _LIBS[key] = lib
    return _LIBS[key]


def group_occupancy(ocp: OCP, nx: int, nu: int, dtype: torch.dtype,
                    kernel: str) -> dict:
    """The card's view of one of the model's group-schedule kernels
    (``GROUP_KERNELS``): resident blocks per SM, threads, shared bytes and
    scenarios per block, registers and local (spill) bytes per thread."""
    out = (ctypes.c_int * 6)()
    cuda.check(getattr(library(ocp, nx, nu), f"ipoc_{kernel}_occupancy")(
        cuda.dtype_code(dtype), out), f"{kernel}_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


def merged_occupancy(ocp: OCP, nx: int, nu: int, dtype: torch.dtype,
                     ddp: bool) -> dict:
    """The card's view of the model's merged trial kernel in one mode (as
    :func:`group_occupancy`)."""
    out = (ctypes.c_int * 6)()
    cuda.check(library(ocp, nx, nu).ipoc_merged_trial_occupancy(
        cuda.dtype_code(dtype), int(ddp), out), "merged_trial_occupancy")
    return dict(zip(cuda.OCCUPANCY_KEYS, out))


def pointers(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(ocp, name, ins, in_shapes, out_shapes, nx, nu, mode=None,
            counted=True):
    """Check the inputs, allocate the outputs and launch kernel ``name``
    (counted in ``cuda.launches`` unless ``counted`` is false);
    ``ins[0]`` is a stage array ``(T, rows, B)``.  ``mode`` (0 Newton, 1
    DDP) goes to an entry point that takes one.  This host work paces
    back-to-back launches of the shorter kernels (some 70 us a call on an
    H100's host, 30 of them the output tensors), so it takes no device
    guard where the tensors' card is current already."""
    code = cuda.check_inputs(name, ins, in_shapes)
    dev = ins[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes tensors on a card")
    outs = [ins[0].new_empty(s) for s in out_shapes]
    T, B = ins[0].shape[0], ins[0].shape[-1]
    if B == 0:
        return tuple(outs)
    lib = library(ocp, nx, nu)
    lead = (code,) if mode is None else (code, mode)
    with cuda.device_guard(dev):
        status = getattr(lib, f"ipoc_{name}")(
            *lead, pointers(ins), pointers(outs), B, T,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda.check(status, name)
    if counted:
        cuda.launches[name] += 1
    return tuple(outs)


def fused_bwd_launch(ocp: OCP, xs, xT, u, bp, reg):
    """The backward launch of the fused trial, on a card's tensors: ``(Kk
    (T, (1+nx)*nu, B) gains [k | K], cost, dv, piv, hu)``."""
    T, nx, B = xs.shape
    nu = u.shape[1]
    return _launch(ocp, "fused_bwd", (xs, u, xT, bp, reg),
                   [(T, nx, B), (T, nu, B), (nx, B), (B,), (B,)],
                   [(T, (1 + nx) * nu, B), (B,), (B,), (B,), (B,)], nx, nu)


def fused_fwd_launch(ocp: OCP, xs, xT, u, bp, Kk):
    """The forward launch of the fused trial, on a card's tensors: ``(tu,
    tx, txT, new_cost_raw, max_c, cun)``."""
    T, nx, B = xs.shape
    nu = u.shape[1]
    return _launch(ocp, "fused_fwd", (xs, u, xT, bp, Kk),
                   [(T, nx, B), (T, nu, B), (nx, B), (B,),
                    (T, (1 + nx) * nu, B)],
                   [(T, nu, B), (T, nx, B), (nx, B), (B,), (B,), (B,)],
                   nx, nu)


def merged_trial_launch(ocp: OCP, xs, xT, u, bp, reg, ddp: bool = False):
    """The merged one-launch trial on a card's tensors, Newton or DDP mode:
    the backward sweep, then the forward sweep on the same warp, the gains
    through shared memory and a scratch ``(T, (1+nx)*nu, B)`` output.  Returns
    :func:`fused_newton_iter_packed`'s ten outputs."""
    T, nx, B = xs.shape
    nu = u.shape[1]
    outs = _launch(ocp, "merged_trial", (xs, u, xT, bp, reg),
                   [(T, nx, B), (T, nu, B), (nx, B), (B,), (B,)],
                   [(T, nu, B), (T, nx, B), (nx, B)] + [(B,)] * 7
                   + [(T, (1 + nx) * nu, B)], nx, nu, mode=int(ddp))
    return outs[:10]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def stage_cu(ocp: OCP, x, u, bp):
    """The barrier stage cost's control gradient ``cu (B, T, nu)`` along
    each trajectory: ``x (B, T+1, nx)``, ``u (B, T, nu)``, ``bp`` ``(B,)``
    or 0-dim."""
    lead = u.shape[:-1]
    return over_leading(grad(ocp.stage_cost, argnums=1), lead,
                        x[..., :-1, :], u, stage_barrier(bp, lead, u))


def _cu_sq(ocp: OCP, x, u, bp):
    """``sum ||cu||^2`` over each trajectory's stages -> ``(B,)``."""
    cu = stage_cu(ocp, x, u, bp)
    return (cu * cu).sum((-2, -1))


def _fused_reference(ocp: OCP, x, u, bp, reg):
    """The unfused composition of one fused Newton iteration on ``(B, ...)``
    tensors (JAX ``_fused_reference``, batched): first-order derivatives ->
    sequential costates -> Hamiltonian LQR -> regularized sequential trial
    -> trial evaluation.

    ``x (B, T+1, nx)``, ``u (B, T, nu)``, ``bp``/``reg (B,)``.  Returns
    ``(temp_x, temp_u, cost, new_cost_raw, max_c, pred, ok, hu, piv,
    cun)``: the JAX function's eight outputs, then the minimum pivot and
    ``sum ||cu||^2`` at the trial point."""
    d = compute_first_order(ocp, x, u, bp)
    lam = seq_costates_plain(d.cx, d.fx, final_gradient(ocp, x[:, -1]))
    lin = compute_hamiltonian_lqr(ocp, x, u, lam, bp)
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    R = lin.R + reg[:, None, None, None] * eye
    du, dx, pred, piv = seq_trial_pivot_plain(
        lin.r, lin.Q, R, lin.M, d.fx, d.fu, final_hessian(ocp, x[:, -1]))
    ok = torch.isfinite(piv) & (piv > 0) & torch.isfinite(pred)
    temp_x = x + dx
    temp_u = u + du
    cost = ocp.total_cost(x, u, bp)
    new_cost = ocp.total_cost(temp_x, temp_u, bp)
    max_c = ocp.constraints(temp_x[:, :-1], temp_u).flatten(1).amax(1)
    hu = lin.r.abs().flatten(1).amax(1)
    cun = _cu_sq(ocp, temp_x, temp_u, bp)
    return temp_x, temp_u, cost, new_cost, max_c, pred, ok, hu, piv, cun


def _fused_ddp_reference(ocp: OCP, x, u, bp, reg):
    """The unfused composition of one DDP trial on ``(B, ...)`` tensors
    (JAX ``_fused_ddp_reference``, batched): tensor-form derivatives ->
    the Vx-contracted backward pass with ``reg`` already scaled ->
    nonlinear closed-loop re-rollout -> trial evaluation.  Returns
    :func:`_fused_reference`'s outputs; ``piv`` is the minimum pivot of an
    unpivoted elimination of the stages' regularized ``Quu``, ``ok`` the
    Cholesky test, as in JAX."""
    cost = ocp.total_cost(x, u, bp)
    d = compute_derivatives(ocp, x, u, bp)
    ffgain, gain, pred, ok, Qu, piv = _ddp_bwd(ocp.final_cost, x[:, -1], d,
                                               reg)
    temp_x, temp_u = closed_loop_rollout(ocp.dynamics, gain, ffgain, x, u)
    new_cost = ocp.total_cost(temp_x, temp_u, bp)
    max_c = ocp.constraints(temp_x[:, :-1], temp_u).flatten(1).amax(1)
    hu = Qu.abs().flatten(1).amax(1)
    cun = _cu_sq(ocp, temp_x, temp_u, bp)
    return temp_x, temp_u, cost, new_cost, max_c, pred, ok, hu, piv, cun


def lanes_first(xs, xT):
    """Batch-last stages ``(T, nx, B)`` and terminal ``(nx, B)`` ->
    ``(B, T+1, nx)``."""
    return torch.cat([xs, xT[None]], 0).permute(2, 0, 1)


def lanes_last(x):
    """``(B, T+1, nx)`` -> batch-last stages and terminal state."""
    return (x[:, :-1].permute(1, 2, 0).contiguous(),
            x[:, -1].T.contiguous())


def fused_newton_iter_plain(ocp: OCP, xs, xT, u, bp, reg, ddp: bool = False):
    """Plain version of the fused trial, Newton or DDP (same contract as
    :func:`fused_newton_iter_packed`)."""
    ref = _fused_ddp_reference if ddp else _fused_reference
    temp_x, temp_u, cost, nc, mc, pred, _, hu, piv, cun = ref(
        ocp, lanes_first(xs, xT), u.permute(2, 0, 1), bp, reg)
    tx, txT = lanes_last(temp_x)
    return (temp_u.permute(1, 2, 0).contiguous(), tx, txT, cost, nc, mc,
            pred, piv, hu, cun)


def rollout_plain(ocp: OCP, u, x0):
    """Plain version of the rollout kernel (same contract as
    :func:`rollout_packed`)."""
    return lanes_last(rollout(ocp.dynamics, u.permute(2, 0, 1), x0.T))


def rollout_cost_plain(ocp: OCP, u, x0, bp):
    """Plain version of the rollout-cost kernel (same contract as
    :func:`rollout_cost_packed`)."""
    ub = u.permute(2, 0, 1)
    x = rollout(ocp.dynamics, ub, x0.T)
    xs, xT = lanes_last(x)
    return xs, xT, ocp.total_cost(x, ub, bp), _cu_sq(ocp, x, ub, bp)


def transition_plain(ocp: OCP, u, up, x0, bp):
    """Plain version of the transition kernel (same contract as
    :func:`transition_packed`): the two candidates' rollouts and costs."""
    xa, xaT, ca, cua = rollout_cost_plain(ocp, u, x0, bp)
    xb, xbT, cb, cub = rollout_cost_plain(ocp, up, x0, bp)
    return xa, xb, xaT, xbT, ca, cb, cua, cub


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def fused_newton_iter_packed(ocp: OCP, xs, xT, u, bp, reg, ddp: bool = False):
    """One fused trial per lane (JAX ``fused_newton_iter_packed(...,
    with_cu=True, ddp=...)``): the Newton trial in two launches, or with
    ``ddp`` the DDP trial in the merged kernel's one launch.

    Shapes: ``xs (T, nx, B)`` stages 0..T-1, ``xT (nx, B)``,
    ``u (T, nu, B)``, ``bp (B,)``, ``reg (B,)`` (the Levenberg parameter,
    already scaled by ``max(||cu||_F, floor)``).  Returns ``(tu (T, nu, B),
    tx (T, nx, B), txT (nx, B), cost, new_cost_raw, max_c, pred, piv, hu,
    cun)``, the last seven ``(B,)``; ``cun`` is ``sum ||cu||^2`` at the
    trial point and the trial is feasible iff ``max_c <= 0``.
    """
    if cuda.on_cpu("fused_newton_iter", xs, u, xT, bp, reg):
        return fused_newton_iter_plain(ocp, xs, xT, u, bp, reg, ddp)
    if ddp:
        return merged_trial_launch(ocp, xs, xT, u, bp, reg, ddp=True)
    Kk, cost, dv, piv, hu = fused_bwd_launch(ocp, xs, xT, u, bp, reg)
    tu, tx, txT, nc, mc, cun = fused_fwd_launch(ocp, xs, xT, u, bp, Kk)
    return tu, tx, txT, cost, nc, mc, dv, piv, hu, cun


def rollout_packed(ocp: OCP, u, x0):
    """The open-loop rollout, one launch (JAX ``rollout_batched``).

    Shapes: ``u (T, nu, B)``, ``x0 (nx, B)`` -> ``(xs (T, nx, B) stages
    0..T-1, xT (nx, B))``; JAX's ``(B, T+1, nx)`` is
    ``lanes_first(xs, xT)``.
    """
    if cuda.on_cpu("rollout", u, x0):
        return rollout_plain(ocp, u, x0)
    T, nu, B = u.shape
    nx = x0.shape[0]
    return _launch(ocp, "rollout", (u, x0), [(T, nu, B), (nx, B)],
                   [(T, nx, B), (nx, B)], nx, nu)


def rollout_reference(ocp: OCP, u, x0):
    """The one-thread loop that the rollout kernel replaced, on a card
    (``csrc/fused_iter.cuh`` rollout_reference_kernel): the oracle that
    holds :func:`rollout_packed` to the bit.  No path launches it, and its
    launches are not counted."""
    T, nu, B = u.shape
    nx = x0.shape[0]
    return _launch(ocp, "rollout_reference", (u, x0), [(T, nu, B), (nx, B)],
                   [(T, nx, B), (nx, B)], nx, nu, counted=False)


def rollout_cost_packed(ocp: OCP, u, x0, bp):
    """Rollout + barrier cost + ``sum ||cu||^2``, one launch (JAX
    ``rollout_cost_packed``).

    Shapes: ``u (T, nu, B)``, ``x0 (nx, B)``, ``bp (B,)`` -> ``(xs
    (T, nx, B) stages 0..T-1, xT (nx, B), cost (B,), cun (B,))``.
    """
    if cuda.on_cpu("rollout_cost", u, x0, bp):
        return rollout_cost_plain(ocp, u, x0, bp)
    T, nu, B = u.shape
    nx = x0.shape[0]
    return _launch(ocp, "rollout_cost", (u, x0, bp),
                   [(T, nu, B), (nx, B), (B,)],
                   [(T, nx, B), (nx, B), (B,), (B,)], nx, nu)


def rollout_cost_reference(ocp: OCP, u, x0, bp):
    """The one-thread loop that the rollout-cost kernel replaced, on a card
    (``csrc/fused_iter.cuh`` rollout_cost_reference_kernel): the oracle
    that holds :func:`rollout_cost_packed` to the bit.  No path launches
    it, and its launches are not counted."""
    T, nu, B = u.shape
    nx = x0.shape[0]
    return _launch(ocp, "rollout_cost_reference", (u, x0, bp),
                   [(T, nu, B), (nx, B), (B,)],
                   [(T, nx, B), (nx, B), (B,), (B,)], nx, nu, counted=False)


def transition_packed(ocp: OCP, u, up, x0, bp):
    """Both stage-transition candidates, one launch (JAX
    ``transition_packed``).

    Shapes: ``u``/``up (T, nu, B)``, ``x0 (nx, B)``, ``bp (B,)`` (the new
    barrier parameter) -> ``(xa, xb (T, nx, B), xaT, xbT (nx, B), ca, cb,
    cua, cub (B,))`` with ``cu* = sum ||cu||^2`` along each candidate.
    """
    if cuda.on_cpu("transition", u, up, x0, bp):
        return transition_plain(ocp, u, up, x0, bp)
    T, nu, B = u.shape
    nx = x0.shape[0]
    return _launch(ocp, "transition", (u, up, x0, bp),
                   [(T, nu, B), (T, nu, B), (nx, B), (B,)],
                   [(T, nx, B), (T, nx, B), (nx, B), (nx, B), (B,), (B,),
                    (B,), (B,)], nx, nu)
