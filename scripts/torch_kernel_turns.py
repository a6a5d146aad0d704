#!/usr/bin/env python3
"""Time the port's lane-open rollout-cost kernel and its scans against
their parents and variants, in turns, on one CUDA card.

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit:

    python3 scripts/torch_kernel_turns.py [--parent DIR] [--parts rc,scan,barrier,ring]

Each part prints JSON lines (and appends them to
``build/kernel_turns.jsonl``):

* ``rc``: the rollout-cost kernel's group schedule (``csrc/rollout_cost.h``)
  at several group shapes (G lanes per scenario, W stages per chunk),
  built into one library with the cartpole model at dt 0.01, each held bit
  for bit to the one-thread loop it replaced
  (``rollout_cost_reference_kernel``) and timed against it in turns
  (loop, variant, variant, loop) through the C entries at B=4096 and at the
  streams' median lane opening, T=100, float32 and float64;
* ``scan``: the value scan and the affine scan (suffix) against the
  parent's kernels, built from ``DIR/ipoc_tpu_torch/csrc/par_newton.cu``
  (a ``git archive`` of the parent commit), in turns (parent, kernel,
  kernel, parent) at B=1024, T=100 and B=1, T=1000 (the affine scan at
  T+1), both dtypes; the value scan at every lane count P, each against
  ``value_scan_plain``;
* ``barrier``: the value scan rebuilt with ``__syncwarp`` as its scenario
  barrier at P = 32 (where ``affine_scan.h`` ScanExec uses a named barrier
  over the warp), in float64 at n = 4 against ``value_scan_plain``;
* ``ring`` (not in the default parts): the group schedules of the seq
  trial, the costate recursion, the fused sweeps, the merged trial, the
  transition and the rollout cost (``csrc/riccati_rows.h`` ``WarpExec``,
  whose steps end with ``__syncwarp()``, after ``RingCopy::wait`` where a
  step awaits its ``cp.async`` copies) rebuilt with ``bar.sync 1, 32`` in a
  copy of the checkout under ``build/ring_barrier/``; both builds run every
  kernel through its wrapper on phases A, D and G's inputs (cartpole T=100
  at B=4096, random nx=3, nu=2 stage data, pendulum, the merged trial and
  the mega kernel's k=4 and k=32 launches at Newton T=100 and DDP T=25, bp
  0.1 and 0.004), both dtypes, one child process each, and the outputs are
  compared bit for bit; it exits 1 if any differs.

CUDA events around 50 back-to-back launches after a warm one, at the SM
clock that ``nvidia-smi`` reports (``chip_smoke.py`` SmClock); no number
is taken from a run without a card.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from ipoc_tpu_torch.models import cartpole  # noqa: E402
from ipoc_tpu_torch.ops import cuda  # noqa: E402
from ipoc_tpu_torch.ops import fused_iter as tf  # noqa: E402
from ipoc_tpu_torch.ops import scan_kernels as sk  # noqa: E402

BUILD = ROOT / "build" / "kernel_turns"
LOG = ROOT / "build" / "kernel_turns.jsonl"

# (G, W): the kernel's (4, 4) and the shapes timed against it.
RC_SHAPES = ((4, 4), (8, 8), (4, 8), (2, 8), (8, 16), (2, 2), (2, 4), (1, 8),
             (1, 1))

RC_SOURCE = r"""
namespace ipoc {
template <typename scalar_t, int G, int W>
__global__ void __launch_bounds__(kRowWarp)
rc_shape(const scalar_t* us, const scalar_t* x0, const scalar_t* bp, scalar_t* xs,
         scalar_t* xT, scalar_t* cost, scalar_t* cun, int B, int T) {
  using Rc = RollCost<Model, scalar_t, G, W>;
  typename Rc::Lane lane;
  lane.s = static_cast<int>(threadIdx.x) / G;
  lane.r = static_cast<int>(threadIdx.x) % G;
  WarpExec<typename Rc::Lane> ex{lane};
  Rc::schedule(ex, Rc::block(us, xs, B, T, static_cast<int>(blockIdx.x)), x0, bp, xT,
               cost, cun);
}
}  // namespace ipoc

template <typename scalar_t>
int shape_t(int v, const void* const* in, void* const* out, int B, int T, cudaStream_t s) {
  using P = const scalar_t*;
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  switch (v) {
%CASES%
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rc_shape(int dtype, int v, const void* const* in, void* const* out, int B,
                        int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return shape_t<float>(v, in, out, B, T, s);
  if (dtype == 1) return shape_t<double>(v, in, out, B, T, s);
  return -1;
}
"""

# The parent's par_newton.cu alone: the trial's entries (other objects)
# stubbed out.
PAR_STUB = r"""
#include "par_newton.cu"
extern "C" int ipoc_par_trial_launch_f32(int, int, int, const void* const*, void*, void*,
                                         void*, void*, void*, int, int, void*) { return -1; }
extern "C" int ipoc_par_trial_launch_f64(int, int, int, const void* const*, void*, void*,
                                         void*, void*, void*, int, int, void*) { return -1; }
extern "C" int ipoc_par_trial_occupancy_f32(int, int, int, int*) { return -1; }
extern "C" int ipoc_par_trial_occupancy_f64(int, int, int, int*) { return -1; }
"""

I_, P_ = ctypes.c_int, ctypes.c_void_p


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def nvcc_lib(name, text, include):
    """``text`` compiled with the port's nvcc flags against ``include`` into
    a loaded library; ptxas's report beside it."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src, so = BUILD / f"{name}.cu", BUILD / f"lib{name}.so"
    src.write_text(text)
    res = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(include), "-o",
                          str(so), str(src)], capture_output=True, text=True)
    (BUILD / f"{name}.ptxas.txt").write_text(res.stderr)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return ctypes.CDLL(str(so)), res.stderr


def turns(calls, order, reps=50):
    """ms of each call of ``order`` (a list of keys of ``calls``), timed in
    that order at the SM clock; returns (ms list, MHz)."""
    with cs.SmClock() as clock:
        cs.busy(calls[order[1]], 0.3)
        ms = [cs.cuda_ms(calls[k], reps) for k in order]
    return ms, clock.mhz


def part_rc():
    ocp = cs.model_ocp("cartpole")
    cases = "\n".join(
        f"    case {i}: ipoc::rc_shape<scalar_t, {g}, {w}>"
        f"<<<(B + {32 // g - 1}) / {32 // g}, 32, 0, s>>>(P(in[0]), P(in[1]), P(in[2]), "
        "O(0), O(1), O(2), O(3), B, T); break;"
        for i, (g, w) in enumerate(RC_SHAPES))
    lib, ptx = nvcc_lib("rc_shapes", tf.model_source(ocp, 4, 1)
                        + RC_SOURCE.replace("%CASES%", cases), cuda.CSRC)
    lib.rc_shape.argtypes = [I_, I_, P_, P_, I_, I_, P_]
    lib.ipoc_rollout_cost_reference.argtypes = [I_, P_, P_, I_, I_, P_]
    regs = cs.ptxas_entries(ptx, r"rc_shapeI([fd])Li(\d+)ELi(\d+)E")
    emit({"part": "rc_ptxas", "registers": {
        f"{dt} G={g} W={w}": (r["registers"], r["spill_store_bytes"])
        for (dt, g, w), r in regs.items()}})
    dev = torch.device("cuda")
    pool = cs.make_pool(cartpole, 2 * cs.LANES, torch.float32)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for dtype in (torch.float32, torch.float64):
        u, _, x0, bp, _ = cs.fused_inputs(pool, dtype, dev, 0.1)
        for B in (cs.LANES, cs.OPEN_B):
            ins = [a.contiguous() for a in (u[..., :B], x0[:, :B], bp[:B])]
            T_, code, ip = u.shape[0], cuda.dtype_code(dtype), tf.pointers(ins)
            calls, outs = {}, {}
            for v in ["loop"] + list(range(len(RC_SHAPES))):
                o = [torch.full(sh, float("nan"), dtype=dtype, device=dev)
                     for sh in ((T_, 4, B), (4, B), (B,), (B,))]
                op = tf.pointers(o)

                def call(v=v, op=op):
                    st = (lib.ipoc_rollout_cost_reference(code, ip, op, B, T_, stream())
                          if v == "loop" else lib.rc_shape(code, v, ip, op, B, T_, stream()))
                    cs.check(st == 0, f"rollout cost {v}: status {st}")
                calls[v], outs[v] = call, o
                call()
            torch.cuda.synchronize()
            rec = {"part": "rc", "dtype": str(dtype)[6:], "B": B, "T": T_, "shapes": {}}
            for v, (g, w) in enumerate(RC_SHAPES):
                ms, mhz = turns(calls, ["loop", v, v, "loop"])
                rec["shapes"][f"G={g} W={w}"] = {
                    "equal_to_loop": all(bool(torch.equal(a, b))
                                         for a, b in zip(outs[v], outs["loop"])),
                    "ms": ms[1:3], "loop_ms": [ms[0], ms[3]],
                    "cycles_per_stage": min(ms[1:3]) * 1e3 / T_ * mhz if mhz else None}
            emit(rec)


def part_scan(parent):
    plib, _ = nvcc_lib("parent_par", PAR_STUB, Path(parent) / "ipoc_tpu_torch" / "csrc")
    plib.ipoc_value_scan.argtypes = [I_] * 2 + [P_] * 10 + [I_, I_, P_]
    plib.ipoc_affine_scan.argtypes = [I_] * 4 + [P_] * 4 + [I_, I_, P_]
    nlib = cuda.library(cuda.PAR_NEWTON)
    dev = torch.device("cuda")
    sms = cuda.sm_count(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for T_, B in ((cs.T, cs.PAR_BATCH), (cs.LONG_T, 1)):
        for dtype in (torch.float32, torch.float64):
            _, scans = cs.par_inputs(T_, B, dtype, dev)
            args, code = scans["value"], cuda.dtype_code(dtype)
            n = args[1].shape[-1]
            calls, outs = {}, {}
            for key in ["parent"] + list(sk.SCAN_LANES):
                o = [torch.full_like(a, float("nan")) for a in args]
                ptrs = [a.data_ptr() for a in (*args, *o)]

                def call(key=key, ptrs=ptrs):
                    st = (plib.ipoc_value_scan(code, n, *ptrs, B, T_, stream())
                          if key == "parent" else
                          nlib.ipoc_value_scan(code, n, key, *ptrs, B, T_, stream()))
                    cs.check(st == 0, f"value scan {key}: status {st}")
                calls[key], outs[key] = call, o
                call()
            torch.cuda.synchronize()
            ref = sk.value_scan_plain(*args)
            rec = {"part": "value", "dtype": str(dtype)[6:], "B": B, "T": T_,
                   "rule_P": sk.scan_lanes(B, T_, dtype, sms, value=True), "P": {}}
            for key, o in outs.items():
                err = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(o, ref))
                if key == "parent":
                    rec["parent_rel_err"] = err
                    continue
                ms, mhz = turns(calls, ["parent", key, key, "parent"])
                rec["P"][key] = {"rel_err": err, "ms": ms[1:3], "parent_ms": [ms[0], ms[3]],
                                 "cycles_per_element": min(ms[1:3]) * 1e3 / T_ * mhz}
            emit(rec)
            # The affine scan's suffix mode on the costate elements (T+1).
            fa = scans["suffix"]
            Ta = fa[1].shape[1]
            P = sk.scan_lanes(B, Ta, dtype, sms)
            acalls = {}
            for key, lib in (("parent", plib), ("kernel", nlib)):
                o = [torch.empty_like(a) for a in fa]
                ptrs = [a.data_ptr() for a in (*fa, *o)]

                def call(lib=lib, ptrs=ptrs, o=o):
                    cs.check(lib.ipoc_affine_scan(code, n, 1, P, *ptrs, B, Ta,
                                                  stream()) == 0, "affine scan")
                acalls[key] = call
            ms, _ = turns(acalls, ["parent", "kernel", "kernel", "parent"])
            emit({"part": "affine", "dtype": str(dtype)[6:], "B": B, "T": Ta, "P": P,
                  "ms": ms[1:3], "parent_ms": [ms[0], ms[3]]})


def patched_copy(items, dst, rel, old, new):
    """Copies of ``items`` (paths in the checkout) under ``dst``, made anew,
    with the one ``old`` in ``dst / rel`` replaced by ``new``."""
    if dst.exists():
        shutil.rmtree(dst)
    for item in items:
        to = dst / item.relative_to(ROOT)
        to.parent.mkdir(parents=True, exist_ok=True)
        if item.is_dir():
            shutil.copytree(item, to, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(item, to)
    f = dst / rel
    text = f.read_text()
    cs.check(text.count(old) == 1, f"{rel}: the barrier to replace not found")
    f.write_text(text.replace(old, new))
    return dst


def part_barrier():
    """The value scan with __syncwarp as the scenario barrier at P = 32."""
    csrc = Path(cuda.CSRC).relative_to(ROOT)
    src = patched_copy([ROOT / csrc], BUILD / "syncwarp", csrc / "affine_scan.h",
                       '      asm volatile("bar.sync 1, 32;" ::: "memory");',
                       "      __syncwarp();") / csrc
    lib, _ = nvcc_lib("syncwarp_par", PAR_STUB, src)
    lib.ipoc_value_scan.argtypes = [I_] * 3 + [P_] * 10 + [I_, I_, P_]
    dev = torch.device("cuda")
    for T_, B in ((7, 3), (cs.T, cs.PAR_BATCH), (cs.LONG_T, 1)):
        args = cs.par_inputs(T_, B, torch.float64, dev)[1]["value"]
        outs = [torch.full_like(a, float("nan")) for a in args]
        cs.check(lib.ipoc_value_scan(1, 4, 32, *(a.data_ptr() for a in (*args, *outs)), B,
                                     T_, torch.cuda.current_stream().cuda_stream) == 0,
                 "value scan (syncwarp)")
        ref = sk.value_scan_plain(*args)
        emit({"part": "barrier", "barrier": "__syncwarp", "dtype": "float64", "n": 4,
              "P": 32, "B": B, "T": T_,
              "rel_err": max(float((g - r).abs().max() / r.abs().max())
                             for g, r in zip(outs, ref))})


RING_OLD = "    f(lane);\n    __syncwarp();\n"
RING_NEW = '    f(lane);\n    asm volatile("bar.sync 1, 32;" ::: "memory");\n'


def ring_dump(path):
    """Every ring kernel's outputs on phases A, D and G's inputs, through
    the wrappers of this checkout's package (a child of :func:`part_ring`)."""
    from ipoc_tpu_torch import BATCH_CONFIG
    from ipoc_tpu_torch.models import pendulum
    from ipoc_tpu_torch.ops import mega
    from ipoc_tpu_torch.ops.cuda.seq_newton import (
        seq_costates_batched,
        seq_newton_trial_batched,
    )

    cs.check(Path(cuda.CSRC).is_relative_to(ROOT), f"imported {cuda.CSRC}")
    dev = torch.device("cuda")
    # Every library at once (one nvcc per source), then the runs.
    cuda.build_all([cuda.SEQ_NEWTON] + [
        tf.model_spec(cs.model_ocp(m, c), nx, 1)
        for m, c, nx in (("cartpole", 1, 4), ("cartpole", cs.COARSEN, 4),
                         ("pendulum", 1, 2))])
    pool32 = cs.make_pool(cartpole, 2 * cs.LANES, torch.float32)
    ppool = cs.make_pool(pendulum, 512, torch.float32, seed=cs.SEED + 1)
    out = {}

    def keep(key, tensors):
        for i, t in enumerate(tensors):
            out[f"{key}[{i}]"] = t.detach().cpu().clone()

    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        # Phase A: the seq trial and the costate recursion.
        trial, costate = cs.slice_stage_data(
            tuple(a[:cs.LANES] for a in pool32), dtype, dev)
        gen = torch.Generator().manual_seed(cs.SEED)
        rtrial, rcostate = cs.random_stage_data(gen, cs.LANES, cs.T, 3, 2, dtype, dev)
        for name, args in (("cartpole", (trial, costate)),
                           ("random_nx3_nu2", (rtrial, rcostate))):
            keep(f"A {name} {tag} seq_trial", seq_newton_trial_batched(*args[0]))
            keep(f"A {name} {tag} costates", (seq_costates_batched(*args[1]),))
        # Phase D: rollout cost, backward and forward sweeps, transition.
        for model, pool, bps in (("cartpole", pool32, (0.1, 0.004)),
                                 ("pendulum", ppool, (0.1,))):
            ocp = cs.model_ocp(model)
            for bp in bps:
                u, u_other, x0, bpt, rp = cs.fused_inputs(pool, dtype, dev, bp)
                up = (u + 0.2 * (u - u_other)).contiguous()
                key = f"D {model} {tag} bp={bp}"
                roll = tf.rollout_cost_packed(ocp, u, x0, bpt)
                keep(f"{key} rollout_cost", roll)
                reg = rp * torch.clamp(torch.sqrt(roll[3]), min=1e-6)
                keep(f"{key} fused_trial",
                     tf.fused_newton_iter_packed(ocp, roll[0], roll[1], u, bpt, reg))
                keep(f"{key} transition", tf.transition_packed(ocp, u, up, x0, bpt))
        # Phase G: the merged trial and the mega kernel.
        for level, (_, ddp) in cs.LEVELS.items():
            ocp, u, x0 = cs.level_inputs(pool32, level, dtype, dev)
            impl = "ddp" if ddp else "fused"
            for bp in (0.1, 0.004):
                key = f"G {level} {tag} bp={bp}"
                lane = cs.open_packed(ocp, u, x0, BATCH_CONFIG, bp)
                reg = 100.0 * torch.clamp(lane.cun, min=1e-6)
                keep(f"{key} merged_trial", tf.merged_trial_launch(
                    ocp, lane.xs, lane.xT, lane.u, lane.bp, reg, ddp=ddp))
                for k, cap in ((4, 2), (32, BATCH_CONFIG.max_newton_iters)):
                    cfg = BATCH_CONFIG.replace(newton_impl=impl, max_newton_iters=cap)
                    lane0 = cs.open_packed(ocp, u, x0, cfg, bp)
                    got, steps = mega.mega_k_iterations(
                        ocp, mega.clone_lane(lane0), torch.ones_like(lane0.done),
                        cfg, k, ddp)
                    keep(f"{key} mega k={k}", (*got, steps))
    torch.cuda.synchronize()
    torch.save(out, path)


def bits(t):
    """``t``'s bit pattern (NaNs compare by their bits)."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return t if t.dtype == torch.bool else t.contiguous().view(ints[t.element_size()])


def part_ring():
    """WarpExec's barrier as bar.sync 1, 32 against __syncwarp, bit for
    bit; returns the number of outputs that differ."""
    work = ROOT / "build" / "ring_barrier"
    me = Path(__file__).resolve()
    patched = patched_copy([ROOT / "ipoc_tpu_torch", ROOT / "chip_smoke.py", me],
                           work / "patched", "ipoc_tpu_torch/csrc/riccati_rows.h",
                           RING_OLD, RING_NEW)
    roots = {"syncwarp": ROOT, "bar_sync": patched}
    t0 = time.perf_counter()
    # Both builds at once, each in a child that imports its own copy.
    procs = {name: subprocess.Popen(
        [sys.executable, str(root / me.relative_to(ROOT)), "--ring-dump",
         str(work / f"{name}.pt")]) for name, root in roots.items()}
    for name, proc in procs.items():
        cs.check(proc.wait() == 0, f"the {name} build's run failed")
    wall = time.perf_counter() - t0
    a, b = (torch.load(work / f"{name}.pt") for name in roots)
    cs.check(a.keys() == b.keys(), "the two runs dumped different outputs")
    differ = [key for key in a if not torch.equal(bits(a[key]), bits(b[key]))]
    for key in differ:
        emit({"part": "ring", "differs": key,
              "max_abs_diff": float((a[key].double() - b[key].double()).abs()
                                    .nan_to_num(float("inf")).max()),
              "elements": a[key].numel(),
              "elements_differing": int((bits(a[key]) != bits(b[key])).sum())})
    emit({"part": "ring", "ring_barrier": "bar.sync 1, 32 against __syncwarp",
          "outputs_compared": len(a),
          "elements_compared": sum(t.numel() for t in a.values()),
          "outputs_differing": len(differ), "bit_equal": not differ, "wall_s": wall})
    return len(differ)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"),
                    help="a git archive of the parent commit (for --parts scan)")
    ap.add_argument("--parts", default="rc,scan,barrier")
    ap.add_argument("--ring-dump", help=argparse.SUPPRESS)  # a child of ring
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    cuda.disable_tf32()
    if args.ring_dump:
        ring_dump(args.ring_dump)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"device": smi.stdout.strip(), "time": time.strftime("%Y-%m-%d %H:%M:%S")})
    parts = args.parts.split(",")
    if "rc" in parts:
        part_rc()
    if "scan" in parts:
        part_scan(args.parent)
    if "barrier" in parts:
        part_barrier()
    if "ring" in parts and part_ring():
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
