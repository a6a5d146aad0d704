// The fused lane evaluators' five kernels for Hopper (sm_90a), templated
// on a generated model.
//
// Replaces, from ipoc_tpu/ops/pallas/fused_iter_kernel.py:
//   * fused_bwd_kernel     <- _fused_bwd_kernel (:1261): in-kernel stage
//     derivatives, costates, Riccati gains, total cost, dV, minimum pivot
//     and max|ru|, one reverse sweep;
//   * fused_fwd_kernel     <- _fused_fwd_kernel (:1298, with_cu): deviation
//     rollout fused with the trial's barrier cost, maximum constraint value
//     and sum ||cu||^2;
//   * rollout_kernel       <- _rollout_kernel (:1577): the open-loop rollout
//     alone (the flat lanes' open and their re-rollout at a stage
//     transition without the predictor);
//   * rollout_cost_kernel  <- _rollout_cost_packed_kernel (:1956): rollout,
//     barrier cost and sum ||cu||^2 (lane open and refill);
//   * transition_kernel    <- _transition_packed_kernel (:2053): both
//     stage-transition candidates, u and the central-path prediction.
//
// The per-stage code is generated: ops/codegen/scalarize.py lowers the
// model's stage programs (ops/fused_iter.py) to straight-line functions of
// a `Model` struct, written into the build directory next to the library
// (fused_<model>.cu), which includes this header and instantiates the
// entry points with IPOC_FUSED_ENTRY_POINTS(Model).  The Riccati step is
// riccati.cuh's, shared with the seq trial kernel.
//
// Layout: batch-last, so neighbouring scenarios read neighbouring addresses
// (coalesced): stage arrays (T, rows, B), terminal and initial states
// (NX, B), per-lane scalars (B,).  The TPU kernels' time blocks, sublane
// packing and hoisted-constant inputs have no counterpart: the time axis is
// a loop, the value and costate carries live in registers (no horizon
// cap), and constants are inlined in the generated code.
//
// fused_bwd_kernel: one warp per block, a group of G lanes per scenario
// (G = 4 at nx = 3, 4; 2 at nx = 2), the schedule of fused_bwd.h (host and
// device; the CPU tests build it with g++).
//   What bounded the one-thread-per-scenario kernel it replaces: one warp's
//   serial chain per SM (128 warps at B = 4096), about 980 instructions
//   per stage in float32, two thirds of them the stage program.  On an
//   H100 (700 W) at B = 4096, T = 100, computing stage_bwd once and reusing
//   its outputs took a launch from 0.128 to 0.049 ms in float32 (0.258 to
//   0.073 in float64), computing the Riccati step once to 0.118 (PERF.md
//   section 5).
//   What the design does: the codegen splits stage_bwd at the costate
//   (stage_bwd_pre: the elementary-function calls that do not read it,
//   sin, cos, log and rem; stage_bwd_post: the rest, all of the arithmetic
//   with it, so that nvcc contracts it into FMAs as in stage_bwd itself
//   and the results stay the one-thread kernel's to the bit at cartpole).
//   Lane r of a group computes pre for one stage of the next chunk of G
//   stages, from x and u it loaded a chunk before, into a shared-memory
//   handoff buffer; the chain runs post on every lane and then the
//   cooperative Riccati step of riccati_rows.h.  So the card holds G warps
//   where it held one, the calls and the loads leave the chain, and a
//   chain's stage carries post and a part of the step.  A split that also
//   handed off the arithmetic that does not read the costate ran 0.094 ms
//   in float32 (0.155 in float64) but rounded apart from stage_bwd; this
//   one runs 0.122 (0.206) against the one-thread kernel's 0.128 (0.254)
//   (PERF.md section 5).
//   Shared memory per block (handoffs [2][G][NH], exchange slices): 8 x
//   (84 + 44) scalars at cartpole (NH = 10): 4,096 bytes in float32, 8,192
//   in float64; pendulum (NH = 8, 16 scenarios) 16 x (34 + 14): 3,072 /
//   6,144.  Registers and resident blocks per SM: chip_smoke.py phase 0
//   (ipoc_fused_bwd_occupancy; cartpole 93 and 20 in float32, 152 and 12
//   in float64).  At the planar quadrotor's nx = 6, nu = 2 (8 lanes, 4
//   scenarios; NH = 15) 6,144 / 12,288 bytes, 115 and 16 / 168 (28 bytes
//   of spills) and 12 (chip_smoke.py phase 0).
//
// fused_fwd_kernel and transition_kernel: one warp per block, 4 scenarios
// of 8 lanes, the schedules of fused_fwd.h and transition.h (host and
// device; the CPU tests build them with g++).
//   What bounded the one-thread kernels they replace: one warp per SM at
//   B = 4096 running the whole stage program on the serial chain, loads
//   included, some 1,590 and 1,640 cycles per stage in float32 (3,730 and
//   3,910 in float64) on an H100 (700 W).
//   What the designs do: the evaluation of each stage (the cost, the
//   constraint maximum and ||cu||^2, with its logs, rem and divisions)
//   leaves the chain, cut by the codegen at the trial point (#6) or per
//   candidate (#12) and spread one stage a lane, a chunk behind; the
//   loads come through a cp.async ring as runs of the block's columns;
//   #12 runs its two candidates on the two halves of the group.  The
//   chain keeps all of its own arithmetic (#6: stage_fwd_step with the
//   dynamics' Jacobian, only sin and cos handed off; #12: the dynamics),
//   so both equal the one-thread kernels to the bit at cartpole: a #6
//   that also handed off the Jacobian's arithmetic ran 0.041 ms in
//   float32 but rounded apart (PERF.md section 5).  C entry at B = 4096,
//   T = 100: #6 0.080 -> 0.064 ms in float32 (0.188 -> 0.119 in float64),
//   #12 0.083 -> 0.057 (0.200 -> 0.088).  Registers, shared memory and
//   resident blocks per SM: chip_smoke.py phase 0.
//
// rollout_kernel: one lane per scenario, the loop of rollout.h (host and
// device; the CPU tests build it with g++).
//   What bounds it: its chain, not its bytes.  x_{t+1} = dynamics(x_t,
//   u_t) is serial, so T steps of the dynamics' latency are its floor: on
//   an H100 (700 W) at B = 4096, T = 100, the one-thread loop it replaces
//   with u pinned to stage 0 and no stores took 0.0199 ms in float32 (394
//   cycles a stage; float64 0.0383, 759), against a byte bound of 0.0025
//   and the loop's own 0.0295 (585 cycles; float64 0.0400): in float32 the
//   load of u_t sat on the chain.
//   What the design does: the controls of the next chunk of 8 stages are
//   loaded into registers at the start of a chunk, so no load is on the
//   chain; the chain keeps all of its arithmetic, so the results are the
//   one-thread loop's bit for bit.  Float32 0.0295 -> 0.0225 ms; float64
//   keeps the loop's time (its chain is 96% of it; one stage ahead) (PERF.md
//   section 6).  rollout_reference_kernel keeps the loop it replaced, as
//   the oracle the checks hold it to.
//
// rollout_cost_kernel: one warp per block, a group of G lanes per
// scenario, the schedule of rollout_cost.h (host and device; the CPU tests
// build it with g++).
//   What bounded the one-thread loop it replaces: latency, not bytes (a
//   byte bound of 0.0025 ms at B = 4096, T = 100): one serial loop of T
//   stages per thread, 128 warps on the card at B = 4096 and a handful at
//   the refill sizes the streams open, with the stage cost's logs, rem and
//   divisions and the loads of u in the loop beside the dynamics: 932
//   cycles a stage in float32 (1,983 in float64) against the dynamics'
//   chain alone, 394 (759), on an H100 (700 W).
//   What the design does: the codegen cuts roll_cost into the dynamics
//   and the evaluation (transition.h's programs); every lane of a group
//   runs the chain, and each evaluates its own stages of a chunk a chunk
//   behind, from the state and control it kept in registers as the chain
//   passed them, so the evaluation leaves the chain and the card holds G
//   = 4 warps where it held one.  The sums stay in stage order, so the
//   results are the one-thread loop's bit for bit (cartpole and pendulum,
//   both dtypes, on an H100).  C entry at B = 4096, T = 100: 0.047 ->
//   0.031 ms in float32, 0.100 -> 0.063 in float64, and the same at the
//   streams' median lane opening, B = 965 (PERF.md section 6).
//   rollout_cost_reference_kernel keeps the loop it replaced, as the
//   oracle the checks hold it to.
// The resident mega kernel (mega.cuh) fuses a lane iteration's launches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_bwd.h"
#include "fused_fwd.h"
#include "launch_attr.cuh"
#include "lane.h"  // load_col, store_col
#include "riccati.cuh"
#include "rollout.h"
#include "rollout_cost.h"
#include "scalar_math.h"
#include "transition.h"

namespace ipoc {

constexpr int kFusedThreads = 32;

// Costates + stage data + Riccati gains in one reverse sweep (fused_bwd.h).
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kRowWarp)
fused_bwd_kernel(const scalar_t* __restrict__ xs,   // (T, NX, B) stages 0..T-1
                 const scalar_t* __restrict__ us,   // (T, NU, B)
                 const scalar_t* __restrict__ xT,   // (NX, B)
                 const scalar_t* __restrict__ bp,   // (B,)
                 const scalar_t* __restrict__ reg,  // (B,) Levenberg, pre-scaled
                 scalar_t* __restrict__ Kk,         // (T, (1+NX)*NU, B) gains [k | K]
                 scalar_t* __restrict__ cost_o,     // (B,) barrier total cost
                 scalar_t* __restrict__ dv_o,       // (B,) predicted reduction
                 scalar_t* __restrict__ piv_o,      // (B,) minimum pivot
                 scalar_t* __restrict__ hu_o,       // (B,) max_t |ru_t|
                 int B, int T) {
  using F = FusedBwd<Model, scalar_t>;
  __shared__ __align__(16) scalar_t sh[F::kShared];
  const int s = static_cast<int>(threadIdx.x) / F::G;
  const auto sc = F::scenario(xs, us, bp, reg, Kk,
                              static_cast<int>(blockIdx.x) * F::S + s, B, T, s, sh);
  typename F::Lane lane;
  lane.r = static_cast<int>(threadIdx.x) % F::G;
  WarpExec<typename F::Lane> ex{lane};
  F::schedule(ex, sc, xT, cost_o, dv_o, piv_o, hu_o);
}

// Deviation rollout fused with the trial's cost, maximum constraint value
// and sum ||cu||^2 at the trial point (fused_fwd.h).
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kRowWarp)
fused_fwd_kernel(const scalar_t* __restrict__ xs,   // (T, NX, B)
                 const scalar_t* __restrict__ us,   // (T, NU, B)
                 const scalar_t* __restrict__ xT,   // (NX, B)
                 const scalar_t* __restrict__ bp,   // (B,)
                 const scalar_t* __restrict__ Kk,   // (T, (1+NX)*NU, B)
                 scalar_t* __restrict__ tu_o,       // (T, NU, B) trial controls
                 scalar_t* __restrict__ tx_o,       // (T, NX, B) trial states
                 scalar_t* __restrict__ txT_o,      // (NX, B) trial terminal state
                 scalar_t* __restrict__ nc_o,       // (B,) trial barrier cost
                 scalar_t* __restrict__ mc_o,       // (B,) max constraint value
                 scalar_t* __restrict__ cun_o,      // (B,) sum ||cu||^2 at the trial
                 int B, int T) {
  using F = FusedFwd<Model, scalar_t>;
  __shared__ __align__(16) scalar_t sh[F::kShared];
  typename F::Lane lane;
  lane.s = static_cast<int>(threadIdx.x) / F::G;
  lane.r = static_cast<int>(threadIdx.x) % F::G;
  const auto k = F::block(xs, us, Kk, tu_o, tx_o, B, T,
                          static_cast<int>(blockIdx.x), sh);
  WarpExec<typename F::Lane> ex{lane};
  F::schedule(ex, k, xT, bp, txT_o, nc_o, mc_o, cun_o);
}

// Open-loop rollout x_{t+1} = f(x_t, u_t), one lane per scenario
// (rollout.h).
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kRolloutWarp)
rollout_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
               const scalar_t* __restrict__ x0,  // (NX, B)
               scalar_t* __restrict__ xs_o,      // (T, NX, B) stages 0..T-1
               scalar_t* __restrict__ xT_o,      // (NX, B)
               int B, int T) {
  const int b = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (b < B) Rollout<Model, scalar_t>::run(us, x0, xs_o, xT_o, B, T, b);
}

// The one-thread loop that rollout_kernel replaced (one thread per
// scenario, u_t loaded and x_t stored in the chain's loop), kept as the
// oracle that holds rollout_kernel to the bit (chip_smoke.py phase D,
// tests/test_torch_cuda.py); no path launches it.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
rollout_reference_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
                         const scalar_t* __restrict__ x0,  // (NX, B)
                         scalar_t* __restrict__ xs_o,      // (T, NX, B)
                         scalar_t* __restrict__ xT_o,      // (NX, B)
                         int B, int T) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  scalar_t x[NX];
  load_col<scalar_t, NX>(x, x0, B, b);
  for (int t = 0; t < T; ++t) {
    scalar_t u[NU], xn[NX];
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    store_col<scalar_t, NX>(xs_o + (size_t)t * NX * B, x, B, b);
    Model::template dynamics<scalar_t>(x, u, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
  store_col<scalar_t, NX>(xT_o, x, B, b);
}

// Open-loop rollout fused with the barrier total cost and sum ||cu||^2, a
// group of lanes per scenario (rollout_cost.h).
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kRowWarp)
rollout_cost_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
                    const scalar_t* __restrict__ x0,  // (NX, B)
                    const scalar_t* __restrict__ bp,  // (B,)
                    scalar_t* __restrict__ xs_o,      // (T, NX, B) stages 0..T-1
                    scalar_t* __restrict__ xT_o,      // (NX, B)
                    scalar_t* __restrict__ cost_o,    // (B,)
                    scalar_t* __restrict__ cun_o,     // (B,)
                    int B, int T) {
  using Rc = RollCost<Model, scalar_t>;
  typename Rc::Lane lane;
  lane.s = static_cast<int>(threadIdx.x) / Rc::G;
  lane.r = static_cast<int>(threadIdx.x) % Rc::G;
  WarpExec<typename Rc::Lane> ex{lane};
  Rc::schedule(ex, Rc::block(us, xs_o, B, T, static_cast<int>(blockIdx.x)), x0, bp,
               xT_o, cost_o, cun_o);
}

// The one-thread loop that rollout_cost_kernel replaced (one thread per
// scenario, roll_cost whole in the loop), kept as the oracle that holds
// rollout_cost_kernel to the bit (chip_smoke.py phase D,
// tests/test_torch_cuda.py); no path launches it.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
rollout_cost_reference_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
                              const scalar_t* __restrict__ x0,  // (NX, B)
                              const scalar_t* __restrict__ bp,  // (B,)
                              scalar_t* __restrict__ xs_o,      // (T, NX, B)
                              scalar_t* __restrict__ xT_o,      // (NX, B)
                              scalar_t* __restrict__ cost_o,    // (B,)
                              scalar_t* __restrict__ cun_o,     // (B,)
                              int B, int T) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const scalar_t bpv = bp[b];
  scalar_t x[NX];
  load_col<scalar_t, NX>(x, x0, B, b);
  scalar_t cost = scalar_t(0), cun = scalar_t(0);
  for (int t = 0; t < T; ++t) {
    scalar_t u[NU], xn[NX], cst, cusq;
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    store_col<scalar_t, NX>(xs_o + (size_t)t * NX * B, x, B, b);
    Model::template roll_cost<scalar_t>(x, u, &bpv, xn, &cst, &cusq);
    cost = cost + cst;
    cun = cun + cusq;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
  scalar_t cT;
  Model::template final_cost<scalar_t>(x, &cT);
  store_col<scalar_t, NX>(xT_o, x, B, b);
  cost_o[b] = cost + cT;
  cun_o[b] = cun;
}

// The stage-predictor transition: rollouts of u (candidate a) and of the
// prediction up (candidate b) with their barrier costs and sum ||cu||^2
// (transition.h).
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kRowWarp)
transition_kernel(const scalar_t* __restrict__ us,   // (T, NU, B)
                  const scalar_t* __restrict__ ups,  // (T, NU, B)
                  const scalar_t* __restrict__ x0,   // (NX, B)
                  const scalar_t* __restrict__ bp,   // (B,) the new bp
                  scalar_t* __restrict__ xa_o,       // (T, NX, B)
                  scalar_t* __restrict__ xb_o,       // (T, NX, B)
                  scalar_t* __restrict__ xaT_o,      // (NX, B)
                  scalar_t* __restrict__ xbT_o,      // (NX, B)
                  scalar_t* __restrict__ ca_o,       // (B,)
                  scalar_t* __restrict__ cb_o,       // (B,)
                  scalar_t* __restrict__ cua_o,      // (B,)
                  scalar_t* __restrict__ cub_o,      // (B,)
                  int B, int T) {
  using Tr = Transition<Model, scalar_t>;
  __shared__ __align__(16) scalar_t sh[Tr::kShared];
  typename Tr::Lane lane;
  lane.s = static_cast<int>(threadIdx.x) / Tr::G;
  lane.r = static_cast<int>(threadIdx.x) % Tr::G;
  const auto k = Tr::block(us, ups, xa_o, xb_o, B, T,
                           static_cast<int>(blockIdx.x), sh);
  WarpExec<typename Tr::Lane> ex{lane};
  Tr::schedule(ex, k, x0, bp, xaT_o, xbT_o, ca_o, cb_o, cua_o, cub_o);
}

inline int fused_blocks(int B) { return (B + kFusedThreads - 1) / kFusedThreads; }

template <typename Model, typename scalar_t>
int launch_fused_bwd(const void* const* in, void* const* out, int B, int T,
                     cudaStream_t s) {
  using P = const scalar_t*;
  using F = FusedBwd<Model, scalar_t>;
  fused_bwd_kernel<Model, scalar_t><<<(B + F::S - 1) / F::S, kRowWarp, 0, s>>>(
      P(in[0]), P(in[1]), P(in[2]), P(in[3]), P(in[4]),
      static_cast<scalar_t*>(out[0]), static_cast<scalar_t*>(out[1]),
      static_cast<scalar_t*>(out[2]), static_cast<scalar_t*>(out[3]),
      static_cast<scalar_t*>(out[4]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_fused_fwd(const void* const* in, void* const* out, int B, int T,
                     cudaStream_t s) {
  using P = const scalar_t*;
  fused_fwd_kernel<Model, scalar_t>
      <<<FusedFwd<Model, scalar_t>::blocks(B), kRowWarp, 0, s>>>(
      P(in[0]), P(in[1]), P(in[2]), P(in[3]), P(in[4]),
      static_cast<scalar_t*>(out[0]), static_cast<scalar_t*>(out[1]),
      static_cast<scalar_t*>(out[2]), static_cast<scalar_t*>(out[3]),
      static_cast<scalar_t*>(out[4]), static_cast<scalar_t*>(out[5]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_rollout(const void* const* in, void* const* out, int B, int T,
                   cudaStream_t s) {
  using P = const scalar_t*;
  rollout_kernel<Model, scalar_t>
      <<<Rollout<Model, scalar_t>::blocks(B), kRolloutWarp, 0, s>>>(
          P(in[0]), P(in[1]), static_cast<scalar_t*>(out[0]),
          static_cast<scalar_t*>(out[1]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_rollout_reference(const void* const* in, void* const* out, int B,
                             int T, cudaStream_t s) {
  using P = const scalar_t*;
  rollout_reference_kernel<Model, scalar_t>
      <<<fused_blocks(B), kFusedThreads, 0, s>>>(
          P(in[0]), P(in[1]), static_cast<scalar_t*>(out[0]),
          static_cast<scalar_t*>(out[1]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_rollout_cost(const void* const* in, void* const* out, int B,
                        int T, cudaStream_t s) {
  using P = const scalar_t*;
  rollout_cost_kernel<Model, scalar_t>
      <<<RollCost<Model, scalar_t>::blocks(B), kRowWarp, 0, s>>>(
          P(in[0]), P(in[1]), P(in[2]), static_cast<scalar_t*>(out[0]),
          static_cast<scalar_t*>(out[1]), static_cast<scalar_t*>(out[2]),
          static_cast<scalar_t*>(out[3]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_rollout_cost_reference(const void* const* in, void* const* out,
                                  int B, int T, cudaStream_t s) {
  using P = const scalar_t*;
  rollout_cost_reference_kernel<Model, scalar_t>
      <<<fused_blocks(B), kFusedThreads, 0, s>>>(
          P(in[0]), P(in[1]), P(in[2]), static_cast<scalar_t*>(out[0]),
          static_cast<scalar_t*>(out[1]), static_cast<scalar_t*>(out[2]),
          static_cast<scalar_t*>(out[3]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_transition(const void* const* in, void* const* out, int B, int T,
                      cudaStream_t s) {
  using P = const scalar_t*;
  transition_kernel<Model, scalar_t>
      <<<Transition<Model, scalar_t>::blocks(B), kRowWarp, 0, s>>>(
      P(in[0]), P(in[1]), P(in[2]), P(in[3]), static_cast<scalar_t*>(out[0]),
      static_cast<scalar_t*>(out[1]), static_cast<scalar_t*>(out[2]),
      static_cast<scalar_t*>(out[3]), static_cast<scalar_t*>(out[4]),
      static_cast<scalar_t*>(out[5]), static_cast<scalar_t*>(out[6]),
      static_cast<scalar_t*>(out[7]), B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipoc

// C entry points of one model's library, bound with ctypes.  Each takes
// `dtype` (0 float32, 1 float64), arrays of input and output device
// pointers in the order of the kernel's parameters, B, T and the stream,
// and returns cudaGetLastError() after the launch (0 on success) or -1 for
// an unknown dtype; nothing is synchronised.
#define IPOC_FUSED_ENTRY(NAME, LAUNCH, MODEL)                                \
  extern "C" int NAME(int dtype, const void* const* in, void* const* out,   \
                      int B, int T, void* stream) {                         \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    if (dtype == 0) return ipoc::LAUNCH<MODEL, float>(in, out, B, T, s);    \
    if (dtype == 1) return ipoc::LAUNCH<MODEL, double>(in, out, B, T, s);   \
    return -1;                                                              \
  }

// The card's view of one of the model's group-schedule kernels, NAME
// (dtype 0 float32, 1 float64; launch_attr.cuh kernel_occupancy): KERNEL
// launched in one-warp blocks of SCHED's S scenarios.
#define IPOC_FUSED_OCCUPANCY(NAME, KERNEL, SCHED, MODEL)                      \
  template <typename scalar_t>                                               \
  int NAME##_t(int* out) {                                                   \
    return ipoc::kernel_occupancy(ipoc::KERNEL<MODEL, scalar_t>,             \
                                  ipoc::kRowWarp, 0,                         \
                                  ipoc::SCHED<MODEL, scalar_t>::S, out);     \
  }                                                                          \
  extern "C" int NAME(int dtype, int* out) {                                 \
    if (dtype == 0) return NAME##_t<float>(out);                             \
    if (dtype == 1) return NAME##_t<double>(out);                            \
    return -1;                                                               \
  }

// Every entry point of one model's library; the merged trial's and the mega
// kernel's are defined in mega.cuh, which the generated source includes
// after this header.
#define IPOC_FUSED_ENTRY_POINTS(MODEL)                                 \
  IPOC_FUSED_ENTRY(ipoc_fused_bwd, launch_fused_bwd, MODEL)            \
  IPOC_FUSED_ENTRY(ipoc_fused_fwd, launch_fused_fwd, MODEL)            \
  IPOC_FUSED_ENTRY(ipoc_rollout, launch_rollout, MODEL)                \
  IPOC_FUSED_ENTRY(ipoc_rollout_cost, launch_rollout_cost, MODEL)      \
  IPOC_FUSED_ENTRY(ipoc_rollout_reference, launch_rollout_reference,   \
                   MODEL)                                              \
  IPOC_FUSED_ENTRY(ipoc_rollout_cost_reference,                        \
                   launch_rollout_cost_reference, MODEL)               \
  IPOC_FUSED_ENTRY(ipoc_transition, launch_transition, MODEL)          \
  IPOC_FUSED_OCCUPANCY(ipoc_fused_bwd_occupancy, fused_bwd_kernel,     \
                       FusedBwd, MODEL)                                \
  IPOC_FUSED_OCCUPANCY(ipoc_fused_fwd_occupancy, fused_fwd_kernel,     \
                       FusedFwd, MODEL)                                \
  IPOC_FUSED_OCCUPANCY(ipoc_transition_occupancy, transition_kernel,   \
                       Transition, MODEL)                              \
  IPOC_FUSED_OCCUPANCY(ipoc_rollout_occupancy, rollout_kernel, Rollout, \
                       MODEL)                                          \
  IPOC_FUSED_OCCUPANCY(ipoc_rollout_cost_occupancy, rollout_cost_kernel, \
                       RollCost, MODEL)                                \
  IPOC_MERGED_ENTRY(MODEL)                                             \
  IPOC_MEGA_ENTRY(MODEL)
