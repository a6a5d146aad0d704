// The fused lane evaluators' five kernels for Hopper (sm_90a), one thread
// per scenario, templated on a generated model.
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
//   in float64).  At nx = 6, nu = 2 (8 lanes, 4 scenarios) the exchange
//   slice is 136 scalars and the handoff 2 x 8 x NH; its registers are not
//   measured (no such model yet).
//
// The other four kernels run one thread per scenario.  What bounds them:
// latency, not bytes.  At B = 4096 each is one serial loop of T dependent
// stages per thread with 128 warps on the card, about one warp per SM, so
// nothing hides the latency of a stage's arithmetic chain or of its loads.
// Per stage a thread moves about 10 values (x, u, the gains, the outputs):
// some 16 MB per Newton iteration in float32 over the three per-iteration
// launches, far below what the memory could stream in the time.  The
// resident mega kernel (mega.cuh) fuses the iteration's launches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_bwd.h"
#include "launch_attr.cuh"
#include "lane.h"  // load_col, store_col
#include "riccati.cuh"
#include "scalar_math.h"

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
// and sum ||cu||^2 at the trial point.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
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
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const scalar_t bpv = bp[b];
  scalar_t dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = scalar_t(0);
  scalar_t cost = scalar_t(0), mc = -scalar_t(INFINITY), cun = scalar_t(0);

  for (int t = 0; t < T; ++t) {
    scalar_t x[NX], u[NU], g[NG];
    load_col<scalar_t, NX>(x, xs + (size_t)t * NX * B, B, b);
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    load_col<scalar_t, NG>(g, Kk + (size_t)t * NG * B, B, b);
    scalar_t tu[NU], tx[NX], dxn[NX], cst, cmax, cusq;
    Model::template stage_fwd<scalar_t>(x, u, &bpv, dx, g, tu, tx, dxn, &cst,
                                        &cmax, &cusq);
    store_col<scalar_t, NU>(tu_o + (size_t)t * NU * B, tu, B, b);
    store_col<scalar_t, NX>(tx_o + (size_t)t * NX * B, tx, B, b);
    cost = cost + cst;
    mc = ipoc_max(mc, cmax);
    cun = cun + cusq;
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
  scalar_t x[NX], txT[NX], cT;
  load_col<scalar_t, NX>(x, xT, B, b);
  Model::template term_fwd<scalar_t>(x, dx, txT, &cT);
  store_col<scalar_t, NX>(txT_o, txT, B, b);
  nc_o[b] = cost + cT;
  mc_o[b] = mc;
  cun_o[b] = cun;
}

// Open-loop rollout x_{t+1} = f(x_t, u_t), x kept in registers.  Bound by
// bytes: each thread reads its u column once and writes its x column once,
// (T*(NU+NX) + 2*NX) values per lane, coalesced across the warp.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
rollout_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
               const scalar_t* __restrict__ x0,  // (NX, B)
               scalar_t* __restrict__ xs_o,      // (T, NX, B) stages 0..T-1
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

// Open-loop rollout fused with the barrier total cost and sum ||cu||^2.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
rollout_cost_kernel(const scalar_t* __restrict__ us,  // (T, NU, B)
                    const scalar_t* __restrict__ x0,  // (NX, B)
                    const scalar_t* __restrict__ bp,  // (B,)
                    scalar_t* __restrict__ xs_o,      // (T, NX, B) stages 0..T-1
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
// prediction up (candidate b) with their barrier costs and sum ||cu||^2.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
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
  constexpr int NX = Model::NX, NU = Model::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const scalar_t bpv = bp[b];
  scalar_t xa[NX], xb[NX];
  load_col<scalar_t, NX>(xa, x0, B, b);
#pragma unroll
  for (int i = 0; i < NX; ++i) xb[i] = xa[i];
  scalar_t ca = scalar_t(0), cb = scalar_t(0), cua = scalar_t(0),
           cub = scalar_t(0);
  for (int t = 0; t < T; ++t) {
    scalar_t u[NU], up[NU], xan[NX], xbn[NX], csta, cstb, cusqa, cusqb;
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    load_col<scalar_t, NU>(up, ups + (size_t)t * NU * B, B, b);
    store_col<scalar_t, NX>(xa_o + (size_t)t * NX * B, xa, B, b);
    store_col<scalar_t, NX>(xb_o + (size_t)t * NX * B, xb, B, b);
    Model::template transition<scalar_t>(xa, xb, u, up, &bpv, xan, xbn, &csta,
                                         &cstb, &cusqa, &cusqb);
    ca = ca + csta;
    cb = cb + cstb;
    cua = cua + cusqa;
    cub = cub + cusqb;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xa[i] = xan[i];
      xb[i] = xbn[i];
    }
  }
  scalar_t cTa, cTb;
  Model::template final_cost<scalar_t>(xa, &cTa);
  Model::template final_cost<scalar_t>(xb, &cTb);
  store_col<scalar_t, NX>(xaT_o, xa, B, b);
  store_col<scalar_t, NX>(xbT_o, xb, B, b);
  ca_o[b] = ca + cTa;
  cb_o[b] = cb + cTb;
  cua_o[b] = cua;
  cub_o[b] = cub;
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
  fused_fwd_kernel<Model, scalar_t><<<fused_blocks(B), kFusedThreads, 0, s>>>(
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
  rollout_kernel<Model, scalar_t><<<fused_blocks(B), kFusedThreads, 0, s>>>(
      P(in[0]), P(in[1]), static_cast<scalar_t*>(out[0]),
      static_cast<scalar_t*>(out[1]), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename Model, typename scalar_t>
int launch_rollout_cost(const void* const* in, void* const* out, int B,
                        int T, cudaStream_t s) {
  using P = const scalar_t*;
  rollout_cost_kernel<Model, scalar_t>
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
  transition_kernel<Model, scalar_t><<<fused_blocks(B), kFusedThreads, 0, s>>>(
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

// The card's view of the model's fused_bwd_kernel (dtype 0 float32, 1
// float64; launch_attr.cuh kernel_occupancy).
#define IPOC_FUSED_BWD_OCCUPANCY(MODEL)                                      \
  template <typename scalar_t>                                               \
  int ipoc_fused_bwd_occupancy_t(int* out) {                                 \
    return ipoc::kernel_occupancy(ipoc::fused_bwd_kernel<MODEL, scalar_t>,   \
                                  ipoc::kRowWarp, 0,                         \
                                  ipoc::FusedBwd<MODEL, scalar_t>::S, out);  \
  }                                                                          \
  extern "C" int ipoc_fused_bwd_occupancy(int dtype, int* out) {             \
    if (dtype == 0) return ipoc_fused_bwd_occupancy_t<float>(out);           \
    if (dtype == 1) return ipoc_fused_bwd_occupancy_t<double>(out);          \
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
  IPOC_FUSED_ENTRY(ipoc_transition, launch_transition, MODEL)          \
  IPOC_FUSED_BWD_OCCUPANCY(MODEL)                                      \
  IPOC_MERGED_ENTRY(MODEL)                                             \
  IPOC_MEGA_ENTRY(MODEL)
