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
// Layout: batch-last, so neighbouring threads read neighbouring addresses
// (coalesced): stage arrays (T, rows, B), terminal and initial states
// (NX, B), per-lane scalars (B,).  The TPU kernels' time blocks, sublane
// packing and hoisted-constant inputs have no counterpart: the time axis is
// a loop inside the thread, the value and costate carries live in
// registers (no horizon cap), and constants are inlined in the generated
// code.  Blocks hold 32 threads so that B=4096 spreads over 128 of the 132
// SMs.
//
// What bounds them on the card: latency, not bytes.  At B=4096 each kernel
// is one serial loop of T dependent stages per thread with 128 warps on the
// card, about one warp per SM, so nothing hides the latency of a stage's
// arithmetic chain or of its loads.  Per stage a thread moves about 10
// values (x, u, the gains, the outputs): some 16 MB per Newton iteration in
// float32 over the three per-iteration launches, far below what the memory
// could stream in the time.  A later performance PR could run several
// scenarios per thread or split a scenario's rows over a warp's lanes for
// more parallel work per SM; the resident mega kernel (mega.cuh) fuses the
// iteration's launches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane.h"  // load_col, store_col
#include "riccati.cuh"
#include "scalar_math.h"

namespace ipoc {

constexpr int kFusedThreads = 32;

// Costates + stage data + Riccati gains in one reverse sweep.
template <typename Model, typename scalar_t>
__global__ void __launch_bounds__(kFusedThreads)
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
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const scalar_t bpv = bp[b];
  const scalar_t regv = reg[b];

  scalar_t x[NX], u[NU], lam[NX], Vxx[NX * NX], Vx[NX], cost;
  load_col<scalar_t, NX>(x, xT, B, b);
  Model::template term<scalar_t>(x, lam, Vxx, &cost);
#pragma unroll
  for (int i = 0; i < NX; ++i) Vx[i] = scalar_t(0);
  scalar_t dv = scalar_t(0), piv = scalar_t(INFINITY), hu = scalar_t(0);

  for (int t = T - 1; t >= 0; --t) {
    load_col<scalar_t, NX>(x, xs + (size_t)t * NX * B, B, b);
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    scalar_t ru[NU], Q[NX * NX], R[NU * NU], M[NX * NU], fx[NX * NX],
        fu[NX * NU], lam_new[NX], cst;
    Model::template stage_bwd<scalar_t>(x, u, &bpv, lam, ru, Q, R, M, fx, fu,
                                        lam_new, &cst);
    // Levenberg: R += reg * I (reg pre-scaled by ||cu|| by the caller).
#pragma unroll
    for (int i = 0; i < NU; ++i) R[i * (NU + 1)] = R[i * (NU + 1)] + regv;
    scalar_t k[NU], K[NU * NX];
    riccati_step<scalar_t, NX, NU>(ru, Q, R, M, fx, fu, Vxx, Vx, k, K, dv,
                                   piv);
    scalar_t* g = Kk + (size_t)t * NG * B;
    store_col<scalar_t, NU>(g, k, B, b);
    store_col<scalar_t, NU * NX>(g + (size_t)NU * B, K, B, b);
    cost = cost + cst;
    scalar_t ru_max = ipoc_abs(ru[0]);
#pragma unroll
    for (int i = 1; i < NU; ++i) ru_max = ipoc_max(ru_max, ipoc_abs(ru[i]));
    hu = ipoc_max(hu, ru_max);
#pragma unroll
    for (int i = 0; i < NX; ++i) lam[i] = lam_new[i];
  }
  cost_o[b] = cost;
  dv_o[b] = dv;
  piv_o[b] = piv;
  hu_o[b] = hu;
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
  fused_bwd_kernel<Model, scalar_t><<<fused_blocks(B), kFusedThreads, 0, s>>>(
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

// Every entry point of one model's library; the merged trial's and the mega
// kernel's are defined in mega.cuh, which the generated source includes
// after this header.
#define IPOC_FUSED_ENTRY_POINTS(MODEL)                                 \
  IPOC_FUSED_ENTRY(ipoc_fused_bwd, launch_fused_bwd, MODEL)            \
  IPOC_FUSED_ENTRY(ipoc_fused_fwd, launch_fused_fwd, MODEL)            \
  IPOC_FUSED_ENTRY(ipoc_rollout, launch_rollout, MODEL)                \
  IPOC_FUSED_ENTRY(ipoc_rollout_cost, launch_rollout_cost, MODEL)      \
  IPOC_FUSED_ENTRY(ipoc_transition, launch_transition, MODEL)          \
  IPOC_MERGED_ENTRY(MODEL)                                             \
  IPOC_MEGA_ENTRY(MODEL)
