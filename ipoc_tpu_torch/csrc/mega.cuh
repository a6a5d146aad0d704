// The resident mega kernel and the merged one-launch trial for Hopper
// (sm_90a), one thread per scenario, templated on a generated model, on the
// dtype and on the mode (Newton, or IP-DDP with DDP = true).
//
// Replaces, from ipoc_tpu/ops/pallas/:
//   * merged_trial_kernel <- fused_iter_kernel.py:1206
//     _fused_iter_merged_kernel: one trial per launch, the backward sweep
//     and then the forward sweep in the same thread, the gains through a
//     (T, (1+NX)*NU, B) scratch array.  Newton mode is fused_bwd + fused_fwd
//     in one launch; DDP mode contracts the stage data with the value
//     gradient Vx (Vx starts at the terminal gradient) and rolls the trial
//     out through the true dynamics in closed loop (the DDP evaluator of the
//     packed stream);
//   * mega_kernel <- mega_kernel.py:1148 _mega_kernel: k lane iterations
//     per launch, each the trial, the accept/Levenberg-Marquardt update, the
//     convergence tests and, for a lane that rolls over to the next barrier
//     stage, the stage transition with the central-path predictor; per-lane
//     semantics are packed_lane_iter's (solvers/packed_stream.py).
//
// Both share the trial's device code (trial_backward, trial_forward) with
// each other; the stage programs are the generated Model's and the Riccati
// step is riccati.cuh's.
//
// Layout and state: batch-last like fused_iter.cuh, stage arrays (T, rows,
// B), per-lane scalars (B,).  The mega kernel updates the lane state in
// place (xs, xT, u, u_prev and the scalars); the trial's arrays, the gains,
// the predictor's candidate states and controls live in workspace arrays
// the caller allocates once per stream.  The TPU kernel's VMEM residency
// and its parking of the candidate in the dead gains ring have no
// counterpart: a thread keeps its carries in registers and writes the
// transition's plain candidate straight into xs.  A thread runs its lane
// until the lane is done or k iterations have passed, so lanes leave the
// loop independently (the TPU kernel skips an iteration only when a whole
// chunk is done; the per-lane results are the same).  An inactive lane
// (active = 0) is not touched.  `steps` is the maximum over lanes of the
// iterations each ran (one atomicMax), which is the number of iterations
// in which some active lane was not done.
//
// What bounds them on the card: latency, as for fused_iter.cuh.  At B=4096
// a launch is 128 warps, about one per SM, each thread a serial chain of
// 2T dependent stages per iteration and 3T more when it rolls over; the
// per-iteration launches, host glue and predicate reads of the two-launch
// stream (PERF.md section 5) are what the mega kernel removes.  Lanes of a
// warp that finish early idle until the warp's slowest lane is done.  A
// later performance PR could run several lanes per thread, stage through
// shared memory, or split a lane's rows over a warp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_iter.cuh"
#include "riccati.cuh"
#include "scalar_math.h"

namespace ipoc {

// The SolverConfig scalars the lane iteration reads, passed at launch (never
// baked into the generated source, which is cached per model).  Doubles,
// cast to scalar_t where used, as torch casts a Python float against a
// float32 tensor.
struct LaneScalars {
  double tol, stage_tol_scale, pred_floor, reg_min, reg_max, bp_decay, bp_min,
      reg_scale_floor, stage_reg, reg_inc_init;
  int max_newton_iters, stall_exit, stage_predictor, scale_reg_by_grad;
};
constexpr int kLaneScalars = 14;  // doubles in the C entry's array

// Backward sweep of one trial for lane b: the gains [k | K] to Kk, the
// iterate's barrier cost, the predicted reduction dv, the minimum pivot and
// max_t |ru_t| (the Hamiltonian's control gradient; DDP: Qu).
template <typename Model, typename scalar_t, bool DDP>
__device__ __forceinline__ void trial_backward(
    const scalar_t* __restrict__ xs, const scalar_t* __restrict__ us,
    const scalar_t* xT, scalar_t bpv, scalar_t regv,
    scalar_t* __restrict__ Kk, int B, int T, int b, scalar_t& cost,
    scalar_t& dv, scalar_t& piv, scalar_t& hu) {
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  scalar_t lam[NX], Vxx[NX * NX], Vx[NX];
  Model::template term<scalar_t>(xT, lam, Vxx, &cost);
  // Newton splits the value gradient between the costates and the
  // deviation recursion (Vx_T = 0); DDP carries the whole Vx.
#pragma unroll
  for (int i = 0; i < NX; ++i) Vx[i] = DDP ? lam[i] : scalar_t(0);
  dv = scalar_t(0);
  piv = scalar_t(INFINITY);
  hu = scalar_t(0);
  for (int t = T - 1; t >= 0; --t) {
    scalar_t x[NX], u[NU];
    load_col<scalar_t, NX>(x, xs + (size_t)t * NX * B, B, b);
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    scalar_t ru[NU], Q[NX * NX], R[NU * NU], M[NX * NU], fx[NX * NX],
        fu[NX * NU], lam_new[NX], cst;
    Model::template stage_bwd<scalar_t>(x, u, &bpv, DDP ? Vx : lam, ru, Q, R,
                                        M, fx, fu, lam_new, &cst);
#pragma unroll
    for (int i = 0; i < NU; ++i) R[i * (NU + 1)] = R[i * (NU + 1)] + regv;
    scalar_t k[NU], K[NU * NX];
    riccati_step<scalar_t, NX, NU, DDP>(ru, Q, R, M, fx, fu, Vxx, Vx, k, K,
                                        dv, piv, lam_new);
    scalar_t* g = Kk + (size_t)t * NG * B;
    store_col<scalar_t, NU>(g, k, B, b);
    store_col<scalar_t, NU * NX>(g + (size_t)NU * B, K, B, b);
    cost = cost + cst;
    scalar_t ru_max = ipoc_abs(ru[0]);
#pragma unroll
    for (int i = 1; i < NU; ++i) ru_max = ipoc_max(ru_max, ipoc_abs(ru[i]));
    hu = ipoc_max(hu, ru_max);
    if constexpr (!DDP) {
#pragma unroll
      for (int i = 0; i < NX; ++i) lam[i] = lam_new[i];
    }
  }
}

// Forward sweep of one trial for lane b: the trial point to (tu_o, tx_o,
// txT), its barrier cost nc, maximum constraint value mc and sum ||cu||^2.
// Newton carries the deviation dx from 0; DDP carries the trial state
// itself from x0 (the nonlinear closed-loop re-rollout).
template <typename Model, typename scalar_t, bool DDP>
__device__ __forceinline__ void trial_forward(
    const scalar_t* __restrict__ xs, const scalar_t* __restrict__ us,
    const scalar_t* xT, const scalar_t* x0, scalar_t bpv,
    const scalar_t* __restrict__ Kk, scalar_t* __restrict__ tu_o,
    scalar_t* __restrict__ tx_o, int B, int T, int b, scalar_t* txT,
    scalar_t& nc, scalar_t& mc, scalar_t& cun) {
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  scalar_t d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = DDP ? x0[i] : scalar_t(0);
  nc = scalar_t(0);
  mc = -scalar_t(INFINITY);
  cun = scalar_t(0);
  for (int t = 0; t < T; ++t) {
    scalar_t x[NX], u[NU], g[NG];
    load_col<scalar_t, NX>(x, xs + (size_t)t * NX * B, B, b);
    load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
    load_col<scalar_t, NG>(g, Kk + (size_t)t * NG * B, B, b);
    scalar_t tu[NU], tx[NX], dn[NX], cst, cmax, cusq;
    if constexpr (DDP) {
      Model::template stage_ddp_fwd<scalar_t>(x, u, &bpv, d, g, tu, tx, dn,
                                              &cst, &cmax, &cusq);
    } else {
      Model::template stage_fwd<scalar_t>(x, u, &bpv, d, g, tu, tx, dn, &cst,
                                          &cmax, &cusq);
    }
    store_col<scalar_t, NU>(tu_o + (size_t)t * NU * B, tu, B, b);
    store_col<scalar_t, NX>(tx_o + (size_t)t * NX * B, tx, B, b);
    nc = nc + cst;
    mc = ipoc_max(mc, cmax);
    cun = cun + cusq;
#pragma unroll
    for (int i = 0; i < NX; ++i) d[i] = dn[i];
  }
  scalar_t cT;
  if constexpr (DDP) {
    Model::template term_ddp_fwd<scalar_t>(xT, d, txT, &cT);
  } else {
    Model::template term_fwd<scalar_t>(xT, d, txT, &cT);
  }
  nc = nc + cT;
}

// Copy lane b's column of a (T, N, B) array.
template <typename scalar_t, int N>
__device__ __forceinline__ void copy_stages(scalar_t* __restrict__ dst,
                                            const scalar_t* __restrict__ src,
                                            int B, int T, int b) {
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const size_t at = ((size_t)t * N + i) * B + b;
      dst[at] = src[at];
    }
  }
}

template <typename Model, typename scalar_t, bool DDP>
__global__ void __launch_bounds__(kFusedThreads)
merged_trial_kernel(const scalar_t* __restrict__ xs,   // (T, NX, B)
                    const scalar_t* __restrict__ us,   // (T, NU, B)
                    const scalar_t* __restrict__ xT,   // (NX, B)
                    const scalar_t* __restrict__ bp,   // (B,)
                    const scalar_t* __restrict__ reg,  // (B,) pre-scaled
                    scalar_t* __restrict__ tu_o,       // (T, NU, B)
                    scalar_t* __restrict__ tx_o,       // (T, NX, B)
                    scalar_t* __restrict__ txT_o,      // (NX, B)
                    scalar_t* __restrict__ cost_o,     // (B,)
                    scalar_t* __restrict__ nc_o,       // (B,)
                    scalar_t* __restrict__ mc_o,       // (B,)
                    scalar_t* __restrict__ dv_o,       // (B,)
                    scalar_t* __restrict__ piv_o,      // (B,)
                    scalar_t* __restrict__ hu_o,       // (B,)
                    scalar_t* __restrict__ cun_o,      // (B,)
                    scalar_t* __restrict__ Kk,         // (T, (1+NX)*NU, B) scratch
                    int B, int T) {
  constexpr int NX = Model::NX;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const scalar_t bpv = bp[b];
  scalar_t xTv[NX], x0[NX], txT[NX];
  load_col<scalar_t, NX>(xTv, xT, B, b);
  load_col<scalar_t, NX>(x0, xs, B, b);  // stage 0: the DDP carry's start
  scalar_t cost, dv, piv, hu, nc, mc, cun;
  trial_backward<Model, scalar_t, DDP>(xs, us, xTv, bpv, reg[b], Kk, B, T, b,
                                       cost, dv, piv, hu);
  trial_forward<Model, scalar_t, DDP>(xs, us, xTv, x0, bpv, Kk, tu_o, tx_o,
                                      B, T, b, txT, nc, mc, cun);
  store_col<scalar_t, NX>(txT_o, txT, B, b);
  cost_o[b] = cost;
  nc_o[b] = nc;
  mc_o[b] = mc;
  dv_o[b] = dv;
  piv_o[b] = piv;
  hu_o[b] = hu;
  cun_o[b] = cun;
}

template <typename Model, typename scalar_t, bool DDP>
__global__ void __launch_bounds__(kFusedThreads)
mega_kernel(scalar_t* __restrict__ xs,            // (T, NX, B) in place
            scalar_t* __restrict__ xT,            // (NX, B) in place
            scalar_t* __restrict__ us,            // (T, NU, B) in place
            scalar_t* __restrict__ ups,           // (T, NU, B) u_prev, in place
            scalar_t* __restrict__ cun_io,        // (B,) ||cu||_F
            int* __restrict__ it_io,              // (B,)
            int* __restrict__ sit_io,             // (B,) stage iterations
            scalar_t* __restrict__ rp_io,         // (B,)
            scalar_t* __restrict__ ri_io,         // (B,) LM growth factor
            scalar_t* __restrict__ bp_io,         // (B,)
            unsigned char* __restrict__ done_io,  // (B,) bool
            const scalar_t* __restrict__ x0,      // (NX, B)
            const scalar_t* __restrict__ bp0,     // (B,)
            const unsigned char* __restrict__ active,  // (B,) bool
            int* __restrict__ steps,              // (1,) zeroed by the caller
            scalar_t* __restrict__ tx,            // workspace (T, NX, B)
            scalar_t* __restrict__ tu,            // workspace (T, NU, B)
            scalar_t* __restrict__ Kk,            // workspace (T, NG, B)
            scalar_t* __restrict__ xb,            // workspace (T, NX, B)
            scalar_t* __restrict__ upred,         // workspace (T, NU, B)
            LaneScalars c, int k, int B, int T) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || !active[b] || done_io[b]) return;

  scalar_t xTv[NX], x0v[NX];
  load_col<scalar_t, NX>(xTv, xT, B, b);
  load_col<scalar_t, NX>(x0v, x0, B, b);
  scalar_t cun = cun_io[b], rp = rp_io[b], ri = ri_io[b], bp = bp_io[b];
  const scalar_t bp0v = bp0[b];
  int it = it_io[b], sit = sit_io[b];
  bool done = false;
  const scalar_t inf = scalar_t(INFINITY);
  const scalar_t gamma = scalar_t(1.0 / c.bp_decay);

  int n = 0;
  for (; n < k && !done; ++n) {
    // --- the trial --------------------------------------------------------
    // DDP scales the Levenberg parameter by ||cu|| unconditionally.
    const scalar_t reg = (DDP || c.scale_reg_by_grad)
                             ? rp * ipoc_max(cun, scalar_t(c.reg_scale_floor))
                             : rp;
    scalar_t cost, dv, piv, hu, nc, mc, cun_t, txT[NX];
    trial_backward<Model, scalar_t, DDP>(xs, us, xTv, bp, reg, Kk, B, T, b,
                                         cost, dv, piv, hu);
    trial_forward<Model, scalar_t, DDP>(xs, us, xTv, x0v, bp, Kk, tu, tx, B,
                                        T, b, txT, nc, mc, cun_t);

    // --- accept and the Marquardt-Nielsen update --------------------------
    const bool ok = isfinite(piv) && piv > scalar_t(0) && isfinite(dv);
    const scalar_t new_cost = mc <= scalar_t(0) ? nc : inf;
    const scalar_t rho = (new_cost - cost) / dv;
    const bool accept = rho > scalar_t(0) && ok;
    const bool stalled =
        !accept && rp >= scalar_t(c.reg_max) && c.stall_exit != 0;
    if (accept) {
      const scalar_t s = scalar_t(2) * rho - scalar_t(1);
      rp = rp * ipoc_max(scalar_t(1) - s * s * s, scalar_t(1.0 / 3.0));
      ri = scalar_t(2);
    } else {
      rp = rp * ri;
      ri = scalar_t(2) * ri;
    }
    rp = ipoc_min(ipoc_max(rp, scalar_t(c.reg_min)), scalar_t(c.reg_max));
    if (accept) {
      copy_stages<scalar_t, NX>(xs, tx, B, T, b);
      copy_stages<scalar_t, NU>(us, tu, B, T, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) xTv[i] = txT[i];
      cun = ipoc_sqrt(cun_t);
    }

    // --- convergence and stage bookkeeping ---------------------------------
    const scalar_t tol_s = ipoc_max(scalar_t(c.stage_tol_scale) * bp,
                                    scalar_t(c.tol));
    bool conv = hu < tol_s;
    if (c.pred_floor > 0.0) {
      conv = conv || (ok && ipoc_abs(dv) < scalar_t(c.pred_floor) *
                                               (scalar_t(1) + ipoc_abs(cost)));
    }
    const bool bad = !isfinite(hu) || !isfinite(cost);
    const bool advance =
        (conv || stalled || sit + 1 > c.max_newton_iters) && !bad;
    const scalar_t bp_next = bp / scalar_t(c.bp_decay);
    const bool done_now = bad || (advance && bp_next <= scalar_t(c.bp_min));
    const bool roll = advance && !done_now;

    // --- the stage transition, only for a lane that rolls over -------------
    // u_prev <- u (after the accept); candidate a re-rolls u at the new bp
    // straight into xs, candidate b the prediction u + (u - u_prev_old) /
    // bp_decay into the workspace; b is taken when the lane is past its
    // first stage and b's barrier cost is lower (a NaN loses).
    if (roll) {
      scalar_t xa[NX], xbs[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xa[i] = xbs[i] = x0v[i];
      scalar_t ca = scalar_t(0), cb = scalar_t(0), cua = scalar_t(0),
               cub = scalar_t(0);
      for (int t = 0; t < T; ++t) {
        scalar_t u[NU], up[NU], xan[NX], csta, cusqa;
        load_col<scalar_t, NU>(u, us + (size_t)t * NU * B, B, b);
        store_col<scalar_t, NX>(xs + (size_t)t * NX * B, xa, B, b);
        if (c.stage_predictor) {
          load_col<scalar_t, NU>(up, ups + (size_t)t * NU * B, B, b);
#pragma unroll
          for (int i = 0; i < NU; ++i) up[i] = u[i] + gamma * (u[i] - up[i]);
          store_col<scalar_t, NU>(upred + (size_t)t * NU * B, up, B, b);
          store_col<scalar_t, NX>(xb + (size_t)t * NX * B, xbs, B, b);
          scalar_t xbn[NX], cstb, cusqb;
          Model::template transition<scalar_t>(xa, xbs, u, up, &bp_next, xan,
                                               xbn, &csta, &cstb, &cusqa,
                                               &cusqb);
          cb = cb + cstb;
          cub = cub + cusqb;
#pragma unroll
          for (int i = 0; i < NX; ++i) xbs[i] = xbn[i];
        } else {
          Model::template roll_cost<scalar_t>(xa, u, &bp_next, xan, &csta,
                                              &cusqa);
        }
        store_col<scalar_t, NU>(ups + (size_t)t * NU * B, u, B, b);
        ca = ca + csta;
        cua = cua + cusqa;
#pragma unroll
        for (int i = 0; i < NX; ++i) xa[i] = xan[i];
      }
      scalar_t cTa;
      Model::template final_cost<scalar_t>(xa, &cTa);
      ca = ca + cTa;
      bool take = false;
      if (c.stage_predictor) {
        scalar_t cTb;
        Model::template final_cost<scalar_t>(xbs, &cTb);
        cb = cb + cTb;
        take = bp < bp0v && cb < ca;
      }
      if (take) {
        copy_stages<scalar_t, NX>(xs, xb, B, T, b);
        copy_stages<scalar_t, NU>(us, upred, B, T, b);
#pragma unroll
        for (int i = 0; i < NX; ++i) xTv[i] = xbs[i];
        cun = ipoc_sqrt(cub);
      } else {
#pragma unroll
        for (int i = 0; i < NX; ++i) xTv[i] = xa[i];
        cun = ipoc_sqrt(cua);
      }
    }
    if (advance) {
      bp = bp_next;
      rp = scalar_t(c.stage_reg);
      ri = scalar_t(c.reg_inc_init);
      sit = 0;
    } else {
      sit = sit + 1;
    }
    it = it + 1;
    done = done_now;
  }

  store_col<scalar_t, NX>(xT, xTv, B, b);
  cun_io[b] = cun;
  rp_io[b] = rp;
  ri_io[b] = ri;
  bp_io[b] = bp;
  it_io[b] = it;
  sit_io[b] = sit;
  done_io[b] = done ? 1 : 0;
  if (n > 0) atomicMax(steps, n);
}

template <typename Model, typename scalar_t, bool DDP>
int launch_merged_trial(const void* const* in, void* const* out, int B, int T,
                        cudaStream_t s) {
  using P = const scalar_t*;
  auto o = [out](int i) { return static_cast<scalar_t*>(out[i]); };
  merged_trial_kernel<Model, scalar_t, DDP>
      <<<fused_blocks(B), kFusedThreads, 0, s>>>(
          P(in[0]), P(in[1]), P(in[2]), P(in[3]), P(in[4]), o(0), o(1), o(2),
          o(3), o(4), o(5), o(6), o(7), o(8), o(9), o(10), B, T);
  return static_cast<int>(cudaGetLastError());
}

// lane: xs, xT, u, u_prev, cun, it, stage_it, rp, r_inc, bp, done, x0, bp0,
// active, steps; ws: tx, tu, Kk, xb, upred; cfg: kLaneScalars doubles in
// LaneScalars order (the four ints last).
template <typename Model, typename scalar_t, bool DDP>
int launch_mega(void* const* lane, void* const* ws, const double* cfg, int k,
                int B, int T, cudaStream_t s) {
  LaneScalars c;
  c.tol = cfg[0];
  c.stage_tol_scale = cfg[1];
  c.pred_floor = cfg[2];
  c.reg_min = cfg[3];
  c.reg_max = cfg[4];
  c.bp_decay = cfg[5];
  c.bp_min = cfg[6];
  c.reg_scale_floor = cfg[7];
  c.stage_reg = cfg[8];
  c.reg_inc_init = cfg[9];
  c.max_newton_iters = static_cast<int>(cfg[10]);
  c.stall_exit = static_cast<int>(cfg[11]);
  c.stage_predictor = static_cast<int>(cfg[12]);
  c.scale_reg_by_grad = static_cast<int>(cfg[13]);
  auto f = [lane](int i) { return static_cast<scalar_t*>(lane[i]); };
  auto w = [ws](int i) { return static_cast<scalar_t*>(ws[i]); };
  auto i32 = [lane](int i) { return static_cast<int*>(lane[i]); };
  auto u8 = [lane](int i) { return static_cast<unsigned char*>(lane[i]); };
  mega_kernel<Model, scalar_t, DDP><<<fused_blocks(B), kFusedThreads, 0, s>>>(
      f(0), f(1), f(2), f(3), f(4), i32(5), i32(6), f(7), f(8), f(9), u8(10),
      f(11), f(12), u8(13), i32(14), w(0), w(1), w(2), w(3), w(4), c, k, B,
      T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipoc

// The C entry points of the two kernels (added to the model library by
// IPOC_FUSED_ENTRY_POINTS): `dtype` (0 float32, 1 float64) and `ddp` (0
// Newton, 1 DDP) first; they return cudaGetLastError() after the launch, or
// -1 for an unknown dtype.  Nothing is synchronised.
#define IPOC_MODE_DISPATCH(LAUNCH, MODEL, ...)                               \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
  if (dtype == 0 && ddp) return ipoc::LAUNCH<MODEL, float, true>(__VA_ARGS__); \
  if (dtype == 0) return ipoc::LAUNCH<MODEL, float, false>(__VA_ARGS__);     \
  if (dtype == 1 && ddp) return ipoc::LAUNCH<MODEL, double, true>(__VA_ARGS__);\
  if (dtype == 1) return ipoc::LAUNCH<MODEL, double, false>(__VA_ARGS__);    \
  return -1;

#define IPOC_MERGED_ENTRY(MODEL)                                              \
  extern "C" int ipoc_merged_trial(int dtype, int ddp, const void* const* in, \
                                   void* const* out, int B, int T,           \
                                   void* stream) {                           \
    IPOC_MODE_DISPATCH(launch_merged_trial, MODEL, in, out, B, T, s)         \
  }

#define IPOC_MEGA_ENTRY(MODEL)                                               \
  extern "C" int ipoc_mega(int dtype, int ddp, void* const* lane,            \
                           void* const* ws, const double* cfg, int k, int B, \
                           int T, void* stream) {                            \
    IPOC_MODE_DISPATCH(launch_mega, MODEL, lane, ws, cfg, k, B, T, s)        \
  }
