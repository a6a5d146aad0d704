// Batched sequential Newton trial and batched costate recursion for Hopper
// (sm_90a).
//
// Replaces, from ipoc_tpu/ops/pallas/seq_newton_kernel.py:
//   * seq_trial_kernel  <- _seq_trial_kernel (seq_newton_trial_batched) and
//     its T-streamed twins _seq_bwd_stream_kernel + _seq_fwd_stream_kernel
//     (seq_newton_trial_streamed).  The TPU needed the streamed form only
//     when the horizon's stage data outgrew VMEM; here the horizon is a loop
//     and the gains go through device memory, so one kernel covers both
//     with no horizon cap.
//   * costate_kernel    <- _costate_kernel (seq_costates_batched) and
//     _costate_stream_kernel (seq_costates_streamed), for the same reason.
//
// seq_trial_kernel: one warp per block, a group of G lanes per scenario
// (G = 4 at nx = 3, 4; 2 at nx = 2; 8 at nx = 6), the schedule of
// seq_trial.h (host and device; the CPU tests build it with g++).
//   What bounded the one-thread-per-scenario kernel it replaces: its loads.
//   Neighbouring threads read the (B, T, rows) inputs T * rows values apart,
//   so none was coalesced, and each stage's 42 loads (nx = 4, nu = 1) were
//   requested on the serial chain: on an H100 (700 W), pinning them to
//   stage 0 took a launch at B = 4096, T = 100 from 0.332 to 0.069 ms in
//   float32, computing the Riccati step once and reusing its gains to 0.240
//   (PERF.md section 5).
//   What the design does: each scenario's W = 4 stages of an array are one
//   contiguous run; the group copies the runs into a shared-memory ring
//   with cp.async (16 bytes a copy where the run allows it), two chunks
//   ahead of the chain, for the forward sweep's fx, fu and gains too; du and
//   dx leave through a staging slice as contiguous runs.  The chain is the
//   cooperative Riccati step of riccati_rows.h (G lanes, one row each), so
//   the card holds G warps where it held one, on G of an SM's schedulers.
//   Shared memory per block (ring 3 slots x 4 stages, staging, exchange)
//   and resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   chip_smoke.py phase 0): (4, 1) 18,560 bytes and 11 blocks in float32,
//   37,120 and 6 in float64; (3, 2) 16,256 / 13 and 32,512 / 6; (2, 1), 16
//   scenarios a block, 13,184 / 16 and 25,856 / 8; 128-146 registers, no
//   spills.  At nx = 6, nu = 2 (the planar quadrotor: 8 lanes, 4
//   scenarios) 22,400 / 44,800 bytes, under the 48 KB of static shared
//   memory; its registers and residency: chip_smoke.py phase 0.
//
// costate_kernel: one warp per block, a group of G lanes per scenario
// (G = 4 at nx = 3, 4; 2 at nx = 2; 8 at nx = 6), the schedule of costates.h (host and
// device; the CPU tests build it with g++).
//   What bounded the one-thread-per-scenario kernel it replaces: its loads.
//   It read the (B, T, rows) inputs as they are, so neighbouring threads
//   read T * NX^2 values apart, and each stage's NX^2 + NX loads were
//   requested on the serial chain: about one memory round trip a stage
//   (0.102 ms at B = 4096, T = 100 through its wrapper on an H100, 700 W,
//   against a bound of 0.0118 ms set by its bytes; PERF.md section 6).
//   What the design does: a scenario's W = 8 stages of cx and of fx are
//   one contiguous run each, copied by the group into a shared-memory
//   ring two chunks ahead of the chain; lam leaves through a staging slice
//   as contiguous runs.  The chain keeps the parent's arithmetic, one row
//   a lane, the rows handed across the group by __shfl_sync.  Shared
//   memory per block and resident blocks per SM: chip_smoke.py phase 0.
//
// Semantics follow the JAX kernel exactly (seq_newton_kernel.py:172-252):
// the backward step is riccati.cuh's riccati_step, spread over the group's
// lanes with its operations and their order kept (riccati_rows.h);
// ok = isfinite(piv) & (piv > 0) & isfinite(pred), dx0 = 0.  Generic in
// dtype (float, double), templated on (NX, NU).

#include <cuda_runtime.h>
#include <math.h>

#include "costates.h"
#include "launch_attr.cuh"
#include "seq_trial.h"

namespace {

template <typename scalar_t, int NX, int NU>
__global__ void __launch_bounds__(ipoc::kRowWarp)
seq_trial_kernel(const scalar_t* __restrict__ ru,  // (B, T, NU)
                 const scalar_t* __restrict__ Q,   // (B, T, NX, NX)
                 const scalar_t* __restrict__ R,   // (B, T, NU, NU), regularized
                 const scalar_t* __restrict__ M,   // (B, T, NX, NU)
                 const scalar_t* __restrict__ fx,  // (B, T, NX, NX)
                 const scalar_t* __restrict__ fu,  // (B, T, NX, NU)
                 const scalar_t* __restrict__ XT,  // (B, NX, NX)
                 scalar_t* __restrict__ gains,     // (B, T, (1+NX)*NU) scratch
                 scalar_t* __restrict__ du,        // (B, T, NU)
                 scalar_t* __restrict__ dx,        // (B, T+1, NX)
                 scalar_t* __restrict__ pred,      // (B,)
                 bool* __restrict__ ok,            // (B,)
                 int B, int T) {
  using Tr = ipoc::SeqTrial<scalar_t, NX, NU>;
  __shared__ __align__(16) scalar_t sh[Tr::kShared];
  const int s = static_cast<int>(threadIdx.x) / Tr::G;
  const auto sc = Tr::scenario(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok,
                               static_cast<int>(blockIdx.x) * Tr::S + s, B, T, s, sh);
  typename Tr::Lane lane;
  lane.r = static_cast<int>(threadIdx.x) % Tr::G;
  ipoc::WarpExec<typename Tr::Lane> ex{lane};
  // The forward sweep copies the gains the warp stored: order the stores
  // before those reads.
  Tr::schedule(ex, sc, [] { __threadfence_block(); });
}

template <typename scalar_t, int NX>
__global__ void __launch_bounds__(ipoc::kRowWarp)
costate_kernel(const scalar_t* __restrict__ cx,    // (B, T, NX)
               const scalar_t* __restrict__ fx,    // (B, T, NX, NX)
               const scalar_t* __restrict__ lamT,  // (B, NX)
               scalar_t* __restrict__ lam,         // (B, T+1, NX)
               int B, int T) {
  using Cs = ipoc::Costates<scalar_t, NX>;
  __shared__ __align__(16) scalar_t sh[Cs::kShared];
  const int s = static_cast<int>(threadIdx.x) / Cs::G;
  const auto sc = Cs::scenario(cx, fx, lamT, lam,
                               static_cast<int>(blockIdx.x) * Cs::S + s, B, T, s, sh);
  typename Cs::Lane lane;
  lane.r = static_cast<int>(threadIdx.x) % Cs::G;
  ipoc::WarpExec<typename Cs::Lane> ex{lane};
  Cs::schedule(ex, sc);
}

template <typename scalar_t, int NX, int NU>
int launch_trial(const void* ru, const void* Q, const void* R, const void* M,
                 const void* fx, const void* fu, const void* XT, void* gains,
                 void* du, void* dx, void* pred, void* ok, int B, int T,
                 cudaStream_t stream) {
  using Tr = ipoc::SeqTrial<scalar_t, NX, NU>;
  const int blocks = (B + Tr::S - 1) / Tr::S;
  seq_trial_kernel<scalar_t, NX, NU><<<blocks, ipoc::kRowWarp, 0, stream>>>(
      static_cast<const scalar_t*>(ru), static_cast<const scalar_t*>(Q),
      static_cast<const scalar_t*>(R), static_cast<const scalar_t*>(M),
      static_cast<const scalar_t*>(fx), static_cast<const scalar_t*>(fu),
      static_cast<const scalar_t*>(XT), static_cast<scalar_t*>(gains),
      static_cast<scalar_t*>(du), static_cast<scalar_t*>(dx),
      static_cast<scalar_t*>(pred), static_cast<bool*>(ok), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t, int NX>
int launch_costates(const void* cx, const void* fx, const void* lamT,
                    void* lam, int B, int T, cudaStream_t stream) {
  const int blocks = ipoc::Costates<scalar_t, NX>::blocks(B);
  costate_kernel<scalar_t, NX><<<blocks, ipoc::kRowWarp, 0, stream>>>(
      static_cast<const scalar_t*>(cx), static_cast<const scalar_t*>(fx),
      static_cast<const scalar_t*>(lamT), static_cast<scalar_t*>(lam), B, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int dispatch_trial(int nx, int nu, const void* ru, const void* Q,
                   const void* R, const void* M, const void* fx,
                   const void* fu, const void* XT, void* gains, void* du,
                   void* dx, void* pred, void* ok, int B, int T,
                   cudaStream_t s) {
  if (nx == 2 && nu == 1)
    return launch_trial<scalar_t, 2, 1>(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  if (nx == 4 && nu == 1)
    return launch_trial<scalar_t, 4, 1>(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  if (nx == 3 && nu == 2)
    return launch_trial<scalar_t, 3, 2>(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  if (nx == 6 && nu == 2)
    return launch_trial<scalar_t, 6, 2>(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  return -1;
}

template <typename scalar_t>
int dispatch_costates(int nx, const void* cx, const void* fx,
                      const void* lamT, void* lam, int B, int T,
                      cudaStream_t s) {
  if (nx == 2) return launch_costates<scalar_t, 2>(cx, fx, lamT, lam, B, T, s);
  if (nx == 3) return launch_costates<scalar_t, 3>(cx, fx, lamT, lam, B, T, s);
  if (nx == 4) return launch_costates<scalar_t, 4>(cx, fx, lamT, lam, B, T, s);
  if (nx == 6) return launch_costates<scalar_t, 6>(cx, fx, lamT, lam, B, T, s);
  return -1;
}

}  // namespace

// C entry points, bound with ctypes.  `dtype` is 0 for float32, 1 for
// float64.  Each returns cudaGetLastError() after the launch (0 on success)
// or -1 for an (nx, nu) with no instantiation; nothing is synchronised.
extern "C" int ipoc_seq_trial(int dtype, int nx, int nu, const void* ru,
                              const void* Q, const void* R, const void* M,
                              const void* fx, const void* fu, const void* XT,
                              void* gains, void* du, void* dx, void* pred,
                              void* ok, int B, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_trial<float>(nx, nu, ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  if (dtype == 1)
    return dispatch_trial<double>(nx, nu, ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, B, T, s);
  return -1;
}

// The card's view of one instantiation of seq_trial_kernel
// (launch_attr.cuh kernel_occupancy).
template <typename scalar_t, int NX, int NU>
int trial_occupancy(int* out) {
  return ipoc::kernel_occupancy(seq_trial_kernel<scalar_t, NX, NU>, ipoc::kRowWarp, 0,
                                ipoc::SeqTrial<scalar_t, NX, NU>::S, out);
}

template <typename scalar_t>
int dispatch_occupancy(int nx, int nu, int* out) {
  if (nx == 2 && nu == 1) return trial_occupancy<scalar_t, 2, 1>(out);
  if (nx == 4 && nu == 1) return trial_occupancy<scalar_t, 4, 1>(out);
  if (nx == 3 && nu == 2) return trial_occupancy<scalar_t, 3, 2>(out);
  if (nx == 6 && nu == 2) return trial_occupancy<scalar_t, 6, 2>(out);
  return -1;
}

extern "C" int ipoc_seq_trial_occupancy(int dtype, int nx, int nu, int* out) {
  if (dtype == 0) return dispatch_occupancy<float>(nx, nu, out);
  if (dtype == 1) return dispatch_occupancy<double>(nx, nu, out);
  return -1;
}

extern "C" int ipoc_seq_costates(int dtype, int nx, const void* cx,
                                 const void* fx, const void* lamT, void* lam,
                                 int B, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_costates<float>(nx, cx, fx, lamT, lam, B, T, s);
  if (dtype == 1) return dispatch_costates<double>(nx, cx, fx, lamT, lam, B, T, s);
  return -1;
}

// The card's view of one instantiation of costate_kernel.
template <typename scalar_t, int NX>
int costate_occupancy(int* out) {
  return ipoc::kernel_occupancy(costate_kernel<scalar_t, NX>, ipoc::kRowWarp, 0,
                                ipoc::Costates<scalar_t, NX>::S, out);
}

template <typename scalar_t>
int dispatch_costate_occupancy(int nx, int* out) {
  if (nx == 2) return costate_occupancy<scalar_t, 2>(out);
  if (nx == 3) return costate_occupancy<scalar_t, 3>(out);
  if (nx == 4) return costate_occupancy<scalar_t, 4>(out);
  if (nx == 6) return costate_occupancy<scalar_t, 6>(out);
  return -1;
}

extern "C" int ipoc_seq_costates_occupancy(int dtype, int nx, int* out) {
  if (dtype == 0) return dispatch_costate_occupancy<float>(nx, out);
  if (dtype == 1) return dispatch_costate_occupancy<double>(nx, out);
  return -1;
}
