// Batched sequential Newton trial and batched costate recursion for Hopper
// (sm_90a), one thread per scenario.
//
// Replaces, from ipoc_tpu/ops/pallas/seq_newton_kernel.py:
//   * seq_trial_kernel  <- _seq_trial_kernel (seq_newton_trial_batched) and
//     its T-streamed twins _seq_bwd_stream_kernel + _seq_fwd_stream_kernel
//     (seq_newton_trial_streamed).  The TPU needed the streamed form only
//     when the horizon's stage data outgrew VMEM; here the horizon is a loop
//     inside the thread and the gains go through device memory, so one
//     kernel covers both with no horizon cap.
//   * costate_kernel    <- _costate_kernel (seq_costates_batched) and
//     _costate_stream_kernel (seq_costates_streamed), for the same reason.
//
// What bounds them on the card: bytes.  Per stage and scenario the trial's
// backward sweep reads 42 values of stage data once (ru 1, Q 16, R 1, M 4,
// fx 16, fu 4 at nx=4, nu=1): about 69 MB per trial at B=4096, T=100 in
// f32, against some 2 kflop of register arithmetic per stage.  The forward
// sweep re-reads fx, fu and the gains (25 values) and writes du and dx.  The
// costate recursion reads cx and fx (20 values per stage) and writes lam.
//
// Layout (the simplest correct one; faster layouts are later work): the
// kernels read the port's (B, T, rows) tensors as they are, so neighbouring
// threads read addresses T*rows values apart and no load is coalesced; each
// 4- or 8-byte load pulls a whole 32-byte sector, so the sweep moves several
// times the bytes it uses.  Only the gain scratch is batch-last,
// (T, (1+nx)*nu, B), written in the backward sweep and read back in
// ascending t by the forward sweep with coalesced accesses.  Blocks hold
// 32 threads so that B=4096 scenarios spread over 128 of the 132 SMs.
//
// Semantics follow the JAX kernel exactly (seq_newton_kernel.py:172-252):
// the backward step is riccati.cuh's riccati_step, shared with the fused
// kernels; ok = isfinite(piv) & (piv > 0) & isfinite(pred), dx0 = 0.
// Generic in dtype (float, double), templated on (NX, NU).

#include <cuda_runtime.h>
#include <math.h>

#include "riccati.cuh"

namespace {

using ipoc::riccati_step;

constexpr int kThreads = 32;

template <typename scalar_t, int NX, int NU>
__global__ void __launch_bounds__(kThreads)
seq_trial_kernel(const scalar_t* __restrict__ ru,  // (B, T, NU)
                 const scalar_t* __restrict__ Q,   // (B, T, NX, NX)
                 const scalar_t* __restrict__ R,   // (B, T, NU, NU), regularized
                 const scalar_t* __restrict__ M,   // (B, T, NX, NU)
                 const scalar_t* __restrict__ fx,  // (B, T, NX, NX)
                 const scalar_t* __restrict__ fu,  // (B, T, NX, NU)
                 const scalar_t* __restrict__ XT,  // (B, NX, NX)
                 scalar_t* __restrict__ gains,     // (T, (1+NX)*NU, B) scratch
                 scalar_t* __restrict__ du,        // (B, T, NU)
                 scalar_t* __restrict__ dx,        // (B, T+1, NX)
                 scalar_t* __restrict__ pred,      // (B,)
                 bool* __restrict__ ok,            // (B,)
                 int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int NG = (1 + NX) * NU;

  scalar_t Vxx[NX * NX], Vx[NX];
#pragma unroll
  for (int r = 0; r < NX * NX; ++r) Vxx[r] = XT[(size_t)b * NX * NX + r];
#pragma unroll
  for (int i = 0; i < NX; ++i) Vx[i] = scalar_t(0);
  scalar_t dv = scalar_t(0);
  scalar_t minpiv = scalar_t(INFINITY);

  for (int t = T - 1; t >= 0; --t) {
    const size_t s = (size_t)b * T + t;
    scalar_t ru_t[NU], Q_t[NX * NX], R_t[NU * NU], M_t[NX * NU];
    scalar_t fx_t[NX * NX], fu_t[NX * NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) ru_t[r] = ru[s * NU + r];
#pragma unroll
    for (int r = 0; r < NX * NX; ++r) Q_t[r] = Q[s * NX * NX + r];
#pragma unroll
    for (int r = 0; r < NU * NU; ++r) R_t[r] = R[s * NU * NU + r];
#pragma unroll
    for (int r = 0; r < NX * NU; ++r) M_t[r] = M[s * NX * NU + r];
#pragma unroll
    for (int r = 0; r < NX * NX; ++r) fx_t[r] = fx[s * NX * NX + r];
#pragma unroll
    for (int r = 0; r < NX * NU; ++r) fu_t[r] = fu[s * NX * NU + r];

    scalar_t k[NU], K[NU * NX];
    riccati_step<scalar_t, NX, NU>(ru_t, Q_t, R_t, M_t, fx_t, fu_t, Vxx, Vx,
                                   k, K, dv, minpiv);
    scalar_t* g = gains + (size_t)t * NG * B + b;
#pragma unroll
    for (int i = 0; i < NU; ++i) g[(size_t)i * B] = k[i];
#pragma unroll
    for (int r = 0; r < NU * NX; ++r) g[(size_t)(NU + r) * B] = K[r];
  }
  pred[b] = dv;
  ok[b] = isfinite(minpiv) && (minpiv > scalar_t(0)) && isfinite(dv);

  // Closed-loop deviation rollout: dx0 = 0, du = k + K dx,
  // dx+ = fx dx + fu du.
  scalar_t dxt[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    dxt[i] = scalar_t(0);
    dx[(size_t)b * (T + 1) * NX + i] = scalar_t(0);
  }
  for (int t = 0; t < T; ++t) {
    const size_t s = (size_t)b * T + t;
    const scalar_t* g = gains + (size_t)t * NG * B + b;
    scalar_t dut[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = g[(size_t)(NU + i * NX) * B] * dxt[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + g[(size_t)(NU + i * NX + j) * B] * dxt[j];
      dut[i] = g[(size_t)i * B] + acc;
      du[s * NU + i] = dut[i];
    }
    scalar_t nxt[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      scalar_t ax = fx[s * NX * NX + i * NX] * dxt[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) ax = ax + fx[s * NX * NX + i * NX + j] * dxt[j];
      scalar_t au = fu[s * NX * NU + i * NU] * dut[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) au = au + fu[s * NX * NU + i * NU + j] * dut[j];
      nxt[i] = ax + au;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dxt[i] = nxt[i];
      dx[((size_t)b * (T + 1) + t + 1) * NX + i] = nxt[i];
    }
  }
}

template <typename scalar_t, int NX>
__global__ void __launch_bounds__(kThreads)
costate_kernel(const scalar_t* __restrict__ cx,    // (B, T, NX)
               const scalar_t* __restrict__ fx,    // (B, T, NX, NX)
               const scalar_t* __restrict__ lamT,  // (B, NX)
               scalar_t* __restrict__ lam,         // (B, T+1, NX)
               int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  scalar_t l[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    l[i] = lamT[(size_t)b * NX + i];
    lam[((size_t)b * (T + 1) + T) * NX + i] = l[i];
  }
  // lam_t = cx_t + fx_t' lam_{t+1}, t = T-1 .. 0.
  for (int t = T - 1; t >= 0; --t) {
    const size_t s = (size_t)b * T + t;
    scalar_t nl[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      scalar_t acc = fx[s * NX * NX + i] * l[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + fx[s * NX * NX + j * NX + i] * l[j];
      nl[i] = cx[s * NX + i] + acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      l[i] = nl[i];
      lam[((size_t)b * (T + 1) + t) * NX + i] = nl[i];
    }
  }
}

template <typename scalar_t, int NX, int NU>
int launch_trial(const void* ru, const void* Q, const void* R, const void* M,
                 const void* fx, const void* fu, const void* XT, void* gains,
                 void* du, void* dx, void* pred, void* ok, int B, int T,
                 cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  seq_trial_kernel<scalar_t, NX, NU><<<blocks, kThreads, 0, stream>>>(
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
  const int blocks = (B + kThreads - 1) / kThreads;
  costate_kernel<scalar_t, NX><<<blocks, kThreads, 0, stream>>>(
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
  return -1;
}

template <typename scalar_t>
int dispatch_costates(int nx, const void* cx, const void* fx,
                      const void* lamT, void* lam, int B, int T,
                      cudaStream_t s) {
  if (nx == 2) return launch_costates<scalar_t, 2>(cx, fx, lamT, lam, B, T, s);
  if (nx == 3) return launch_costates<scalar_t, 3>(cx, fx, lamT, lam, B, T, s);
  if (nx == 4) return launch_costates<scalar_t, 4>(cx, fx, lamT, lam, B, T, s);
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

extern "C" int ipoc_seq_costates(int dtype, int nx, const void* cx,
                                 const void* fx, const void* lamT, void* lam,
                                 int B, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_costates<float>(nx, cx, fx, lamT, lam, B, T, s);
  if (dtype == 1) return dispatch_costates<double>(nx, cx, fx, lamT, lam, B, T, s);
  return -1;
}
