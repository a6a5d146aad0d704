// The parallel-in-time kernels for Hopper (sm_90a): the affine scan, the
// value scan and the one-launch parallel Newton trial.
//
// Replaces, from ipoc_tpu/ops/pallas/:
//   * affine_scan_kernel      <- scan_kernels.py _affine_kernel (launched at
//     scan_kernels.py:252 through pallas_affine_scan): inclusive suffix
//     (earlier o later, the costates) or prefix (later o earlier, the LQT
//     forward pass) scan of affine maps (F, c).
//   * value_scan_kernel       <- scan_kernels.py _value_kernel: suffix scan
//     of the LQT's conditional-value elements (A, b, C, eta, J).
//   * par_newton_trial_kernel <- newton_kernel.py _fused_kernel (launched at
//     newton_kernel.py:229 through scan_kernels.py:252): one whole parallel
//     LQT Newton trial per scenario.
//
// Design.  The TPU kernels laid the horizon along the 128 lanes, padded to
// a multiple of 128, and ran ceil(log2 Tp) Hillis-Steele rounds over the
// whole horizon.  Here one block of kScanThreads = 128 threads takes one
// scenario (the grid is B blocks) and each thread a contiguous chunk of
// ceil(T / 128) stages: the thread combines its chunk serially in
// registers, the block scans the 128 chunk aggregates in shared memory
// (scan.cuh block_carry), and the thread walks its chunk again from the
// carried-in aggregate.  No horizon cap: only the chunk grows with T.
//
// What bounds them on the card: at the slice's sizes neither bytes nor the
// card's flop rate but latency.  A value combine is about 1,800 flops at
// nx=4 in dependent chains (eliminations); the trial's critical path is
// about 2 * ceil(T/128) + 7 combines per phase, and one scenario (B=1, the
// single solve) fills one SM of 132.  Stage data are read twice (both
// walks) from the port's (B, T, rows) tensors, so neighbouring threads read
// addresses a chunk apart and loads are not coalesced; the gains go through
// a (B, T, nu*(1+nx)) scratch that each thread writes and reads back
// itself.  The shared memory holds two buffers of 128 aggregates (the
// Hillis-Steele rounds read one and write the other): 114,688 bytes for a
// float64 value element at nx=4, set through cudaFuncSetAttribute.
//
// Generic in dtype (float, double); templated on n and on (NX, NU).

#include <cuda_runtime.h>
#include <math.h>

#include "riccati.cuh"
#include "scan.cuh"

namespace {

using ipoc::AffineOp;
using ipoc::block_carry;
using ipoc::copy_elem;
using ipoc::kScanThreads;
using ipoc::nan_min;
using ipoc::solve_track;
using ipoc::thread_chunk;
using ipoc::ValueOp;

template <typename scalar_t, int N, bool REVERSE>
__global__ void __launch_bounds__(kScanThreads)
affine_scan_kernel(const scalar_t* __restrict__ F,  // (B, T, N, N)
                   const scalar_t* __restrict__ c,  // (B, T, N)
                   scalar_t* __restrict__ Fo,       // (B, T, N, N)
                   scalar_t* __restrict__ co,       // (B, T, N)
                   int T) {
  using Op = AffineOp<scalar_t, N>;
  constexpr int E = Op::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* buf = reinterpret_cast<scalar_t*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * T;
  int t0, t1;
  thread_chunk(T, t0, t1);
  const int len = t1 - t0;

  auto load = [&](int t, scalar_t* e) {
#pragma unroll
    for (int r = 0; r < N * N; ++r) e[r] = F[(base + t) * N * N + r];
#pragma unroll
    for (int r = 0; r < N; ++r) e[N * N + r] = c[(base + t) * N + r];
  };

  // 1. This chunk's aggregate, walking in the scan's direction.
  scalar_t agg[E];
  Op::identity(agg);
  for (int s = 0; s < len; ++s) {
    const int t = REVERSE ? t1 - 1 - s : t0 + s;
    scalar_t e[E], nxt[E];
    load(t, e);
    if (s == 0) {
      copy_elem<scalar_t, E>(e, agg);
    } else {
      Op::combine(e, agg, nxt);
      copy_elem<scalar_t, E>(nxt, agg);
    }
  }
  // 2. The block's scan of the aggregates.
  scalar_t run[E];
  bool have = block_carry<Op, scalar_t, REVERSE>(agg, buf, run);
  // 3. The chunk again from the carried-in aggregate.
  for (int s = 0; s < len; ++s) {
    const int t = REVERSE ? t1 - 1 - s : t0 + s;
    scalar_t e[E], nxt[E];
    load(t, e);
    if (have) {
      Op::combine(e, run, nxt);
      copy_elem<scalar_t, E>(nxt, run);
    } else {
      copy_elem<scalar_t, E>(e, run);
      have = true;
    }
#pragma unroll
    for (int r = 0; r < N * N; ++r) Fo[(base + t) * N * N + r] = run[r];
#pragma unroll
    for (int r = 0; r < N; ++r) co[(base + t) * N + r] = run[N * N + r];
  }
}

template <typename scalar_t, int N>
__global__ void __launch_bounds__(kScanThreads)
value_scan_kernel(const scalar_t* __restrict__ A,    // (B, T, N, N)
                  const scalar_t* __restrict__ b,    // (B, T, N)
                  const scalar_t* __restrict__ C,    // (B, T, N, N)
                  const scalar_t* __restrict__ eta,  // (B, T, N)
                  const scalar_t* __restrict__ J,    // (B, T, N, N)
                  scalar_t* __restrict__ Ao, scalar_t* __restrict__ bo,
                  scalar_t* __restrict__ Co, scalar_t* __restrict__ etao,
                  scalar_t* __restrict__ Jo, int T) {
  using Op = ValueOp<scalar_t, N>;
  constexpr int E = Op::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* buf = reinterpret_cast<scalar_t*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * T;
  int t0, t1;
  thread_chunk(T, t0, t1);
  const int len = t1 - t0;

  auto load = [&](int t, scalar_t* e) {
    const size_t m = (base + t) * N * N, v = (base + t) * N;
#pragma unroll
    for (int r = 0; r < N * N; ++r) {
      e[Op::kA + r] = A[m + r];
      e[Op::kC + r] = C[m + r];
      e[Op::kJ + r] = J[m + r];
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      e[Op::kB + r] = b[v + r];
      e[Op::kEta + r] = eta[v + r];
    }
  };

  // 1. This chunk's aggregate (a suffix scan: walk backward).
  scalar_t agg[E];
  Op::identity(agg);
  for (int s = 0; s < len; ++s) {
    scalar_t e[E], nxt[E];
    load(t1 - 1 - s, e);
    if (s == 0) {
      copy_elem<scalar_t, E>(e, agg);
    } else {
      Op::combine(e, agg, nxt);
      copy_elem<scalar_t, E>(nxt, agg);
    }
  }
  // 2. The block's scan of the aggregates.
  scalar_t run[E];
  bool have = block_carry<Op, scalar_t, true>(agg, buf, run);
  // 3. The chunk again from the carried-in aggregate.
  for (int s = 0; s < len; ++s) {
    const int t = t1 - 1 - s;
    scalar_t e[E], nxt[E];
    load(t, e);
    if (have) {
      Op::combine(e, run, nxt);
      copy_elem<scalar_t, E>(nxt, run);
    } else {
      copy_elem<scalar_t, E>(e, run);
      have = true;
    }
    const size_t m = (base + t) * N * N, v = (base + t) * N;
#pragma unroll
    for (int r = 0; r < N * N; ++r) {
      Ao[m + r] = run[Op::kA + r];
      Co[m + r] = run[Op::kC + r];
      Jo[m + r] = run[Op::kJ + r];
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      bo[v + r] = run[Op::kB + r];
      etao[v + r] = run[Op::kEta + r];
    }
  }
}

// One stage's Newton data, read from the (B, T, rows) inputs.
template <typename scalar_t, int NX, int NU>
struct StageData {
  scalar_t ru[NU], Q[NX * NX], R[NU * NU], M[NX * NU], fx[NX * NX],
      fu[NX * NU];
};

template <typename scalar_t, int NX, int NU>
__device__ __forceinline__ void load_stage(
    const scalar_t* ru, const scalar_t* Q, const scalar_t* R,
    const scalar_t* M, const scalar_t* fx, const scalar_t* fu, size_t s,
    StageData<scalar_t, NX, NU>& st) {
#pragma unroll
  for (int r = 0; r < NU; ++r) st.ru[r] = ru[s * NU + r];
#pragma unroll
  for (int r = 0; r < NX * NX; ++r) {
    st.Q[r] = Q[s * NX * NX + r];
    st.fx[r] = fx[s * NX * NX + r];
  }
#pragma unroll
  for (int r = 0; r < NU * NU; ++r) st.R[r] = R[s * NU * NU + r];
#pragma unroll
  for (int r = 0; r < NX * NU; ++r) {
    st.M[r] = M[s * NX * NU + r];
    st.fu[r] = fu[s * NX * NU + r];
  }
}

// The reference trick and the stage's value element (newton_kernel.py
// steps 1-2; H = Z = I, c = 0): s = -(R - M'Q^-1 M)^-1 ru, r = -Q^-1 M s,
// then A = fx - fu R^-1 M', b = fu (s + R^-1 M' r), C = fu R^-1 fu',
// eta = Xtil r, J = Xtil = Q - M R^-1 M'.  Also the minimum pivot of R.
template <typename scalar_t, int NX, int NU>
__device__ __forceinline__ void stage_element(
    const StageData<scalar_t, NX, NU>& st, scalar_t* e, scalar_t* sv,
    scalar_t* rv, scalar_t& piv_u) {
  using Op = ValueOp<scalar_t, NX>;
  // Q^-1 M (the Q and Schur pivots are not part of ok).
  scalar_t a[NX * NX], QinvM[NX * NU];
  copy_elem<scalar_t, NX * NX>(st.Q, a);
  copy_elem<scalar_t, NX * NU>(st.M, QinvM);
  solve_track<scalar_t, NX, NU>(a, QinvM);
  scalar_t schur[NU * NU], sn[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.M[i] * QinvM[j];  // (M')[i][0] * QinvM[0][j]
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.M[l * NU + i] * QinvM[l * NU + j];
      schur[i * NU + j] = st.R[i * NU + j] - acc;
    }
    sn[i] = st.ru[i];
  }
  solve_track<scalar_t, NU, 1>(schur, sn);
#pragma unroll
  for (int i = 0; i < NU; ++i) sv[i] = -sn[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    scalar_t acc = QinvM[i * NU] * sv[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc = acc + QinvM[i * NU + j] * sv[j];
    rv[i] = -acc;
  }
  // R^-1, its minimum pivot, and R^-1 M' (NU x NX).
  scalar_t aR[NU * NU], Uinv[NU * NU];
#pragma unroll
  for (int r = 0; r < NU * NU; ++r) {
    aR[r] = st.R[r];
    Uinv[r] = (r / NU == r % NU) ? scalar_t(1) : scalar_t(0);
  }
  piv_u = solve_track<scalar_t, NU, NU>(aR, Uinv);
  scalar_t UMt[NU * NX];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = Uinv[i * NU] * st.M[j * NU];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + Uinv[i * NU + l] * st.M[j * NU + l];
      UMt[i * NX + j] = acc;
    }
  }
  // A = fx - fu UMt;  J = Xtil = Q - M UMt;  C = (fu Uinv) fu'.
  scalar_t fuU[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t a1 = st.fu[i * NU] * UMt[j];
      scalar_t a2 = st.M[i * NU] * UMt[j];
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        a1 = a1 + st.fu[i * NU + l] * UMt[l * NX + j];
        a2 = a2 + st.M[i * NU + l] * UMt[l * NX + j];
      }
      e[Op::kA + i * NX + j] = st.fx[i * NX + j] - a1;
      e[Op::kJ + i * NX + j] = st.Q[i * NX + j] - a2;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.fu[i * NU] * Uinv[j];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + st.fu[i * NU + l] * Uinv[l * NU + j];
      fuU[i * NU + j] = acc;
    }
  }
  // w = s + UMt r;  b = fu w;  eta = Xtil r.
  scalar_t w[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    scalar_t acc = UMt[i * NX] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) acc = acc + UMt[i * NX + l] * rv[l];
    w[i] = sv[i] + acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    scalar_t acc = st.fu[i * NU] * w[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + st.fu[i * NU + l] * w[l];
    e[Op::kB + i] = acc;
    scalar_t a2 = e[Op::kJ + i * NX] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) a2 = a2 + e[Op::kJ + i * NX + l] * rv[l];
    e[Op::kEta + i] = a2;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t a3 = fuU[i * NU] * st.fu[j * NU];
#pragma unroll
      for (int l = 1; l < NU; ++l) a3 = a3 + fuU[i * NU + l] * st.fu[j * NU + l];
      e[Op::kC + i * NX + j] = a3;
    }
  }
}

// The stage gains from the next stage's value (S', v') (newton_kernel.py
// step 5): Quu = R + fu' S' fu, Qxu = M + fx' S' fu, qu = -R s - M' r -
// fu' v'; one elimination of Quu [d | K] = [-qu | Qxu'] with the RHS
// interleaved row-major (NU, 1+NX); dV = d'qu + 1/2 d'Quu d.  Returns
// Quu's minimum pivot.
template <typename scalar_t, int NX, int NU>
__device__ __forceinline__ scalar_t stage_gains(
    const StageData<scalar_t, NX, NU>& st, const scalar_t* sv,
    const scalar_t* rv, const scalar_t* Sn, const scalar_t* vn, scalar_t* KD,
    scalar_t& dV) {
  constexpr int MC = 1 + NX;
  scalar_t Sfu[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = Sn[i * NX] * st.fu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + Sn[i * NX + l] * st.fu[l * NU + j];
      Sfu[i * NU + j] = acc;
    }
  }
  scalar_t Quu[NU * NU], a[NU * NU], qu[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.fu[i] * Sfu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.fu[l * NU + i] * Sfu[l * NU + j];
      Quu[i * NU + j] = st.R[i * NU + j] + acc;
      a[i * NU + j] = Quu[i * NU + j];
    }
    scalar_t rs = st.R[i * NU] * sv[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) rs = rs + st.R[i * NU + l] * sv[l];
    scalar_t mr = st.M[i] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) mr = mr + st.M[l * NU + i] * rv[l];
    scalar_t fv = st.fu[i] * vn[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) fv = fv + st.fu[l * NU + i] * vn[l];
    qu[i] = -rs - mr - fv;
    KD[i * MC] = -qu[i];
  }
  // Qxu = M + fx' Sfu, written transposed into the RHS.
#pragma unroll
  for (int j = 0; j < NX; ++j) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = st.fx[j] * Sfu[i];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.fx[l * NX + j] * Sfu[l * NU + i];
      KD[i * MC + 1 + j] = st.M[j * NU + i] + acc;
    }
  }
  const scalar_t piv = solve_track<scalar_t, NU, MC>(a, KD);
  scalar_t dq = KD[0] * qu[0], dQd = scalar_t(0);
#pragma unroll
  for (int i = 1; i < NU; ++i) dq = dq + KD[i * MC] * qu[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    scalar_t acc = Quu[i * NU] * KD[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + Quu[i * NU + l] * KD[l * MC];
    dQd = (i == 0) ? KD[0] * acc : dQd + KD[i * MC] * acc;
  }
  dV = dq + scalar_t(0.5) * dQd;
  return piv;
}

// The closed-loop affine element of one stage (newton_kernel.py step 6):
// F = fx - fu K, e = fu d.
template <typename scalar_t, int NX, int NU>
__device__ __forceinline__ void closed_loop(const scalar_t* fx,
                                            const scalar_t* fu,
                                            const scalar_t* KD, scalar_t* e) {
  constexpr int MC = 1 + NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = fu[i * NU] * KD[1 + j];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + fu[i * NU + l] * KD[l * MC + 1 + j];
      e[i * NX + j] = fx[i * NX + j] - acc;
    }
    scalar_t acc = fu[i * NU] * KD[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + fu[i * NU + l] * KD[l * MC];
    e[NX * NX + i] = acc;
  }
}

template <typename scalar_t, int NX, int NU>
__global__ void __launch_bounds__(kScanThreads)
par_newton_trial_kernel(const scalar_t* __restrict__ ru,  // (B, T, NU)
                        const scalar_t* __restrict__ Q,   // (B, T, NX, NX)
                        const scalar_t* __restrict__ R,   // (B, T, NU, NU)
                        const scalar_t* __restrict__ M,   // (B, T, NX, NU)
                        const scalar_t* __restrict__ fx,  // (B, T, NX, NX)
                        const scalar_t* __restrict__ fu,  // (B, T, NX, NU)
                        const scalar_t* __restrict__ XT,  // (B, NX, NX)
                        scalar_t* __restrict__ gains,     // (B, T, NU*(1+NX))
                        scalar_t* __restrict__ du,        // (B, T, NU)
                        scalar_t* __restrict__ dx,        // (B, T+1, NX)
                        scalar_t* __restrict__ pred,      // (B,)
                        bool* __restrict__ ok,            // (B,)
                        int T) {
  using VOp = ValueOp<scalar_t, NX>;
  using AOp = AffineOp<scalar_t, NX>;
  constexpr int VE = VOp::E, AE = AOp::E, MC = 1 + NX, NG = NU * MC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* buf = reinterpret_cast<scalar_t*>(smem_raw);
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * T;
  const scalar_t* XTb = XT + static_cast<size_t>(b) * NX * NX;
  int t0, t1;
  thread_chunk(T, t0, t1);
  const int len = t1 - t0;

  // 1. The chunk's value aggregate (backward walk).
  scalar_t agg[VE];
  VOp::identity(agg);
  for (int s = 0; s < len; ++s) {
    StageData<scalar_t, NX, NU> st;
    load_stage(ru, Q, R, M, fx, fu, base + t1 - 1 - s, st);
    scalar_t e[VE], nxt[VE], sv[NU], rv[NX], pu;
    stage_element(st, e, sv, rv, pu);
    if (s == 0) {
      copy_elem<scalar_t, VE>(e, agg);
    } else {
      VOp::combine(e, agg, nxt);
      copy_elem<scalar_t, VE>(nxt, agg);
    }
  }
  // 2. The suffix scan of the block's aggregates.
  scalar_t run[VE];
  bool have = block_carry<VOp, scalar_t, true>(agg, buf, run);
  // 3. Backward walk from the carried-in suffix: before stage t, `run` is
  //    the suffix from t+1 (scanned[t+1]); its fold with the terminal
  //    element (0, 0, 0, 0, XT) is the next stage's value (S', v'), and
  //    stage T-1 sees (XT, 0).  Gains go to the scratch.
  scalar_t dv_sum = scalar_t(0);
  bool bad = false;
  for (int s = 0; s < len; ++s) {
    const int t = t1 - 1 - s;
    StageData<scalar_t, NX, NU> st;
    load_stage(ru, Q, R, M, fx, fu, base + t, st);
    scalar_t e[VE], sv[NU], rv[NX], pu;
    stage_element(st, e, sv, rv, pu);
    scalar_t Sn[NX * NX], vn[NX];
    if (t == T - 1) {
#pragma unroll
      for (int r = 0; r < NX * NX; ++r) Sn[r] = XTb[r];
#pragma unroll
      for (int r = 0; r < NX; ++r) vn[r] = scalar_t(0);
    } else {
      VOp::eta_J(run, XTb, nullptr, vn, Sn);
    }
    scalar_t KD[NG], dV;
    const scalar_t pq = stage_gains(st, sv, rv, Sn, vn, KD, dV);
    const scalar_t piv = nan_min(pu, pq);
    bad = bad || !(isfinite(piv) && piv > scalar_t(0));
    dv_sum = dv_sum + dV;
#pragma unroll
    for (int r = 0; r < NG; ++r) gains[(base + t) * NG + r] = KD[r];
    if (have) {
      scalar_t nxt[VE];
      VOp::combine(e, run, nxt);
      copy_elem<scalar_t, VE>(nxt, run);
    } else {
      copy_elem<scalar_t, VE>(e, run);
      have = true;
    }
  }
  // 4. The chunk's closed-loop aggregate (forward walk).
  scalar_t fagg[AE];
  AOp::identity(fagg);
  for (int s = 0; s < len; ++s) {
    const size_t g = base + t0 + s;
    scalar_t e[AE], nxt[AE];
    closed_loop<scalar_t, NX, NU>(fx + g * NX * NX, fu + g * NX * NU,
                                  gains + g * NG, e);
    if (s == 0) {
      copy_elem<scalar_t, AE>(e, fagg);
    } else {
      AOp::combine(e, fagg, nxt);
      copy_elem<scalar_t, AE>(nxt, fagg);
    }
  }
  // 5. The prefix scan of the aggregates; from zero deviation, the state at
  //    the chunk's start is the constant part of the carried-in prefix.
  scalar_t fcarry[AE];
  const bool fhave = block_carry<AOp, scalar_t, false>(fagg, buf, fcarry);
  scalar_t x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = fhave ? fcarry[NX * NX + i] : scalar_t(0);
  for (int s = 0; s < len; ++s) {
    const int t = t0 + s;
    const size_t g = base + t;
    const scalar_t* KD = gains + g * NG;
    scalar_t e[AE];
    closed_loop<scalar_t, NX, NU>(fx + g * NX * NX, fu + g * NX * NU, KD, e);
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[(static_cast<size_t>(b) * (T + 1) + t) * NX + i] = x[i];
    // du = d - K dx.
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = KD[i * MC + 1] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + KD[i * MC + 1 + j] * x[j];
      du[g * NU + i] = KD[i * MC] - acc;
    }
    scalar_t xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      scalar_t acc = e[i * NX] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + e[i * NX + j] * x[j];
      xn[i] = acc + e[NX * NX + i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
  if (len > 0 && t1 == T) {
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[(static_cast<size_t>(b) * (T + 1) + T) * NX + i] = x[i];
  }
  // 6. pred = sum dV; ok = every pivot finite and > 0, pred finite.
  const bool any_bad = __syncthreads_or(bad);
  buf[threadIdx.x] = dv_sum;
  __syncthreads();
  for (int w = kScanThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] = buf[threadIdx.x] + buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const scalar_t p = buf[0];
    pred[b] = p;
    ok[b] = !any_bad && isfinite(p);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename scalar_t, int N>
int launch_affine(int reverse, const void* F, const void* c, void* Fo,
                  void* co, int B, int T, cudaStream_t stream) {
  constexpr size_t smem = 2 * kScanThreads * AffineOp<scalar_t, N>::E * sizeof(scalar_t);
  auto kernel = reverse ? affine_scan_kernel<scalar_t, N, true>
                        : affine_scan_kernel<scalar_t, N, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kScanThreads, smem, stream>>>(
      static_cast<const scalar_t*>(F), static_cast<const scalar_t*>(c),
      static_cast<scalar_t*>(Fo), static_cast<scalar_t*>(co), T);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t, int N>
int launch_value(const void* const* in, void* const* out, int B, int T,
                 cudaStream_t stream) {
  constexpr size_t smem = 2 * kScanThreads * ValueOp<scalar_t, N>::E * sizeof(scalar_t);
  auto kernel = value_scan_kernel<scalar_t, N>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  kernel<<<B, kScanThreads, smem, stream>>>(I(0), I(1), I(2), I(3), I(4),
                                            O(0), O(1), O(2), O(3), O(4), T);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t, int NX, int NU>
int launch_trial(const void* const* in, void* gains, void* du, void* dx,
                 void* pred, void* ok, int B, int T, cudaStream_t stream) {
  constexpr size_t smem = 2 * kScanThreads * ValueOp<scalar_t, NX>::E * sizeof(scalar_t);
  auto kernel = par_newton_trial_kernel<scalar_t, NX, NU>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  kernel<<<B, kScanThreads, smem, stream>>>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6),
      static_cast<scalar_t*>(gains), static_cast<scalar_t*>(du),
      static_cast<scalar_t*>(dx), static_cast<scalar_t*>(pred),
      static_cast<bool*>(ok), T);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int dispatch_affine(int n, int reverse, const void* F, const void* c,
                    void* Fo, void* co, int B, int T, cudaStream_t s) {
  if (n == 2) return launch_affine<scalar_t, 2>(reverse, F, c, Fo, co, B, T, s);
  if (n == 3) return launch_affine<scalar_t, 3>(reverse, F, c, Fo, co, B, T, s);
  if (n == 4) return launch_affine<scalar_t, 4>(reverse, F, c, Fo, co, B, T, s);
  return -1;
}

template <typename scalar_t>
int dispatch_value(int n, const void* const* in, void* const* out, int B,
                   int T, cudaStream_t s) {
  if (n == 2) return launch_value<scalar_t, 2>(in, out, B, T, s);
  if (n == 3) return launch_value<scalar_t, 3>(in, out, B, T, s);
  if (n == 4) return launch_value<scalar_t, 4>(in, out, B, T, s);
  return -1;
}

template <typename scalar_t>
int dispatch_trial(int nx, int nu, const void* const* in, void* gains,
                   void* du, void* dx, void* pred, void* ok, int B, int T,
                   cudaStream_t s) {
  if (nx == 2 && nu == 1)
    return launch_trial<scalar_t, 2, 1>(in, gains, du, dx, pred, ok, B, T, s);
  if (nx == 4 && nu == 1)
    return launch_trial<scalar_t, 4, 1>(in, gains, du, dx, pred, ok, B, T, s);
  if (nx == 3 && nu == 2)
    return launch_trial<scalar_t, 3, 2>(in, gains, du, dx, pred, ok, B, T, s);
  return -1;
}

}  // namespace

// C entry points, bound with ctypes.  `dtype` is 0 for float32, 1 for
// float64.  Each returns cudaGetLastError() after the launch (0 on success)
// or -1 for a shape with no instantiation; nothing is synchronised.
extern "C" int ipoc_affine_scan(int dtype, int n, int reverse, const void* F,
                                const void* c, void* Fo, void* co, int B,
                                int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_affine<float>(n, reverse, F, c, Fo, co, B, T, s);
  if (dtype == 1) return dispatch_affine<double>(n, reverse, F, c, Fo, co, B, T, s);
  return -1;
}

extern "C" int ipoc_value_scan(int dtype, int n, const void* A, const void* b,
                               const void* C, const void* eta, const void* J,
                               void* Ao, void* bo, void* Co, void* etao,
                               void* Jo, int B, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[5] = {A, b, C, eta, J};
  void* out[5] = {Ao, bo, Co, etao, Jo};
  if (dtype == 0) return dispatch_value<float>(n, in, out, B, T, s);
  if (dtype == 1) return dispatch_value<double>(n, in, out, B, T, s);
  return -1;
}

extern "C" int ipoc_par_newton_trial(int dtype, int nx, int nu,
                                     const void* ru, const void* Q,
                                     const void* R, const void* M,
                                     const void* fx, const void* fu,
                                     const void* XT, void* gains, void* du,
                                     void* dx, void* pred, void* ok, int B,
                                     int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[7] = {ru, Q, R, M, fx, fu, XT};
  if (dtype == 0) return dispatch_trial<float>(nx, nu, in, gains, du, dx, pred, ok, B, T, s);
  if (dtype == 1) return dispatch_trial<double>(nx, nu, in, gains, du, dx, pred, ok, B, T, s);
  return -1;
}
