// Associative-scan algebra shared by the parallel-in-time kernels
// (csrc/par_newton.cu, csrc/affine_scan.h, csrc/par_trial.h) and their
// row loads and stores.  Counterpart of the lane-layout helpers of
// ipoc_tpu/ops/pallas/scan_kernels.py: _affine_combine_lanes and
// _value_combine_lanes.
//
// Elements are flat row-major arrays in registers or shared memory:
//   affine  (F, c):             [F (N*N) | c (N)]             v -> F v + c
//   value   (A, b, C, eta, J):  [A (N*N) | b (N) | C (N*N) | eta (N) | J (N*N)]
// Identities (I, 0) and (I, 0, 0, 0, 0), as scan_kernels.py pads with.
// Arithmetic follows the JAX lane kernels term by term (same products, same
// summation order, unpivoted eliminations through riccati.cuh's
// solve_track); nvcc may contract a product and a sum into one FMA.  The
// algebra is host and device (IPOC_HD): the host builds of the trial
// (par_trial.h) and the scans (affine_scan.h) compile it with g++.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "launch_attr.cuh"  // allow_smem
#endif
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "riccati.cuh"

namespace ipoc {

// Each algebra also describes its element's rows, the arrays it is stored
// in (row r: row_len(r) scalars at row_off(r) of the element), and how the
// lane schedule of affine_scan.h holds its operands: kInPlace, whether a
// combine reads the tile's element where it lies in shared memory (the
// value element, too large for two in registers) or from registers.
template <typename scalar_t, int N>
struct AffineOp {
  using Scalar = scalar_t;
  static constexpr int E = N * N + N;
  static constexpr int kRows = 2;  // F, c
  static constexpr bool kInPlace = false;
  IPOC_HD static constexpr int row_off(int r) { return r == 0 ? 0 : N * N; }
  IPOC_HD static constexpr int row_len(int r) { return r == 0 ? N * N : N; }

  IPOC_HD static void identity(scalar_t* e) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      e[r] = (r < N * N && r / N == r % N) ? scalar_t(1) : scalar_t(0);
  }

  // out = x o y: v -> Fx (Fy v + cy) + cx.  out must not alias x or y.
  IPOC_HD static void combine(const scalar_t* x,
                                                 const scalar_t* y,
                                                 scalar_t* out) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = x[i * N] * y[j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + x[i * N + l] * y[l * N + j];
        out[i * N + j] = acc;
      }
      scalar_t acc = x[i * N] * y[N * N];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + x[i * N + l] * y[N * N + l];
      out[N * N + i] = acc + x[N * N + i];
    }
  }
};

template <typename scalar_t, int N>
struct ValueOp {
  using Scalar = scalar_t;
  static constexpr int E = 3 * N * N + 2 * N;
  static constexpr int kA = 0, kB = N * N, kC = N * N + N;
  static constexpr int kEta = 2 * N * N + N, kJ = 2 * N * N + 2 * N;
  static constexpr int kRows = 5;  // A, b, C, eta, J
  static constexpr bool kInPlace = true;
  IPOC_HD static constexpr int row_off(int r) {
    return r == 0 ? kA : r == 1 ? kB : r == 2 ? kC : r == 3 ? kEta : kJ;
  }
  IPOC_HD static constexpr int row_len(int r) { return r % 2 == 0 ? N * N : N; }

  IPOC_HD static void identity(scalar_t* e) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      e[r] = (r < N * N && r / N == r % N) ? scalar_t(1) : scalar_t(0);
  }

  // Solves on L2 = I + Jj Ci for [etaj - Jj bi | Jj] (E_eta, E_J), then
  // eta = Ai' E_eta + etai and J = (Ai' E_J) Ai + Ji.  `etaj` may be null
  // (zero).  Shared by combine and the terminal fold.
  IPOC_HD static void eta_J(const scalar_t* x,
                                               const scalar_t* Jj,
                                               const scalar_t* etaj,
                                               scalar_t* eta_out,
                                               scalar_t* J_out) {
    constexpr int M2 = N + 1;
    scalar_t L2[N * N], R2[N * M2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = Jj[i * N] * x[kC + j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + Jj[i * N + l] * x[kC + l * N + j];
        L2[i * N + j] = (i == j ? scalar_t(1) : scalar_t(0)) + acc;
        R2[i * M2 + 1 + j] = Jj[i * N + j];
      }
      scalar_t acc = Jj[i * N] * x[kB];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + Jj[i * N + l] * x[kB + l];
      R2[i * M2] = (etaj ? etaj[i] : scalar_t(0)) - acc;
    }
    solve_track<scalar_t, N, M2>(L2, R2);
    // eta = Ai' E_eta + etai;  J = (Ai' E_J) Ai + Ji.
    scalar_t AE[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      scalar_t acc = x[kA + i] * R2[0];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + x[kA + l * N + i] * R2[l * M2];
      eta_out[i] = acc + x[kEta + i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t a2 = x[kA + i] * R2[1 + j];
#pragma unroll
        for (int l = 1; l < N; ++l) a2 = a2 + x[kA + l * N + i] * R2[l * M2 + 1 + j];
        AE[i * N + j] = a2;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = AE[i * N] * x[kA + j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + AE[i * N + l] * x[kA + l * N + j];
        J_out[i * N + j] = acc + x[kJ + i * N + j];
      }
    }
  }

  // out = combine(earlier x, later y) (parallel/lqt.py value_combine, the
  // lane form of scan_kernels.py:156-181).  out must not alias x or y.
  IPOC_HD static void combine(const scalar_t* x,
                                                 const scalar_t* y,
                                                 scalar_t* out) {
    // L1 = I + Ci Jj against [Ai | bi + Ci etaj | Ci]: D_A, D_b, D_C.
    constexpr int M1 = 2 * N + 1;
    scalar_t L1[N * N], R1[N * M1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = x[kC + i * N] * y[kJ + j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + x[kC + i * N + l] * y[kJ + l * N + j];
        L1[i * N + j] = (i == j ? scalar_t(1) : scalar_t(0)) + acc;
        R1[i * M1 + j] = x[kA + i * N + j];
        R1[i * M1 + N + 1 + j] = x[kC + i * N + j];
      }
      scalar_t acc = x[kC + i * N] * y[kEta];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + x[kC + i * N + l] * y[kEta + l];
      R1[i * M1 + N] = x[kB + i] + acc;
    }
    solve_track<scalar_t, N, M1>(L1, R1);
    // A = Aj D_A;  b = Aj D_b + bj;  C = (Aj D_C) Aj' + Cj.
    scalar_t AD[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t a1 = y[kA + i * N] * R1[j];
        scalar_t a2 = y[kA + i * N] * R1[N + 1 + j];
#pragma unroll
        for (int l = 1; l < N; ++l) {
          a1 = a1 + y[kA + i * N + l] * R1[l * M1 + j];
          a2 = a2 + y[kA + i * N + l] * R1[l * M1 + N + 1 + j];
        }
        out[kA + i * N + j] = a1;
        AD[i * N + j] = a2;
      }
      scalar_t acc = y[kA + i * N] * R1[N];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + y[kA + i * N + l] * R1[l * M1 + N];
      out[kB + i] = acc + y[kB + i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = AD[i * N] * y[kA + j * N];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + AD[i * N + l] * y[kA + j * N + l];
        out[kC + i * N + j] = acc + y[kC + i * N + j];
      }
    }
    eta_J(x, y + kJ, y + kEta, out + kEta, out + kJ);
  }
};

template <typename scalar_t, int E>
IPOC_HD void copy_elem(const scalar_t* src, scalar_t* dst) {
#pragma unroll
  for (int r = 0; r < E; ++r) dst[r] = src[r];
}

// Row s (N scalars) of a (rows, N) array.  On the card, in 16- or 8-byte
// vectors where N scalars fill them (the wrappers hand over 16-byte aligned
// tensors, and `dst` is 16-byte aligned): a lane's rows lie a chunk apart
// from its neighbours', so each load instruction of a warp touches 32
// lines, and wider loads need fewer of them.
template <typename scalar_t, int N>
IPOC_HD void load_row(const scalar_t* a, size_t s, scalar_t* dst) {
  constexpr int bytes = N * static_cast<int>(sizeof(scalar_t));
  constexpr int V = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 0;
#ifdef __CUDA_ARCH__
  if constexpr (V > 0) {
    using vec = typename std::conditional<V == 16, uint4, uint2>::type;
    const vec* src = reinterpret_cast<const vec*>(a + s * N);
#pragma unroll
    for (int k = 0; k < bytes / V; ++k) reinterpret_cast<vec*>(dst)[k] = src[k];
    return;
  }
#endif
#pragma unroll
  for (int r = 0; r < N; ++r) dst[r] = a[s * N + r];
}

// The store of row s, as load_row reads it.
template <typename scalar_t, int N>
IPOC_HD void store_row(scalar_t* a, size_t s, const scalar_t* src) {
  constexpr int bytes = N * static_cast<int>(sizeof(scalar_t));
  constexpr int V = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 0;
#ifdef __CUDA_ARCH__
  if constexpr (V > 0) {
    using vec = typename std::conditional<V == 16, uint4, uint2>::type;
    vec* dst = reinterpret_cast<vec*>(a + s * N);
#pragma unroll
    for (int k = 0; k < bytes / V; ++k) dst[k] = reinterpret_cast<const vec*>(src)[k];
    return;
  }
#endif
#pragma unroll
  for (int r = 0; r < N; ++r) a[s * N + r] = src[r];
}


}  // namespace ipoc
