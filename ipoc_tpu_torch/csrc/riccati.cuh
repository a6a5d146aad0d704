// Riccati row algebra shared by the Newton kernels (one thread per
// scenario, everything in registers).  Counterpart of the device helpers of
// ipoc_tpu/ops/pallas/seq_newton_kernel.py (_solve_track, _gain_rhs,
// _pivots_only, _add_mm_sym, _mm, _mv) and of the backward step that
// seq_newton_kernel.py:172-252 and fused_iter_kernel.py:802-833 both
// compute.
//
// Semantics follow the JAX kernels exactly: symmetric updates computed on
// the upper triangle and mirrored, one unpivoted elimination for [k | K]
// with the interleaved right-hand side, the minimum pivot over Quu and the
// regularized R, NaN-propagating like jnp.minimum.  Matrices are row-major
// flat arrays; generic in dtype, templated on (NX, NU).  Host and device
// (IPOC_HD): the mega kernel's lane iteration (lane.h) also compiles with a
// host C++ compiler for the CPU tests.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

#include "scalar_math.h"

namespace ipoc {

template <typename scalar_t>
IPOC_HD scalar_t nan_min(scalar_t a, scalar_t b) {
  // jnp.minimum / torch.minimum semantics: a NaN operand wins (fmin would
  // drop it and could let a NaN pivot pass the PD test).
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// A DDP gain as the reference backward pass gives it
// (solvers/ip_ddp.py _ddp_bwd): it factors the stage's regularized Quu by
// Cholesky, which fails where a pivot of Quu is not positive (or is NaN)
// and then gives NaN gains; those carry NaN into Vx, and so into every
// earlier stage's Qu and pivots (max|Qu| is NaN and the lane's iteration
// ends as non-finite).  The unpivoted elimination gives finite gains
// there, so DDP mode puts NaN in their place.
template <typename scalar_t>
IPOC_HD scalar_t ddp_gain(scalar_t g, scalar_t piv) {
  return piv > scalar_t(0) ? g : scalar_t(NAN);
}

// Unpivoted elimination on an (N x N) matrix `a` with an (N x MC) RHS `b`,
// both row-major, in place; returns the minimum pivot (_solve_track).
template <typename scalar_t, int N, int MC>
IPOC_HD scalar_t solve_track(scalar_t* a, scalar_t* b) {
  scalar_t minpiv = a[0];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const scalar_t piv = a[k * N + k];
    if (k > 0) minpiv = nan_min(minpiv, piv);
    const scalar_t inv_p = scalar_t(1) / piv;
#pragma unroll
    for (int j = k + 1; j < N; ++j) a[k * N + j] = a[k * N + j] * inv_p;
#pragma unroll
    for (int j = 0; j < MC; ++j) b[k * MC + j] = b[k * MC + j] * inv_p;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const scalar_t f = a[i * N + k];
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[i * N + j] = a[i * N + j] - f * a[k * N + j];
#pragma unroll
      for (int j = 0; j < MC; ++j) b[i * MC + j] = b[i * MC + j] - f * b[k * MC + j];
    }
  }
#pragma unroll
  for (int i = N - 2; i >= 0; --i) {
#pragma unroll
    for (int l = i + 1; l < N; ++l) {
      const scalar_t f = a[i * N + l];
#pragma unroll
      for (int j = 0; j < MC; ++j) b[i * MC + j] = b[i * MC + j] - f * b[l * MC + j];
    }
  }
  return minpiv;
}

// Minimum leading pivot of an unpivoted elimination (_pivots_only).
template <typename scalar_t, int N>
IPOC_HD scalar_t pivots_only(const scalar_t* A) {
  if (N == 1) return A[0];
  scalar_t a[N * N];
#pragma unroll
  for (int r = 0; r < N * N; ++r) a[r] = A[r];
  scalar_t minpiv = a[0];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const scalar_t piv = a[k * N + k];
    if (k > 0) minpiv = nan_min(minpiv, piv);
    const scalar_t inv_p = scalar_t(1) / piv;
#pragma unroll
    for (int j = k + 1; j < N; ++j) a[k * N + j] = a[k * N + j] * inv_p;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const scalar_t f = a[i * N + k];
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[i * N + j] = a[i * N + j] - f * a[k * N + j];
    }
  }
  return minpiv;
}

// One backward Riccati step of the sequential Newton trial.
//
// In: the stage's ru (NU), Q (NX*NX, upper triangle read), R (NU*NU,
// regularized, upper triangle read), M (NX*NU), fx (NX*NX), fu (NX*NU), and
// the value carry Vxx (NX*NX), Vx (NX).  Out: the gains k (NU) and
// K (NU*NX); Vxx and Vx updated in place; dv += k'Qu + 1/2 k'Quu k;
// minpiv <- min(minpiv, pivots of Quu and R).
//
// DDP = true is the IP-DDP step (mega_kernel.py:852-878): the stage data
// were contracted with the value gradient Vx, not the costates, so the
// Hamiltonian gradient is the Q-function's, Qu = ru and Qx = hx (the
// stage's lam_new, passed as hx); Vx is only written (Qx + Qxu k); dv +=
// 1/2 k'Qu (= -1/2 Qu' Quu^-1 Qu); the pivots are Quu's alone; a Quu
// that is not positive definite gives NaN gains (ddp_gain).  The caller
// starts Vx at the terminal gradient.
template <typename scalar_t, int NX, int NU, bool DDP = false>
IPOC_HD void riccati_step(
    const scalar_t* ru, const scalar_t* Q, const scalar_t* R,
    const scalar_t* M, const scalar_t* fx, const scalar_t* fu,
    scalar_t* Vxx, scalar_t* Vx, scalar_t* k, scalar_t* K, scalar_t& dv,
    scalar_t& minpiv, const scalar_t* hx = nullptr) {
  constexpr int MC = 1 + NX;
  // Vfx = Vxx fx, Vfu = Vxx fu.
  scalar_t Vfx[NX * NX], Vfu[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = Vxx[i * NX] * fx[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + Vxx[i * NX + l] * fx[l * NX + j];
      Vfx[i * NX + j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = Vxx[i * NX] * fu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + Vxx[i * NX + l] * fu[l * NU + j];
      Vfu[i * NU + j] = acc;
    }
  }
  // Qxx = Q + fx' Vfx and Quu = R + fu' Vfu: upper triangle, mirrored.
  scalar_t Qxx[NX * NX], Quu[NU * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = i; j < NX; ++j) {
      scalar_t acc = Q[i * NX + j] + fx[i] * Vfx[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fx[l * NX + i] * Vfx[l * NX + j];
      Qxx[i * NX + j] = acc;
      Qxx[j * NX + i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = i; j < NU; ++j) {
      scalar_t acc = R[i * NU + j] + fu[i] * Vfu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fu[l * NU + i] * Vfu[l * NU + j];
      Quu[i * NU + j] = acc;
      Quu[j * NU + i] = acc;
    }
  }
  // Qxu = M + fx' Vfu;  Qu = ru + fu' Vx;  Qx = fx' Vx  (DDP: ru, hx).
  scalar_t Qxu[NX * NU], Qu[NU], Qx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = fx[i] * Vfu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fx[l * NX + i] * Vfu[l * NU + j];
      Qxu[i * NU + j] = M[i * NU + j] + acc;
    }
    if constexpr (DDP) {
      Qx[i] = hx[i];
    } else {
      scalar_t acc = fx[i] * Vx[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fx[l * NX + i] * Vx[l];
      Qx[i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    if constexpr (DDP) {
      Qu[i] = ru[i];
    } else {
      scalar_t acc = fu[i] * Vx[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fu[l * NU + i] * Vx[l];
      Qu[i] = ru[i] + acc;
    }
  }

  // Quu [k | K] = -[Qu | Qxu'] in one elimination; the RHS row i holds
  // (Qu_i, Qxu'_i0, ..., Qxu'_i,nx-1) (interleaved layout, _gain_rhs).
  scalar_t a[NU * NU], sol[NU * MC];
#pragma unroll
  for (int r = 0; r < NU * NU; ++r) a[r] = Quu[r];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    sol[i * MC] = Qu[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) sol[i * MC + 1 + j] = Qxu[j * NU + i];
  }
  scalar_t piv = solve_track<scalar_t, NU, MC>(a, sol);
  if constexpr (!DDP) piv = nan_min(piv, pivots_only<scalar_t, NU>(R));

#pragma unroll
  for (int i = 0; i < NU; ++i) {
    k[i] = -sol[i * MC];
#pragma unroll
    for (int j = 0; j < NX; ++j) K[i * NX + j] = -sol[i * MC + 1 + j];
  }
  if constexpr (DDP) {
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) K[i] = ddp_gain(K[i], piv);
#pragma unroll
    for (int i = 0; i < NU; ++i) k[i] = ddp_gain(k[i], piv);
  }

  // Vx <- Qx + Qxu k;  Vxx <- Qxx + Qxu K (upper triangle, mirrored).
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    scalar_t acc = Qxu[i * NU] * k[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc = acc + Qxu[i * NU + j] * k[j];
    Vx[i] = Qx[i] + acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = i; j < NX; ++j) {
      scalar_t acc = Qxx[i * NX + j] + Qxu[i * NU] * K[j];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + Qxu[i * NU + l] * K[l * NX + j];
      Vxx[i * NX + j] = acc;
      Vxx[j * NX + i] = acc;
    }
  }
  // dV += k'Qu + 1/2 k'Quu k  (DDP: 1/2 k'Qu).
  scalar_t kQu = k[0] * Qu[0];
#pragma unroll
  for (int i = 1; i < NU; ++i) kQu = kQu + k[i] * Qu[i];
  if constexpr (DDP) {
    dv = dv + scalar_t(0.5) * kQu;
    minpiv = nan_min(minpiv, piv);
    return;
  }
  scalar_t kQk = scalar_t(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    scalar_t acc = Quu[i * NU] * k[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc = acc + Quu[i * NU + j] * k[j];
    kQk = (i == 0) ? k[0] * acc : kQk + k[i] * acc;
  }
  dv = dv + kQu + scalar_t(0.5) * kQk;
  minpiv = nan_min(minpiv, piv);
}

}  // namespace ipoc
