// The one-launch parallel Newton trial's kernel for Hopper (sm_90a), its
// launch and its C entries, instantiated once per dtype by
// par_trial_f32.cu and par_trial_f64.cu, and for the planar quadrotor's
// (6, 2) by par_trial_62_f32.cu and par_trial_62_f64.cu (one object each,
// built in parallel) and dispatched by par_newton.cu
// ipoc_par_newton_trial.  The
// lanes, their phases and the schedule are par_trial.h's; the design note
// is at the top of par_newton.cu.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "launch_attr.cuh"
#include "par_trial.h"

namespace ipoc_trial {

// Runs each step for this thread's lane, then syncs the scenario's lanes:
// its warp (P = 32), a named barrier over its P threads (P = 64, two
// scenarios per block), or the block (P >= 128, one scenario).
template <class Lane, int P>
struct DeviceExec {
  Lane& lane;
  template <class F>
  IPOC_HD void operator()(F&& f) {
    f(lane);
#ifdef __CUDA_ARCH__
    if constexpr (P == ipoc::kTrialWarp) {
      __syncwarp();
    } else if constexpr (P < ipoc::kTrialBlock) {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + static_cast<int>(threadIdx.x) / P),
                   "r"(P)
                   : "memory");
    } else {
      __syncthreads();
    }
#endif
  }
};

template <typename scalar_t, int NX, int NU, int P>
__global__ void __launch_bounds__(ipoc::ParTrial<scalar_t, NX, NU, P>::kBlock)
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
                        int B, int T) {
  using Tr = ipoc::ParTrial<scalar_t, NX, NU, P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int within = static_cast<int>(threadIdx.x) / P;  // scenario in block
  const int b = static_cast<int>(blockIdx.x) * Tr::kScenarios + within;
  if (b >= B) return;  // the scenario's P threads leave together
  scalar_t* sh = reinterpret_cast<scalar_t*>(smem_raw) + within * Tr::kShared;
  const auto s = Tr::scenario(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, b, T);
  typename Tr::Lane lane;
  Tr::init(lane, static_cast<int>(threadIdx.x) % P, T);
  DeviceExec<typename Tr::Lane, P> ex{lane};
  Tr::schedule(ex, s, sh);
}

template <int NX_, int NU_>
struct Shape {
  static constexpr int nx = NX_, nu = NU_;
};

template <typename scalar_t, int NX, int NU, int P>
struct TrialLaunch {
  using Tr = ipoc::ParTrial<scalar_t, NX, NU, P>;
  static constexpr size_t smem = Tr::kScenarios * Tr::kShared * sizeof(scalar_t);

  static int launch(const void* const* in, void* gains, void* du, void* dx,
                    void* pred, void* ok, int B, int T, cudaStream_t stream) {
    auto kernel = par_newton_trial_kernel<scalar_t, NX, NU, P>;
    cudaError_t err = ipoc::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
    const int blocks = (B + Tr::kScenarios - 1) / Tr::kScenarios;
    kernel<<<blocks, Tr::kBlock, smem, stream>>>(
        I(0), I(1), I(2), I(3), I(4), I(5), I(6),
        static_cast<scalar_t*>(gains), static_cast<scalar_t*>(du),
        static_cast<scalar_t*>(dx), static_cast<scalar_t*>(pred),
        static_cast<bool*>(ok), B, T);
    return static_cast<int>(cudaGetLastError());
  }

  // launch_attr.cuh kernel_occupancy.
  static int occupancy(int* out) {
    return ipoc::kernel_occupancy(par_newton_trial_kernel<scalar_t, NX, NU, P>,
                                  Tr::kBlock, smem, Tr::kScenarios, out);
  }
};

// fn(TrialLaunch<scalar_t, nx, nu, P>()) for one of the shapes `Shapes`;
// -1 for a shape or P with no instantiation, or a P whose block would take
// more shared memory than a block may (at (6, 2) in float64, P = 256:
// ops/newton_kernel.py trial_lanes never asks for it).
template <typename scalar_t, class... Shapes, class F>
int with_trial(int nx, int nu, int P, F&& fn) {
  auto lanes = [&](auto shape) -> int {
    constexpr int NX = decltype(shape)::nx, NU = decltype(shape)::nu;
    auto go = [&](auto pp) -> int {
      using L = TrialLaunch<scalar_t, NX, NU, decltype(pp)::value>;
      if constexpr (L::smem <= ipoc::kMaxSmem) return fn(L());
      return -1;
    };
    if (P == 32) return go(std::integral_constant<int, 32>());
    if (P == 64) return go(std::integral_constant<int, 64>());
    if (P == 128) return go(std::integral_constant<int, 128>());
    if (P == 256) return go(std::integral_constant<int, 256>());
    return -1;
  };
  int status = -1;
  ((status = (nx == Shapes::nx && nu == Shapes::nu) ? lanes(Shapes()) : status), ...);
  return status;
}

}  // namespace ipoc_trial

// The C entries of one dtype and one list of (nx, nu) shapes:
// `ipoc_par_trial_launch_<tag>` launches the trial on (nx, nu, P),
// `ipoc_par_trial_occupancy_<tag>` reports TrialLaunch::occupancy; -1 for
// a shape or P with no instantiation.
#define IPOC_TRIAL_ENTRIES(scalar_t, tag, ...)                                    \
  extern "C" int ipoc_par_trial_launch_##tag(                                     \
      int nx, int nu, int P, const void* const* in, void* gains, void* du,        \
      void* dx, void* pred, void* ok, int B, int T, void* stream) {               \
    auto go = [&](auto l) {                                                       \
      return l.launch(in, gains, du, dx, pred, ok, B, T,                          \
                      static_cast<cudaStream_t>(stream));                         \
    };                                                                            \
    return ipoc_trial::with_trial<scalar_t, __VA_ARGS__>(nx, nu, P, go);          \
  }                                                                               \
  extern "C" int ipoc_par_trial_occupancy_##tag(int nx, int nu, int P, int* out) { \
    auto go = [&](auto l) { return l.occupancy(out); };                           \
    return ipoc_trial::with_trial<scalar_t, __VA_ARGS__>(nx, nu, P, go);          \
  }
