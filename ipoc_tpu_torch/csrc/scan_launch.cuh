// The two scans' kernels (affine_scan.h's lane schedule) and their
// launch, shared by the objects that instantiate them: par_newton.cu (n =
// 2, 3, 4) and scan_n6_*.cu (the planar quadrotor's n = 6, one object per
// scan and dtype, built in parallel: at n = 6 the value scan's
// instantiations are the library's longest compiles).  The design note is
// at the top of par_newton.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "affine_scan.h"
#include "launch_attr.cuh"
#include "riccati.cuh"
#include "scan.cuh"

namespace ipoc_scan {
// Internal to each object that includes this header: the objects
// instantiate disjoint n, and none shares a kernel with another.
namespace {

using ipoc::AffineScan;
using ipoc::allow_smem;
using ipoc::kernel_occupancy;
using ipoc::ScanExec;
using ipoc::ValueScan;

// One scan of one scenario per P threads (affine_scan.h): the affine scan
// (Sc = AffineScan, NR = 2 rows: F, c) or the value scan (ValueScan, 5:
// A, b, C, eta, J), each row's (B, T, ...) array in `ins` and `outs`.
template <class Sc>
struct Rows {
  const typename Sc::scalar_t* in[Sc::NR];
  typename Sc::scalar_t* out[Sc::NR];
};

template <class Sc>
__device__ __forceinline__ void scan_scenarios(const Rows<Sc>& rows, int B, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using scalar_t = typename Sc::scalar_t;
  scalar_t* sh = reinterpret_cast<scalar_t*>(smem_raw);
  constexpr int P = Sc::NW * ipoc::kScanWarp;
  const int within = static_cast<int>(threadIdx.x) / P;  // scenario in block
  const int b = static_cast<int>(blockIdx.x) * Sc::kScenarios + within;
  if (b >= B) return;  // the scenario's P threads leave together
  const auto s = Sc::scenario(rows.in, rows.out, b, T);
  typename Sc::Lane lane;
  Sc::init(lane, static_cast<int>(threadIdx.x) % P, T);
  ScanExec<typename Sc::Lane, P> ex{lane};
  Sc::schedule(ex, s, sh + within * Sc::kShared);
}

// The affine scan: (B, T, N, N) F and (B, T, N) c in, the same shapes out.
template <typename scalar_t, int N, int P, bool REVERSE>
__global__ void __launch_bounds__(AffineScan<scalar_t, N, P, REVERSE>::kBlock)
affine_scan_kernel(const Rows<AffineScan<scalar_t, N, P, REVERSE>> rows, int B, int T) {
  scan_scenarios(rows, B, T);
}

// The value scan: (B, T, N, N) A, C, J and (B, T, N) b, eta in, the same
// shapes out.
template <typename scalar_t, int N, int P>
__global__ void __launch_bounds__(ValueScan<scalar_t, N, P>::kBlock)
value_scan_kernel(const Rows<ValueScan<scalar_t, N, P>> rows, int B, int T) {
  scan_scenarios(rows, B, T);
}

template <class Sc, void (*Kernel)(Rows<Sc>, int, int)>
struct ScanLaunch {
  using scalar_t = typename Sc::scalar_t;
  static constexpr size_t smem = Sc::kScenarios * Sc::kShared * sizeof(scalar_t);

  // ins and outs: the rows' device pointers, in the algebra's order.
  static int launch(const void* const* ins, void* const* outs, int B, int T,
                    cudaStream_t stream) {
    auto kernel = Kernel;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Rows<Sc> rows;
    for (int r = 0; r < Sc::NR; ++r) {
      rows.in[r] = static_cast<const scalar_t*>(ins[r]);
      rows.out[r] = static_cast<scalar_t*>(outs[r]);
    }
    kernel<<<(B + Sc::kScenarios - 1) / Sc::kScenarios, Sc::kBlock, smem, stream>>>(
        rows, B, T);
    return static_cast<int>(cudaGetLastError());
  }

  // launch_attr.cuh kernel_occupancy.
  static int occupancy(int* out) {
    return kernel_occupancy(Kernel, Sc::kBlock, smem, Sc::kScenarios, out);
  }
};

// The scans a with_scan instantiates (its KINDS mask).
constexpr int kAffine = 1, kValue = 2;

// fn(ScanLaunch<Sc>()) for the scan `value` (the value scan) or the affine
// scan in direction `reverse`, of dimension n at P lanes per scenario, for
// n among `Ns` and the scans in the mask KINDS; -1 for another n, scan or
// P, or a P whose block would take more shared memory than a block may (n
// = 6 in float64 at P = 256: ops/scan_kernels.py scan_lanes never asks for
// it).
template <typename scalar_t, int KINDS, int... Ns, class Fn>
int with_scan(bool value, int n, int P, int reverse, Fn&& fn) {
  auto lanes = [&](auto nn, auto kind) -> int {
    constexpr int N = decltype(nn)::value;
    constexpr int K = decltype(kind)::value;  // 0 prefix, 1 suffix, 2 value
    auto go = [&](auto pp) -> int {
      constexpr int Pv = decltype(pp)::value;
      using Sc = std::conditional_t<K == 2, ValueScan<scalar_t, N, Pv>,
                                    AffineScan<scalar_t, N, Pv, K == 1>>;
      if constexpr (Sc::kScenarios * Sc::kShared * sizeof(scalar_t) > ipoc::kMaxSmem) {
        return -1;
      } else if constexpr (K == 2) {
        return fn(ScanLaunch<Sc, value_scan_kernel<scalar_t, N, Pv>>());
      } else {
        return fn(ScanLaunch<Sc, affine_scan_kernel<scalar_t, N, Pv, K == 1>>());
      }
    };
    if (P == 32) return go(std::integral_constant<int, 32>());
    if (P == 64) return go(std::integral_constant<int, 64>());
    if (P == 128) return go(std::integral_constant<int, 128>());
    if (P == 256) return go(std::integral_constant<int, 256>());
    return -1;
  };
  auto kind = [&](auto nn) -> int {
    if (value) {
      if constexpr ((KINDS & kValue) != 0) return lanes(nn, std::integral_constant<int, 2>());
      return -1;
    }
    if constexpr ((KINDS & kAffine) != 0) {
      return reverse ? lanes(nn, std::integral_constant<int, 1>())
                     : lanes(nn, std::integral_constant<int, 0>());
    }
    return -1;
  };
  int status = -1;
  ((status = n == Ns ? kind(std::integral_constant<int, Ns>()) : status), ...);
  return status;
}

}  // namespace
}  // namespace ipoc_scan

// The C entries of one object: `ipoc_scan_launch_<tag>` launches the scan
// (value, n, P, reverse) on the rows' pointers `ins`, `outs`;
// `ipoc_scan_occupancy_<tag>` reports ScanLaunch::occupancy; -1 for what
// the object does not instantiate.
#define IPOC_SCAN_ENTRIES(scalar_t, tag, KINDS, ...)                             \
  extern "C" int ipoc_scan_launch_##tag(int value, int n, int P, int reverse,    \
                                        const void* const* ins, void* const* outs, \
                                        int B, int T, void* stream) {            \
    auto go = [&](auto l) {                                                      \
      return l.launch(ins, outs, B, T, static_cast<cudaStream_t>(stream));       \
    };                                                                           \
    return ipoc_scan::with_scan<scalar_t, KINDS, __VA_ARGS__>(value, n, P,       \
                                                              reverse, go);      \
  }                                                                              \
  extern "C" int ipoc_scan_occupancy_##tag(int value, int n, int P, int* out) {  \
    auto go = [&](auto l) { return l.occupancy(out); };                          \
    return ipoc_scan::with_scan<scalar_t, KINDS, __VA_ARGS__>(value, n, P, 1,    \
                                                              go);               \
  }
