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
// The two scans.  The TPU kernels laid the horizon along the 128 lanes,
// padded to a multiple of 128, and ran ceil(log2 Tp) Hillis-Steele rounds
// over the whole horizon.  Both ran here first as one block of 128
// threads per scenario, a chunk of ceil(T / 128) stages a thread walked
// twice around a block scan of the chunk aggregates in shared memory.
// What bounded them on an H100 (700 W): the block's 7 rounds (each a
// barrier and 128 combines where the work needs T - 1) and the walks'
// loads, each thread's rows a chunk apart from its neighbours', so every
// load instruction of a warp touched 32 lines; at B = 1024, T = 100 the
// affine scan's C entry took 0.066 ms (bound 0.0049) and the value
// scan's 0.295 (bound 0.0137), whose element stride of 56 scalars also
// put 8-way bank conflicts in the rounds.  Their design now is one lane
// schedule for both algebras (affine_scan.h LaneScan): P lanes per
// scenario by the launch rule (ops/scan_kernels.py scan_lanes, with each
// kernel's resident warps), the chunks staged through shared memory in
// tiles whose copies and stores are whole lines, the chunk aggregates
// scanned inside each warp and over the warps' totals with one barrier.
// The affine element is read into registers and the rounds shuffle it;
// the value element, 56 scalars at n = 4, is read where it lies in shared
// memory (registers: 222 in float32, 255 with spills in float64; 8 warps
// an SM).  C entries: the affine scan 0.066 -> 0.011-0.020 ms at B = 1024
// (64 lanes in float32), 0.049 -> 0.011-0.019 at B = 1, T = 1001 (256);
// the value scan 0.295 -> 0.066 at B = 1024, T = 100 (32 lanes; float64
// 0.686 -> 0.120), 0.154 -> 0.078 at B = 1, T = 1000 (256; 0.243 ->
// 0.116) (PERF.md sections 5 and 6).
//
// The trial (par_trial.h holds its lanes' phases and schedule, and
// par_trial.cuh its kernel and launch).  What bounds it on the card is
// neither bytes (0.006 ms at B=1024, T=100) nor the flop rate but the
// dispatch of its dependent arithmetic and of its memory instructions: a
// value combine is some 1,400 operations at nx=4 in dependent chains
// (eliminations) over some 170 scalars of its operands.  Its first design,
// a block scan like the two scans', spent half its time on shared-memory
// bank conflicts (an element stride of 56 scalars: 8-way in float32) and
// most of the rest on 128 threads per scenario, of which at T=100 each
// owns at most one stage and whose rounds cost 769 value combines where
// the work needs 99; its stage
// loads (each lane's rows a chunk apart from its neighbours', one line per
// lane for each scalar loaded) were 3% of it at B=1024 but a quarter at
// B=1 (PERF.md section 5).  The design:
//   * P lanes per scenario, P in {32, 64, 128, 256}, each a contiguous
//     chunk of ceil(T / P) stages; blocks of max(P, 128) threads, so 128 / P
//     scenarios share a block where P < 128.  The wrapper picks P from
//     (B, T) (ops/newton_kernel.py trial_lanes): small P at large B,
//     where a scenario's scan costs at most 129 value combines in 5 rounds
//     (B=1024, T=100: P = 32, 4 stages a lane), large P at small B for a
//     short critical path (B=1, T=1000: P = 256).
//   * The chunk aggregates are scanned inside each warp (5 rounds), then
//     over the warps' totals (log2(P / 32) rounds), with one more combine
//     per lane for the carry: no barrier wider than the scenario (a warp
//     sync at P = 32, a named barrier at P = 64, the block's at P >= 128).
//   * Each element sits at an odd stride (E | 1 scalars) in shared memory,
//     so a warp's operand reads hit 32 distinct banks (float32; float64 at
//     its two-wavefront minimum).  A round's result goes to registers and
//     is stored after a barrier, so one buffer serves: (P + P / 32) slots
//     of ValueOp<NX>::E | 1 scalars per scenario.  Per block of 128
//     threads at nx=4: 29,184 bytes (float32), 58,368 (float64); at P =
//     256, 60,192 / 120,384.  At the quadrotor's (6, 2), not instantiated
//     yet (E = 120, stride 121): 61,952 / 123,904 per 128 threads, 127,776
//     / 255,552 at P = 256, which would need P <= 128 in float64.
//     Residency is set by registers (about 200-255 per thread: 8 warps per
//     SM at nx=4), not by shared memory.
//   * Stage rows are loaded in 16- or 8-byte vectors where a row fills them
//     (par_trial.h load_row): 12 load instructions per stage instead of 42
//     at (4, 1) in float32, each still one line per lane.  The gains go
//     through a (B, T, nu*(1+nx)) scratch that each thread writes and reads
//     back itself (L1).

// Generic in dtype (float, double); templated on n and on (NX, NU).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "affine_scan.h"
#include "riccati.cuh"
#include "scan.cuh"

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

// fn(ScanLaunch<Sc>()) for the scan `value` (the value scan) or the affine
// scan in direction `reverse`, of dimension n at P lanes per scenario; -1
// for an n or P with no instantiation.
template <typename scalar_t, class Fn>
int with_scan(bool value, int n, int P, int reverse, Fn&& fn) {
  auto lanes = [&](auto nn, auto kind) -> int {
    constexpr int N = decltype(nn)::value;
    constexpr int K = decltype(kind)::value;  // 0 prefix, 1 suffix, 2 value
    auto go = [&](auto pp) -> int {
      constexpr int Pv = decltype(pp)::value;
      if constexpr (K == 2) {
        return fn(ScanLaunch<ValueScan<scalar_t, N, Pv>, value_scan_kernel<scalar_t, N, Pv>>());
      } else {
        return fn(ScanLaunch<AffineScan<scalar_t, N, Pv, K == 1>,
                             affine_scan_kernel<scalar_t, N, Pv, K == 1>>());
      }
    };
    if (P == 32) return go(std::integral_constant<int, 32>());
    if (P == 64) return go(std::integral_constant<int, 64>());
    if (P == 128) return go(std::integral_constant<int, 128>());
    if (P == 256) return go(std::integral_constant<int, 256>());
    return -1;
  };
  auto kind = [&](auto nn) -> int {
    if (value) return lanes(nn, std::integral_constant<int, 2>());
    return reverse ? lanes(nn, std::integral_constant<int, 1>())
                   : lanes(nn, std::integral_constant<int, 0>());
  };
  if (n == 2) return kind(std::integral_constant<int, 2>());
  if (n == 3) return kind(std::integral_constant<int, 3>());
  if (n == 4) return kind(std::integral_constant<int, 4>());
  return -1;
}

}  // namespace

// C entry points, bound with ctypes.  `dtype` is 0 for float32, 1 for
// float64.  Each returns cudaGetLastError() after the launch (0 on success)
// or -1 for a shape with no instantiation; nothing is synchronised.
extern "C" int ipoc_affine_scan(int dtype, int n, int reverse, int P, const void* F,
                                const void* c, void* Fo, void* co, int B,
                                int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[2] = {F, c};
  void* out[2] = {Fo, co};
  auto go = [&](auto l) { return l.launch(in, out, B, T, s); };
  if (dtype == 0) return with_scan<float>(false, n, P, reverse, go);
  if (dtype == 1) return with_scan<double>(false, n, P, reverse, go);
  return -1;
}

// The affine scan's launch geometry and residency for (dtype, n, P) in its
// suffix mode: six ints, as launch_attr.cuh kernel_occupancy.
extern "C" int ipoc_affine_scan_occupancy(int dtype, int n, int P, int* out) {
  auto go = [&](auto l) { return l.occupancy(out); };
  if (dtype == 0) return with_scan<float>(false, n, P, 1, go);
  if (dtype == 1) return with_scan<double>(false, n, P, 1, go);
  return -1;
}

// The value scan at P lanes per scenario.
extern "C" int ipoc_value_scan(int dtype, int n, int P, const void* A, const void* b,
                               const void* C, const void* eta, const void* J,
                               void* Ao, void* bo, void* Co, void* etao,
                               void* Jo, int B, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[5] = {A, b, C, eta, J};
  void* out[5] = {Ao, bo, Co, etao, Jo};
  auto go = [&](auto l) { return l.launch(in, out, B, T, s); };
  if (dtype == 0) return with_scan<float>(true, n, P, 1, go);
  if (dtype == 1) return with_scan<double>(true, n, P, 1, go);
  return -1;
}

// The value scan's launch geometry and residency for (dtype, n, P): six
// ints, as launch_attr.cuh kernel_occupancy.
extern "C" int ipoc_value_scan_occupancy(int dtype, int n, int P, int* out) {
  auto go = [&](auto l) { return l.occupancy(out); };
  if (dtype == 0) return with_scan<float>(true, n, P, 1, go);
  if (dtype == 1) return with_scan<double>(true, n, P, 1, go);
  return -1;
}

// The trial's entries, one library object per dtype (par_trial_f32.cu,
// par_trial_f64.cu): they build in parallel.
extern "C" int ipoc_par_trial_launch_f32(int, int, int, const void* const*, void*, void*, void*,
                                         void*, void*, int, int, void*);
extern "C" int ipoc_par_trial_launch_f64(int, int, int, const void* const*, void*, void*, void*,
                                         void*, void*, int, int, void*);
extern "C" int ipoc_par_trial_occupancy_f32(int, int, int, int*);
extern "C" int ipoc_par_trial_occupancy_f64(int, int, int, int*);

extern "C" int ipoc_par_newton_trial(int dtype, int nx, int nu, int P,
                                     const void* ru, const void* Q,
                                     const void* R, const void* M,
                                     const void* fx, const void* fu,
                                     const void* XT, void* gains, void* du,
                                     void* dx, void* pred, void* ok, int B,
                                     int T, void* stream) {
  const void* in[7] = {ru, Q, R, M, fx, fu, XT};
  if (dtype == 0)
    return ipoc_par_trial_launch_f32(nx, nu, P, in, gains, du, dx, pred, ok, B, T, stream);
  if (dtype == 1)
    return ipoc_par_trial_launch_f64(nx, nu, P, in, gains, du, dx, pred, ok, B, T, stream);
  return -1;
}

// The trial's launch geometry and residency for (dtype, nx, nu, P): six
// ints, as par_trial.cuh TrialLaunch::occupancy.
extern "C" int ipoc_par_trial_occupancy(int dtype, int nx, int nu, int P,
                                        int* out) {
  if (dtype == 0) return ipoc_par_trial_occupancy_f32(nx, nu, P, out);
  if (dtype == 1) return ipoc_par_trial_occupancy_f64(nx, nu, P, out);
  return -1;
}
