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
// over the whole horizon.  The value scan runs one block of kScanThreads =
// 128 threads per scenario (the grid is B blocks), each thread a
// contiguous chunk of ceil(T / 128) stages: the thread combines its chunk
// serially in registers, the block scans the 128 chunk aggregates in
// shared memory (scan.cuh block_carry, double-buffered, 2 x 128 elements),
// and the thread walks its chunk again from the carried-in aggregate.  No
// horizon cap: only the chunk grows with T.
//
// The affine scan ran so too.  What bounded it on an H100 (700 W), at B =
// 1024, T = 101 (the costates of solve_batch(method="par")): its C entry
// took 0.066 ms against a byte bound of 0.0049; without the block's 7
// rounds 0.025 (each a barrier and 128 combines where the work needs
// 99); the rest was the two walks' loads, each thread's rows a chunk apart
// from its neighbours', so every load instruction of a warp touched 32
// lines.  Its design (affine_scan.h): P lanes per scenario by the launch
// rule (ops/scan_kernels.py scan_lanes: at this batch 64 in float32, 32
// in float64; 256 for one scenario at T = 1001), the chunks staged through
// shared memory in tiles whose copies and stores are whole lines, the
// chunk aggregates scanned inside each warp by shuffles and over the
// warps' totals with one barrier.  C entry 0.066 -> 0.011-0.020 ms at
// B = 1024 (float64 0.146 -> 0.015-0.020), 0.049 -> 0.011-0.019 at B = 1,
// the spread from call to call (PERF.md sections 5 and 7).
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
using ipoc::block_carry;
using ipoc::copy_elem;
using ipoc::kernel_occupancy;
using ipoc::kScanThreads;
using ipoc::ScanExec;
using ipoc::thread_chunk;
using ipoc::ValueOp;

// The affine scan of one scenario per P threads (affine_scan.h).
template <typename scalar_t, int N, int P, bool REVERSE>
__global__ void __launch_bounds__(AffineScan<scalar_t, N, P, REVERSE>::kBlock)
affine_scan_kernel(const scalar_t* __restrict__ F,  // (B, T, N, N)
                   const scalar_t* __restrict__ c,  // (B, T, N)
                   scalar_t* __restrict__ Fo,       // (B, T, N, N)
                   scalar_t* __restrict__ co,       // (B, T, N)
                   int B, int T) {
  using Sc = AffineScan<scalar_t, N, P, REVERSE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* sh = reinterpret_cast<scalar_t*>(smem_raw);
  const int within = static_cast<int>(threadIdx.x) / P;  // scenario in block
  const int b = static_cast<int>(blockIdx.x) * Sc::kScenarios + within;
  if (b >= B) return;  // the scenario's P threads leave together
  const auto s = Sc::scenario(F, c, Fo, co, b, T);
  typename Sc::Lane lane;
  Sc::init(lane, static_cast<int>(threadIdx.x) % P, T);
  ScanExec<typename Sc::Lane, P> ex{lane};
  Sc::schedule(ex, s, sh + within * Sc::kShared);
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

template <typename scalar_t, int N, int P, bool REVERSE>
struct ScanLaunch {
  using Sc = AffineScan<scalar_t, N, P, REVERSE>;
  static constexpr size_t smem = Sc::kScenarios * Sc::kShared * sizeof(scalar_t);

  static int launch(const void* F, const void* c, void* Fo, void* co, int B, int T,
                    cudaStream_t stream) {
    auto kernel = affine_scan_kernel<scalar_t, N, P, REVERSE>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(B + Sc::kScenarios - 1) / Sc::kScenarios, Sc::kBlock, smem, stream>>>(
        static_cast<const scalar_t*>(F), static_cast<const scalar_t*>(c),
        static_cast<scalar_t*>(Fo), static_cast<scalar_t*>(co), B, T);
    return static_cast<int>(cudaGetLastError());
  }

  // launch_attr.cuh kernel_occupancy.
  static int occupancy(int* out) {
    return kernel_occupancy(affine_scan_kernel<scalar_t, N, P, REVERSE>, Sc::kBlock, smem,
                            Sc::kScenarios, out);
  }
};

// fn(ScanLaunch<scalar_t, n, P, reverse>()); -1 for an n or P with no
// instantiation.
template <typename scalar_t, class Fn>
int with_scan(int n, int P, int reverse, Fn&& fn) {
  auto lanes = [&](auto nn, auto rev) -> int {
    constexpr int N = decltype(nn)::value;
    constexpr bool R = decltype(rev)::value;
    if (P == 32) return fn(ScanLaunch<scalar_t, N, 32, R>());
    if (P == 64) return fn(ScanLaunch<scalar_t, N, 64, R>());
    if (P == 128) return fn(ScanLaunch<scalar_t, N, 128, R>());
    if (P == 256) return fn(ScanLaunch<scalar_t, N, 256, R>());
    return -1;
  };
  auto dir = [&](auto nn) -> int {
    return reverse ? lanes(nn, std::true_type()) : lanes(nn, std::false_type());
  };
  if (n == 2) return dir(std::integral_constant<int, 2>());
  if (n == 3) return dir(std::integral_constant<int, 3>());
  if (n == 4) return dir(std::integral_constant<int, 4>());
  return -1;
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

template <typename scalar_t>
int dispatch_value(int n, const void* const* in, void* const* out, int B,
                   int T, cudaStream_t s) {
  if (n == 2) return launch_value<scalar_t, 2>(in, out, B, T, s);
  if (n == 3) return launch_value<scalar_t, 3>(in, out, B, T, s);
  if (n == 4) return launch_value<scalar_t, 4>(in, out, B, T, s);
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
  auto go = [&](auto l) { return l.launch(F, c, Fo, co, B, T, s); };
  if (dtype == 0) return with_scan<float>(n, P, reverse, go);
  if (dtype == 1) return with_scan<double>(n, P, reverse, go);
  return -1;
}

// The affine scan's launch geometry and residency for (dtype, n, P) in its
// suffix mode: six ints, as launch_attr.cuh kernel_occupancy.
extern "C" int ipoc_affine_scan_occupancy(int dtype, int n, int P, int* out) {
  auto go = [&](auto l) { return l.occupancy(out); };
  if (dtype == 0) return with_scan<float>(n, P, 1, go);
  if (dtype == 1) return with_scan<double>(n, P, 1, go);
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
