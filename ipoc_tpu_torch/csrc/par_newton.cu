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
//     256, 60,192 / 120,384.  At the quadrotor's (6, 2) (E = 120, stride
//     121): 61,952 / 123,904 per 128 threads, 127,776 / 255,552 at P =
//     256, past the 232,448 a block may take, so float64 stops at P = 128
//     (par_trial_62_f64.cu instantiates no more; ops/newton_kernel.py
//     trial_lanes asks for no more).  Residency is set by registers (about
//     200-255 per thread: 8 warps per SM at nx=4), not by shared memory;
//     at (6, 2) float32 takes 255 with 3.7-4.5 KB of spills, float64
//     spills its whole walk (186 KB of spill stores; chip_smoke.py phase
//     0).
//   * Stage rows are loaded in 16- or 8-byte vectors where a row fills them
//     (par_trial.h load_row): 12 load instructions per stage instead of 42
//     at (4, 1) in float32, each still one line per lane.  The gains go
//     through a (B, T, nu*(1+nx)) scratch that each thread writes and reads
//     back itself (L1).

// Generic in dtype (float, double); templated on n and on (NX, NU).

#include <cuda_runtime.h>

#include "scan_launch.cuh"

// The n = 6 scans' entries, one object per scan and dtype (scan_n6_*.cu).
#define IPOC_SCAN_DECLS(tag)                                                     \
  extern "C" int ipoc_scan_launch_##tag(int, int, int, int, const void* const*, \
                                        void* const*, int, int, void*);          \
  extern "C" int ipoc_scan_occupancy_##tag(int, int, int, int*);
IPOC_SCAN_DECLS(n6_affine_f32)
IPOC_SCAN_DECLS(n6_value_f32)
IPOC_SCAN_DECLS(n6_affine_f64)
IPOC_SCAN_DECLS(n6_value_f64)

namespace {

// The scan (value, n, P, reverse) of dtype `dtype` on the rows' pointers:
// n = 2, 3, 4 instantiated here, n = 6 in scan_n6_*.cu.
int scan_launch(int dtype, bool value, int n, int P, int reverse,
                const void* const* ins, void* const* outs, int B, int T,
                cudaStream_t s) {
  using ipoc_scan::kAffine;
  using ipoc_scan::kValue;
  auto go = [&](auto l) { return l.launch(ins, outs, B, T, s); };
  if (n == 6) {
    auto* fn = dtype == 0 ? (value ? ipoc_scan_launch_n6_value_f32 : ipoc_scan_launch_n6_affine_f32)
             : dtype == 1 ? (value ? ipoc_scan_launch_n6_value_f64 : ipoc_scan_launch_n6_affine_f64)
                          : nullptr;
    return fn ? fn(value, n, P, reverse, ins, outs, B, T, s) : -1;
  }
  if (dtype == 0) return ipoc_scan::with_scan<float, kAffine | kValue, 2, 3, 4>(value, n, P, reverse, go);
  if (dtype == 1) return ipoc_scan::with_scan<double, kAffine | kValue, 2, 3, 4>(value, n, P, reverse, go);
  return -1;
}

// The scan's launch geometry and residency (the affine scan's suffix mode).
int scan_occupancy(int dtype, bool value, int n, int P, int* out) {
  using ipoc_scan::kAffine;
  using ipoc_scan::kValue;
  auto go = [&](auto l) { return l.occupancy(out); };
  if (n == 6) {
    auto* fn = dtype == 0 ? (value ? ipoc_scan_occupancy_n6_value_f32 : ipoc_scan_occupancy_n6_affine_f32)
             : dtype == 1 ? (value ? ipoc_scan_occupancy_n6_value_f64 : ipoc_scan_occupancy_n6_affine_f64)
                          : nullptr;
    return fn ? fn(value, n, P, out) : -1;
  }
  if (dtype == 0) return ipoc_scan::with_scan<float, kAffine | kValue, 2, 3, 4>(value, n, P, 1, go);
  if (dtype == 1) return ipoc_scan::with_scan<double, kAffine | kValue, 2, 3, 4>(value, n, P, 1, go);
  return -1;
}

}  // namespace

// C entry points, bound with ctypes.  `dtype` is 0 for float32, 1 for
// float64.  Each returns cudaGetLastError() after the launch (0 on success)
// or -1 for a shape with no instantiation; nothing is synchronised.
extern "C" int ipoc_affine_scan(int dtype, int n, int reverse, int P, const void* F,
                                const void* c, void* Fo, void* co, int B,
                                int T, void* stream) {
  const void* in[2] = {F, c};
  void* out[2] = {Fo, co};
  return scan_launch(dtype, false, n, P, reverse, in, out, B, T,
                     static_cast<cudaStream_t>(stream));
}

// The affine scan's launch geometry and residency for (dtype, n, P) in its
// suffix mode: six ints, as launch_attr.cuh kernel_occupancy.
extern "C" int ipoc_affine_scan_occupancy(int dtype, int n, int P, int* out) {
  return scan_occupancy(dtype, false, n, P, out);
}

// The value scan at P lanes per scenario.
extern "C" int ipoc_value_scan(int dtype, int n, int P, const void* A, const void* b,
                               const void* C, const void* eta, const void* J,
                               void* Ao, void* bo, void* Co, void* etao,
                               void* Jo, int B, int T, void* stream) {
  const void* in[5] = {A, b, C, eta, J};
  void* out[5] = {Ao, bo, Co, etao, Jo};
  return scan_launch(dtype, true, n, P, 1, in, out, B, T,
                     static_cast<cudaStream_t>(stream));
}

// The value scan's launch geometry and residency for (dtype, n, P): six
// ints, as launch_attr.cuh kernel_occupancy.
extern "C" int ipoc_value_scan_occupancy(int dtype, int n, int P, int* out) {
  return scan_occupancy(dtype, true, n, P, out);
}

// The trial's entries, one library object per dtype and shape list
// (par_trial_f32.cu, par_trial_f64.cu, par_trial_62_f32.cu,
// par_trial_62_f64.cu): they build in parallel.
#define IPOC_TRIAL_DECLS(tag)                                                    \
  extern "C" int ipoc_par_trial_launch_##tag(int, int, int, const void* const*, \
                                             void*, void*, void*, void*, void*,  \
                                             int, int, void*);                   \
  extern "C" int ipoc_par_trial_occupancy_##tag(int, int, int, int*);
IPOC_TRIAL_DECLS(f32)
IPOC_TRIAL_DECLS(f64)
IPOC_TRIAL_DECLS(62_f32)
IPOC_TRIAL_DECLS(62_f64)

extern "C" int ipoc_par_newton_trial(int dtype, int nx, int nu, int P,
                                     const void* ru, const void* Q,
                                     const void* R, const void* M,
                                     const void* fx, const void* fu,
                                     const void* XT, void* gains, void* du,
                                     void* dx, void* pred, void* ok, int B,
                                     int T, void* stream) {
  const void* in[7] = {ru, Q, R, M, fx, fu, XT};
  const bool quad = nx == 6 && nu == 2;
  if (dtype == 0)
    return (quad ? ipoc_par_trial_launch_62_f32 : ipoc_par_trial_launch_f32)(
        nx, nu, P, in, gains, du, dx, pred, ok, B, T, stream);
  if (dtype == 1)
    return (quad ? ipoc_par_trial_launch_62_f64 : ipoc_par_trial_launch_f64)(
        nx, nu, P, in, gains, du, dx, pred, ok, B, T, stream);
  return -1;
}

// The trial's launch geometry and residency for (dtype, nx, nu, P): six
// ints, as par_trial.cuh TrialLaunch::occupancy.
extern "C" int ipoc_par_trial_occupancy(int dtype, int nx, int nu, int P,
                                        int* out) {
  const bool quad = nx == 6 && nu == 2;
  if (dtype == 0)
    return (quad ? ipoc_par_trial_occupancy_62_f32 : ipoc_par_trial_occupancy_f32)(
        nx, nu, P, out);
  if (dtype == 1)
    return (quad ? ipoc_par_trial_occupancy_62_f64 : ipoc_par_trial_occupancy_f64)(
        nx, nu, P, out);
  return -1;
}
