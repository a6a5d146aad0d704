// The resident mega kernel and the merged one-launch trial for Hopper
// (sm_90a), templated on a generated model, on the dtype and on the mode
// (Newton, or IP-DDP with DDP = true).
//
// Replaces, from ipoc_tpu/ops/pallas/:
//   * merged_trial_kernel <- fused_iter_kernel.py:1206
//     _fused_iter_merged_kernel: one trial per launch, the backward sweep
//     and then the forward sweep, the gains through a (T, (1+NX)*NU, B)
//     scratch array.  Newton mode is fused_bwd + fused_fwd in one launch;
//     DDP mode contracts the stage data with the value gradient Vx (Vx
//     starts at the terminal gradient) and rolls the trial out through the
//     true dynamics in closed loop (the DDP evaluator of the packed
//     stream).  One warp per block, a group of G lanes per scenario
//     through both sweeps: the schedule of merged_trial.h (host and
//     device; the CPU tests build it with g++);
//   * mega_kernel <- mega_kernel.py:1148 _mega_kernel and :1240
//     _mega_streamed_kernel: k lane iterations per launch, one thread per
//     scenario, each the trial, the accept/Levenberg-Marquardt update, the
//     convergence tests and, for a lane that rolls over to the next barrier
//     stage, the stage transition with the central-path predictor;
//     per-lane semantics are packed_lane_iter's (solvers/packed_stream.py).
//
// merged_trial_kernel.
//   What bounded the one-thread kernel it replaces (lane.h's two sweeps
//   through the mega kernel's ring): one warp per SM at B = 4096, each
//   thread the whole stage programs and Riccati step on its serial chain,
//   3,720-4,120 cycles per stage for the two sweeps at T = 25 in float32
//   on an H100 (700 W), and one memory round trip at each sweep's start
//   that nothing hid (PERF.md section 5).
//   What the design does: the two sweeps are the group schedules of the
//   two-launch arm (fused_bwd.h, fused_fwd.h) at one group size, so a warp
//   holds G times the scenarios' lanes and the calls, the evaluations and
//   the loads leave the chains; what lies between the sweeps (the gains of
//   the first chunk, the first chunks' x and u) is kept in or fetched into
//   shared memory during the backward sweep (merged_trial.h).  Registers,
//   shared memory and resident blocks per SM: chip_smoke.py phase 0.
//
// mega_kernel.
//   The lane's iteration, the sweeps and the transition are lane.h's,
//   shared with a host build that the CPU tests run; this file adds the
//   device's memory policy and the launch.  Layout and state: batch-last
//   like fused_iter.cuh, stage arrays (T, rows, B), per-lane scalars (B,).
//   It updates the lane state in place (xs, xT, u, u_prev and the scalars)
//   and keeps the trial point and the gains in workspace arrays (tx, tu,
//   Kk) that the caller allocates once per stream.  A thread runs its lane
//   until the lane is done or k iterations have passed, so lanes leave the
//   loop independently (the TPU kernel skips an iteration only when a
//   whole chunk is done; the per-lane results are the same).  An inactive
//   lane (active = 0) is not touched.  `steps` is the maximum over lanes of
//   the iterations each ran (one atomicMax), which is the number of
//   iterations in which some active lane was not done.
//   What bounds it on the card: latency.  At B=4096 a launch is 128 warps,
//   about one per SM, each thread a serial chain of 2T dependent stages per
//   iteration (the costates, the value function, the rollout state) and T
//   more when it rolls over.  The design keeps memory off that chain, so
//   that what is left is the stage arithmetic run by one warp (about
//   1,640 instructions per stage-iteration, PERF.md section 5):
//   * stage reads come through a ring in shared memory that cp.async
//     (LDGSTS) fills ahead of the sweep: kRingS slots of kRingW stages, the
//     reads of chunk j + kRingS - 1 started when the sweep enters chunk j, so
//     a stage's rows were requested (kRingS - 1) * kRingW stages of
//     arithmetic before they are needed (about 12 x 1-2 us against an HBM
//     round trip of about 1 us).  Each thread copies its own lane's
//     elements (4 or 8 bytes), so the warp's 32 copies of a row are one
//     coalesced line for any B and alignment, and a thread reads back only
//     what it copied: no barrier between threads, and lanes of a warp may
//     diverge freely;
//   * the iterate ping-pongs between the lane's fields and the workspace
//     (lane.h), so an accept and taking the predictor's candidate copy
//     nothing; a lane that ends a launch in the workspace copies back once.
//   The TPU kernel's VMEM windows and DMA semaphores have no other
//   counterpart.  A later step spreads a lane's carry-independent
//   arithmetic over a second warp (ROADMAP.md).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_iter.cuh"
#include "lane.h"
#include "merged_trial.h"
#include "scalar_math.h"

namespace ipoc {

constexpr int kRingW = 4;  // stages per ring slot
constexpr int kRingS = 4;  // slots

// The mega kernel's ring bytes per block: the forward sweep's rows (x, u,
// the gains), the most any sweep reads per stage.
template <typename Model, typename scalar_t>
constexpr size_t ring_bytes() {
  return (size_t)kRingS * kRingW *
         (Model::NX + Model::NU + (1 + Model::NX) * Model::NU) *
         kFusedThreads * sizeof(scalar_t);
}

// Stage reads through the block's cp.async ring in dynamic shared memory.
// Host-device so that lane.h's host-device templates may take it; only the
// device pass has a body.
struct RingStages {
  unsigned char* ring;

  template <typename scalar_t, int N0, int N1, int N2>
  struct Reader {
    static constexpr int R = N0 + N1 + N2;  // rows per stage
    scalar_t* col;  // this thread's column: row r of stage w of slot s at
                    // col[((s * kRingW + w) * R + r) * kFusedThreads]
    const scalar_t *s0, *s1, *s2;
    int B, b, T;
    bool fwd;

    // Starts the reads of the sweep's first kRingS - 1 chunks.
    IPOC_HD Reader(const RingStages& m, const scalar_t* a0,
                   const scalar_t* a1, const scalar_t* a2, int B_, int b_,
                   int T_, bool fwd_)
        : s0(a0), s1(a1), s2(a2), B(B_), b(b_), T(T_), fwd(fwd_) {
#ifdef __CUDA_ARCH__
      col = reinterpret_cast<scalar_t*>(m.ring) + threadIdx.x;
#pragma unroll
      for (int j = 0; j < kRingS - 1; ++j) fetch(j);
#endif
    }

    // The rows of stage t; called for every stage, in sweep order.  On
    // entering chunk j it starts chunk j + kRingS - 1 and waits for chunk j.
    IPOC_HD void get(int t, scalar_t* r0, scalar_t* r1, scalar_t* r2) {
#ifdef __CUDA_ARCH__
      const unsigned i = fwd ? t : T - 1 - t;
      const unsigned w = i % kRingW, j = i / kRingW;
      if (w == 0) {
        fetch(j + kRingS - 1);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingS - 1)
                     : "memory");
      }
      const scalar_t* d = col + ((j % kRingS) * kRingW + w) * R * kFusedThreads;
#pragma unroll
      for (int r = 0; r < N0; ++r) r0[r] = d[r * kFusedThreads];
#pragma unroll
      for (int r = 0; r < N1; ++r) r1[r] = d[(N0 + r) * kFusedThreads];
#pragma unroll
      for (int r = 0; r < N2; ++r) r2[r] = d[(N0 + N1 + r) * kFusedThreads];
#endif
    }

#ifdef __CUDA_ARCH__
    template <int N>
    __device__ __forceinline__ void rows(scalar_t* d, const scalar_t* src,
                                         int t) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(d + r * kFusedThreads));
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                     "l"(src + ((size_t)t * N + r) * B + b),
                     "n"(sizeof(scalar_t))
                     : "memory");
      }
    }

    // Chunk j's stages into slot j % kRingS, as one commit group (empty
    // past the sweep's end, which keeps the group count uniform).
    __device__ __forceinline__ void fetch(unsigned j) {
      scalar_t* slot = col + (j % kRingS) * kRingW * R * kFusedThreads;
      // Not unrolled: an unrolled chunk of copies cost the mega kernel
      // registers and spills and 6-9% of its time (PERF.md section 5).
#pragma unroll 1
      for (int w = 0; w < kRingW; ++w) {
        const int i = j * kRingW + w;
        if (i < T) {
          const int t = fwd ? i : T - 1 - i;
          scalar_t* d = slot + w * R * kFusedThreads;
          rows<N0>(d, s0, t);
          rows<N1>(d + N0 * kFusedThreads, s1, t);
          rows<N2>(d + (N0 + N1) * kFusedThreads, s2, t);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#endif
  };
};

extern __shared__ __align__(16) unsigned char ipoc_ring[];

template <typename Model, typename scalar_t, bool DDP>
__global__ void __launch_bounds__(kRowWarp)
merged_trial_kernel(const scalar_t* __restrict__ xs,   // (T, NX, B)
                    const scalar_t* __restrict__ us,   // (T, NU, B)
                    const scalar_t* __restrict__ xT,   // (NX, B)
                    const scalar_t* __restrict__ bp,   // (B,)
                    const scalar_t* __restrict__ reg,  // (B,) pre-scaled
                    scalar_t* __restrict__ tu_o,       // (T, NU, B)
                    scalar_t* __restrict__ tx_o,       // (T, NX, B)
                    scalar_t* __restrict__ txT_o,      // (NX, B)
                    scalar_t* __restrict__ cost_o,     // (B,)
                    scalar_t* __restrict__ nc_o,       // (B,)
                    scalar_t* __restrict__ mc_o,       // (B,)
                    scalar_t* __restrict__ dv_o,       // (B,)
                    scalar_t* __restrict__ piv_o,      // (B,)
                    scalar_t* __restrict__ hu_o,       // (B,)
                    scalar_t* __restrict__ cun_o,      // (B,)
                    scalar_t* __restrict__ Kk,         // (T, (1+NX)*NU, B) scratch
                    int B, int T) {
  using Mt = MergedTrial<Model, scalar_t, DDP>;
  // Dynamic: past 48 KB at the quadrotor's (6, 2) in float64 (54,272 bytes
  // in Newton mode), which a static array may not take.
  scalar_t* sh = reinterpret_cast<scalar_t*>(ipoc_ring);
  const typename Mt::Arrays a{xs, us, xT, bp, reg, tu_o, tx_o, txT_o, cost_o,
                              nc_o, mc_o, dv_o, piv_o, hu_o, cun_o, Kk, B, T};
  const int l = static_cast<int>(threadIdx.x);
  const auto k = Mt::block(a, static_cast<int>(blockIdx.x), sh);
  {
    typename Mt::Bwd::Lane lane;
    lane.r = l % Mt::G;
    WarpExec<typename Mt::Bwd::Lane> ex{lane};
    Mt::backward(ex, a, k, l / Mt::G);
  }
  // The forward sweep copies the gains the warp stored: order the stores
  // before those reads.
  __threadfence_block();
  __syncwarp();
  typename Mt::Fwd::Lane lane;
  lane.s = l / Mt::G;
  lane.r = l % Mt::G;
  WarpExec<typename Mt::Fwd::Lane> ex{lane};
  Mt::forward(ex, a, k);
}

template <typename Model, typename scalar_t, bool DDP>
__global__ void __launch_bounds__(kFusedThreads)
mega_kernel(MegaArrays<scalar_t> a, LaneScalars c, int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const LaneRun r =
      mega_lane<Model, scalar_t, DDP>(a, c, k, b, RingStages{ipoc_ring});
  if (r.steps > 0) atomicMax(a.steps, r.steps);
}

// Allow `kernel` the ring's dynamic shared memory where it passes the
// default 48 KB; returns the CUDA status.  Set at every launch, not cached
// in a function-local static: such a static of a template is one object
// across every model library loaded in the process (a unique symbol), and
// the first library's value would stand for all.
template <typename Kernel>
int ring_attribute(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The merged trial's shared memory per block, in bytes.
template <typename Model, typename scalar_t, bool DDP>
constexpr size_t merged_bytes() {
  return MergedTrial<Model, scalar_t, DDP>::kShared * sizeof(scalar_t);
}

template <typename Model, typename scalar_t, bool DDP>
int launch_merged_trial(const void* const* in, void* const* out, int B, int T,
                        cudaStream_t s) {
  using P = const scalar_t*;
  auto o = [out](int i) { return static_cast<scalar_t*>(out[i]); };
  constexpr size_t bytes = merged_bytes<Model, scalar_t, DDP>();
  const int attr = ring_attribute(merged_trial_kernel<Model, scalar_t, DDP>, bytes);
  if (attr != 0) return attr;
  merged_trial_kernel<Model, scalar_t, DDP>
      <<<MergedTrial<Model, scalar_t, DDP>::blocks(B), kRowWarp, bytes, s>>>(
          P(in[0]), P(in[1]), P(in[2]), P(in[3]), P(in[4]), o(0), o(1), o(2),
          o(3), o(4), o(5), o(6), o(7), o(8), o(9), o(10), B, T);
  return static_cast<int>(cudaGetLastError());
}

// The card's view of merged_trial_kernel (launch_attr.cuh kernel_occupancy).
template <typename Model, typename scalar_t, bool DDP>
int merged_occupancy(int* out) {
  return kernel_occupancy(merged_trial_kernel<Model, scalar_t, DDP>, kRowWarp,
                          merged_bytes<Model, scalar_t, DDP>(),
                          MergedTrial<Model, scalar_t, DDP>::S, out);
}

// lane, ws: mega_arrays' order (lane.h); cfg: kLaneScalars doubles.
template <typename Model, typename scalar_t, bool DDP>
int launch_mega(void* const* lane, void* const* ws, const double* cfg, int k,
                int B, int T, cudaStream_t s) {
  constexpr size_t bytes = ring_bytes<Model, scalar_t>();
  const int attr =
      ring_attribute(mega_kernel<Model, scalar_t, DDP>, bytes);
  if (attr != 0) return attr;
  mega_kernel<Model, scalar_t, DDP>
      <<<fused_blocks(B), kFusedThreads, bytes, s>>>(
          mega_arrays<scalar_t>(lane, ws, B, T), lane_scalars(cfg), k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipoc

// The C entry points of the two kernels (added to the model library by
// IPOC_FUSED_ENTRY_POINTS): `dtype` (0 float32, 1 float64) and `ddp` (0
// Newton, 1 DDP) first; they return cudaGetLastError() after the launch, or
// -1 for an unknown dtype.  Nothing is synchronised.
#define IPOC_MODE_DISPATCH(LAUNCH, MODEL, ...)                               \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
  if (dtype == 0 && ddp) return ipoc::LAUNCH<MODEL, float, true>(__VA_ARGS__); \
  if (dtype == 0) return ipoc::LAUNCH<MODEL, float, false>(__VA_ARGS__);     \
  if (dtype == 1 && ddp) return ipoc::LAUNCH<MODEL, double, true>(__VA_ARGS__);\
  if (dtype == 1) return ipoc::LAUNCH<MODEL, double, false>(__VA_ARGS__);    \
  return -1;

#define IPOC_MERGED_ENTRY(MODEL)                                              \
  extern "C" int ipoc_merged_trial(int dtype, int ddp, const void* const* in, \
                                   void* const* out, int B, int T,           \
                                   void* stream) {                           \
    IPOC_MODE_DISPATCH(launch_merged_trial, MODEL, in, out, B, T, s)         \
  }                                                                          \
  extern "C" int ipoc_merged_trial_occupancy(int dtype, int ddp, int* out) { \
    if (dtype == 0 && ddp) return ipoc::merged_occupancy<MODEL, float, true>(out);   \
    if (dtype == 0) return ipoc::merged_occupancy<MODEL, float, false>(out);         \
    if (dtype == 1 && ddp) return ipoc::merged_occupancy<MODEL, double, true>(out);  \
    if (dtype == 1) return ipoc::merged_occupancy<MODEL, double, false>(out);        \
    return -1;                                                               \
  }

// ipoc_ring_layout writes kRingW, kRingS and the mega kernel's ring bytes
// per block for `dtype` to out[0..2].
#define IPOC_MEGA_ENTRY(MODEL)                                               \
  extern "C" int ipoc_mega(int dtype, int ddp, void* const* lane,            \
                           void* const* ws, const double* cfg, int k, int B, \
                           int T, void* stream) {                            \
    IPOC_MODE_DISPATCH(launch_mega, MODEL, lane, ws, cfg, k, B, T, s)        \
  }                                                                          \
  extern "C" int ipoc_ring_layout(int dtype, int* out) {                     \
    out[0] = ipoc::kRingW;                                                   \
    out[1] = ipoc::kRingS;                                                   \
    if (dtype == 0) out[2] = (int)ipoc::ring_bytes<MODEL, float>();          \
    else if (dtype == 1) out[2] = (int)ipoc::ring_bytes<MODEL, double>();    \
    else return -1;                                                          \
    return 0;                                                                \
  }
