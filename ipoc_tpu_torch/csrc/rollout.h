// The open-loop rollout (fused_iter.cuh rollout_kernel) as one lane's
// loop over a generated Model, for the kernel and for a host build that
// the CPU tests compile with g++.
//
// x_{t+1} = Model::dynamics(x_t, u_t) from x0 (NX, B) over u (T, NU, B),
// writing xs (T, NX, B) (stages 0..T-1) and xT (NX, B).  One lane per
// scenario, 32 scenarios to a one-warp block: neighbouring lanes read and
// write neighbouring addresses, so each load and store of a warp is one
// coalesced run.  The chain is Model::dynamics alone, with all of its own
// arithmetic, in the order of the one-thread loop it replaces (x_t stored,
// then the step), so the results equal that loop's bit for bit.  The
// horizon goes in chunks of W stages, unrolled: the controls of chunk
// j + 1 are loaded into registers at the start of chunk j, so no load is
// on the chain, and the stores leave from registers.  W is 8 in float32;
// in float64, whose sin and cos run to hundreds of instructions and whose
// chain hides a load's latency by itself, every longer chunk ran slower
// than W = 1 (one stage ahead) on an H100 (PERF.md section 6).  A lane
// past B does nothing.
//
// The block schedules of transition.h with one candidate ran slower on an
// H100: with no evaluation to spread over a group, the lanes of a group
// only repeat the chain, and the staging through shared memory puts its
// loads and stores in the chain's warp.  So did a queue of controls that
// a rolled loop shifts each stage (a register move waits for the load in
// flight).

#pragma once

#include "lane.h"  // load_col, store_col, IPOC_HD

namespace ipoc {

constexpr int kRolloutWarp = 32;  // scenarios per block (one warp)

// Stages per chunk.
template <typename scalar_t>
constexpr int rollout_chunk() { return sizeof(scalar_t) == 4 ? 8 : 1; }

template <typename Model, typename scalar_t, int W = rollout_chunk<scalar_t>()>
struct Rollout {
  static constexpr int NX = Model::NX, NU = Model::NU;
  static constexpr int S = kRolloutWarp;

  // Scenario b's rollout.
  IPOC_HD static void run(const scalar_t* us, const scalar_t* x0, scalar_t* xs,
                          scalar_t* xT, int B, int T, int b) {
    const size_t row = static_cast<size_t>(NU) * B;
    scalar_t x[NX], u[W][NU], un[W][NU] = {};
    load_col<scalar_t, NX>(x, x0, B, b);
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w < T) load_col<scalar_t, NU>(u[w], us + w * row, B, b);
    for (int t0 = 0; t0 < T; t0 += W) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (t0 + W + w < T) load_col<scalar_t, NU>(un[w], us + (t0 + W + w) * row, B, b);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (t0 + w < T) {
          scalar_t xn[NX];
          store_col<scalar_t, NX>(xs + static_cast<size_t>(t0 + w) * NX * B, x, B, b);
          Model::template dynamics<scalar_t>(x, u[w], xn);
#pragma unroll
          for (int i = 0; i < NX; ++i) x[i] = xn[i];
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < NU; ++i) u[w][i] = un[w][i];
    }
    store_col<scalar_t, NX>(xT, x, B, b);
  }

  IPOC_HD static int blocks(int B) { return (B + S - 1) / S; }
};

#ifndef __CUDACC__
// The rollout on the host, scenario by scenario.
template <typename Model, typename scalar_t, int W = rollout_chunk<scalar_t>()>
void rollout_host(const scalar_t* us, const scalar_t* x0, scalar_t* xs,
                  scalar_t* xT, int B, int T) {
  for (int b = 0; b < B; ++b) Rollout<Model, scalar_t, W>::run(us, x0, xs, xT, B, T, b);
}
#endif  // !__CUDACC__

}  // namespace ipoc
