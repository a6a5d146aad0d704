// The lane-open rollout-cost kernel (fused_iter.cuh rollout_cost_kernel)
// as a group schedule over a generated Model, for the kernel and for a
// host build that the CPU tests compile with g++.
//
// x_{t+1} = f(x_t, u_t) from x0 (NX, B) over u (T, NU, B), writing xs
// (T, NX, B) (stages 0..T-1) and xT (NX, B), with the barrier total cost
// sum_t l(x_t, u_t) + l_T(x_T) and sum_t ||cu_t||^2 (B,).  The codegen
// cuts the stage program roll_cost into transition.h's two programs
// (ops/fused_iter.py rollout_cost_parts checks that they are the same):
//
//   Model::transition_step(x, u) -> x_next: the chain, the dynamics alone;
//   Model::transition_eval(x, u, bp) -> the stage cost and ||cu||^2, each
//       as the pair of operands whose product it is.
//
// One group of G lanes per scenario, S = 32 / G scenarios to a one-warp
// block; the horizon in chunks of W stages (W a multiple of G), unrolled.
// Every lane of a group runs the chain, and lane r keeps the state and
// the control of the chunk's stages r, r + G, ... in its own registers, a
// select as the chain passes them, so no shared memory is in the warp.
// One step per chunk j, on every lane:
//
//   share: the group's evaluations of chunk j - 2, by shuffles;
//   sum:   those, into the cost and sum ||cu||^2, stage by stage in order
//          (a + x * y: the product contracts into the sum as in the
//          one-thread loop);
//   eval:  the kept stages of chunk j - 1 (W / G a lane);
//   chain: chunk j's stages, each with its control loaded a chunk before;
//   store: chunk j's kept states, each lane its own stages;
//   load:  the controls of chunk j + 1 into registers.
//
// So the chain carries the dynamics alone, with all of its arithmetic in
// the one-thread loop's order (the results equal that loop's bit for bit
// where nvcc contracts both alike), and the evaluation (two logs, a rem
// and the divisions at cartpole), the loads and the stores are spread
// over the group's lanes, off it.  final_cost runs at the end on each
// group's lane 0.  A scenario past B runs on scenario B - 1's data and
// writes nothing.
//
// G = 4, W = 4 (8 scenarios a block, one stage a lane a chunk): on an
// H100 (700 W) at B = 4096, T = 100 it ran faster than G, W = (8, 8),
// (4, 8), (2, 8), (8, 16), one lane with the evaluation a chunk behind
// in the loop ((1, 8), slower than the parent) and transition.h's
// schedule with one candidate, which stages x through shared memory
// (PERF.md section 6).

#pragma once

#include "lane.h"          // load_col, store_col
#include "riccati_rows.h"  // kRowWarp, WarpExec, GroupExec

namespace ipoc {

template <typename Model, typename scalar_t, int G_ = 4, int W_ = 4>
struct RollCost {
  static_assert(W_ % G_ == 0 && kRowWarp % G_ == 0, "W: a multiple of G, G | 32");
  static constexpr int NX = Model::NX, NU = Model::NU;
  static constexpr int G = G_;            // lanes per scenario
  static constexpr int W = W_;            // stages per chunk
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  static constexpr int K = W / G;         // stages of a chunk each lane keeps
  static constexpr int NE = 4;            // cost (a, b), ||cu||^2 (a, b)

  struct Lane {
    int s, r, b;              // scenario in the block, lane in its group, column read
    bool valid;               // the scenario lies below B: it writes
    scalar_t bp;
    scalar_t x[NX];           // the chain's carry
    scalar_t u[W][NU];        // this chunk's controls
    scalar_t un[W][NU];       // the next chunk's, in flight
    scalar_t xk[K][NX];       // the kept stages r, r + G, ... of the last chunk
    scalar_t uk[K][NU];
    scalar_t ev[K][NE];       // their evaluations
    scalar_t sv[W][NE];       // the group's evaluations of a chunk, in stage order
    scalar_t cost, cun;
  };

  struct Block {
    const scalar_t* us;  // (T, NU, B)
    scalar_t* xs;        // (T, NX, B)
    int B, T, b0, nvalid;
  };

  IPOC_HD static int chunks(int T) { return (T + W - 1) / W; }

  // Chunk j's controls into un (the stages past T keep what they held).
  IPOC_HD static void load(const Block& k, Lane& L, int j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int t = j * W + w;
      if (t < k.T) load_col<scalar_t, NU>(L.un[w], k.us + (size_t)t * NU * k.B, k.B, L.b);
    }
  }

  // The sums over chunk j's stages (those before 0 or past T leave them).
  IPOC_HD static void sum(const Block& k, Lane& L, int j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int t = j * W + w;
      const bool live = t >= 0 && t < k.T;
      const scalar_t cost = L.cost + L.sv[w][0] * L.sv[w][1];
      const scalar_t cun = L.cun + L.sv[w][2] * L.sv[w][3];
      L.cost = live ? cost : L.cost;
      L.cun = live ? cun : L.cun;
    }
  }

  // The kept stages' evaluations (of the last chunk the chain ran).
  IPOC_HD static void eval(Lane& L) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      scalar_t cst[2], cu[2];
      Model::template transition_eval<scalar_t>(L.xk[q], L.uk[q], &L.bp, cst, cu);
      L.ev[q][0] = cst[0];
      L.ev[q][1] = cst[1];
      L.ev[q][2] = cu[0];
      L.ev[q][3] = cu[1];
    }
  }

  // Chunk j's stages (those past T leave x as it is), keeping this lane's.
  IPOC_HD static void chain(const Block& k, Lane& L, int j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const bool keep = w % G == L.r;
#pragma unroll
      for (int i = 0; i < NX; ++i) L.xk[w / G][i] = keep ? L.x[i] : L.xk[w / G][i];
#pragma unroll
      for (int i = 0; i < NU; ++i) L.uk[w / G][i] = keep ? L.u[w][i] : L.uk[w / G][i];
      scalar_t xn[NX];
      Model::template transition_step<scalar_t>(L.x, L.u[w], xn);
      const bool live = j * W + w < k.T;
#pragma unroll
      for (int i = 0; i < NX; ++i) L.x[i] = live ? xn[i] : L.x[i];
    }
  }

  // Chunk j's kept states.
  IPOC_HD static void store(const Block& k, const Lane& L, int j) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int t = j * W + q * G + L.r;
      if (L.valid && t < k.T)
        store_col<scalar_t, NX>(k.xs + (size_t)t * NX * k.B, L.xk[q], k.B, L.b);
    }
  }

  // The rollout of one block; `ex(f)` runs f(lane) for each of its 32
  // lanes, then a barrier over them, and `ex.share<G>(get, put)` gives
  // each lane every value get(lane) of its group.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Block& k, const scalar_t* x0,
                               const scalar_t* bp, scalar_t* xT_o, scalar_t* cost_o,
                               scalar_t* cun_o) {
    const int NC = chunks(k.T);
    ex([&](Lane& L) {
      L.valid = L.s < k.nvalid;
      L.b = k.b0 + (L.valid ? L.s : k.nvalid - 1);
      L.bp = bp[L.b];
      load_col<scalar_t, NX>(L.x, x0, k.B, L.b);
      L.cost = L.cun = scalar_t(0);
#pragma unroll
      for (int q = 0; q < K; ++q) {
#pragma unroll
        for (int i = 0; i < NX; ++i) L.xk[q][i] = L.x[i];
#pragma unroll
        for (int i = 0; i < NU; ++i) L.uk[q][i] = scalar_t(0);
#pragma unroll
        for (int e = 0; e < NE; ++e) L.ev[q][e] = scalar_t(0);
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < NU; ++i) L.u[w][i] = L.un[w][i] = scalar_t(0);
      load(k, L, 0);
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < NU; ++i) L.u[w][i] = L.un[w][i];
    });
    for (int j = 0; j < NC + 2; ++j) {
      // ev holds chunk j - 2's evaluations.
      if constexpr (G > 1) {
#pragma unroll
        for (int q = 0; q < K; ++q)
#pragma unroll
          for (int e = 0; e < NE; ++e)
            ex.template share<G>([&](const Lane& L) { return L.ev[q][e]; },
                                 [&](Lane& L, int g, scalar_t v) { L.sv[q * G + g][e] = v; });
      }
      ex([&](Lane& L) {
        if constexpr (G == 1) {
#pragma unroll
          for (int w = 0; w < W; ++w)
#pragma unroll
            for (int e = 0; e < NE; ++e) L.sv[w][e] = L.ev[w][e];
        }
        load(k, L, j + 1);
        // The sums, the evaluation and the chain run unguarded, one
        // straight run of code.
        sum(k, L, j - 2);
        eval(L);
        chain(k, L, j);
        store(k, L, j);
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int i = 0; i < NU; ++i) L.u[w][i] = L.un[w][i];
      });
    }
    ex([&](Lane& L) {
      if (L.r != 0 || !L.valid) return;
      scalar_t cT;
      Model::template final_cost<scalar_t>(L.x, &cT);
      store_col<scalar_t, NX>(xT_o, L.x, k.B, L.b);
      cost_o[L.b] = L.cost + cT;
      cun_o[L.b] = L.cun;
    });
  }

  IPOC_HD static Block block(const scalar_t* us, scalar_t* xs, int B, int T, int blk) {
    const int b0 = blk * S;
    return Block{us, xs, B, T, b0, B - b0 < S ? B - b0 : S};
  }

  IPOC_HD static int blocks(int B) { return (B + S - 1) / S; }
};

#ifndef __CUDACC__
// The rollout cost on the host, block by block, each block's 32 lanes
// stepped through every step in turn.
template <typename Model, typename scalar_t, int G = 4, int W = 4>
void rollout_cost_host(const scalar_t* us, const scalar_t* x0, const scalar_t* bp,
                       scalar_t* xs, scalar_t* xT, scalar_t* cost, scalar_t* cun,
                       int B, int T) {
  using Rc = RollCost<Model, scalar_t, G, W>;
  for (int blk = 0; blk < Rc::blocks(B); ++blk) {
    typename Rc::Lane lanes[kRowWarp];
    for (int l = 0; l < kRowWarp; ++l) {
      lanes[l].s = l / G;
      lanes[l].r = l % G;
    }
    GroupExec<typename Rc::Lane, kRowWarp> ex{lanes};
    Rc::schedule(ex, Rc::block(us, xs, B, T, blk), x0, bp, xT, cost, cun);
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
