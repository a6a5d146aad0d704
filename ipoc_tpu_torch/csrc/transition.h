// The stage-transition kernel (fused_iter.cuh transition_kernel) as a
// block schedule over a generated Model, for the kernel and for a host
// build that the CPU tests compile with g++.
//
// Both candidates of a scenario, the rollout of u (a) and of the
// prediction up (b), run on one group of G = 8 lanes of a one-warp block
// (S = 4 scenarios): candidate a on lanes 0-3, b on lanes 4-7, one program
// on other data, so the warp does not diverge.  The codegen cuts the
// stage program at candidate a's inputs (ops/fused_iter.py
// transition_parts, which checks that candidate b's parts are the same
// programs):
//
//   Model::transition_step(x, u) -> x_next: the chain, the dynamics alone;
//   Model::transition_eval(x, u, bp) -> the stage cost and ||cu||^2, each
//       as the pair of operands whose product it is, recomputed from x_t,
//       u_t and bp (no value crosses from the chain but x_t itself).
//
// Chunks of W = G / 2 stages.  The controls come through a ring in shared
// memory ([u, up][stage][scenario] per slot), copied two chunks ahead as
// runs of the block's S columns (fused_fwd.h BlockRuns).  One step per
// chunk j, on every lane (s, r), candidate c = r / W:
//
//   eval:  the pair (c, stage r % W) of chunk j - 1, from the staged x_t
//          and the ring's u_t (the chunk's 2 W pairs, one a lane);
//   chain: chunk j's stages of candidate c (every lane of the half stages
//          x_t);
//   sum:   chunk j - 2's evaluations, into each candidate's cost and sum
//          ||cu||^2, stage by stage in order;
//   store: chunk j - 1's xa and xb, as runs of S columns;
//
// then the wait for chunk j + 1's copies and one barrier.  final_cost
// runs at the end on each half's first lane.  A scenario past B runs on
// scenario B - 1's data and writes nothing.

#pragma once

#include "fused_fwd.h"  // BlockRuns

namespace ipoc {

template <typename Model, typename scalar_t>
struct Transition {
  static constexpr int NX = Model::NX, NU = Model::NU;
  static constexpr int G = 8;             // lanes per scenario
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  static constexpr int W = G / 2;         // stages per chunk
  static constexpr int kSlots = 4;        // chunk j + 2 is copied during step j (a power of 2)
  static constexpr int R = 2 * NU;        // rows a stage reads: u, up
  static constexpr int NE = 4;            // cost (a, b), ||cu||^2 (a, b)
  using Runs = BlockRuns<scalar_t, S, W>;
  // The block's shared memory, in scalars: the ring [kSlots][R][W][S], the
  // staged states [2][2 NX][W][S] (candidate a's rows, then b's), the
  // evaluations [2][2][NE][W][S].
  static constexpr int kSlot = R * W * S;
  static constexpr int oOut = kSlots * kSlot;
  static constexpr int oEval = oOut + 2 * 2 * NX * W * S;
  static constexpr int kShared = oEval + 2 * 2 * NE * W * S;

  struct Lane {
    int s, r, c;            // scenario in the block, lane in its group, candidate
    scalar_t bp;
    scalar_t x[NX];         // candidate c's state carry
    scalar_t cost[2], cun[2];
  };

  struct Block {
    const scalar_t *us, *ups;  // (T, NU, B) each
    scalar_t *xa, *xb;         // (T, NX, B) each
    int B, T, b0, nvalid;
    scalar_t* sh;
  };

  IPOC_HD static int chunks(int T) { return (T + W - 1) / W; }
  // The stages of chunk j that lie in 0 .. T-1.
  IPOC_HD static int stages(const Block& k, int j) {
    const int n = k.T - j * W;
    return j < 0 || n < 0 ? 0 : (n < W ? n : W);
  }
  // Chunk j's ring slot (j may be negative before the sweep's start).
  IPOC_HD static scalar_t* slot(const Block& k, int j) {
    return k.sh + (j & (kSlots - 1)) * kSlot;
  }
  IPOC_HD static scalar_t* staged(const Block& k, int j) {
    return k.sh + oOut + (j & 1) * 2 * NX * W * S;
  }
  IPOC_HD static scalar_t* evals(const Block& k, int j) {
    return k.sh + oEval + (j & 1) * 2 * NE * W * S;
  }

  IPOC_HD static void fetch(const Block& k, const Lane& L, int j) {
    const int n = stages(k, j), l = L.s * G + L.r;
    if (n > 0) {
      scalar_t* d = slot(k, j);
      const size_t B = static_cast<size_t>(k.B);
      Runs::template fetch<NU>(l, d, j * W, n, k.nvalid, [&](int row, int t) {
        return k.us + ((size_t)t * NU + row) * B + k.b0;
      });
      Runs::template fetch<NU>(l, d + NU * W * S, j * W, n, k.nvalid,
                               [&](int row, int t) {
                                 return k.ups + ((size_t)t * NU + row) * B + k.b0;
                               });
    }
    RingCopy::commit();
  }

  // Candidate c's stages of chunk j (those past T leave x as it is);
  // every lane of the half stages the same x_t.
  IPOC_HD static void chain(const Block& k, Lane& L, int j) {
    const scalar_t* u = slot(k, j) + L.c * NU * W * S + L.s;
    scalar_t* o = staged(k, j) + L.c * NX * W * S + L.s;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      scalar_t uw[NU], xn[NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) uw[i] = u[(i * W + w) * S];
#pragma unroll
      for (int i = 0; i < NX; ++i) o[(i * W + w) * S] = L.x[i];
      Model::template transition_step<scalar_t>(L.x, uw, xn);
      const bool live = j * W + w < k.T;
#pragma unroll
      for (int i = 0; i < NX; ++i) L.x[i] = live ? xn[i] : L.x[i];
    }
  }

  // eval of the pair (c, stage r % W) of chunk j.
  IPOC_HD static void eval(const Block& k, const Lane& L, int j) {
    const int w = L.r % W;
    const scalar_t* u = slot(k, j) + (L.c * NU * W + w) * S + L.s;
    const scalar_t* o = staged(k, j) + (L.c * NX * W + w) * S + L.s;
    scalar_t x[NX], uw[NU], cst[2], cu[2];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = o[i * W * S];
#pragma unroll
    for (int i = 0; i < NU; ++i) uw[i] = u[i * W * S];
    Model::template transition_eval<scalar_t>(x, uw, &L.bp, cst, cu);
    scalar_t* e = evals(k, j) + (L.c * NE * W + w) * S + L.s;
    e[0] = cst[0];
    e[W * S] = cst[1];
    e[2 * W * S] = cu[0];
    e[3 * W * S] = cu[1];
  }

  // Both candidates' sums over chunk j's evaluated stages, in stage order
  // (the stages of chunks before the first or past T leave them as they
  // are).
  IPOC_HD static void sum(const Block& k, Lane& L, int j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const scalar_t* e = evals(k, j) + c * NE * W * S + L.s;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const scalar_t* ew = e + w * S;
        const scalar_t cost = L.cost[c] + ew[0] * ew[W * S];
        const scalar_t cun = L.cun[c] + ew[2 * W * S] * ew[3 * W * S];
        const bool live = j * W + w >= 0 && j * W + w < k.T;
        L.cost[c] = live ? cost : L.cost[c];
        L.cun[c] = live ? cun : L.cun[c];
      }
    }
  }

  IPOC_HD static void store(const Block& k, const Lane& L, int j) {
    const int n = stages(k, j), l = L.s * G + L.r;
    if (n == 0) return;
    const size_t B = static_cast<size_t>(k.B);
    const scalar_t* o = staged(k, j);
    Runs::template store<NX>(l, o, j * W, n, k.nvalid, [&](int row, int t) {
      return k.xa + ((size_t)t * NX + row) * B + k.b0;
    });
    Runs::template store<NX>(l, o + NX * W * S, j * W, n, k.nvalid, [&](int row, int t) {
      return k.xb + ((size_t)t * NX + row) * B + k.b0;
    });
  }

  // The transition of one block; `ex(f)` runs f(lane) for each of its 32
  // lanes, then a barrier over them.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Block& k, const scalar_t* x0,
                               const scalar_t* bp, scalar_t* xaT_o,
                               scalar_t* xbT_o, scalar_t* ca_o, scalar_t* cb_o,
                               scalar_t* cua_o, scalar_t* cub_o) {
    const int C = chunks(k.T);
    ex([&](Lane& L) {
      const int b = k.b0 + (L.s < k.nvalid ? L.s : k.nvalid - 1);
      L.c = L.r / W;
      L.bp = bp[b];
      load_col<scalar_t, NX>(L.x, x0, k.B, b);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        L.cost[c] = scalar_t(0);
        L.cun[c] = scalar_t(0);
      }
      for (int j = 0; j < kSlots - 2; ++j) fetch(k, L, j);
      RingCopy::wait<kSlots - 3>();
    });
    for (int j = 0; j < C + 2; ++j) {
      ex([&](Lane& L) {
        fetch(k, L, j + kSlots - 2);
        // eval, the chain and the sums run unguarded, one straight run of
        // code (fused_fwd.h).
        eval(k, L, j - 1);
        chain(k, L, j);
        sum(k, L, j - 2);
        store(k, L, j - 1);
        RingCopy::wait<kSlots - 3>();
      });
    }
    ex([&](Lane& L) {
      if (L.r % W != 0 || L.s >= k.nvalid) return;
      const int b = k.b0 + L.s;
      scalar_t cT;
      Model::template final_cost<scalar_t>(L.x, &cT);
      store_col<scalar_t, NX>(L.c == 0 ? xaT_o : xbT_o, L.x, k.B, b);
      (L.c == 0 ? ca_o : cb_o)[b] = L.cost[L.c] + cT;
      (L.c == 0 ? cua_o : cub_o)[b] = L.cun[L.c];
    });
  }

  IPOC_HD static Block block(const scalar_t* us, const scalar_t* ups, scalar_t* xa,
                             scalar_t* xb, int B, int T, int blk, scalar_t* sh) {
    const int b0 = blk * S;
    return Block{us, ups, xa, xb, B, T, b0, B - b0 < S ? B - b0 : S, sh};
  }

  IPOC_HD static int blocks(int B) { return (B + S - 1) / S; }
};

#ifndef __CUDACC__
// The transition on the host, block by block, each block's 32 lanes
// stepped through every step in turn.  `sh` holds kShared scalars.
template <typename Model, typename scalar_t>
void transition_host(const scalar_t* us, const scalar_t* ups, const scalar_t* x0,
                     const scalar_t* bp, scalar_t* xa, scalar_t* xb, scalar_t* xaT,
                     scalar_t* xbT, scalar_t* ca, scalar_t* cb, scalar_t* cua,
                     scalar_t* cub, int B, int T, scalar_t* sh) {
  using Tr = Transition<Model, scalar_t>;
  for (int blk = 0; blk < Tr::blocks(B); ++blk) {
    const auto k = Tr::block(us, ups, xa, xb, B, T, blk, sh);
    typename Tr::Lane lanes[kRowWarp];
    for (int l = 0; l < kRowWarp; ++l) {
      lanes[l].s = l / Tr::G;
      lanes[l].r = l % Tr::G;
    }
    GroupExec<typename Tr::Lane, kRowWarp> ex{lanes};
    Tr::schedule(ex, k, x0, bp, xaT, xbT, ca, cb, cua, cub);
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
