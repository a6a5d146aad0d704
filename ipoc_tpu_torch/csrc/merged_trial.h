// The merged one-launch trial (mega.cuh merged_trial_kernel) as a block
// schedule over a generated Model, Newton or DDP mode, for the kernel and
// for a host build that the CPU tests compile with g++.
//
// One block is one warp of S = 32 / G scenarios, a group of G lanes each,
// G = RowStep's (4 at nx = 3, 4; 2 at nx = 2), in both sweeps (groups of
// 8, 4 scenarios a warp, ran 12-25% slower at cartpole: PERF.md section
// 5): the
// backward sweep is fused_bwd.h's group schedule (the cooperative Riccati
// step of riccati_rows.h, RowStep<..., DDP>; in DDP mode the costate
// argument of the stage program is Vx), the forward sweep fused_fwd.h's
// block schedule instantiated at the same G (chunks of W = G stages; in
// DDP mode the chain is stage_ddp_fwd_step and the evaluation, a chunk
// behind and spread over the group's lanes, stage_fwd_eval).  One warp
// runs both, so nothing crosses between blocks or launches.
//
// What lies between the sweeps is taken off the chain:
//   * the gains of stages 0 .. W - 1 (the forward sweep's first chunk,
//     which the backward sweep computes last) go into the forward ring's
//     slot 0 in shared memory, not to Kk; Kk holds the other stages', as
//     in the two-launch arm;
//   * the copies of x and u of the forward sweep's first kSlots - 1 chunks
//     (one commit group) are issued at the start of the backward sweep's
//     second-to-last chunk;
//   * at the forward sweep's start only the gains of chunks 1 and 2 are
//     copied (from Kk, after a fence over the block); chunk 0 is in the
//     ring already, so the DDP chain starts at once, and those copies have
//     chunk 0's W stages of chain to arrive in.  (Newton mode pre-evaluates
//     chunk 1 at once and waits for its gains: it is on no path.)
//
// Shared memory per block: the forward schedule's (ring, handoffs -- none
// in DDP mode --, staged trial point, evaluations), then the backward
// schedule's (handoffs, exchange slices): cartpole 15,104 bytes in
// float32 and 30,208 in float64 in Newton mode, 11,776 and 23,552 in DDP
// mode; pendulum (16 scenarios a block) 9,984 / 19,968 and 8,192 /
// 16,384.  Registers and resident blocks per SM: chip_smoke.py phase 0
// (cartpole float32 117 and 111 registers, 14 and 16 blocks; float64 182
// and 165, 7 and 9; no spills).  The arithmetic is the
// one-thread kernel's (lane.h trial_backward and trial_forward): the
// stage programs' DAG nodes and riccati_step's operations in their order.
// A scenario past B (the last block's) runs on scenario B - 1's data and
// writes nothing.

#pragma once

#include "fused_bwd.h"
#include "fused_fwd.h"

namespace ipoc {

template <typename Model, typename scalar_t, bool DDP>
struct MergedTrial {
  using Bwd = FusedBwd<Model, scalar_t, DDP>;
  static constexpr int G = Bwd::G;
  using Fwd = FusedFwd<Model, scalar_t, G, DDP>;
  static constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  static constexpr int S = Bwd::S, W = Fwd::W;
  static_assert(Fwd::S == S, "one block holds the same scenarios in both sweeps");
  // The forward schedule's shared memory first (its ring takes 16-byte
  // copies), then the backward schedule's.
  static constexpr int oBwd = Fwd::kShared;
  static constexpr int kShared = oBwd + Bwd::kShared;

  using Block = typename Fwd::Block;

  struct Arrays {
    const scalar_t *xs, *us, *xT, *bp, *reg;  // (T, NX, B), (T, NU, B), (NX, B), (B,) x 2
    scalar_t *tu, *tx, *txT;                  // (T, NU, B), (T, NX, B), (NX, B)
    scalar_t *cost, *nc, *mc, *dv, *piv, *hu, *cun;  // (B,) each
    scalar_t* Kk;                             // (T, NG, B) scratch
    int B, T;
  };

  IPOC_HD static Block block(const Arrays& a, int blk, scalar_t* sh) {
    return Fwd::block(a.xs, a.us, a.Kk, a.tu, a.tx, a.B, a.T, blk, sh);
  }

  // The backward sweep of scenario s of block k; `ex` runs its G lanes.
  template <class Exec>
  IPOC_HD static void backward(Exec& ex, const Arrays& a, const Block& k, int s) {
    const auto sc = Bwd::scenario(a.xs, a.us, a.bp, a.reg, a.Kk, k.b0 + s, a.B,
                                  a.T, s, k.sh + oBwd);
    const int C = Bwd::chunks(a.T);
    const int c_pre = C >= 2 ? C - 2 : 0;
    // Column s of chunk 0's gains rows in the forward ring.
    scalar_t* g0 = Fwd::slot(k, 0) + (NX + NU) * W * S + s;
    Bwd::schedule(
        ex, sc, a.xT, a.cost, a.dv, a.piv, a.hu,
        [&](const typename Bwd::Lane& L, int t) {
          if (t >= W) {
            Bwd::store_gains(sc, L, t);
            return;
          }
          if (Bwd::Step::owns(L)) {
#pragma unroll
            for (int m = 0; m < NU; ++m) g0[((NU + m * NX + L.r) * W + t) * S] = L.kc[m];
          }
          if (L.r == 0) {
#pragma unroll
            for (int m = 0; m < NU; ++m) g0[(m * W + t) * S] = L.k[m];
          }
        },
        [&](const typename Bwd::Lane& L, int c) {
          if (c != c_pre) return;
          for (int j = 0; j < Fwd::kSlots - 1; ++j)
            Fwd::template copy<true, false>(k, s * G + L.r, j);
          RingCopy::commit();
        });
  }

  // The forward sweep of block k (after every backward sweep of the block
  // and `publish()`); `ex` runs the block's 32 lanes.
  template <class Exec>
  IPOC_HD static void forward(Exec& ex, const Arrays& a, const Block& k) {
    Fwd::schedule(ex, k, a.xT, a.bp, a.txT, a.nc, a.mc, a.cun,
                  [&](const typename Fwd::Lane& L) {
                    for (int j = 1; j < Fwd::kSlots - 1; ++j) {
                      Fwd::template copy<false, true>(k, L.s * G + L.r, j);
                      RingCopy::commit();
                    }
                  });
  }

  IPOC_HD static int blocks(int B) { return Fwd::blocks(B); }
};

#ifndef __CUDACC__
// The trial on the host, block by block: each scenario's backward sweep
// in turn (its G lanes stepped through every step in turn), then the
// block's forward sweep (its 32 lanes likewise).  `sh` holds kShared
// scalars.
template <typename Model, typename scalar_t, bool DDP>
void merged_trial_host(const typename MergedTrial<Model, scalar_t, DDP>::Arrays& a,
                       scalar_t* sh) {
  using Mt = MergedTrial<Model, scalar_t, DDP>;
  for (int blk = 0; blk < Mt::blocks(a.B); ++blk) {
    const auto k = Mt::block(a, blk, sh);
    for (int s = 0; s < Mt::S; ++s) {
      typename Mt::Bwd::Lane lanes[Mt::G];
      for (int l = 0; l < Mt::G; ++l) lanes[l].r = l;
      GroupExec<typename Mt::Bwd::Lane, Mt::G> ex{lanes};
      Mt::backward(ex, a, k, s);
    }
    typename Mt::Fwd::Lane lanes[kRowWarp];
    for (int l = 0; l < kRowWarp; ++l) {
      lanes[l].s = l / Mt::G;
      lanes[l].r = l % Mt::G;
    }
    GroupExec<typename Mt::Fwd::Lane, kRowWarp> ex{lanes};
    Mt::forward(ex, a, k);
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
