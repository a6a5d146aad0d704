// The fused forward sweep (fused_iter.cuh fused_fwd_kernel) as a block
// schedule over a generated Model, for the kernel and for a host build
// that the CPU tests compile with g++.
//
// One block is one warp: S = 32 / G scenarios, a group of G lanes each
// (G = 8 at every shape: the chain runs on every lane of a group, so a
// lane more costs the chain nothing and takes a share of the work off
// it; at B = 4096 that is 1,024 one-warp blocks, 8 warps an SM).  The
// stage program is cut by the codegen (ops/fused_iter.py forward_parts)
// into three parts:
//
//   Model::stage_fwd_pre(x, u, bp, gains) -> NHF handoff values: the
//       elementary-function calls that do not read the deviation (sin and
//       cos of the dynamics' Jacobian at cartpole), and x, u, the gains;
//   Model::stage_fwd_step(handoff, dx) -> (tu, tx, dx_next): the rest of
//       the chain's stage, all of its arithmetic, so that nvcc contracts
//       and folds it as in the whole stage_fwd (a cut that handed off the
//       Jacobian's arithmetic rounded apart: PERF.md section 5);
//   Model::stage_fwd_eval(tx, tu, bp) -> the trial point's cost, maximum
//       constraint value and ||cu||^2, each summand as the pair of
//       operands whose product it is.
//
// The sweep goes forward in chunks of W = G stages.  Chunk j of the
// block's x, u and gains comes into a ring in shared memory (kSlots
// slots of [row][stage][scenario]) as runs of the block's S scenario
// columns, copied by all 32 lanes (RingCopy: 16-byte copies where a run
// allows, one scalar each otherwise) three chunks ahead.  One step of the
// schedule per chunk j, on every lane (s, r) of scenario s:
//
//   pre:   stage r of chunk j + 1, from the ring, into the handoff buffer;
//   eval:  stage r of chunk j - 1, from the staged tu and tx;
//   chain: chunk j's stages, each stage_fwd_step from the handoff and the
//          deviation (every lane the same instructions on the same data;
//          each stages tu and tx);
//   sum:   chunk j - 2's evaluations, into the cost, the maximum and
//          sum ||cu||^2, stage by stage in order (a + x * y: a product
//          contracts into the sum as in the one-thread kernel);
//   store: chunk j - 1's tu and tx, as runs of S columns;
//
// then the wait for chunk j + 2's copies and one barrier.  The last
// chunk's step runs its chain only up to T (Newton mode), and two steps
// of eval, sum and store drain the pipeline.  So the serial chain carries
// stage_fwd_step, and the calls, the evaluation (2 logs, a rem, 2
// divisions at cartpole) and the loads are spread over the group's lanes,
// off it.  term_fwd runs at the end on every lane (lane 0
// writes).  A scenario past B (the last block's) runs on scenario B - 1's
// data and writes nothing.
//
// The merged trial (merged_trial.h) runs this schedule after its backward
// sweep with two template arguments: G_, the group size (RowStep's G, so
// that one warp holds the same scenarios in both sweeps; W = G then), and
// DDP, its DDP mode.  In DDP mode the chain is the closed-loop
// re-rollout, whose carry is the trial state itself from x_0 (stage 0 of
// x): Model::stage_ddp_fwd_step(x, u, tx, gains) -> (tu, tx, tx+), read
// from the ring (its sin and cos read the carry, so nothing is handed
// off and pre does nothing); the evaluation is stage_fwd_eval (the
// codegen checks that stage_ddp_fwd's evaluation is that program) and
// term_ddp_fwd ends it.  Its start hook issues the first chunks' copies
// (some of them during the backward sweep).

#pragma once

#include <stdint.h>
#include <string.h>

#include "lane.h"         // load_col, store_col
#include "riccati_rows.h"  // kRowWarp, WarpExec, GroupExec
#include "seq_trial.h"     // RingCopy

namespace ipoc {

// Runs of a block's S scenario columns: at (stage t, row) of a (T, rows, B)
// array, columns b0 .. b0 + S - 1 are S consecutive scalars.  In shared
// memory a chunk of W stages of ROWS rows is [row][w][s].  The block's 32
// lanes share the copies and stores; a block past B (nvalid < S) reads
// column B - 1 for the columns past it and stores only its valid ones.
template <typename scalar_t, int S, int W>
struct BlockRuns {
  static constexpr int V = 16 / static_cast<int>(sizeof(scalar_t));
  static constexpr int NV = S / V;  // 16-byte pieces in a whole run (0: none)

  IPOC_HD static bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }

  // Lane l's copies of stages t0 .. t0 + n - 1 (n <= W) of ROWS rows:
  // src(row, t) is column b0's address at (t, row).
  template <int ROWS, class Src>
  IPOC_HD static void fetch(int l, scalar_t* dst, int t0, int n, int nvalid,
                            Src&& src) {
    if constexpr (NV > 0) {
      if (nvalid == S) {
        for (int p = l; p < ROWS * W * NV; p += kRowWarp) {
          const int q = p / NV, k = p % NV, row = q / W, w = q % W;
          if (w >= n) continue;
          const scalar_t* a = src(row, t0 + w) + k * V;
          scalar_t* d = dst + q * S + k * V;
          if (aligned(a)) {
            RingCopy::vec16(d, a);
          } else {
            for (int i = 0; i < V; ++i) RingCopy::one(d + i, a + i);
          }
        }
        return;
      }
    }
    for (int p = l; p < ROWS * W * S; p += kRowWarp) {
      const int q = p / S, s = p % S, row = q / W, w = q % W;
      if (w >= n) continue;
      RingCopy::one(dst + p, src(row, t0 + w) + (s < nvalid ? s : nvalid - 1));
    }
  }

  // Lane l's stores of the staged stages t0 .. t0 + n - 1 of ROWS rows:
  // dst(row, t) is column b0's address at (t, row).
  template <int ROWS, class Dst>
  IPOC_HD static void store(int l, const scalar_t* src, int t0, int n, int nvalid,
                            Dst&& dst) {
    if constexpr (NV > 0) {
      if (nvalid == S) {
        for (int p = l; p < ROWS * W * NV; p += kRowWarp) {
          const int q = p / NV, k = p % NV, row = q / W, w = q % W;
          if (w >= n) continue;
          scalar_t* a = dst(row, t0 + w) + k * V;
          const scalar_t* d = src + q * S + k * V;
#ifdef __CUDA_ARCH__
          if (aligned(a)) {
            *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(d);
            continue;
          }
#endif
          for (int i = 0; i < V; ++i) a[i] = d[i];
        }
        return;
      }
    }
    for (int p = l; p < ROWS * W * S; p += kRowWarp) {
      const int q = p / S, s = p % S, row = q / W, w = q % W;
      if (w >= n || s >= nvalid) continue;
      dst(row, t0 + w)[s] = src[p];
    }
  }
};

template <typename Model, typename scalar_t, int G_ = 8, bool DDP = false>
struct FusedFwd {
  static constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  static constexpr int NH = Model::NHF;  // handoff values per stage
  static constexpr int G = G_;           // lanes per scenario
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  static constexpr int W = G;            // stages per chunk
  static constexpr int kSlots = 4;       // chunk j + 3 is copied during step j (a power of 2)
  static constexpr int R = NX + NU + NG;  // rows a stage reads: x, u, gains
  static constexpr int NO = NU + NX;      // rows a stage writes: tu, tx
  static constexpr int NE = 5;            // cost (a, b), max c, ||cu||^2 (a, b)
  using Runs = BlockRuns<scalar_t, S, W>;
  // The block's shared memory, in scalars: the ring [kSlots][R][W][S], the
  // handoffs [2][S][kHandS] (a stage's NH values at an odd stride, so that
  // the lanes that write them fall on distinct banks), the staged tu and tx
  // [2][NO][W][S], the evaluations [2][NE][W][S].
  static constexpr int kSlot = R * W * S;
  static constexpr int kNH = NH | 1;
  static constexpr int kHandS = DDP ? 0 : W * kNH;  // DDP hands nothing off
  static constexpr int oHand = kSlots * kSlot;
  static constexpr int oOut = oHand + 2 * S * kHandS;
  static constexpr int oEval = oOut + 2 * NO * W * S;
  static constexpr int kShared = oEval + 2 * NE * W * S;

  struct Lane {
    int s, r;             // scenario in the block, lane in its group
    scalar_t bp;
    scalar_t dx[NX];      // the deviation carry (every lane of the group)
    scalar_t cost, mc, cun;
  };

  struct Block {
    const scalar_t *xs, *us, *Kk;  // (T, NX, B), (T, NU, B), (T, NG, B)
    scalar_t *tu, *tx;             // (T, NU, B), (T, NX, B)
    int B, T, b0, nvalid;          // columns b0 .. b0 + nvalid - 1 are valid
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
  IPOC_HD static scalar_t* hand(const Block& k, const Lane& L, int j) {
    return k.sh + oHand + ((j & 1) * S + L.s) * kHandS;
  }
  IPOC_HD static scalar_t* staged(const Block& k, int j) {
    return k.sh + oOut + (j & 1) * NO * W * S;
  }
  IPOC_HD static scalar_t* evals(const Block& k, int j) {
    return k.sh + oEval + (j & 1) * NE * W * S;
  }

  // Lane l's copies of chunk j's x and u rows (XU) and gains rows (GAINS),
  // uncommitted.
  template <bool XU, bool GAINS>
  IPOC_HD static void copy(const Block& k, int l, int j) {
    const int n = stages(k, j);
    if (n == 0) return;
    scalar_t* d = slot(k, j);
    const size_t B = static_cast<size_t>(k.B);
    const int t0 = j * W;
    if constexpr (XU) {
      Runs::template fetch<NX>(l, d, t0, n, k.nvalid, [&](int row, int t) {
        return k.xs + ((size_t)t * NX + row) * B + k.b0;
      });
      Runs::template fetch<NU>(l, d + NX * W * S, t0, n, k.nvalid, [&](int row, int t) {
        return k.us + ((size_t)t * NU + row) * B + k.b0;
      });
    }
    if constexpr (GAINS) {
      Runs::template fetch<NG>(l, d + (NX + NU) * W * S, t0, n, k.nvalid,
                               [&](int row, int t) {
                                 return k.Kk + ((size_t)t * NG + row) * B + k.b0;
                               });
    }
  }

  // Lane l's copies of chunk j (one commit group, empty past the last).
  IPOC_HD static void fetch(const Block& k, const Lane& L, int j) {
    copy<true, true>(k, L.s * G + L.r, j);
    RingCopy::commit();
  }

  // pre of stage r of chunk j, from the ring, into its handoff slot.
  IPOC_HD static void pre(const Block& k, const Lane& L, int j) {
    if constexpr (DDP) return;
    const scalar_t* d = slot(k, j) + L.r * S + L.s;
    scalar_t x[NX], u[NU], g[NG];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = d[i * W * S];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = d[(NX + i) * W * S];
#pragma unroll
    for (int i = 0; i < NG; ++i) g[i] = d[(NX + NU + i) * W * S];
    Model::template stage_fwd_pre<scalar_t>(x, u, &L.bp, g,
                                            hand(k, L, j) + L.r * kNH);
  }

  // The chain over chunk j's first n stages (those past T leave dx as it
  // is); every lane of the group stages the same tu and tx.  DDP: dx is
  // the trial state, and the chain reads x, u and the gains from the ring.
  IPOC_HD static void chain(const Block& k, Lane& L, int j, int n = W) {
    const scalar_t* h = hand(k, L, j);
    const scalar_t* d = slot(k, j) + L.s;
    scalar_t* o = staged(k, j) + L.s;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w >= n) break;
      scalar_t tu[NU], tx[NX], dxn[NX];
      if constexpr (DDP) {
        scalar_t x[NX], u[NU], g[NG];
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = d[(i * W + w) * S];
#pragma unroll
        for (int i = 0; i < NU; ++i) u[i] = d[((NX + i) * W + w) * S];
#pragma unroll
        for (int i = 0; i < NG; ++i) g[i] = d[((NX + NU + i) * W + w) * S];
        Model::template stage_ddp_fwd_step<scalar_t>(x, u, L.dx, g, tu, tx, dxn);
      } else {
        Model::template stage_fwd_step<scalar_t>(h + w * kNH, L.dx, tu, tx, dxn);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) o[(i * W + w) * S] = tu[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) o[((NU + i) * W + w) * S] = tx[i];
      const bool live = j * W + w < k.T;
#pragma unroll
      for (int i = 0; i < NX; ++i) L.dx[i] = live ? dxn[i] : L.dx[i];
    }
  }

  // eval of stage r of chunk j, from the staged tu and tx.
  IPOC_HD static void eval(const Block& k, const Lane& L, int j) {
    const scalar_t* o = staged(k, j) + L.r * S + L.s;
    scalar_t tu[NU], tx[NX], cst[2], cmax, cu[2];
#pragma unroll
    for (int i = 0; i < NU; ++i) tu[i] = o[i * W * S];
#pragma unroll
    for (int i = 0; i < NX; ++i) tx[i] = o[(NU + i) * W * S];
    Model::template stage_fwd_eval<scalar_t>(tx, tu, &L.bp, cst, &cmax, cu);
    scalar_t* e = evals(k, j) + L.r * S + L.s;
    e[0] = cst[0];
    e[W * S] = cst[1];
    e[2 * W * S] = cmax;
    e[3 * W * S] = cu[0];
    e[4 * W * S] = cu[1];
  }

  // The sums over chunk j's evaluated stages, in stage order (the stages
  // of chunks before the first or past T leave them as they are).
  IPOC_HD static void sum(const Block& k, Lane& L, int j) {
    const scalar_t* e = evals(k, j) + L.s;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const scalar_t* ew = e + w * S;
      const scalar_t cost = L.cost + ew[0] * ew[W * S];
      const scalar_t mc = ipoc_max(L.mc, ew[2 * W * S]);
      const scalar_t cun = L.cun + ew[3 * W * S] * ew[4 * W * S];
      const bool live = j * W + w >= 0 && j * W + w < k.T;
      L.cost = live ? cost : L.cost;
      L.mc = live ? mc : L.mc;
      L.cun = live ? cun : L.cun;
    }
  }

  IPOC_HD static void store(const Block& k, const Lane& L, int j) {
    const int n = stages(k, j), l = L.s * G + L.r;
    if (n == 0) return;
    const size_t B = static_cast<size_t>(k.B);
    const scalar_t* o = staged(k, j);
    Runs::template store<NU>(l, o, j * W, n, k.nvalid, [&](int row, int t) {
      return k.tu + ((size_t)t * NU + row) * B + k.b0;
    });
    Runs::template store<NX>(l, o + NU * W * S, j * W, n, k.nvalid, [&](int row, int t) {
      return k.tx + ((size_t)t * NX + row) * B + k.b0;
    });
  }

  // The sweep of one block; `ex(f)` runs f(lane) for each of its 32 lanes,
  // then a barrier over them.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Block& k, const scalar_t* xT,
                               const scalar_t* bp, scalar_t* txT_o, scalar_t* nc_o,
                               scalar_t* mc_o, scalar_t* cun_o) {
    schedule(ex, k, xT, bp, txT_o, nc_o, mc_o, cun_o, [&](const Lane& L) {
      for (int j = 0; j < kSlots - 1; ++j) fetch(k, L, j);
    });
  }

  // The same with the copies of the first kSlots - 1 chunks issued by
  // `start(L)`: kSlots - 1 commit groups in all, chunk 0's x and u in the
  // oldest (which may have been committed before).
  template <class Exec, class Start>
  IPOC_HD static void schedule(Exec& ex, const Block& k, const scalar_t* xT,
                               const scalar_t* bp, scalar_t* txT_o, scalar_t* nc_o,
                               scalar_t* mc_o, scalar_t* cun_o, Start&& start) {
    const int C = chunks(k.T);
    ex([&](Lane& L) {
      const int b = k.b0 + (L.s < k.nvalid ? L.s : k.nvalid - 1);
      L.bp = bp[b];
#pragma unroll
      for (int i = 0; i < NX; ++i) L.dx[i] = scalar_t(0);
      L.cost = scalar_t(0);
      L.mc = -scalar_t(INFINITY);
      L.cun = scalar_t(0);
      start(L);
      RingCopy::wait<kSlots - 2>();
    });
    ex([&](Lane& L) {
      if constexpr (DDP) {
        // The carry starts at x_0, from the ring (chunk 0 is in).
        const scalar_t* d = slot(k, 0) + L.s;
#pragma unroll
        for (int i = 0; i < NX; ++i) L.dx[i] = d[i * W * S];
      } else {
        pre(k, L, 0);
        RingCopy::wait<kSlots - 3>();
      }
    });
    // Newton mode takes its last chunk out of the loop (below); DDP mode
    // runs it in the loop, which measured faster there (PERF.md section 5).
    const int last = DDP ? C : C - 1;
    for (int j = 0; j < last; ++j) {
      ex([&](Lane& L) {
        fetch(k, L, j + kSlots - 1);
        // pre, eval, the chain and the sums run unguarded, one straight
        // run of code in which their independent instructions interleave;
        // what they compute before the sweep's start or past its end is
        // never summed or stored.
        pre(k, L, j + 1);
        eval(k, L, j - 1);
        chain(k, L, j);
        sum(k, L, j - 2);
        store(k, L, j - 1);
        RingCopy::wait<kSlots - 3>();
      });
    }
    // The last chunk (copied and pre-evaluated already), its chain only
    // over the stages before T; then the pipeline's drain: the last
    // chunk's evaluations, the last two chunks' sums and the last chunk's
    // stores.
    if constexpr (!DDP) {
      ex([&](Lane& L) {
        eval(k, L, C - 2);
        chain(k, L, C - 1, stages(k, C - 1));
        sum(k, L, C - 3);
        store(k, L, C - 2);
      });
    }
    ex([&](Lane& L) {
      eval(k, L, C - 1);
      sum(k, L, C - 2);
      store(k, L, C - 1);
    });
    ex([&](Lane& L) { sum(k, L, C - 1); });
    ex([&](Lane& L) {
      if (L.r != 0 || L.s >= k.nvalid) return;
      const int b = k.b0 + L.s;
      scalar_t x[NX], txT[NX], cT;
      load_col<scalar_t, NX>(x, xT, k.B, b);
      if constexpr (DDP) {
        Model::template term_ddp_fwd<scalar_t>(x, L.dx, txT, &cT);
      } else {
        Model::template term_fwd<scalar_t>(x, L.dx, txT, &cT);
      }
      store_col<scalar_t, NX>(txT_o, txT, k.B, b);
      nc_o[b] = L.cost + cT;
      mc_o[b] = L.mc;
      cun_o[b] = L.cun;
    });
  }

  // Block `blk` of a launch whose shared memory is `sh`.
  IPOC_HD static Block block(const scalar_t* xs, const scalar_t* us,
                             const scalar_t* Kk, scalar_t* tu, scalar_t* tx,
                             int B, int T, int blk, scalar_t* sh) {
    const int b0 = blk * S;
    return Block{xs, us, Kk, tu, tx, B, T, b0, B - b0 < S ? B - b0 : S, sh};
  }

  IPOC_HD static int blocks(int B) { return (B + S - 1) / S; }
};

#ifndef __CUDACC__
// The sweep on the host, block by block, each block's 32 lanes stepped
// through every step in turn.  `sh` holds kShared scalars.
template <typename Model, typename scalar_t>
void fused_fwd_host(const scalar_t* xs, const scalar_t* us, const scalar_t* xT,
                    const scalar_t* bp, const scalar_t* Kk, scalar_t* tu,
                    scalar_t* tx, scalar_t* txT, scalar_t* nc, scalar_t* mc,
                    scalar_t* cun, int B, int T, scalar_t* sh) {
  using F = FusedFwd<Model, scalar_t>;
  for (int blk = 0; blk < F::blocks(B); ++blk) {
    const auto k = F::block(xs, us, Kk, tu, tx, B, T, blk, sh);
    typename F::Lane lanes[kRowWarp];
    for (int l = 0; l < kRowWarp; ++l) {
      lanes[l].s = l / F::G;
      lanes[l].r = l % F::G;
    }
    GroupExec<typename F::Lane, kRowWarp> ex{lanes};
    F::schedule(ex, k, xT, bp, txT, nc, mc, cun);
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
