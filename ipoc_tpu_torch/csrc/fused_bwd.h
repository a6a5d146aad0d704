// The fused backward sweep (fused_iter.cuh fused_bwd_kernel) as a group
// schedule over a generated Model, for the kernel and for a host build
// that the CPU tests compile with g++.
//
// One scenario is a group of G lanes of one warp (riccati_rows.h); a warp
// holds S = 32 / G scenarios.  The stage program is split by the codegen
// (ops/codegen/scalarize.py ScalarProgram.split): Model::stage_bwd_pre
// computes the calls of elementary functions that do not read the costate
// (sin, cos, log, rem: long library sequences), Model::stage_bwd_post the
// rest of the stage's (ru, Q, R, M, fx, fu, lam_new, cost) from pre's NH
// handoff values and lam.  Post keeps all of the arithmetic, so that nvcc
// contracts its products into FMAs as it does in the whole stage_bwd: the
// sweep's results equal the one-thread kernel's, and so the mega kernel's,
// to the bit at cartpole (a split that handed off arithmetic values did
// not; PERF.md section 5).
//
// The sweep goes backward in chunks of G stages (chunk c: stages
// T - 1 - (c G + w), w = 0..G-1).  Lane r of the group computes pre for
// stage w = r of chunk c + 1 while the group works on chunk c, into a
// shared-memory buffer (two, alternating); it loaded that stage's x and u
// from the (T, rows, B) arrays a chunk earlier still.  So a chunk's calls
// are spread over the group's lanes and made, with their loads, off the
// serial chain.  The chain, per stage: post on every
// lane (the same instructions on the same data), then the cooperative
// Riccati step (RowStep::step).  Each lane stores its column of K (lane 0
// also k) into Kk (T, (1+NX)*NU, B); lane 0 writes the scenario's cost,
// dV, pivot and max|ru| at the end.  A scenario past B (the last block's)
// runs on scenario B - 1's data and writes nothing.
//
// The per-stage arithmetic is the generated stage_bwd's (pre and post
// compute its DAG's nodes with the same operations) and riccati_step's;
// the cost is summed and max|ru| taken in the one-thread kernel's order.
//
// DDP = true is the merged trial's DDP mode (merged_trial.h; lane.h
// trial_backward<..., true>): the costate argument of post is the value
// gradient Vx, which starts at the terminal gradient and which the
// Riccati step (RowStep<..., true>) produces, so the chain runs post(Vx)
// -> step -> Vx; the step's Qx is post's lam_new.  The schedule's two
// hooks let the merged trial keep a stage's gains in shared memory
// (`put`, in place of the store to Kk) and start its forward sweep's
// copies during the last chunks (`at_chunk`, at each chunk's start).

#pragma once

#include "lane.h"  // load_col
#include "riccati_rows.h"
#include "scalar_math.h"

namespace ipoc {

template <typename Model, typename scalar_t, bool DDP = false>
struct FusedBwd {
  static constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  static constexpr int NH = Model::NH;  // handoff values per stage
  using Step = RowStep<scalar_t, NX, NU, DDP>;
  static constexpr int G = Step::G;
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  // A group's handoff buffers [2][G][NH], at an odd multiple of G scalars.
  static constexpr int kHand = odd_stride(2 * G * NH, G);
  // The block's shared memory, in scalars: handoffs [S][kHand], then the
  // exchange slices [S][kXch].
  static constexpr int kShared = S * (kHand + Step::kXch);

  struct Lane : Step::Lane {
    scalar_t lam[NX];     // the costate carry (DDP: the terminal gradient)
    scalar_t cost, hu;    // barrier cost, max_t |ru_t|
    scalar_t xn[NX], un[NU];  // the stage this lane pre-evaluates next
  };

  struct Scenario {
    const scalar_t *xs, *us;  // (T, NX, B), (T, NU, B)
    scalar_t bp, reg;
    scalar_t* Kk;             // (T, NG, B)
    int B, b, T;              // b: the column read (B - 1 past B)
    bool valid;
    scalar_t* hand;           // this group's handoff buffers
    scalar_t* xch;            // its exchange slice
  };

  IPOC_HD static int chunks(int T) { return (T + G - 1) / G; }

  // Load x and u of stage w = L.r of chunk c into (xn, un), if it exists.
  IPOC_HD static void load_next(const Scenario& s, Lane& L, int c) {
    const int t = s.T - 1 - (c * G + L.r);
    if (c >= chunks(s.T) || t < 0) return;
    load_col<scalar_t, NX>(L.xn, s.xs + (size_t)t * NX * s.B, s.B, s.b);
    load_col<scalar_t, NU>(L.un, s.us + (size_t)t * NU * s.B, s.B, s.b);
  }

  // pre of stage w = L.r of chunk c, from (xn, un), into its buffer.
  IPOC_HD static void pre(const Scenario& s, const Lane& L, int c) {
    if (c >= chunks(s.T) || s.T - 1 - (c * G + L.r) < 0) return;
    Model::template stage_bwd_pre<scalar_t>(L.xn, L.un, &s.bp,
                                            s.hand + ((c & 1) * G + L.r) * NH);
  }

  // The lane's share of stage t's gains, stored into Kk: its column of K
  // (an owning lane), k (lane 0).
  IPOC_HD static void store_gains(const Scenario& s, const Lane& L, int t) {
    if (!s.valid) return;
    scalar_t* g = s.Kk + (size_t)t * NG * s.B + s.b;
    if (Step::owns(L)) {
#pragma unroll
      for (int m = 0; m < NU; ++m) g[(size_t)(NU + m * NX + L.r) * s.B] = L.kc[m];
    }
    if (L.r == 0) {
#pragma unroll
      for (int m = 0; m < NU; ++m) g[(size_t)m * s.B] = L.k[m];
    }
  }

  // The sweep of one scenario; `ex(f)` runs f(lane) for each of the
  // group's lanes, then a barrier over them.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s, const scalar_t* xT,
                               scalar_t* cost_o, scalar_t* dv_o, scalar_t* piv_o,
                               scalar_t* hu_o) {
    schedule(ex, s, xT, cost_o, dv_o, piv_o, hu_o,
             [&](const Lane& L, int t) { store_gains(s, L, t); },
             [](const Lane&, int) {});
  }

  // The same with the hooks: `put(L, t)` takes the lane's share of stage
  // t's gains; `at_chunk(L, c)` runs at the start of chunk c.
  template <class Exec, class Put, class AtChunk>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s, const scalar_t* xT,
                               scalar_t* cost_o, scalar_t* dv_o, scalar_t* piv_o,
                               scalar_t* hu_o, Put&& put, AtChunk&& at_chunk) {
    const int C = chunks(s.T);
    ex([&](Lane& L) {
      Step::init(L, L.r);
      scalar_t x[NX], Vxx[NX * NX];
      load_col<scalar_t, NX>(x, xT, s.B, s.b);
      Model::template term<scalar_t>(x, L.lam, Vxx, &L.cost);
      if constexpr (DDP) {
#pragma unroll
        for (int i = 0; i < NX; ++i) L.vx[i] = L.lam[i];
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) L.vr[j] = pick<scalar_t, NX>(Vxx + j, NX, L.rr);
      L.hu = scalar_t(0);
      load_next(s, L, 0);
      pre(s, L, 0);
      load_next(s, L, 1);
    });
    // The stage's data: computed on every lane by post (on the host, by
    // each lane in turn, to the same values).
    scalar_t ru[NU], Q[NX * NX], R[NU * NU], M[NX * NU], fx[NX * NX], fu[NX * NU],
        lam_new[NX], cst;
    for (int c = 0; c < C; ++c) {
      const scalar_t* hc = s.hand + (c & 1) * G * NH;
#pragma unroll
      for (int w = 0; w < G; ++w) {
        const int t = s.T - 1 - (c * G + w);
        if (t < 0) break;
        Step::step(
            ex, s.xch, ru, R, fx, fu,
            [&](Lane& L) {
              if (w == 0) {
                at_chunk(L, c);
                pre(s, L, c + 1);
                load_next(s, L, c + 2);
              }
              Model::template stage_bwd_post<scalar_t>(hc + w * NH,
                                                       DDP ? L.vx : L.lam, ru, Q,
                                                       R, M, fx, fu, lam_new, &cst);
              // Levenberg: R += reg * I (reg pre-scaled by the caller).
#pragma unroll
              for (int i = 0; i < NU; ++i) R[i * (NU + 1)] = R[i * (NU + 1)] + s.reg;
            },
            [&](const auto& L, const scalar_t* xch, typename Step::Rows& rw) {
              Step::rows_pick(L, Q, fx, M, xch, rw, lam_new);
            },
            [&](Lane& L) {
              put(L, t);
              L.cost = L.cost + cst;
              scalar_t ru_max = ipoc_abs(ru[0]);
#pragma unroll
              for (int i = 1; i < NU; ++i) ru_max = ipoc_max(ru_max, ipoc_abs(ru[i]));
              L.hu = ipoc_max(L.hu, ru_max);
              if constexpr (!DDP) {
#pragma unroll
                for (int i = 0; i < NX; ++i) L.lam[i] = lam_new[i];
              }
            });
      }
    }
    ex([&](Lane& L) {
      if (s.valid && L.r == 0) {
        cost_o[s.b] = L.cost;
        dv_o[s.b] = L.dv;
        piv_o[s.b] = L.piv;
        hu_o[s.b] = L.hu;
      }
    });
  }

  // Scenario b of a block whose shared memory is `sh` (group s).
  IPOC_HD static Scenario scenario(const scalar_t* xs, const scalar_t* us,
                                   const scalar_t* bp, const scalar_t* reg,
                                   scalar_t* Kk, int b, int B, int T, int s,
                                   scalar_t* sh) {
    const bool valid = b < B;
    const int c = valid ? b : B - 1;
    return Scenario{xs, us, bp[c], reg[c], Kk, B, c, T, valid, sh + s * kHand,
                    sh + S * kHand + s * Step::kXch};
  }
};

#ifndef __CUDACC__
// The sweep on the host, block by block: each block's S groups in turn
// (those past B on scenario B - 1's data, writing nothing), each group's G
// lanes stepped through every step in turn.  `sh` holds kShared scalars.
template <typename Model, typename scalar_t>
void fused_bwd_host(const scalar_t* xs, const scalar_t* us, const scalar_t* xT,
                    const scalar_t* bp, const scalar_t* reg, scalar_t* Kk,
                    scalar_t* cost, scalar_t* dv, scalar_t* piv, scalar_t* hu,
                    int B, int T, scalar_t* sh) {
  using F = FusedBwd<Model, scalar_t>;
  for (int b0 = 0; b0 < B; b0 += F::S) {
    for (int s = 0; s < F::S; ++s) {
      const auto sc = F::scenario(xs, us, bp, reg, Kk, b0 + s, B, T, s, sh);
      typename F::Lane lanes[F::G];
      for (int l = 0; l < F::G; ++l) lanes[l].r = l;
      GroupExec<typename F::Lane, F::G> ex{lanes};
      F::schedule(ex, sc, xT, cost, dv, piv, hu);
    }
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
