// The costate recursion (seq_newton.cu costate_kernel) as a group
// schedule, for the kernel and for a host build that the CPU tests
// compile with g++.
//
//   lam_T given, lam_t = cx_t + fx_t' lam_{t+1}, t = T-1 .. 0,
//   cx (B, T, NX), fx (B, T, NX, NX), lam_T (B, NX) -> lam (B, T+1, NX).
//
// One scenario is a group of G lanes of one warp, G the least power of two
// >= NX (riccati_rows.h row_lanes: 2 at nx = 2, 4 at nx = 3 and 4); a warp
// holds S = 32 / G scenarios.  In the (B, T, rows) inputs a scenario's W
// consecutive stages of cx (W NX values) and of fx (W NX^2) are one
// contiguous run each; the group's lanes copy the runs of chunk
// j + kSlots - 1 into a ring in shared memory while the recursion works on
// chunk j (seq_trial.h RingCopy: 16-byte cp.async copies where a run's
// start and length allow, one scalar each otherwise), so the loads leave
// the serial chain.  Chunks are W stages from t = 0; the recursion meets
// the partial one first.
//
// The chain, per stage: lane i computes row i of lam_t with the parent
// kernel's expression and order, acc = fx[i] l[0], acc = acc + fx[j NX + i]
// l[j], lam_t[i] = cx[i] + acc (a lane past NX computes row NX - 1 and
// writes nothing), stages it into the group's staging slice and hands it
// to the group (WarpExec::share, __shfl_sync): NX dependent products and
// a shuffle.  After a chunk the group stores its W stages of lam, one
// contiguous run of (B, T+1, NX), from the staging slice.  A scenario past
// B (the last block's) runs on scenario B - 1's data and writes nothing.
// Shared memory per block (ring 3 slots x 8 stages, staging): nx = 4
// 16,896 bytes in float32, 33,792 in float64; nx = 3 10,496 / 20,992;
// nx = 2 (16 scenarios) 11,264 / 21,504; on an H100 13 / 6 resident
// blocks per SM at nx = 4, 78-123 registers, no spills (chip_smoke.py
// phase 0).  Host and device (IPOC_HD); seq_newton.cu runs one lane per
// thread (WarpExec), the host executor (costates_host) each group's lanes
// in turn.

#pragma once

#include <stdint.h>

#include "riccati_rows.h"
#include "seq_trial.h"  // RingCopy

namespace ipoc {

template <typename scalar_t, int NX>
struct Costates {
  static constexpr int G = row_lanes(NX);
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  static constexpr int W = 8;             // stages per chunk
  static constexpr int kSlots = 3;        // chunk j + 2 is copied while chunk j is worked on
  static constexpr int V = 16 / static_cast<int>(sizeof(scalar_t));  // scalars per 16 bytes
  // A scenario's slot: W stages of cx, then W of fx.
  static constexpr int oCx = 0, oFx = W * NX, kIn = oFx + W * NX * NX;
  // Slots and staging slices at an odd multiple of max(G, V) scalars:
  // 16-byte aligned, and the warp's groups on distinct banks.
  static constexpr int A = G > V ? G : V;
  static constexpr int kSlot = odd_stride(kIn, A);
  static constexpr int kOut = odd_stride(W * NX, A);
  // The block's shared memory, in scalars: the ring [kSlots][S][kSlot],
  // the staging [S][kOut].
  static constexpr int kRing = kSlots * S * kSlot;
  static constexpr int kShared = kRing + S * kOut;

  struct Lane {
    int r;           // the row this lane computes (spare if >= NX)
    int rr;          // min(r, NX - 1)
    scalar_t l[NX];  // lam_{t+1}, on every lane of the group
  };

  struct Scenario {
    const scalar_t *cx, *fx, *lamT;  // this scenario's (T, NX), (T, NX, NX), (NX)
    scalar_t* lam;                   // (T + 1, NX)
    int T;
    bool valid;       // b < B: write results
    scalar_t* slot0;  // this scenario's slot in slot 0 of the ring
    scalar_t* out;    // its staging slice
  };

  IPOC_HD static Scenario scenario(const scalar_t* cx, const scalar_t* fx,
                                   const scalar_t* lamT, scalar_t* lam, int b,
                                   int B, int T, int s, scalar_t* sh) {
    const bool valid = b < B;
    const size_t c = static_cast<size_t>(valid ? b : B - 1);
    const size_t n = static_cast<size_t>(T);
    return Scenario{cx + c * n * NX, fx + c * n * NX * NX, lamT + c * NX,
                    lam + c * (n + 1) * NX, T, valid, sh + s * kSlot,
                    sh + kRing + s * kOut};
  }

  IPOC_HD static int chunks(int T) { return (T + W - 1) / W; }
  IPOC_HD static int blocks(int B) { return (B + S - 1) / S; }
  IPOC_HD static scalar_t* slot(const Scenario& s, int j) {
    return s.slot0 + (j % kSlots) * S * kSlot;
  }
  // The first stage and the stage count of the recursion's j-th chunk
  // (chunk C - 1 - j).
  IPOC_HD static int first(const Scenario& s, int j) {
    return (chunks(s.T) - 1 - j) * W;
  }
  IPOC_HD static int count(const Scenario& s, int j) {
    const int t0 = first(s, j);
    return s.T - t0 < W ? s.T - t0 : W;
  }

  // Lane r's share of one run of `len` scalars.
  IPOC_HD static void fetch_run(int r, scalar_t* dst, const scalar_t* src, int len) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && len % V == 0) {
      for (int p = r; p < len / V; p += G) RingCopy::vec16(dst + p * V, src + p * V);
    } else {
      for (int p = r; p < len; p += G) RingCopy::one(dst + p, src + p);
    }
  }

  // The copies of the recursion's j-th chunk, one commit group (empty past
  // the last).
  IPOC_HD static void fetch(const Scenario& s, int r, int j) {
    if (j < chunks(s.T)) {
      const size_t t0 = static_cast<size_t>(first(s, j));
      const int n = count(s, j);
      scalar_t* d = slot(s, j);
      fetch_run(r, d + oCx, s.cx + t0 * NX, n * NX);
      fetch_run(r, d + oFx, s.fx + t0 * NX * NX, n * NX * NX);
    }
    RingCopy::commit();
  }

  // Lane r's share of one staged run of `len` scalars into device memory.
  IPOC_HD static void store_run(int r, scalar_t* dst, const scalar_t* src, int len) {
#ifdef __CUDA_ARCH__
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && len % V == 0) {
      for (int p = r; p < len / V; p += G)
        reinterpret_cast<uint4*>(dst)[p] = reinterpret_cast<const uint4*>(src)[p];
      return;
    }
#endif
    for (int p = r; p < len; p += G) dst[p] = src[p];
  }

  // The recursion's j-th chunk of lam from the staging slice.
  IPOC_HD static void store(const Scenario& s, int r, int j) {
    if (!s.valid) return;
    store_run(r, s.lam + static_cast<size_t>(first(s, j)) * NX, s.out,
              count(s, j) * NX);
  }

  // The recursion of one scenario; `ex(f)` runs f(lane) for each of the
  // group's lanes, then a barrier over them.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s) {
    const int C = chunks(s.T);
    ex([&](Lane& L) {
      L.rr = L.r < NX ? L.r : NX - 1;
#pragma unroll
      for (int i = 0; i < NX; ++i) L.l[i] = s.lamT[i];
      if (s.valid && L.r == 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) s.lam[static_cast<size_t>(s.T) * NX + i] = L.l[i];
      }
      for (int j = 0; j < kSlots - 1; ++j) fetch(s, L.r, j);
    });
    for (int j = 0; j < C; ++j) {
      ex([&](Lane& L) {
        if (j > 0) store(s, L.r, j - 1);
        fetch(s, L.r, j + kSlots - 1);
        RingCopy::wait<kSlots - 1>();
      });
      const scalar_t* d = slot(s, j);
      const int n = count(s, j);
#pragma unroll
      for (int w = W - 1; w >= 0; --w) {
        if (w >= n) continue;
        const scalar_t* fx = d + oFx + w * NX * NX;
        const scalar_t* cx = d + oCx + w * NX;
        ex.template share<G>(
            [&](Lane& L) {
              scalar_t acc = fx[L.rr] * L.l[0];
#pragma unroll
              for (int i = 1; i < NX; ++i) acc = acc + fx[i * NX + L.rr] * L.l[i];
              const scalar_t nl = cx[L.rr] + acc;
              if (L.r < NX) s.out[w * NX + L.r] = nl;
              return nl;
            },
            [&](Lane& L, int i, scalar_t v) {
              if (i < NX) L.l[i] = v;
            });
      }
      ex([](Lane&) {});  // the staged chunk, to the group
    }
    ex([&](Lane& L) { store(s, L.r, C - 1); });
  }
};

#ifndef __CUDACC__
// The recursion on the host, block by block: each block's S groups in turn
// (those past B on scenario B - 1's data, writing nothing), each group's G
// lanes stepped through every step in turn.  `sh` holds kShared scalars.
template <typename scalar_t, int NX>
void costates_host(const scalar_t* cx, const scalar_t* fx, const scalar_t* lamT,
                   scalar_t* lam, int B, int T, scalar_t* sh) {
  using Cs = Costates<scalar_t, NX>;
  for (int b0 = 0; b0 < B; b0 += Cs::S) {
    for (int s = 0; s < Cs::S; ++s) {
      const auto sc = Cs::scenario(cx, fx, lamT, lam, b0 + s, B, T, s, sh);
      typename Cs::Lane lanes[Cs::G];
      for (int l = 0; l < Cs::G; ++l) lanes[l].r = l;
      GroupExec<typename Cs::Lane, Cs::G> ex{lanes};
      Cs::schedule(ex, sc);
    }
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
