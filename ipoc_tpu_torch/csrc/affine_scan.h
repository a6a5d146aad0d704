// The affine scan (par_newton.cu affine_scan_kernel) as a lane schedule,
// for the kernel and for a host build that the CPU tests compile with g++.
//
// The inclusive scan of affine maps e_t = (F_t, c_t) over a scenario's
// horizon: REVERSE, the suffix e_t o e_{t+1} o ... o e_{T-1} (the costate
// recursion); else the prefix e_t o ... o e_0 (the LQT forward pass).  The
// algebra is scan.cuh AffineOp.  One scenario is spread over P lanes, P a
// power of two from 32 to 256 (the wrapper's launch rule,
// ops/scan_kernels.py scan_lanes); lane l owns the contiguous chunk
// [l L, l L + L) of L = ceil(T / P) stages, and the first Pa = ceil(T / L)
// lanes own stages.  The chunks go through shared memory in tiles of LT
// stages of every lane: the scenario's lanes copy a tile's rows of F and c
// with cp.async in 16-byte pieces (one scalar where a row is not made of
// them),
// neighbouring lanes on neighbouring pieces, so a warp's copy reads a few
// whole lines; each lane then reads its own stages from its slots (a
// stage at an odd number of 16-byte units from the next lane's, so a
// warp's 16-byte reads fall on distinct banks).  The schedule
// (AffineScan::schedule), each step ending in a barrier over the
// scenario's lanes (over its warp for those marked so):
//
//   1. walk:  per tile, in the scan's direction: the copy, then each lane
//             folds its stages into the chunk's aggregate;
//   2. warp:  the inclusive scan of the aggregates inside each warp of 32
//             lanes, Hillis-Steele in 5 rounds, the neighbour's element
//             taken with __shfl_sync (no shared memory);
//   3. carry: the combination of everything beyond the lane: its in-warp
//             neighbour's inclusive scan (one more shuffle), then, for P >
//             32, combined with the totals of the warps beyond its own
//             (each warp publishes its total to shared memory, one barrier,
//             and each lane combines the at most P / 32 - 1 totals it
//             needs in order);
//   4. walk:  per tile, the copy again (not where the horizon is one tile:
//             it is still there), each lane's results from the carry over
//             its inputs in place, then the scenario's lanes store the tile
//             in pieces as they copied it.
//
// So a scenario costs 2T combines plus 5 rounds and at most 8 warp totals,
// with a critical path of 2L + 5 + P / 32 combines, and every global access
// is a warp's run of whole lines.  The association follows P: the results
// agree with the plain version to rounding, not to the bit.  Host and
// device (IPOC_HD): par_newton.cu runs one lane per thread (ScanExec
// below), the host build every lane of the scenario in turn.

#pragma once

#include "riccati_rows.h"  // odd_stride
#include "scan.cuh"        // AffineOp, copy_elem, load_row, store_row
#include "seq_trial.h"     // RingCopy

namespace ipoc {

constexpr int kScanWarp = 32;    // lanes of a warp: the inner scan's width
constexpr int kScanBlock = 128;  // threads per block where P < 128

// Bytes of the pieces that copy a row of `bytes`: 16 where the row is
// made of them, else one scalar.
template <typename scalar_t>
constexpr int piece_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : static_cast<int>(sizeof(scalar_t));
}

template <typename scalar_t, int N, int P, bool REVERSE>
struct AffineScan {
  static_assert(P >= kScanWarp && (P & (P - 1)) == 0, "P: a power of two >= 32");
  using Op = AffineOp<scalar_t, N>;
  static constexpr int E = Op::E;
  static constexpr int NW = P / kScanWarp;  // warps per scenario
  static constexpr int LT = 4;              // stages of each lane in a tile
  static constexpr int SZ = static_cast<int>(sizeof(scalar_t));
  // A stage's slot in a tile: F then c, at a stride of an odd number of
  // 16-byte units; slot (w, l) holds stage w of lane l's tile.
  static constexpr int ES = odd_stride(E, 16 / SZ);
  // The pieces of a stage: F's row, then c's.
  static constexpr int UF = piece_bytes<scalar_t>(N * N * SZ);
  static constexpr int UC = piece_bytes<scalar_t>(N * SZ);
  static constexpr int NF = N * N * SZ / UF, NC = N * SZ / UC;
  // Scenarios and threads per block; shared scalars per scenario: the
  // tile, then the warp totals.
  static constexpr int kScenarios = P < kScanBlock ? kScanBlock / P : 1;
  static constexpr int kBlock = P * kScenarios;
  static constexpr int kTile = LT * P * ES;
  static constexpr int kShared = kTile + (NW > 1 ? NW * E : 0);

  struct Scenario {
    const scalar_t *F, *c;  // (T, N, N), (T, N) at the scenario's first row
    scalar_t *Fo, *co;
    int T, L, NT;           // stages per lane, tiles
  };

  struct Lane {
    using Scalar = scalar_t;
    static constexpr int kE = E;
    int lane, Pa, Wa;
    bool seen, have;
    alignas(16) scalar_t v[E];    // the aggregate, then its in-warp scan
    alignas(16) scalar_t y[E];    // a neighbour's v (ScanExec::shift)
    alignas(16) scalar_t run[E];  // the carry, then the running result
  };

  IPOC_HD static Scenario scenario(const scalar_t* F, const scalar_t* c, scalar_t* Fo,
                                   scalar_t* co, int b, int T) {
    const size_t s = static_cast<size_t>(b) * T;
    const int L = (T + P - 1) / P;
    return Scenario{F + s * N * N, c + s * N, Fo + s * N * N, co + s * N, T, L,
                    (L + LT - 1) / LT};
  }

  IPOC_HD static void init(Lane& L, int lane, int T) {
    const int len = (T + P - 1) / P;
    L.lane = lane;
    L.Pa = len > 0 ? (T + len - 1) / len : 0;
    L.Wa = (L.Pa + kScanWarp - 1) / kScanWarp;
    L.seen = L.have = false;
  }

  // Lane l's stages in tile k: t0 .. t0 + n - 1, n returned.
  IPOC_HD static int tile_stages(const Scenario& s, int l, int k, int& t0) {
    const int c0 = l * s.L, c1 = c0 + s.L < s.T ? c0 + s.L : s.T;
    t0 = c0 + k * LT;
    const int n = c1 - t0;
    return n < 0 ? 0 : (n < LT ? n : LT);
  }

  IPOC_HD static scalar_t* slot(scalar_t* sh, int w, int l) { return sh + (w * P + l) * ES; }

  // The scenario's lanes move tile k between global and shared memory:
  // lane `me` takes pieces me, me + P, ... of (lane, stage, piece).
  template <bool STORE>
  IPOC_HD static void move_tile(const Scenario& s, int me, scalar_t* sh, int k) {
    for (int p = me; p < P * LT * (NF + NC); p += P) {
      const int r = p % (NF + NC), q = p / (NF + NC), w = q % LT, l = q / LT;
      int t0;
      if (w >= tile_stages(s, l, k, t0)) continue;
      const size_t t = static_cast<size_t>(t0 + w);
      scalar_t* m = slot(sh, w, l);
      if (r < NF) {
        move<UF, STORE>(m + r * (UF / SZ), (STORE ? s.Fo : s.F) + t * N * N + r * (UF / SZ));
      } else {
        move<UC, STORE>(m + N * N + (r - NF) * (UC / SZ),
                        (STORE ? s.co : s.c) + t * N + (r - NF) * (UC / SZ));
      }
    }
    if constexpr (!STORE) {
      RingCopy::commit();
      RingCopy::wait<0>();
    }
  }

  // One piece of U bytes: from global memory `g` into the tile at `m`
  // (cp.async on the card, awaited before the step's barrier), or back.
  template <int U, bool STORE>
  IPOC_HD static void move(scalar_t* m, const scalar_t* g) {
    if constexpr (!STORE) {
      if constexpr (U == 16) {
        RingCopy::vec16(m, g);
      } else {
        RingCopy::one(m, g);
      }
    } else {
      scalar_t* d = const_cast<scalar_t*>(g);
#ifdef __CUDA_ARCH__
      if constexpr (U == 16) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(m);
        return;
      }
#endif
      for (int i = 0; i < U / SZ; ++i) d[i] = m[i];
    }
  }

  IPOC_HD static void read_slot(const scalar_t* d, scalar_t* e) {
    load_row<scalar_t, N * N>(d, 0, e);
    load_row<scalar_t, N>(d + N * N, 0, e + N * N);
  }

  // Step 1, one tile: the lane's stages, in the scan's direction, into v.
  IPOC_HD static void aggregate(const Scenario& s, Lane& L, scalar_t* sh, int k) {
    int t0;
    const int n = tile_stages(s, L.lane, k, t0);
    for (int i = 0; i < n; ++i) {
      alignas(16) scalar_t e[E];
      read_slot(slot(sh, REVERSE ? n - 1 - i : i, L.lane), e);
      if (L.seen) {
        scalar_t nxt[E];
        Op::combine(e, L.v, nxt);
        copy_elem<scalar_t, E>(nxt, L.v);
      } else {
        copy_elem<scalar_t, E>(e, L.v);
        L.seen = true;
      }
    }
  }

  // Step 2, one round: v with its neighbour d lanes beyond it in its warp
  // (y, from ScanExec::shift): earlier o later (REVERSE) or later o
  // earlier, both lanes owning stages.
  IPOC_HD static void round(Lane& L, int d) {
    const int l = L.lane, k = l % kScanWarp;
    const bool take = l < L.Pa && (REVERSE ? k + d < kScanWarp && l + d < L.Pa : k >= d);
    if (take) {
      scalar_t nxt[E];
      Op::combine(L.v, L.y, nxt);
      copy_elem<scalar_t, E>(nxt, L.v);
    }
  }

  // Step 3a: the warp's total into its slot of `tot`: the inclusive suffix
  // at its first lane, the inclusive prefix at its last lane that owns
  // stages.
  IPOC_HD static void publish(const Lane& L, scalar_t* tot) {
    const int l = L.lane, k = l % kScanWarp;
    if (l < L.Pa && (REVERSE ? k == 0 : (k == kScanWarp - 1 || l == L.Pa - 1)))
      copy_elem<scalar_t, E>(L.v, tot + (l / kScanWarp) * E);
  }

  // Step 3b: the combination of every element beyond the lane into run
  // (y holds the in-warp neighbour's inclusive scan): have is false where
  // there is none.
  IPOC_HD static void carry(Lane& L, const scalar_t* tot) {
    const int l = L.lane, k = l % kScanWarp, w = l / kScanWarp;
    const int j = REVERSE ? l + 1 : l - 1;
    L.have = l < L.Pa && j >= 0 && j < L.Pa;
    if (!L.have) return;
    const bool in_warp = REVERSE ? k < kScanWarp - 1 : k > 0;
    if constexpr (NW > 1) {
      // The warps beyond, nearest first: w + 1 .. Wa - 1 or w - 1 .. 0.
      const int first = REVERSE ? w + 1 : w - 1;
      const int last = REVERSE ? L.Wa - 1 : 0;
      if (REVERSE ? first <= last : first >= last) {
        scalar_t acc[E], nxt[E];
        copy_elem<scalar_t, E>(tot + last * E, acc);
        for (int v = last; v != first;) {
          v += REVERSE ? -1 : 1;
          Op::combine(tot + v * E, acc, nxt);
          copy_elem<scalar_t, E>(nxt, acc);
        }
        if (in_warp) {
          Op::combine(L.y, acc, L.run);
        } else {
          copy_elem<scalar_t, E>(acc, L.run);
        }
        return;
      }
    }
    copy_elem<scalar_t, E>(L.y, L.run);
  }

  // Step 4, one tile: the lane's results from the carry, in place.
  IPOC_HD static void walk(const Scenario& s, Lane& L, scalar_t* sh, int k) {
    int t0;
    const int n = tile_stages(s, L.lane, k, t0);
    for (int i = 0; i < n; ++i) {
      scalar_t* d = slot(sh, REVERSE ? n - 1 - i : i, L.lane);
      alignas(16) scalar_t e[E];
      read_slot(d, e);
      if (L.have) {
        Op::combine(e, L.run, L.y);
        copy_elem<scalar_t, E>(L.y, L.run);
      } else {
        copy_elem<scalar_t, E>(e, L.run);
        L.have = true;
      }
      store_row<scalar_t, N * N>(d, 0, L.run);
      store_row<scalar_t, N>(d + N * N, 0, L.run + N * N);
    }
  }

  // The scan of one scenario; `sh` holds kShared scalars.  `ex(f)` runs
  // f(lane) for every lane of the scenario, then a barrier over them;
  // `ex.warp(f)` the same with a barrier over each warp; `ex.shift<DOWN>(d)`
  // sets each lane's y to the v of the lane d after it (DOWN) or before it
  // in its warp.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s, scalar_t* sh) {
    scalar_t* tot = sh + kTile;
    for (int kk = 0; kk < s.NT; ++kk) {
      const int k = REVERSE ? s.NT - 1 - kk : kk;
      ex([&](Lane& L) { move_tile<false>(s, L.lane, sh, k); });
      ex([&](Lane& L) { aggregate(s, L, sh, k); });
    }
#pragma unroll 1
    for (int d = 1; d < kScanWarp; d <<= 1) {
      ex.template shift<REVERSE>(d);
      ex.warp([&](Lane& L) { round(L, d); });
    }
    ex.template shift<REVERSE>(1);
    if constexpr (NW > 1) ex([&](Lane& L) { publish(L, tot); });
    ex.warp([&](Lane& L) { carry(L, tot); });
    for (int kk = 0; kk < s.NT; ++kk) {
      const int k = REVERSE ? s.NT - 1 - kk : kk;
      if (s.NT > 1) ex([&](Lane& L) { move_tile<false>(s, L.lane, sh, k); });
      ex([&](Lane& L) { walk(s, L, sh, k); });
      ex([&](Lane& L) { move_tile<true>(s, L.lane, sh, k); });
    }
  }
};

#ifdef __CUDACC__
// One lane per thread; the scenario's barrier is its warp (P = 32), a
// named barrier over its P threads (P = 64, two scenarios per block) or
// the block's (P >= 128, one scenario).
template <class Lane, int P>
struct ScanExec {
  Lane& lane;
  template <class F>
  __device__ __forceinline__ void operator()(F&& f) {
    f(lane);
    if constexpr (P == kScanWarp) {
      __syncwarp();
    } else if constexpr (P < kScanBlock) {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + static_cast<int>(threadIdx.x) / P), "r"(P)
                   : "memory");
    } else {
      __syncthreads();
    }
  }
  template <class F>
  __device__ __forceinline__ void warp(F&& f) {
    f(lane);
    __syncwarp();
  }
  template <bool DOWN>
  __device__ __forceinline__ void shift(int d) {
#pragma unroll
    for (int i = 0; i < Lane::kE; ++i)
      lane.y[i] = DOWN ? __shfl_down_sync(0xffffffffu, lane.v[i], d)
                       : __shfl_up_sync(0xffffffffu, lane.v[i], d);
  }
};
#else
// Every lane of the scenario in turn (the barrier is the end of the loop);
// a shift reads the lanes' v as they stood before it, as a shuffle does.
template <class Lane, int P>
struct ScanHostExec {
  Lane* lanes;
  template <class F>
  void operator()(F&& f) {
    for (int l = 0; l < P; ++l) f(lanes[l]);
  }
  template <class F>
  void warp(F&& f) {
    (*this)(f);
  }
  template <bool DOWN>
  void shift(int d) {
    for (int l = 0; l < P; ++l) {
      const int k = l % kScanWarp;
      const int src = DOWN ? (k + d < kScanWarp ? l + d : l) : (k >= d ? l - d : l);
      copy_elem<typename Lane::Scalar, Lane::kE>(lanes[src].v, lanes[l].y);
    }
  }
};

// The scan on the host, scenario by scenario: `lanes` holds P Lane states
// and `sh` AffineScan::kShared scalars.
template <typename scalar_t, int N, int P, bool REVERSE>
void affine_scan_host(const scalar_t* F, const scalar_t* c, scalar_t* Fo, scalar_t* co,
                      int B, int T,
                      typename AffineScan<scalar_t, N, P, REVERSE>::Lane* lanes,
                      scalar_t* sh) {
  using Sc = AffineScan<scalar_t, N, P, REVERSE>;
  for (int b = 0; b < B; ++b) {
    const auto s = Sc::scenario(F, c, Fo, co, b, T);
    for (int l = 0; l < P; ++l) Sc::init(lanes[l], l, T);
    ScanHostExec<typename Sc::Lane, P> ex{lanes};
    Sc::schedule(ex, s, sh);
  }
}
#endif  // __CUDACC__

}  // namespace ipoc
