// The two scans of par_newton.cu (affine_scan_kernel, value_scan_kernel)
// as one lane schedule, generic over the element's algebra (scan.cuh
// AffineOp, ValueOp), for the kernels and for a host build that the CPU
// tests compile with g++.
//
// The inclusive scan of elements e_t over a scenario's horizon: REVERSE,
// the suffix e_t o e_{t+1} o ... o e_{T-1} (the costate recursion; the
// value scan, earlier before later); else the prefix e_t o ... o e_0 (the
// LQT forward pass).  One scenario is spread over P lanes, P a power of
// two from 32 to 256 (the wrappers' launch rule, ops/scan_kernels.py
// scan_lanes); lane l owns the contiguous chunk [l L, l L + L) of
// L = ceil(T / P) stages, and the first Pa = ceil(T / L) lanes own
// stages.  The chunks go through shared memory in tiles of LT stages of
// every lane: the scenario's lanes copy a tile's rows (F, c; A, b, C, eta,
// J) with cp.async, row by row, each lane's run of LT stages of a row in
// pieces of 16 bytes where the row and its slot allow them (else one
// scalar), neighbouring lanes on neighbouring pieces, so a warp's copy
// reads whole lines.  The schedule (LaneScan::schedule), each step ending
// in a barrier over the scenario's lanes (over its warp for those marked
// so):
//
//   1. walk:  per tile, in the scan's direction: the copy, then each lane
//             folds its stages into the chunk's aggregate;
//   2. warp:  the inclusive scan of the aggregates inside each warp of 32
//             lanes, Hillis-Steele in 5 rounds;
//   3. carry: the combination of everything beyond the lane: its in-warp
//             neighbour's inclusive scan, then, for P > 32, combined with
//             the totals of the warps beyond its own (each warp publishes
//             its total to shared memory, one barrier, and each lane
//             combines the at most P / 32 - 1 totals it needs in order);
//   4. walk:  per tile, the copy again, each lane's results from the carry
//             over its inputs in place, then the scenario's lanes store
//             the tile in pieces as they copied it.
//
// The operands, by the algebra's kInPlace:
//   * the affine element (20 scalars at n = 4) is read into registers: a
//     stage's slot lies an odd number of 16-byte units from the next
//     lane's, so a warp's 16-byte reads fall on distinct banks; the
//     rounds take the neighbour's element with __shfl_sync; tiles of 4
//     stages, and step 4 copies nothing where the horizon is one tile;
//   * the value element (56 scalars at n = 4, with a combine's
//     temporaries about 90 more) is read where it lies: the combine takes
//     the tile's slot, and the rounds the neighbour's element from the
//     lanes' first slots of the tile, each lane writing its own there
//     before the round, so that a lane holds one element in registers
//     (two would spill in float64).  A slot lies an odd number of scalars
//     from the next lane's, so a warp's scalar reads fall on distinct
//     banks (and the copies go one scalar a piece); a tile holds as many
//     stages, 1 to 4, as fit 16 KB a warp, so that the SM keeps warps
//     enough (2 at n = 4 in float32, 1 in float64).
//
// So a scenario costs 2T combines plus 5 rounds and at most 8 warp totals,
// with a critical path of 2L + 5 + P / 32 combines, and every global access
// is a warp's run of whole lines.  The association follows P: the results
// agree with the plain version to rounding, not to the bit.  Host and
// device (IPOC_HD): par_newton.cu runs one lane per thread (ScanExec
// below), the host build every lane of the scenario in turn.

#pragma once

#include "riccati_rows.h"  // odd_stride
#include "scan.cuh"        // AffineOp, ValueOp, copy_elem, load_row, store_row
#include "seq_trial.h"     // RingCopy

namespace ipoc {

constexpr int kScanWarp = 32;    // lanes of a warp: the inner scan's width
constexpr int kScanBlock = 128;  // threads per block where P < 128

// Bytes of the pieces that copy a row of `bytes` at `off` bytes into a
// slot of `stride` bytes: 16 where all three are made of them, else one
// scalar.
template <typename scalar_t>
constexpr int piece_bytes(int bytes, int off, int stride) {
  return bytes % 16 == 0 && off % 16 == 0 && stride % 16 == 0
             ? 16 : static_cast<int>(sizeof(scalar_t));
}

template <class Op, int P, bool REVERSE>
struct LaneScan {
  static_assert(P >= kScanWarp && (P & (P - 1)) == 0, "P: a power of two >= 32");
  static_assert(REVERSE || !Op::kInPlace, "the in-place operands: a suffix scan");
  using scalar_t = typename Op::Scalar;
  static constexpr int E = Op::E, NR = Op::kRows;
  static constexpr bool kInPlace = Op::kInPlace;
  static constexpr int NW = P / kScanWarp;  // warps per scenario
  static constexpr int SZ = static_cast<int>(sizeof(scalar_t));
  // A stage's slot in a tile: the element's rows, at a stride of an odd
  // number of scalars (in place) or of 16-byte units; slot (w, l) holds
  // stage w of lane l's tile.
  static constexpr int ES = kInPlace ? (E | 1) : odd_stride(E, 16 / SZ);
  // Stages of each lane in a tile.
  static constexpr int LT =
      !kInPlace ? 4
      : 16384 / (kScanWarp * ES * SZ) < 1 ? 1
      : 16384 / (kScanWarp * ES * SZ) > 4 ? 4
      : 16384 / (kScanWarp * ES * SZ);
  // Row r's piece bytes and pieces per stage.
  IPOC_HD static constexpr int unit(int r) {
    return piece_bytes<scalar_t>(Op::row_len(r) * SZ, Op::row_off(r) * SZ, ES * SZ);
  }
  IPOC_HD static constexpr int pieces(int r) { return Op::row_len(r) * SZ / unit(r); }
  // Scenarios and threads per block; shared scalars per scenario: the
  // tile, then the warp totals.
  static constexpr int kScenarios = P < kScanBlock ? kScanBlock / P : 1;
  static constexpr int kBlock = P * kScenarios;
  static constexpr int kTile = LT * P * ES;
  static constexpr int kShared = kTile + (NW > 1 ? NW * E : 0);

  struct Scenario {
    const scalar_t* in[NR];  // each row's array at the scenario's first stage
    scalar_t* out[NR];
    int T, L, NT;            // stages per lane, tiles
  };

  struct Lane {
    using Scalar = scalar_t;
    static constexpr int kE = E;
    int lane, Pa, Wa;
    bool seen, have;
    alignas(16) scalar_t v[E];                  // the aggregate, then its in-warp scan
    alignas(16) scalar_t y[kInPlace ? 1 : E];   // a neighbour's v (ScanExec::shift)
    alignas(16) scalar_t run[E];                // the carry, then the running result
  };

  // ins[r] and outs[r]: row r's (B, T, row_len(r)) arrays.
  IPOC_HD static Scenario scenario(const scalar_t* const* ins, scalar_t* const* outs,
                                   int b, int T) {
    Scenario s;
    const size_t t0 = static_cast<size_t>(b) * T;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s.in[r] = ins[r] + t0 * Op::row_len(r);
      s.out[r] = outs[r] + t0 * Op::row_len(r);
    }
    s.T = T;
    s.L = (T + P - 1) / P;
    s.NT = (s.L + LT - 1) / LT;
    return s;
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

  // The scenario's lanes move row R of tile k between global and shared
  // memory: lane `me` takes pieces me, me + P, ... of (lane, stage, piece),
  // so that neighbouring lanes take neighbouring pieces of one lane's run.
  template <int R, bool STORE>
  IPOC_HD static void move_row(const Scenario& s, int me, scalar_t* sh, int k) {
    constexpr int U = unit(R), NP = pieces(R), len = Op::row_len(R);
    for (int p = me; p < P * LT * NP; p += P) {
      const int q = p % NP, w = (p / NP) % LT, l = p / (NP * LT);
      int t0;
      if (w >= tile_stages(s, l, k, t0)) continue;
      const size_t g = static_cast<size_t>(t0 + w) * len + q * (U / SZ);
      move<U, STORE>(slot(sh, w, l) + Op::row_off(R) + q * (U / SZ),
                     (STORE ? s.out[R] : s.in[R]) + g);
    }
    if constexpr (R + 1 < NR) move_row<R + 1, STORE>(s, me, sh, k);
  }

  template <bool STORE>
  IPOC_HD static void move_tile(const Scenario& s, int me, scalar_t* sh, int k) {
    move_row<0, STORE>(s, me, sh, k);
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

  // A slot's element into registers, row by row in 16- or 8-byte vectors
  // where the rows allow them (the register operands), or back.
  template <int R = 0>
  IPOC_HD static void read_slot(const scalar_t* d, scalar_t* e) {
    load_row<scalar_t, Op::row_len(R)>(d + Op::row_off(R), 0, e + Op::row_off(R));
    if constexpr (R + 1 < NR) read_slot<R + 1>(d, e);
  }
  template <int R = 0>
  IPOC_HD static void write_slot(scalar_t* d, const scalar_t* e) {
    store_row<scalar_t, Op::row_len(R)>(d + Op::row_off(R), 0, e + Op::row_off(R));
    if constexpr (R + 1 < NR) write_slot<R + 1>(d, e);
  }

  // f(the element of slot d as the combine reads it).
  template <class F>
  IPOC_HD static void with_slot(const scalar_t* d, F&& f) {
    if constexpr (kInPlace) {
      f(d);
    } else {
      alignas(16) scalar_t e[E];
      read_slot(d, e);
      f(static_cast<const scalar_t*>(e));
    }
  }

  // Step 1, one tile: the lane's stages, in the scan's direction, into v.
  IPOC_HD static void aggregate(const Scenario& s, Lane& L, scalar_t* sh, int k) {
    int t0;
    const int n = tile_stages(s, L.lane, k, t0);
    for (int i = 0; i < n; ++i) {
      with_slot(slot(sh, REVERSE ? n - 1 - i : i, L.lane), [&](const scalar_t* e) {
        if (L.seen) {
          scalar_t nxt[E];
          Op::combine(e, L.v, nxt);
          copy_elem<scalar_t, E>(nxt, L.v);
        } else {
          copy_elem<scalar_t, E>(e, L.v);
          L.seen = true;
        }
      });
    }
  }

  // Step 2, one round: v with its neighbour d lanes beyond it in its warp,
  // `y` (a shuffled copy, or its first slot in place): earlier o later
  // (REVERSE) or later o earlier, both lanes owning stages.
  IPOC_HD static void round(Lane& L, int d, const scalar_t* y) {
    const int l = L.lane, k = l % kScanWarp;
    const bool take = l < L.Pa && (REVERSE ? k + d < kScanWarp && l + d < L.Pa : k >= d);
    if (take) {
      scalar_t nxt[E];
      Op::combine(L.v, y, nxt);
      copy_elem<scalar_t, E>(nxt, L.v);
    }
  }

  // The in-warp neighbour d lanes beyond lane l, as round() and carry()
  // read it: y, or its first slot.
  IPOC_HD static const scalar_t* beyond(const Lane& L, scalar_t* sh, int d) {
    if constexpr (kInPlace) {
      const int k = L.lane % kScanWarp;
      const int j = REVERSE ? (k + d < kScanWarp ? L.lane + d : L.lane)
                            : (k >= d ? L.lane - d : L.lane);
      return slot(sh, 0, j);
    } else {
      return L.y;
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
  IPOC_HD static void carry(Lane& L, const scalar_t* y, const scalar_t* tot) {
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
          Op::combine(y, acc, L.run);
        } else {
          copy_elem<scalar_t, E>(acc, L.run);
        }
        return;
      }
    }
    copy_elem<scalar_t, E>(y, L.run);
  }

  // Step 4, one tile: the lane's results from the carry, in place.
  IPOC_HD static void walk(const Scenario& s, Lane& L, scalar_t* sh, int k) {
    int t0;
    const int n = tile_stages(s, L.lane, k, t0);
    for (int i = 0; i < n; ++i) {
      scalar_t* d = slot(sh, REVERSE ? n - 1 - i : i, L.lane);
      with_slot(d, [&](const scalar_t* e) {
        if (L.have) {
          scalar_t nxt[E];
          Op::combine(e, L.run, nxt);
          copy_elem<scalar_t, E>(nxt, L.run);
        } else {
          copy_elem<scalar_t, E>(e, L.run);
          L.have = true;
        }
      });
      if constexpr (kInPlace) {
        copy_elem<scalar_t, E>(L.run, d);
      } else {
        write_slot(d, L.run);
      }
    }
  }

  // The lane's v into its first slot, where its warp's lanes read it.
  IPOC_HD static void post(const Lane& L, scalar_t* sh) {
    copy_elem<scalar_t, E>(L.v, slot(sh, 0, L.lane));
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
      if constexpr (kInPlace) {
        ex.warp([&](Lane& L) { post(L, sh); });
      } else {
        ex.template shift<REVERSE>(d);
      }
      ex.warp([&](Lane& L) { round(L, d, beyond(L, sh, d)); });
    }
    if constexpr (kInPlace) {
      ex.warp([&](Lane& L) { post(L, sh); });
      if constexpr (NW > 1) ex([&](Lane& L) { publish(L, tot); });
      // The tile's copies overwrite the first slots: a barrier over the
      // scenario first.
      ex([&](Lane& L) { carry(L, beyond(L, sh, 1), tot); });
    } else {
      ex.template shift<REVERSE>(1);
      if constexpr (NW > 1) ex([&](Lane& L) { publish(L, tot); });
      ex.warp([&](Lane& L) { carry(L, L.y, tot); });
    }
    for (int kk = 0; kk < s.NT; ++kk) {
      const int k = REVERSE ? s.NT - 1 - kk : kk;
      if (kInPlace || s.NT > 1) ex([&](Lane& L) { move_tile<false>(s, L.lane, sh, k); });
      ex([&](Lane& L) { walk(s, L, sh, k); });
      ex([&](Lane& L) { move_tile<true>(s, L.lane, sh, k); });
    }
  }
};

template <typename scalar_t, int N, int P, bool REVERSE>
using AffineScan = LaneScan<AffineOp<scalar_t, N>, P, REVERSE>;
template <typename scalar_t, int N, int P>
using ValueScan = LaneScan<ValueOp<scalar_t, N>, P, true>;

#ifdef __CUDACC__
// One lane per thread; the scenario's barrier is a named barrier over its
// P threads (P < 128: 128 / P scenarios a block) or the block's (P >= 128,
// one scenario).  At P = 32 every warp of the block arrives at barrier 1
// with a count of 32, which its own arrival completes: a constant id, so
// ptxas reserves no more barriers than that and the SM keeps as many
// blocks as at P >= 128.  Not __syncwarp there: it let a lane read the
// tile before another lane's cp.async copies into it had landed (the value
// scan in float64 at n = 4 gave wrong results on an H100, the named
// barrier right ones; PERF.md section 6).  The rounds' ex.warp steps move
// only registers and plain shared stores.
template <class Lane, int P>
struct ScanExec {
  Lane& lane;
  template <class F>
  __device__ __forceinline__ void operator()(F&& f) {
    f(lane);
    if constexpr (P == kScanWarp) {
      asm volatile("bar.sync 1, 32;" ::: "memory");
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

// A scan on the host, scenario by scenario: `lanes` holds P Lane states
// and `sh` Sc::kShared scalars; ins and outs as Sc::scenario.
template <class Sc>
void lane_scan_host(const typename Sc::scalar_t* const* ins,
                    typename Sc::scalar_t* const* outs, int B, int T,
                    typename Sc::Lane* lanes, typename Sc::scalar_t* sh) {
  constexpr int P = Sc::NW * kScanWarp;
  for (int b = 0; b < B; ++b) {
    const auto s = Sc::scenario(ins, outs, b, T);
    for (int l = 0; l < P; ++l) Sc::init(lanes[l], l, T);
    ScanHostExec<typename Sc::Lane, P> ex{lanes};
    Sc::schedule(ex, s, sh);
  }
}

template <typename scalar_t, int N, int P, bool REVERSE>
void affine_scan_host(const scalar_t* F, const scalar_t* c, scalar_t* Fo, scalar_t* co,
                      int B, int T,
                      typename AffineScan<scalar_t, N, P, REVERSE>::Lane* lanes,
                      scalar_t* sh) {
  const scalar_t* ins[2] = {F, c};
  scalar_t* outs[2] = {Fo, co};
  lane_scan_host<AffineScan<scalar_t, N, P, REVERSE>>(ins, outs, B, T, lanes, sh);
}
#endif  // __CUDACC__

}  // namespace ipoc
