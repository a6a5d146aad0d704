// The backward Riccati step of riccati.cuh spread over a group of G lanes
// of one warp, for the sequential trial (seq_trial.h) and the fused
// backward sweep (fused_bwd.h), and for a host build that the CPU tests
// compile with g++.
//
// G is the least power of two >= NX (2 at nx=2, 4 at nx=3 and 4, 8 at
// nx=6).  Lane r of a group owns row r of Vxx, Vfx = Vxx fx, Qxx and Qxu;
// a lane with r >= NX (nx=3: lane 3) is spare: it computes on row NX-1
// and writes nothing.  What crosses rows goes through the group's slice of
// shared memory (`xch`), written in one phase and read in the next, after
// a barrier over the group's lanes:
//
//   1. vf:    Vfx row r and Vfu row r -> xch;
//   2. gains: every row of Vfx and Vfu from xch; Qxx row r (its upper
//             part, j >= r: the entries riccati_step computes for row r),
//             Quu, Qu (every lane), Qxu row r, Qx_r; the elimination of
//             Quu against [Qu | Qxu row r'] on every lane, which gives k
//             and column r of K; Vx_r -> xch, column r of K -> xch;
//   3. value: every column of K and all of Vx from xch; the upper part of
//             row r of the new Vxx -> xch at (r, j) and (j, r); dV;
//   and, at the start of the next stage's phase 1, carry: row r of the new
//   Vxx from xch (three barriers a stage).
//
// Every entry is computed by one lane with riccati_step's operations in
// riccati_step's order (the upper triangle, mirrored; the unpivoted
// elimination with the interleaved right-hand side, whose columns are
// independent, so a lane eliminates only its two; the NaN-propagating
// minimum pivot), and every lane runs the same instructions on its own
// row, so the warp does not diverge.  The terms of the lane's row that
// read the stage's Q, fx and M (`Rows`) come from its row and column of
// them: read at its offsets in shared memory (rows_at, the seq trial's), or,
// where the stage data sit in registers and hold the generated program's
// constants (the fused sweep's), computed for every row as riccati_step
// computes them and picked by selects (rows_pick).  nvcc contracts a
// product into the sum that reads it (an FMA, one rounding) as it sees
// them, constants included, so a row read by selects alone rounded apart
// from riccati_step's (on an H100: an ulp on 66 of 256 pendulum lanes
// after two stages).  As they are, the seq trial's results equal its
// one-thread parent kernel's to the bit, and so do the fused sweep's at
// cartpole, in float32 and float64 (PERF.md section 5).
//
// DDP = true is riccati_step<..., true>'s step (the merged trial's DDP
// mode, merged_trial.h): Qu = ru, Qx_r = hx_r (the stage's lam_new, which
// the caller hands to rows_pick), dV += 1/2 k'Qu, the pivots of Quu alone,
// NaN gains where Quu is not positive definite (ddp_gain); every other
// entry as in Newton mode.

#pragma once

#include "riccati.cuh"

namespace ipoc {

constexpr int kRowWarp = 32;

// Lanes per scenario: the least power of two >= nx.
constexpr int row_lanes(int nx) { return nx <= 1 ? 1 : 2 * row_lanes((nx + 1) / 2); }

// The least multiple of `a` (a power of two) that is >= n and an odd
// multiple of a: groups `a` apart in a warp then touch distinct banks.
constexpr int odd_stride(int n, int a) {
  return ((n + a - 1) / a) % 2 == 1 ? (n + a - 1) / a * a : ((n + a - 1) / a + 1) * a;
}

// a[i * stride] for a row i known only at run time, by selects.
template <typename scalar_t, int N>
IPOC_HD scalar_t pick(const scalar_t* a, int stride, int i) {
  scalar_t v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = (i == k) ? a[k * stride] : v;
  return v;
}

template <typename scalar_t, int NX, int NU, bool DDP = false>
struct RowStep {
  static constexpr int G = row_lanes(NX);
  // The group's exchange slice, in scalars: the rows of Vfx (G x NX) and
  // of Vfu (G x NU), the columns of K (G x NU), Vx (G), Vxx (NX x NX).
  static constexpr int kVfx = 0;
  static constexpr int kVfu = kVfx + G * NX;
  static constexpr int kK = kVfu + G * NU;
  static constexpr int kVx = kK + G * NU;
  static constexpr int kVxx = kVx + G;
  static constexpr int kXch = odd_stride(kVxx + NX * NX, G);

  // The lane's row of the Q-function's stage part: Qxx[r][j] (entries
  // j >= r), Qxu[r][:] and Qx_r.
  struct Rows {
    scalar_t qxx[NX];
    scalar_t qxu[NU];
    scalar_t qx;
  };

  struct Lane {
    int r;                    // the row this lane owns (spare if >= NX)
    int rr;                   // min(r, NX - 1): the row it reads
    scalar_t vr[NX];          // Vxx[r][:]
    scalar_t vx[NX];          // Vx, on every lane
    scalar_t dv, piv;         // dV and the minimum pivot, on every lane
    // Carried between the phases of one step.
    scalar_t qxx[NX];         // Qxx[r][:] (entries j >= r)
    scalar_t qxu[NU];         // Qxu[r][:]
    scalar_t quu[NU * NU];    // Quu
    scalar_t qu[NU];          // Qu
    scalar_t k[NU];           // the feedforward gain
    scalar_t kc[NU];          // K[:][r]
    scalar_t piv_t;           // this stage's pivot
    bool fresh;               // vr holds the carry (else it waits in xch)
  };

  IPOC_HD static bool owns(const Lane& L) { return L.r < NX; }

  // Lane r of the group at the start of a sweep: Vx = 0, dV = 0, no pivot.
  IPOC_HD static void init(Lane& L, int r) {
    L.r = r;
    L.rr = r < NX ? r : NX - 1;
#pragma unroll
    for (int i = 0; i < NX; ++i) L.vx[i] = scalar_t(0);
    L.dv = scalar_t(0);
    L.piv = scalar_t(INFINITY);
    L.fresh = true;
  }

  // The lane's Rows (phase 2, from phase 1's exchange: Vfx, Vfu and the
  // lane's Vx) from its row of Q, its column of fx and its row of M:
  //   Qxx[r][j] = Q[r][j] + fx[:][r]' Vfx[:][j],  Qxu[r][:] = M[r][:] +
  //   fx[:][r]' Vfu,  Qx_r = fx[:][r]' Vx.
  IPOC_HD static void rows_from(const Lane& L, const scalar_t* Qr,
                                const scalar_t* fxc, const scalar_t* Mr,
                                const scalar_t* xch, Rows& w) {
    const scalar_t* Vfx = xch + kVfx;
    const scalar_t* Vfu = xch + kVfu;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = Qr[j] + fxc[0] * Vfx[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fxc[l] * Vfx[l * NX + j];
      w.qxx[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = fxc[0] * Vfu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + fxc[l] * Vfu[l * NU + j];
      w.qxu[j] = Mr[j] + acc;
    }
    if constexpr (!DDP) {
      w.qx = fxc[0] * L.vx[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) w.qx = w.qx + fxc[l] * L.vx[l];
    }
  }

  // The lane's row of row-major Q (NX x NX) and M (NX x NU) and column of
  // fx (NX x NX), read at its offsets (shared memory, or any host array).
  IPOC_HD static void rows_at(const Lane& L, const scalar_t* Q,
                              const scalar_t* fx, const scalar_t* M,
                              const scalar_t* xch, Rows& w) {
    scalar_t Qr[NX], fxc[NX], Mr[NU];
#pragma unroll
    for (int j = 0; j < NX; ++j) Qr[j] = Q[L.rr * NX + j];
#pragma unroll
    for (int l = 0; l < NX; ++l) fxc[l] = fx[l * NX + L.rr];
#pragma unroll
    for (int m = 0; m < NU; ++m) Mr[m] = M[L.rr * NU + m];
    rows_from(L, Qr, fxc, Mr, xch, w);
  }

  // The same from arrays in registers (the fused sweep's stage data, which
  // hold the generated program's constants): every row computed with
  // indices known at compile time, as riccati_step computes it, then the
  // lane's row picked by selects, so that no register array is indexed at
  // run time and the compiler folds and contracts each row against the
  // constants as it does in riccati_step.  In DDP mode Qx_r is hx_r,
  // picked alike.
  IPOC_HD static void rows_pick(const Lane& L, const scalar_t* Q,
                                const scalar_t* fx, const scalar_t* M,
                                const scalar_t* xch, Rows& w,
                                const scalar_t* hx = nullptr) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      scalar_t Qr[NX], fxc[NX], Mr[NU];
#pragma unroll
      for (int j = 0; j < NX; ++j) Qr[j] = Q[i * NX + j];
#pragma unroll
      for (int l = 0; l < NX; ++l) fxc[l] = fx[l * NX + i];
#pragma unroll
      for (int m = 0; m < NU; ++m) Mr[m] = M[i * NU + m];
      Rows wi;
      rows_from(L, Qr, fxc, Mr, xch, wi);
      if constexpr (DDP) wi.qx = hx[i];
      const bool take = i == 0 || L.rr == i;
#pragma unroll
      for (int j = 0; j < NX; ++j) w.qxx[j] = take ? wi.qxx[j] : w.qxx[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) w.qxu[j] = take ? wi.qxu[j] : w.qxu[j];
      w.qx = take ? wi.qx : w.qx;
    }
  }

  // Phase 1: the previous stage's carry; Vfx row r = Vxx[r][:] fx, Vfu
  // row r = Vxx[r][:] fu.
  IPOC_HD static void vf(Lane& L, const scalar_t* fx, const scalar_t* fu,
                         scalar_t* xch) {
    if (!L.fresh) carry(L, xch);
    L.fresh = false;
    scalar_t vfx[NX], vfu[NU];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = L.vr[0] * fx[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + L.vr[l] * fx[l * NX + j];
      vfx[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = L.vr[0] * fu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + L.vr[l] * fu[l * NU + j];
      vfu[j] = acc;
    }
    if (!owns(L)) return;
#pragma unroll
    for (int j = 0; j < NX; ++j) xch[kVfx + L.r * NX + j] = vfx[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) xch[kVfu + L.r * NU + j] = vfu[j];
  }

  // Phase 2: the lane's rows of the Q-function (w), Quu and Qu, the gains
  // k and K[:][r], Vx_r.  `R` is the regularized control weight.
  IPOC_HD static void gains(Lane& L, const scalar_t* ru, const scalar_t* R,
                            const scalar_t* fu, const Rows& w, scalar_t* xch) {
    const scalar_t* Vfu = xch + kVfu;
#pragma unroll
    for (int j = 0; j < NX; ++j) L.qxx[j] = w.qxx[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) L.qxu[j] = w.qxu[j];
    // Quu = R + fu' Vfu: upper triangle, mirrored (every lane).
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = i; j < NU; ++j) {
        scalar_t acc = R[i * NU + j] + fu[i] * Vfu[j];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc = acc + fu[l * NU + i] * Vfu[l * NU + j];
        L.quu[i * NU + j] = acc;
        L.quu[j * NU + i] = acc;
      }
    }
    // Qu = ru + fu' Vx (DDP: ru).
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      if constexpr (DDP) {
        L.qu[i] = ru[i];
      } else {
        scalar_t acc = fu[i] * L.vx[0];
#pragma unroll
        for (int l = 1; l < NX; ++l) acc = acc + fu[l * NU + i] * L.vx[l];
        L.qu[i] = ru[i] + acc;
      }
    }
    // Quu [k | K[:][r]] = -[Qu | Qxu[r][:]'], two of riccati_step's 1 + NX
    // right-hand side columns.
    scalar_t a[NU * NU], sol[NU * 2];
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) a[i] = L.quu[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      sol[i * 2] = L.qu[i];
      sol[i * 2 + 1] = L.qxu[i];
    }
    L.piv_t = solve_track<scalar_t, NU, 2>(a, sol);
    if constexpr (!DDP) L.piv_t = nan_min(L.piv_t, pivots_only<scalar_t, NU>(R));
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      L.k[i] = -sol[i * 2];
      L.kc[i] = -sol[i * 2 + 1];
      if constexpr (DDP) {
        L.k[i] = ddp_gain(L.k[i], L.piv_t);
        L.kc[i] = ddp_gain(L.kc[i], L.piv_t);
      }
    }
    // Vx_r = Qx_r + Qxu[r][:] k.
    scalar_t acc = L.qxu[0] * L.k[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc = acc + L.qxu[j] * L.k[j];
    if (!owns(L)) return;
    xch[kVx + L.r] = w.qx + acc;
#pragma unroll
    for (int i = 0; i < NU; ++i) xch[kK + L.r * NU + i] = L.kc[i];
  }

  // Phase 3: Vx from every row; the upper part of Vxx's row r,
  // Qxx[r][j] + Qxu[r][:] K[:][j], to (r, j) and (j, r); dV and the pivot.
  IPOC_HD static void value(Lane& L, scalar_t* xch) {
#pragma unroll
    for (int i = 0; i < NX; ++i) L.vx[i] = xch[kVx + i];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = L.qxx[j] + L.qxu[0] * xch[kK + j * NU];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + L.qxu[l] * xch[kK + j * NU + l];
      if (owns(L) && j >= L.r) {
        xch[kVxx + L.r * NX + j] = acc;
        xch[kVxx + j * NX + L.r] = acc;
      }
    }
    // dV += k'Qu + 1/2 k'Quu k (DDP: 1/2 k'Qu).
    scalar_t kQu = L.k[0] * L.qu[0];
#pragma unroll
    for (int i = 1; i < NU; ++i) kQu = kQu + L.k[i] * L.qu[i];
    if constexpr (DDP) {
      L.dv = L.dv + scalar_t(0.5) * kQu;
      L.piv = nan_min(L.piv, L.piv_t);
      return;
    }
    scalar_t kQk = scalar_t(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = L.quu[i * NU] * L.k[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) acc = acc + L.quu[i * NU + j] * L.k[j];
      kQk = (i == 0) ? L.k[0] * acc : kQk + L.k[i] * acc;
    }
    L.dv = L.dv + kQu + scalar_t(0.5) * kQk;
    L.piv = nan_min(L.piv, L.piv_t);
  }

  // Row r of the new Vxx (phase 3's, after the barrier that ends it).
  IPOC_HD static void carry(Lane& L, const scalar_t* xch) {
#pragma unroll
    for (int j = 0; j < NX; ++j) L.vr[j] = xch[kVxx + L.rr * NX + j];
  }

  // The whole step, phase by phase; `ex(f)` runs f(lane) for each of the
  // group's lanes, then a barrier over them (WarpExec, GroupExec below;
  // the lanes may be any type derived from Lane).  `first(L)` runs at the
  // start of the first phase (where the stage data may be computed: ru, R,
  // fx and fu are read after it); `rows(L, xch, w)` fills the lane's Rows
  // (rows_at or rows_pick);
  // `after_gains(L)` sees its k and K[:][r] (to store them).
  template <class Exec, class FirstFn, class RowsFn, class GainsFn>
  IPOC_HD static void step(Exec& ex, scalar_t* xch, const scalar_t* ru,
                           const scalar_t* R, const scalar_t* fx,
                           const scalar_t* fu, FirstFn&& first, RowsFn&& rows,
                           GainsFn&& after_gains) {
    ex([&](auto& L) {
      first(L);
      vf(L, fx, fu, xch);
    });
    ex([&](auto& L) {
      Rows w;
      rows(L, xch, w);
      gains(L, ru, R, fu, w, xch);
      after_gains(L);
    });
    ex([&](auto& L) { value(L, xch); });
  }
};

// The executors of a group's schedule.  On the card each thread is one
// lane: it runs the step's part for its lane, then a barrier over the
// warp (every lane of the warp runs every step).  On the host the group's
// lanes run the step in turn (the barrier is the end of the loop).
// `share<g>(get, put)` hands each lane's value get(lane) to every lane of
// its group of g consecutive lanes, put(lane, j, value of the group's lane
// j): on the card by __shfl_sync (no barrier), on the host once every lane
// has made its value.
#ifdef __CUDACC__
template <class LaneT>
struct WarpExec {
  LaneT& lane;
  template <class F>
  __device__ __forceinline__ void operator()(F&& f) {
    f(lane);
    __syncwarp();
  }
  template <int g, class Get, class Put>
  __device__ __forceinline__ void share(Get&& get, Put&& put) {
    const auto v = get(lane);
    const int base = static_cast<int>(threadIdx.x) & (kRowWarp - 1) & ~(g - 1);
#pragma unroll
    for (int j = 0; j < g; ++j) put(lane, j, __shfl_sync(0xffffffffu, v, base + j));
  }
};
#else
template <class LaneT, int G>
struct GroupExec {
  LaneT* lanes;
  template <class F>
  void operator()(F&& f) {
    for (int l = 0; l < G; ++l) f(lanes[l]);
  }
  template <int g, class Get, class Put>
  void share(Get&& get, Put&& put) {
    decltype(get(lanes[0])) v[G];
    for (int l = 0; l < G; ++l) v[l] = get(lanes[l]);
    for (int l = 0; l < G; ++l)
      for (int j = 0; j < g; ++j) put(lanes[l], j, v[(l & ~(g - 1)) + j]);
  }
};
#endif

}  // namespace ipoc
