// The sequential Newton trial (seq_newton.cu seq_trial_kernel) as a group
// schedule, for the kernel and for a host build that the CPU tests compile
// with g++.
//
// One scenario is a group of G lanes of one warp (riccati_rows.h); a warp
// holds S = 32 / G scenarios.  The stage data come through a ring in shared
// memory: in the (B, T, rows) inputs a scenario's W consecutive stages of
// one array are one contiguous run, and the group's lanes copy each run of
// chunk j + kSlots - 1 (16-byte copies where the run's start and length
// allow it, one scalar each otherwise) while the sweep works on chunk j,
// so the loads are requested two chunks of serial work before they are
// needed.  Chunks are W stages from t = 0 (the backward sweep meets the
// partial one first).
//
//   backward: per chunk, the wait for its copies, then for each of its
//             stages, last first, the cooperative Riccati step
//             (RowStep::step) on the ring's rows; each lane stores its
//             column of K (lane 0 also k) into the (B, T, (1+NX)*NU) gain
//             scratch; lane 0 writes pred and ok at the end;
//   forward:  per chunk, fx, fu and the gains through the same ring; every
//             lane of the group runs the closed-loop deviation rollout
//             (du = k + K dx, dx+ = fx dx + fu du, dx0 = 0), lane 0 keeps
//             the chunk's du and dx in a staging slice, and the group writes
//             them to du and dx as contiguous runs.
//
// The arithmetic is riccati_step's (through RowStep) and the parent
// kernel's forward step, in the same order.  A scenario past B (the last
// block's) runs on scenario B - 1's data and writes nothing.  Host and
// device (IPOC_HD); seq_newton.cu runs one lane per thread (WarpExec), the
// host executor (seq_trial_host) each group's lanes in turn.

#pragma once

#include <stdint.h>
#include <string.h>

#include "riccati_rows.h"

namespace ipoc {

// The ring's copies: cp.async on the card (a thread waits for its own
// copies; the barrier that follows publishes them to the group), plain
// copies on the host.
struct RingCopy {
  template <typename scalar_t>
  IPOC_HD static void vec16(scalar_t* dst, const scalar_t* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
#else
    memcpy(dst, src, 16);
#endif
  }
  template <typename scalar_t>
  IPOC_HD static void one(scalar_t* dst, const scalar_t* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(sizeof(scalar_t))
                 : "memory");
#else
    *dst = *src;
#endif
  }
  IPOC_HD static void commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }
  template <int N>
  IPOC_HD static void wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
  }
};

template <typename scalar_t, int NX, int NU>
struct SeqTrial {
  using Step = RowStep<scalar_t, NX, NU>;
  static constexpr int G = Step::G;
  static constexpr int S = kRowWarp / G;  // scenarios per block (one warp)
  static constexpr int NG = (1 + NX) * NU;
  static constexpr int W = 4;       // stages per chunk: every run a multiple of 4 scalars
  static constexpr int kSlots = 3;  // chunk j + 2 is copied while chunk j is worked on
  static constexpr int V = 16 / static_cast<int>(sizeof(scalar_t));  // scalars per 16 bytes
  // A scenario's slot: W stages of each array, one array after another;
  // backward (ru, Q, R, M, fx, fu) or forward (fx, fu, gains).
  static constexpr int oRu = 0, oQ = oRu + W * NU, oR = oQ + W * NX * NX,
                       oM = oR + W * NU * NU, oFx = oM + W * NX * NU,
                       oFu = oFx + W * NX * NX, kBwd = oFu + W * NX * NU;
  static constexpr int oFx2 = 0, oFu2 = oFx2 + W * NX * NX, oG = oFu2 + W * NX * NU,
                       kFwd = oG + W * NG;
  // Slots at an odd multiple of max(G, V) scalars: 16-byte aligned, and the
  // warp's groups on distinct banks.
  static constexpr int A = G > V ? G : V;
  static constexpr int kSlot = odd_stride(kBwd > kFwd ? kBwd : kFwd, A);
  static constexpr int kOut = odd_stride(W * (NU + NX), A);  // a chunk's du, then dx
  // The block's shared memory, in scalars: the ring [kSlots][S][kSlot],
  // the staging [S][kOut], the exchange slices [S][kXch].
  static constexpr int kRing = kSlots * S * kSlot;
  static constexpr int kShared = kRing + S * kOut + S * Step::kXch;

  struct Lane : Step::Lane {
    scalar_t d[NX];  // the forward sweep's deviation
  };

  struct Scenario {
    const scalar_t *ru, *Q, *R, *M, *fx, *fu;  // this scenario's (T, rows) runs
    const scalar_t* XT;                          // (NX, NX)
    scalar_t *gains, *du, *dx, *pred;            // (T, NG), (T, NU), (T+1, NX), ()
    bool* ok;
    int T;
    bool valid;       // b < B: write results
    scalar_t* slot0;  // this scenario's slot in slot 0 of the ring
    scalar_t* out;    // its staging slice
    scalar_t* xch;    // its exchange slice
  };

  IPOC_HD static Scenario scenario(const scalar_t* ru, const scalar_t* Q,
                                   const scalar_t* R, const scalar_t* M,
                                   const scalar_t* fx, const scalar_t* fu,
                                   const scalar_t* XT, scalar_t* gains,
                                   scalar_t* du, scalar_t* dx, scalar_t* pred,
                                   bool* ok, int b, int B, int T, int s,
                                   scalar_t* sh) {
    const bool valid = b < B;
    const size_t c = static_cast<size_t>(valid ? b : B - 1);
    const size_t n = static_cast<size_t>(T);
    return Scenario{ru + c * n * NU, Q + c * n * NX * NX, R + c * n * NU * NU,
                    M + c * n * NX * NU, fx + c * n * NX * NX, fu + c * n * NX * NU,
                    XT + c * NX * NX, gains + c * n * NG, du + c * n * NU,
                    dx + c * (n + 1) * NX, pred + c, ok + c, T, valid,
                    sh + s * kSlot, sh + kRing + s * kOut,
                    sh + kRing + S * kOut + s * Step::kXch};
  }

  IPOC_HD static int chunks(int T) { return (T + W - 1) / W; }
  IPOC_HD static scalar_t* slot(const Scenario& s, int j) {
    return s.slot0 + (j % kSlots) * S * kSlot;
  }

  // Lane r's share of one run of n stages of ROWS scalars.
  template <int ROWS>
  IPOC_HD static void fetch_run(int r, scalar_t* dst, const scalar_t* src, int n) {
    const int len = n * ROWS;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && len % V == 0) {
      for (int p = r; p < len / V; p += G) RingCopy::vec16(dst + p * V, src + p * V);
    } else {
      for (int p = r; p < len; p += G) RingCopy::one(dst + p, src + p);
    }
  }

  // The copies of the backward sweep's j-th chunk (chunk C - 1 - j), one
  // commit group per chunk (empty past the last).
  IPOC_HD static void fetch_bwd(const Scenario& s, int r, int j) {
    const int C = chunks(s.T);
    if (j < C) {
      const int t0 = (C - 1 - j) * W, n = s.T - t0 < W ? s.T - t0 : W;
      const size_t t = static_cast<size_t>(t0);
      scalar_t* d = slot(s, j);
      fetch_run<NU>(r, d + oRu, s.ru + t * NU, n);
      fetch_run<NX * NX>(r, d + oQ, s.Q + t * NX * NX, n);
      fetch_run<NU * NU>(r, d + oR, s.R + t * NU * NU, n);
      fetch_run<NX * NU>(r, d + oM, s.M + t * NX * NU, n);
      fetch_run<NX * NX>(r, d + oFx, s.fx + t * NX * NX, n);
      fetch_run<NX * NU>(r, d + oFu, s.fu + t * NX * NU, n);
    }
    RingCopy::commit();
  }

  IPOC_HD static void fetch_fwd(const Scenario& s, int r, int j) {
    if (j < chunks(s.T)) {
      const int t0 = j * W, n = s.T - t0 < W ? s.T - t0 : W;
      const size_t t = static_cast<size_t>(t0);
      scalar_t* d = slot(s, j);
      fetch_run<NX * NX>(r, d + oFx2, s.fx + t * NX * NX, n);
      fetch_run<NX * NU>(r, d + oFu2, s.fu + t * NX * NU, n);
      fetch_run<NG>(r, d + oG, s.gains + t * NG, n);
    }
    RingCopy::commit();
  }

  IPOC_HD static void init(const Scenario& s, Lane& L) {
    Step::init(L, L.r);
#pragma unroll
    for (int j = 0; j < NX; ++j) L.vr[j] = s.XT[L.rr * NX + j];
  }

  // The backward sweep of one scenario: the gains to the scratch, pred, ok.
  template <class Exec>
  IPOC_HD static void backward(Exec& ex, const Scenario& s) {
    const int C = chunks(s.T);
    ex([&](Lane& L) {
      init(s, L);
      for (int j = 0; j < kSlots - 1; ++j) fetch_bwd(s, L.r, j);
    });
    for (int j = 0; j < C; ++j) {
      ex([&](Lane& L) {
        fetch_bwd(s, L.r, j + kSlots - 1);
        RingCopy::wait<kSlots - 1>();
      });
      const int t0 = (C - 1 - j) * W;
      const int n = s.T - t0 < W ? s.T - t0 : W;
      const scalar_t* d = slot(s, j);
      for (int w = n - 1; w >= 0; --w) {
        const size_t t = static_cast<size_t>(t0 + w);
        const scalar_t* Q = d + oQ + w * NX * NX;
        const scalar_t* fx = d + oFx + w * NX * NX;
        const scalar_t* M = d + oM + w * NX * NU;
        Step::step(
            ex, s.xch, d + oRu + w * NU, d + oR + w * NU * NU, fx,
            d + oFu + w * NX * NU, [](const Lane&) {},
            [&](const auto& L, const scalar_t* xch, typename Step::Rows& rw) {
              Step::rows_at(L, Q, fx, M, xch, rw);
            },
            [&](const Lane& L) {
              if (!s.valid) return;
              scalar_t* g = s.gains + t * NG;
              if (Step::owns(L)) {
#pragma unroll
                for (int m = 0; m < NU; ++m) g[NU + m * NX + L.r] = L.kc[m];
              }
              if (L.r == 0) {
#pragma unroll
                for (int m = 0; m < NU; ++m) g[m] = L.k[m];
              }
            });
      }
    }
    ex([&](Lane& L) {
      if (s.valid && L.r == 0) {
        *s.pred = L.dv;
        *s.ok = ipoc_isfinite(L.piv) && L.piv > scalar_t(0) && ipoc_isfinite(L.dv);
      }
    });
  }

  // Stage w of forward chunk j on every lane (lane 0 stages du and dx).
  IPOC_HD static void forward_stage(const Scenario& s, Lane& L, const scalar_t* d,
                                    int w) {
    const scalar_t* g = d + oG + w * NG;
    const scalar_t* fx = d + oFx2 + w * NX * NX;
    const scalar_t* fu = d + oFu2 + w * NX * NU;
    scalar_t dut[NU], nxt[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = g[NU + i * NX] * L.d[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + g[NU + i * NX + j] * L.d[j];
      dut[i] = g[i] + acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      scalar_t ax = fx[i * NX] * L.d[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) ax = ax + fx[i * NX + j] * L.d[j];
      scalar_t au = fu[i * NU] * dut[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) au = au + fu[i * NU + j] * dut[j];
      nxt[i] = ax + au;
    }
    if (L.r == 0) {
#pragma unroll
      for (int i = 0; i < NU; ++i) s.out[w * NU + i] = dut[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) s.out[W * NU + w * NX + i] = nxt[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) L.d[i] = nxt[i];
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

  // The forward sweep of one scenario: du and dx.
  template <class Exec>
  IPOC_HD static void forward(Exec& ex, const Scenario& s) {
    const int C = chunks(s.T);
    ex([&](Lane& L) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        L.d[i] = scalar_t(0);
        if (s.valid && L.r == 0) s.dx[i] = scalar_t(0);
      }
      for (int j = 0; j < kSlots - 1; ++j) fetch_fwd(s, L.r, j);
    });
    for (int j = 0; j < C; ++j) {
      const int t0 = j * W, n = s.T - t0 < W ? s.T - t0 : W;
      const scalar_t* d = slot(s, j);
      ex([&](Lane& L) {
        fetch_fwd(s, L.r, j + kSlots - 1);
        RingCopy::wait<kSlots - 1>();
      });
      ex([&](Lane& L) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (w < n) forward_stage(s, L, d, w);
        }
      });
      ex([&](Lane& L) {
        if (!s.valid) return;
        const size_t t = static_cast<size_t>(t0);
        store_run(L.r, s.du + t * NU, s.out, n * NU);
        store_run(L.r, s.dx + (t + 1) * NX, s.out + W * NU, n * NX);
      });
    }
  }

  // The whole trial of one scenario.  The forward sweep reads the gains
  // that the group's lanes stored in the backward sweep: `publish()` runs
  // between the sweeps (on the card, a fence over the block's memory).
  template <class Exec, class Publish>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s, Publish&& publish) {
    backward(ex, s);
    publish();
    forward(ex, s);
  }
};

#ifndef __CUDACC__
// The trial on the host, block by block: each block's S groups in turn
// (those past B on scenario B - 1's data, writing nothing), each group's G
// lanes stepped through every step in turn.  `sh` holds kShared scalars.
template <typename scalar_t, int NX, int NU>
void seq_trial_host(const scalar_t* ru, const scalar_t* Q, const scalar_t* R,
                    const scalar_t* M, const scalar_t* fx, const scalar_t* fu,
                    const scalar_t* XT, scalar_t* gains, scalar_t* du,
                    scalar_t* dx, scalar_t* pred, bool* ok, int B, int T,
                    scalar_t* sh) {
  using Tr = SeqTrial<scalar_t, NX, NU>;
  for (int b0 = 0; b0 < B; b0 += Tr::S) {
    for (int s = 0; s < Tr::S; ++s) {
      const auto sc = Tr::scenario(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred,
                                   ok, b0 + s, B, T, s, sh);
      typename Tr::Lane lanes[Tr::G];
      for (int l = 0; l < Tr::G; ++l) lanes[l].r = l;
      GroupExec<typename Tr::Lane, Tr::G> ex{lanes};
      Tr::schedule(ex, sc, [] {});
    }
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
