// One packed lane's iterations, for the mega kernel (mega.cuh) and for a
// host build that the CPU tests compile with g++: the trial's two sweeps,
// the accept and Levenberg-Marquardt update, the convergence tests, the
// stage transition with the central-path predictor, the ping-pong iterate
// and its copy-back.  Per-lane semantics are packed_lane_iter's
// (solvers/packed_stream.py); the stage programs are the generated Model's
// and the Riccati step is riccati.cuh's.
//
// Data movement:
//   * Stage reads go through a memory policy, `Mem`, whose `Reader` hands
//     out the rows of one stage after another in sweep order: on the card
//     the cp.async ring of mega.cuh (RingStages), which fetches stages
//     ahead of the lane's serial chain; on the host plain loads
//     (PlainStages).  Stores are plain: nothing on the chain waits on them.
//   * The iterate ping-pongs between two buffers, the lane's fields (xs, u)
//     and the workspace (tx, tu); `odd` says which holds it.  The trial
//     reads the iterate and writes its trial point into the other buffer,
//     so an accept flips `odd` and copies nothing (the counterpart of the
//     TPU kernel's lazy accept merge).  At a rollover candidate a re-rolls
//     into the iterate's states and candidate b (the prediction) writes
//     its states and controls into the other buffer; taking b flips `odd`.
//     A lane that ends a launch odd copies (tx, tu) back into (xs, u) once,
//     so the lane's fields hold the iterate between launches.
//
// Layout: batch-last, stage arrays (T, rows, B), per-lane scalars (B,).

#pragma once

#include <math.h>

#include "riccati.cuh"
#include "scalar_math.h"

namespace ipoc {

template <typename scalar_t, int N>
IPOC_HD void load_col(scalar_t* dst, const scalar_t* src, int B, int b) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[(size_t)i * B + b];
}

template <typename scalar_t, int N>
IPOC_HD void store_col(scalar_t* dst, const scalar_t* src, int B, int b) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[(size_t)i * B + b] = src[i];
}

// Plain loads of one stage's rows, from up to three (T, N, B) arrays.
struct PlainStages {
  template <typename scalar_t, int N0, int N1, int N2>
  struct Reader {
    const scalar_t *s0, *s1, *s2;
    int B, b;
    IPOC_HD Reader(const PlainStages&, const scalar_t* a0, const scalar_t* a1,
                   const scalar_t* a2, int B_, int b_, int, bool)
        : s0(a0), s1(a1), s2(a2), B(B_), b(b_) {}
    IPOC_HD void get(int t, scalar_t* r0, scalar_t* r1, scalar_t* r2) const {
      load_col<scalar_t, N0>(r0, s0 + (size_t)t * N0 * B, B, b);
      if constexpr (N1 > 0) load_col<scalar_t, N1>(r1, s1 + (size_t)t * N1 * B, B, b);
      if constexpr (N2 > 0) load_col<scalar_t, N2>(r2, s2 + (size_t)t * N2 * B, B, b);
    }
  };
};

// The SolverConfig scalars the lane iteration reads, passed at launch (never
// baked into the generated source, which is cached per model).  Doubles,
// cast to scalar_t where used, as torch casts a Python float against a
// float32 tensor.
struct LaneScalars {
  double tol, stage_tol_scale, pred_floor, reg_min, reg_max, bp_decay, bp_min,
      reg_scale_floor, stage_reg, reg_inc_init;
  int max_newton_iters, stall_exit, stage_predictor, scale_reg_by_grad;
};
constexpr int kLaneScalars = 14;  // doubles in the C entry's array

// `cfg`: kLaneScalars doubles in LaneScalars order (the four ints last).
inline LaneScalars lane_scalars(const double* cfg) {
  LaneScalars c;
  c.tol = cfg[0];
  c.stage_tol_scale = cfg[1];
  c.pred_floor = cfg[2];
  c.reg_min = cfg[3];
  c.reg_max = cfg[4];
  c.bp_decay = cfg[5];
  c.bp_min = cfg[6];
  c.reg_scale_floor = cfg[7];
  c.stage_reg = cfg[8];
  c.reg_inc_init = cfg[9];
  c.max_newton_iters = static_cast<int>(cfg[10]);
  c.stall_exit = static_cast<int>(cfg[11]);
  c.stage_predictor = static_cast<int>(cfg[12]);
  c.scale_reg_by_grad = static_cast<int>(cfg[13]);
  return c;
}

// The arrays of the lanes and of their workspace.
template <typename scalar_t>
struct MegaArrays {
  scalar_t *xs, *xT, *us, *ups, *cun;  // (T, NX, B), (NX, B), u, u_prev, (B,)
  int *it, *sit;                        // (B,)
  scalar_t *rp, *ri, *bp;               // (B,)
  unsigned char* done;                  // (B,) bool
  const scalar_t *x0, *bp0;             // (NX, B), (B,)
  const unsigned char* active;          // (B,) bool
  int* steps;                           // (1,) zeroed by the caller
  scalar_t *tx, *tu, *Kk;               // workspace (T, NX|NU|NG, B)
  int B, T;
};

// lane: xs, xT, u, u_prev, cun, it, stage_it, rp, r_inc, bp, done, x0, bp0,
// active, steps; ws: tx, tu, Kk.
template <typename scalar_t>
inline MegaArrays<scalar_t> mega_arrays(void* const* lane, void* const* ws,
                                        int B, int T) {
  auto f = [lane](int i) { return static_cast<scalar_t*>(lane[i]); };
  auto w = [ws](int i) { return static_cast<scalar_t*>(ws[i]); };
  auto i32 = [lane](int i) { return static_cast<int*>(lane[i]); };
  auto u8 = [lane](int i) { return static_cast<unsigned char*>(lane[i]); };
  return MegaArrays<scalar_t>{f(0), f(1), f(2), f(3), f(4), i32(5), i32(6),
                              f(7), f(8), f(9), u8(10), f(11), f(12), u8(13),
                              i32(14), w(0), w(1), w(2), B, T};
}

// Backward sweep of one trial for lane b: the gains [k | K] to Kk, the
// iterate's barrier cost, the predicted reduction dv, the minimum pivot and
// max_t |ru_t| (the Hamiltonian's control gradient; DDP: Qu).
template <typename Model, typename scalar_t, bool DDP, typename Mem>
IPOC_HD void trial_backward(const Mem& mem, const scalar_t* xs,
                            const scalar_t* us, const scalar_t* xT,
                            scalar_t bpv, scalar_t regv, scalar_t* Kk, int B,
                            int T, int b, scalar_t& cost, scalar_t& dv,
                            scalar_t& piv, scalar_t& hu) {
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  typename Mem::template Reader<scalar_t, NX, NU, 0> rd(mem, xs, us, nullptr,
                                                         B, b, T, false);
  scalar_t lam[NX], Vxx[NX * NX], Vx[NX];
  Model::template term<scalar_t>(xT, lam, Vxx, &cost);
  // Newton splits the value gradient between the costates and the
  // deviation recursion (Vx_T = 0); DDP carries the whole Vx.
#pragma unroll
  for (int i = 0; i < NX; ++i) Vx[i] = DDP ? lam[i] : scalar_t(0);
  dv = scalar_t(0);
  piv = scalar_t(INFINITY);
  hu = scalar_t(0);
  for (int t = T - 1; t >= 0; --t) {
    scalar_t x[NX], u[NU];
    rd.get(t, x, u, nullptr);
    scalar_t ru[NU], Q[NX * NX], R[NU * NU], M[NX * NU], fx[NX * NX],
        fu[NX * NU], lam_new[NX], cst;
    Model::template stage_bwd<scalar_t>(x, u, &bpv, DDP ? Vx : lam, ru, Q, R,
                                        M, fx, fu, lam_new, &cst);
#pragma unroll
    for (int i = 0; i < NU; ++i) R[i * (NU + 1)] = R[i * (NU + 1)] + regv;
    scalar_t k[NU], K[NU * NX];
    riccati_step<scalar_t, NX, NU, DDP>(ru, Q, R, M, fx, fu, Vxx, Vx, k, K,
                                        dv, piv, lam_new);
    scalar_t* g = Kk + (size_t)t * NG * B;
    store_col<scalar_t, NU>(g, k, B, b);
    store_col<scalar_t, NU * NX>(g + (size_t)NU * B, K, B, b);
    cost = cost + cst;
    scalar_t ru_max = ipoc_abs(ru[0]);
#pragma unroll
    for (int i = 1; i < NU; ++i) ru_max = ipoc_max(ru_max, ipoc_abs(ru[i]));
    hu = ipoc_max(hu, ru_max);
    if constexpr (!DDP) {
#pragma unroll
      for (int i = 0; i < NX; ++i) lam[i] = lam_new[i];
    }
  }
}

// Forward sweep of one trial for lane b: the trial point to (tu_o, tx_o,
// txT), its barrier cost nc, maximum constraint value mc and sum ||cu||^2.
// Newton carries the deviation dx from 0; DDP carries the trial state
// itself from x0 (the nonlinear closed-loop re-rollout).
template <typename Model, typename scalar_t, bool DDP, typename Mem>
IPOC_HD void trial_forward(const Mem& mem, const scalar_t* xs,
                           const scalar_t* us, const scalar_t* xT,
                           const scalar_t* x0, scalar_t bpv,
                           const scalar_t* Kk, scalar_t* tu_o, scalar_t* tx_o,
                           int B, int T, int b, scalar_t* txT, scalar_t& nc,
                           scalar_t& mc, scalar_t& cun) {
  constexpr int NX = Model::NX, NU = Model::NU, NG = (1 + NX) * NU;
  typename Mem::template Reader<scalar_t, NX, NU, NG> rd(mem, xs, us, Kk, B,
                                                          b, T, true);
  scalar_t d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = DDP ? x0[i] : scalar_t(0);
  nc = scalar_t(0);
  mc = -scalar_t(INFINITY);
  cun = scalar_t(0);
  for (int t = 0; t < T; ++t) {
    scalar_t x[NX], u[NU], g[NG];
    rd.get(t, x, u, g);
    scalar_t tu[NU], tx[NX], dn[NX], cst, cmax, cusq;
    if constexpr (DDP) {
      Model::template stage_ddp_fwd<scalar_t>(x, u, &bpv, d, g, tu, tx, dn,
                                              &cst, &cmax, &cusq);
    } else {
      Model::template stage_fwd<scalar_t>(x, u, &bpv, d, g, tu, tx, dn, &cst,
                                          &cmax, &cusq);
    }
    store_col<scalar_t, NU>(tu_o + (size_t)t * NU * B, tu, B, b);
    store_col<scalar_t, NX>(tx_o + (size_t)t * NX * B, tx, B, b);
    nc = nc + cst;
    mc = ipoc_max(mc, cmax);
    cun = cun + cusq;
#pragma unroll
    for (int i = 0; i < NX; ++i) d[i] = dn[i];
  }
  scalar_t cT;
  if constexpr (DDP) {
    Model::template term_ddp_fwd<scalar_t>(xT, d, txT, &cT);
  } else {
    Model::template term_fwd<scalar_t>(xT, d, txT, &cT);
  }
  nc = nc + cT;
}

// The stage transition of a lane that rolls over to bp_next: u_prev <- u;
// candidate a re-rolls u at bp_next into xs (the iterate's states);
// with PRED, candidate b rolls out the prediction u + gamma (u - u_prev)
// into (xb, ub) (the other buffer).  Returns the final states and the
// barrier costs and sums ||cu||^2 of both, terminal costs included.
template <typename Model, typename scalar_t, bool PRED, typename Mem>
IPOC_HD void stage_transition(const Mem& mem, const scalar_t* x0,
                              const scalar_t* us, scalar_t* ups, scalar_t* xs,
                              scalar_t* xb, scalar_t* ub, scalar_t bp_next,
                              scalar_t gamma, int B, int T, int b,
                              scalar_t* xa, scalar_t* xbs, scalar_t& ca,
                              scalar_t& cb, scalar_t& cua, scalar_t& cub) {
  constexpr int NX = Model::NX, NU = Model::NU;
  typename Mem::template Reader<scalar_t, NU, PRED ? NU : 0, 0> rd(
      mem, us, ups, nullptr, B, b, T, true);
#pragma unroll
  for (int i = 0; i < NX; ++i) xa[i] = xbs[i] = x0[i];
  ca = cb = cua = cub = scalar_t(0);
  for (int t = 0; t < T; ++t) {
    scalar_t u[NU], up[NU], xan[NX], csta, cusqa;
    rd.get(t, u, up, nullptr);
    store_col<scalar_t, NX>(xs + (size_t)t * NX * B, xa, B, b);
    if constexpr (PRED) {
#pragma unroll
      for (int i = 0; i < NU; ++i) up[i] = u[i] + gamma * (u[i] - up[i]);
      store_col<scalar_t, NU>(ub + (size_t)t * NU * B, up, B, b);
      store_col<scalar_t, NX>(xb + (size_t)t * NX * B, xbs, B, b);
      scalar_t xbn[NX], cstb, cusqb;
      Model::template transition<scalar_t>(xa, xbs, u, up, &bp_next, xan, xbn,
                                           &csta, &cstb, &cusqa, &cusqb);
      cb = cb + cstb;
      cub = cub + cusqb;
#pragma unroll
      for (int i = 0; i < NX; ++i) xbs[i] = xbn[i];
    } else {
      Model::template roll_cost<scalar_t>(xa, u, &bp_next, xan, &csta,
                                          &cusqa);
    }
    store_col<scalar_t, NU>(ups + (size_t)t * NU * B, u, B, b);
    ca = ca + csta;
    cua = cua + cusqa;
#pragma unroll
    for (int i = 0; i < NX; ++i) xa[i] = xan[i];
  }
  scalar_t cTa;
  Model::template final_cost<scalar_t>(xa, &cTa);
  ca = ca + cTa;
  if constexpr (PRED) {
    scalar_t cTb;
    Model::template final_cost<scalar_t>(xbs, &cTb);
    cb = cb + cTb;
  }
}

// Copy lane b's column of a (T, N, B) array, once per launch; unrolled so
// that the loads of several stages are in flight together.
template <typename scalar_t, int N>
IPOC_HD void copy_back(scalar_t* __restrict__ dst,
                       const scalar_t* __restrict__ src, int B, int T, int b) {
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const size_t at = ((size_t)t * N + i) * B + b;
      dst[at] = src[at];
    }
  }
}

struct LaneRun {
  int steps;  // the iterations the lane ran
  bool odd;   // the launch ended with the iterate in (tx, tu): copied back
};

// Up to k iterations of lane b, until it is done.  An inactive lane, and a
// lane done before the launch, is not touched.
template <typename Model, typename scalar_t, bool DDP, typename Mem>
IPOC_HD LaneRun mega_lane(const MegaArrays<scalar_t>& a, const LaneScalars& c,
                          int k, int b, const Mem& mem) {
  constexpr int NX = Model::NX, NU = Model::NU;
  const int B = a.B, T = a.T;
  if (!a.active[b] || a.done[b]) return LaneRun{0, false};

  scalar_t xTv[NX], x0v[NX];
  load_col<scalar_t, NX>(xTv, a.xT, B, b);
  load_col<scalar_t, NX>(x0v, a.x0, B, b);
  scalar_t cun = a.cun[b], rp = a.rp[b], ri = a.ri[b], bp = a.bp[b];
  const scalar_t bp0v = a.bp0[b];
  int it = a.it[b], sit = a.sit[b];
  bool done = false, odd = false;
  const scalar_t inf = scalar_t(INFINITY);
  const scalar_t gamma = scalar_t(1.0 / c.bp_decay);

  int n = 0;
  for (; n < k && !done; ++n) {
    // --- the trial: reads the iterate, writes the other buffer -------------
    scalar_t* cx = odd ? a.tx : a.xs;
    scalar_t* cu = odd ? a.tu : a.us;
    // DDP scales the Levenberg parameter by ||cu|| unconditionally.
    const scalar_t reg = (DDP || c.scale_reg_by_grad)
                             ? rp * ipoc_max(cun, scalar_t(c.reg_scale_floor))
                             : rp;
    scalar_t cost, dv, piv, hu, nc, mc, cun_t, txT[NX];
    trial_backward<Model, scalar_t, DDP>(mem, cx, cu, xTv, bp, reg, a.Kk, B,
                                         T, b, cost, dv, piv, hu);
    trial_forward<Model, scalar_t, DDP>(mem, cx, cu, xTv, x0v, bp, a.Kk,
                                        odd ? a.us : a.tu, odd ? a.xs : a.tx,
                                        B, T, b, txT, nc, mc, cun_t);

    // --- accept and the Marquardt-Nielsen update --------------------------
    const bool ok = ipoc_isfinite(piv) && piv > scalar_t(0) &&
                    ipoc_isfinite(dv);
    const scalar_t new_cost = mc <= scalar_t(0) ? nc : inf;
    const scalar_t rho = (new_cost - cost) / dv;
    const bool accept = rho > scalar_t(0) && ok;
    const bool stalled =
        !accept && rp >= scalar_t(c.reg_max) && c.stall_exit != 0;
    if (accept) {
      const scalar_t s = scalar_t(2) * rho - scalar_t(1);
      rp = rp * ipoc_max(scalar_t(1) - s * s * s, scalar_t(1.0 / 3.0));
      ri = scalar_t(2);
    } else {
      rp = rp * ri;
      ri = scalar_t(2) * ri;
    }
    rp = ipoc_min(ipoc_max(rp, scalar_t(c.reg_min)), scalar_t(c.reg_max));
    if (accept) {
      odd = !odd;
#pragma unroll
      for (int i = 0; i < NX; ++i) xTv[i] = txT[i];
      cun = ipoc_sqrt(cun_t);
    }

    // --- convergence and stage bookkeeping ---------------------------------
    const scalar_t tol_s = ipoc_max(scalar_t(c.stage_tol_scale) * bp,
                                    scalar_t(c.tol));
    bool conv = hu < tol_s;
    if (c.pred_floor > 0.0) {
      conv = conv || (ok && ipoc_abs(dv) < scalar_t(c.pred_floor) *
                                               (scalar_t(1) + ipoc_abs(cost)));
    }
    const bool bad = !ipoc_isfinite(hu) || !ipoc_isfinite(cost);
    const bool advance =
        (conv || stalled || sit + 1 > c.max_newton_iters) && !bad;
    const scalar_t bp_next = bp / scalar_t(c.bp_decay);
    const bool done_now = bad || (advance && bp_next <= scalar_t(c.bp_min));
    const bool roll = advance && !done_now;

    // --- the stage transition, only for a lane that rolls over -------------
    // b is taken when the lane is past its first stage and b's barrier cost
    // is lower (a NaN loses).
    if (roll) {
      scalar_t xa[NX], xbs[NX], ca, cb, cua, cub;
      scalar_t* xs_c = odd ? a.tx : a.xs;
      scalar_t* us_c = odd ? a.tu : a.us;
      scalar_t* xs_o = odd ? a.xs : a.tx;
      scalar_t* us_o = odd ? a.us : a.tu;
      bool take = false;
      if (c.stage_predictor) {
        stage_transition<Model, scalar_t, true>(
            mem, x0v, us_c, a.ups, xs_c, xs_o, us_o, bp_next, gamma, B, T, b,
            xa, xbs, ca, cb, cua, cub);
        take = bp < bp0v && cb < ca;
      } else {
        stage_transition<Model, scalar_t, false>(
            mem, x0v, us_c, a.ups, xs_c, xs_o, us_o, bp_next, gamma, B, T, b,
            xa, xbs, ca, cb, cua, cub);
      }
      if (take) {
        odd = !odd;
#pragma unroll
        for (int i = 0; i < NX; ++i) xTv[i] = xbs[i];
        cun = ipoc_sqrt(cub);
      } else {
#pragma unroll
        for (int i = 0; i < NX; ++i) xTv[i] = xa[i];
        cun = ipoc_sqrt(cua);
      }
    }
    if (advance) {
      bp = bp_next;
      rp = scalar_t(c.stage_reg);
      ri = scalar_t(c.reg_inc_init);
      sit = 0;
    } else {
      sit = sit + 1;
    }
    it = it + 1;
    done = done_now;
  }

  if (odd) {
    copy_back<scalar_t, NX>(a.xs, a.tx, B, T, b);
    copy_back<scalar_t, NU>(a.us, a.tu, B, T, b);
  }
  store_col<scalar_t, NX>(a.xT, xTv, B, b);
  a.cun[b] = cun;
  a.rp[b] = rp;
  a.ri[b] = ri;
  a.bp[b] = bp;
  a.it[b] = it;
  a.sit[b] = sit;
  a.done[b] = done ? 1 : 0;
  return LaneRun{n, odd};
}

#ifndef __CUDACC__
// The host build (CPU tests): every lane in turn with plain loads; `steps`
// as the kernel's atomicMax leaves it, each lane's parity at the end to
// `odd_out` (may be null).
template <typename Model, typename scalar_t, bool DDP>
inline void mega_host(const MegaArrays<scalar_t>& a, const LaneScalars& c,
                      int k, unsigned char* odd_out) {
  for (int b = 0; b < a.B; ++b) {
    const LaneRun r = mega_lane<Model, scalar_t, DDP>(a, c, k, b,
                                                      PlainStages{});
    if (r.steps > *a.steps) *a.steps = r.steps;
    if (odd_out) odd_out[b] = r.odd ? 1 : 0;
  }
}
#endif

}  // namespace ipoc
