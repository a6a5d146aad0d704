// The one-launch parallel Newton trial (par_newton.cu
// par_newton_trial_kernel) as per-lane phases and a scan schedule, for the
// kernel and for a host build that the CPU tests compile with g++.
//
// One scenario is spread over P lanes (threads), P a power of two from 32
// to 256; lane l owns the contiguous chunk [l L, l L + L) of stages, L =
// ceil(T / P), and the first Pa = ceil(T / L) lanes own stages.  The
// schedule (ParTrial::schedule) is a sequence of steps; each step runs
// every lane's part and ends in a barrier over the scenario's lanes:
//
//   1. value_chunk: the chunk's value aggregate (backward walk), into the
//      lane's slot of the scenario's shared buffer;
//   2. the suffix scan of the slots: log2(32) rounds inside each warp of
//      32 lanes (lane l combines its slot with lane l + d's, d = 1, 2, 4,
//      8, 16, within the warp), then, for P > 32, one level over the
//      warps' totals (published to W = P / 32 warp slots and scanned by
//      lanes 0..W-1 in log2(W) rounds);
//   3. the carry: the combination of every aggregate beyond the lane (its
//      in-warp neighbour's inclusive suffix, combined with the warps
//      beyond its own);
//   4. value_walk (the chunk again from the carry: the terminal fold, the
//      gains, dV and pivots) and affine_chunk (the chunk's closed-loop
//      aggregate, forward);
//   5. the prefix scan of the closed-loop aggregates, as in 2 in the other
//      direction, and its carry;
//   6. forward_walk (du, dx from the carried-in state), then a tree sum of
//      dV and of the pivot flags over the lanes.
//
// Shared memory holds one slot per lane and one per warp.  Each slot is an
// element at an odd stride (E | 1 scalars), so the 32 lanes of a warp that
// read slot[l] or slot[l +- d] touch 32 distinct banks in float32 (16
// lanes per wavefront, each on two banks, in float64): no bank conflict.
// A round reads its two operands from shared memory and writes its result
// to the lane's registers (`out`), which a second step stores into the
// slot after the barrier, so one buffer serves every round.
//
// The arithmetic of a stage (stage_element, stage_gains, closed_loop) and
// of a combine (scan.cuh ValueOp, AffineOp) is that of the TPU kernel
// (ipoc_tpu/ops/pallas/newton_kernel.py _fused_kernel); only the
// association of the two scans follows the lanes.  Host and device
// (IPOC_HD); the device executor (par_newton.cu) runs one lane per thread
// and syncs the scenario's lanes between steps, the host executor
// (HostExec) runs every lane of the step in turn.

#pragma once

#include "riccati.cuh"
#include "scan.cuh"  // AffineOp, ValueOp, load_row

namespace ipoc {

constexpr int kTrialWarp = 32;    // lanes of a warp: the inner scan's width
constexpr int kTrialBlock = 128;  // threads per block where P < 128

// One stage's Newton data, read from the (B, T, rows) inputs.
template <typename scalar_t, int NX, int NU>
struct StageData {
  alignas(16) scalar_t ru[NU];
  alignas(16) scalar_t Q[NX * NX];
  alignas(16) scalar_t R[NU * NU];
  alignas(16) scalar_t M[NX * NU];
  alignas(16) scalar_t fx[NX * NX];
  alignas(16) scalar_t fu[NX * NU];
};

template <typename scalar_t, int NX, int NU>
IPOC_HD void load_stage(const scalar_t* ru, const scalar_t* Q,
                        const scalar_t* R, const scalar_t* M,
                        const scalar_t* fx, const scalar_t* fu, size_t s,
                        StageData<scalar_t, NX, NU>& st) {
  load_row<scalar_t, NU>(ru, s, st.ru);
  load_row<scalar_t, NX * NX>(Q, s, st.Q);
  load_row<scalar_t, NU * NU>(R, s, st.R);
  load_row<scalar_t, NX * NU>(M, s, st.M);
  load_row<scalar_t, NX * NX>(fx, s, st.fx);
  load_row<scalar_t, NX * NU>(fu, s, st.fu);
}

// The reference trick and the stage's value element (newton_kernel.py
// steps 1-2; H = Z = I, c = 0): s = -(R - M'Q^-1 M)^-1 ru, r = -Q^-1 M s,
// then A = fx - fu R^-1 M', b = fu (s + R^-1 M' r), C = fu R^-1 fu',
// eta = Xtil r, J = Xtil = Q - M R^-1 M'.  Also the minimum pivot of R.
template <typename scalar_t, int NX, int NU>
IPOC_HD void stage_element(const StageData<scalar_t, NX, NU>& st,
                           scalar_t* e, scalar_t* sv, scalar_t* rv,
                           scalar_t& piv_u) {
  using Op = ValueOp<scalar_t, NX>;
  // Q^-1 M (the Q and Schur pivots are not part of ok).
  scalar_t a[NX * NX], QinvM[NX * NU];
  copy_elem<scalar_t, NX * NX>(st.Q, a);
  copy_elem<scalar_t, NX * NU>(st.M, QinvM);
  solve_track<scalar_t, NX, NU>(a, QinvM);
  scalar_t schur[NU * NU], sn[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.M[i] * QinvM[j];  // (M')[i][0] * QinvM[0][j]
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.M[l * NU + i] * QinvM[l * NU + j];
      schur[i * NU + j] = st.R[i * NU + j] - acc;
    }
    sn[i] = st.ru[i];
  }
  solve_track<scalar_t, NU, 1>(schur, sn);
#pragma unroll
  for (int i = 0; i < NU; ++i) sv[i] = -sn[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    scalar_t acc = QinvM[i * NU] * sv[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc = acc + QinvM[i * NU + j] * sv[j];
    rv[i] = -acc;
  }
  // R^-1, its minimum pivot, and R^-1 M' (NU x NX).
  scalar_t aR[NU * NU], Uinv[NU * NU];
#pragma unroll
  for (int r = 0; r < NU * NU; ++r) {
    aR[r] = st.R[r];
    Uinv[r] = (r / NU == r % NU) ? scalar_t(1) : scalar_t(0);
  }
  piv_u = solve_track<scalar_t, NU, NU>(aR, Uinv);
  scalar_t UMt[NU * NX];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = Uinv[i * NU] * st.M[j * NU];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + Uinv[i * NU + l] * st.M[j * NU + l];
      UMt[i * NX + j] = acc;
    }
  }
  // A = fx - fu UMt;  J = Xtil = Q - M UMt;  C = (fu Uinv) fu'.
  scalar_t fuU[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t a1 = st.fu[i * NU] * UMt[j];
      scalar_t a2 = st.M[i * NU] * UMt[j];
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        a1 = a1 + st.fu[i * NU + l] * UMt[l * NX + j];
        a2 = a2 + st.M[i * NU + l] * UMt[l * NX + j];
      }
      e[Op::kA + i * NX + j] = st.fx[i * NX + j] - a1;
      e[Op::kJ + i * NX + j] = st.Q[i * NX + j] - a2;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.fu[i * NU] * Uinv[j];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + st.fu[i * NU + l] * Uinv[l * NU + j];
      fuU[i * NU + j] = acc;
    }
  }
  // w = s + UMt r;  b = fu w;  eta = Xtil r.
  scalar_t w[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    scalar_t acc = UMt[i * NX] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) acc = acc + UMt[i * NX + l] * rv[l];
    w[i] = sv[i] + acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    scalar_t acc = st.fu[i * NU] * w[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + st.fu[i * NU + l] * w[l];
    e[Op::kB + i] = acc;
    scalar_t a2 = e[Op::kJ + i * NX] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) a2 = a2 + e[Op::kJ + i * NX + l] * rv[l];
    e[Op::kEta + i] = a2;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t a3 = fuU[i * NU] * st.fu[j * NU];
#pragma unroll
      for (int l = 1; l < NU; ++l) a3 = a3 + fuU[i * NU + l] * st.fu[j * NU + l];
      e[Op::kC + i * NX + j] = a3;
    }
  }
}

// The stage gains from the next stage's value (S', v') (newton_kernel.py
// step 5): Quu = R + fu' S' fu, Qxu = M + fx' S' fu, qu = -R s - M' r -
// fu' v'; one elimination of Quu [d | K] = [-qu | Qxu'] with the RHS
// interleaved row-major (NU, 1+NX); dV = d'qu + 1/2 d'Quu d.  Returns
// Quu's minimum pivot.
template <typename scalar_t, int NX, int NU>
IPOC_HD scalar_t stage_gains(const StageData<scalar_t, NX, NU>& st,
                             const scalar_t* sv, const scalar_t* rv,
                             const scalar_t* Sn, const scalar_t* vn,
                             scalar_t* KD, scalar_t& dV) {
  constexpr int MC = 1 + NX;
  scalar_t Sfu[NX * NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = Sn[i * NX] * st.fu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + Sn[i * NX + l] * st.fu[l * NU + j];
      Sfu[i * NU + j] = acc;
    }
  }
  scalar_t Quu[NU * NU], a[NU * NU], qu[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      scalar_t acc = st.fu[i] * Sfu[j];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.fu[l * NU + i] * Sfu[l * NU + j];
      Quu[i * NU + j] = st.R[i * NU + j] + acc;
      a[i * NU + j] = Quu[i * NU + j];
    }
    scalar_t rs = st.R[i * NU] * sv[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) rs = rs + st.R[i * NU + l] * sv[l];
    scalar_t mr = st.M[i] * rv[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) mr = mr + st.M[l * NU + i] * rv[l];
    scalar_t fv = st.fu[i] * vn[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) fv = fv + st.fu[l * NU + i] * vn[l];
    qu[i] = -rs - mr - fv;
    KD[i * MC] = -qu[i];
  }
  // Qxu = M + fx' Sfu, written transposed into the RHS.
#pragma unroll
  for (int j = 0; j < NX; ++j) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      scalar_t acc = st.fx[j] * Sfu[i];
#pragma unroll
      for (int l = 1; l < NX; ++l) acc = acc + st.fx[l * NX + j] * Sfu[l * NU + i];
      KD[i * MC + 1 + j] = st.M[j * NU + i] + acc;
    }
  }
  const scalar_t piv = solve_track<scalar_t, NU, MC>(a, KD);
  scalar_t dq = KD[0] * qu[0], dQd = scalar_t(0);
#pragma unroll
  for (int i = 1; i < NU; ++i) dq = dq + KD[i * MC] * qu[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    scalar_t acc = Quu[i * NU] * KD[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + Quu[i * NU + l] * KD[l * MC];
    dQd = (i == 0) ? KD[0] * acc : dQd + KD[i * MC] * acc;
  }
  dV = dq + scalar_t(0.5) * dQd;
  return piv;
}

// The closed-loop affine element of one stage (newton_kernel.py step 6):
// F = fx - fu K, e = fu d.
template <typename scalar_t, int NX, int NU>
IPOC_HD void closed_loop(const scalar_t* fx, const scalar_t* fu,
                         const scalar_t* KD, scalar_t* e) {
  constexpr int MC = 1 + NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      scalar_t acc = fu[i * NU] * KD[1 + j];
#pragma unroll
      for (int l = 1; l < NU; ++l) acc = acc + fu[i * NU + l] * KD[l * MC + 1 + j];
      e[i * NX + j] = fx[i * NX + j] - acc;
    }
    scalar_t acc = fu[i * NU] * KD[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) acc = acc + fu[i * NU + l] * KD[l * MC];
    e[NX * NX + i] = acc;
  }
}

template <typename scalar_t, int NX, int NU, int P>
struct ParTrial {
  static_assert(P >= kTrialWarp && (P & (P - 1)) == 0, "P: a power of two >= 32");
  using VOp = ValueOp<scalar_t, NX>;
  using AOp = AffineOp<scalar_t, NX>;
  static constexpr int VE = VOp::E, AE = AOp::E, MC = 1 + NX, NG = NU * MC;
  static constexpr int W = P / kTrialWarp;  // warps per scenario
  // Slot strides: odd, so a warp's slots fall on distinct banks.
  static constexpr int VS = VE | 1, AS = AE | 1;
  // Scenarios per block, threads per block, shared scalars per scenario
  // (P lane slots and, for W > 1, W warp slots; the tree sum at the end
  // reuses the lane slots).
  static constexpr int kScenarios = P < kTrialBlock ? kTrialBlock / P : 1;
  static constexpr int kBlock = P * kScenarios;
  static constexpr int kShared = (P + (W > 1 ? W : 0)) * VS;

  // One scenario's inputs and outputs (pointers at its first row).
  struct Scenario {
    const scalar_t *ru, *Q, *R, *M, *fx, *fu, *XT;
    scalar_t *gains, *du, *dx, *pred;
    bool* ok;
    int T;
  };

  // One lane's state between steps (registers on the card).
  struct Lane {
    int lane, t0, t1, Pa, Wa;
    bool did, have, fhave, bad;
    scalar_t out[VE];  // a round's result, stored after the barrier
    scalar_t run[VE];  // the value carry, then the running suffix
    scalar_t fc[AE];   // the closed-loop carry
    scalar_t dv;
  };

  IPOC_HD static Scenario scenario(const scalar_t* ru, const scalar_t* Q,
                                   const scalar_t* R, const scalar_t* M,
                                   const scalar_t* fx, const scalar_t* fu,
                                   const scalar_t* XT, scalar_t* gains,
                                   scalar_t* du, scalar_t* dx, scalar_t* pred,
                                   bool* ok, int b, int T) {
    const size_t s = static_cast<size_t>(b) * T;
    return Scenario{ru + s * NU, Q + s * NX * NX, R + s * NU * NU,
                    M + s * NX * NU, fx + s * NX * NX, fu + s * NX * NU,
                    XT + static_cast<size_t>(b) * NX * NX, gains + s * NG,
                    du + s * NU, dx + (s + b) * NX, pred + b, ok + b, T};
  }

  // The lane's chunk [t0, t1) of L = ceil(T / P) stages (empty beyond the
  // horizon); Pa lanes and Wa warps own stages.
  IPOC_HD static void init(Lane& L, int lane, int T) {
    const int len = (T + P - 1) / P;
    L.lane = lane;
    L.t0 = lane * len < T ? lane * len : T;
    L.t1 = L.t0 + len < T ? L.t0 + len : T;
    L.Pa = len > 0 ? (T + len - 1) / len : 0;
    L.Wa = (L.Pa + kTrialWarp - 1) / kTrialWarp;
    L.dv = scalar_t(0);
    L.bad = false;
  }

  template <class Op>
  IPOC_HD static constexpr int stride() {
    return Op::E == VE ? VS : AS;
  }

  // Step 1: the chunk's value aggregate (backward walk) into its slot.
  IPOC_HD static void value_chunk(const Scenario& s, Lane& L, scalar_t* sh) {
    if (L.t1 <= L.t0) return;
    scalar_t agg[VE];
    for (int t = L.t1 - 1; t >= L.t0; --t) {
      StageData<scalar_t, NX, NU> st;
      load_stage(s.ru, s.Q, s.R, s.M, s.fx, s.fu, t, st);
      scalar_t e[VE], sv[NU], rv[NX], pu;
      stage_element(st, e, sv, rv, pu);
      if (t == L.t1 - 1) {
        copy_elem<scalar_t, VE>(e, agg);
      } else {
        scalar_t nxt[VE];
        VOp::combine(e, agg, nxt);
        copy_elem<scalar_t, VE>(nxt, agg);
      }
    }
    copy_elem<scalar_t, VE>(agg, sh + L.lane * VS);
  }

  // A round inside the warp: the lane's slot with lane l + d's (suffix,
  // earlier first) or l - d's (prefix, later first), both in its warp.
  template <class Op, bool REVERSE>
  IPOC_HD static void lane_round(Lane& L, const scalar_t* sh, int d) {
    constexpr int S = stride<Op>();
    const int l = L.lane, k = l % kTrialWarp;
    const int j = REVERSE ? l + d : l - d;
    L.did = l < L.Pa && (REVERSE ? (k + d < kTrialWarp && j < L.Pa) : k >= d);
    if (L.did) Op::combine(sh + l * S, sh + j * S, L.out);
  }

  template <class Op>
  IPOC_HD static void lane_store(Lane& L, scalar_t* sh) {
    if (L.did) copy_elem<scalar_t, Op::E>(L.out, sh + L.lane * stride<Op>());
  }

  // The warp's total into its warp slot: the inclusive suffix at its first
  // lane, the inclusive prefix at its last lane that owns stages.
  template <class Op, bool REVERSE>
  IPOC_HD static void publish(Lane& L, scalar_t* sh) {
    constexpr int S = stride<Op>();
    const int l = L.lane, k = l % kTrialWarp;
    const bool total = l < L.Pa && (REVERSE ? k == 0
                                            : (k == kTrialWarp - 1 || l == L.Pa - 1));
    if (total) copy_elem<scalar_t, Op::E>(sh + l * S, sh + (P + l / kTrialWarp) * S);
  }

  // A round over the warp slots, run by lanes 0..Wa-1 (lane w for warp w).
  template <class Op, bool REVERSE>
  IPOC_HD static void warp_round(Lane& L, const scalar_t* sh, int d) {
    constexpr int S = stride<Op>();
    const int w = L.lane;
    L.did = w < L.Wa && (REVERSE ? w + d < L.Wa : w >= d);
    if (L.did) Op::combine(sh + (P + w) * S, sh + (P + (REVERSE ? w + d : w - d)) * S, L.out);
  }

  template <class Op>
  IPOC_HD static void warp_store(Lane& L, scalar_t* sh) {
    if (L.did) copy_elem<scalar_t, Op::E>(L.out, sh + (P + L.lane) * stride<Op>());
  }

  // The combination of every aggregate beyond the lane (REVERSE: of the
  // lanes after it, earlier first; else of the lanes before it, later
  // first) into `c`; false where there is none.
  template <class Op, bool REVERSE>
  IPOC_HD static bool carry(const Lane& L, const scalar_t* sh, scalar_t* c) {
    constexpr int S = stride<Op>();
    const int l = L.lane, k = l % kTrialWarp, w = l / kTrialWarp;
    const int j = REVERSE ? l + 1 : l - 1;  // the neighbour
    if (l >= L.Pa || j < 0 || j >= L.Pa) return false;
    const scalar_t* warps = sh + P * S;
    if constexpr (W > 1) {
      const bool edge = REVERSE ? k == kTrialWarp - 1 : k == 0;
      const int v = REVERSE ? w + 1 : w - 1;  // the next warp's slot
      if (edge) {
        copy_elem<scalar_t, Op::E>(warps + v * S, c);
        return true;
      }
      if (REVERSE ? v < L.Wa : v >= 0) {
        Op::combine(sh + j * S, warps + v * S, c);
        return true;
      }
    }
    copy_elem<scalar_t, Op::E>(sh + j * S, c);
    return true;
  }

  // Step 4a: the chunk again from the carried-in suffix.  Before stage t,
  // `run` is the suffix from t+1; its fold with the terminal element
  // (0, 0, 0, 0, XT) is the next stage's value (S', v'), and stage T-1 sees
  // (XT, 0).  Gains go to the scratch.
  IPOC_HD static void value_walk(const Scenario& s, Lane& L) {
    for (int t = L.t1 - 1; t >= L.t0; --t) {
      StageData<scalar_t, NX, NU> st;
      load_stage(s.ru, s.Q, s.R, s.M, s.fx, s.fu, t, st);
      scalar_t e[VE], sv[NU], rv[NX], pu;
      stage_element(st, e, sv, rv, pu);
      scalar_t Sn[NX * NX], vn[NX];
      if (t == s.T - 1) {
#pragma unroll
        for (int r = 0; r < NX * NX; ++r) Sn[r] = s.XT[r];
#pragma unroll
        for (int r = 0; r < NX; ++r) vn[r] = scalar_t(0);
      } else {
        VOp::eta_J(L.run, s.XT, nullptr, vn, Sn);
      }
      scalar_t KD[NG], dV;
      const scalar_t pq = stage_gains(st, sv, rv, Sn, vn, KD, dV);
      const scalar_t piv = nan_min(pu, pq);
      L.bad = L.bad || !(ipoc_isfinite(piv) && piv > scalar_t(0));
      L.dv = L.dv + dV;
#pragma unroll
      for (int r = 0; r < NG; ++r) s.gains[static_cast<size_t>(t) * NG + r] = KD[r];
      if (L.have) {
        scalar_t nxt[VE];
        VOp::combine(e, L.run, nxt);
        copy_elem<scalar_t, VE>(nxt, L.run);
      } else {
        copy_elem<scalar_t, VE>(e, L.run);
        L.have = true;
      }
    }
  }

  // Step 4b: the chunk's closed-loop aggregate (forward walk) into its
  // slot (the value scan's slots are free: the carries were read a step
  // earlier).
  IPOC_HD static void affine_chunk(const Scenario& s, const Lane& L, scalar_t* sh) {
    if (L.t1 <= L.t0) return;
    scalar_t fagg[AE];
    for (int t = L.t0; t < L.t1; ++t) {
      scalar_t e[AE];
      StageData<scalar_t, NX, NU> st;
      load_row<scalar_t, NX * NX>(s.fx, t, st.fx);
      load_row<scalar_t, NX * NU>(s.fu, t, st.fu);
      closed_loop<scalar_t, NX, NU>(st.fx, st.fu,
                                    s.gains + static_cast<size_t>(t) * NG, e);
      if (t == L.t0) {
        copy_elem<scalar_t, AE>(e, fagg);
      } else {
        scalar_t nxt[AE];
        AOp::combine(e, fagg, nxt);
        copy_elem<scalar_t, AE>(nxt, fagg);
      }
    }
    copy_elem<scalar_t, AE>(fagg, sh + L.lane * AS);
  }

  // Step 6a: from zero deviation, the state at the chunk's start is the
  // constant part of the carried-in prefix; du = d - K dx, dx' = F dx + e.
  IPOC_HD static void forward_walk(const Scenario& s, const Lane& L) {
    scalar_t x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = L.fhave ? L.fc[NX * NX + i] : scalar_t(0);
    for (int t = L.t0; t < L.t1; ++t) {
      const scalar_t* KD = s.gains + static_cast<size_t>(t) * NG;
      scalar_t e[AE];
      StageData<scalar_t, NX, NU> st;
      load_row<scalar_t, NX * NX>(s.fx, t, st.fx);
      load_row<scalar_t, NX * NU>(s.fu, t, st.fu);
      closed_loop<scalar_t, NX, NU>(st.fx, st.fu, KD, e);
#pragma unroll
      for (int i = 0; i < NX; ++i) s.dx[static_cast<size_t>(t) * NX + i] = x[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        scalar_t acc = KD[i * MC + 1] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc = acc + KD[i * MC + 1 + j] * x[j];
        s.du[static_cast<size_t>(t) * NU + i] = KD[i * MC] - acc;
      }
      scalar_t xn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        scalar_t acc = e[i * NX] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc = acc + e[i * NX + j] * x[j];
        xn[i] = acc + e[NX * NX + i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    if (L.t1 > L.t0 && L.t1 == s.T) {
#pragma unroll
      for (int i = 0; i < NX; ++i) s.dx[static_cast<size_t>(s.T) * NX + i] = x[i];
    }
  }

  // Step 6b: pred = sum dV, ok = every pivot finite and > 0 and pred
  // finite, by a tree over the lanes (slot scalars [0, P) and [P, 2P)).
  IPOC_HD static void reduce_start(const Lane& L, scalar_t* sh) {
    sh[L.lane] = L.dv;
    sh[P + L.lane] = L.bad ? scalar_t(1) : scalar_t(0);
  }

  IPOC_HD static void reduce_round(const Lane& L, scalar_t* sh, int w) {
    const int l = L.lane;
    if (l < w) {
      sh[l] = sh[l] + sh[l + w];
      sh[P + l] = sh[P + l] + sh[P + l + w];
    }
  }

  IPOC_HD static void finish(const Scenario& s, const Lane& L, const scalar_t* sh) {
    if (L.lane != 0) return;
    const scalar_t p = sh[0];
    *s.pred = p;
    *s.ok = sh[P] == scalar_t(0) && ipoc_isfinite(p);
  }

  // One scan (2 in the account at the top) and its carry into `c`.
  template <class Op, bool REVERSE, class Exec>
  IPOC_HD static void scan(Exec& ex, scalar_t* sh) {
    for (int d = 1; d < kTrialWarp; d <<= 1) {
      ex([&](Lane& L) { lane_round<Op, REVERSE>(L, sh, d); });
      ex([&](Lane& L) { lane_store<Op>(L, sh); });
    }
    if constexpr (W > 1) {
      ex([&](Lane& L) { publish<Op, REVERSE>(L, sh); });
      for (int d = 1; d < W; d <<= 1) {
        ex([&](Lane& L) { warp_round<Op, REVERSE>(L, sh, d); });
        ex([&](Lane& L) { warp_store<Op>(L, sh); });
      }
    }
  }

  // The whole trial of one scenario.  `ex(f)` runs f(lane) for every lane
  // of the scenario, then a barrier over them.
  template <class Exec>
  IPOC_HD static void schedule(Exec& ex, const Scenario& s, scalar_t* sh) {
    ex([&](Lane& L) { value_chunk(s, L, sh); });
    scan<VOp, true>(ex, sh);
    ex([&](Lane& L) { L.have = carry<VOp, true>(L, sh, L.run); });
    ex([&](Lane& L) {
      value_walk(s, L);
      affine_chunk(s, L, sh);
    });
    scan<AOp, false>(ex, sh);
    ex([&](Lane& L) { L.fhave = carry<AOp, false>(L, sh, L.fc); });
    ex([&](Lane& L) {
      forward_walk(s, L);
      reduce_start(L, sh);
    });
    for (int w = P / 2; w > 0; w >>= 1)
      ex([&](Lane& L) { reduce_round(L, sh, w); });
    ex([&](Lane& L) { finish(s, L, sh); });
  }
};

#ifndef __CUDACC__
// The host executor: every lane of the step in turn (the barrier is the
// end of the loop).
template <class Lane, int P>
struct HostExec {
  Lane* lanes;
  template <class F>
  void operator()(F&& f) {
    for (int l = 0; l < P; ++l) f(lanes[l]);
  }
};

// The trial on the host, scenario by scenario: `lanes` holds P Lane
// states and `sh` ParTrial::kShared scalars.
template <typename scalar_t, int NX, int NU, int P>
void par_trial_host(const scalar_t* ru, const scalar_t* Q, const scalar_t* R,
                    const scalar_t* M, const scalar_t* fx, const scalar_t* fu,
                    const scalar_t* XT, scalar_t* gains, scalar_t* du,
                    scalar_t* dx, scalar_t* pred, bool* ok, int B, int T,
                    typename ParTrial<scalar_t, NX, NU, P>::Lane* lanes,
                    scalar_t* sh) {
  using Tr = ParTrial<scalar_t, NX, NU, P>;
  for (int b = 0; b < B; ++b) {
    const auto s = Tr::scenario(ru, Q, R, M, fx, fu, XT, gains, du, dx, pred, ok, b, T);
    for (int l = 0; l < P; ++l) Tr::init(lanes[l], l, T);
    HostExec<typename Tr::Lane, P> ex{lanes};
    Tr::schedule(ex, s, sh);
  }
}
#endif  // !__CUDACC__

}  // namespace ipoc
