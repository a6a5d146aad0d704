"""The group schedules of the merged one-launch trial (``csrc/merged_trial.h``,
Newton and DDP modes) and of the costate recursion (``csrc/costates.h``),
built with the host C++ compiler and held to their one-thread parents and
to the plain versions on the CPU, with the codegen's cut of the DDP
forward stage and the DDP mode of the cooperative Riccati step
(``csrc/riccati_rows.h``) that they run.

The headers hold the CUDA kernels' per-lane parts and the schedules that
order them; their host executors step each group's lanes (the merged
trial's backward sweep, the costate recursion) or a block's 32 lanes (the
merged trial's forward sweep) through every step in turn, block by block
(those past B included, on scenario B - 1's data, writing nothing), with
the shared memory filled with NaN first.  Here they are compiled with
``g++`` (no FMA contraction on the host's baseline instruction set) and
held

* in float64, cartpole, pendulum, the planar quadrotor (nx=6, nu=2) and
  the unicycle (nx=3, nu=2) at
  dt = 1/40, B in {1, 3, 37} and T in {1, 7, 40}: the merged trial, both modes, against ``lane.h``'s
  one-thread trial (the parent kernel's body) built by the same compiler,
  bit for bit on every output, and against ``fused_newton_iter_plain`` at
  1e-12 of scale; at B = 37 also on inputs that start one scalar past a
  16-byte boundary, to the bit of the aligned ones;
* the costate recursion against the parent kernel's loop built by the same
  compiler, bit for bit, and against ``seq_costates_plain`` at 1e-12 of
  scale, nx in {2, 3, 4, 6}, on offset views too;
* ``RowStep<..., true>`` against ``riccati_step<..., true>`` over a chain of
  stages, bit for bit, in float64 and float32;
* the codegen's ``ddp_forward_parts``: composed, ``stage_ddp_fwd`` to the
  bit (torch evaluators, float64), its evaluation ``stage_fwd_eval``'s
  program;
* the launch rule and the shared memory per block at B in {1, 3, 4096};
* in float32 against JAX's kernels in interpret mode (pendulum, T=6, 128
  lanes): ``fused_newton_iter_packed(..., merged=True, ddp=True,
  with_cu=True)`` at ``tests/test_torch_fused_iter.py``'s tolerance (rtol
  and atol 5e-5), ``seq_costates_batched(..., interpret=True)`` at
  ``tests/test_torch_seq_newton.py``'s (1e-5 of scale).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu.ops.pallas import set_pallas_scans
from ipoc_tpu.ops.pallas.seq_newton_kernel import _pack_s, _unpack_s
from ipoc_tpu.ops.pallas.seq_newton_kernel import (
    seq_costates_batched as j_costates_kernel,
)
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops.codegen.scalarize import ELEMENTARY_CALLS as CALLS
from ipoc_tpu_torch.ops.codegen.scalarize import same_program
from ipoc_tpu_torch.ops.cuda import seq_newton as sn
from ipoc_tpu_torch.ops.cuda.seq_newton import seq_costates_plain

torch.set_num_threads(1)

TOL = 1e-12
DT = 1.0 / 40
# model: (port module, nx, nu, the controls' centre inside the box)
MODELS = {"cartpole": (t_cartpole, 4, 1, 0.0), "pendulum": (t_pendulum, 2, 1, 0.0),
          "quadrotor": (t_quadrotor, 6, 2, t_quadrotor.HOVER),
          "unicycle": (t_unicycle, 3, 2, 0.3)}
NAMES = ("tu", "tx", "txT", "cost", "nc", "mc", "dv", "piv", "hu", "cun")

MERGED_SOURCE = r"""
#include <math.h>
#include <vector>
#include "lane.h"
#include "merged_trial.h"

template <typename scalar_t, bool DDP>
void merged(const void* const* in, void* const* out, int B, int T) {
  using Mt = ipoc::MergedTrial<Model, scalar_t, DDP>;
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  std::vector<scalar_t> sh(Mt::kShared, scalar_t(NAN));
  const typename Mt::Arrays a{I(0), I(1), I(2), I(3), I(4), O(0), O(1), O(2), O(3),
                              O(4), O(5), O(6), O(7), O(8), O(9), O(10), B, T};
  ipoc::merged_trial_host<Model, scalar_t, DDP>(a, sh.data());
}

// The parent kernel's body: lane.h's two sweeps, one scenario at a time.
template <typename scalar_t, bool DDP>
void one_thread(const void* const* in, void* const* out, int B, int T) {
  constexpr int NX = Model::NX;
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  for (int b = 0; b < B; ++b) {
    scalar_t xTv[NX], x0[NX], txT[NX];
    ipoc::load_col<scalar_t, NX>(xTv, I(2), B, b);
    ipoc::load_col<scalar_t, NX>(x0, I(0), B, b);
    scalar_t cost, dv, piv, hu, nc, mc, cun;
    ipoc::trial_backward<Model, scalar_t, DDP>(ipoc::PlainStages{}, I(0), I(1), xTv,
                                               I(3)[b], I(4)[b], O(10), B, T, b,
                                               cost, dv, piv, hu);
    ipoc::trial_forward<Model, scalar_t, DDP>(ipoc::PlainStages{}, I(0), I(1), xTv,
                                              x0, I(3)[b], O(10), O(0), O(1), B, T,
                                              b, txT, nc, mc, cun);
    ipoc::store_col<scalar_t, NX>(O(2), txT, B, b);
    O(3)[b] = cost;
    O(4)[b] = nc;
    O(5)[b] = mc;
    O(6)[b] = dv;
    O(7)[b] = piv;
    O(8)[b] = hu;
    O(9)[b] = cun;
  }
}

extern "C" int host_trial(int dtype, int ddp, int parent, const void* const* in,
                          void* const* out, int B, int T) {
  if (dtype == 1 && ddp) parent ? one_thread<double, true>(in, out, B, T)
                                : merged<double, true>(in, out, B, T);
  else if (dtype == 1) parent ? one_thread<double, false>(in, out, B, T)
                              : merged<double, false>(in, out, B, T);
  else if (dtype == 0 && ddp) parent ? one_thread<float, true>(in, out, B, T)
                                     : merged<float, true>(in, out, B, T);
  else if (dtype == 0) parent ? one_thread<float, false>(in, out, B, T)
                              : merged<float, false>(in, out, B, T);
  else return -1;
  return 0;
}

template <typename scalar_t, bool DDP>
void geometry_t(int B, int* out) {
  using Mt = ipoc::MergedTrial<Model, scalar_t, DDP>;
  out[0] = Mt::G;
  out[1] = Mt::S;
  out[2] = Mt::W;
  out[3] = Mt::blocks(B);
  out[4] = Mt::kShared * static_cast<int>(sizeof(scalar_t));
}

extern "C" int host_geometry(int dtype, int ddp, int B, int* out) {
  if (dtype == 0 && ddp) return geometry_t<float, true>(B, out), 0;
  if (dtype == 0) return geometry_t<float, false>(B, out), 0;
  if (dtype == 1 && ddp) return geometry_t<double, true>(B, out), 0;
  if (dtype == 1) return geometry_t<double, false>(B, out), 0;
  return -1;
}
"""

COSTATE_SOURCE = r"""
#include <math.h>
#include <vector>
#include "costates.h"
#include "riccati_rows.h"

// The parent kernel's loop, one scenario at a time.
template <typename scalar_t, int NX>
void parent(const scalar_t* cx, const scalar_t* fx, const scalar_t* lamT,
            scalar_t* lam, int B, int T) {
  for (int b = 0; b < B; ++b) {
    scalar_t l[NX];
    for (int i = 0; i < NX; ++i) {
      l[i] = lamT[(size_t)b * NX + i];
      lam[((size_t)b * (T + 1) + T) * NX + i] = l[i];
    }
    for (int t = T - 1; t >= 0; --t) {
      const size_t s = (size_t)b * T + t;
      scalar_t nl[NX];
      for (int i = 0; i < NX; ++i) {
        scalar_t acc = fx[s * NX * NX + i] * l[0];
        for (int j = 1; j < NX; ++j) acc = acc + fx[s * NX * NX + j * NX + i] * l[j];
        nl[i] = cx[s * NX + i] + acc;
      }
      for (int i = 0; i < NX; ++i) {
        l[i] = nl[i];
        lam[((size_t)b * (T + 1) + t) * NX + i] = nl[i];
      }
    }
  }
}

template <typename scalar_t, int NX>
void run(int which, const void* const* in, void* out, int B, int T) {
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto* lam = static_cast<scalar_t*>(out);
  if (which) {
    parent<scalar_t, NX>(I(0), I(1), I(2), lam, B, T);
    return;
  }
  std::vector<scalar_t> sh(ipoc::Costates<scalar_t, NX>::kShared, scalar_t(NAN));
  ipoc::costates_host<scalar_t, NX>(I(0), I(1), I(2), lam, B, T, sh.data());
}

extern "C" int host_costates(int dtype, int nx, int which, const void* const* in,
                             void* out, int B, int T) {
  if (dtype == 1 && nx == 2) return run<double, 2>(which, in, out, B, T), 0;
  if (dtype == 1 && nx == 3) return run<double, 3>(which, in, out, B, T), 0;
  if (dtype == 1 && nx == 4) return run<double, 4>(which, in, out, B, T), 0;
  if (dtype == 1 && nx == 6) return run<double, 6>(which, in, out, B, T), 0;
  if (dtype == 0 && nx == 2) return run<float, 2>(which, in, out, B, T), 0;
  if (dtype == 0 && nx == 3) return run<float, 3>(which, in, out, B, T), 0;
  if (dtype == 0 && nx == 4) return run<float, 4>(which, in, out, B, T), 0;
  return -1;
}

template <typename scalar_t, int NX>
void geometry(int B, int* out) {
  using Cs = ipoc::Costates<scalar_t, NX>;
  out[0] = Cs::G;
  out[1] = Cs::S;
  out[2] = Cs::W;
  out[3] = Cs::blocks(B);
  out[4] = Cs::kShared * static_cast<int>(sizeof(scalar_t));
}

extern "C" int host_costate_geometry(int dtype, int nx, int B, int* out) {
  if (dtype == 0 && nx == 2) return geometry<float, 2>(B, out), 0;
  if (dtype == 0 && nx == 3) return geometry<float, 3>(B, out), 0;
  if (dtype == 0 && nx == 4) return geometry<float, 4>(B, out), 0;
  if (dtype == 0 && nx == 6) return geometry<float, 6>(B, out), 0;
  if (dtype == 1 && nx == 2) return geometry<double, 2>(B, out), 0;
  if (dtype == 1 && nx == 3) return geometry<double, 3>(B, out), 0;
  if (dtype == 1 && nx == 4) return geometry<double, 4>(B, out), 0;
  if (dtype == 1 && nx == 6) return geometry<double, 6>(B, out), 0;
  return -1;
}

// T DDP Riccati steps from (Vxx, Vx) on per-stage data, by riccati_step
// (which = 1) or by RowStep's group of G lanes (which = 0): the gains
// (T, NU + NU NX) and the final Vxx, Vx, dV, minimum pivot.
template <typename scalar_t, int NX, int NU>
void ddp_steps(int which, const scalar_t* ru, const scalar_t* Q, const scalar_t* R,
               const scalar_t* M, const scalar_t* fx, const scalar_t* fu,
               const scalar_t* hx, const scalar_t* VxxT, const scalar_t* VxT,
               scalar_t* gains, scalar_t* Vxx_o, scalar_t* Vx_o, scalar_t* dv_o,
               scalar_t* piv_o, int T) {
  constexpr int NG = NU + NU * NX;
  if (which) {
    scalar_t Vxx[NX * NX], Vx[NX], dv = 0, piv = scalar_t(INFINITY);
    for (int i = 0; i < NX * NX; ++i) Vxx[i] = VxxT[i];
    for (int i = 0; i < NX; ++i) Vx[i] = VxT[i];
    for (int t = T - 1; t >= 0; --t) {
      scalar_t* g = gains + (size_t)t * NG;
      ipoc::riccati_step<scalar_t, NX, NU, true>(
          ru + t * NU, Q + t * NX * NX, R + t * NU * NU, M + t * NX * NU,
          fx + t * NX * NX, fu + t * NX * NU, Vxx, Vx, g, g + NU, dv, piv,
          hx + t * NX);
    }
    for (int i = 0; i < NX * NX; ++i) Vxx_o[i] = Vxx[i];
    for (int i = 0; i < NX; ++i) Vx_o[i] = Vx[i];
    *dv_o = dv;
    *piv_o = piv;
    return;
  }
  using Step = ipoc::RowStep<scalar_t, NX, NU, true>;
  std::vector<scalar_t> xch(Step::kXch, scalar_t(NAN));
  typename Step::Lane lanes[Step::G];
  for (int l = 0; l < Step::G; ++l) {
    Step::init(lanes[l], l);
    for (int j = 0; j < NX; ++j) lanes[l].vr[j] = VxxT[lanes[l].rr * NX + j];
    for (int i = 0; i < NX; ++i) lanes[l].vx[i] = VxT[i];
  }
  ipoc::GroupExec<typename Step::Lane, Step::G> ex{lanes};
  for (int t = T - 1; t >= 0; --t) {
    scalar_t* g = gains + (size_t)t * NG;
    const scalar_t *Qt = Q + t * NX * NX, *fxt = fx + t * NX * NX,
                   *Mt = M + t * NX * NU, *hxt = hx + t * NX;
    Step::step(
        ex, xch.data(), ru + t * NU, R + t * NU * NU, fxt, fu + t * NX * NU,
        [](typename Step::Lane&) {},
        [&](const auto& L, const scalar_t* x, typename Step::Rows& w) {
          Step::rows_pick(L, Qt, fxt, Mt, x, w, hxt);
        },
        [&](typename Step::Lane& L) {
          if (Step::owns(L))
            for (int m = 0; m < NU; ++m) g[NU + m * NX + L.r] = L.kc[m];
          if (L.r == 0)
            for (int m = 0; m < NU; ++m) g[m] = L.k[m];
        });
  }
  for (int i = 0; i < NX * NX; ++i) Vxx_o[i] = xch[Step::kVxx + i];
  for (int i = 0; i < NX; ++i) Vx_o[i] = lanes[0].vx[i];
  *dv_o = lanes[0].dv;
  *piv_o = lanes[0].piv;
}

template <typename scalar_t, int NX, int NU>
void ddp_run(int which, const void* const* in, void* const* out, int T) {
  auto I = [&](int k) { return static_cast<const scalar_t*>(in[k]); };
  auto O = [&](int k) { return static_cast<scalar_t*>(out[k]); };
  ddp_steps<scalar_t, NX, NU>(which, I(0), I(1), I(2), I(3), I(4), I(5), I(6), I(7),
                              I(8), O(0), O(1), O(2), O(3), O(4), T);
}

extern "C" int host_ddp_steps(int dtype, int nx, int nu, int which,
                              const void* const* in, void* const* out, int T) {
  if (dtype == 1 && nx == 2 && nu == 1) return ddp_run<double, 2, 1>(which, in, out, T), 0;
  if (dtype == 1 && nx == 4 && nu == 1) return ddp_run<double, 4, 1>(which, in, out, T), 0;
  if (dtype == 1 && nx == 3 && nu == 2) return ddp_run<double, 3, 2>(which, in, out, T), 0;
  if (dtype == 1 && nx == 6 && nu == 2) return ddp_run<double, 6, 2>(which, in, out, T), 0;
  if (dtype == 0 && nx == 2 && nu == 1) return ddp_run<float, 2, 1>(which, in, out, T), 0;
  if (dtype == 0 && nx == 4 && nu == 1) return ddp_run<float, 4, 1>(which, in, out, T), 0;
  if (dtype == 0 && nx == 3 && nu == 2) return ddp_run<float, 3, 2>(which, in, out, T), 0;
  if (dtype == 0 && nx == 6 && nu == 2) return ddp_run<float, 6, 2>(which, in, out, T), 0;
  return -1;
}
"""

_LIBS = {}


def _compile(tmp_path_factory, name, source):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp(name)
    src, so = out / f"{name}.cpp", out / f"{name}.so"
    src.write_text(source)
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


def _merged_library(tmp_path_factory, name):
    """One model's generated struct (dt = 1/40) with the merged schedule and
    lane.h's one-thread trial, compiled once per module: ``(ocp, lib)``."""
    if name not in _LIBS:
        model, nx, nu, _ = MODELS[name]
        ocp = model.make_ocp(DT)
        lib = _compile(tmp_path_factory, f"merged_{name}",
                       '#include "scalar_math.h"\n' + tf.model_struct(ocp, nx, nu)
                       + MERGED_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.host_trial.argtypes = [i, i, i, p, p, i, i]
        lib.host_trial.restype = i
        lib.host_geometry.argtypes = [i, i, i, p]
        lib.host_geometry.restype = i
        _LIBS[name] = ocp, lib
    return _LIBS[name]


@pytest.fixture(scope="module", params=list(MODELS))
def host(request, tmp_path_factory):
    """``(model, ocp, nx, lib)`` of one model's merged host build."""
    model, nx, _, _ = MODELS[request.param]
    ocp, lib = _merged_library(tmp_path_factory, request.param)
    return model, ocp, nx, lib


@pytest.fixture(scope="module")
def host_costates(tmp_path_factory):
    lib = _compile(tmp_path_factory, "costates", COSTATE_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_costates.argtypes = [i, i, i, p, p, i, i]
    lib.host_costates.restype = i
    lib.host_costate_geometry.argtypes = [i, i, i, p]
    lib.host_costate_geometry.restype = i
    lib.host_ddp_steps.argtypes = [i, i, i, i, p, p, i]
    lib.host_ddp_steps.restype = i
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _trial(lib, ins, ddp, parent=False):
    """The host build's merged trial (or, ``parent``, the one-thread trial)
    on CPU tensors, outputs NaN-filled first: :data:`NAMES`' ten."""
    xs, u = ins[0], ins[1]
    T, nx, B = xs.shape
    nu = u.shape[1]
    shapes = [(T, nu, B), (T, nx, B), (nx, B)] + [(B,)] * 7 + [
        (T, (1 + nx) * nu, B)]
    outs = [torch.full(s, float("nan"), dtype=xs.dtype) for s in shapes]
    assert lib.host_trial(cuda.dtype_code(xs.dtype), int(ddp), int(parent),
                          _ptrs(ins), _ptrs(outs), B, T) == 0
    return outs[:10]


def _lanes(model, ocp, nx, B, T, seed, dtype=torch.float64):
    """Packed lane inputs at a random warm start: the open-loop trajectory
    of numpy-made controls, a per-lane barrier and Levenberg parameter."""
    rng = np.random.default_rng(seed)
    x0 = model.initial_state(torch.float64).numpy()
    _, _, nu, centre = next(m for m in MODELS.values() if m[0] is model)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    u = t(centre + 0.1 * rng.normal(size=(T, nu, B)))
    x0b = t(x0[:, None] + 0.01 * rng.normal(size=(nx, B)))
    bp = t(rng.uniform(0.01, 0.2, size=B))
    xs, xT, _, cunsq = tf.rollout_cost_plain(ocp, u, x0b, bp)
    return xs, u, xT, bp, 100.0 * torch.sqrt(cunsq)


def _offset(a):
    """``a`` as a contiguous view one scalar past its storage's start."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    return v


@pytest.mark.parametrize("T", [1, 7, 40])
@pytest.mark.parametrize("ddp", [False, True], ids=["newton", "ddp"])
def test_host_merged_trial_matches_parent_and_plain(host, ddp, T):
    """Float64, B in {1, 3, 37}: every output equal to the one-thread
    trial's to the bit, and within 1e-12 of scale of the plain trial (the
    pivot where the plain version's is positive: DDP's plain pivot is the
    elimination's of the regularized Quu, as the kernel's); at B = 37 also
    on offset views, to the bit of the aligned inputs."""
    model, ocp, nx, lib = host
    for B in (1, 3, 37):
        ins = _lanes(model, ocp, nx, B, T, seed=T + B + 100 * ddp)
        got = _trial(lib, ins, ddp)
        parent = _trial(lib, ins, ddp, parent=True)
        for name, g, p in zip(NAMES, got, parent):
            assert torch.equal(g, p), (name, T, B, ddp)
        xs, u, xT, bp, reg = ins
        ref = tf.fused_newton_iter_plain(ocp, xs, xT, u, bp, reg, ddp)
        assert bool((ref[7] > 0).all())
        for name, g, r in zip(NAMES, got, ref):
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= TOL * scale, (name, T, B)
        if B == 37:
            views = _trial(lib, [_offset(a) for a in ins], ddp)
            for name, g, v in zip(NAMES, got, views):
                assert torch.equal(g, v), name


@pytest.mark.parametrize("B", [1, 3, 4096])
def test_merged_launch_rule(host, B):
    """One warp per block in both modes: G = RowStep's lanes per scenario
    (4 at cartpole, 2 at pendulum, 8 at the quadrotor, 4 at the
    unicycle), 32 / G
    scenarios, chunks of W = G
    stages, ceil(B / S) blocks, as ``row_geometry`` states them; the shared
    memory per block that the source notes state (DDP mode holds no
    forward handoffs)."""
    _, _, nx, lib = host
    shared = {(4, False): (15104, 30208), (4, True): (11776, 23552),
              (2, False): (9984, 19968), (2, True): (8192, 16384),
              (6, False): (27136, 54272), (6, True): (20736, 41472),
              (3, False): (17920, 35840), (3, True): (14080, 28160)}
    G = {4: 4, 2: 2, 6: 8, 3: 4}[nx]
    geo = sn.row_geometry(nx, B)
    for ddp in (False, True):
        for code in (0, 1):
            out = (ctypes.c_int * 5)()
            assert lib.host_geometry(code, int(ddp), B, out) == 0
            assert list(out)[:4] == [G, 32 // G, G, -(-B // (32 // G))]
            assert [geo["lanes_per_scenario"], geo["scenarios_per_block"],
                    geo["blocks"]] == [out[0], out[1], out[3]]
            assert out[4] == shared[(nx, ddp)][code], (nx, ddp, code)


def _args(prog, seed, B=16):
    gen = torch.Generator().manual_seed(seed)
    return [0.1 + 0.4 * torch.rand(tuple(s) + (B,), generator=gen,
                                   dtype=torch.float64)
            for s in prog.in_shapes]


def test_ddp_forward_parts_are_the_stage_program(host):
    """step(x, u, tx, gains) gives stage_ddp_fwd's tu, tx and tx+, and the
    evaluation (tx, tu, bp) its cost, maximum constraint value and
    ||cu||^2 (each summand the product of its pair), to the bit on the
    torch evaluators in float64; the evaluation is stage_fwd_eval's
    program, and the step holds the chain's calls (sin and cos at
    cartpole, 41 operations; pendulum 16; the quadrotor 54; the unicycle
    27) and reads no
    bp."""
    _, ocp, nx, _ = host
    nu = {4: 1, 2: 1, 6: 2, 3: 2}[nx]
    prog = tf.scalar_programs(ocp, nx, nu)["stage_ddp_fwd"]
    step, ev = tf.ddp_forward_parts(ocp, nx, nu)
    assert same_program(ev, tf.forward_parts(ocp, nx, nu)[2])
    assert not same_program(step, ev)
    assert step.stats["ops"] == {4: 41, 2: 16, 6: 54, 3: 27}[nx]
    assert {nd.op for nd in step.order} & CALLS
    assert step.in_shapes == [(nx,), (nu,), (nx,), ((1 + nx) * nu,)]
    x, u, bp, tx, g = _args(prog, nx + 7)
    ref = prog.evaluate(x, u, bp, tx, g)
    tu, tx2, txn = step.evaluate(x, u, tx, g)
    cost, cmax, cu = ev.evaluate(tx2, tu, bp)
    got = (tu, tx2, txn, cost[0] * cost[1], cmax, cu[0] * cu[1])
    for k, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), k


# --- the DDP Riccati step ---------------------------------------------------


def _ddp_data(T, nx, nu, seed, dtype):
    """A chain of DDP steps' data: Q, R and the terminal Vxx positive
    definite."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: 0.3 * rng.normal(size=s)  # noqa: E731
    A = rnd(T, nx, nx)
    Q = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(nx)
    Br = rnd(T, nu, nu)
    R = Br @ np.swapaxes(Br, -1, -2) + 2 * np.eye(nu)
    Xa = rnd(nx, nx)
    t = lambda a: torch.tensor(a, dtype=dtype).contiguous()  # noqa: E731
    return tuple(t(a) for a in (rnd(T, nu), Q, R, 0.1 * rnd(T, nx, nu),
                                rnd(T, nx, nx), rnd(T, nx, nu), rnd(T, nx),
                                Xa @ Xa.T + np.eye(nx), rnd(nx)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (3, 2), (6, 2)],
                         ids=lambda s: f"nx{s[0]}nu{s[1]}")
def test_rowstep_ddp_equals_riccati_step(host_costates, shape, dtype):
    """Twelve DDP steps from a terminal (Vxx, Vx): every gain, the final
    Vxx and Vx, dV and the minimum pivot of RowStep<..., true> equal
    riccati_step<..., true>'s to the bit."""
    nx, nu = shape
    T = 12
    ins = _ddp_data(T, nx, nu, seed=nx + 10 * nu, dtype=dtype)
    res = []
    for which in (0, 1):
        outs = [torch.full(s, float("nan"), dtype=dtype)
                for s in ((T, nu + nu * nx), (nx, nx), (nx,), (), ())]
        assert host_costates.host_ddp_steps(cuda.dtype_code(dtype), nx, nu,
                                            which, _ptrs(ins), _ptrs(outs),
                                            T) == 0
        res.append(outs)
    assert bool(torch.isfinite(res[1][0]).all())
    for k, (a, b) in enumerate(zip(*res)):
        assert torch.equal(a, b), k


# --- the costate recursion ---------------------------------------------------


def _costate_data(B, T, nx, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype).contiguous()  # noqa: E731
    return (t(rng.normal(size=(B, T, nx))),
            t(0.4 * rng.normal(size=(B, T, nx, nx)) + np.eye(nx)),
            t(rng.normal(size=(B, nx))))


def _costates(lib, ins, parent=False):
    cx = ins[0]
    B, T, nx = cx.shape
    lam = torch.full((B, T + 1, nx), float("nan"), dtype=cx.dtype)
    assert lib.host_costates(cuda.dtype_code(cx.dtype), nx, int(parent),
                             _ptrs(ins), lam.data_ptr(), B, T) == 0
    return lam


@pytest.mark.parametrize("T", [1, 7, 40, 100])
@pytest.mark.parametrize("nx", [2, 3, 4, 6])
def test_host_costates_match_parent_and_plain(host_costates, nx, T):
    """Float64, B in {1, 3, 37}: lam equal to the one-thread loop's to the
    bit and within 1e-12 of scale of ``seq_costates_plain``; at B = 37 also
    on offset views, to the bit of the aligned inputs."""
    for B in (1, 3, 37):
        ins = _costate_data(B, T, nx, seed=nx + T + B)
        got = _costates(host_costates, ins)
        assert torch.equal(got, _costates(host_costates, ins, parent=True))
        ref = seq_costates_plain(*ins)
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= TOL * scale, (nx, T, B)
        if B == 37:
            views = _costates(host_costates, [_offset(a) for a in ins])
            assert torch.equal(got, views)


@pytest.mark.parametrize("B", [1, 3, 4096])
def test_costate_launch_rule(host_costates, B):
    """One warp per block, G = row_lanes(nx) lanes per scenario, 32 / G
    scenarios, chunks of 8 stages, ceil(B / S) blocks, as ``row_geometry``
    states them; the shared memory per block that the source notes state."""
    shared = {(0, 2): 11264, (1, 2): 21504, (0, 3): 10496, (1, 3): 20992,
              (0, 4): 16896, (1, 4): 33792, (0, 6): 17408, (1, 6): 34816}
    for (code, nx), bytes_ in shared.items():
        out = (ctypes.c_int * 5)()
        assert host_costates.host_costate_geometry(code, nx, B, out) == 0
        G = {2: 2, 3: 4, 4: 4, 6: 8}[nx]
        assert list(out)[:4] == [G, 32 // G, 8, -(-B // (32 // G))]
        geo = sn.row_geometry(nx, B)
        assert [geo["lanes_per_scenario"], geo["scenarios_per_block"],
                geo["blocks"]] == [out[0], out[1], out[3]]
        assert out[4] == bytes_, (code, nx)


# --- float32 against JAX's kernels in interpret mode -------------------------

JB, JT = 128, 6


def test_host_costates_match_jax_kernel_f32(host_costates):
    """Float32, nx = 4, T = 12, B = 37 against JAX's costate kernel in
    interpret mode, within 1e-5 of scale."""
    ins = _costate_data(37, 12, 4, seed=9, dtype=torch.float32)
    with jax.enable_x64(False):
        ref = np.asarray(j_costates_kernel(*(jnp.asarray(a.numpy())
                                             for a in ins), interpret=True))
    got = _costates(host_costates, ins).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _jp(a):
    """(B, T, rows) or (B, rows) numpy -> JAX's packed layout (1 sublane)."""
    a = jnp.asarray(a)
    return _pack_s(a, JB, 1) if a.ndim == 3 else jf._pack_vec(a, JB, 1)


def test_host_merged_ddp_matches_jax_kernel_f32(tmp_path_factory):
    """The DDP trial against JAX's merged kernel in DDP mode (interpret
    mode, pendulum, T = 6, 128 lanes, float32): tu, tx, txT, the cost, the
    trial cost, its maximum constraint value, dV, the pivot, max|Qu| and
    sum ||cu||^2."""
    tocp, lib = _merged_library(tmp_path_factory, "pendulum")
    jocp = j_pendulum.make_ocp(DT)
    rng = np.random.default_rng(3)
    x0 = np.asarray(j_pendulum.initial_state(jnp.float64))
    u = (0.1 * rng.normal(size=(JB, JT, 1))).astype(np.float32)
    x0b = (x0 + 0.02 * rng.normal(size=(JB, 2))).astype(np.float32)
    bp = np.full((JB,), 0.1, np.float32)
    reg = np.full((JB,), 3.0, np.float32)
    ut = torch.as_tensor(np.ascontiguousarray(np.moveaxis(u, 0, -1)))
    bpt = torch.as_tensor(bp)
    xs, xT, _, _ = tf.rollout_cost_plain(tocp, ut, torch.as_tensor(x0b.T.copy()),
                                         bpt)
    xs_b, xT_b = xs.permute(2, 0, 1).numpy(), xT.T.numpy()
    set_pallas_scans("on")
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(lambda: jf.fused_newton_iter_packed(
                jocp, _jp(xs_b), _jp(xT_b), _jp(u), _jp(bp[:, None]),
                _jp(reg[:, None]), with_cu=True, merged=True, ddp=True,
                interpret=True))()
    finally:
        set_pallas_scans("auto")
    got = _trial(lib, (xs, ut, xT, bpt, torch.as_tensor(reg)), True)
    tol = dict(rtol=5e-5, atol=5e-5)
    stages = lambda p, rows: np.asarray(_unpack_s(p, JB, (rows,)))  # noqa: E731
    np.testing.assert_allclose(got[0].permute(2, 0, 1).numpy(), stages(ref[0], 1),
                               **tol)
    np.testing.assert_allclose(got[1].permute(2, 0, 1).numpy(), stages(ref[1], 2),
                               **tol)
    np.testing.assert_allclose(
        got[2].T.numpy(), np.asarray(_unpack_s(ref[2][:, None], JB, (2,)))[:, 0],
        **tol)
    for k in range(3, 10):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k]).reshape(-1)[:JB],
                                   err_msg=NAMES[k], **tol)
