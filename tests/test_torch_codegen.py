"""Model code generation (``ops/codegen/scalarize.py``) against torch.func
and the JAX package.

Every stage program of ``ops/fused_iter.py`` is traced and scalarized for
cartpole, pendulum, the planar quadrotor (nx=6, nu=2: its sin, cos,
stack and cat lowered to straight-line code), the unicycle (nx=3, nu=2:
the sin and cos of its heading, the keep-out disc's state constraint
among five barrier logs and the maximum over five rows) and cartpole with
BASELINE.json config 3's cart box (the cat of the force box's and the
cart box's stacks); at the same float64 inputs (made with numpy, the
angle at and near 0 and 2*pi, where the angle wrap switches branch) its
DAG's torch evaluator equals the port's ``torch.func`` program and the JAX
package's stage program (``fused_iter_kernel.py``), and the emitted C
function, compiled with the host C++ compiler and called through ctypes,
equals ``torch.func``.  Tolerance: 1e-12 relative to each output's largest
entry (the DAG performs the same float64 operations up to constant folding
and summation order, so agreement is at rounding level).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from ipoc_tpu.models import cartpole as j_cartpole
from ipoc_tpu.models import pendulum as j_pendulum
from ipoc_tpu.models import quadrotor as j_quadrotor
from ipoc_tpu.models import unicycle as j_unicycle
from ipoc_tpu.ops.pallas import fused_iter_kernel as jf
from ipoc_tpu_torch.models import cartpole as t_cartpole
from ipoc_tpu_torch.models import pendulum as t_pendulum
from ipoc_tpu_torch.models import quadrotor as t_quadrotor
from ipoc_tpu_torch.models import unicycle as t_unicycle
from ipoc_tpu_torch.ops import cuda
from ipoc_tpu_torch.ops import fused_iter as tf
from ipoc_tpu_torch.ops.codegen.scalarize import scalarize
from tests.test_torch_models import boxed

torch.set_num_threads(1)

RTOL = 1e-12
# model: (JAX module, port module, nx, nu, index of the angle, the
# controls' centre inside the box)
MODELS = {"cartpole": (j_cartpole, t_cartpole, 4, 1, 1, 0.0),
          "pendulum": (j_pendulum, t_pendulum, 2, 1, 0, 0.0),
          "quadrotor": (j_quadrotor, t_quadrotor, 6, 2, 2, t_quadrotor.HOVER),
          "unicycle": (j_unicycle, t_unicycle, 3, 2, 2, 0.0),
          "cartpole_box": (boxed(j_cartpole), boxed(t_cartpole), 4, 1, 1,
                           0.0)}
# The states' spread where a state constraint must hold at every input:
# the cart inside its box, the unicycle (about the origin) off the disc.
STATE_SCALE = {"unicycle": 0.2, "cartpole_box": 0.08}
PROGRAMS = ("stage_bwd", "term", "stage_fwd", "term_fwd", "roll_cost",
            "transition", "final_cost", "dynamics")
ANGLES = (0.0, 1e-13, -1e-13, 2 * np.pi, 2 * np.pi - 1e-12,
          2 * np.pi + 1e-12, np.pi, -3.0, 7.0)


def _jax_program(name, jocp, nx, nu):
    return {
        "stage_bwd": jf._stage_bwd_fn(jocp, nx, nu),
        "term": jf._term_fn(jocp, nx),
        "stage_fwd": jf._stage_fwd_fn(jocp, nx, nu, with_cu=True),
        "term_fwd": jf._term_fwd_fn(jocp),
        "roll_cost": jf._stage_roll_cost_cu_fn(jocp),
        "transition": jf._stage_transition_fn(jocp, with_cu=True),
        "final_cost": jocp.final_cost,
        "dynamics": jocp.dynamics,
    }[name]


def _inputs(shapes, nx, angle, seed, B=len(ANGLES), nu=1, u_centre=0.0,
            x_scale=0.3):
    """Float64 inputs, batch-first: states (nx,) carry the test angles and
    spread ``x_scale`` elsewhere, controls-shaped (nu,) stay well inside
    the box (about ``u_centre``), scalars are bp."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = 0.3 * rng.normal(size=(B,) + tuple(s))
        if tuple(s) == (nx,):
            a *= x_scale / 0.3
        if tuple(s) == (nx,):
            a[:, angle] = ANGLES
        elif tuple(s) == (nu,):
            a = a + u_centre
        elif tuple(s) == ():
            a = rng.uniform(0.01, 0.2, size=(B,))
        out.append(a)
    return out


def _close(got, ref, name):
    """Equal NaN patterns (the barrier's log at an infeasible point) and,
    elsewhere, ``got`` within RTOL of the largest finite |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                  err_msg=name)
    fin = ~np.isnan(ref)
    scale = (np.abs(ref[fin]).max() if fin.any() else 0.0) + 1e-300
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=RTOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    jm, tm, nx, nu, angle, centre = MODELS[request.param]
    tocp = tm.make_ocp(0.01)
    return (request.param, jm.make_ocp(0.01), tocp, nx, nu, angle, centre,
            tf.scalar_programs(tocp, nx, nu))


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_matches_torch_func_and_jax(model, name):
    mname, jocp, tocp, nx, nu, angle, centre, progs = model
    fn, shapes = tf.stage_programs(tocp, nx, nu)[name]
    args = _inputs(shapes, nx, angle, seed=len(name), nu=nu, u_centre=centre,
                   x_scale=STATE_SCALE.get(mname, 0.3))
    prog = progs[name]
    got = prog.evaluate(*(torch.as_tensor(a).movedim(0, -1) for a in args))
    ref = vmap(fn)(*(torch.as_tensor(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    jref = jax.vmap(_jax_program(name, jocp, nx, nu))(
        *(jnp.asarray(a) for a in args))
    jref = jref if isinstance(jref, tuple) else (jref,)
    assert len(got) == len(ref) == len(jref)
    for i, (g, r, j) in enumerate(zip(got, ref, jref)):
        g = g.movedim(-1, 0).numpy()
        _close(g, r.numpy(), f"{mname}.{name}[{i}] vs torch.func")
        _close(g, np.asarray(j), f"{mname}.{name}[{i}] vs JAX")


def test_backward_dag_folds():
    """The one-hot AD basis structure folds away: the cartpole backward
    stage program's DAG is well below the traced graph, and constant
    folding and CSE both fire (the JAX package's
    test_scalarize_folds_basis_structure, for the aten trace)."""
    tocp = t_cartpole.make_ocp(0.01)
    stats = tf.scalar_programs(tocp, 4, 1)["stage_bwd"].stats
    assert stats["ops"] < 0.4 * stats["traced_nodes"], stats
    assert stats["folded"] > 100, stats
    assert stats["cse_hits"] > 50, stats


@pytest.mark.parametrize("fn", [
    lambda x, u: torch.cumsum(x, 0) + u.sum(),
    lambda x, u: torch.sort(x).values + u.sum(),
    lambda x, u: x.argmax().to(x.dtype) + u.sum(),
], ids=["cumsum", "sort", "argmax"])
def test_uncovered_aten_op_raises(fn):
    with pytest.raises(NotImplementedError):
        scalarize(fn, [(4,), (1,)])


def _host_source(progs):
    """The generated functions with extern "C" float64 wrappers."""
    lines = ['#include "scalar_math.h"', "struct Model {"]
    lines += [p.c_source(indent="  ") for p in progs.values()]
    lines.append("};")
    for name, p in progs.items():
        call = ", ".join([f"in[{i}]" for i in range(len(p.in_shapes))]
                         + [f"out[{i}]" for i in range(len(p.out_shapes))])
        lines.append(f'extern "C" void host_{name}(const double* const* in, '
                     f"double* const* out) {{ Model::{name}<double>({call}); }}")
    return "\n".join(lines) + "\n"


def test_emitted_c_matches_torch_func(model, tmp_path):
    """The emitted text compiles with the host C++ compiler and, called
    through ctypes in float64, equals torch.func: this catches emission
    faults before the card."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    mname, _, tocp, nx, nu, angle, centre, progs = model
    src = tmp_path / "model.cpp"
    so = tmp_path / "model.so"
    src.write_text(_host_source(progs))
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(cuda.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    fns = tf.stage_programs(tocp, nx, nu)
    for name, prog in progs.items():
        fn, shapes = fns[name]
        args = [torch.as_tensor(a) for a in
                _inputs(shapes, nx, angle, seed=len(name), nu=nu,
                        u_centre=centre, x_scale=STATE_SCALE.get(mname, 0.3))]
        ref = vmap(fn)(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for b in range(args[0].shape[0]):
            ins = [a[b].contiguous() for a in args]
            outs = [torch.empty(s, dtype=torch.float64)
                    for s in prog.out_shapes]
            getattr(lib, f"host_{name}")(
                (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
                (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs)))
            for i, (o, r) in enumerate(zip(outs, ref)):
                _close(o.numpy(), r[b].reshape(o.shape).numpy(),
                       f"{mname}.{name}[{i}] lane {b}")


def test_model_source_instantiates_the_entry_points():
    """One translation unit per model: the fused kernels' header, the
    generated Model struct with every stage program, and the entry
    points."""
    src = tf.model_source(t_pendulum.make_ocp(0.01), 2, 1)
    assert src.count('#include "fused_iter.cuh"') == 1
    assert "static constexpr int NX = 2;" in src
    for name in PROGRAMS:
        assert f"static IPOC_HD void {name}(" in src
    assert src.rstrip().endswith("IPOC_FUSED_ENTRY_POINTS(Model)")
