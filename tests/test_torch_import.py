"""The PyTorch port never imports jax."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

EXAMPLES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "torch_*.py")))

MODULES = [
    "ipoc_tpu_torch",
    "ipoc_tpu_torch.config",
    "ipoc_tpu_torch.interop",
    "ipoc_tpu_torch.problem",
    "ipoc_tpu_torch.models.cartpole",
    "ipoc_tpu_torch.models.double_integrator",
    "ipoc_tpu_torch.models.pendulum",
    "ipoc_tpu_torch.models.quadrotor",
    "ipoc_tpu_torch.models.unicycle",
    "ipoc_tpu_torch.utils",
    "ipoc_tpu_torch.utils.integrators",
    "ipoc_tpu_torch.utils.logging",
    "ipoc_tpu_torch.utils.profiling",
    "ipoc_tpu_torch.utils.timing",
    "ipoc_tpu_torch.ops.linalg",
    "ipoc_tpu_torch.ops.derivatives",
    "ipoc_tpu_torch.ops.cuda",
    "ipoc_tpu_torch.ops.cuda.seq_newton",
    "ipoc_tpu_torch.ops.codegen.scalarize",
    "ipoc_tpu_torch.ops.fused_iter",
    "ipoc_tpu_torch.ops.mega",
    "ipoc_tpu_torch.ops.scan_kernels",
    "ipoc_tpu_torch.ops.newton_kernel",
    "ipoc_tpu_torch.parallel.costates",
    "ipoc_tpu_torch.parallel.distributed",
    "ipoc_tpu_torch.parallel.lqt",
    "ipoc_tpu_torch.parallel.scan",
    "ipoc_tpu_torch.parallel.sharding",
    "ipoc_tpu_torch.parallel.time_sharded",
    "ipoc_tpu_torch.solvers.barrier",
    "ipoc_tpu_torch.solvers.batched",
    "ipoc_tpu_torch.solvers.checkpoint",
    "ipoc_tpu_torch.solvers.globalization",
    "ipoc_tpu_torch.solvers.ip_ddp",
    "ipoc_tpu_torch.solvers.ip_newton",
    "ipoc_tpu_torch.solvers.packed_stream",
    "ipoc_tpu_torch.solvers.solution",
    "ipoc_tpu_torch.solvers.stream",
    "ipoc_tpu_torch.solvers.time_sharded",
]


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port with jax
    blocked, and ends with no jax module loaded; importing builds nothing."""
    code = textwrap.dedent(f"""
        import importlib, sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked in this check")
                return None

        sys.meta_path.insert(0, BlockJax())
        for m in {MODULES!r}:
            importlib.import_module(m)
        from ipoc_tpu_torch.ops import cuda, fused_iter
        assert not cuda._libs, "importing built or loaded the kernels"
        assert not fused_iter._LIBS and not fused_iter._PROGRAMS, (
            "importing generated, built or loaded the fused kernels")
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib"))
        print("JAX_MODULES", loaded)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout


def imported_packages(path):
    """The top-level packages a Python file imports (every ``import`` and
    ``from ... import`` statement, wherever it stands)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_torch_examples_found():
    assert len(EXAMPLES) == 6, EXAMPLES


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_torch_example_imports_no_jax(path):
    """The port's examples import neither jax nor the JAX package."""
    assert not imported_packages(path) & {"jax", "jaxlib", "ipoc_tpu"}
    assert "ipoc_tpu_torch" in imported_packages(path)
