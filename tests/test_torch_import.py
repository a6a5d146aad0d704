"""The PyTorch port never imports jax."""

import subprocess
import sys
import textwrap

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
    "ipoc_tpu_torch.utils.integrators",
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
