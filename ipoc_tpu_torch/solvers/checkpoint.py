"""Checkpoint/resume for large batched solve campaigns (counterpart of
``ipoc_tpu/solvers/checkpoint.py``).

The reference has no checkpointing (SURVEY §5.4); solves are seconds-long
and single-shot.  At pool scale (65k scenarios, BASELINE.json config 5) a
campaign is minutes-to-hours, so completed work must survive restarts: the
runner processes the scenario set in chunks and persists each finished
chunk (controls + iteration counts + a JSON manifest).  A restarted run
skips finished chunks.

The directory is the JAX package's: the same ``chunk_{idx:06d}.npz`` files
(``controls``, ``iterations`` int32), the same ``manifest.json`` and the
same campaign identity, the dtype under numpy's name (``"float32"``, not
``"torch.float32"``), so a campaign either package started resumes in the
other.  Loaded chunks go to the device of the campaign's ``controls``.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ipoc_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from ipoc_tpu_torch.problem import OCP
from ipoc_tpu_torch.solvers.batched import BatchSolution, solve_batch


def dtype_name(dtype: torch.dtype) -> str:
    """A tensor dtype under numpy's name, as the JAX runner records it
    (``str(jnp.result_type(...))``): ``torch.float32`` -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


class CheckpointedBatchRunner:
    """Chunked batched solves with restart-safe persistence."""

    def __init__(self, directory: str, chunk_size: int = 256):
        self.directory = directory
        self.chunk_size = chunk_size
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")

    def _manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {"chunks_done": []}

    def _write_manifest(self, m: dict):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, self._manifest_path)  # atomic

    def _check_identity(self, n: int, horizon: int, nu: int,
                        semantics: dict) -> dict:
        """Refuse to resume a run whose chunking/campaign shape OR solver
        semantics changed.

        Chunk files are keyed by index only, so resuming with a different
        ``chunk_size`` or scenario-set shape would silently splice stale
        chunks into the result at the wrong offsets — and resuming the
        same-shaped campaign with a different cfg/method/dtype would
        silently splice chunks solved under different solver settings into
        one result.  The manifest records the campaign identity (shape +
        a digest of cfg, the method, and the dtype) on first run and must
        match on resume (delete the directory to start over)."""
        m = self._manifest()
        ident = {"chunk_size": self.chunk_size, "n": n,
                 "horizon": horizon, "nu": nu, **semantics}
        recorded = m.get("identity")
        if recorded is not None and set(recorded) < set(ident):
            # Manifest written before the identity grew the semantics
            # keys (cfg digest/method/dtype): compare on the recorded
            # keys only and back-fill the new ones, so pre-existing
            # checkpoint directories stay resumable.
            if {k: ident[k] for k in recorded} == recorded:
                recorded = m["identity"] = ident
                self._write_manifest(m)
        if recorded is None:
            m["identity"] = ident
            self._write_manifest(m)
        elif recorded != ident:
            raise ValueError(
                f"checkpoint directory {self.directory!r} was written by a "
                f"run with {recorded}, resumed with {ident}; finished "
                "chunks would splice at wrong offsets — use a fresh "
                "directory (or delete this one) to change the campaign"
            )
        return m

    def _mark_done(self, idx: int):
        m = self._manifest()
        if idx not in m["chunks_done"]:
            m["chunks_done"].append(idx)
        self._write_manifest(m)

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{idx:06d}.npz")

    def _save_chunk(self, idx: int, sol: BatchSolution):
        tmp = self._chunk_path(idx) + ".tmp.npz"
        np.savez(
            tmp,
            controls=sol.controls.detach().cpu().numpy(),
            iterations=sol.iterations.detach().cpu().numpy().astype(np.int32),
        )
        os.replace(tmp, self._chunk_path(idx))
        self._mark_done(idx)

    def _load_chunk(self, idx: int, device=None) -> BatchSolution:
        with np.load(self._chunk_path(idx)) as data:
            return BatchSolution(
                torch.as_tensor(data["controls"], device=device),
                torch.as_tensor(data["iterations"].astype(np.int32),
                                device=device),
            )

    def run(
        self,
        ocp: OCP,
        controls,        # (N, T, nu)
        initial_states,  # (N, nx)
        cfg: SolverConfig = DEFAULT_CONFIG,
        method: str = "par",
        solve_fn=None,
    ) -> BatchSolution:
        """Solve all N scenarios, resuming from any prior partial run; the
        solution is on the device of ``controls``.

        ``solve_fn(u_chunk, x_chunk) -> BatchSolution`` may override the
        default solve, :func:`solve_batch` on the device of its inputs
        (e.g. with a stream or a mesh-sharded one).
        """
        n, horizon, nu = controls.shape
        custom = solve_fn is not None
        if solve_fn is None:
            def solve_fn(u, x):
                return solve_batch(ocp, u, x, cfg, method)
        semantics = {
            "cfg_digest": hashlib.sha256(repr(cfg).encode()).hexdigest()[:16],
            "method": "<custom solve_fn>" if custom else method,
            "dtype": dtype_name(controls.dtype),
        }
        done = set(
            self._check_identity(n, horizon, nu, semantics)["chunks_done"])
        out = []
        for idx, start in enumerate(range(0, n, self.chunk_size)):
            end = min(start + self.chunk_size, n)
            if idx in done:
                out.append(self._load_chunk(idx, controls.device))
                continue
            sol = solve_fn(controls[start:end], initial_states[start:end])
            sol = BatchSolution(
                sol.controls.to(controls.device),
                sol.iterations.to(controls.device, torch.int32),
            )
            self._save_chunk(idx, sol)
            out.append(sol)
        return BatchSolution(
            torch.cat([s.controls for s in out], dim=0),
            torch.cat([s.iterations for s in out], dim=0),
        )
