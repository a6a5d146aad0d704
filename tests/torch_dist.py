"""Process groups for the port's distributed tests: gloo on the CPU, one
spawned process per rank.

A group starts at once and runs every case of its test file in each rank;
:meth:`Group.results` joins it with a deadline, kills what is left, and
hands back each rank's results.  A gloo collective that waits longer than
``GROUP_TIMEOUT_S`` raises in the rank, and a rank that outlives the join
deadline is killed, so a hang fails the tests instead of cutting the run.
This module and the workers it runs import no JAX: the children import
only the test module's top level.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 600


def _rank_main(fn, rank, world, init_file, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from ipoc_tpu_torch.parallel.distributed import initialize

        initialize(f"file://{init_file}", world, rank, backend="gloo",
                   timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = (fn(rank, world), None)
        dist.destroy_process_group()
    except Exception:  # the parent reports it
        out = (None, traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Group:
    """``world`` spawned ranks, each running ``fn(rank, world)`` (a
    module-level function) in a gloo group rendezvoused through a file
    under ``tmp_dir``."""

    def __init__(self, fn, world: int, tmp_dir):
        self.world, self.dir = world, str(tmp_dir)
        os.makedirs(self.dir, exist_ok=True)
        ctx = mp.get_context("spawn")
        init_file = os.path.join(self.dir, "rendezvous")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, init_file, self.dir))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._out = None

    def results(self) -> list:
        """Every rank's return value, in rank order; raises if a rank
        failed or did not finish in time."""
        if self._out is None:
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
            late = [r for r, p in enumerate(self.procs) if p.is_alive()]
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            outs, errors = [], []
            for r in range(self.world):
                path = os.path.join(self.dir, f"rank{r}.pkl")
                if not os.path.exists(path):
                    errors.append(f"rank {r}: no result (exit code "
                                  f"{self.procs[r].exitcode})")
                    continue
                with open(path, "rb") as f:
                    value, err = pickle.load(f)
                if err is not None:
                    errors.append(f"rank {r}:\n{err}")
                outs.append(value)
            if late:
                errors.insert(0, f"ranks {late} did not finish in "
                                 f"{JOIN_TIMEOUT_S} s")
            self._out = (outs, errors)
        outs, errors = self._out
        if errors:
            raise RuntimeError("\n".join(errors))
        return outs


def run_cases(cases: dict, rank: int, world: int, *args) -> dict:
    """Run each ``cases[name](world, *args)`` in turn on this rank; a case
    that raises is recorded as its traceback, and the others still run."""
    out = {}
    for name, case in cases.items():
        try:
            out[name] = case(world, *args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def case_result(group: Group, name: str) -> dict:
    """Rank 0's result of case ``name``, after checking that every rank
    returned the same (the entry points hand the full result to every
    rank) and that the case did not raise."""
    import numpy as np

    outs = group.results()
    first = outs[0][name]
    assert "error" not in first, first["error"]
    for r, out in enumerate(outs[1:], start=1):
        other = out[name]
        assert "error" not in other, f"rank {r}: {other['error']}"
        assert other.keys() == first.keys()
        for key in first:
            np.testing.assert_array_equal(
                np.asarray(other[key]), np.asarray(first[key]),
                err_msg=f"rank {r}, {name}.{key}")
    return first
