"""Profiling hooks: ``torch.profiler`` traces around solves (counterpart of
``ipoc_tpu/utils/profiling.py``).

The reference's only tracing is host wall-clock timing (SURVEY §5.1).
These helpers write Chrome traces, viewable in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``: the host's operators and
annotations and, on a machine with a CUDA device, every kernel launched on
it, the port's CUDA kernels among them.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Trace the enclosed block; on exit write a Chrome trace
    ``ipoc_<pid>_<ns>.pt.trace.json`` into ``logdir`` (by default
    ``ipoc_trace`` in the temporary directory).  Yields ``logdir``.

    The host's activity is always recorded, the CUDA devices' whenever
    torch sees one: a trace observes a run where it runs and moves nothing
    off the card.
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "ipoc_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"ipoc_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named span inside a trace (``torch.profiler.record_function``)."""
    return record_function(name)
