"""Benchmark timing protocol (counterpart of ``ipoc_tpu/utils/timing.py``;
reference pendulum_runtime.py:104-139).

Warmup calls that are not timed (the first call on a card loads the
kernels), then N timed repetitions, each waiting for the device; mean and
median reported.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from ipoc_tpu_torch.interop import to_numpy


def sync(tree):
    """Wait for the work behind ``tree`` (any result: a tensor, or tuples,
    lists and dicts of them): once CUDA is in use, ``torch.cuda.synchronize``
    on every card this process sees, whatever the result holds.  Returns
    the tree as numpy, on the host, as the JAX package's ``sync`` does."""
    if torch.cuda.is_initialized():
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
    return to_numpy(tree)


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """Run the reference timing protocol on ``fn(*args)``.

    Returns ``(mean_s, median_s, times)``.
    """
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.fmean(times), statistics.median(times), times
