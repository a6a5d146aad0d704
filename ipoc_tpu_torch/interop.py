"""Carrying the JAX package's state across to the port.

This system has no weights: what the two packages share is the solver
configuration (``BATCH_CONFIG`` included), the scenario pool and the
models' constants.  The helpers here take plain Python
and numpy values, so the port still imports no jax; the tests build every
input with numpy from a seed and hand the same arrays to both packages
(``jax.random`` and ``torch.Generator`` draw different numbers from the
same seed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ipoc_tpu_torch.config import SolverConfig


def config_from_jax(cfg) -> SolverConfig:
    """The port's :class:`SolverConfig` with the fields of an
    ``ipoc_tpu.config.SolverConfig`` (or any object with those fields)."""
    return SolverConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(SolverConfig)})


def pool_from_numpy(controls, initial_states, device=None, dtype=None):
    """A scenario pool ``(controls (N, T, nu), initial_states (N, nx))`` as
    tensors on ``device`` (numpy arrays, or anything ``np.asarray`` takes)."""
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (controls, initial_states))


def model_constants(module) -> dict:
    """A model module's constants (its upper-case module-level numbers and
    tuples of numbers) as plain Python floats: the JAX package's model and
    the port's must carry the same."""
    out = {}
    for name, value in vars(module).items():
        if not name.isupper():
            continue
        if isinstance(value, tuple):
            value = tuple(float(v) for v in value)
        elif isinstance(value, (int, float)) or hasattr(value, "dtype"):
            value = float(value)
        else:
            continue
        out[name] = value
    return out


def to_numpy(value):
    """Tensors, and tuples, NamedTuples, lists and dicts of them, as numpy
    (on the host); other values pass through."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple):
        out = [to_numpy(v) for v in value]
        return type(value)(*out) if hasattr(value, "_fields") else tuple(out)
    if isinstance(value, list):
        return [to_numpy(v) for v in value]
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    return value


def pick_device(name: str) -> torch.device:
    """A script's ``--device``: the device named, and no fallback to the
    CPU where that is a CUDA device and there is no card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return device
