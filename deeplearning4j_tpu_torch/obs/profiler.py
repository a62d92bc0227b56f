"""Profiling hooks: NaN/Inf panic, step timing and a profiler trace (port
of ``deeplearning4j_tpu/obs/profiler.py``).

Parity with ND4J ``OpProfiler``'s NAN_PANIC / INF_PANIC modes: the
trainer checks the params after each step (:func:`check_finite`, only
under ``config.nan_panic`` / ``config.inf_panic``).  The JAX package's
``jax_debug_nans`` becomes autograd's anomaly mode
(:func:`enable_debug_nans`), and its ``jax.profiler`` trace a
``torch.profiler`` trace exported as Chrome-trace JSON (:func:`trace`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.config import get_config


class NonFiniteError(RuntimeError):
    pass


def _path_text(keys: tuple) -> str:
    """A leaf's path as the JAX package's error prints its key path:
    ``(SequenceKey(idx=0), DictKey(key='W'))``."""
    return "(" + ", ".join(keys) + ("," if len(keys) == 1 else "") + ")"


def _inexact_leaves(tree: Any, keys: tuple = ()) -> list:
    """``(path, leaf)`` for every floating or complex tensor of ``tree``, in
    the JAX package's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _inexact_leaves(tree[k], keys + (f"DictKey(key={k!r})",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, node in enumerate(tree)
                for item in _inexact_leaves(node, keys + (f"SequenceKey(idx={i})",))]
    if torch.is_tensor(tree) and (tree.is_floating_point() or tree.is_complex()):
        return [(_path_text(keys), tree)]
    return []


def _finite_flags(leaves: list) -> torch.Tensor:
    """(any NaN, any Inf) over every leaf as one two-entry tensor on the
    leaves' device: one read for the host, where a ``bool()`` a leaf
    would wait on the device once per parameter tensor."""
    nan = torch.stack([torch.isnan(leaf).any() for leaf in leaves]).any()
    inf = torch.stack([torch.isinf(leaf).any() for leaf in leaves]).any()
    return torch.stack([nan, inf])


def check_finite(tree: Any, label: str = "output") -> None:
    """NAN_PANIC / INF_PANIC: raise :class:`NonFiniteError` when a leaf of
    ``tree`` holds a NaN (under ``config.nan_panic``) or an Inf (under
    ``config.inf_panic``); a no-op when neither is set.  The flags of all
    leaves come to the host in one copy, which waits for the work behind
    them; only after a hit are the leaves walked, to name the first
    offending one."""
    cfg = get_config()
    if not (cfg.nan_panic or cfg.inf_panic):
        return
    flat = _inexact_leaves(tree)
    if not flat:
        return
    nan_flag, inf_flag = _finite_flags([leaf for _, leaf in flat]).tolist()
    has_nan = cfg.nan_panic and nan_flag
    has_inf = cfg.inf_panic and inf_flag
    if not (has_nan or has_inf):
        return
    for path, leaf in flat:
        if has_nan and bool(torch.isnan(leaf).any()):
            raise NonFiniteError(f"NaN detected in {label} at {path}")
        if has_inf and bool(torch.isinf(leaf).any()):
            raise NonFiniteError(f"Inf detected in {label} at {path}")
    raise NonFiniteError(f"non-finite value detected in {label}")


def enable_debug_nans(enable: bool = True) -> None:
    """Trap NaNs at op granularity: autograd's anomaly mode with its NaN
    check, the counterpart of ``jax_debug_nans``.  Unlike JAX's flag it
    checks the backward's ops only (each gradient function's outputs),
    and it reads every value on the host, so while it is on every captured
    step runs as its plain function (``train/capture.py``)."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


class StepTimer:
    """Wall-clock timing of steps, with compile-step detection: the first
    step of a signature includes its compile (in the port, its first eager
    run and, on the card, the capture that follows), so the first timed
    step is recorded apart (``compile_s``) and left out of the step
    statistics.  The clock is the host's: a step that returns before the
    card has finished is timed to its return."""

    def __init__(self):
        self.compile_s: Optional[float] = None
        self.steps = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    @contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if self.compile_s is None:
            self.compile_s = dt
        else:
            self.steps += 1
            self.total_s += dt
            self.min_s = min(self.min_s, dt)
            self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    def summary(self) -> dict:
        return {
            "compile_s": self.compile_s,
            "steps": self.steps,
            "mean_step_s": self.mean_s,
            "min_step_s": self.min_s if self.steps else None,
            "max_step_s": self.max_s if self.steps else None,
        }


@dataclasses.dataclass
class ProfilerTrace:
    """What :func:`trace` yields: ``path`` is the Chrome-trace JSON file,
    written when the block ends; ``profile`` the ``torch.profiler.profile``
    object (its ``key_averages()`` after the block)."""

    path: str
    profile: Any = None


@contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host ops, and the card's
    kernels and copies when a card is present), exported as Chrome-trace
    JSON (Perfetto, ``chrome://tracing``) into ``logdir``, also when the
    block raises.  Yields a :class:`ProfilerTrace`."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    result = ProfilerTrace(os.path.join(
        logdir, f"torch_profile_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
    result.profile = profile(activities=activities)
    result.profile.start()
    try:
        yield result
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            from deeplearning4j_tpu_torch.train.capture import device_synchronize
            device_synchronize()
        result.profile.stop()
        result.profile.export_chrome_trace(result.path)
