"""Configuration, dtype policy and device choice for the PyTorch port.

Mirrors ``deeplearning4j_tpu/config.py``: a ``DTypePolicy`` (params in
``param_dtype``, matmuls/convs in ``compute_dtype``, layer outputs in
``output_dtype``) and a ``Config`` carrying ``fused_conv``.  Unlike the
JAX package, nothing here reads the environment: settings change only
through :func:`set_config` and :func:`set_dtype_policy`.

Devices are explicit.  :func:`resolve_device` turns the ``device=``
argument of an entry point into a ``torch.device`` and raises when it
names a CUDA card that is not there; there is no silent CPU fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

DEFAULT_DEVICE = "cuda"


@dataclasses.dataclass
class DTypePolicy:
    """Mixed-precision policy.  ``f32`` (the default) keeps everything in
    float32; ``bf16`` keeps float32 params and computes and emits layer
    outputs in bfloat16."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    @classmethod
    def bf16(cls) -> "DTypePolicy":
        return cls(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                   output_dtype=torch.bfloat16)

    @classmethod
    def f32(cls) -> "DTypePolicy":
        return cls()


@dataclasses.dataclass
class Config:
    """Runtime knobs, with the JAX package's names and defaults.

    - ``fused_conv``: build the zoo's ResNet bottlenecks as
      ``FusedBottleneck`` layers, whose 1x1 convs run through the
      ``matmul_bn_act`` kernel; an explicit ``fused=`` argument to a zoo
      factory wins.
    - ``device_feed``: ``Trainer.fit`` stages each batch on the device
      through a ``DeviceFeeder`` (host work and the copy of batch N+1
      overlap step N).
    - ``prefetch_size``: how many staged batches that feeder keeps ready.
    - ``tracing``: enable span-based tracing (``obs.tracing``); a traced
      span waits on the card's stream where it attributes device time,
      so it is off by default.
    - ``trace_dir``: where span exports, flight-recorder dumps and
      profiler traces land when no path is given.
    - ``nan_panic``, ``inf_panic``: after every training step, check the
      params for a NaN (an Inf) and raise ``obs.profiler.NonFiniteError``
      naming the first offending leaf.  The check reads one pair of flags
      from the device, so it waits for the step: off by default.
    - ``profiling``: record a ``torch.profiler`` trace (Chrome-trace JSON)
      around ``Trainer.fit`` into ``trace_dir`` (``obs.profiler.trace``)."""

    fused_conv: bool = True
    device_feed: bool = True
    prefetch_size: int = 2
    tracing: bool = False
    trace_dir: str = "traces"
    nan_panic: bool = False
    inf_panic: bool = False
    profiling: bool = False


_config = Config()
_policy = DTypePolicy()


def get_config() -> Config:
    return _config


def set_config(**kwargs: Any) -> Config:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config key: {k}")
        setattr(_config, k, v)
    return _config


def dtype_policy() -> DTypePolicy:
    return _policy


def set_dtype_policy(policy: DTypePolicy) -> None:
    global _policy
    _policy = policy


def resolve_device(device: Any = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device
    and no card is present (callers that want the CPU say so)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
