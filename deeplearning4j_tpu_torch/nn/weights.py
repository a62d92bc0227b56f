"""Weight initializers (port of ``deeplearning4j_tpu/nn/weights.py``).

Every initializer takes ``(gen, shape, fan_in, fan_out, dtype)`` and
draws from the explicit CPU ``torch.Generator`` it is given, so a seed
gives the same weights whatever device they end up on.  The streams
differ from ``jax.random``'s: weights carried across from the JAX
package go through :mod:`deeplearning4j_tpu_torch.interop`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

InitFn = Callable[[torch.Generator, tuple, float, float, torch.dtype], torch.Tensor]

_REGISTRY: dict[str, InitFn] = {}


def register(name: str):
    def deco(fn: InitFn) -> InitFn:
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def get(name) -> InitFn:
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown weight init '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def _normal(gen, shape, std, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float32).mul_(std).to(dtype)


@register("relu")  # He normal: N(0, sqrt(2/fanIn))
def relu_init(gen, shape, fi, fo, dtype):
    return _normal(gen, shape, math.sqrt(2.0 / max(fi, 1.0)), dtype)

