"""Activation registry (port of ``deeplearning4j_tpu/nn/activations.py``).

Only the activations that the ported slices use are registered so far;
names match case-insensitively, and a callable passes through.
"""

from __future__ import annotations

from typing import Callable

import torch

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: dict[str, ActivationFn] = {}


def register(name: str) -> Callable[[ActivationFn], ActivationFn]:
    def deco(fn: ActivationFn) -> ActivationFn:
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def get(name) -> ActivationFn:
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown activation '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list[str]:
    return sorted(_REGISTRY)


register("identity")(lambda x: x)
register("relu")(torch.relu)
register("softmax")(lambda x: torch.softmax(x, dim=-1))
register("sigmoid")(torch.sigmoid)
register("tanh")(torch.tanh)
# jax.nn.gelu's default: the tanh approximation
register("gelu")(lambda x: torch.nn.functional.gelu(x, approximate="tanh"))
