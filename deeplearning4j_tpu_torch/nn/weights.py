"""Weight initializers (port of ``deeplearning4j_tpu/nn/weights.py``).

DL4J's ``WeightInit`` schemes: ZERO, ONES, NORMAL, UNIFORM, XAVIER,
XAVIER_UNIFORM, XAVIER_FAN_IN, LECUN_NORMAL, LECUN_UNIFORM, RELU (He
normal), RELU_UNIFORM (He uniform), SIGMOID_UNIFORM, IDENTITY,
VAR_SCALING_* and DISTRIBUTION (:func:`distribution`), with DL4J's fans
(for a dense weight [nIn, nOut], fanIn = nIn and fanOut = nOut; a conv's
include its receptive field).

Every initializer takes ``(gen, shape, fan_in, fan_out, dtype)`` and
draws from the explicit CPU ``torch.Generator`` it is given, so a seed
gives the same weights whatever device they end up on.  The streams
differ from ``jax.random``'s: the distributions are the same, the draws
are not; weights carried across from the JAX package go through
:mod:`deeplearning4j_tpu_torch.interop`.
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


def names() -> list[str]:
    return sorted(_REGISTRY)


# draws in f32, then cast, as jax.random draws in the requested dtype's
# f32 counterpart for bf16 params
def _normal(gen, shape, std, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float32).mul_(std).to(dtype)


def _uniform(gen, shape, a, dtype):
    return torch.empty(shape, dtype=torch.float32).uniform_(-a, a, generator=gen).to(dtype)


def _fan(f):
    return max(f, 1.0)


register("zero")(lambda gen, shape, fi, fo, dtype: torch.zeros(shape, dtype=dtype))
register("ones")(lambda gen, shape, fi, fo, dtype: torch.ones(shape, dtype=dtype))
register("normal")(  # DL4J NORMAL: N(0, 1/sqrt(fanIn))
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, 1.0 / math.sqrt(_fan(fi)), dtype))
register("uniform")(  # DL4J UNIFORM: U(-a, a), a = sqrt(3/fanIn)
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(3.0 / _fan(fi)), dtype))
register("xavier")(  # N(0, sqrt(2/(fanIn+fanOut)))
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(2.0 / _fan(fi + fo)), dtype))
register("xavier_uniform")(  # U(-a, a), a = sqrt(6/(fanIn+fanOut))
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(6.0 / _fan(fi + fo)), dtype))
register("xavier_fan_in")(  # N(0, sqrt(1/fanIn))
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, 1.0 / math.sqrt(_fan(fi)), dtype))
register("relu")(  # He normal: N(0, sqrt(2/fanIn))
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(2.0 / _fan(fi)), dtype))
register("relu_uniform")(  # He uniform: U(-a, a), a = sqrt(6/fanIn)
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(6.0 / _fan(fi)), dtype))
register("lecun_normal")(
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(1.0 / _fan(fi)), dtype))
register("lecun_uniform")(  # U(-a, a), a = sqrt(3/fanIn)
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(3.0 / _fan(fi)), dtype))
register("sigmoid_uniform")(  # U(-a, a), a = 4*sqrt(6/(fanIn+fanOut))
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, 4.0 * math.sqrt(6.0 / _fan(fi + fo)),
                                               dtype))


@register("identity")
def identity_init(gen, shape, fi, fo, dtype):
    if len(shape) == 2 and shape[0] == shape[1]:
        return torch.eye(shape[0], dtype=dtype)
    raise ValueError("IDENTITY weight init requires a square 2-D weight")


register("var_scaling_normal_fan_in")(
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(1.0 / _fan(fi)), dtype))
register("var_scaling_normal_fan_out")(
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(1.0 / _fan(fo)), dtype))
register("var_scaling_normal_fan_avg")(
    lambda gen, shape, fi, fo, dtype: _normal(gen, shape, math.sqrt(2.0 / _fan(fi + fo)), dtype))
register("var_scaling_uniform_fan_in")(
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(3.0 / _fan(fi)), dtype))
register("var_scaling_uniform_fan_out")(
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(3.0 / _fan(fo)), dtype))
register("var_scaling_uniform_fan_avg")(
    lambda gen, shape, fi, fo, dtype: _uniform(gen, shape, math.sqrt(6.0 / _fan(fi + fo)), dtype))


def distribution(dist: str, **kw) -> InitFn:
    """WeightInit.DISTRIBUTION: an explicit distribution
    (``org/deeplearning4j/nn/conf/distribution/``), with the reference's
    names and keyword defaults."""
    dist = dist.lower()
    f32 = torch.float32
    if dist in ("normal", "gaussian"):
        mean, std = kw.get("mean", 0.0), kw.get("std", 1.0)
        return lambda gen, shape, fi, fo, dtype: (
            mean + std * torch.randn(shape, generator=gen, dtype=f32)).to(dtype)
    if dist == "uniform":
        lo, hi = kw.get("lower", -1.0), kw.get("upper", 1.0)
        return lambda gen, shape, fi, fo, dtype: torch.empty(shape, dtype=f32).uniform_(
            lo, hi, generator=gen).to(dtype)
    if dist == "truncated_normal":  # N(0, 1) cut to [-2, 2], then scaled and shifted
        mean, std = kw.get("mean", 0.0), kw.get("std", 1.0)
        return lambda gen, shape, fi, fo, dtype: (mean + std * torch.nn.init.trunc_normal_(
            torch.empty(shape, dtype=f32), 0.0, 1.0, -2.0, 2.0, generator=gen)).to(dtype)
    if dist == "constant":
        value = kw.get("value", 0.0)
        return lambda gen, shape, fi, fo, dtype: torch.full(shape, float(value), dtype=dtype)
    if dist == "orthogonal":
        gain = kw.get("gain", 1.0)
        return lambda gen, shape, fi, fo, dtype: torch.nn.init.orthogonal_(
            torch.empty(shape, dtype=f32), gain, generator=gen).to(dtype)
    if dist == "binomial":
        n, p = kw.get("n", 1), kw.get("p", 0.5)
        return lambda gen, shape, fi, fo, dtype: torch.binomial(
            torch.full(shape, float(n)), torch.full(shape, float(p)), generator=gen).to(dtype)
    if dist == "log_normal":
        mean, std = kw.get("mean", 0.0), kw.get("std", 1.0)
        return lambda gen, shape, fi, fo, dtype: torch.exp(
            mean + std * torch.randn(shape, generator=gen, dtype=f32)).to(dtype)
    raise KeyError(f"unknown distribution '{dist}'")
