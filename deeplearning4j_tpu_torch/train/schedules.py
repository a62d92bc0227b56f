"""Learning-rate schedules (port of ``deeplearning4j_tpu/train/schedules.py``).

ND4J's ``ISchedule`` implementations (fixed, exponential, inverse, poly,
sigmoid, step, map, cycle and ramp), each a dataclass with the JAX
package's field names, field order and JSON type name.  A schedule is a
function of a device tensor: ``value_at(step)`` takes a 0-dim int32
tensor (the updater's own count, on the params' device) and returns a
0-dim float32 tensor on the same device, with no host read and no Python
float of the step.  A captured step (``train/capture.py``) replays its
CUDA graph with the count that the graph itself advances, so a rate read
on the host at capture would be frozen into every replay.

``__call__`` first divides the count by ``steps_per_epoch`` (floor), the
JAX package's epoch keying.  The values carry the JAX package's bits in
f32: optax calls a schedule inside the jitted step, so each formula is
written as XLA's optimizer leaves it there.  A division by a constant is
a product with the constant's f32 reciprocal, constant factors fold into
one f32 constant, ``x ** 2`` is ``x * x``, ``c / x ** p`` is
``c * x ** -p``, a product added to a term is one fused multiply-add
(:func:`_fma`); the sigmoid's ``exp`` is the one XLA computes on the CPU
(:func:`xla_exp`), and ``pow`` is taken of 0-dim tensors, whose scalar
path is libm's, as XLA's is.

Note the field order: ``steps_per_epoch`` is every schedule's first
field, as in the JAX package, so give the others by name
(``StepSchedule(initial_value=1e-2, decay_rate=0.5, step=8)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Schedule = Callable[[Any], Any]

_REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        cls.TYPE_NAME = name
        _REGISTRY[name] = cls
        return cls
    return deco


def is_schedule_dict(value) -> bool:
    """Whether ``value`` is a schedule's JSON dict."""
    return isinstance(value, dict) and value.get("type") in _REGISTRY


def from_dict(d: dict) -> "BaseSchedule":
    d = dict(d)
    type_name = d.pop("type")
    cls = _REGISTRY.get(type_name)
    if cls is None:
        raise KeyError(f"unknown schedule type {type_name!r}; registered: {sorted(_REGISTRY)}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


def _f32(value: float) -> float:
    """``value`` rounded to float32, as a Python float (exact in float64);
    host constants are made in numpy, so a schedule's call puts nothing
    of the host's into a tensor."""
    return float(np.float32(value))


# XLA's CPU exp for f32: the Cephes polynomial, every multiply-add fused
_EXP_LOG2E, _EXP_C1, _EXP_C2 = _f32(1.44269504088896341), _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))
_EXP_LO, _EXP_HI = _f32(-87.8), _f32(88.8)


def _recip(value: float) -> float:
    """The f32 reciprocal of ``value``, as XLA folds ``x / value``."""
    return float(np.float32(1.0) / np.float32(value))


def _fold(a: float, b: float) -> float:
    """The f32 product of two f32 constants, as XLA folds ``(x * a) * b``."""
    return float(np.float32(a) * np.float32(b))


def _pow(x: torch.Tensor, power: float) -> torch.Tensor:
    """``x ** power`` as XLA simplifies it (``x`` at 1, ``x * x`` at 2)."""
    if power == 1.0:
        return x
    if power == 2.0:
        return x * x
    return torch.pow(x, _const(power, x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the product of two f32 values is
    exact in f64, so the f64 sum rounded to f32 is the fused result."""
    return (a.double() * (b.double() if torch.is_tensor(b) else b)
            + (c.double() if torch.is_tensor(c) else c)).float()


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor as XLA computes it on the CPU (and so
    as the JAX package's schedules compute it there): the input clamped
    to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    the remainder reduced in two parts, a degree-5 polynomial, times 2^n."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    z = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, r, c)
    z = _fma(z, r * r, r)
    return (1.0 + z) * torch.ldexp(torch.ones_like(z), n.to(torch.int32))


def _as_count(step) -> torch.Tensor:
    return step if torch.is_tensor(step) else torch.tensor(step, dtype=torch.int32)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 constant on ``like``'s device, made by a fill on that
    device (a host tensor copied over could not be captured)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@dataclasses.dataclass
class BaseSchedule:
    TYPE_NAME = "base"
    steps_per_epoch: int = 1  # 1: keyed by iteration (ScheduleType.ITERATION)

    def value_at(self, step: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, step) -> torch.Tensor:
        return self.value_at(_as_count(step) // max(self.steps_per_epoch, 1))

    def to_dict(self) -> dict:
        out = {"type": self.TYPE_NAME}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, BaseSchedule) else v
        return out


@register("fixed")
@dataclasses.dataclass
class FixedSchedule(BaseSchedule):
    value: float = 0.001

    def value_at(self, step):
        return _const(self.value, step)


@register("exponential")
@dataclasses.dataclass
class ExponentialSchedule(BaseSchedule):
    """lr = initial * gamma^t (``ExponentialSchedule.java``)."""
    initial_value: float = 0.1
    gamma: float = 0.99

    def value_at(self, step):
        return self.initial_value * torch.pow(_const(self.gamma, step), step.to(torch.float32))


@register("inverse")
@dataclasses.dataclass
class InverseSchedule(BaseSchedule):
    """lr = initial / (1 + gamma*t)^power (``InverseSchedule.java``)."""
    initial_value: float = 0.1
    gamma: float = 0.99
    power: float = 1.0

    def value_at(self, step):
        base = _fma(step.to(torch.float32), _f32(self.gamma), 1.0)
        if self.power in (1.0, 2.0):
            return torch.div(_const(self.initial_value, step), _pow(base, self.power))
        return self.initial_value * torch.pow(base, _const(-self.power, step))


@register("poly")
@dataclasses.dataclass
class PolySchedule(BaseSchedule):
    """lr = initial * (1 - t/maxIter)^power (``PolySchedule.java``)."""
    initial_value: float = 0.1
    power: float = 1.0
    max_iter: int = 1000

    def value_at(self, step):
        frac = torch.clamp_max(step.to(torch.float32) * _recip(max(self.max_iter, 1)), 1.0)
        return self.initial_value * _pow(1.0 - frac, self.power)


@register("sigmoid")
@dataclasses.dataclass
class SigmoidSchedule(BaseSchedule):
    """lr = initial / (1 + exp(-gamma*(t - stepSize))) (``SigmoidSchedule.java``)."""
    initial_value: float = 0.1
    gamma: float = 0.1
    step_size: int = 100

    def value_at(self, step):
        return torch.div(_const(self.initial_value, step),
                         1.0 + xla_exp(-self.gamma * (step - self.step_size).to(torch.float32)))


@register("step")
@dataclasses.dataclass
class StepSchedule(BaseSchedule):
    """lr = initial * decayRate^floor(t/step) (``StepSchedule.java``)."""
    initial_value: float = 0.1
    decay_rate: float = 0.5
    step: float = 100.0

    def value_at(self, step):
        exponent = torch.floor(step.to(torch.float32) * _recip(self.step))
        return self.initial_value * torch.pow(_const(self.decay_rate, step), exponent)


@register("map")
@dataclasses.dataclass
class MapSchedule(BaseSchedule):
    """Explicit {step: lr} map, the last value holding (``MapSchedule.java``);
    the lookup is a chain of ``where`` s on the device."""
    values: dict = dataclasses.field(default_factory=dict)

    def value_at(self, step):
        items = sorted((int(k), float(v)) for k, v in self.values.items())
        if not items:
            return _const(0.001, step)
        out = _const(items[0][1], step)
        for k, v in items:
            out = torch.where(step >= k, _const(v, step), out)
        return out


@register("cycle")
@dataclasses.dataclass
class CycleSchedule(BaseSchedule):
    """1-cycle schedule (``CycleSchedule.java``): a linear ramp from initial
    to max over the first half, back down, then annealing in the last
    ``annealing_frac`` of the cycle."""
    initial_value: float = 0.001
    max_value: float = 0.01
    cycle_length: int = 1000
    annealing_frac: float = 0.1

    def value_at(self, step):
        anneal_start = int(self.cycle_length * (1.0 - self.annealing_frac))
        pos = torch.remainder(step, max(self.cycle_length, 1))
        half = max(anneal_start // 2, 1)
        slope = _fold(self.max_value - self.initial_value, _recip(half))
        up = _fma(pos.to(torch.float32), slope, _f32(self.initial_value))
        down = _fma((pos - half).to(torch.float32), -slope, _f32(self.max_value))
        anneal_slope = _fold(_recip(max(self.cycle_length - anneal_start, 1)), 0.99)
        anneal = self.initial_value * _fma((pos - anneal_start).to(torch.float32), -anneal_slope,
                                           1.0)
        return torch.where(pos < half, up, torch.where(pos < anneal_start, down, anneal))


@register("ramp")
@dataclasses.dataclass
class RampSchedule(BaseSchedule):
    """Linear warm-up over the first ``num_iterations`` steps of the
    ``underlying`` schedule (``RampSchedule.java``)."""
    underlying: Any = None
    num_iterations: int = 100

    def __post_init__(self):
        if isinstance(self.underlying, dict):
            self.underlying = from_dict(self.underlying)

    def value_at(self, step):
        base = (self.underlying.value_at(step) if self.underlying
                else _const(1.0, step))
        warm = base * (step + 1).to(torch.float32) * _recip(self.num_iterations)
        return torch.where(step >= self.num_iterations, base, warm)


def as_schedule(value) -> Schedule:
    """A float (a fixed rate), a schedule, its JSON dict, or a callable."""
    if isinstance(value, BaseSchedule):
        return value
    if is_schedule_dict(value):
        return from_dict(value)
    if callable(value):
        return value
    return FixedSchedule(value=float(value))
