"""Base layer dataclass and JSON-subtype registry (port of
``deeplearning4j_tpu/nn/layers/base.py``).

A layer is a dataclass of hyperparameters plus plain functions on
tensors:

- ``init_params(gen, input_type) -> params``: a dict of CPU tensors drawn
  from the ``torch.Generator`` it is given (the graph moves them to its
  device);
- ``apply(params, state, x, *, train, rng, mask) -> (y, new_state)``;
  ``rng`` is the training step's random stream, a ``torch.Generator`` on
  the activations' device (``None`` at inference);
- ``transform_mask(mask)``: the per-timestep mask the next layer sees.

Field names and JSON type names are the JAX package's, so a config that
package wrote loads here.  ``dropout`` is DL4J's retain probability,
applied to the input of the layers that take it on training passes
(:meth:`Layer._maybe_dropout`).  ``regularization_penalty`` gives the
layer's l1/l2 score term for training.  ``updater`` (a per-layer
updater, or its JSON dict) and ``frozen`` are read by the trainer (a
frozen layer still runs in training mode: only its updates are zeroed);
``weight_noise`` is carried through the JSON but not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn import weights as weight_inits
from deeplearning4j_tpu_torch.nn.input_type import InputType

_LAYER_REGISTRY: dict[str, type] = {}


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's part of a data-parallel step: the ``rank``-th of
    ``size`` equal row blocks of the global batch.  ``reduce`` is the
    differentiable sum over the ranks (``parallel.mesh.MeshLayout.
    all_reduce_sum``) through which batch statistics become the global
    batch's; None keeps them per shard (``ParallelWrapper``'s averaging
    mode, whose replicas keep their own)."""

    rank: int
    size: int
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


_SHARD = threading.local()


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]):
    """Run the layers of this thread as ``shard`` of a data-parallel step
    (:func:`current_shard`); None is the single-process step."""
    prev = getattr(_SHARD, "value", None)
    _SHARD.value = shard
    try:
        yield
    finally:
        _SHARD.value = prev


def current_shard() -> Optional[DataShard]:
    """The :class:`DataShard` the layers of this thread run as, or None."""
    return getattr(_SHARD, "value", None)


def _keep_mask(shape: tuple, p: float, gen: torch.Generator, device) -> torch.Tensor:
    """Dropout's keep mask: each entry True with probability ``p``, drawn
    from ``gen`` on ``device`` (a generator on another device raises)."""
    return torch.rand(shape, generator=gen, device=device) < p


def register_layer(type_name: str):
    def deco(cls):
        cls.TYPE_NAME = type_name
        _LAYER_REGISTRY[type_name] = cls
        return cls
    return deco


def layer_from_dict(d: dict) -> "Layer":
    d = dict(d)
    type_name = d.pop("type")
    cls = _LAYER_REGISTRY.get(type_name)
    if cls is None:
        raise KeyError(f"unknown layer type '{type_name}'; registered: {sorted(_LAYER_REGISTRY)}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class Layer:
    """Base config.  ``None`` fields inherit the network-level default."""

    TYPE_NAME = "base"

    name: Optional[str] = None
    activation: Optional[Any] = None
    weight_init: Optional[Any] = None
    bias_init: Optional[float] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[Any] = None
    frozen: bool = False
    weight_noise: Optional[Any] = None

    # ---- conf API ----------------------------------------------------
    def inherit_defaults(self, defaults: dict) -> None:
        for field, value in defaults.items():
            if hasattr(self, field) and getattr(self, field) is None:
                setattr(self, field, value)

    def has_params(self) -> bool:
        return True

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def to_dict(self) -> dict:
        out = {"type": self.TYPE_NAME}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or callable(v):
                continue
            out[f.name] = v.to_dict() if hasattr(v, "to_dict") else v
        return out

    # ---- impl API ----------------------------------------------------
    def init_params(self, gen: torch.Generator, input_type: InputType) -> dict:
        return {}

    def init_state(self, input_type: InputType) -> dict:
        return {}

    def apply(self, params: dict, state: dict, x: torch.Tensor, *,
              train: bool = False, rng: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def transform_mask(self, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The ``[B, T]`` mask that reaches the next layer
        (``feedForwardMaskArray``): unchanged by default; a layer that
        consumes the time axis returns None."""
        return mask

    # ---- shared helpers ---------------------------------------------
    def _param_dtype(self):
        from deeplearning4j_tpu_torch.config import dtype_policy
        return dtype_policy().param_dtype

    def _init_weight(self, gen, shape, fan_in, fan_out):
        init = weight_inits.get(self.weight_init or "xavier")
        return init(gen, tuple(shape), float(fan_in), float(fan_out), self._param_dtype())

    def _init_bias(self, shape):
        value = self.bias_init if self.bias_init is not None else 0.0
        return torch.full(tuple(shape), float(value), dtype=self._param_dtype())

    def regularization_penalty(self, params: dict) -> torch.Tensor:
        """L1/L2 penalty for this layer's params (DL4J applies l2*w to the
        gradient, i.e. a 0.5*l2*||w||^2 score term); biases (``b``,
        ``*_b``, ``*bias*``) use the ``*_bias`` coefficients, every other
        param (BN gamma/beta included) ``l1``/``l2``."""
        penalty = torch.zeros((), dtype=torch.float32,
                              device=next(iter(params.values())).device)
        for pname, arr in params.items():
            is_bias = pname == "b" or pname.endswith("_b") or "bias" in pname
            l1 = (self.l1_bias if is_bias else self.l1) or 0.0
            l2 = (self.l2_bias if is_bias else self.l2) or 0.0
            if l1:
                penalty = penalty + l1 * arr.abs().sum()
            if l2:
                penalty = penalty + 0.5 * l2 * (arr * arr).sum()
        return penalty

    def _maybe_dropout(self, x: torch.Tensor, train: bool,
                       rng: Optional[torch.Generator]) -> torch.Tensor:
        """Input dropout with DL4J's retain probability p: keep each entry
        with probability p and scale it by 1/p, zero the rest; x as is at
        p >= 1, at inference or without a stream.  As a :class:`DataShard`
        the mask is the global batch's, cut to this shard's rows."""
        p = self.dropout
        if not train or p is None or p >= 1.0 or rng is None:
            return x
        shard = current_shard()
        if shard is None or shard.size == 1:
            keep = _keep_mask(tuple(x.shape), p, rng, x.device)
        else:
            # the global batch's mask from the shared stream, this shard's
            # rows of it: the single-process step's mask, as GSPMD's global
            # key gives the JAX package's sharded step
            b = x.shape[0]
            keep = _keep_mask((b * shard.size,) + tuple(x.shape[1:]), p, rng,
                              x.device)[shard.rank * b:(shard.rank + 1) * b]
        return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype, device=x.device))
