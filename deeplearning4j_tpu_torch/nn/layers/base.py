"""Base layer dataclass and JSON-subtype registry (port of
``deeplearning4j_tpu/nn/layers/base.py``).

A layer is a dataclass of hyperparameters plus plain functions on
tensors:

- ``init_params(gen, input_type) -> params``: a dict of CPU tensors drawn
  from the ``torch.Generator`` it is given (the graph moves them to its
  device);
- ``apply(params, state, x, *, train, mask) -> (y, new_state)``.

Field names and JSON type names are the JAX package's, so a config that
package wrote loads here.  ``updater`` and ``weight_noise`` are carried
through the JSON untouched: the serving slice does not train.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn import weights as weight_inits
from deeplearning4j_tpu_torch.nn.input_type import InputType

_LAYER_REGISTRY: dict[str, type] = {}


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
            out[f.name] = v
        return out

    # ---- impl API ----------------------------------------------------
    def init_params(self, gen: torch.Generator, input_type: InputType) -> dict:
        return {}

    def init_state(self, input_type: InputType) -> dict:
        return {}

    def apply(self, params: dict, state: dict, x: torch.Tensor, *,
              train: bool = False, mask: Optional[torch.Tensor] = None):
        raise NotImplementedError

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

    def _inference_only(self, train: bool) -> None:
        if train:
            raise NotImplementedError(
                f"{type(self).__name__}: the PyTorch port runs inference "
                f"only so far (train=True is not ported)")
