"""Graph vertices (port of ``deeplearning4j_tpu/nn/vertices.py``): the
``GraphVertex`` base, its JSON registry, ``ElementWiseVertex`` (the
residual adds) and ``AttentionVertex``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.ops.attention import multi_head_attention

_VERTEX_REGISTRY: dict[str, type] = {}


def register_vertex(name: str):
    def deco(cls):
        cls.TYPE_NAME = name
        _VERTEX_REGISTRY[name] = cls
        return cls
    return deco


def vertex_from_dict(d: dict) -> "GraphVertex":
    d = dict(d)
    type_name = d.pop("type")
    cls = _VERTEX_REGISTRY.get(type_name)
    if cls is None:
        raise KeyError(f"unknown vertex type '{type_name}'; registered: {sorted(_VERTEX_REGISTRY)}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class GraphVertex:
    TYPE_NAME = "vertex"

    def apply(self, inputs: list[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def get_output_type(self, input_types: list[InputType]) -> InputType:
        return input_types[0]

    def to_dict(self) -> dict:
        out = {"type": self.TYPE_NAME}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        return out


@register_vertex("elementwise")
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise Add/Subtract/Product/Average/Max/Min over equal-shaped
    inputs."""

    op: str = "add"

    def apply(self, inputs):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op in ("subtract", "sub"):
            out = inputs[0] - inputs[1]
        elif op in ("product", "mul"):
            for x in inputs[1:]:
                out = out * x
        elif op in ("average", "avg"):
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        elif op == "min":
            for x in inputs[1:]:
                out = torch.minimum(out, x)
        else:
            raise ValueError(f"unknown elementwise op '{self.op}'")
        return out


@register_vertex("attention")
@dataclasses.dataclass
class AttentionVertex(GraphVertex):
    """Multi-head dot-product attention without projections (they are
    the Dense layers before it): 1 input is self attention over
    [B, T, H*Dh], 3 are (queries, keys, values).  ``causal`` adds the
    autoregressive mask; ``use_flash`` None routes by sequence length
    (the flash kernels from 1024), an explicit value wins."""

    n_heads: int = 1
    causal: bool = False
    use_flash: Optional[bool] = None
    flash_block: int = 0

    def apply(self, inputs):
        if len(inputs) == 1:
            q = k = v = inputs[0]
        elif len(inputs) == 3:
            q, k, v = inputs
        else:
            raise ValueError("AttentionVertex takes 1 (self) or 3 (q,k,v) inputs")
        return multi_head_attention(q, k, v, n_heads=self.n_heads, causal=self.causal,
                                    use_flash=self.use_flash, flash_block=self.flash_block)

    def get_output_type(self, input_types):
        q, v = input_types[0], input_types[-1]
        return InputType.recurrent(v.size, q.timesteps)   # q's steps, v's width
