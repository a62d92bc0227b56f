"""Normalization and parametric activation layers (port of
``deeplearning4j_tpu/nn/layers/norm.py``): ``LayerNormalization`` over
the last axis with a learned gain and bias, and ``PReLULayer``, a learned
negative slope per channel.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer("layer_norm")
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Normalize over the channel (last) axis: the mean and the biased
    variance in x's dtype, as the JAX package computes them; the params'
    dtype (f32 under the bf16 policy) promotes the result."""

    eps: float = 1e-5
    use_bias: bool = True

    def _n(self, input_type: InputType) -> int:
        if input_type.kind == "cnn":
            return input_type.channels
        if input_type.kind == "rnn":
            return input_type.size
        return input_type.flat_size()

    def init_params(self, gen, input_type):
        n = self._n(input_type)
        params = {"gamma": torch.ones(n, dtype=self._param_dtype())}
        if self.use_bias:
            params["beta"] = torch.zeros(n, dtype=self._param_dtype())
        return params

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.eps) * params["gamma"]
        if self.use_bias:
            y = y + params["beta"]
        return y, state


@register_layer("prelu")
@dataclasses.dataclass
class PReLULayer(Layer):
    """Parametric ReLU: x where x >= 0, else alpha * x, with alpha of the
    input's channel shape (zeros at init)."""

    def init_params(self, gen, input_type):
        n = input_type.channels if input_type.kind == "cnn" else input_type.flat_size()
        return {"alpha": torch.zeros(n, dtype=self._param_dtype())}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.where(x >= 0, x, params["alpha"] * x), state
