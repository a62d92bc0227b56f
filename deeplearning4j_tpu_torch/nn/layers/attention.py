"""Attention layers (port of ``deeplearning4j_tpu/nn/layers/attention.py``):
``SelfAttentionLayer`` and ``LearnedSelfAttentionLayer`` over NTC input.

The inner product is ``ops.attention.multi_head_attention``: the einsum
chain below sequence 1024, the flash kernels
(``ops/kernels/flash_attention.py``, forward and merged backward through
their ``autograd.Function``) from there on in f32 or bf16, or as
``use_flash`` says.  Projections are ``x @ W`` in the promoted dtype of x
and W, as JAX's einsum promotes: under the bf16 policy (f32 params) they
run in f32, with bf16 params in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops.attention import multi_head_attention


def _project(x, w):
    """``einsum("btc,cd->btd", x, w)`` in the promoted dtype of x and w."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


@register_layer("self_attention")
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self attention; ``project_input`` adds learned Q/K/V/O
    projections (needed when n_heads > 1), ``has_bias`` their biases.
    ``use_flash``: None routes by sequence length (flash from 1024), an
    explicit value wins; ``flash_block`` is the TPU kernel's tile knob and
    changes nothing here.  A ``mask`` [B, T] masks keys and zeroes masked
    query rows."""

    n_heads: int = 1
    head_size: int = 0
    project_input: bool = True
    has_bias: bool = False
    use_flash: Optional[bool] = None
    flash_block: int = 0

    def _proj(self, input_type: InputType) -> int:
        return self.n_heads * (self.head_size or input_type.size // self.n_heads)

    def get_output_type(self, input_type: InputType) -> InputType:
        out = self._proj(input_type) if self.project_input else input_type.size
        return InputType.recurrent(out, input_type.timesteps)

    def init_params(self, gen, input_type):
        if not self.project_input:
            return {}
        d, proj = input_type.size, self._proj(input_type)
        params = {"Wq": self._init_weight(gen, (d, proj), d, proj),
                  "Wk": self._init_weight(gen, (d, proj), d, proj),
                  "Wv": self._init_weight(gen, (d, proj), d, proj),
                  "Wo": self._init_weight(gen, (proj, proj), proj, proj)}
        if self.has_bias:
            for n in ("bq", "bk", "bv", "bo"):
                params[n] = torch.zeros(proj, dtype=self._param_dtype())
        return params

    def has_params(self) -> bool:
        return self.project_input

    def _qkv(self, params, queries, x):
        if not self.project_input:
            return queries, x, x
        q, k, v = (_project(queries, params["Wq"]), _project(x, params["Wk"]),
                   _project(x, params["Wv"]))
        if self.has_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        return q, k, v

    def _out(self, params, y):
        if not self.project_input:
            return y
        y = _project(y, params["Wo"])
        return y + params["bo"] if self.has_bias else y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        q, k, v = self._qkv(params, x, x)
        y = multi_head_attention(q, k, v, n_heads=self.n_heads if self.project_input else 1,
                                 mask=mask, use_flash=self.use_flash,
                                 flash_block=self.flash_block)
        return self._out(params, y), state


@register_layer("learned_self_attention")
@dataclasses.dataclass
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention of ``n_queries`` learned query vectors over the input:
    [B, n_queries, D] whatever the input's length.  A ``mask`` masks the
    keys only (``kv_mask``); the routing is the default one, by the
    longer of the two sequences, whatever ``use_flash`` says, as in the
    JAX package."""

    n_queries: int = 1

    def get_output_type(self, input_type: InputType) -> InputType:
        out = self._proj(input_type) if self.project_input else input_type.size
        return InputType.recurrent(out, self.n_queries)

    def has_params(self) -> bool:
        return True   # the learned queries are params even without projections

    def init_params(self, gen, input_type):
        params = super().init_params(gen, input_type)
        d = input_type.size
        params["Q"] = self._init_weight(gen, (self.n_queries, d), d, d)
        return params

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        queries = params["Q"].expand((x.shape[0],) + tuple(params["Q"].shape))
        q, k, v = self._qkv(params, queries, x)
        y = multi_head_attention(q, k, v, n_heads=self.n_heads if self.project_input else 1,
                                 kv_mask=mask)
        return self._out(params, y), state
