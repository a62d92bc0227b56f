"""Core feed-forward layers, inference only (port of
``deeplearning4j_tpu/nn/layers/core.py``): ``DenseLayer``,
``OutputLayer``, ``ActivationLayer`` and ``BatchNormalization`` (which
the JAX package also keeps in its ``core.py``).

Dense weights keep the JAX layout ``W [nIn, nOut]``; the product is
``x @ W + b`` in the policy's compute dtype.  The int8 ``W_q`` branch
of the JAX ``DenseLayer`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer("dense")
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected: y = act(x @ W + b).  W: [nIn, nOut]."""

    n_out: int = 0
    has_bias: bool = True

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type):
        n_in = input_type.size if input_type.kind == "rnn" else input_type.flat_size()
        params = {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}
        if self.has_bias:
            params["b"] = self._init_bias((self.n_out,))
        return params

    def pre_output(self, params, state, x):
        policy = dtype_policy()
        n_in = params["W"].shape[0]
        if x.ndim > 2 and x.shape[-1] != n_in:
            x = x.reshape(x.shape[0], -1)  # CNN→FF flatten (NHWC order)
        y = torch.matmul(x.to(policy.compute_dtype),
                         params["W"].to(policy.compute_dtype))
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        return y.to(policy.output_dtype)

    def apply(self, params, state, x, *, train=False, mask=None):
        self._inference_only(train)
        z = self.pre_output(params, state, x)
        return activations.get(self.activation or "identity")(z), state


@register_layer("output")
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head; ``apply`` returns the activated output.  The
    loss name is kept for the config and used by no inference path."""

    loss: Any = "mcxent"

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            raise ValueError(
                "OutputLayer cannot follow a recurrent layer — use "
                "RnnOutputLayer for per-timestep output")
        return InputType.feed_forward(self.n_out)


@register_layer("activation")
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Standalone activation."""

    def has_params(self) -> bool:
        return False

    def apply(self, params, state, x, *, train=False, mask=None):
        return activations.get(self.activation or "identity")(x), state


@register_layer("batch_norm")
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch normalization over the channel (last) axis, eval mode: the
    running mean/var fold into a per-channel scale/shift in f32, applied
    in x's own dtype."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    use_gamma_beta: bool = True

    def _num_features(self, input_type: InputType) -> int:
        if input_type.kind in ("cnn", "cnn3d"):
            return input_type.channels
        return input_type.flat_size() if input_type.kind != "rnn" else input_type.size

    def init_params(self, gen, input_type):
        n = self._num_features(input_type)
        if not self.use_gamma_beta or self.lock_gamma_beta:
            return {}
        dt = self._param_dtype()
        return {"gamma": torch.ones(n, dtype=dt), "beta": torch.zeros(n, dtype=dt)}

    def init_state(self, input_type):
        n = self._num_features(input_type)
        dt = self._param_dtype()
        return {"mean": torch.zeros(n, dtype=dt), "var": torch.ones(n, dtype=dt)}

    def apply(self, params, state, x, *, train=False, mask=None):
        self._inference_only(train)
        scale = torch.rsqrt(state["var"].float() + self.eps)
        shift = -state["mean"].float() * scale
        if params:
            gamma = params["gamma"].float()
            scale = scale * gamma
            shift = shift * gamma + params["beta"].float()
        y = x * scale.to(x.dtype) + shift.to(x.dtype)
        return activations.get(self.activation or "identity")(y), state
