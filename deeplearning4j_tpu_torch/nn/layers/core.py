"""Core feed-forward layers (port of
``deeplearning4j_tpu/nn/layers/core.py``): ``DenseLayer``,
``OutputLayer`` (with its loss, ``compute_score_array``),
``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer``,
``EmbeddingSequenceLayer`` and ``BatchNormalization`` (which the JAX
package also keeps in its ``core.py``), in eval and train mode.

Dense weights keep the JAX layout ``W [nIn, nOut]``; the product is
``x @ W + b`` in the policy's compute dtype.  A quantized layer
(``nn/quantize.py``: int8 ``W_q`` and f32 ``W_scale`` in place of ``W``)
runs its product through ``ops.kernels.quant_matmul.int8_matmul``.  A
dense layer with ``dropout`` set drops its input on training passes
(DL4J's retain probability, ``Layer._maybe_dropout``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops.kernels import quant_matmul


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

    def pre_output(self, params, state, x, *, train=False, rng=None):
        x = self._maybe_dropout(x, train, rng)
        policy = dtype_policy()
        quantized = "W_q" in params   # nn.quantize: per-channel int8 weights
        n_in = (params["W_q"] if quantized else params["W"]).shape[0]
        if x.ndim > 2 and x.shape[-1] != n_in:
            x = x.reshape(x.shape[0], -1)  # CNN→FF flatten (NHWC order)
        if quantized:
            # the int8 weight streams one byte per weight; the dequant is
            # fused into the product (the CUDA kernel on the card)
            xc = x.to(policy.compute_dtype)
            y = quant_matmul.int8_matmul(xc.reshape(-1, n_in).contiguous(), params["W_q"],
                                         params["W_scale"])
            y = y.reshape(xc.shape[:-1] + (y.shape[-1],))
        else:
            y = torch.matmul(x.to(policy.compute_dtype),
                             params["W"].to(policy.compute_dtype))
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        return y.to(policy.output_dtype)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        z = self.pre_output(params, state, x, train=train, rng=rng)
        return activations.get(self.activation or "identity")(z), state


@register_layer("output")
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head; ``apply`` returns the activated output,
    ``compute_score_array`` pairs the pre-activation with the loss, and
    ``apply_and_score`` (a training forward) does both from one product,
    and so from one dropout mask."""

    loss: Any = "mcxent"

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            raise ValueError(
                "OutputLayer cannot follow a recurrent layer — use "
                "RnnOutputLayer for per-timestep output")
        return InputType.feed_forward(self.n_out)

    def compute_score_array(self, params, state, x, labels, *, train=False, rng=None,
                            mask=None):
        """Per-example loss."""
        return self._score(self.pre_output(params, state, x, train=train, rng=rng), labels,
                           mask)

    def apply_and_score(self, params, state, x, labels, *, train=False, rng=None, mask=None):
        """``apply`` and ``compute_score_array`` from one pre-activation:
        ``(output, state, per-example loss)``."""
        z = self.pre_output(params, state, x, train=train, rng=rng)
        y = activations.get(self.activation or "identity")(z)
        return y, state, self._score(z, labels, mask)

    def _score(self, z, labels, mask):
        """The loss math (softmax, log) runs in at least f32, so a bf16
        output policy keeps the score path exact."""
        z = z.to(torch.promote_types(z.dtype, torch.float32))
        return losses.get(self.loss)(labels, z, self.activation or "identity", mask)


@register_layer("activation")
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Standalone activation."""

    def has_params(self) -> bool:
        return False

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return activations.get(self.activation or "identity")(x), state


@register_layer("dropout")
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Standalone dropout; ``dropout`` is the retain probability, as in
    DL4J."""

    def has_params(self) -> bool:
        return False

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self._maybe_dropout(x, train, rng), state


@register_layer("embedding")
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index -> vector lookup, a Dense over one-hot run as a gather of the
    rows of ``W [n_in, n_out]`` (in the table's dtype), plus ``b`` and the
    activation.  Indices of shape [B] or [B, 1] give [B, n_out]; [B, T]
    gives [B, T, n_out].  A quantized table (``W_q`` int8 rows, per-column
    ``W_scale``, from ``nn.quantize``) gathers int8 rows, widens them to
    f32, scales them and casts to the policy's compute dtype, as the JAX
    package's gather does."""

    n_in: int = 0   # vocab size
    n_out: int = 0
    has_bias: bool = True

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.flat_size()
        params = {"W": self._init_weight(gen, (n_in, self.n_out), n_in, self.n_out)}
        if self.has_bias:
            params["b"] = self._init_bias((self.n_out,))
        return params

    def _lookup(self, params, idx):
        if "W_q" in params:
            y = params["W_q"][idx].to(torch.float32) * params["W_scale"].to(torch.float32)
            return y.to(dtype_policy().compute_dtype)
        return torch.nn.functional.embedding(idx, params["W"])

    def _embed(self, params, idx):
        y = self._lookup(params, idx.long())
        if self.has_bias:
            y = y + params["b"]
        return activations.get(self.activation or "identity")(y)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x if x.ndim != 2 or x.shape[-1] != 1 else x[..., 0]
        return self._embed(params, idx), state


@register_layer("embedding_sequence")
@dataclasses.dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """A sequence of indices, [B, T] or [B, T, 1], -> [B, T, n_out] (NTC)."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x if x.ndim != 3 or x.shape[-1] != 1 else x[..., 0]
        return self._embed(params, idx), state


@register_layer("batch_norm")
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch normalization over the channel (last) axis.  Train mode uses
    the batch's mean and biased variance (in at least f32) and returns the
    running statistics moved by ``decay`` (detached, values only); eval
    mode uses the running statistics.  Mean/var fold into a per-channel
    scale/shift in at least f32 (f64 under an f64 policy), applied in x's
    own dtype."""

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

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if train:
            axes = tuple(range(x.ndim - 1))
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = x32.mean(dim=axes)
            var = x32.var(dim=axes, unbiased=False)
            state = {"mean": (self.decay * state["mean"] + (1.0 - self.decay) * mean).detach(),
                     "var": (self.decay * state["var"] + (1.0 - self.decay) * var).detach()}
        else:
            mean, var = state["mean"], state["var"]
        sdt = torch.promote_types(mean.dtype, torch.float32)
        scale = torch.rsqrt(var.to(sdt) + self.eps)
        shift = -mean.to(sdt) * scale
        if params:
            gamma = params["gamma"].to(sdt)
            scale = scale * gamma
            shift = shift * gamma + params["beta"].to(sdt)
        y = x * scale.to(x.dtype) + shift.to(x.dtype)
        return activations.get(self.activation or "identity")(y), state
