"""Convolutional, pooling and spatial layers (port of
``deeplearning4j_tpu/nn/layers/conv.py``): ``ConvolutionLayer``
("truncate", "strict", "causal" and "same"; input dropout on training
passes), ``SubsamplingLayer`` and ``GlobalPoolingLayer`` (max, avg, sum
and pnorm; global pooling with the JAX package's optional mask),
``ZeroPaddingLayer`` and ``LocalResponseNormalization``, in eval and
train mode (autograd,
through cuDNN on the card, gives their backward; the JAX package leaves
these to XLA too).

Activations stay NHWC and conv weights HWIO, as in the JAX package.  At
the torch op the NHWC tensor is viewed as NCHW with ``permute`` (a
channels-last view, no copy) and the weight is permuted to OIHW.  A
quantized ``ConvolutionLayer`` (``nn/quantize.py``) widens its int8
kernel to the compute dtype on read, as the JAX package does.

JAX's "SAME" padding puts ``total // 2`` before and the rest after,
which ``torch.nn`` cannot express when the two differ, so SAME pads are
applied explicitly with ``F.pad``.  Pooling pads as ``lax.reduce_window``
does, with its init value: ``-inf`` for max, 0 for the sums behind avg,
sum and pnorm, so a pad never counts; avg divides by the window's size
(``avg_pool_include_pad``) or by the count of real elements in it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.quantize import dequantize_weight


def _pair(v) -> tuple:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _out_dim(size: int, k: int, s: int, p: int, d: int, mode: str) -> int:
    eff_k = (k - 1) * d + 1
    if mode == "same":
        return -(-size // s)
    return (size + 2 * p - eff_k) // s + 1


def _same_pads(size: int, k: int, s: int, d: int = 1) -> tuple:
    """(before, after) padding of XLA's SAME for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@register_layer("conv2d")
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2-D convolution over NHWC with an HWIO kernel."""

    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    dilation: Any = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def _dims(self):
        return _pair(self.kernel_size), _pair(self.stride), _pair(self.padding), _pair(self.dilation)

    def get_output_type(self, input_type: InputType) -> InputType:
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = self._dims()
        h = _out_dim(input_type.height, kh, sh, ph, dh, self.convolution_mode)
        w = _out_dim(input_type.width, kw, sw, pw, dw, self.convolution_mode)
        return InputType.convolutional(h, w, self.n_out)

    def init_params(self, gen, input_type):
        (kh, kw), _, _, _ = self._dims()
        c_in = input_type.channels
        params = {"W": self._init_weight(gen, (kh, kw, c_in, self.n_out),
                                         kh * kw * c_in, kh * kw * self.n_out)}
        if self.has_bias:
            params["b"] = self._init_bias((self.n_out,))
        return params

    def _weight(self, params):
        """The HWIO kernel as stored, or widened from int8 ``W_q`` and its
        per-channel ``W_scale`` to the compute dtype for a quantized net
        (``nn/quantize.py``)."""
        if "W_q" in params:
            return dequantize_weight(params["W_q"], params["W_scale"],
                                     dtype_policy().compute_dtype)
        return params["W"]

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        (kh, kw), stride, pad, dilation = self._dims()
        cdt = dtype_policy().compute_dtype
        x = x.to(cdt)
        if self.convolution_mode == "same":
            pt, pb = _same_pads(x.shape[1], kh, stride[0], dilation[0])
            pl, pr = _same_pads(x.shape[2], kw, stride[1], dilation[1])
            if pt != pb or pl != pr:
                x = F.pad(x, (0, 0, pl, pr, pt, pb))
                pad = (0, 0)
            else:
                pad = (pt, pl)
        elif self.convolution_mode not in ("truncate", "strict", "causal"):
            # the 2-D layer pads every other mode explicitly and symmetrically
            raise NotImplementedError(f"convolution_mode {self.convolution_mode!r}")
        y = _nhwc(F.conv2d(_nchw(x), self._weight(params).to(cdt).permute(3, 2, 0, 1),
                           stride=stride, padding=pad, dilation=dilation))
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        y = activations.get(self.activation or "identity")(y)
        return y.to(dtype_policy().output_dtype), state


@register_layer("subsampling")
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """2-D pooling: max, avg, sum or pnorm over NHWC windows."""

    pooling_type: str = "max"  # max | avg | sum | pnorm
    kernel_size: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2
    avg_pool_include_pad: bool = False

    def has_params(self) -> bool:
        return False

    def get_output_type(self, input_type: InputType) -> InputType:
        (kh, kw), (sh, sw), (ph, pw) = _pair(self.kernel_size), _pair(self.stride), _pair(self.padding)
        h = _out_dim(input_type.height, kh, sh, ph, 1, self.convolution_mode)
        w = _out_dim(input_type.width, kw, sw, pw, 1, self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        kind = self.pooling_type.lower()
        if kind not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(f"unknown pooling type {self.pooling_type}")
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        if self.convolution_mode == "same":
            pt, pb = _same_pads(x.shape[1], kh, sh)
            pl, pr = _same_pads(x.shape[2], kw, sw)
        else:
            ph, pw = _pair(self.padding)
            pt, pb, pl, pr = ph, ph, pw, pw
        pads = (0, 0, pl, pr, pt, pb)
        if kind == "max":
            y = F.max_pool2d(_nchw(F.pad(x, pads, value=float("-inf"))), (kh, kw), (sh, sw))
            return _nhwc(y), state

        def window_sum(t):
            return F.avg_pool2d(_nchw(F.pad(t, pads)), (kh, kw), (sh, sw), divisor_override=1)

        if kind == "pnorm":
            p = float(self.pnorm)
            return _nhwc(window_sum(x.abs() ** p) ** (1.0 / p)), state
        y = window_sum(x)
        if kind == "avg":
            if self.avg_pool_include_pad:
                y = y / (kh * kw)
            else:
                # the count of real (non-pad) elements in each window
                y = y / window_sum(torch.ones_like(x[:1, :, :, :1])).clamp_min(1.0)
        return _nhwc(y), state


@register_layer("zero_padding")
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """padding: (top, bottom, left, right), or (h, w) symmetric."""

    padding: Any = (1, 1, 1, 1)

    def has_params(self) -> bool:
        return False

    def _pads(self):
        p = self.padding
        if isinstance(p, int):
            return (p, p, p, p)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        return tuple(p)

    def get_output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self._pads()
        return InputType.convolutional(input_type.height + t + b, input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer("global_pooling")
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial (or time) dims: max, avg, sum or
    pnorm, with the JAX package's optional mask (masked max over ``-inf``
    fill)."""

    pooling_type: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self) -> bool:
        return False

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind in ("cnn", "cnn3d"):
            return InputType.feed_forward(input_type.channels)
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        return input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        kind = self.pooling_type.lower()
        if kind not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(f"unknown pooling type {self.pooling_type}")
        axes = tuple(range(1, x.ndim - 1))
        p = float(self.pnorm)
        if mask is None:
            if kind == "max":
                return x.amax(dim=axes), state
            if kind == "avg":
                return x.mean(dim=axes), state
            if kind == "sum":
                return x.sum(dim=axes), state
            return (x.abs() ** p).sum(dim=axes) ** (1.0 / p), state
        # the mask as given (f32 under a bf16 x promotes the sums to f32,
        # as in JAX): a bf16 mask would round a count such as 3000
        m = mask
        while m.ndim < x.ndim:
            m = m[..., None]
        if kind == "max":
            return torch.where(m > 0, x, float("-inf")).amax(dim=axes), state
        if kind == "avg":
            return (x * m).sum(dim=axes) / m.sum(dim=axes).clamp_min(1.0), state
        if kind == "sum":
            return (x * m).sum(dim=axes), state
        return ((x * m).abs() ** p).sum(dim=axes) ** (1.0 / p), state


@register_layer("lrn")
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Local response normalization across the channels of NHWC input:
    ``x / (k + alpha * sum)^beta``, the sum of x^2 over a window of ``n``
    channels centred on each channel, zero-padded by ``n // 2`` (alpha is
    not divided by n, unlike ``F.local_response_norm``).  DL4J's
    defaults: k=2, n=5, alpha=1e-4, beta=0.75."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self) -> bool:
        return False

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        half, c = self.n // 2, x.shape[-1]
        sq = F.pad(x * x, (half, half))
        summed = sq[..., 0:c]
        for i in range(1, self.n):
            summed = summed + sq[..., i:i + c]
        return x / (self.k + self.alpha * summed) ** self.beta, state
