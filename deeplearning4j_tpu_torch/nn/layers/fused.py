"""Fused ResNet v1 bottleneck, eval mode (port of
``deeplearning4j_tpu/nn/layers/fused.py``).

1x1 reduce → 3x3 → 1x1 expand (+ optional 1x1 projection shortcut) as one
layer, so that the three (or four) 1x1 convs run through
:func:`deeplearning4j_tpu_torch.ops.kernels.conv_bn.matmul_bn_act`:

  * the 3x3's BN+ReLU is applied in the expand conv's kernel prologue;
  * the expand/projection BNs fold into the final residual-add + ReLU.

A stride lands as the strided slice ``x[:, ::sh, ::sw, :]`` before the
1x1 reduce, as in the JAX layer; the 3x3 is a plain ``conv2d`` at
stride 1.  Only the eval branch is ported: BN uses the running
mean/var held in the layer state, and the statistics the kernel emits
are left unused until the training slice.  Param and state keys are the
JAX layer's (``W_a``, ``gamma_a``, ``mean_a``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops.kernels.conv_bn import matmul_bn_act


def _fold(mean, var, gamma, beta, eps):
    """(mean, var, gamma, beta) → per-channel (a, b): bn(x) = x*a + b."""
    a = gamma * torch.rsqrt(var + eps)
    return a, beta - mean * a


@register_layer("fused_bottleneck")
@dataclasses.dataclass
class FusedBottleneck(Layer):
    """ResNet v1 bottleneck whose 1x1 conv+BN pairs run through the
    ``matmul_bn_act`` kernel."""

    filters: Tuple[int, int, int] = (64, 64, 256)
    stride: Tuple[int, int] = (1, 1)
    project: bool = False
    decay: float = 0.9
    eps: float = 1e-5

    def get_output_type(self, input_type: InputType) -> InputType:
        sh, sw = self.stride
        return InputType.convolutional(-(-input_type.height // sh),
                                       -(-input_type.width // sw), self.filters[2])

    def _branches(self, c_in):
        f1, f2, f3 = self.filters
        out = [("a", (c_in, f1)), ("b3", (3, 3, f1, f2)), ("c", (f2, f3))]
        if self.project:
            out.append(("proj", (c_in, f3)))
        return out

    def init_params(self, gen, input_type):
        params: dict[str, Any] = {}
        dt = self._param_dtype()
        for name, shape in self._branches(input_type.channels):
            fan_in = shape[0] if len(shape) == 2 else shape[0] * shape[1] * shape[2]
            params[f"W_{name}"] = self._init_weight(gen, shape, fan_in, shape[-1])
            params[f"gamma_{name}"] = torch.ones(shape[-1], dtype=dt)
            params[f"beta_{name}"] = torch.zeros(shape[-1], dtype=dt)
        return params

    def init_state(self, input_type):
        state = {}
        dt = self._param_dtype()
        for name, shape in self._branches(input_type.channels):
            state[f"mean_{name}"] = torch.zeros(shape[-1], dtype=dt)
            state[f"var_{name}"] = torch.ones(shape[-1], dtype=dt)
        return state

    def apply(self, params, state, x, *, train=False, mask=None):
        self._inference_only(train)
        policy = dtype_policy()
        cdt = policy.compute_dtype
        sdt = torch.float64 if cdt == torch.float64 else torch.float32
        f1, f2, f3 = self.filters
        sh, sw = self.stride
        xs = x[:, ::sh, ::sw, :] if (sh, sw) != (1, 1) else x
        n, hb, wb, c_in = xs.shape
        m = n * hb * wb
        x2d = xs.to(cdt).reshape(m, c_in).contiguous()

        def W(name):
            return params[f"W_{name}"].to(cdt).contiguous()

        def bn_fold(name):
            return _fold(state[f"mean_{name}"].to(sdt), state[f"var_{name}"].to(sdt),
                         params[f"gamma_{name}"].to(sdt), params[f"beta_{name}"].to(sdt),
                         self.eps)

        # ---- 1x1 reduce; its BN+ReLU is one pass ahead of the 3x3 conv
        y1, _, _ = matmul_bn_act(x2d, W("a"))
        a1, b1 = bn_fold("a")
        z1 = torch.relu(y1 * a1.to(cdt) + b1.to(cdt)).reshape(n, hb, wb, f1)

        # ---- 3x3, stride 1, SAME (symmetric for an odd kernel)
        y2 = F.conv2d(z1.permute(0, 3, 1, 2), W("b3").permute(3, 2, 0, 1), padding=1)
        y2 = y2.permute(0, 2, 3, 1).reshape(m, f2).contiguous()
        a2, b2 = bn_fold("b3")

        # ---- 1x1 expand: the 3x3's BN+ReLU rides the kernel prologue
        y3, _, _ = matmul_bn_act(y2, W("c"), a2, b2, relu_in=True)
        a3, b3 = bn_fold("c")

        # ---- shortcut, then expand/proj BN + residual add + ReLU
        if self.project:
            yp, _, _ = matmul_bn_act(x2d, W("proj"))
            ap, bp = bn_fold("proj")
            sc = yp * ap.to(cdt) + bp.to(cdt)
        else:
            sc = x2d
        out = torch.relu(y3 * a3.to(cdt) + b3.to(cdt) + sc)
        return out.reshape(n, hb, wb, f3).to(policy.output_dtype), state
