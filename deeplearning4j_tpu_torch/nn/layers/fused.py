"""Fused ResNet v1 bottleneck (port of
``deeplearning4j_tpu/nn/layers/fused.py``).

1x1 reduce → 3x3 → 1x1 expand (+ optional 1x1 projection shortcut) as one
layer, so that the three (or four) 1x1 convs run through
:func:`deeplearning4j_tpu_torch.ops.kernels.conv_bn.matmul_bn_act`:

  * the 3x3's BN+ReLU is applied in the expand conv's kernel prologue;
  * the expand/projection BNs fold into the final residual-add + ReLU.

A stride lands as the strided slice ``x[:, ::sh, ::sw, :]`` before the
1x1 reduce, as in the JAX layer; the 3x3 is a plain ``conv2d`` at
stride 1 (:func:`conv3x3_stage`, one function so that a caller can watch
the stage's inputs and outputs).  In train mode each BN uses its batch
statistics: the 1x1 convs' come from the kernel's s1/s2 epilogue (so
gradients flow back through them into the kernel's backward), the 3x3's
from one reduction of its output; the variance is the one-pass
E[y^2] - E[y]^2 clamped at 0, and the running mean/var move by ``decay``
(returned detached).  In a data-parallel step
(``nn.layers.base.DataShard``) the sums and the row count are the global
batch's, summed over the ranks by one differentiable all-reduce per BN,
so every rank folds the same statistics and moves the same running
ones.  In eval mode BN uses the running statistics.  Param and state keys are the
JAX layer's (``W_a``, ``gamma_a``, ``mean_a``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.config import dtype_policy
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, current_shard, register_layer
from deeplearning4j_tpu_torch.ops.kernels.conv_bn import matmul_bn_act


def _fold(mean, var, gamma, beta, eps):
    """(mean, var, gamma, beta) → per-channel (a, b): bn(x) = x*a + b."""
    a = gamma * torch.rsqrt(var + eps)
    return a, beta - mean * a


def conv3x3_stage(y1, a1, b1, w, shape, *, train: bool):
    """The bottleneck's 3x3 stage, the function of the ``conv3x3_bn_act``
    kernel, as the JAX layer computes it: the normalize pass
    ``relu(y1*a1 + b1)`` in y1's dtype, the stride-1 SAME 3x3 conv with
    ``w`` (HWIO; symmetric padding for an odd kernel), and in train mode
    the batch statistics Σy, Σy² as one reduction of its output in the
    stats dtype.  ``y1`` is the reduce conv's output [m, C] over an
    (n, h, w) = ``shape`` grid; returns y2 [m, Cout] (contiguous) and
    (s1, s2), None in eval mode."""
    n, hb, wb = shape
    cdt = y1.dtype
    z1 = torch.relu(y1 * a1.to(cdt) + b1.to(cdt)).reshape(n, hb, wb, -1)
    y2 = F.conv2d(z1.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y2 = y2.permute(0, 2, 3, 1).reshape(n * hb * wb, w.shape[-1]).contiguous()
    if not train:
        return y2, None, None
    y2f = y2.to(torch.float64 if cdt == torch.float64 else torch.float32)
    return y2, y2f.sum(0), (y2f * y2f).sum(0)


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

    def _stats(self, name, s1, s2, m, state, new_state, train):
        """Batch (train) or running (eval) mean/var; train also moves the
        running statistics in ``new_state``."""
        if not train:
            return state[f"mean_{name}"], state[f"var_{name}"]
        shard = current_shard()
        if shard is not None and shard.reduce is not None:
            # data parallel: the global batch's sums and rows, in one
            # all-reduce whose backward sums ds1, ds2 over the ranks before
            # the backward kernel folds them into dy
            c = s1.shape[0]
            total = shard.reduce(torch.cat([s1, s2, s1.new_full((1,), m)]))
            s1, s2, m = total[:c], total[c:2 * c], total[2 * c]
        mean = s1 / m
        # one-pass E[y^2] - E[y]^2 can go slightly negative from f32
        # cancellation on a near-constant channel; clamp before the rsqrt
        var = torch.clamp_min(s2 / m - mean * mean, 0.0)
        for stat, batch in (("mean", mean), ("var", var)):
            key = f"{stat}_{name}"
            new_state[key] = (self.decay * state[key] + (1.0 - self.decay) * batch).detach()
        return mean, var

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        policy = dtype_policy()
        cdt = policy.compute_dtype
        sdt = torch.float64 if cdt == torch.float64 else torch.float32
        f3 = self.filters[2]
        sh, sw = self.stride
        xs = x[:, ::sh, ::sw, :] if (sh, sw) != (1, 1) else x
        n, hb, wb, c_in = xs.shape
        m = n * hb * wb
        x2d = xs.to(cdt).reshape(m, c_in).contiguous()

        def W(name):
            return params[f"W_{name}"].to(cdt).contiguous()

        new_state = dict(state)

        def bn_fold(name, s1, s2):
            mean, var = self._stats(name, s1, s2, m, state, new_state, train)
            return _fold(mean.to(sdt), var.to(sdt), params[f"gamma_{name}"].to(sdt),
                         params[f"beta_{name}"].to(sdt), self.eps)

        # ---- 1x1 reduce; its BN+ReLU is one pass ahead of the 3x3 conv
        y1, s1a, s2a = matmul_bn_act(x2d, W("a"))
        a1, b1 = bn_fold("a", s1a, s2a)

        # ---- 3x3 with the reduce conv's BN+ReLU ahead of it
        y2, s1b, s2b = conv3x3_stage(y1, a1, b1, W("b3"), (n, hb, wb), train=train)
        a2, b2 = bn_fold("b3", s1b, s2b)

        # ---- 1x1 expand: the 3x3's BN+ReLU rides the kernel prologue
        y3, s1c, s2c = matmul_bn_act(y2, W("c"), a2, b2, relu_in=True)
        a3, b3 = bn_fold("c", s1c, s2c)

        # ---- shortcut, then expand/proj BN + residual add + ReLU
        if self.project:
            yp, s1p, s2p = matmul_bn_act(x2d, W("proj"))
            ap, bp = bn_fold("proj", s1p, s2p)
            sc = yp * ap.to(cdt) + bp.to(cdt)
        else:
            sc = x2d
        out = torch.relu(y3 * a3.to(cdt) + b3.to(cdt) + sc)
        return out.reshape(n, hb, wb, f3).to(policy.output_dtype), new_state
