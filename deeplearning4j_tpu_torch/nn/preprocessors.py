"""Input preprocessors (port of ``deeplearning4j_tpu/nn/preprocessors.py``):
the shape adapters a graph inserts between layer kinds, as far as the
ported layers need them.  Layouts are the JAX package's: NHWC for CNN
activations, NTC for recurrent ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.input_type import InputType


def expected_kind(layer) -> Optional[str]:
    """What input kind a layer wants; None = any."""
    from deeplearning4j_tpu_torch.nn.layers import attention as attn_mod
    from deeplearning4j_tpu_torch.nn.layers import conv as conv_mod
    from deeplearning4j_tpu_torch.nn.layers import recurrent as rnn_mod
    if isinstance(layer, attn_mod.SelfAttentionLayer):
        return "rnn"
    if isinstance(layer, (rnn_mod.BaseRecurrentLayer, rnn_mod.Bidirectional,
                          rnn_mod.LastTimeStep, rnn_mod.TimeDistributed,
                          rnn_mod.RnnOutputLayer, rnn_mod.RnnLossLayer)):
        return "rnn"
    if isinstance(layer, (conv_mod.ConvolutionLayer, conv_mod.SubsamplingLayer,
                          conv_mod.ZeroPaddingLayer)):
        return "cnn"
    return None


def adapt_type(current: InputType, layer) -> InputType:
    """Convert ``current`` to the kind ``layer`` expects (conf-time)."""
    want = expected_kind(layer)
    if want is None or current.kind == want:
        return current
    if want == "cnn" and current.kind == "cnn_flat":
        return InputType.convolutional(current.height, current.width, current.channels)
    if want == "cnn" and current.kind == "ff":
        raise ValueError(
            "cannot infer CNN dims from flat feed-forward input — use "
            "InputType.convolutional_flat(h, w, c) as the network input type")
    if want == "rnn" and current.kind == "ff":
        return InputType.recurrent(current.size, 1)
    if want == "rnn" and current.kind == "cnn":
        # CnnToRnn: rows become time, each row's W*C values a step's features
        return InputType.recurrent(current.width * current.channels, current.height)
    raise ValueError(f"no preprocessor from {current.kind} to {want}")


def adapt_array(x: torch.Tensor, current: InputType, layer) -> torch.Tensor:
    """Runtime twin of :func:`adapt_type`."""
    want = expected_kind(layer)
    if want is None or current.kind == want:
        return x
    if want == "cnn" and current.kind == "cnn_flat":
        return x.reshape(x.shape[0], current.height, current.width, current.channels)
    if want == "rnn" and current.kind == "ff":
        return x[:, None, :]
    if want == "rnn" and current.kind == "cnn":
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)
    raise ValueError(f"no preprocessor from {current.kind} to {want}")
