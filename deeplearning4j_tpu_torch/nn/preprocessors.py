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
    from deeplearning4j_tpu_torch.nn.layers import conv as conv_mod
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
    raise ValueError(f"no preprocessor from {current.kind} to {want}")


def adapt_array(x: torch.Tensor, current: InputType, layer) -> torch.Tensor:
    """Runtime twin of :func:`adapt_type`."""
    want = expected_kind(layer)
    if want is None or current.kind == want:
        return x
    if want == "cnn" and current.kind == "cnn_flat":
        return x.reshape(x.shape[0], current.height, current.width, current.channels)
    raise ValueError(f"no preprocessor from {current.kind} to {want}")
