"""Layer catalog of the port: config dataclasses with plain functions on
tensors, registered under the JAX package's JSON type names."""

from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    register_layer,
    layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    DenseLayer,
    OutputLayer,
    ActivationLayer,
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (
    ConvolutionLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
    GlobalPoolingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneck

__all__ = [
    "Layer", "register_layer", "layer_from_dict",
    "DenseLayer", "OutputLayer", "ActivationLayer", "BatchNormalization",
    "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer", "GlobalPoolingLayer",
    "FusedBottleneck",
]
