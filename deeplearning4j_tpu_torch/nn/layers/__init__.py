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
    DropoutLayer,
    EmbeddingLayer,
    EmbeddingSequenceLayer,
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (
    ConvolutionLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
    GlobalPoolingLayer,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneck
from deeplearning4j_tpu_torch.nn.layers.norm import LayerNormalization, PReLULayer
from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttentionLayer,
    LearnedSelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer,
    LSTM,
    GravesLSTM,
    SimpleRnn,
    GRU,
    Bidirectional,
    BidirectionalLastStep,
    LastTimeStep,
    TimeDistributed,
    RnnOutputLayer,
    RnnLossLayer,
)

__all__ = [
    "Layer", "register_layer", "layer_from_dict",
    "DenseLayer", "OutputLayer", "ActivationLayer", "DropoutLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "BatchNormalization",
    "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer", "GlobalPoolingLayer",
    "LocalResponseNormalization",
    "FusedBottleneck", "LayerNormalization", "PReLULayer", "SelfAttentionLayer",
    "LearnedSelfAttentionLayer",
    "BaseRecurrentLayer", "LSTM", "GravesLSTM", "SimpleRnn", "GRU", "Bidirectional",
    "BidirectionalLastStep", "LastTimeStep", "TimeDistributed", "RnnOutputLayer",
    "RnnLossLayer",
]
