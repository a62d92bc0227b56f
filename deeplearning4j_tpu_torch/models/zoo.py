"""Zoo model builders (port of ``deeplearning4j_tpu/models/zoo.py``):
ResNet-50 and VGG-16 so far.  Each configuration is the JAX package's,
layer for layer, so its JSON matches the one that package writes.
"""

from __future__ import annotations

from typing import Any

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, get_config
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer, FusedBottleneck,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.train.updaters import Nesterovs

# The JAX package's default ResNet-50 updater, Nesterovs(0.1, 0.9)
_NESTEROVS = Nesterovs(0.1, 0.9)


def _conv_bn(gb, name, n_out, kernel, stride, input_name, activation="identity",
             mode="same"):
    gb.add_layer(f"{name}_conv",
                 ConvolutionLayer(n_out=n_out, kernel_size=kernel, stride=stride,
                                  convolution_mode=mode, has_bias=False,
                                  activation="identity"),
                 input_name)
    gb.add_layer(f"{name}_bn", BatchNormalization(activation=activation),
                 f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(gb, name, in_name, filters, stride, project):
    """Unfused ResNet v1 bottleneck: 1x1 reduce → 3x3 → 1x1 expand, +shortcut."""
    f1, f2, f3 = filters
    x = _conv_bn(gb, f"{name}_a", f1, (1, 1), stride, in_name, activation="relu")
    x = _conv_bn(gb, f"{name}_b", f2, (3, 3), (1, 1), x, activation="relu")
    x = _conv_bn(gb, f"{name}_c", f3, (1, 1), (1, 1), x, activation="identity")
    if project:
        shortcut = _conv_bn(gb, f"{name}_proj", f3, (1, 1), stride, in_name,
                            activation="identity")
    else:
        shortcut = in_name
    gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def resnet50(seed: int = 123, num_classes: int = 1000, height: int = 224,
             width: int = 224, channels: int = 3, updater: Any = None,
             fused: bool | None = None, device: Any = DEFAULT_DEVICE) -> ComputationGraph:
    """ResNet-50 v1 ([3, 4, 6, 3] bottlenecks, NHWC) as a
    ``ComputationGraph`` on ``device`` (the CUDA card by default; raises
    without one unless ``device="cpu"``), trained by ``updater`` (an
    updater of ``train.updaters`` or its JSON; ``Nesterovs(0.1, 0.9)`` by
    default) with l2 1e-4.  ``fused=True`` builds each
    block as one :class:`FusedBottleneck` (its 1x1 convs run through the
    ``matmul_bn_act`` kernel), ``False`` as ConvolutionLayer +
    BatchNormalization nodes; ``None`` follows ``config.fused_conv``."""
    if fused is None:
        fused = bool(get_config().fused_conv)
    gb = (NeuralNetConfiguration.builder()
          .seed(seed)
          .updater(updater or _NESTEROVS)
          .weight_init("relu")
          .l2(1e-4)
          .graph()
          .add_inputs("in")
          .set_input_types(InputType.convolutional(height, width, channels)))
    gb.add_layer("stem_pad", ZeroPaddingLayer(padding=(3, 3)), "in")
    x = _conv_bn(gb, "stem", 64, (7, 7), (2, 2), "stem_pad", activation="relu",
                 mode="truncate")
    gb.add_layer("stem_pool",
                 SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                  stride=(2, 2), convolution_mode="same"), x)
    x = "stem_pool"
    stages = [
        ("res2", [64, 64, 256], 3, (1, 1)),
        ("res3", [128, 128, 512], 4, (2, 2)),
        ("res4", [256, 256, 1024], 6, (2, 2)),
        ("res5", [512, 512, 2048], 3, (2, 2)),
    ]
    for stage_name, filters, blocks, first_stride in stages:
        for i in range(blocks):
            stride = first_stride if i == 0 else (1, 1)
            if fused:
                gb.add_layer(f"{stage_name}_{i}",
                             FusedBottleneck(filters=tuple(filters),
                                             stride=stride, project=i == 0),
                             x)
                x = f"{stage_name}_{i}"
            else:
                x = _bottleneck(gb, f"{stage_name}_{i}", x, filters,
                                stride, project=i == 0)
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                    loss="mcxent"), "avgpool")
    gb.set_outputs("out")
    return ComputationGraph(gb.build(), device=device)


def vgg16(seed: int = 123, num_classes: int = 1000,
          device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """VGG-16 (VGG16.java parity): 224x224x3 NHWC, 13 3x3 "same" convs in
    5 blocks each closed by a 2x2 max pool, dense 4096, 4096 and the
    softmax output, He-normal weights, ``Nesterovs(1e-2, 0.9)``; a
    ``MultiLayerNetwork`` on ``device`` (the CUDA card by default; raises
    without one unless ``device="cpu"``), not initialised yet."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(Nesterovs(1e-2, 0.9))
         .weight_init("relu")
         .list())
    for n_out, convs in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(convs):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     convolution_mode="same", activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(224, 224, 3))
    return MultiLayerNetwork(b.build(), device=device)
