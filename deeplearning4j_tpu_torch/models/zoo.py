"""Zoo model builders (port of ``deeplearning4j_tpu/models/zoo.py``):
MLP-MNIST, LeNet, SimpleCNN, AlexNet, VGG-16, VGG-19, ResNet-50 and the
two recurrent nets (the UCI-HAR LSTM classifier and the char-RNN) so
far.  Each configuration is the JAX package's, layer for layer, so its
JSON matches the one that package writes.  Each factory takes
``device=``: the CUDA card by default, raising without one unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Optional

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, get_config
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer, DropoutLayer,
    FusedBottleneck, GlobalPoolingLayer, GravesLSTM, LastTimeStep, LocalResponseNormalization,
    OutputLayer, RnnOutputLayer, SubsamplingLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.train.updaters import Adam, Nesterovs

# The JAX package's default ResNet-50 updater, Nesterovs(0.1, 0.9)
_NESTEROVS = Nesterovs(0.1, 0.9)


def mlp_mnist(seed: int = 123, hidden: int = 500, hidden2: int = 100, updater: Any = None,
              device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """The dl4j-examples two-layer MNIST MLP: 784 -> dense ``hidden`` ->
    dense ``hidden2`` (relu) -> softmax 10, Xavier weights, l2 1e-4,
    ``Nesterovs(0.0015, 0.98)`` unless ``updater`` is given."""
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(updater or Nesterovs(0.0015, 0.98))
        .weight_init("xavier")
        .l2(1e-4)
        .list()
        .layer(DenseLayer(n_out=hidden, activation="relu"))
        .layer(DenseLayer(n_out=hidden2, activation="relu"))
        .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(784))
        .build(), device=device)


def lenet(seed: int = 123, height: int = 28, width: int = 28, channels: int = 1,
          num_classes: int = 10, updater: Any = None,
          device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """DL4J's LeNet (zoo ``LeNet.java``): conv 5x5x20 -> max pool 2 ->
    conv 5x5x50 -> max pool 2 -> dense 500 (relu) -> softmax, "same"
    convolutions, Xavier weights, ``Adam(1e-3)`` unless ``updater`` is
    given."""
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(updater or Adam(1e-3))
        .weight_init("xavier")
        .list()
        .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                convolution_mode="same", activation="identity"))
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                convolution_mode="same", activation="identity"))
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
        .layer(DenseLayer(n_out=500, activation="relu"))
        .layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.convolutional(height, width, channels))
        .build(), device=device)


def simple_cnn(seed: int = 123, height: int = 48, width: int = 48, channels: int = 3,
               num_classes: int = 10, device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """DL4J's SimpleCNN: three blocks of 3x3 "same" conv (16, 32, 64;
    relu), BatchNormalization and a 2x2 max pool, then a ``DropoutLayer``
    (retain 0.5), dense 256 and the softmax, He weights, ``Adam(1e-3)``."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(Adam(1e-3))
         .weight_init("relu")
         .list())
    for n_out in (16, 32, 64):
        b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                 convolution_mode="same", activation="relu"))
        b.layer(BatchNormalization())
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
    b.layer(DropoutLayer(dropout=0.5))
    b.layer(DenseLayer(n_out=256, activation="relu"))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(height, width, channels))
    return MultiLayerNetwork(b.build(), device=device)


def alexnet(seed: int = 123, num_classes: int = 1000,
            device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """DL4J's one-tower AlexNet (zoo ``AlexNet.java``) on 224x224x3: five
    convolutions with LRN after the first two, three max pools, two
    dense 4096 with dropout (retain 0.5) on their inputs, the softmax;
    normal weights, l2 5e-4, ``Nesterovs(1e-2, 0.9)``."""
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(Nesterovs(1e-2, 0.9))
        .weight_init("normal")
        .l2(5e-4)
        .list()
        .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                activation="relu"))
        .layer(LocalResponseNormalization())
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5), convolution_mode="same",
                                activation="relu", bias_init=1.0))
        .layer(LocalResponseNormalization())
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), convolution_mode="same",
                                activation="relu"))
        .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), convolution_mode="same",
                                activation="relu", bias_init=1.0))
        .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), convolution_mode="same",
                                activation="relu", bias_init=1.0))
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
        .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
        .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
        .layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.convolutional(224, 224, 3))
        .build(), device=device)


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


def _vgg(convs_per_block, seed: int, num_classes: int, device: Any) -> MultiLayerNetwork:
    """224x224x3 NHWC, five blocks of 3x3 "same" convs (64, 128, 256, 512
    and 512 channels, ``convs_per_block`` each) each closed by a 2x2 max
    pool, dense 4096, 4096 and the softmax output, He-normal weights,
    ``Nesterovs(1e-2, 0.9)``; not initialised yet."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(Nesterovs(1e-2, 0.9))
         .weight_init("relu")
         .list())
    for n_out, convs in zip((64, 128, 256, 512, 512), convs_per_block):
        for _ in range(convs):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     convolution_mode="same", activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(224, 224, 3))
    return MultiLayerNetwork(b.build(), device=device)


def vgg16(seed: int = 123, num_classes: int = 1000,
          device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """VGG-16 (VGG16.java parity): 13 convs, two or three a block
    (``_vgg``); a ``MultiLayerNetwork`` on ``device`` (the CUDA card by
    default; raises without one unless ``device="cpu"``)."""
    return _vgg((2, 2, 3, 3, 3), seed, num_classes, device)


def vgg19(seed: int = 123, num_classes: int = 1000,
          device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """VGG-19 (VGG19.java parity): VGG-16 with four convs in each of the
    256- and 512-channel blocks."""
    return _vgg((2, 2, 4, 4, 4), seed, num_classes, device)


# ------------------------------------------------------------------ RNN zoo
def lstm_classifier(seed: int = 123, n_in: int = 9, n_classes: int = 6,
                    timesteps: Optional[int] = 128, hidden: int = 128, graves: bool = True,
                    updater: Any = None, device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """The UCI-HAR sequence classifier (BASELINE config 3): GravesLSTM (or
    LSTM) -> LastTimeStep -> OutputLayer(softmax, MCXENT), Adam(5e-3),
    gradients clipped element-wise at 0.5; a ``MultiLayerNetwork`` on
    ``device``."""
    cell = GravesLSTM(n_out=hidden) if graves else LSTM(n_out=hidden)
    return MultiLayerNetwork(
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(updater or Adam(5e-3))
        .weight_init("xavier")
        .gradient_normalization("clip_element_wise_absolute_value", 0.5)
        .list()
        .layer(LastTimeStep(underlying=cell))
        .layer(OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(n_in, timesteps))
        .build(), device=device)


def text_gen_lstm(seed: int = 123, vocab_size: int = 77, hidden: int = 256,
                  timesteps: Optional[int] = None, layers: int = 2,
                  device: Any = DEFAULT_DEVICE) -> MultiLayerNetwork:
    """The char-RNN (DL4J's TextGenerationLSTM): ``layers`` stacked
    GravesLSTM and a per-timestep softmax, Adam(2e-3), gradients clipped
    element-wise at 1.0, trained by tBPTT over segments of 50 steps; a
    ``MultiLayerNetwork`` on ``device``."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(Adam(2e-3))
         .weight_init("xavier")
         .gradient_normalization("clip_element_wise_absolute_value", 1.0)
         .list())
    for _ in range(layers):
        b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.recurrent(vocab_size, timesteps))
    b.backprop_type("tbptt", 50, 50)
    return MultiLayerNetwork(b.build(), device=device)
