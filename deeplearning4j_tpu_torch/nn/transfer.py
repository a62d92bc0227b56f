"""Transfer learning: surgery on a trained ``MultiLayerNetwork`` (port of
``deeplearning4j_tpu/nn/transfer.py``, DL4J's ``TransferLearning.Builder``
and ``FineTuneConfiguration``).

- ``FineTuneConfiguration``: hyperparameter overrides (updater,
  activation, weight init, dropout, l1/l2, seed, gradient normalization)
  cascaded over every layer of the new net, kept weights untouched.
- ``TransferLearning.builder(net)``: freeze every layer up to a feature
  extraction boundary (``set_feature_extractor``), remove output layers,
  change a layer's ``n_out`` (``nout_replace``: the next layer's input
  width follows from the input types at init), append new layers.

The builder clones the configuration through its JSON, builds and
initialises a new net on the source's device, and copies the kept
layers' params and state (BN running statistics too) into it.  They are
copied, never aliased: a step updates a net's tensors in place, so a
shared tensor would let one net's training change the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.updaters import tree_map


def _as_json(updater):
    return updater.to_dict() if hasattr(updater, "to_dict") else updater


@dataclasses.dataclass
class FineTuneConfiguration:
    """Network-wide overrides for the new net (``FineTuneConfiguration.Builder``)."""

    updater: Optional[Any] = None
    activation: Optional[Any] = None
    weight_init: Optional[Any] = None
    bias_init: Optional[float] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    seed: Optional[int] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    _LAYER_FIELDS = ("activation", "weight_init", "bias_init", "dropout",
                     "l1", "l2", "l1_bias", "l2_bias")

    def apply_to(self, conf: MultiLayerConfiguration) -> None:
        if self.updater is not None:
            conf.updater = _as_json(self.updater)
        if self.seed is not None:
            conf.seed = self.seed
        if self.gradient_normalization is not None:
            conf.gradient_normalization = self.gradient_normalization
        if self.gradient_normalization_threshold is not None:
            conf.gradient_normalization_threshold = self.gradient_normalization_threshold
        for layer in conf.layers:
            for field in self._LAYER_FIELDS:
                v = getattr(self, field)
                if v is not None and hasattr(layer, field):
                    setattr(layer, field, v)
            if self.updater is not None and getattr(layer, "updater", None) is not None:
                layer.updater = None    # the network-wide updater wins (DL4J's cascade)


def _clone_layer(layer: Layer) -> Layer:
    return layer_from_dict(layer.to_dict())


class TransferLearning:
    """``TransferLearning.Builder`` for a ``MultiLayerNetwork``."""

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearningBuilder":
        return TransferLearningBuilder(net)


class TransferLearningBuilder:
    def __init__(self, net: MultiLayerNetwork):
        if net.params_ is None:
            raise ValueError("the source network must be initialised or trained (init())")
        self._src = net
        # the cloned layers and each one's index in the source (None: new)
        self._layers: list[Layer] = [_clone_layer(layer) for layer in net.conf.layers]
        self._origin: list[Optional[int]] = list(range(len(self._layers)))
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._input_type = net.conf.input_type

    def fine_tune_configuration(self, ftc: FineTuneConfiguration) -> "TransferLearningBuilder":
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_index: int) -> "TransferLearningBuilder":
        """Freeze layers ``0..layer_index``, both included (``setFeatureExtractor``)."""
        self._freeze_until = layer_index
        return self

    def remove_output_layer(self) -> "TransferLearningBuilder":
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int) -> "TransferLearningBuilder":
        if n <= 0 or n > len(self._layers):
            raise ValueError(f"cannot remove {n} layers from a {len(self._layers)}-layer net")
        del self._layers[-n:]
        del self._origin[-n:]
        return self

    def add_layer(self, layer: Layer) -> "TransferLearningBuilder":
        self._layers.append(layer)
        self._origin.append(None)
        return self

    def nout_replace(self, layer_index: int, n_out: int,
                     weight_init: Optional[Any] = None) -> "TransferLearningBuilder":
        """Change layer ``layer_index``'s output width; its params and the
        next layer's are initialised anew (``nOutReplace``)."""
        layer = self._layers[layer_index]
        if not hasattr(layer, "n_out"):
            raise ValueError(f"layer {layer_index} ({layer.TYPE_NAME}) has no n_out")
        layer.n_out = n_out
        if weight_init is not None:
            layer.weight_init = weight_init
        self._origin[layer_index] = None
        if layer_index + 1 < len(self._layers):
            self._origin[layer_index + 1] = None
        return self

    def set_input_type(self, input_type) -> "TransferLearningBuilder":
        self._input_type = input_type
        return self

    def build(self) -> MultiLayerNetwork:
        src_conf = self._src.conf
        conf = MultiLayerConfiguration(
            layers=self._layers, input_type=self._input_type, seed=src_conf.seed,
            updater=src_conf.updater, gradient_normalization=src_conf.gradient_normalization,
            gradient_normalization_threshold=src_conf.gradient_normalization_threshold,
            mini_batch=src_conf.mini_batch, backprop_type=src_conf.backprop_type,
            tbptt_fwd_length=src_conf.tbptt_fwd_length,
            tbptt_back_length=src_conf.tbptt_back_length, dtype=src_conf.dtype)
        if self._fine_tune is not None:
            self._fine_tune.apply_to(conf)
        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(conf.layers))):
                conf.layers[i].frozen = True
        net = MultiLayerNetwork(conf, device=self._src.device).init()
        for i, origin in enumerate(self._origin):
            if origin is not None:
                net.params_[i] = tree_map(torch.Tensor.clone, self._src.params_[origin])
                net.state_[i] = tree_map(torch.Tensor.clone, self._src.state_[origin])
        return net
