"""NeuralNetConfiguration builder and MultiLayerConfiguration (port of
``deeplearning4j_tpu/nn/conf.py``).

Network-level defaults (activation, weight init, l1/l2, dropout, ...)
cascade into layers that leave them unset; ``.list()`` opens a
:class:`ListBuilder` for a layer stack (a
:class:`MultiLayerConfiguration`, whose ``input_types()`` infers each
layer's input and inserts the preprocessors between layer kinds), and
``.graph()`` a :class:`~deeplearning4j_tpu_torch.nn.graph.GraphBuilder`.
The updater is held as its JSON dict (the JAX package's form), which
:func:`deeplearning4j_tpu_torch.train.updaters.from_dict` turns into an
updater when training starts.  Both configurations' JSON is the JAX
package's, so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict


def layer_path(index: int, layer) -> str:
    """A layer's anchor in a stack config, ``layers[3] (DenseLayer 'fc1')``,
    for shape-inference errors."""
    cls = type(layer).__name__
    name = getattr(layer, "name", None)
    return f"layers[{index}] ({cls} {name!r})" if name else f"layers[{index}] ({cls})"


class ShapeInferenceError(ValueError):
    """Shape inference failed at a specific layer or vertex; ``path``
    names it and ``cause`` keeps the underlying exception."""

    def __init__(self, path: str, cause: BaseException):
        self.path = path
        self.cause = cause
        super().__init__(f"shape inference failed at {path}: "
                         f"{type(cause).__name__}: {cause}")


@dataclasses.dataclass
class MultiLayerConfiguration:
    """The built, serializable spec of a layer stack."""

    layers: list = dataclasses.field(default_factory=list)
    input_type: Optional[InputType] = None
    seed: int = 0
    updater: Optional[dict] = None   # the JAX package's updater JSON, carried as is
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    backprop_type: str = "standard"  # "standard" | "tbptt"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"

    def input_types(self) -> list[InputType]:
        """The InputType arriving at each layer, after the preprocessor
        that the layer's kind asks for."""
        return self._infer()[0]

    def output_type(self) -> InputType:
        return self._infer()[1]

    def _infer(self) -> tuple[list[InputType], InputType]:
        from deeplearning4j_tpu_torch.nn import preprocessors
        if self.input_type is None:
            raise ValueError("input_type not set — call set_input_type(...) on the builder")
        types, current = [], self.input_type
        for i, layer in enumerate(self.layers):
            try:
                current = preprocessors.adapt_type(current, layer)
                types.append(current)
                current = layer.get_output_type(current)
            except Exception as e:
                raise ShapeInferenceError(layer_path(i, layer), e) from e
        return types, current

    # ---- serde ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "layers": [layer.to_dict() for layer in self.layers],
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "seed": self.seed,
            "updater": self.updater,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
            "mini_batch": self.mini_batch,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "dtype": self.dtype,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            seed=d.get("seed", 0),
            updater=d.get("updater"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
            mini_batch=d.get("mini_batch", True),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            dtype=d.get("dtype", "float32"),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._seed = 0
        self._updater = None
        self._defaults: dict[str, Any] = {}
        self._grad_norm: Optional[str] = None
        self._grad_norm_threshold = 1.0
        self._mini_batch = True

    def seed(self, seed: int) -> "Builder":
        self._seed = int(seed)
        return self

    def updater(self, updater) -> "Builder":
        """An updater (``train.updaters``) or its JSON dict."""
        self._updater = updater.to_dict() if hasattr(updater, "to_dict") else updater
        return self

    def activation(self, act) -> "Builder":
        self._defaults["activation"] = act
        return self

    def weight_init(self, wi) -> "Builder":
        self._defaults["weight_init"] = wi
        return self

    def bias_init(self, b: float) -> "Builder":
        self._defaults["bias_init"] = b
        return self

    def dropout(self, retain_prob: float) -> "Builder":
        self._defaults["dropout"] = retain_prob
        return self

    def l1(self, v: float) -> "Builder":
        self._defaults["l1"] = v
        return self

    def l2(self, v: float) -> "Builder":
        self._defaults["l2"] = v
        return self

    def l1_bias(self, v: float) -> "Builder":
        self._defaults["l1_bias"] = v
        return self

    def l2_bias(self, v: float) -> "Builder":
        self._defaults["l2_bias"] = v
        return self

    def gradient_normalization(self, gn: str, threshold: float = 1.0) -> "Builder":
        self._grad_norm = gn
        self._grad_norm_threshold = threshold
        return self

    def mini_batch(self, v: bool) -> "Builder":
        self._mini_batch = v
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self)

    def graph(self):
        from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
        return GraphBuilder(self)


class ListBuilder:
    """``.list()``: layers in order, the network's input type, build."""

    def __init__(self, parent: Builder):
        self.parent = parent
        self._layers: list[Layer] = []
        self._input_type: Optional[InputType] = None

    def layer(self, layer: Layer) -> "ListBuilder":
        self._layers.append(layer)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def backprop_type(self, kind: str, fwd_length: int = 20,
                      back_length: int = 20) -> "ListBuilder":
        if kind != "standard":
            raise NotImplementedError(f"backprop_type {kind!r} waits for the recurrent layers")
        return self

    def build(self) -> MultiLayerConfiguration:
        p = self.parent
        for layer in self._layers:
            layer.inherit_defaults(p._defaults)
        return MultiLayerConfiguration(
            layers=self._layers, input_type=self._input_type, seed=p._seed,
            updater=p._updater, gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            mini_batch=p._mini_batch)
