"""NeuralNetConfiguration builder (port of ``deeplearning4j_tpu/nn/conf.py``).

Network-level defaults (activation, weight init, l1/l2, dropout, ...)
cascade into layers that leave them unset, and ``.graph()`` opens a
:class:`~deeplearning4j_tpu_torch.nn.graph.GraphBuilder`.  The updater
is held as its JSON dict (the JAX package's form), which
:func:`deeplearning4j_tpu_torch.train.updaters.from_dict` turns into an
updater when training starts.
"""

from __future__ import annotations

from typing import Any, Optional


class ShapeInferenceError(ValueError):
    """Shape inference failed at a specific layer or vertex; ``path``
    names it and ``cause`` keeps the underlying exception."""

    def __init__(self, path: str, cause: BaseException):
        self.path = path
        self.cause = cause
        super().__init__(f"shape inference failed at {path}: "
                         f"{type(cause).__name__}: {cause}")


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

    def graph(self):
        from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
        return GraphBuilder(self)
