"""MultiLayerNetwork — the linear-stack network (port of
``deeplearning4j_tpu/nn/multilayer.py``): init and inference
(``output``, ``feed_forward``), parameter count, deep copy and summary.

Parameters and state are lists of per-layer dicts of tensors (the JAX
package's layout: NHWC activations, HWIO conv kernels, dense
``W [nIn, nOut]``) on the net's device.  A post-training-quantized net
(``nn/quantize.py``) is the same class with ``W_q``/``W_scale`` in place
of ``W`` and ``quantized_ == "int8"``.  Not ported yet: ``fit``,
``evaluate``, ``rnn_time_step``, ``save``/``load`` and recurrent layers
(a configuration with tBPTT raises).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from deeplearning4j_tpu_torch.nn import preprocessors
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration


class MultiLayerNetwork:
    """Layer stack on one device (``"cuda"`` unless the caller says
    otherwise; raises when that card is absent)."""

    def __init__(self, conf: MultiLayerConfiguration, device: Any = DEFAULT_DEVICE):
        if conf.backprop_type != "standard":
            raise NotImplementedError(
                f"backprop_type {conf.backprop_type!r} waits for the recurrent layers")
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self._types = conf.input_types()
        self.params_: Optional[list] = None     # per-layer param dicts
        self.state_: Optional[list] = None      # per-layer state dicts
        self.quantized_: Optional[str] = None   # "int8" after nn.quantize.quantize_net
        self.quantization_ = None               # its QuantizationReport

    # ------------------------------------------------------------- init
    def init(self, seed: Optional[int] = None, device: Any = None) -> "MultiLayerNetwork":
        """Draw parameters from a ``torch.Generator`` seeded with ``seed``
        (the config's seed by default), layer by layer, and place them on
        ``device`` (the net's device by default)."""
        if device is not None:
            self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.seed if seed is None else seed)
        params, state = [], []
        for layer, itype in zip(self.layers, self._types):
            params.append(layer.init_params(gen, itype) if layer.has_params() else {})
            state.append(layer.init_state(itype))
        self.params_ = [{k: t.to(self.device) for k, t in d.items()} for d in params]
        self.state_ = [{k: t.to(self.device) for k, t in d.items()} for d in state]
        return self

    def num_params(self) -> int:
        return sum(t.numel() for d in self.params_ for t in d.values())

    # ---------------------------------------------------------- forward
    def _forward(self, params, state, x, *, train: bool = False, mask=None, labels=None):
        """Full forward pass; returns ``(output, new_state, score_array)``,
        the score array (per-example loss of the last layer) None without
        labels."""
        new_state, score_array = [], None
        last = len(self.layers) - 1
        for i, (layer, itype) in enumerate(zip(self.layers, self._types)):
            x = preprocessors.adapt_array(x, itype_before(self, i, self._types), layer)
            if i == last and labels is not None and hasattr(layer, "apply_and_score"):
                x, s, score_array = layer.apply_and_score(params[i], state[i], x, labels,
                                                          train=train, mask=mask)
            else:
                x, s = layer.apply(params[i], state[i], x, train=train, mask=mask)
            new_state.append(s)
        return x, new_state, score_array

    def _as_tensor(self, a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=self.device)

    def output(self, x, mask=None) -> torch.Tensor:
        """Inference forward on the net's device; numpy or tensor input,
        tensor output."""
        with torch.inference_mode():
            return self._forward(self.params_, self.state_, self._as_tensor(x), train=False,
                                 mask=None if mask is None else self._as_tensor(mask))[0]

    def feed_forward(self, x, train: bool = False) -> list:
        """Every layer's activation, in order (``feedForward``)."""
        x, acts = self._as_tensor(x), []
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                x = preprocessors.adapt_array(x, itype_before(self, i, self._types), layer)
                x, _ = layer.apply(self.params_[i], self.state_[i], x, train=train)
                acts.append(x)
        return acts

    # ---------------------------------------------------------- misc
    def summary(self) -> str:
        lines = [f"{'idx':<4}{'type':<24}{'out shape':<20}{'params':<10}"]
        for i, (layer, itype) in enumerate(zip(self.layers, self._types)):
            out = layer.get_output_type(itype)
            n = sum(t.numel() for t in self.params_[i].values()) if self.params_ else 0
            lines.append(f"{i:<4}{layer.TYPE_NAME:<24}{str(out.batch_shape()):<20}{n:<10}")
        lines.append(f"Total params: {self.num_params() if self.params_ else 0}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A deep copy on the same device: configuration, parameters and
        state."""
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(self.conf.to_dict()),
                                device=self.device)
        if self.params_ is not None:
            net.params_ = [{k: t.clone() for k, t in d.items()} for d in self.params_]
            net.state_ = [{k: t.clone() for k, t in d.items()} for d in self.state_]
        return net


def itype_before(net: MultiLayerNetwork, i: int, types: list) -> Any:
    """InputType of the activation arriving at layer i (before adaptation)."""
    if i == 0:
        return net.conf.input_type
    return net.layers[i - 1].get_output_type(types[i - 1])
