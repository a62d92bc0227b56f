"""MultiLayerNetwork — the linear-stack network (port of
``deeplearning4j_tpu/nn/multilayer.py``): init, inference (``output``,
``feed_forward``), training (``fit``, through
:class:`deeplearning4j_tpu_torch.train.Trainer`; ``score``), evaluation
(``evaluate``, ``evaluate_regression``, ``evaluate_roc``), the flat
parameter vector (``params``, ``set_params``), parameter count, deep copy
and summary.

Parameters and state are lists of per-layer dicts of tensors (the JAX
package's layout: NHWC activations, HWIO conv kernels, dense
``W [nIn, nOut]``) on the net's device.  A post-training-quantized net
(``nn/quantize.py``) is the same class with ``W_q``/``W_scale`` in place
of ``W`` and ``quantized_ == "int8"``.  Evaluation reads each batch's
output back to the host once and accumulates in numpy
(``deeplearning4j_tpu_torch.evaluation``).  A per-timestep mask goes
through each layer's ``transform_mask`` on its way down the stack; the
recurrent layers' carries thread through :meth:`MultiLayerNetwork._forward_impl`
(tBPTT) and :meth:`MultiLayerNetwork.rnn_time_step` (streaming).
``save``/``load`` write and read the JAX package's model zip
(``io/model_serializer.py``).  Not ported yet: ``trace_attrs``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from deeplearning4j_tpu_torch.nn import preprocessors
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map


class MultiLayerNetwork:
    """Layer stack on one device (``"cuda"`` unless the caller says
    otherwise; raises when that card is absent)."""

    def __init__(self, conf: MultiLayerConfiguration, device: Any = DEFAULT_DEVICE):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self._types = conf.input_types()
        self.params_: Optional[list] = None     # per-layer param dicts
        self.state_: Optional[list] = None      # per-layer state dicts
        self.quantized_: Optional[str] = None   # "int8" after nn.quantize.quantize_net
        self.quantization_ = None               # its QuantizationReport
        self.opt_state = None                   # the updater's state, once trained
        self.iteration = 0
        self.epoch = 0
        self._score = float("nan")              # the last step's loss (a device scalar)
        self._rnn_carries: Optional[list] = None  # rnn_time_step's stored state

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
        self.params_ = tree_map(lambda t: t.to(self.device), params)
        self.state_ = tree_map(lambda t: t.to(self.device), state)
        return self

    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params_))

    def params(self) -> torch.Tensor:
        """The flat parameter vector (``MultiLayerNetwork.params()``) on the
        net's device, in the JAX package's leaf order: layers in order,
        each layer's keys sorted, each tensor raveled in C order."""
        return flat_param_vector(self.params_, self.device)

    def set_params(self, params: list) -> None:
        """Replace the parameters with copies of ``params``, a list of
        per-layer dicts (tensors or arrays), on the net's device: training
        updates the net's tensors in place, so the caller's stay as given."""
        self.params_ = tree_map(lambda v: self._as_tensor(v).clone(), list(params))

    # ---------------------------------------------------------- forward
    def _forward(self, params, state, x, *, train: bool = False, rng=None, mask=None,
                 labels=None):
        """Full forward pass; returns ``(output, new_state, score_array)``,
        the score array (per-example loss of the last layer) None without
        labels.  ``rng``, the step's stream, feeds each layer's dropout in
        turn."""
        out, new_state, score_array, _ = self._forward_impl(
            params, state, x, None, train=train, rng=rng, mask=mask, labels=labels)
        return out, new_state, score_array

    def _forward_impl(self, params, state, x, carries, *, train: bool = False, rng=None,
                      mask=None, labels=None):
        """The forward with the recurrent carries threaded through:
        ``carries`` is a per-layer list (entries of other layers are
        ignored), or None to start every recurrent layer from zeros.  A
        recurrent layer starts from its carry detached, so state flows
        across tBPTT segments and gradients stop at their boundary.  The
        mask reaches each layer through the ``transform_mask`` of the layer
        before.  Returns ``(output, new_state, score_array, new_carries)``,
        ``new_carries`` None where a layer is not recurrent or ``carries``
        is None."""
        new_state, score_array = [], None
        new_carries = [None] * len(self.layers)
        last = len(self.layers) - 1
        for i, (layer, itype) in enumerate(zip(self.layers, self._types)):
            x = preprocessors.adapt_array(x, itype_before(self, i, self._types), layer)
            if i == last and labels is not None and hasattr(layer, "apply_and_score"):
                x, s, score_array = layer.apply_and_score(params[i], state[i], x, labels,
                                                          train=train, rng=rng, mask=mask)
            elif carries is not None and isinstance(layer, BaseRecurrentLayer):
                carry = carries[i]
                if carry is not None:
                    carry = tree_map(torch.Tensor.detach, carry)
                x, s, new_carries[i] = layer.apply_with_carry(
                    params[i], state[i], x, carry, train=train, rng=rng, mask=mask)
            else:
                x, s = layer.apply(params[i], state[i], x, train=train, rng=rng, mask=mask)
            new_state.append(s)
            mask = layer.transform_mask(mask)
        return x, new_state, score_array, new_carries

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

    # ---------------------------------------------------------- rnn API
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference with stored state (``rnnTimeStep``): ``x`` is
        ``[B, T, C]``, or ``[B, C]`` for one step (then the output is
        ``[B, nOut]``); each recurrent layer's carry goes on from the call
        before.  The cells run as in training, without dropout and
        without the output cast, their carries in x's dtype."""
        x = self._as_tensor(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = [None] * len(self.layers)
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                x = preprocessors.adapt_array(x, itype_before(self, i, self._types), layer)
                if isinstance(layer, BaseRecurrentLayer):
                    carry = self._rnn_carries[i]
                    if carry is None:
                        carry = layer.init_carry(x.shape[0], x.dtype, x.device)
                    x, self._rnn_carries[i] = layer._scan(self.params_[i], x, None, carry)
                else:
                    x, _ = layer.apply(self.params_[i], self.state_[i], x, train=False)
        return x[:, -1, :] if single and x.ndim == 3 else x

    # ---------------------------------------------------------- training
    def score(self) -> float:
        """The loss of the last training step (reading it waits for the
        card)."""
        return float(self._score)

    def fit(self, iterator, epochs: int = 1, listeners=None,
            resume_from=None) -> "MultiLayerNetwork":
        """``Trainer(self, listeners).fit(iterator, epochs, resume_from)``."""
        from deeplearning4j_tpu_torch.train.trainer import Trainer
        Trainer(self, listeners=listeners).fit(iterator, epochs, resume_from=resume_from)
        return self

    def trace_attrs(self) -> dict:
        """The model's identity on the trainer's ``fit`` span
        (``obs.tracing``): what a trace viewer shows for the run."""
        return {"model": "MultiLayerNetwork",
                "layers": len(self.layers),
                "params": self.num_params() if self.params_ is not None else 0}

    # ---------------------------------------------------------- serde
    def save(self, path: str, save_updater: bool = True,
             iterator_state: Optional[dict] = None, normalizer=None) -> None:
        """The model zip (``io.model_serializer.write_model``), which the
        JAX package restores too."""
        from deeplearning4j_tpu_torch.io.model_serializer import write_model
        write_model(self, path, save_updater=save_updater, iterator_state=iterator_state,
                    normalizer=normalizer)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: Any = DEFAULT_DEVICE) -> "MultiLayerNetwork":
        """The network of a model zip either package wrote, on ``device``
        (verified first; a damaged zip raises ``CheckpointCorruptError``)."""
        from deeplearning4j_tpu_torch.io.model_serializer import restore_multi_layer_network
        return restore_multi_layer_network(path, load_updater=load_updater, device=device)

    # ---------------------------------------------------------- evaluation
    def _accumulate(self, evaluation, iterator):
        """Feed ``evaluation`` every batch's labels, output and labels mask,
        each read back to the host once."""
        for batch in iterator:
            out = self.output(batch.features, mask=batch.features_mask)
            evaluation.eval(to_host(batch.labels), to_host(out),
                            mask=to_host(batch.labels_mask))
        return evaluation

    def evaluate(self, iterator, top_n: int = 1):
        from deeplearning4j_tpu_torch.evaluation.classification import Evaluation
        return self._accumulate(Evaluation(top_n=top_n), iterator)

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
        return self._accumulate(RegressionEvaluation(), iterator)

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCMultiClass
        n_out = self.conf.output_type().flat_size()
        roc = ROC(threshold_steps) if n_out <= 2 else ROCMultiClass(threshold_steps)
        return self._accumulate(roc, iterator)

    # ---------------------------------------------------------- misc
    def summary(self) -> str:
        lines = [f"{'idx':<4}{'type':<24}{'out shape':<20}{'params':<10}"]
        for i, (layer, itype) in enumerate(zip(self.layers, self._types)):
            out = layer.get_output_type(itype)
            n = sum(t.numel() for t in tree_leaves(self.params_[i])) if self.params_ else 0
            lines.append(f"{i:<4}{layer.TYPE_NAME:<24}{str(out.batch_shape()):<20}{n:<10}")
        lines.append(f"Total params: {self.num_params() if self.params_ else 0}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A deep copy on the same device: configuration, parameters and
        state."""
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(self.conf.to_dict()),
                                device=self.device)
        if self.params_ is not None:
            net.params_ = tree_map(torch.Tensor.clone, self.params_)
            net.state_ = tree_map(torch.Tensor.clone, self.state_)
        return net


def to_host(a):
    """A tensor as a numpy array (bf16 widened to f32; numpy has no bf16);
    anything else as it is."""
    if not torch.is_tensor(a):
        return a
    a = a.detach().cpu()
    return (a.float() if a.dtype == torch.bfloat16 else a).numpy()


def flat_param_vector(params, device) -> torch.Tensor:
    """Every leaf of a list of per-layer dicts or a dict of per-vertex
    dicts, raveled (C order) and concatenated in JAX's leaf order: dict
    keys sorted at every level, lists in order."""
    def leaves(node):
        if isinstance(node, dict):
            return [leaf for k in sorted(node) for leaf in leaves(node[k])]
        if isinstance(node, list):
            return [leaf for item in node for leaf in leaves(item)]
        return [node.reshape(-1)]
    flat = leaves(params)
    return torch.cat(flat) if flat else torch.zeros(0, device=device)


def itype_before(net: MultiLayerNetwork, i: int, types: list) -> Any:
    """InputType of the activation arriving at layer i (before adaptation)."""
    if i == 0:
        return net.conf.input_type
    return net.layers[i - 1].get_output_type(types[i - 1])
