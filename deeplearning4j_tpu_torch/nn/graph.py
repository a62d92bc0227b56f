"""ComputationGraph — the DAG network (port of
``deeplearning4j_tpu/nn/graph.py``), inference only.

Named vertices (layers or combinator vertices) run in a topological
order computed once at build.  The configuration's JSON form is the JAX
package's, so a graph that package serialized builds the same network
here.  Parameters and state are nested dicts of tensors (vertex name →
param name → tensor) in the JAX layouts, on the graph's device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from deeplearning4j_tpu_torch.nn import preprocessors
from deeplearning4j_tpu_torch.nn.conf import ShapeInferenceError
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.vertices import GraphVertex, vertex_from_dict


@dataclasses.dataclass
class VertexSpec:
    name: str
    kind: str            # "layer" | "vertex"
    obj: Any             # Layer or GraphVertex
    inputs: list         # names of input vertices / graph inputs

    def to_dict(self):
        return {"name": self.name, "kind": self.kind, "obj": self.obj.to_dict(),
                "inputs": list(self.inputs)}

    @staticmethod
    def from_dict(d):
        obj = layer_from_dict(d["obj"]) if d["kind"] == "layer" else vertex_from_dict(d["obj"])
        return VertexSpec(d["name"], d["kind"], obj, list(d["inputs"]))


@dataclasses.dataclass
class ComputationGraphConfiguration:
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    vertices: list = dataclasses.field(default_factory=list)  # [VertexSpec]
    input_types: list = dataclasses.field(default_factory=list)
    seed: int = 0
    updater: Optional[dict] = None   # the JAX package's updater JSON, carried as is
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    # ---------------------------------------------------------- topo/types
    def topo_order(self) -> list[VertexSpec]:
        resolved = set(self.inputs)
        order: list[VertexSpec] = []
        pending = list(self.vertices)
        while pending:
            remaining = []
            for spec in pending:
                if all(i in resolved for i in spec.inputs):
                    order.append(spec)
                    resolved.add(spec.name)
                else:
                    remaining.append(spec)
            if len(remaining) == len(pending):
                missing = {i for s in remaining for i in s.inputs if i not in resolved}
                raise ValueError(f"graph has unresolvable inputs or a cycle: {missing}")
            pending = remaining
        return order

    def types(self) -> tuple[dict, dict]:
        """(name → InputType arriving at each vertex, after adaptation for
        layers; name → output InputType of every graph input and vertex)."""
        if len(self.input_types) != len(self.inputs):
            raise ValueError("set_input_types must provide one InputType per graph input")
        known: dict[str, InputType] = dict(zip(self.inputs, self.input_types))
        arriving: dict[str, list] = {}
        for spec in self.topo_order():
            try:
                in_types = [known[i] for i in spec.inputs]
                if spec.kind == "layer":
                    arriving[spec.name] = [preprocessors.adapt_type(in_types[0], spec.obj)]
                    known[spec.name] = spec.obj.get_output_type(arriving[spec.name][0])
                else:
                    arriving[spec.name] = in_types
                    known[spec.name] = spec.obj.get_output_type(in_types)
            except Exception as e:
                raise ShapeInferenceError(
                    f"vertex '{spec.name}' ({type(spec.obj).__name__})", e) from e
        return arriving, known

    def output_types(self) -> dict[str, InputType]:
        known = self.types()[1]
        return {name: known[name] for name in self.outputs}

    # ---------------------------------------------------------- serde
    def to_dict(self):
        return {
            "inputs": self.inputs,
            "outputs": self.outputs,
            "vertices": [v.to_dict() for v in self.vertices],
            "input_types": [t.to_dict() for t in self.input_types],
            "seed": self.seed,
            "updater": self.updater,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold": self.gradient_normalization_threshold,
            "mini_batch": self.mini_batch,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d):
        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]),
            outputs=list(d["outputs"]),
            vertices=[VertexSpec.from_dict(v) for v in d["vertices"]],
            input_types=[InputType.from_dict(t) for t in d["input_types"]],
            seed=d.get("seed", 0),
            updater=d.get("updater"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get("gradient_normalization_threshold", 1.0),
            mini_batch=d.get("mini_batch", True),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    @staticmethod
    def from_json(s):
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """``ComputationGraphConfiguration.GraphBuilder`` parity."""

    def __init__(self, parent):
        self.parent = parent  # nn.conf.Builder carrying global defaults
        self._inputs: list[str] = []
        self._outputs: list[str] = []
        self._vertices: list[VertexSpec] = []
        self._input_types: list[InputType] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types.extend(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        self._vertices.append(VertexSpec(name, "layer", layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        self._vertices.append(VertexSpec(name, "vertex", vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs.extend(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        p = self.parent
        for spec in self._vertices:
            if spec.kind == "layer":
                spec.obj.inherit_defaults(p._defaults)
        conf = ComputationGraphConfiguration(
            inputs=self._inputs, outputs=self._outputs, vertices=self._vertices,
            input_types=self._input_types, seed=p._seed, updater=p._updater,
            gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            mini_batch=p._mini_batch,
        )
        conf.topo_order()  # validate DAG now
        return conf


class ComputationGraph:
    """DAG network on one device (``"cuda"`` unless the caller says
    otherwise; raises when that card is absent)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device: Any = DEFAULT_DEVICE):
        self.conf = conf
        self.device = resolve_device(device)
        self._topo = conf.topo_order()
        self._arriving, self._known = conf.types()
        self.params_: Optional[dict] = None
        self.state_: Optional[dict] = None

    # ------------------------------------------------------------- init
    def init(self, seed: Optional[int] = None, device: Any = None) -> "ComputationGraph":
        """Draw parameters from a ``torch.Generator`` seeded with ``seed``
        (the config's seed by default) and place them on ``device`` (the
        graph's device by default)."""
        if device is not None:
            self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.conf.seed if seed is None else seed)
        params, state = {}, {}
        for spec in self._topo:
            if spec.kind == "layer":
                itype = self._arriving[spec.name][0]
                params[spec.name] = (spec.obj.init_params(gen, itype)
                                     if spec.obj.has_params() else {})
                state[spec.name] = spec.obj.init_state(itype)
            else:
                params[spec.name], state[spec.name] = {}, {}
        self.params_ = self._to_device(params)
        self.state_ = self._to_device(state)
        return self

    def _to_device(self, tree: dict) -> dict:
        return {v: {k: t.to(self.device) for k, t in d.items()} for v, d in tree.items()}

    # ---------------------------------------------------------- forward
    def _forward(self, params, state, features, *, train: bool = False, mask=None):
        """features: a tensor (single input) or a list of tensors.
        Returns (outputs, new_state); outputs is a tensor for a single
        graph output, else a list."""
        feats = list(features) if isinstance(features, (list, tuple)) else [features]
        masks = list(mask) if isinstance(mask, (list, tuple)) else [mask] * len(feats)
        acts: dict[str, Any] = dict(zip(self.conf.inputs, feats))
        act_masks: dict[str, Any] = dict(zip(self.conf.inputs, masks))
        new_state = {}
        for spec in self._topo:
            in_acts = [acts[i] for i in spec.inputs]
            in_mask = next((act_masks.get(i) for i in spec.inputs
                            if act_masks.get(i) is not None), None)
            if spec.kind == "layer":
                x = preprocessors.adapt_array(in_acts[0], self._known[spec.inputs[0]],
                                              spec.obj)
                y, new_state[spec.name] = spec.obj.apply(
                    params[spec.name], state[spec.name], x, train=train, mask=in_mask)
            else:
                y = spec.obj.apply(in_acts)
                new_state[spec.name] = state[spec.name]
            acts[spec.name] = y
            act_masks[spec.name] = in_mask
        outs = [acts[name] for name in self.conf.outputs]
        return (outs[0] if len(outs) == 1 else outs), new_state

    def _as_tensor(self, a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=self.device)

    def output(self, *features, mask=None):
        """Inference forward on the graph's device; numpy or tensor inputs,
        tensor outputs."""
        feats = [self._as_tensor(f) for f in features]
        if mask is not None:
            mask = ([self._as_tensor(m) for m in mask] if isinstance(mask, (list, tuple))
                    else self._as_tensor(mask))
        with torch.inference_mode():
            y, _ = self._forward(self.params_, self.state_,
                                 feats[0] if len(feats) == 1 else feats,
                                 train=False, mask=mask)
        return y
