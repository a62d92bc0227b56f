"""Carry weights from the JAX package into the port.

``load_jax_params(net, params, state)`` takes a JAX net's ``params_`` and
``state_`` as numpy arrays in the JAX layouts (NHWC activations, HWIO
conv kernels, dense ``W [nIn, nOut]``) and fills the port's net with the
same values: nested dicts (vertex name → name → array) for a
``ComputationGraph``, lists of per-layer dicts for a
``MultiLayerNetwork``, including a quantized net's int8 ``W_q`` and f32
``W_scale`` (quantize the port's net first, so that its keys match).
The port keeps those layouts, so this is a checked copy: every vertex or
layer and every key must match the port's own, with the same shapes.

``load_jax_opt_state(net, opt_state)`` carries a JAX net's optimizer
state (``net.opt_state``, the optax state of its trainer's transform)
into the port, so that training continues where the JAX run stopped:
every updater's fields, a schedule's own count, and the per-label states
of per-layer updaters (``optax.multi_transform``).  The optax state is
read as its leaves in ``jax.tree_util``'s flatten order, walked by hand
(named tuples field by field, dict keys sorted; no optax import), and
handed to the port's optimizer (``Trainer.tx``), which lays them out.

``load_jax_bert_params(model, params)`` fills a port ``BertForMaskedLM``
from the JAX model's ``params`` (or the TF importer's tree) as nested
dicts of numpy arrays, checked key by key and shape by shape.
"""

from __future__ import annotations

import numpy as np
import torch



def _fill(name: str, ours, theirs):
    """``ours`` (nested dicts and lists of tensors, any depth) refilled
    from ``theirs``: the same keys and lengths at every level, the same
    shapes, and int8 only from int8."""
    if isinstance(ours, list):
        if not isinstance(theirs, (list, tuple)) or len(theirs) != len(ours):
            got = len(theirs) if isinstance(theirs, (list, tuple)) else type(theirs).__name__
            raise KeyError(f"{name}: {got} entries != {len(ours)}")
        return [_fill(f"{name}[{i}]", t, th) for i, (t, th) in enumerate(zip(ours, theirs))]
    if not isinstance(theirs, dict) or set(theirs) != set(ours):
        got = sorted(theirs) if isinstance(theirs, dict) else type(theirs).__name__
        raise KeyError(f"{name}: keys {got} != {sorted(ours)}")
    out = {}
    for key, t in ours.items():
        if isinstance(t, (dict, list)):
            out[key] = _fill(f"{name}/{key}", t, theirs[key])
            continue
        arr = np.array(theirs[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}/{key}: shape {arr.shape} != {tuple(t.shape)}")
        if (t.dtype == torch.int8) != (arr.dtype == np.int8):
            raise TypeError(f"{name}/{key}: dtype {arr.dtype} cannot fill {t.dtype}")
        if arr.dtype.name == "bfloat16":   # numpy's bf16 extension type: widen exactly
            arr = arr.astype(np.float32)
        out[key] = torch.as_tensor(arr, dtype=t.dtype, device=t.device)
    return out


def optax_leaves(node) -> list:
    """The array leaves of an optax state in ``jax.tree_util``'s flatten
    order: a named tuple's fields in order (``EmptyState`` and
    ``MaskedNode`` have none), tuples and lists in order, dict keys
    sorted; None is no leaf."""
    if node is None:
        return []
    if hasattr(node, "_fields"):
        return [leaf for f in node._fields for leaf in optax_leaves(getattr(node, f))]
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in optax_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [leaf for item in node for leaf in optax_leaves(item)]
    return [np.array(node)]


def load_jax_opt_state(net, opt_state):
    """Fill ``net.opt_state`` from a JAX trainer's optimizer state; the
    port's optimizer for ``net`` (its updater, per-layer updaters and
    frozen layers, from ``net.conf``) says where each leaf goes.
    Returns ``net``."""
    from deeplearning4j_tpu_torch.train.trainer import net_optimizer
    if net.params_ is None:
        net.init()
    net.opt_state = net_optimizer(net).state_from_leaves(net.params_, optax_leaves(opt_state))
    return net


def load_jax_params(net, params: dict, state: dict):
    """Fill ``net`` (initialised first if it is not yet) from the JAX
    trees; returns ``net``."""
    if net.params_ is None:
        net.init()
    net.params_ = _fill("params", net.params_, params)
    net.state_ = _fill("state", net.state_, state)
    return net


def load_jax_bert_params(model, params: dict):
    """Fill ``model.params`` (a port ``BertForMaskedLM``) from a JAX BERT
    params tree; returns ``model``."""
    model.params = _fill("params", model.params, params)
    return model
