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
state (``net.opt_state``, the optax state of its updater) into the
port, so that training continues where the JAX run stopped: the
``trace`` of ``Nesterovs``, the ``count``/``mu``/``nu`` of ``Adam``.
The optax state is read by its field names alone (no optax import).

``load_jax_bert_params(model, params)`` fills a port ``BertForMaskedLM``
from the JAX model's ``params`` (or the TF importer's tree) as nested
dicts of numpy arrays, checked key by key and shape by shape.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.updaters import from_dict


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


def _optax_fields(node, out: dict) -> dict:
    """The fields of every named tuple in an optax state (nested tuples of
    named tuples, e.g. ``(EmptyState(), (TraceState(trace=...), ...))``)."""
    if hasattr(node, "_asdict"):
        out.update(node._asdict())
    elif isinstance(node, (list, tuple)):
        for item in node:
            _optax_fields(item, out)
    return out


def load_jax_opt_state(net, opt_state):
    """Fill ``net.opt_state`` from a JAX optimizer state; the port's
    updater (from ``net.conf``) says which fields it needs.  Returns
    ``net``."""
    fields = _optax_fields(opt_state, {})
    ours = from_dict(net.conf.updater).init(net.params_)
    out = {}
    for key, tree in ours.items():
        if key not in fields:
            raise KeyError(f"opt_state: field {key!r} missing from the JAX state "
                           f"(it has {sorted(fields)})")
        if key == "count":
            out[key] = torch.as_tensor(np.asarray(fields[key]), dtype=tree.dtype,
                                       device=tree.device).reshape(())
        else:
            out[key] = _fill(f"opt_state[{key!r}]", tree, fields[key])
    net.opt_state = out
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
