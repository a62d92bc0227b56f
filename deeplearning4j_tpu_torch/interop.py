"""Carry weights from the JAX package into the port.

``load_jax_params(net, params, state)`` takes a JAX net's ``params_`` and
``state_`` as nested dicts of numpy arrays (vertex name → name → array,
in the JAX layouts: NHWC activations, HWIO conv kernels, dense
``W [nIn, nOut]``) and fills the port's net with the same values.  The
port keeps those layouts, so this is a checked copy: every vertex and
every key must match the port's own, with the same shapes.
"""

from __future__ import annotations

import numpy as np
import torch


def _fill(name: str, ours: dict, theirs: dict) -> dict:
    out = {}
    for vertex, tensors in ours.items():
        given = theirs.get(vertex)
        if given is None:
            raise KeyError(f"{name}: vertex {vertex!r} missing from the JAX tree")
        if set(given) != set(tensors):
            raise KeyError(f"{name}[{vertex!r}]: keys {sorted(given)} != {sorted(tensors)}")
        out[vertex] = {}
        for key, t in tensors.items():
            arr = np.asarray(given[key])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}[{vertex!r}][{key!r}]: shape {arr.shape} "
                                 f"!= {tuple(t.shape)}")
            out[vertex][key] = torch.as_tensor(arr, dtype=t.dtype, device=t.device).clone()
    extra = set(theirs) - set(ours)
    if extra:
        raise KeyError(f"{name}: vertices {sorted(extra)} are not in the port's net")
    return out


def load_jax_params(net, params: dict, state: dict):
    """Fill ``net`` (initialised first if it is not yet) from the JAX
    trees; returns ``net``."""
    if net.params_ is None:
        net.init()
    net.params_ = _fill("params", net.params_, params)
    net.state_ = _fill("state", net.state_, state)
    return net
