"""Flat-parameter-vector view (port of ``deeplearning4j_tpu/utils/pytree.py``).

DL4J keeps a network's parameters as ONE contiguous vector with per-layer
views; the port keeps a tree of tensors (nested dicts and lists) and
gives the flat vector as a view utility: for checkpoints, the gradient
codec (``parallel/compression.py``, whose wire indices are positions in
this vector) and parity tests.

The order is ``jax.flatten_util.ravel_pytree``'s: the leaves in
``jax.tree_util``'s flatten order (dict keys sorted at every level,
lists in order; ``train.updaters.jax_leaves``), each raveled row-major in
the layout the port shares with the JAX package (HWIO conv kernels,
dense ``W [nIn, nOut]``), so that a flat vector, and a codec message
over it, is the same in both packages.
"""

from __future__ import annotations

from typing import Any

import torch

from deeplearning4j_tpu_torch.train.updaters import jax_leaves, jax_unflatten


def flat_param_vector(params: Any) -> torch.Tensor:
    """Every leaf of ``params`` raveled (row-major) and concatenated in
    ``jax_leaves`` order: the ``MultiLayerNetwork.params()`` equivalent.
    An empty tree gives an empty f32 vector."""
    leaves = jax_leaves(params)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def unflatten_param_vector(flat: torch.Tensor, like: Any) -> Any:
    """Inverse of :func:`flat_param_vector` given a template tree: each
    leaf takes its template's shape and dtype (a view of ``flat`` where
    the dtype is already the template's)."""
    total = sum(leaf.numel() for leaf in jax_leaves(like))
    if flat.shape[0] != total:
        raise ValueError(f"flat vector length {flat.shape[0]} != template size {total}")
    offset = 0

    def take(leaf):
        nonlocal offset
        n = leaf.numel()
        out = flat[offset:offset + n].reshape(leaf.shape).to(leaf.dtype)
        offset += n
        return out

    return jax_unflatten(like, take)


def param_count(params: Any) -> int:
    """``Model.numParams()`` parity."""
    return sum(leaf.numel() for leaf in jax_leaves(params))


def param_table(params: Any) -> dict[str, Any]:
    """``Model.paramTable()`` parity: a flat dict of path → leaf, the path
    each key or index along the way joined by ``/`` (``"0/W"``), in
    ``jax_leaves`` order."""
    table: dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            table["/".join(path)] = node

    walk(params, ())
    return table
