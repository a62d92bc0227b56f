"""The npz helpers of ``deeplearning4j_tpu/io/model_serializer.py``.

A params tree (nested dicts of tensors or arrays) is stored as
``leaf_0 .. leaf_{n-1}`` in the JAX package's flatten order: dict keys
sorted, depth first.  So a zip written by either package loads in the
other: the JAX reader reads the ``leaf_i`` entries alone and ignores
``treedef``, which the port writes as the JSON list of each leaf's key
path (JAX writes its own treedef's text).  The rest of the JAX module
(net checkpoints, manifests, training state) is not ported yet.
"""

from __future__ import annotations

import io as _io
import json
from typing import Any

import numpy as np
import torch


def tree_paths(tree: dict, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's key path, in the JAX flatten order (sorted keys)."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        out.extend(tree_paths(node, prefix + (key,)) if isinstance(node, dict)
                   else [prefix + (key,)])
    return out


def leaf_at(tree: dict, path: tuple):
    """The leaf of ``tree`` at a key path."""
    for key in path:
        tree = tree[key]
    return tree


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_to_npz_bytes(tree: dict) -> bytes:
    paths = tree_paths(tree)
    buf = _io.BytesIO()
    np.savez(buf, treedef=np.frombuffer(json.dumps(["/".join(p) for p in paths]).encode(),
                                        dtype=np.uint8),
             **{f"leaf_{i}": _to_numpy(leaf_at(tree, p)) for i, p in enumerate(paths)})
    return buf.getvalue()


def _npz_bytes_to_leaves(data: bytes) -> list[np.ndarray]:
    archive = np.load(_io.BytesIO(data), allow_pickle=False)
    leaves = []
    while f"leaf_{len(leaves)}" in archive:
        leaves.append(archive[f"leaf_{len(leaves)}"])
    return leaves


def _rebuild_like(template: dict, leaves: list) -> dict:
    """A tree of ``template``'s structure holding ``leaves`` (JAX order);
    each leaf a tensor of the template leaf's dtype and device."""
    paths = tree_paths(template)
    if len(paths) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} arrays but model expects {len(paths)}")
    out: dict[str, Any] = {}
    for path, arr in zip(paths, leaves):
        want = leaf_at(template, path)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} != "
                             f"{tuple(want.shape)}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.as_tensor(np.asarray(arr), dtype=want.dtype,
                                         device=want.device).clone()
    return out
