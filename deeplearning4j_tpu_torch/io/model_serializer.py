"""Model serialization (port of ``deeplearning4j_tpu/io/model_serializer.py``):
DL4J's ``ModelSerializer``, made durable.  A model file is a zip of

- ``configuration.json``: the network's configuration (the JAX package's JSON);
- ``coefficients.npz``: the params; ``state.npz``: the layers' state (BN
  running statistics);
- ``updater.npz``: the updater's state, as the leaves of the JAX
  package's optax state in ``jax.tree_util``'s flatten order
  (``train.updaters.Optimizer.state_leaves``);
- ``meta.json``: the format version, the iteration and epoch counters and
  the model type;
- ``trainingState.json``: what an exact resume needs beyond that: the
  completed iteration and epoch, the batches run of a mid-epoch
  checkpoint, the dtype policy;
- ``manifest.json``: each entry's sha256 (``resilience.checkpoint``);
- optionally ``iteratorState.json``, a ``ResumableIterator``'s position;
- the port's own ``torchStream.json``: the state of the trainer's random
  stream (a ``torch.Generator``).

A params tree (nested dicts and lists of tensors) is stored as ``leaf_0
.. leaf_{n-1}`` in the JAX package's flatten order (dict keys sorted,
depth first), so a zip written by either package restores in the other:
the JAX reader reads the ``leaf_i`` entries alone and ignores
``treedef``, which the port writes as the JSON list of each leaf's key
path.  bf16 tensors are written widened to f32 (numpy has no bf16) and
narrowed again on restore.  Random streams cannot cross: the port never
writes the JAX package's ``rng_key_data``, and the JAX reader ignores
``torchStream.json``; a zip the JAX package wrote (or one written on
another device type) restores with no stream, so the next ``fit``
starts its stream from the seed.

Every write is atomic with a manifest, and every restore verifies the
zip first and raises ``CheckpointCorruptError`` rather than read a torn
file.  Not ported yet: the normalizer entry (``normalizer=`` raises
until ``data/normalizers.py`` is ported) and the artifact store's
entries, which are neither written nor read.
"""

from __future__ import annotations

import io as _io
import json
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointCorruptError, verify_checkpoint, write_checkpoint_zip)
from deeplearning4j_tpu_torch.train.capture import write_into
from deeplearning4j_tpu_torch.train.updaters import jax_leaves, jax_unflatten, leaf_like

FORMAT_VERSION = 2   # v2: manifest + trainingState.json
STREAM_ENTRY = "torchStream.json"


def tree_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's key path, in the JAX flatten order (dict keys sorted,
    lists in order, a list position as an int)."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in tree_paths(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, node in enumerate(tree) for p in tree_paths(node, prefix + (i,))]
    return [prefix]


def leaf_at(tree, path: tuple):
    """The leaf of ``tree`` at a key path."""
    for key in path:
        tree = tree[key]
    return tree


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _leaves_to_npz_bytes(leaves: list, names: list[str]) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, treedef=np.frombuffer(json.dumps(names).encode(), dtype=np.uint8),
             **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})
    return buf.getvalue()


def _tree_to_npz_bytes(tree) -> bytes:
    paths = tree_paths(tree)
    return _leaves_to_npz_bytes([leaf_at(tree, p) for p in paths],
                                ["/".join(map(str, p)) for p in paths])


def _npz_bytes_to_leaves(data: bytes) -> list[np.ndarray]:
    archive = np.load(_io.BytesIO(data), allow_pickle=False)
    leaves = []
    while f"leaf_{len(leaves)}" in archive:
        leaves.append(archive[f"leaf_{len(leaves)}"])
    return leaves


def _rebuild_like(template, leaves: list):
    """A tree of ``template``'s structure holding ``leaves`` (JAX order),
    each leaf a tensor of the template leaf's shape (checked), dtype and
    device."""
    if len(jax_leaves(template)) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} arrays but model expects "
                         f"{len(jax_leaves(template))}")
    it = iter(enumerate(leaves))

    def make(want):
        index, value = next(it)
        return leaf_like(want, value, index)
    return jax_unflatten(template, make)


def _optimizer(net):
    from deeplearning4j_tpu_torch.train.trainer import net_optimizer
    return net_optimizer(net)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _training_state_json(net) -> str:
    """The exact-resume extras: the trainer stamps the ``_completed_*``
    counters and ``_epoch_batches`` on the net at each step (``fit``); a
    net that never trained records its own counters."""
    from deeplearning4j_tpu_torch.config import dtype_policy
    policy = dtype_policy()
    state: dict[str, Any] = {
        "iteration": int(getattr(net, "_completed_iterations", net.iteration)),
        "epoch": int(getattr(net, "_completed_epochs", net.epoch)),
        "dtype_policy": {"param_dtype": _dtype_name(policy.param_dtype),
                         "compute_dtype": _dtype_name(policy.compute_dtype),
                         "output_dtype": _dtype_name(policy.output_dtype)},
    }
    batches = getattr(net, "_epoch_batches", None)
    if batches is not None:
        state["epoch_batches"] = int(batches)
    return json.dumps(state)


def _stream_json(net) -> Optional[str]:
    """The trainer's random stream (the live generator's state now, or a
    snapshot's or a restore's copy), or None without one."""
    state = getattr(net, "_stream_state", None)
    device = getattr(net, "_stream_device", None)
    stream = getattr(net, "_stream", None)
    if stream is not None:
        state, device = stream.get_state(), stream.device.type
    if state is None:
        return None
    return json.dumps({"device": device, "state": state.tolist()})


def write_model(net, path: str, save_updater: bool = True, normalizer=None,
                iterator_state: Optional[dict] = None) -> None:
    """Write ``net`` (a network, or a ``resilience.checkpoint.NetSnapshot``
    of one) to the zip ``path``, atomically with a sha256 manifest.
    ``iterator_state`` (``ResumableIterator.state()``) is stored as
    ``iteratorState.json``."""
    if normalizer is not None:
        raise NotImplementedError("normalizer= waits for data/normalizers.py, which is not "
                                  "ported yet")
    entries: dict[str, Any] = {
        "configuration.json": net.conf.to_json(),
        "coefficients.npz": _tree_to_npz_bytes(net.params_),
        "state.npz": _tree_to_npz_bytes(net.state_),
    }
    if save_updater and net.opt_state is not None:
        leaves = _optimizer(net).state_leaves(net.opt_state)
        entries["updater.npz"] = _leaves_to_npz_bytes(
            leaves, [f"optax state leaf {i}" for i in range(len(leaves))])
    entries["meta.json"] = json.dumps({
        "format_version": FORMAT_VERSION, "iteration": net.iteration, "epoch": net.epoch,
        "model_type": getattr(net, "model_type", type(net).__name__)})
    entries["trainingState.json"] = _training_state_json(net)
    entries[STREAM_ENTRY] = _stream_json(net)
    if iterator_state is not None:
        entries["iteratorState.json"] = json.dumps(iterator_state)
    write_checkpoint_zip(path, entries)


def _read_json(path: str, name: str) -> Optional[dict]:
    with zipfile.ZipFile(path, "r") as zf:
        if name not in zf.namelist():
            return None
        return json.loads(zf.read(name).decode())


def read_iterator_state(path: str) -> Optional[dict]:
    """A checkpoint's ``iteratorState.json``, if it has one."""
    return _read_json(path, "iteratorState.json")


def read_training_state(path: str) -> Optional[dict]:
    """A checkpoint's ``trainingState.json``, if it has one."""
    return _read_json(path, "trainingState.json")


def _verify_or_raise(path: str) -> None:
    problems = verify_checkpoint(path)
    if problems:
        raise CheckpointCorruptError(path, problems)


def _apply_training_state(net, zf: zipfile.ZipFile) -> None:
    """The exact-resume extras onto a restored net: the completed counters
    (over meta.json's), the mid-epoch position, and the port's stream
    state when it was taken on the net's device type (else none)."""
    names = zf.namelist()
    if "trainingState.json" in names:
        state = json.loads(zf.read("trainingState.json").decode())
        net.iteration = int(state.get("iteration", net.iteration))
        net.epoch = int(state.get("epoch", net.epoch))
        if "epoch_batches" in state:
            net._epoch_batches = int(state["epoch_batches"])
    net._stream_state = None
    if STREAM_ENTRY in names:
        stream = json.loads(zf.read(STREAM_ENTRY).decode())
        if stream.get("device") == net.device.type:
            net._stream_state = torch.tensor(stream["state"], dtype=torch.uint8)
            net._stream_device = net.device.type


def _restore(path: str, conf_cls, net_cls, load_updater: bool, verify: bool, device):
    if verify:
        _verify_or_raise(path)
    with zipfile.ZipFile(path, "r") as zf:
        conf = conf_cls.from_json(zf.read("configuration.json").decode())
        net = net_cls(conf, device=device).init()   # the template trees
        net.params_ = _rebuild_like(net.params_, _npz_bytes_to_leaves(zf.read("coefficients.npz")))
        net.state_ = _rebuild_like(net.state_, _npz_bytes_to_leaves(zf.read("state.npz")))
        meta = json.loads(zf.read("meta.json").decode())
        net.iteration = meta.get("iteration", 0)
        net.epoch = meta.get("epoch", 0)
        if load_updater and "updater.npz" in zf.namelist():
            leaves = _npz_bytes_to_leaves(zf.read("updater.npz"))
            net.opt_state = _optimizer(net).state_from_leaves(net.params_, leaves)
        _apply_training_state(net, zf)
    return net


def restore_multi_layer_network(path: str, load_updater: bool = True, verify: bool = True,
                                device: Any = DEFAULT_DEVICE):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return _restore(path, MultiLayerConfiguration, MultiLayerNetwork, load_updater, verify,
                    device)


def restore_computation_graph(path: str, load_updater: bool = True, verify: bool = True,
                              device: Any = DEFAULT_DEVICE):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
    return _restore(path, ComputationGraphConfiguration, ComputationGraph, load_updater, verify,
                    device)


def restore_model(path: str, load_updater: bool = True, verify: bool = True,
                  device: Any = DEFAULT_DEVICE):
    """The network of a zip, by its saved model type (``ModelGuesser``)."""
    if verify:
        _verify_or_raise(path)
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json").decode())
    restore = (restore_computation_graph if meta.get("model_type") == "ComputationGraph"
               else restore_multi_layer_network)
    return restore(path, load_updater, verify=False, device=device)


def restore_into(net, path: str, tx=None, load_updater: bool = True,
                 verify: bool = True) -> dict:
    """A checkpoint's values written into an existing ``net`` (the resume
    path): its params, state and updater state are written into the
    net's own tensors where it has them, the buffers a captured step
    holds, so the step reads the restored values; ``tx`` (the trainer's
    optimizer; the net's own by default) shapes the updater state.
    Returns the checkpoint's training-state dict (empty for a zip
    without one)."""
    if verify:
        _verify_or_raise(path)
    with zipfile.ZipFile(path, "r") as zf:
        if net.params_ is None:
            net.init()
        write_into(net.params_, _rebuild_like(
            net.params_, _npz_bytes_to_leaves(zf.read("coefficients.npz"))))
        write_into(net.state_, _rebuild_like(
            net.state_, _npz_bytes_to_leaves(zf.read("state.npz"))))
        meta = json.loads(zf.read("meta.json").decode())
        net.iteration = meta.get("iteration", 0)
        net.epoch = meta.get("epoch", 0)
        if load_updater and "updater.npz" in zf.namelist():
            tx = tx if tx is not None else _optimizer(net)
            restored = tx.state_from_leaves(net.params_,
                                            _npz_bytes_to_leaves(zf.read("updater.npz")))
            if net.opt_state is None:
                net.opt_state = restored
            else:
                write_into(net.opt_state, restored)
        _apply_training_state(net, zf)
        if "trainingState.json" in zf.namelist():
            return json.loads(zf.read("trainingState.json").decode())
    return {}


def save_params(params, path: str) -> None:
    """A bare params tree as an npz (zoo weight files)."""
    with open(path, "wb") as f:
        f.write(_tree_to_npz_bytes(params))


def load_params(path: str, template):
    """The params tree of an npz, shaped, typed and placed like ``template``."""
    with open(path, "rb") as f:
        return _rebuild_like(template, _npz_bytes_to_leaves(f.read()))
