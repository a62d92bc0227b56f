"""Deprecated shim: data parallelism is a layout (port of
``deeplearning4j_tpu/parallel/data_parallel.py``).

.. deprecated::
    ``ParallelWrapper``'s default mode (an all-reduce of the gradient
    every step) is exactly ``Trainer(mesh=...)``: one process per data
    shard, each with its rows of the global batch, the gradient summed
    over the ranks before every update (``train/trainer.py``).  The class
    survives for DL4J's name, for the parameter-averaging mode
    (``averaging_frequency > 1``: each rank trains its own replica on its
    shard with no traffic, and the params, and optionally the updater
    state, are averaged every N steps) and for ZeRO-1
    (``zero_optimizer_sharding``: each rank holds and steps the updater
    state of its share of the layers).  New code calls
    ``Trainer(net, layout=...)``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.base import DataShard
from deeplearning4j_tpu_torch.obs import tracing
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel.mesh import AXIS_DATA, DATA_AXES  # noqa: F401
from deeplearning4j_tpu_torch.train.trainer import Trainer
from deeplearning4j_tpu_torch.train.updaters import _select, tree_leaves, tree_map

warnings.warn(
    "deeplearning4j_tpu_torch.parallel.data_parallel is deprecated; use "
    "Trainer(layout='dp<N>') — ParallelWrapper remains as a thin shim over the "
    "data-parallel layout", DeprecationWarning, stacklevel=2)


def _entries(tree) -> list:
    """The top-level (key, entry) pairs of a params tree: a layer stack's
    indices, a graph's vertex names."""
    return list(enumerate(tree)) if isinstance(tree, list) else list(tree.items())


class ZeroOptimizer:
    """ZeRO-1 over a data-parallel ``layout``: the optimizer ``tx`` (the
    trainer's: normalization, updater, frozen layers) runs on this rank's
    share of the top-level entries (whole layers, so that a per-layer
    gradient normalization reads only what its rank owns), holding the
    updater state of those alone; each rank's updates then reach the
    others by one broadcast, so every rank adds the same updates to the
    same params.  The layers go to the ranks largest first, each to the
    rank with the fewest parameter bytes so far (lowest rank on a tie)."""

    def __init__(self, tx, layout, params):
        self.tx, self.layout = tx, layout
        load = [0] * layout.data
        sizes = {k: sum(t.numel() * t.element_size() for t in tree_leaves(v))
                 for k, v in _entries(params)}
        owner = {}
        for k in sorted((k for k in sizes if sizes[k]), key=lambda k: -sizes[k]):
            owner[k] = min(range(layout.data), key=lambda r: (load[r], r))
            load[owner[k]] += sizes[k]
        self.owners = ([owner.get(i) for i in range(len(params))] if isinstance(params, list)
                       else {k: owner.get(k) for k in params})

    def own(self, tree, rank: Optional[int] = None):
        """``tree`` with the entries of other ranks than ``rank`` (this one
        by default) left empty."""
        return _select(tree, self.owners, self.layout.rank if rank is None else rank)

    def init(self, params):
        return self.tx.init(self.own(params))

    def update(self, grads, state, params=None):
        updates, new_state = self.tx.update(self.own(grads), state,
                                            None if params is None else self.own(params))
        parts = []
        for r in range(self.layout.data):
            if r == self.layout.rank:
                part = updates
            else:
                part = tree_map(torch.empty_like, self.own(grads, r))
            if tree_leaves(part):
                self.layout.replicate(part, src=r)
            parts.append(part)
        merged = {k: (parts[o][k] if o is not None else {})
                  for k, o in _entries(self.owners)}
        return ([merged[i] for i in range(len(merged))] if isinstance(self.owners, list)
                else merged), new_state


class ParallelWrapper(Trainer):
    """DL4J's data-parallel trainer: the same ``fit(iterator, epochs)``
    surface as :class:`Trainer`, each step over the mesh's ``data`` axis,
    the global batch from the iterator split over the ranks (its leading
    dim must divide by their number).  ``mesh`` is a
    ``parallel.make_mesh`` mesh (over the whole process group, on the
    net's device, by default).

    ``averaging_frequency > 1``: each rank trains its replica on its shard
    with no per-step traffic (its batch statistics its own) and every N
    steps the params, and the updater state when
    ``average_updater_state``, are averaged (the ``average`` span,
    ``tpudl_parallel_avg_syncs_total``); the reported loss is the
    replicas' mean; ``fit`` hands back the averaged net, with rank 0's
    layer state (and updater state, when not averaged) on every rank.
    ``zero_optimizer_sharding``: ZeRO-1 (:class:`ZeroOptimizer`), the
    every-step mode only."""

    def __init__(self, net, mesh=None, listeners=None, averaging_frequency: int = 1,
                 average_updater_state: bool = True, zero_optimizer_sharding: bool = False):
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(devices=net.device)
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updater_state = average_updater_state
        self.zero_optimizer_sharding = zero_optimizer_sharding
        if zero_optimizer_sharding and averaging_frequency > 1:
            raise ValueError("zero_optimizer_sharding requires the every-step allreduce mode "
                             "(averaging_frequency=1)")
        self._steps_since_avg = 0
        self._replicas = None
        if self.averaging_frequency == 1:
            super().__init__(net, listeners=listeners, mesh=self.mesh)
        else:
            super().__init__(net, listeners=listeners)
            # the replicas' rows of each batch and their collectives; the
            # steps run each replica alone (its statistics its own)
            self._replicas = mesh_mod.MeshLayout(mesh_mod.MeshSpec.from_mesh(self.mesh),
                                                 mesh=self.mesh)
            self._batch_layout = self._replicas
            self._shard = DataShard(self._replicas.rank, self._replicas.data)
        if zero_optimizer_sharding and self._layout is not None:
            if net.opt_state is not None:
                raise ValueError("zero_optimizer_sharding starts from a fresh updater state: "
                                 "the net already holds one")
            self.tx = ZeroOptimizer(self.tx, self._layout, net.params_)
        get_registry().gauge("tpudl_parallel_mesh_devices").set(self.mesh.shape[AXIS_DATA])

    def _step_key(self, kind: str):
        if self._replicas is not None:
            kind = f"{kind}:dp_avg_{self._replicas.data}"
        elif isinstance(self.tx, ZeroOptimizer):
            kind = f"{kind}:zero1"
        return super()._step_key(kind)

    def _replicated(self) -> list:
        # under ZeRO-1 each rank's updater state is its own share
        trees = super()._replicated()
        return trees[:2] if isinstance(self.tx, ZeroOptimizer) else trees

    def _ensure_ready(self) -> None:
        super()._ensure_ready()
        if self._replicas is not None and not self._layout_placed:
            # the replicas start from rank 0's trees, as the dense layout does
            self._replicas.replicate(self._replicated())
            self._layout_placed = True

    def fit_batch(self, batch, rng=None, prepared: bool = False) -> torch.Tensor:
        """One step (module docstring); returns the global batch's loss (the
        replicas' mean in the averaging mode)."""
        loss = super().fit_batch(batch, rng, prepared)
        if self._replicas is None:
            return loss
        self._steps_since_avg += 1
        if self._steps_since_avg >= self.averaging_frequency:
            with tracing.span("average", shards=self._replicas.data,
                              frequency=self.averaging_frequency):
                self._average()
            get_registry().counter("tpudl_parallel_avg_syncs_total").inc()
        return self._replicas.all_reduce_(loss.reshape(1).clone(), "loss")[0] / self._replicas.data

    def _fit_tbptt(self, batch, rng, prepared: bool = False):
        if self._replicas is not None:
            raise NotImplementedError("tBPTT with averaging_frequency > 1 is not supported; use "
                                      "the default every-step allreduce (averaging_frequency=1)")
        return super()._fit_tbptt(batch, rng, prepared)

    def _average(self) -> None:
        """The replicas' mean of the params (and of the updater state, when
        ``average_updater_state``), written in place on every rank."""
        net, n = self.net, self._replicas.data
        trees = [net.params_] + ([net.opt_state] if self.average_updater_state else [])
        leaves = [t for tree in trees for t in tree_leaves(tree)
                  if torch.is_tensor(t) and t.is_floating_point()]
        summed, _ = self._replicas.all_reduce_tree(leaves, kind="average")
        with torch.no_grad():
            for leaf, s in zip(leaves, summed):
                leaf.copy_(s / n)
        self._steps_since_avg = 0

    def fit(self, iterator, epochs: int = 1, resume_from=None):
        from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
        if isinstance(self.tx, ZeroOptimizer) and (resume_from is not None or any(
                isinstance(l, CheckpointListener) for l in self.bus.listeners)):
            raise NotImplementedError("checkpoints under zero_optimizer_sharding: each rank "
                                      "holds its share of the updater state, which a "
                                      "checkpoint does not gather yet")
        result = super().fit(iterator, epochs, resume_from=resume_from)
        if self._replicas is not None:
            self._finalize_averaging()
        return result

    def _finalize_averaging(self) -> None:
        """Hand back one net (DL4J's ParameterAveragingTrainingMaster): the
        params averaged (and the updater state, when averaged) if steps ran
        since the last average, and rank 0's layer state (and updater
        state, when not averaged) on every rank."""
        if self._steps_since_avg:
            self._average()
        net = self.net
        self._replicas.replicate([net.state_] + ([] if self.average_updater_state
                                                 else [net.opt_state]))
