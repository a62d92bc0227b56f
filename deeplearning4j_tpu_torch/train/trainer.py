"""Training loop, single device (port of the core of
``deeplearning4j_tpu/train/trainer.py``).

One step is forward, score, backward and update on the net's device:
:func:`make_train_step`, the JAX package's jitted step with donation.
The loss is the JAX package's: the mean per-example loss over the
(unmasked) examples, or their sum when the config sets
``mini_batch(False)``, plus every layer's L1/L2 penalty.  The update is
the config's updater (``train.updaters``) after the gradient
normalization, added to the params in place; the layers' new state and
the updater's new state are written into theirs, so the net's tensors
are the step's buffers.  On the card the step runs as CUDA graphs
(``train/capture.py``) that every trainer of one configuration shares
through ``train/step_cache.py``, so the fresh ``Trainer`` that each
``MultiLayerNetwork.fit`` and ``ComputationGraph.fit`` call builds reuses
the graphs of the call before.  ``fit_batch`` returns the loss as a fresh
0-dim tensor on the device without waiting for it; ``net.score()`` reads
it.

A step's random stream (dropout's masks) is a ``torch.Generator`` on the
net's device.  ``fit`` makes one per call, seeded with ``conf.seed +
7919`` as the JAX package seeds its key, so a run repeats bit for bit;
``fit_batch`` without a generator draws from the trainer's own stream.
The two packages' streams differ, so their masks do too.

A tBPTT configuration (``backprop_type("tbptt", n, n)``) trains each
batch of sequences in segments of n steps (:meth:`Trainer._fit_tbptt`,
:func:`make_tbptt_step`): the recurrent carries are a fourth tree the
step updates in place, so the segments replay one captured graph.

The optimizer (:func:`net_optimizer`) composes the gradient
normalization, the updater (or one per label, for layers with an updater
of their own) and the zeroing of frozen layers' updates, as the JAX
package composes its optax transform.  ``Trainer(net, listeners)``
dispatches the JAX package's listener hooks; ``fit`` stages batches
through a ``DeviceFeeder`` and stamps on the net what a checkpoint needs
for an exact resume, and ``fit(..., resume_from=...)`` (or
:meth:`Trainer.resume_state`) continues a run from a checkpoint.

Telemetry, as the JAX package's: a listener that wants model statistics
(``StatsListener``, ``HealthMonitor``) makes the trainer run the
statistics step (``make_train_step(with_stats=True)``) on the iterations
it samples and hand it the per-layer statistics (``stats_ready``); the
``fit``, ``epoch`` and ``step`` spans and the ``tpudl_train_*`` series;
the ``trainer.step`` fault site and its ``nan`` poison; the flight
recorder's ``step`` and ``resume`` events; the resume counters; NaN/Inf
panic (``config.nan_panic``, ``config.inf_panic``) and a profiler trace
around ``fit`` (``config.profiling``).  A "recompile" is a call signature
that a step has not seen before (``CapturedStep.signature_count``), the
counterpart of a new ``jax.jit`` trace; on the card the call that
captures a signature's graph is timed as a compile too
(``tpudl_train_compile_seconds``), and neither is a
``tpudl_train_step_seconds`` sample.  With tracing off a step waits for
nothing on the card.

Data parallelism, as the JAX package's ``Trainer(mesh=..., layout=
"dpN")``: one process per data shard over a ``torch.distributed`` group
(``parallel.launcher``), each calling ``Trainer(net, layout="dp2")`` on
the same config, weights and iterator.  Each rank takes its rows of every
global batch (``MeshLayout.shard_batch``), runs its layers as that shard
(``nn.layers.base.DataShard``: batch-norm statistics summed over the
ranks, dropout masks the global batch's), scores against the global
normalizer (a mask's count summed; the penalty counted once, on rank 0)
and sums its gradient and loss with the others' in one all-reduce before
the update, so the params, the layer state and the updater state stay
the same on every rank, and equal to the single-process step on the
whole batch.  Rank 0 writes the checkpoints.  A step over a gloo group
runs eagerly (its collectives stage through the host; the step's key and
``CapturedStep.eager_reason`` say so).

The in-process resize, as the JAX package's: :meth:`Trainer.request_resize`
parks a width (validated at the call: a width past the gang's processes
raises, since only a relaunch grows a gang past them), and at each epoch
boundary of ``fit`` rank 0 broadcasts its pending width to the whole
gang, which then runs :meth:`Trainer.resize_mesh` together: the layout at
the new width takes the world's leading ranks, rank 0's trees, counters
and random stream go to the ranks that join, and every artifact of the old
width goes.  A rank outside the layout is parked: it runs no step and
waits at the next boundary.  The arbiter (``resilience.arbiter``) and any
caller of ``request_resize`` live in rank 0's process.

Pipeline parallelism, as the JAX package's ``Trainer(layout="pp2",
n_microbatches=M)`` (or ``"dp2xpp2"``): each rank of a pipe group runs
its stage's layers over M microbatches on the 1F1B schedule
(``parallel.unified.make_pp_train_step``, ``parallel.pipeline_stages``),
every rank holds and updates the whole net (the JAX package's replicated
placement: every stage's gradients reach every rank), so ``params()``,
``score()`` and rank 0's checkpoints are the whole net's.  The step runs
eagerly (its exchanges go through the host each tick); a
``features_mask`` and tBPTT are refused, as the JAX package refuses them.

Supervised gangs (``resilience.supervisor``): a respawned child's
``fit`` with no ``resume_from`` resumes from its launcher context's
resume pointer (``parallel.launcher.child_context``), ``resume_state``
fires the ``gang.grow`` site in a child that a grow spawned and sends the
``resume`` event to the cluster telemetry, and ``step_batch`` stamps each
step on it (``obs.remote.notify_step``).  A worker sizes its layout from
``resilience.elastic.configured_width``.

Not ported yet: the model-axis layouts (``ROADMAP.md`` queue A item
2.5), the artifact store and the cost model's step hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import get_config, resolve_device
from deeplearning4j_tpu_torch.data.device_pipeline import (
    DeviceFeeder, FedBatch, ensure_feature_mask, pad_segment)
from deeplearning4j_tpu_torch.nn.layers.base import DataShard, data_shard
from deeplearning4j_tpu_torch.nn.losses import mean_score
from deeplearning4j_tpu_torch.obs import flight_recorder, profiler, tracing
from deeplearning4j_tpu_torch.obs import remote as obs_remote
from deeplearning4j_tpu_torch.obs.listeners import ListenerBus
from deeplearning4j_tpu_torch.obs.registry import get_registry, record_device_memory
from deeplearning4j_tpu_torch.obs.stats import (GROUPS, device_layer_stats, pack_stats,
                                                stats_keys, unpack_stats)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train import updaters as updater_mod
from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

# the step stream's seed is the config's seed plus this (the JAX package's key)
STREAM_SEED_OFFSET = 7919


def make_loss_fn(net, train: bool = True, with_carries: bool = False,
                 shard: Optional[DataShard] = None):
    """``(params, state, features, labels, features_mask, labels_mask, rng)
    -> (loss, new_state)``, ``rng`` the step's stream (the layers draw
    from it in order); ``train=False`` scores in inference mode (no
    dropout; BN uses its running statistics and leaves them).  With
    ``with_carries`` (tBPTT) the function takes the recurrent carries
    after ``state`` and returns ``(loss, (new_state, new_carries))``.  A
    per-timestep score array ``[B, T]`` without a labels mask is masked by
    the features mask.

    ``shard``: the layers run as this rank's part of a data-parallel step
    (``nn.layers.base.data_shard``).  Where it sums over the ranks
    (``shard.reduce``), the loss is this rank's share of the global one:
    its examples' scores over the global normalizer (the global example
    count, or the mask's count summed over the ranks) and the penalty on
    rank 0 only, so the shares, and their gradients, sum to the
    single-process step's."""
    synced = shard is not None and shard.reduce is not None

    def score(params, score_array, features_mask, labels_mask):
        if score_array is None:
            raise ValueError("the net has no output layer with a loss — use "
                             "OutputLayer or RnnOutputLayer as the final layer for fit()")
        mask = labels_mask
        if mask is None and score_array.ndim == 2 and features_mask is not None:
            mask = features_mask
        if net.conf.mini_batch and not synced:
            loss = mean_score(score_array, mask)
        elif net.conf.mini_batch and mask is None:
            loss = score_array.sum() / (score_array.numel() * shard.size)
        elif net.conf.mini_batch:
            mask = mask.reshape(score_array.shape).to(score_array.dtype)
            count = shard.reduce(mask.sum().reshape(1))[0]
            loss = (score_array * mask).sum() / count.clamp_min(1.0)
        else:   # minibatch(false): the sum, not the mean, over the examples
            if mask is not None:
                score_array = score_array * mask.reshape(score_array.shape)
            loss = score_array.sum()
        if synced and shard.rank != 0:
            return loss
        layer_params = net.layer_params(params) if hasattr(net, "layer_params") else params
        for layer, p in zip(net.layers, layer_params):
            if p:
                loss = loss + layer.regularization_penalty(p)
        return loss

    if with_carries:
        def loss_fn(params, state, carries, features, labels, features_mask, labels_mask,
                    rng=None):
            with data_shard(shard):
                _, new_state, score_array, new_carries = net._forward_impl(
                    params, state, features, carries, train=train, rng=rng,
                    mask=features_mask, labels=labels)
            return (score(params, score_array, features_mask, labels_mask),
                    (new_state, new_carries))
    else:
        def loss_fn(params, state, features, labels, features_mask, labels_mask, rng=None):
            with data_shard(shard):
                _, new_state, score_array = net._forward(params, state, features, train=train,
                                                         rng=rng, mask=features_mask,
                                                         labels=labels)
            return score(params, score_array, features_mask, labels_mask), new_state

    return loss_fn


def _top_keys(net) -> tuple:
    """The params' top-level keys (a layer stack's indices, a graph's
    vertex names) and each layer's key, in ``net.layers`` order."""
    if hasattr(net, "_topo"):
        return ([spec.name for spec in net._topo],
                [spec.name for spec in net._topo if spec.kind == "layer"])
    n = len(getattr(net, "layers", ()))
    return list(range(n)), list(range(n))


def net_optimizer(net) -> updater_mod.Optimizer:
    """The update a trainer of ``net`` steps, composed as the JAX package's
    ``Trainer`` composes its optax transform: the gradient normalization,
    the config's updater (``Sgd(0.1)`` without one), or with per-layer
    updaters one label per such layer (``"layer_{i}"``, ``i`` its index in
    ``net.layers``) beside ``"_default"``, then frozen layers' updates set
    to zero."""
    conf = net.conf
    updater = updater_mod.as_updater(conf.updater) if conf.updater else updater_mod.Sgd(0.1)
    normalization = getattr(conf, "gradient_normalization", None)
    threshold = getattr(conf, "gradient_normalization_threshold", 1.0)
    keys, layer_keys = _top_keys(net)
    stack = not hasattr(net, "_topo")

    def as_tree(by_key: dict):
        return [by_key[k] for k in keys] if stack else by_key

    labels = {k: updater_mod.DEFAULT_LABEL for k in keys}
    frozen = {k: False for k in keys}
    label_updaters = {updater_mod.DEFAULT_LABEL: updater}
    for i, (key, layer) in enumerate(zip(layer_keys, getattr(net, "layers", ()))):
        frozen[key] = bool(layer.frozen)
        if layer.updater is not None:
            labels[key] = f"layer_{i}"
            label_updaters[labels[key]] = updater_mod.as_updater(layer.updater)
    per_layer = len(label_updaters) > 1
    return updater_mod.Optimizer(
        updater, normalization, threshold,
        labels=as_tree(labels) if per_layer else None,
        label_updaters=label_updaters if per_layer else None,
        frozen=as_tree(frozen))


def _update(net, tx, loss_fn, layout=None):
    """``(params, state, opt_state, *args) -> (loss, aux, grads, updates)``:
    the loss and its gradient in every param (zeros where the loss never
    reads one), the optimizer's step (``tx``, :func:`net_optimizer`:
    normalization, updater, frozen layers) added to the params and its new
    state written into ``opt_state``, in place; ``aux`` is what
    ``loss_fn`` returned beside the loss, for the caller to write, and
    ``grads`` and ``updates`` the trees the statistics step reads.  Under
    a data-parallel ``layout`` (``parallel.mesh.MeshLayout``) the gradient
    and the loss are summed over its ranks in one all-reduce before the
    update: the global batch's."""

    def update(params, state, opt_state, *args):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(grad_params)
        with torch.enable_grad():
            loss, aux = loss_fn(grad_params, state, *args)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(flat), params)
        loss = loss.detach()
        if layout is not None:
            grads, (loss,) = layout.all_reduce_tree(grads, extra=(loss,))
        with torch.no_grad():
            updates, new_opt_state = tx.update(grads, opt_state, params)
            tree_map(lambda u, p: p.add_(u), updates, params)
            write_into(opt_state, new_opt_state)
        return loss, aux, grads, updates

    return update


def _step_shard(layout, shard):
    """The :class:`DataShard` a step's layers run as: ``shard`` as given,
    else the layout's (batch statistics summed over its ranks)."""
    return shard if shard is not None or layout is None else layout.data_shard()


def _eager_reason(layout):
    return None if layout is None else layout.eager_reason()


def make_train_step(net, tx, with_stats: bool = False, name="", layout=None, shard=None):
    """The training step, ``(params, state, opt_state, features, labels,
    features_mask, labels_mask, rng) -> (params, state, opt_state, loss)``:
    the params, the layers' state and the updater's state are updated in
    place and returned (the JAX package's donation); ``loss`` is a 0-dim
    tensor.  ``tx`` is the trainer's optimizer (:func:`net_optimizer`).
    A :class:`CapturedStep`: CUDA graphs on the card, the plain step on
    the CPU; ``name`` labels its errors.

    ``with_stats=True`` also returns the per-layer statistics of the new
    params, the gradients and the updates (``obs.stats``: norms, mean,
    stdev, 20-bin histograms), computed on the device in the same step
    and packed into one tensor (``obs.stats.pack_stats``;
    ``unpack_stats`` with ``stats_keys(params)`` reads it), so a sampled
    iteration costs one copy of a few kB, never the tensors.  The update
    is the plain step's, so it leaves the same params.

    ``layout`` (``parallel.mesh.MeshLayout``): the data-parallel step of
    the module docstring, run eagerly where the layout's collectives
    cannot be captured.  ``shard`` without a layout runs the layers as a
    :class:`DataShard` whose statistics stay its own (``ParallelWrapper``'s
    averaging mode)."""
    update = _update(net, tx, make_loss_fn(net, train=True, shard=_step_shard(layout, shard)),
                     layout)

    def step(params, state, opt_state, features, labels, features_mask, labels_mask, rng):
        loss, new_state, grads, updates = update(params, state, opt_state, features, labels,
                                                 features_mask, labels_mask, rng)
        with torch.no_grad():
            write_into(state, new_state)
            if with_stats:
                stats = dict(zip(GROUPS, (device_layer_stats(t)
                                          for t in (params, grads, updates))))
                return params, state, opt_state, loss, pack_stats(stats)
        return params, state, opt_state, loss

    return CapturedStep(step, n_trees=3, name=name, eager_reason=_eager_reason(layout))


def make_tbptt_step(net, tx, name="", layout=None, shard=None):
    """One tBPTT segment, ``(params, state, opt_state, carries, features,
    labels, features_mask, labels_mask, rng) -> (params, state, opt_state,
    carries, loss)``: :func:`make_train_step` with the recurrent carries
    as a fourth tree.  The segment starts from the carries (detached, so
    gradients stop at its start) and writes the segment's final carries
    into them after the backward, which reads the old ones.  ``layout`` and
    ``shard`` as :func:`make_train_step`'s; the carries are each rank's
    own."""
    update = _update(net, tx, make_loss_fn(net, train=True, with_carries=True,
                                           shard=_step_shard(layout, shard)), layout)

    def step(params, state, opt_state, carries, features, labels, features_mask, labels_mask,
             rng):
        loss, (new_state, new_carries), _, _ = update(
            params, state, opt_state, carries, features, labels, features_mask, labels_mask, rng)
        with torch.no_grad():
            write_into(state, new_state)
            for carry, new in zip(carries, new_carries):
                if new is not None:
                    write_into(carry, new)
        return params, state, opt_state, carries, loss

    return CapturedStep(step, n_trees=4, name=name, eager_reason=_eager_reason(layout))


def tbptt_segments(batch, length: int):
    """Split a batch of ``[B, T, C]`` sequences into segments of ``length``
    steps (``tBPTTLength``); a last segment shorter than ``length`` is
    padded to it with a masked tail, so every segment has one shape (the
    caller gives a batch whose T is no multiple of ``length`` a features
    mask first)."""
    t = batch.features.shape[1]
    for start in range(0, t, length):
        end = min(start + length, t)

        def cut(a, ndim):
            return a[:, start:end] if a is not None and a.ndim >= ndim else a
        seg = dataclasses.replace(batch, features=batch.features[:, start:end],
                                  labels=cut(batch.labels, 3),
                                  features_mask=cut(batch.features_mask, 2),
                                  labels_mask=cut(batch.labels_mask, 2))
        if end - start < length:
            seg = pad_segment(seg, length)
        yield seg


def make_eval_step(net, name="", layout=None):
    """Inference-mode loss, ``(params, state, features, labels,
    features_mask, labels_mask) -> loss`` (``MultiLayerNetwork.score
    (DataSet)``), captured as :func:`make_train_step` is; under a
    ``layout`` the global batch's, summed over its ranks."""
    loss_fn = make_loss_fn(net, train=False, shard=_step_shard(layout, None))

    def step(params, state, features, labels, features_mask, labels_mask):
        with torch.no_grad():
            loss = loss_fn(params, state, features, labels, features_mask, labels_mask)[0]
            if layout is not None:
                loss = layout.all_reduce_(loss.reshape(1).clone(), "loss")[0]
            return loss

    return CapturedStep(step, n_trees=2, name=name, eager_reason=_eager_reason(layout))


def _batch_masks(batch) -> tuple:
    """(features_mask, labels_mask), a ``MultiDataSet``'s plural names
    (``features_masks``, ``labels_masks``) when the batch has those."""
    fmask = getattr(batch, "features_mask", None)
    if fmask is None:
        fmask = getattr(batch, "features_masks", None)
    lmask = getattr(batch, "labels_mask", None)
    if lmask is None:
        lmask = getattr(batch, "labels_masks", None)
    return fmask, lmask


def _map_arrays(fn, value):
    """``fn`` over an array or tensor, or over each one of a list or tuple
    (a ``MultiDataSet``'s fields); None stays None."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        return [None if v is None else fn(v) for v in value]
    return fn(value)


class Trainer:
    """Trains ``net`` on the device its parameters live on (the net fixes
    it; a CUDA net without a card raises here), with the JAX package's
    listener hooks (``listeners``: a list or a ``ListenerBus``).  Its
    steps come from the step cache, keyed as the JAX package keys them
    (``_cache_sig`` plus the layout's signature and the step's kind); a net
    with frozen layers or per-layer updaters has no key, so each such
    trainer builds its own.

    ``mesh=`` / ``layout=`` pick a layout, the JAX package's one flag: a
    layout string (``"dp2"``, ``"pp2"``, ``"dp2xpp2"``), a
    ``parallel.mesh.MeshSpec`` or ``MeshLayout``, or a ``ProcessMesh`` from
    ``parallel.make_mesh`` (``parallel.mesh.resolve_layout``'s rules; the
    module docstring says what the step does).  Each process of the group
    calls it with the same net and batches.  The data, seq, expert and
    pipe axes are ported (the seq and expert ranks of a data position are
    replicas of its step; a pipe layout splits each batch into
    ``n_microbatches``, which other layouts ignore); a ``model`` axis
    raises ``NotImplementedError`` naming ``ROADMAP.md`` queue A item 2.5.
    A layout narrower than the gang parks the ranks past it (module
    docstring)."""

    def __init__(self, net, listeners=None, mesh=None, layout=None, n_microbatches: int = 1):
        self.net = net
        self.bus = listeners if isinstance(listeners, ListenerBus) else ListenerBus(listeners)
        resolve_device(net.device)
        self._layout = None
        if mesh is not None or layout is not None:
            # local import: parallel/ imports the trainer back
            from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
            self._layout = mesh_mod.resolve_layout(mesh=mesh, layout=layout, devices=net.device)
            if self._layout is not None and self._layout.device.type != net.device.type:
                raise ValueError(f"the mesh puts this rank on {self._layout.device}, the net is "
                                 f"on {net.device}")
        if int(n_microbatches) < 1:
            raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
        self._n_microbatches = int(n_microbatches)
        # the rows of each batch this process takes, and the shard its
        # layers run as (ParallelWrapper's averaging mode sets both alone)
        self._batch_layout = self._layout
        self._shard = None
        self._layout_placed = False
        # one checkpoint writer per group: rank 0
        net._writes_checkpoints = self._layout is None or self._layout.mesh.world_rank == 0
        # a width asked for by request_resize, applied at the next epoch boundary
        self._pending_resize: Optional[int] = None
        if net.params_ is None:
            net.init()
        self.tx = net_optimizer(net)   # an unknown updater or normalization raises here
        # the process-level step-cache identity; None (per-layer updaters,
        # frozen layers, a conf that cannot be serialized) builds per trainer
        self._cache_sig = None
        if self.tx.labels is None and self.tx.frozen is None:
            net_sig = step_cache.net_signature(net)
            tx_sig = step_cache.updater_signature(net.conf)
            if net_sig is not None and tx_sig is not None:
                self._cache_sig = net_sig + (tx_sig,)
        self._step = None
        self._stats_step = None
        self._eval_step = None
        self._tbptt_step = None
        self._carries: Optional[list] = None      # tBPTT's carry buffers
        self._stream: Optional[torch.Generator] = None
        self._resume_skip = 0                      # batches of the resumed epoch already run
        # the listeners that sample the statistics step (wants_stats_now)
        self._stats_listeners = [l for l in self.bus.listeners
                                 if getattr(l, "wants_model_stats", False)]
        self._stats_keys: Optional[list] = None
        self._compiled = False    # the first step through this trainer is its compile

    def _pipelined(self) -> bool:
        return self._layout is not None and self._layout.pipe > 1

    def _step_key(self, kind: str) -> Optional[tuple]:
        """Step-cache key of this trainer's config, or None (no cache); a
        pipe layout's names its microbatch count (``|mb:M``)."""
        if self._cache_sig is None:
            return None
        sig = step_cache.sharding_signature(self._layout)
        if self._pipelined():
            sig += f"|mb:{self._n_microbatches}"
        return self._cache_sig + (sig, kind)

    # ------------------------------------------------------------- elastic
    def request_resize(self, n_devices: int) -> None:
        """Ask for an elastic resize at the next epoch (round) boundary of
        ``fit``.  Validates here, at the decision site: no layout raises
        ``ValueError``; a width the layout's fixed axes refuse, or one past
        the gang's processes (a gang grows past them only by a relaunch,
        ``resilience.supervisor.ClusterSupervisor.request_resize``), raises
        ``parallel.mesh.LayoutResizeError``.  The latest request wins.  Only
        rank 0's request counts: it broadcasts it at the boundary."""
        from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
        if self._layout is None:
            raise ValueError("request_resize needs a mesh/layout-configured Trainer (the "
                             "single-device path has no width to change)")
        n = int(n_devices)
        mesh_mod.resize_spec(self._layout.spec, n)   # validate
        world = self._layout.mesh.world_size
        if n > world:
            raise mesh_mod.LayoutResizeError(
                f"cannot resize layout {self._layout.describe()!r} to {n} devices in place: the "
                f"gang has {world} processes; a gang grows past them by a relaunch at the new "
                f"width (resilience.supervisor.ClusterSupervisor.request_resize)")
        self._pending_resize = n

    def _agree_resize(self, n_devices: Optional[int]) -> Optional[int]:
        """Rank 0's width and its checks, in one broadcast over the gang
        (``parallel.mesh.park_group``): rank 0 derives the new layout's
        spec and, on a grow, fires ``gang.grow`` before anything changes,
        so that every rank sees the same outcome.  Returns the width (None:
        no resize); a failure on rank 0 raises there, and on every other
        rank as the same type with rank 0's message."""
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
        mesh = self._layout.mesh
        error: Optional[BaseException] = None
        decision = [None, None, ""]
        if mesh.world_rank == 0:
            decision[0] = n_devices
            if n_devices is not None and int(n_devices) != self._layout.spec.total():
                try:
                    self.request_resize(n_devices)      # the same checks, here
                    self._pending_resize = None
                    if int(n_devices) > self._layout.spec.total():
                        faults.fire("gang.grow")
                except BaseException as e:  # noqa: BLE001 — every rank raises it below
                    error = e
                    decision[1:] = [type(e).__name__, str(e)]
        if mesh.world_size > 1:
            group = mesh_mod.park_group(mesh.world)
            root = 0 if mesh.world is None else dist.get_global_rank(mesh.world, 0)
            dist.broadcast_object_list(decision, src=root, group=group)
        if error is not None:
            raise error
        if decision[1] is not None:
            kinds = {"InjectedCrash": faults.InjectedCrash, "InjectedFault": faults.InjectedFault,
                     "LayoutResizeError": mesh_mod.LayoutResizeError}
            raise kinds.get(decision[1], RuntimeError)(
                f"rank 0 refused the resize ({decision[1]}): {decision[2]}")
        return None if decision[0] is None else int(decision[0])

    def resize_mesh(self, n_devices: Optional[int]) -> bool:
        """Move this trainer's layout to ``n_devices`` (grow or shrink), in
        every rank of the gang at once (each calls it; rank 0's width
        counts, None: rank 0's pending request or nothing).  In order: the
        new width agreed (:meth:`_agree_resize`: a refused width raises
        ``LayoutResizeError`` and a crash at ``gang.grow`` raises, on every
        rank, before anything changes); the layout at the new width over the
        world's leading ranks (``parallel.mesh.resize_layout``; the groups
        of a width are made once and reused); on a grow, rank 0's params,
        layer state, updater state, counters and random stream broadcast to
        the ranks in the new layout; every artifact of the old width dropped
        (steps, step-cache entries under its signature, the rows each rank
        takes); the step rebuilt, so that the flip's cost lands in
        ``tpudl_elastic_flip_seconds``; the ``tpudl_elastic_*`` series, the
        ``elastic_resize`` flight event and the cluster telemetry's event.
        Returns False when the width is already current."""
        from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
        if self._layout is None:
            raise ValueError("resize_mesh needs a mesh/layout-configured Trainer")
        pending, self._pending_resize = self._pending_resize, None
        width = self._agree_resize(n_devices if n_devices is not None else pending)
        old_layout = self._layout
        old_width = old_layout.spec.total()
        if width is None or width == old_width:
            return False
        grow = width > old_width
        t0 = time.perf_counter()
        new_layout = mesh_mod.resize_layout(old_layout, width, devices=old_layout.mesh.world_devices)
        self._layout = new_layout
        if self._batch_layout is old_layout:
            self._batch_layout = new_layout
        self._layout_placed = False
        self._step = self._stats_step = self._eval_step = self._tbptt_step = None
        step_cache.drop_sharding(step_cache.sharding_signature(old_layout))
        if new_layout.member:
            if grow:
                self._join(new_layout)
            self._place_layout(replicate=grow)
        self._ensure_ready()
        flip_s = time.perf_counter() - t0
        reg = get_registry()
        direction = "grow" if grow else "shrink"
        reg.counter(f"tpudl_elastic_{direction}s_total").inc()
        reg.gauge("tpudl_elastic_gang_width").set(width)
        reg.histogram("tpudl_elastic_flip_seconds").observe(flip_s)
        flight_recorder.record("elastic_resize", direction=direction, from_width=old_width,
                               to_width=width, layout=new_layout.spec.describe(), flip_s=flip_s)
        obs_remote.notify_event("elastic_resize", direction=direction, from_width=old_width,
                                to_width=width)
        return True

    def _join(self, layout) -> None:
        """A grow's hand-over inside ``layout``: rank 0's counters and random
        stream (one object broadcast), then its trees (``_place_layout``)."""
        import torch.distributed as dist
        net = self.net
        box = [(net.iteration, net.epoch,
                None if self._stream is None else self._stream.get_state())]
        mesh = layout.mesh
        dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
        net.iteration, net.epoch, stream = box[0]
        if stream is not None:
            if self._stream is None:
                self._stream = self._new_stream()
            self._stream.set_state(stream)

    @property
    def parked(self) -> bool:
        """Whether this rank sits outside its layout (it runs no step)."""
        return self._layout is not None and not self._layout.member

    def _new_stream(self) -> torch.Generator:
        return torch.Generator(device=self.net.device).manual_seed(
            self.net.conf.seed + STREAM_SEED_OFFSET)

    def _rows(self, batch):
        """This process's rows of every array of ``batch`` under a
        data-parallel layout; the batch itself otherwise."""
        layout = self._batch_layout
        if layout is None:
            return batch
        return dataclasses.replace(batch, **{f.name: layout.shard_batch(getattr(batch, f.name))
                                             for f in dataclasses.fields(batch)})

    def _host_batch(self, batch):
        """A batch's numpy arrays as (host) tensors, tensors as they are, this
        process's rows of them: the feeder's placement, which then stages
        them on the device."""
        def as_tensor(v):
            return v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))

        return self._rows(dataclasses.replace(
            batch, **{f.name: _map_arrays(as_tensor, getattr(batch, f.name))
                      for f in dataclasses.fields(batch)}))

    def _place(self, batch):
        dev = self.net.device

        def put(v):
            return v.to(dev) if torch.is_tensor(v) else torch.as_tensor(np.asarray(v), device=dev)

        batch = self._rows(batch)
        return dataclasses.replace(batch, **{f.name: _map_arrays(put, getattr(batch, f.name))
                                             for f in dataclasses.fields(batch)})

    def _replicated(self) -> list:
        """The trees every rank takes from rank 0 when a layout starts."""
        return [self.net.params_, self.net.state_, self.net.opt_state]

    def _place_layout(self, replicate: bool = True) -> None:
        """Once per layout: every rank takes rank 0's params, layer state and
        updater state (a broadcast each; not after a shrink, whose ranks
        hold them already), and the ``tpudl_mesh_*`` gauges and
        ``tpudl_parallel_mesh_devices`` describe the layout."""
        net, layout = self.net, self._layout
        if replicate:
            layout.replicate(self._replicated())
        param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(net.params_))
        layout.publish_metrics(param_bytes=param_bytes)
        get_registry().gauge("tpudl_parallel_mesh_devices").set(layout.data)
        self._layout_placed = True

    def _ensure_ready(self) -> None:
        net = self.net
        if net.params_ is None:
            net.init()
        if net.opt_state is None:
            net.opt_state = self.tx.init(net.params_)
        if self._layout is not None and not self._layout_placed and self._layout.member:
            self._place_layout()
        if self._step is None:
            key = self._step_key("train")
            if self._pipelined():
                from deeplearning4j_tpu_torch.parallel import unified
                layout, mb = self._layout, self._n_microbatches
                self._step = step_cache.get_or_build(key, lambda: unified.make_pp_train_step(
                    net, self.tx, layout, mb))
            else:
                self._step = step_cache.get_or_build(key, lambda: make_train_step(
                    net, self.tx, name=key, layout=self._layout, shard=self._shard))

    def _step_fns(self) -> tuple:
        """Every step this trainer may call: the recompile count sums the
        signatures they have seen around each step."""
        return (self._step, self._stats_step, self._tbptt_step, self._eval_step)

    def _stream_or(self, rng: Optional[torch.Generator]) -> torch.Generator:
        """``rng``, checked, or the trainer's own stream when None: a
        generator on another device than the net's is refused, since
        drawing on the host would copy every mask to the card."""
        if rng is None:
            if self._stream is None:
                self._stream = self._new_stream()
            return self._stream
        if not isinstance(rng, torch.Generator):
            raise TypeError(f"rng must be a torch.Generator or None, got {type(rng).__name__}")
        if rng.device.type != self.net.device.type:
            raise ValueError(f"rng is a generator on {rng.device.type}, the net is on "
                             f"{self.net.device.type}: make it with torch.Generator(device=...) "
                             f"on the net's device")
        return rng

    def fit_batch(self, batch, rng: Optional[torch.Generator] = None,
                  prepared: bool = False) -> torch.Tensor:
        """One optimization step on one batch; returns the loss as a 0-dim
        tensor on the device.  ``rng`` is the step's random stream, a
        ``torch.Generator`` on the net's device (:meth:`_stream_or`).  On
        an iteration that a statistics listener samples
        (``wants_stats_now``) the statistics step runs in the plain step's
        place, its statistics come to the host in one copy and every such
        listener gets ``stats_ready``.  Under ``config.nan_panic`` or
        ``inf_panic`` the params are checked after the step.  Under a
        layout ``batch`` is the global batch, and the loss the global
        batch's; ``prepared`` marks a batch the feeder already cut to this
        process's rows and staged."""
        net = self.net
        if self.parked:
            raise RuntimeError(f"this rank is parked outside layout {self._layout.describe()!r}; "
                               f"it steps again once a resize takes it back")
        rng = self._stream_or(rng)
        if not prepared:
            batch = self._place(batch)
        self._ensure_ready()
        fmask, lmask = _batch_masks(batch)
        if self._pipelined() and fmask is not None:
            raise ValueError("pipe-axis layouts do not support features_mask (per-timestep "
                             "masking) — use a data/model layout; labels_mask (bucket padding) "
                             "rides the packed labels")
        args = (net.params_, net.state_, net.opt_state, batch.features, batch.labels, fmask,
                lmask, rng)
        sampling = [l for l in self._stats_listeners if l.wants_stats_now(net.iteration)]
        if sampling:
            if self._stats_step is None:
                key = self._step_key("train_stats")
                self._stats_step = step_cache.get_or_build(
                    key, lambda: make_train_step(net, self.tx, with_stats=True, name=key,
                                                 layout=self._layout, shard=self._shard))
            net.params_, net.state_, net.opt_state, loss, packed = self._stats_step(*args)
            if self._stats_keys is None:
                self._stats_keys = stats_keys(net.params_)
            stats = unpack_stats(packed, self._stats_keys)
            for listener in sampling:
                listener.stats_ready(net, net.iteration, net.epoch, float(loss), stats)
        else:
            net.params_, net.state_, net.opt_state, loss = self._step(*args)
        cfg = get_config()
        if cfg.nan_panic or cfg.inf_panic:
            profiler.check_finite(net.params_, "params after step")
        return loss

    def eval_loss(self, batch) -> torch.Tensor:
        """Inference-mode loss on one batch, no update."""
        net = self.net
        batch = self._place(batch)
        if self._layout is not None and not self._layout_placed and self._layout.member:
            self._place_layout()
        if self._eval_step is None:
            key = self._step_key("eval")
            self._eval_step = step_cache.get_or_build(
                key, lambda: make_eval_step(net, key, layout=self._layout))
        fmask, lmask = _batch_masks(batch)
        return self._eval_step(net.params_, net.state_, batch.features, batch.labels, fmask,
                               lmask)

    def _carry_buffers(self, features) -> list:
        """The tBPTT carries, one entry per layer (``()`` where a layer is
        not recurrent): the same buffers for every batch of one shape,
        zeroed, so a captured segment step finds its own buffers again."""
        from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer
        b, dtype, device = features.shape[0], features.dtype, features.device
        if self._carries is None or any(
                (t.shape[0], t.dtype, t.device) != (b, dtype, device)
                for t in tree_leaves(self._carries)):
            self._carries = [layer.init_carry(b, dtype, device)
                             if isinstance(layer, BaseRecurrentLayer) else ()
                             for layer in self.net.layers]
        else:
            tree_map(lambda t: t.zero_(), self._carries)
        return self._carries

    def _fit_tbptt(self, batch, rng: torch.Generator, prepared: bool = False) -> torch.Tensor:
        """Truncated BPTT over one batch of whole sequences: one step per
        segment of ``conf.tbptt_fwd_length``, the forward state carried
        from segment to segment (gradients cut at each boundary), the
        dropout masks drawn from ``rng`` in turn.  A T that is no multiple
        of the length gets an all-ones features mask, and the short tail is
        padded with masked steps, so every segment runs one captured step.
        Returns the last segment's loss; under a layout the carries hold
        this process's rows."""
        if self._pipelined():
            raise NotImplementedError("tBPTT is not supported on pipe-axis layouts (recurrent "
                                      "carries cannot ride the 1F1B ring); use a data/model "
                                      "layout")
        net = self.net
        length = net.conf.tbptt_fwd_length
        if batch.features.shape[1] % length:
            batch = ensure_feature_mask(batch)
        if not prepared:
            batch = self._place(batch)
        self._ensure_ready()
        if self._tbptt_step is None:
            key = self._step_key("tbptt")
            self._tbptt_step = step_cache.get_or_build(
                key, lambda: make_tbptt_step(net, self.tx, key, layout=self._layout,
                                             shard=self._shard))
        carries = self._carry_buffers(batch.features)
        loss = None
        for seg in tbptt_segments(batch, length):
            net.params_, net.state_, net.opt_state, carries, loss = self._tbptt_step(
                net.params_, net.state_, net.opt_state, carries, seg.features, seg.labels,
                seg.features_mask, seg.labels_mask, rng)
        cfg = get_config()
        if cfg.nan_panic or cfg.inf_panic:
            profiler.check_finite(net.params_, "params after tBPTT step")
        return loss

    def step_batch(self, batch, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """One training iteration with the whole of its bookkeeping: a tBPTT
        configuration trains a batch of sequences (3-D features) by
        :meth:`_fit_tbptt`, the rest by :meth:`fit_batch`; the score is
        kept on the net, every listener's ``record_batch`` gets the
        batch's real example count, ``iteration_done`` goes through the bus
        with the score read back as a float (only when a listener is
        there), and the net's iteration counter moves.  ``fit`` and
        ``EarlyStoppingTrainer`` drive it; ``batch`` may be a feeder's
        ``FedBatch``.

        Telemetry: the ``trainer.step`` fault site before the step (a
        ``nan`` rule poisons the returned loss after it, as a NaN tensor
        on the net's device), the flight recorder's progress and ``step``
        event, a ``step`` span (with tracing on: ``score``, ``compile`` on
        the trainer's first step and ``hbm_bytes_in_use``, after waiting
        for the card), and the ``tpudl_train_*`` series.  With tracing off
        the step waits for nothing, and ``tpudl_train_step_seconds``
        records the host's time to launch it."""
        net = self.net
        # the clock starts before the fault site: an injected delay models
        # a slow step, so it shows in the step time
        t0 = time.perf_counter()
        faults.fire("trainer.step", index=net.iteration)
        flight_recorder.progress("trainer.step")
        fed = isinstance(batch, FedBatch)
        data = batch.batch if fed else batch
        features = data.features
        first = features[0] if isinstance(features, (list, tuple)) else features
        n_examples = batch.n_examples if fed else int(first.shape[0])
        compile_step = not self._compiled
        seen_before = step_cache.seen_signatures(*self._step_fns())
        graphs_before = step_cache.captured_graphs(*self._step_fns())
        with tracing.span("step", iteration=net.iteration, epoch=net.epoch) as sp:
            if (net.conf.backprop_type == "tbptt" and not isinstance(features, (list, tuple))
                    and np.ndim(first) == 3):
                loss = self._fit_tbptt(data, self._stream_or(rng), prepared=fed)
            else:
                loss = self.fit_batch(data, rng, prepared=fed)
            if tracing.get_tracer().enabled:
                score = float(tracing.device_sync(loss))
                sp.set_attribute("score", score)
                if compile_step:
                    sp.set_attribute("compile", True)
                hbm = record_device_memory(device=net.device)
                if hbm and "bytes_in_use" in hbm:
                    sp.set_attribute("hbm_bytes_in_use", hbm["bytes_in_use"])
                get_registry().gauge("tpudl_train_last_score").set(score)
        dt = time.perf_counter() - t0
        self._compiled = True
        retraced = step_cache.seen_signatures(*self._step_fns()) - seen_before
        captured = step_cache.captured_graphs(*self._step_fns()) - graphs_before
        reg = get_registry()
        if retraced > 0:
            reg.counter("tpudl_train_recompiles_total").inc(retraced)
            reg.gauge("tpudl_train_compile_seconds").set(dt)
        elif captured > 0:
            # capturing a signature's graph is the port's compile too
            reg.gauge("tpudl_train_compile_seconds").set(dt)
        else:
            reg.histogram("tpudl_train_step_seconds").observe(dt)
        reg.counter("tpudl_train_steps_total").inc()
        reg.counter("tpudl_train_examples_total").inc(n_examples)
        flight_recorder.record("step", iteration=net.iteration, epoch=net.epoch,
                               duration_ms=round(dt * 1e3, 3), examples=n_examples,
                               compile=bool(retraced))
        flight_recorder.progress("trainer.step")
        # a "nan" rule poisons the reported loss (a numeric blow-up's stand-in)
        # so that the health monitor's detection runs end to end
        if faults.poison("trainer.step", index=net.iteration):
            loss = torch.full_like(loss, float("nan"))
        # this worker's progress onto the coordinator's dashboard (a buffer
        # append: the router's thread reads the loss and sends it)
        obs_remote.notify_step(net.iteration, epoch=net.epoch, duration_s=dt, score=loss,
                               examples=n_examples, compile=bool(retraced))
        net._score = loss
        if self.bus.listeners:
            for listener in self.bus.listeners:
                if hasattr(listener, "record_batch"):
                    listener.record_batch(n_examples)
            self.bus.dispatch("iteration_done", net, net.iteration, net.epoch, loss.item())
        net.iteration += 1
        return loss

    def resume_state(self, source, iterator=None) -> dict:
        """Restore the training state of ``source`` (a checkpoint zip, or a
        directory of them: its newest intact one) into this trainer's net:
        params, layer state, updater state, the iteration and epoch
        counters, the dtype policy and the random stream (when the zip
        holds the port's own stream state), and fast-forward ``iterator``
        past the batches already run when the checkpoint was taken
        mid-epoch (a ``ResumableIterator``; another iterator raises
        ``ValueError`` there).  Returns the checkpoint's training-state
        dict, with ``checkpoint_path``."""
        from deeplearning4j_tpu_torch.config import DTypePolicy, set_dtype_policy
        from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
        from deeplearning4j_tpu_torch.io.model_serializer import (
            read_iterator_state, restore_into)
        path, verified = source, False
        if os.path.isdir(source):
            # discovery verifies each candidate, newest first
            path, verified = CheckpointListener.last_checkpoint_in(source), True
            if path is None:
                raise FileNotFoundError(f"no intact checkpoint found under {source}")
        elif not os.path.exists(source):
            raise FileNotFoundError(f"resume_from path does not exist: {source}")
        self._ensure_ready()
        state = restore_into(self.net, path, tx=self.tx, verify=not verified)
        # a child respawned by a grow announces the reshard here: a kill
        # planted at this site leaves the checkpoint intact and recovers
        # by the supervisor's respawn
        from deeplearning4j_tpu_torch.resilience import elastic
        if elastic.is_grown_child():
            faults.fire("gang.grow")
        policy = state.get("dtype_policy")
        if policy:
            set_dtype_policy(DTypePolicy(**{k: getattr(torch, v) for k, v in policy.items()}))
        skip = int(state.get("epoch_batches", 0) or 0)
        if skip:
            if iterator is None or not hasattr(iterator, "set_state"):
                raise ValueError(
                    f"checkpoint {path} was taken mid-epoch ({skip} batches in); resuming "
                    f"exactly needs a ResumableIterator (data.iterators) to fast-forward")
            # the position comes from the trainer's counters: the feeder
            # prefetches ahead, so the iterator's own count runs ahead
            it_state = read_iterator_state(path) or {}
            it_state.update({"epoch": self.net.epoch, "batch_index": skip})
            iterator.set_state(it_state)
        self._resume_skip = skip
        state["checkpoint_path"] = path
        # the resume point, for the dashboard and the supervisor's steps
        # replayed after a crash (the last iteration before it, less this)
        resumed_iter = int(state.get("iteration", 0) or 0)
        reg = get_registry()
        reg.counter("tpudl_resilience_resumes_total").inc()
        reg.gauge("tpudl_resilience_resumed_iteration").set(resumed_iter)
        flight_recorder.record("resume", iteration=resumed_iter,
                               epoch=int(state.get("epoch", 0) or 0),
                               checkpoint=os.path.basename(path))
        obs_remote.notify_event("resume", iteration=resumed_iter,
                                epoch=int(state.get("epoch", 0) or 0),
                                checkpoint=os.path.basename(path))
        return state

    def fit(self, iterator, epochs: int = 1, resume_from=None):
        """``epochs`` passes over ``iterator`` (reset before each), each
        batch staged on the device by a ``DeviceFeeder`` (when
        ``config.device_feed``; one feeder for the whole call) and run by
        :meth:`step_batch`, with the listeners' ``on_fit_start``,
        ``on_epoch_start``, ``on_epoch_end`` (``epoch_time_s``,
        ``batches``, ``score``) and ``on_fit_end``.  The random stream is
        made anew from the config's seed, or restored with the training
        state: with ``resume_from`` (a checkpoint zip or a directory of
        them) the run continues from it (:meth:`resume_state`), ``epochs``
        counting the whole run, so an interrupted fit resumed here repeats
        the uninterrupted run's steps.  Without ``resume_from``, a gang
        child that its supervisor respawned resumes from the pointer in
        its launcher context.  The net carries what a checkpoint
        taken now records (``_completed_iterations``, ``_completed_epochs``,
        ``_epoch_batches`` and ``_stream``).

        Under a layout, each epoch starts at a boundary where the gang
        agrees on rank 0's pending resize (:meth:`request_resize`) and
        applies it (:meth:`resize_mesh`); a parked rank sits the epoch out
        and waits at the next boundary.  Every rank of the gang calls ``fit``
        with the same epochs.

        Telemetry: a ``fit`` span with ``net.trace_attrs()``, an ``epoch``
        span per epoch, ``tpudl_train_epoch_seconds`` and
        ``tpudl_train_epochs_total``, and under ``config.profiling`` a
        ``torch.profiler`` trace of the whole call written into
        ``config.trace_dir`` (``obs.profiler.trace``)."""
        net = self.net
        epochs_to_run = epochs
        if resume_from is None:
            from deeplearning4j_tpu_torch.parallel.launcher import child_context
            resume_from = child_context().resume_from
        if resume_from is not None:
            self.resume_state(resume_from, iterator)
            epochs_to_run = max(0, epochs - net.epoch)
        self._ensure_ready()
        self._stream = self._new_stream()
        saved = getattr(net, "_stream_state", None)
        if saved is not None:
            self._stream.set_state(saved)
            net._stream_state = None
        net._stream = self._stream
        cfg = get_config()
        feeder = (DeviceFeeder(self._host_batch, depth=cfg.prefetch_size, device=net.device)
                  if cfg.device_feed else None)
        reg = get_registry()
        with (profiler.trace(cfg.trace_dir) if cfg.profiling else contextlib.nullcontext()), \
                tracing.span("fit", epochs=epochs, **net.trace_attrs()):
            self.bus.dispatch("on_fit_start", net)
            for _ in range(epochs_to_run):
                if self._layout is not None:
                    # the round boundary: a feeder restarts each epoch, so no
                    # batch cut for the old width reaches the new step
                    self.resize_mesh(None)
                if self.parked:
                    net.epoch += 1
                    continue
                with tracing.span("epoch", epoch=net.epoch):
                    self.bus.dispatch("on_epoch_start", net, net.epoch)
                    t0 = time.perf_counter()
                    n_batches, self._resume_skip = self._resume_skip, 0
                    net._completed_epochs = net.epoch
                    if hasattr(iterator, "reset"):
                        iterator.reset()
                    for batch in (feeder.feed(iterator) if feeder is not None else iterator):
                        # what a checkpoint taken during this step records
                        net._completed_iterations = net.iteration + 1
                        net._epoch_batches = n_batches + 1
                        self.step_batch(batch, self._stream)
                        n_batches += 1
                    # a checkpoint from here on resumes at the next epoch's first batch
                    net._completed_epochs = net.epoch + 1
                    net._epoch_batches = 0
                    epoch_s = time.perf_counter() - t0
                    reg.histogram("tpudl_train_epoch_seconds").observe(epoch_s)
                    info = {"epoch_time_s": epoch_s, "batches": n_batches, "score": net._score}
                    self.bus.dispatch("on_epoch_end", net, net.epoch, info)
                reg.counter("tpudl_train_epochs_total").inc()
                net.epoch += 1
            self.bus.dispatch("on_fit_end", net, {"epochs": epochs})
        # a completed fit draws from the seed again next time; an
        # interrupted one leaves the stream for its checkpoints
        net._stream = None
        return net
