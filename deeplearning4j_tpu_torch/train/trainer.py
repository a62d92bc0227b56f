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

Not ported yet: parallel layouts, listeners, the step statistics
(``with_stats``), the artifact store and resume from a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import resolve_device
from deeplearning4j_tpu_torch.data.device_pipeline import ensure_feature_mask, pad_segment
from deeplearning4j_tpu_torch.nn.losses import mean_score
from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train import updaters as updater_mod
from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

# the step stream's seed is the config's seed plus this (the JAX package's key)
STREAM_SEED_OFFSET = 7919


def make_loss_fn(net, train: bool = True, with_carries: bool = False):
    """``(params, state, features, labels, features_mask, labels_mask, rng)
    -> (loss, new_state)``, ``rng`` the step's stream (the layers draw
    from it in order); ``train=False`` scores in inference mode (no
    dropout; BN uses its running statistics and leaves them).  With
    ``with_carries`` (tBPTT) the function takes the recurrent carries
    after ``state`` and returns ``(loss, (new_state, new_carries))``.  A
    per-timestep score array ``[B, T]`` without a labels mask is masked by
    the features mask."""

    def score(params, score_array, features_mask, labels_mask):
        if score_array is None:
            raise ValueError("the net has no output layer with a loss — use "
                             "OutputLayer or RnnOutputLayer as the final layer for fit()")
        mask = labels_mask
        if mask is None and score_array.ndim == 2 and features_mask is not None:
            mask = features_mask
        if net.conf.mini_batch:
            loss = mean_score(score_array, mask)
        else:   # minibatch(false): the sum, not the mean, over the examples
            if mask is not None:
                score_array = score_array * mask.reshape(score_array.shape)
            loss = score_array.sum()
        layer_params = net.layer_params(params) if hasattr(net, "layer_params") else params
        for layer, p in zip(net.layers, layer_params):
            if p:
                loss = loss + layer.regularization_penalty(p)
        return loss

    if with_carries:
        def loss_fn(params, state, carries, features, labels, features_mask, labels_mask,
                    rng=None):
            _, new_state, score_array, new_carries = net._forward_impl(
                params, state, features, carries, train=train, rng=rng, mask=features_mask,
                labels=labels)
            return (score(params, score_array, features_mask, labels_mask),
                    (new_state, new_carries))
    else:
        def loss_fn(params, state, features, labels, features_mask, labels_mask, rng=None):
            _, new_state, score_array = net._forward(params, state, features, train=train,
                                                     rng=rng, mask=features_mask,
                                                     labels=labels)
            return score(params, score_array, features_mask, labels_mask), new_state

    return loss_fn


def _normalizer(net):
    conf = net.conf
    return updater_mod.gradient_normalization(conf.gradient_normalization,
                                              conf.gradient_normalization_threshold)


def _update(net, updater, loss_fn):
    """``(params, state, opt_state, *args) -> (loss, aux)``: the loss and its
    gradient in every param (zeros where the loss never reads one), the
    gradient normalized and the updater's step added to the params and its
    new state written into ``opt_state``, in place; ``aux`` is what
    ``loss_fn`` returned beside the loss, for the caller to write."""
    normalize = _normalizer(net)

    def update(params, state, opt_state, *args):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(grad_params)
        with torch.enable_grad():
            loss, aux = loss_fn(grad_params, state, *args)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(flat), params)
        with torch.no_grad():
            updates, new_opt_state = updater.update(normalize(grads), opt_state)
            tree_map(lambda p, u: p.add_(u), params, updates)
            write_into(opt_state, new_opt_state)
        return loss.detach(), aux

    return update


def make_train_step(net, updater, name=""):
    """The training step, ``(params, state, opt_state, features, labels,
    features_mask, labels_mask, rng) -> (params, state, opt_state, loss)``:
    the params, the layers' state and the updater's state are updated in
    place and returned (the JAX package's donation); ``loss`` is a 0-dim
    tensor.  A :class:`CapturedStep`: CUDA graphs on the card, the plain
    step on the CPU; ``name`` labels its errors."""
    update = _update(net, updater, make_loss_fn(net, train=True))

    def step(params, state, opt_state, features, labels, features_mask, labels_mask, rng):
        loss, new_state = update(params, state, opt_state, features, labels, features_mask,
                                 labels_mask, rng)
        with torch.no_grad():
            write_into(state, new_state)
        return params, state, opt_state, loss

    return CapturedStep(step, n_trees=3, name=name)


def make_tbptt_step(net, updater, name=""):
    """One tBPTT segment, ``(params, state, opt_state, carries, features,
    labels, features_mask, labels_mask, rng) -> (params, state, opt_state,
    carries, loss)``: :func:`make_train_step` with the recurrent carries
    as a fourth tree.  The segment starts from the carries (detached, so
    gradients stop at its start) and writes the segment's final carries
    into them after the backward, which reads the old ones."""
    update = _update(net, updater, make_loss_fn(net, train=True, with_carries=True))

    def step(params, state, opt_state, carries, features, labels, features_mask, labels_mask,
             rng):
        loss, (new_state, new_carries) = update(params, state, opt_state, carries, features,
                                                labels, features_mask, labels_mask, rng)
        with torch.no_grad():
            write_into(state, new_state)
            for carry, new in zip(carries, new_carries):
                if new is not None:
                    write_into(carry, new)
        return params, state, opt_state, carries, loss

    return CapturedStep(step, n_trees=4, name=name)


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


def make_eval_step(net, name=""):
    """Inference-mode loss, ``(params, state, features, labels,
    features_mask, labels_mask) -> loss`` (``MultiLayerNetwork.score
    (DataSet)``), captured as :func:`make_train_step` is."""
    loss_fn = make_loss_fn(net, train=False)

    def step(params, state, features, labels, features_mask, labels_mask):
        with torch.no_grad():
            return loss_fn(params, state, features, labels, features_mask, labels_mask)[0]

    return CapturedStep(step, n_trees=2, name=name)


class Trainer:
    """Trains ``net`` on the device its parameters live on (the net fixes
    it; a CUDA net without a card raises here).  Its steps come from the
    step cache, keyed as the JAX package keys them (``_cache_sig`` plus
    ``"train"`` or ``"eval"``)."""

    def __init__(self, net):
        self.net = net
        resolve_device(net.device)
        conf = net.conf
        self.updater = (updater_mod.from_dict(conf.updater) if conf.updater
                        else updater_mod.Sgd(0.1))
        _normalizer(net)   # an unknown normalization raises here
        for layer in net.layers:
            if layer.updater is not None or layer.frozen:
                raise NotImplementedError(
                    f"{type(layer).__name__}: per-layer updaters and frozen layers "
                    f"are not ported yet")
        if net.params_ is None:
            net.init()
        # the process-level step-cache identity; None (a conf that cannot be
        # serialized) builds per trainer
        net_sig = step_cache.net_signature(net)
        tx_sig = step_cache.updater_signature(conf)
        self._cache_sig = (net_sig + (tx_sig,) if net_sig is not None and tx_sig is not None
                           else None)
        self._step = None
        self._eval_step = None
        self._tbptt_step = None
        self._carries: Optional[list] = None      # tBPTT's carry buffers
        self._stream: Optional[torch.Generator] = None

    def _step_key(self, kind: str) -> Optional[tuple]:
        """Step-cache key of this trainer's config, or None (no cache)."""
        if self._cache_sig is None:
            return None
        return self._cache_sig + (step_cache.sharding_signature(None), kind)

    def _new_stream(self) -> torch.Generator:
        return torch.Generator(device=self.net.device).manual_seed(
            self.net.conf.seed + STREAM_SEED_OFFSET)

    def _place(self, batch):
        dev = self.net.device

        def put(v):
            if v is None:
                return None
            return v.to(dev) if torch.is_tensor(v) else torch.as_tensor(np.asarray(v), device=dev)

        return dataclasses.replace(batch, **{f.name: put(getattr(batch, f.name))
                                             for f in dataclasses.fields(batch)})

    def fit_batch(self, batch, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """One optimization step on one batch; returns the loss as a 0-dim
        tensor on the device.  ``rng`` is the step's random stream, a
        ``torch.Generator`` on the net's device (the trainer's own stream
        when None): a generator elsewhere is refused, since drawing on
        the host would copy every mask to the card."""
        net = self.net
        if rng is None:
            if self._stream is None:
                self._stream = self._new_stream()
            rng = self._stream
        elif not isinstance(rng, torch.Generator):
            raise TypeError(f"rng must be a torch.Generator or None, got {type(rng).__name__}")
        elif rng.device.type != net.device.type:
            raise ValueError(f"rng is a generator on {rng.device.type}, the net is on "
                             f"{net.device.type}: make it with torch.Generator(device=...) "
                             f"on the net's device")
        batch = self._place(batch)
        if net.opt_state is None:
            net.opt_state = self.updater.init(net.params_)
        if self._step is None:
            key = self._step_key("train")
            self._step = step_cache.get_or_build(
                key, lambda: make_train_step(net, self.updater, key))
        net.params_, net.state_, net.opt_state, loss = self._step(
            net.params_, net.state_, net.opt_state, batch.features, batch.labels,
            batch.features_mask, batch.labels_mask, rng)
        return loss

    def eval_loss(self, batch) -> torch.Tensor:
        """Inference-mode loss on one batch, no update."""
        net = self.net
        batch = self._place(batch)
        if self._eval_step is None:
            key = self._step_key("eval")
            self._eval_step = step_cache.get_or_build(key, lambda: make_eval_step(net, key))
        return self._eval_step(net.params_, net.state_, batch.features, batch.labels,
                               batch.features_mask, batch.labels_mask)

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

    def _fit_tbptt(self, batch, rng: torch.Generator) -> torch.Tensor:
        """Truncated BPTT over one batch of whole sequences: one step per
        segment of ``conf.tbptt_fwd_length``, the forward state carried
        from segment to segment (gradients cut at each boundary), the
        dropout masks drawn from ``rng`` in turn.  A T that is no multiple
        of the length gets an all-ones features mask, and the short tail is
        padded with masked steps, so every segment runs one captured step.
        Returns the last segment's loss."""
        net = self.net
        length = net.conf.tbptt_fwd_length
        if batch.features.shape[1] % length:
            batch = ensure_feature_mask(batch)
        batch = self._place(batch)
        if net.opt_state is None:
            net.opt_state = self.updater.init(net.params_)
        if self._tbptt_step is None:
            key = self._step_key("tbptt")
            self._tbptt_step = step_cache.get_or_build(
                key, lambda: make_tbptt_step(net, self.updater, key))
        carries = self._carry_buffers(batch.features)
        loss = None
        for seg in tbptt_segments(batch, length):
            net.params_, net.state_, net.opt_state, carries, loss = self._tbptt_step(
                net.params_, net.state_, net.opt_state, carries, seg.features, seg.labels,
                seg.features_mask, seg.labels_mask, rng)
        return loss

    def fit(self, iterator, epochs: int = 1):
        """``epochs`` passes over ``iterator`` (reset before each), drawing
        from a stream made anew from the config's seed; the net's
        ``iteration``, ``epoch`` and score follow.  A tBPTT configuration
        trains each batch of sequences (3-D features) by
        :meth:`_fit_tbptt`; ``fit_batch`` stays the plain step."""
        net = self.net
        self._stream = self._new_stream()
        tbptt = net.conf.backprop_type == "tbptt"
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for batch in iterator:
                if tbptt and np.ndim(batch.features) == 3:
                    net._score = self._fit_tbptt(batch, self._stream)
                else:
                    net._score = self.fit_batch(batch)
                net.iteration += 1
            net.epoch += 1
        return net
