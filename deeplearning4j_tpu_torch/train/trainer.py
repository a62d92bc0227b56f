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

Not ported yet: parallel layouts, listeners, the step statistics
(``with_stats``), the artifact store, resume from a checkpoint, and
tBPTT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import resolve_device
from deeplearning4j_tpu_torch.nn.losses import mean_score
from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train import updaters as updater_mod
from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

# the step stream's seed is the config's seed plus this (the JAX package's key)
STREAM_SEED_OFFSET = 7919


def make_loss_fn(net, train: bool = True):
    """``(params, state, features, labels, features_mask, labels_mask, rng)
    -> (loss, new_state)``, ``rng`` the step's stream (the layers draw
    from it in order); ``train=False`` scores in inference mode (no
    dropout; BN uses its running statistics and leaves them)."""

    def loss_fn(params, state, features, labels, features_mask, labels_mask, rng=None):
        _, new_state, score_array = net._forward(params, state, features, train=train,
                                                 rng=rng, mask=features_mask, labels=labels)
        if score_array is None:
            raise ValueError("the net has no output layer with a loss — use "
                             "OutputLayer as the final layer for fit()")
        if net.conf.mini_batch:
            loss = mean_score(score_array, labels_mask)
        else:   # minibatch(false): the sum, not the mean, over the examples
            if labels_mask is not None:
                score_array = score_array * labels_mask.reshape(score_array.shape)
            loss = score_array.sum()
        layer_params = net.layer_params(params) if hasattr(net, "layer_params") else params
        for layer, p in zip(net.layers, layer_params):
            if p:
                loss = loss + layer.regularization_penalty(p)
        return loss, new_state

    return loss_fn


def make_train_step(net, updater, name=""):
    """The training step, ``(params, state, opt_state, features, labels,
    features_mask, labels_mask, rng) -> (params, state, opt_state, loss)``:
    the params, the layers' state and the updater's state are updated in
    place and returned (the JAX package's donation); ``loss`` is a 0-dim
    tensor.  A :class:`CapturedStep`: CUDA graphs on the card, the plain
    step on the CPU; ``name`` labels its errors."""
    loss_fn = make_loss_fn(net, train=True)
    normalize = updater_mod.gradient_normalization(net.conf.gradient_normalization)

    def step(params, state, opt_state, features, labels, features_mask, labels_mask, rng):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(grad_params)
        with torch.enable_grad():
            loss, new_state = loss_fn(grad_params, state, features, labels, features_mask,
                                      labels_mask, rng)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a param the loss never reads has no grad
        flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(flat), params)
        with torch.no_grad():
            updates, new_opt_state = updater.update(normalize(grads), opt_state)
            tree_map(lambda p, u: p.add_(u), params, updates)
            write_into(state, new_state)
            write_into(opt_state, new_opt_state)
        return params, state, opt_state, loss.detach()

    return CapturedStep(step, n_trees=3, name=name)


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
        updater_mod.gradient_normalization(conf.gradient_normalization)   # raises if not ported
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

    def fit(self, iterator, epochs: int = 1):
        """``epochs`` passes over ``iterator`` (reset before each), drawing
        from a stream made anew from the config's seed; the net's
        ``iteration``, ``epoch`` and score follow."""
        net = self.net
        self._stream = self._new_stream()
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for batch in iterator:
                net._score = self.fit_batch(batch)
                net.iteration += 1
            net.epoch += 1
        return net
