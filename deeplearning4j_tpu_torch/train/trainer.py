"""Training loop, single device (port of the core of
``deeplearning4j_tpu/train/trainer.py``).

One step is forward, score, backward and update, eagerly on the net's
device.  The loss is the JAX package's: the mean per-example loss over
the (unmasked) examples, or their sum when the config sets
``mini_batch(False)``, plus every layer's L1/L2 penalty.  The update is
the config's updater (``train.updaters``) after the gradient
normalization.  ``fit_batch`` returns the loss as a 0-dim tensor on the
device without waiting for it; ``net.score()`` reads it.

A step's random stream (dropout's masks) is a ``torch.Generator`` on the
net's device.  ``fit`` makes one per call, seeded with ``conf.seed +
7919`` as the JAX package seeds its key, so a run repeats bit for bit;
``fit_batch`` without a generator draws from the trainer's own stream.
The two packages' streams differ, so their masks do too.

Not ported yet: parallel layouts, listeners, the compiled-step cache,
the artifact store, resume from a checkpoint, and tBPTT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import resolve_device
from deeplearning4j_tpu_torch.nn.losses import mean_score
from deeplearning4j_tpu_torch.train import updaters as updater_mod
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


class Trainer:
    """Trains ``net`` on the device its parameters live on (the net fixes
    it; a CUDA net without a card raises here)."""

    def __init__(self, net):
        self.net = net
        resolve_device(net.device)
        conf = net.conf
        self.updater = (updater_mod.from_dict(conf.updater) if conf.updater
                        else updater_mod.Sgd(0.1))
        self._normalize = updater_mod.gradient_normalization(conf.gradient_normalization)
        for layer in net.layers:
            if layer.updater is not None or layer.frozen:
                raise NotImplementedError(
                    f"{type(layer).__name__}: per-layer updaters and frozen layers "
                    f"are not ported yet")
        if net.params_ is None:
            net.init()
        self._loss = make_loss_fn(net, train=True)
        self._eval_loss = make_loss_fn(net, train=False)
        self._stream: Optional[torch.Generator] = None

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
        params = tree_map(lambda p: p.detach().requires_grad_(True), net.params_)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, new_state = self._loss(params, net.state_, batch.features, batch.labels,
                                         batch.features_mask, batch.labels_mask, rng)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a param the loss never reads has no grad
        flat = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)])
        grads = tree_map(lambda _: next(flat), params)
        with torch.no_grad():
            updates, net.opt_state = self.updater.update(self._normalize(grads), net.opt_state)
            net.params_ = tree_map(lambda p, u: p + u, params, updates)
        net.state_ = new_state
        return loss.detach()

    def eval_loss(self, batch) -> torch.Tensor:
        """Inference-mode loss on one batch, no update."""
        net = self.net
        batch = self._place(batch)
        with torch.no_grad():
            loss, _ = self._eval_loss(net.params_, net.state_, batch.features, batch.labels,
                                      batch.features_mask, batch.labels_mask)
        return loss

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
