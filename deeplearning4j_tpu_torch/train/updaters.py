"""Updaters (port of ``deeplearning4j_tpu/train/updaters.py``).

Each updater is a dataclass with the JAX package's field names and JSON
type name, and two plain tensor functions over a param tree: nested
dicts and lists of any depth with tensors at the leaves (a graph's vertex
-> name -> tensor; a layer stack's list of per-layer dicts; BERT's
``encoder/layer_N/attention/query/kernel``):

- ``init(params) -> state``: a dict of trees (and counters);
- ``update(grads, state, params=None) -> (updates, new_state)``: the step
  to add to each param, with optax's arithmetic (the JAX package's
  updaters are optax transforms), so that a state carried across from the
  JAX package continues its run.

Not ``torch.optim``: its SGD applies Nesterov momentum in another form.
Every updater of the JAX package is ported: ``Sgd``, ``Nesterovs``,
``Adam`` (f32 moments, or a bf16 first moment with ``mu_dtype="bf16"``),
``AdamW``, ``AdaMax``, ``AMSGrad``, ``Nadam``, ``AdaGrad``, ``AdaDelta``,
``RmsProp`` and ``NoOp``, each mapped onto optax as the JAX package maps
it, and every gradient normalization (:func:`gradient_normalization`).
A learning rate may be a schedule (``train/schedules.py``): as in optax
it reads a count of its own (``schedule_count``, from 0), apart from
Adam's bias-correction count (from 1).  A state holds every field of
the optax state, in the order :meth:`_UpdaterBase.state_leaves` gives
them, which is ``jax.tree_util``'s flatten order of that state.

:class:`Optimizer` is what a trainer steps: the gradient normalization,
then the net's updater, or one updater per label (a layer with an
updater of its own is its own label, as ``optax.multi_transform``
labels it), then the updates of frozen layers set to zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train import schedules as sched_mod

_REGISTRY: dict[str, type] = {}

# the names of a bf16 first moment that ``Adam(mu_dtype=...)`` takes, as
# the JAX package writes them
MU_DTYPES = ("bf16", "bfloat16")


def register(name: str):
    def deco(cls):
        cls.TYPE_NAME = name
        _REGISTRY[name] = cls
        return cls
    return deco


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of param-shaped trees: nested dicts, lists
    and tuples of any depth, the first tree's keys and lengths deciding
    the structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *nodes) for nodes in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, lists and tuples, in its key
    and list order (``tree_map``'s order)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def jax_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree_util``'s flatten order: dict keys
    sorted at every level, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in jax_leaves(node)]
    return [tree]


def jax_unflatten(template, make: Callable):
    """A tree of ``template``'s structure whose leaves are
    ``make(template_leaf)``, called in :func:`jax_leaves` order."""
    if isinstance(template, dict):
        filled = {k: jax_unflatten(template[k], make) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(jax_unflatten(node, make) for node in template)
    return make(template)


def to_dict(updater) -> dict:
    d = {"type": updater.TYPE_NAME}
    for f in dataclasses.fields(updater):
        v = getattr(updater, f.name)
        d[f.name] = v.to_dict() if isinstance(v, sched_mod.BaseSchedule) else v
    return d


def from_dict(d: dict):
    """The updater of a JSON dict the JAX package (or the port) wrote; a
    learning rate written as a schedule's dict becomes the schedule."""
    d = dict(d)
    type_name = d.pop("type")
    cls = _REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"unknown updater {type_name!r}; known: {sorted(_REGISTRY)}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


def as_updater(value):
    """An updater, or the updater of its JSON dict."""
    return from_dict(value) if isinstance(value, dict) else value


def _per_layer_map(fn: Callable, tree):
    """``fn`` on each top-level entry of a gradient tree: a layer stack's
    list elements, a graph's dict values."""
    if isinstance(tree, list):
        return [fn(t) for t in tree]
    if isinstance(tree, dict):
        return {k: fn(t) for k, t in tree.items()}
    return fn(tree)


def _l2(tree) -> torch.Tensor:
    """The L2 norm of all the leaves of ``tree`` together."""
    return torch.sqrt(sum((g * g).sum() for g in tree_leaves(tree)))


def gradient_normalization(kind: Optional[str],
                           threshold: float = 1.0) -> Callable[[Any], Any]:
    """The pre-updater normalization of the gradient tree (DL4J's
    ``GradientNormalization``), as the JAX package's optax transform
    computes it: ``None``/``"none"``, ``renormalize_l2_per_layer``,
    ``renormalize_l2_per_param_type``, ``clip_element_wise_absolute_value``,
    ``clip_l2_per_layer`` or ``clip_l2_per_param_type``.  A layer is a
    top-level entry of the tree, a param type one leaf.  The scales stay
    on the device (no host read), so the step can be captured."""
    if kind is None or str(kind).lower() == "none":
        return lambda grads: grads
    kind = str(kind).lower()

    def per_layer(scale_of):
        def apply(layer):
            if not tree_leaves(layer):
                return layer
            scale = scale_of(_l2(layer))
            return tree_map(lambda g: g * scale, layer)
        return lambda grads: _per_layer_map(apply, grads)

    def renormalize(n):
        return 1.0 / torch.clamp_min(n, 1e-8)

    def clip(n):
        return torch.where(n > threshold, threshold / (n + 1e-12), torch.ones_like(n))

    if kind == "renormalize_l2_per_layer":
        return per_layer(renormalize)
    if kind == "renormalize_l2_per_param_type":
        return lambda grads: tree_map(
            lambda g: g / torch.clamp_min(torch.sqrt((g * g).sum()), 1e-8), grads)
    if kind == "clip_element_wise_absolute_value":
        return lambda grads: tree_map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if kind == "clip_l2_per_layer":
        return per_layer(clip)
    if kind == "clip_l2_per_param_type":
        return lambda grads: tree_map(lambda g: g * clip(torch.sqrt((g * g).sum())), grads)
    raise ValueError(f"unknown gradient normalization {kind!r}")


def _bias_correction(moment, decay: float, count: torch.Tensor):
    """optax's ``tree_bias_correction``: ``moment / (1 - decay**count)``,
    the power in f32 from the device count."""
    correction = 1 - torch.pow(decay, count.to(torch.float32))
    return tree_map(lambda t: t / correction.to(t.dtype), moment)


def _moment(grads, moments, decay: float, order: int):
    """optax's ``tree_update_moment``: ``(1 - decay) g^order + decay t``."""
    return tree_map(lambda g, t: (1 - decay) * (g if order == 1 else g * g) + decay * t,
                    grads, moments)


class _UpdaterBase:
    """An updater: its own state fields (``STATE_FIELDS``, the optax
    state's, in its order) and the direction of its step before the
    learning rate (:meth:`_direction`); the rate, a float or a schedule,
    scales the direction as ``optax.scale_by_learning_rate`` does."""

    TYPE_NAME = "base"
    STATE_FIELDS: tuple = ()

    def __post_init__(self):
        lr = getattr(self, "learning_rate", None)
        if sched_mod.is_schedule_dict(lr):
            self.learning_rate = sched_mod.from_dict(lr)

    def to_dict(self) -> dict:
        return to_dict(self)

    @property
    def scheduled(self) -> bool:
        """Whether the learning rate is a schedule (then the state counts
        the steps for it)."""
        return isinstance(getattr(self, "learning_rate", None), sched_mod.BaseSchedule)

    def _init(self, params, device) -> dict:
        return {}

    def _direction(self, grads, state: dict, params):
        """``(direction, new fields)``: the step before the learning rate."""
        return grads, {}

    def init(self, params, device=None) -> dict:
        """The state for ``params``; its counters on ``device`` (the first
        param's device by default: a label's state may own no param)."""
        if device is None:
            device = _first_device(params)
        state = self._init(params, device)
        if self.scheduled:
            state["schedule_count"] = torch.zeros((), dtype=torch.int32, device=device)
        return state

    def update(self, grads, state: dict, params=None):
        direction, new_state = self._direction(grads, state, params)
        if self.scheduled:
            count = state["schedule_count"]
            step = -self.learning_rate(count)
            updates = tree_map(lambda d: step.to(d.dtype) * d, direction)
            new_state["schedule_count"] = count + 1
        else:
            lr = self._constant_rate()
            updates = tree_map(lambda d: -lr * d, direction)
        return updates, new_state

    def _constant_rate(self) -> float:
        return self.learning_rate

    def state_leaves(self, state: dict) -> list:
        """The state's tensors as the optax state's leaves, in
        ``jax.tree_util``'s flatten order: each field of ``STATE_FIELDS``
        in turn (a tree's leaves with its dict keys sorted), then the
        schedule's count."""
        names = self.STATE_FIELDS + (("schedule_count",) if self.scheduled else ())
        return [leaf for name in names for leaf in jax_leaves(state[name])]

    def state_from_leaves(self, params, make: Callable, device=None) -> dict:
        """The state of ``params`` whose leaves are ``make(template_leaf)``,
        called in :meth:`state_leaves`' order; a field ``make`` runs out
        of leaves for raises ``KeyError`` naming it."""
        template = self.init(params, device)
        names = self.STATE_FIELDS + (("schedule_count",) if self.scheduled else ())
        state = {}
        for name in names:
            try:
                state[name] = jax_unflatten(template[name], make)
            except _OutOfLeaves as e:
                raise KeyError(f"{type(self).__name__} state: field {name!r} is missing "
                               f"(the state given has {e.args[0]} leaves)") from None
        return state


@register("sgd")
@dataclasses.dataclass
class Sgd(_UpdaterBase):
    """u = -lr * g (optax.sgd without momentum)."""

    learning_rate: Any = 0.1


@register("nesterovs")
@dataclasses.dataclass
class Nesterovs(_UpdaterBase):
    """SGD with Nesterov momentum, as ``optax.sgd(lr, momentum,
    nesterov=True)``: t = g + mu*t, u = -lr * (g + mu*t), t from zero."""

    STATE_FIELDS = ("trace",)
    learning_rate: Any = 0.1
    momentum: float = 0.9

    def _init(self, params, device) -> dict:
        return {"trace": tree_map(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        mu = self.momentum
        trace = tree_map(lambda g, t: g + mu * t, grads, state["trace"])
        return tree_map(lambda g, t: g + mu * t, grads, trace), {"trace": trace}


class _AdamMoments:
    """Adam's moments and direction, shared by ``Adam``, ``AdamW`` and
    ``Nadam`` (``optax.scale_by_adam``)."""

    STATE_FIELDS = ("count", "mu", "nu")

    def _mu_dtype(self):
        mu_dtype = getattr(self, "mu_dtype", None)
        if mu_dtype is None:
            return None
        if mu_dtype in MU_DTYPES:
            return torch.bfloat16
        raise NotImplementedError(f"Adam(mu_dtype={mu_dtype!r}) is not ported; "
                                  f"ported: None, {', '.join(map(repr, MU_DTYPES))}")

    def _init(self, params, device) -> dict:
        mu_dtype = self._mu_dtype()
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    def _moments(self, grads, state):
        """mu, nu, the incremented count and the bias-corrected nu."""
        b1, b2 = self.beta1, self.beta2
        mu_dtype = self._mu_dtype()
        # JAX takes b1 into a bf16 mu's dtype first (0.9 -> 0.8984375) and
        # rounds the product to bf16; the product of two bf16 values is
        # exact in f32, so torch's rounding of it is the same
        b1m = b1 if mu_dtype is None else float(torch.tensor(b1, dtype=mu_dtype))
        mu = tree_map(lambda g, m: (1 - b1) * g + b1m * m, grads, state["mu"])
        nu = _moment(grads, state["nu"], b2, 2)
        # the bias corrections from the device count alone (no host copy, so
        # the step can be captured); the float base is taken to f32, as JAX
        # takes ``b ** count``
        count = state["count"] + 1
        return mu, nu, count, _bias_correction(nu, b2, count)

    def _adam(self, grads, state):
        mu, nu, count, nu_hat = self._moments(grads, state)
        mu_hat = _bias_correction(mu, self.beta1, count)
        direction = tree_map(lambda m, v: m / (torch.sqrt(v) + self.epsilon), mu_hat, nu_hat)
        mu_dtype = self._mu_dtype()
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return direction, {"count": count, "mu": mu, "nu": nu}


@register("adam")
@dataclasses.dataclass
class Adam(_AdamMoments, _UpdaterBase):
    """``optax.adam``: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    count += 1, u = -lr * mu_hat / (sqrt(nu_hat) + eps) with the bias
    corrections 1 - b^count.

    ``mu_dtype="bf16"`` (or ``"bfloat16"``) keeps the first moment in
    bf16 between steps, in optax 0.2.6's order: ``b1 * mu`` is rounded
    in bf16 (b1 itself taken to bf16 first, as JAX does) and promoted to
    f32 by the sum, nu stays f32, the update
    comes from the unrounded f32 mu, and the state keeps that mu cast to
    bf16."""

    learning_rate: Any = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    mu_dtype: Any = None

    def _direction(self, grads, state, params):
        return self._adam(grads, state)


@register("adamw")
@dataclasses.dataclass
class AdamW(_AdamMoments, _UpdaterBase):
    """``optax.adamw``: Adam's direction plus ``weight_decay * p`` for every
    param (biases included: the JAX package passes no mask), before the
    learning rate."""

    learning_rate: Any = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.01

    def _direction(self, grads, state, params):
        if params is None:
            raise ValueError("AdamW's weight decay needs the params: update(grads, state, "
                             "params)")
        direction, new_state = self._adam(grads, state)
        wd = self.weight_decay
        return tree_map(lambda d, p: d + wd * p, direction, params), new_state


@register("adamax")
@dataclasses.dataclass
class AdaMax(_UpdaterBase):
    """``optax.adamax``: mu = (1-b1) g + b1 mu, nu = max(|g| + eps, b2 nu),
    u = -lr * mu_hat / nu."""

    STATE_FIELDS = ("count", "mu", "nu")
    learning_rate: Any = 0.002
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init(self, params, device) -> dict:
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        count = state["count"] + 1
        mu = _moment(grads, state["mu"], self.beta1, 1)
        nu = tree_map(lambda g, t: torch.maximum(torch.abs(g) + self.epsilon, self.beta2 * t),
                      grads, state["nu"])
        mu_hat = _bias_correction(mu, self.beta1, count)
        return (tree_map(lambda m, v: m / v, mu_hat, nu),
                {"count": count, "mu": mu, "nu": nu})


@register("amsgrad")
@dataclasses.dataclass
class AMSGrad(_UpdaterBase):
    """``optax.amsgrad``: Adam's moments, nu_max = max(nu_max, nu_hat),
    u = -lr * mu_hat / (sqrt(nu_max) + eps)."""

    STATE_FIELDS = ("count", "mu", "nu", "nu_max")
    learning_rate: Any = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init(self, params, device) -> dict:
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros(), "nu_max": zeros()}

    def _direction(self, grads, state, params):
        mu = _moment(grads, state["mu"], self.beta1, 1)
        nu = _moment(grads, state["nu"], self.beta2, 2)
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, self.beta1, count)
        nu_max = tree_map(torch.maximum, state["nu_max"],
                          _bias_correction(nu, self.beta2, count))
        return (tree_map(lambda m, v: m / (torch.sqrt(v) + self.epsilon), mu_hat, nu_max),
                {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max})


@register("nadam")
@dataclasses.dataclass
class Nadam(_AdamMoments, _UpdaterBase):
    """``optax.nadam`` (Adam with Nesterov momentum): mu_hat = b1 *
    mu / (1 - b1^(count+1)) + (1-b1) * g / (1 - b1^count)."""

    learning_rate: Any = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _direction(self, grads, state, params):
        b1 = self.beta1
        mu, nu, count, nu_hat = self._moments(grads, state)
        mu_hat = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                          _bias_correction(mu, b1, count + 1),
                          _bias_correction(grads, b1, count))
        return (tree_map(lambda m, v: m / (torch.sqrt(v) + self.epsilon), mu_hat, nu_hat),
                {"count": count, "mu": mu, "nu": nu})


@register("adagrad")
@dataclasses.dataclass
class AdaGrad(_UpdaterBase):
    """``optax.adagrad(lr, eps=epsilon)``: the accumulator starts at 0.1
    (optax's ``initial_accumulator_value``), s += g^2,
    u = -lr * g / sqrt(s + eps) where s > 0."""

    STATE_FIELDS = ("sum_of_squares",)
    INITIAL_ACCUMULATOR = 0.1
    learning_rate: Any = 0.1
    epsilon: float = 1e-6

    def _init(self, params, device) -> dict:
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, self.INITIAL_ACCUMULATOR), params)}

    def _direction(self, grads, state, params):
        sums = tree_map(lambda g, t: g * g + t, grads, state["sum_of_squares"])
        scale = tree_map(lambda t: torch.where(t > 0, torch.rsqrt(t + self.epsilon),
                                               torch.zeros_like(t)), sums)
        return tree_map(lambda s, g: s * g, scale, grads), {"sum_of_squares": sums}


@register("adadelta")
@dataclasses.dataclass
class AdaDelta(_UpdaterBase):
    """``optax.adadelta(learning_rate=1.0, rho, eps)``: no learning rate of
    its own (optax's weight decay of 0 first, then e_g = (1-rho) g^2 + rho
    e_g, u = sqrt(e_x + eps) / sqrt(e_g + eps) * g, e_x = (1-rho) u^2 + rho
    e_x, and u scaled by -1)."""

    STATE_FIELDS = ("e_g", "e_x")
    rho: float = 0.95
    epsilon: float = 1e-6

    def _init(self, params, device) -> dict:
        return {"e_g": tree_map(torch.zeros_like, params),
                "e_x": tree_map(torch.zeros_like, params)}

    def _constant_rate(self) -> float:
        return 1.0

    def _direction(self, grads, state, params):
        if params is not None:   # optax's add_decayed_weights(0.0)
            grads = tree_map(lambda g, p: g + 0.0 * p, grads, params)
        eps = self.epsilon
        e_g = _moment(grads, state["e_g"], self.rho, 2)
        updates = tree_map(lambda g, cur, prev: torch.sqrt(prev + eps) / torch.sqrt(cur + eps) * g,
                           grads, e_g, state["e_x"])
        e_x = _moment(updates, state["e_x"], self.rho, 2)
        return updates, {"e_g": e_g, "e_x": e_x}


@register("rmsprop")
@dataclasses.dataclass
class RmsProp(_UpdaterBase):
    """``optax.rmsprop(lr, decay=rms_decay, eps)``: nu from 0, nu = (1-d)
    g^2 + d nu, u = -lr * g / sqrt(nu + eps)."""

    STATE_FIELDS = ("nu",)
    learning_rate: Any = 0.001
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def _init(self, params, device) -> dict:
        return {"nu": tree_map(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        nu = _moment(grads, state["nu"], self.rms_decay, 2)
        return (tree_map(lambda n, g: torch.rsqrt(n + self.epsilon) * g, nu, grads),
                {"nu": nu})


@register("noop")
@dataclasses.dataclass
class NoOp(_UpdaterBase):
    """No update (optax.set_to_zero)."""

    def update(self, grads, state: dict, params=None):
        return tree_map(torch.zeros_like, grads), state


DEFAULT_LABEL = "_default"


class _OutOfLeaves(Exception):
    """A state being filled from fewer leaves than it has."""


def _select(tree, labels, label: str):
    """``tree`` with the top-level entries of other labels left empty."""
    if isinstance(tree, list):
        return [t if lbl == label else {} for t, lbl in zip(tree, labels)]
    return {k: (t if labels[k] == label else {}) for k, t in tree.items()}


class Optimizer:
    """A trainer's update, as the JAX package composes it with optax: the
    gradient normalization over every leaf, then ``updater`` (or, with
    ``labels``, each top-level entry's label's updater of
    ``label_updaters``, ``optax.multi_transform``'s partition), then the
    updates of the ``frozen`` top-level entries set to zero.  ``labels``
    and ``frozen`` are shaped like the params' top level (a list for a
    layer stack, a dict for a graph).  A frozen entry's updater state
    still moves on its gradient, as optax's does.

    The state is the updater's (one label), or a dict of each label's
    state over its own entries (the others empty), keyed by label
    (``optax.multi_transform``'s ``PartitionState`` of ``MaskedState`` s)."""

    def __init__(self, updater, normalization: Optional[str] = None, threshold: float = 1.0,
                 labels=None, label_updaters: Optional[dict] = None, frozen=None):
        self.updater = updater
        self.normalize = gradient_normalization(normalization, threshold)
        self.labels = labels
        self.label_updaters = dict(label_updaters or {})
        self.frozen = frozen if frozen is not None and any(
            frozen.values() if isinstance(frozen, dict) else frozen) else None

    def _labelled(self) -> list:
        return sorted(self.label_updaters)

    def init(self, params):
        if self.labels is None:
            return self.updater.init(params)
        device = _first_device(params)
        return {label: self.label_updaters[label].init(_select(params, self.labels, label),
                                                       device)
                for label in self._labelled()}

    def update(self, grads, state, params=None):
        grads = self.normalize(grads)
        if self.labels is None:
            updates, new_state = self.updater.update(grads, state, params)
        else:
            updates = grads.copy()
            new_state = {}
            for label in self._labelled():
                sub, new_state[label] = self.label_updaters[label].update(
                    _select(grads, self.labels, label), state[label],
                    None if params is None else _select(params, self.labels, label))
                for key in (range(len(sub)) if isinstance(sub, list) else sub):
                    if self.labels[key] == label:
                        updates[key] = sub[key]
        if self.frozen is not None:
            def masked(key, u):
                return tree_map(torch.zeros_like, u) if self.frozen[key] else u
            updates = ([masked(i, u) for i, u in enumerate(updates)] if isinstance(updates, list)
                       else {k: masked(k, u) for k, u in updates.items()})
        return updates, new_state

    def state_leaves(self, state) -> list:
        """The state's tensors as the leaves of the JAX package's optax
        state, in ``jax.tree_util``'s flatten order (the labels sorted)."""
        if self.labels is None:
            return self.updater.state_leaves(state)
        return [leaf for label in self._labelled()
                for leaf in self.label_updaters[label].state_leaves(state[label])]

    def state_from_leaves(self, params, leaves: list):
        """The state of ``params`` holding ``leaves`` (arrays or tensors,
        :meth:`state_leaves`' order), each made a tensor of the dtype,
        shape and device that the state's own leaf has."""
        it = iter(leaves)
        count = [0]

        def make(template):
            count[0] += 1
            value = next(it, None)
            if value is None:
                raise _OutOfLeaves(len(leaves))
            return leaf_like(template, value, count[0] - 1)

        if self.labels is None:
            state = self.updater.state_from_leaves(params, make)
        else:
            device = _first_device(params)
            state = {label: self.label_updaters[label].state_from_leaves(
                _select(params, self.labels, label), make, device)
                for label in self._labelled()}
        if count[0] != len(leaves):
            raise ValueError(f"the updater state has {count[0]} leaves, not {len(leaves)}")
        return state


def _first_device(params):
    leaf = next(iter(tree_leaves(params)), None)
    return None if leaf is None else leaf.device


def leaf_like(template: torch.Tensor, value, index: int) -> torch.Tensor:
    """``value`` (a numpy array, which may be numpy's bf16, or a tensor;
    leaf ``index`` of a state or a checkpoint) as a new tensor like
    ``template``: the same shape (checked), its dtype and device."""
    if not torch.is_tensor(value):
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":    # numpy's bf16 extension type: widen exactly
            arr = arr.astype(np.float32)
        value = torch.as_tensor(arr)
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(f"leaf {index}: shape {tuple(value.shape)} != "
                         f"{tuple(template.shape)}")
    return value.to(dtype=template.dtype, device=template.device).clone()
