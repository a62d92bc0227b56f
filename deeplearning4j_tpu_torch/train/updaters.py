"""Updaters (port of ``deeplearning4j_tpu/train/updaters.py``).

Each updater is a dataclass with the JAX package's field names and JSON
type name, and two plain tensor functions over a param tree: nested
dicts and lists of any depth with tensors at the leaves (a graph's vertex
-> name -> tensor; a layer stack's list of per-layer dicts; BERT's
``encoder/layer_N/attention/query/kernel``):

- ``init(params) -> state``: a dict of trees (and counters);
- ``update(grads, state) -> (updates, new_state)``: the step to add to
  each param, with optax's arithmetic (the JAX package's updaters are
  optax transforms), so that a state carried across from the JAX package
  continues its run.

Not ``torch.optim``: its SGD applies Nesterov momentum in another form.
Ported: ``Sgd``, ``Nesterovs``, ``Adam`` (f32 moments, or a bf16 first
moment with ``mu_dtype="bf16"``) and ``NoOp``, and every gradient
normalization (:func:`gradient_normalization`).  The other updaters and
learning-rate schedules are not ported yet; their JSON raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

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


def to_dict(updater) -> dict:
    d = {"type": updater.TYPE_NAME}
    for f in dataclasses.fields(updater):
        d[f.name] = getattr(updater, f.name)
    return d


def from_dict(d: dict):
    """The updater of a JSON dict the JAX package (or the port) wrote."""
    d = dict(d)
    type_name = d.pop("type")
    cls = _REGISTRY.get(type_name)
    if cls is None:
        raise NotImplementedError(f"updater {type_name!r} is not ported yet; "
                                  f"ported: {sorted(_REGISTRY)}")
    known = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if isinstance(v, dict):
            raise NotImplementedError(f"updater {type_name!r}: {k} is a schedule, "
                                      f"and schedules are not ported yet")
    return cls(**{k: v for k, v in d.items() if k in known})


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


class _UpdaterBase:
    TYPE_NAME = "base"

    def to_dict(self) -> dict:
        return to_dict(self)


@register("sgd")
@dataclasses.dataclass
class Sgd(_UpdaterBase):
    """u = -lr * g (optax.sgd without momentum)."""

    learning_rate: Any = 0.1

    def init(self, params: dict) -> dict:
        return {}

    def update(self, grads: dict, state: dict):
        return tree_map(lambda g: -self.learning_rate * g, grads), state


@register("nesterovs")
@dataclasses.dataclass
class Nesterovs(_UpdaterBase):
    """SGD with Nesterov momentum, as ``optax.sgd(lr, momentum,
    nesterov=True)``: t = g + mu*t, u = -lr * (g + mu*t), t from zero."""

    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init(self, params: dict) -> dict:
        return {"trace": tree_map(torch.zeros_like, params)}

    def update(self, grads: dict, state: dict):
        mu, lr = self.momentum, self.learning_rate
        trace = tree_map(lambda g, t: g + mu * t, grads, state["trace"])
        updates = tree_map(lambda g, t: -lr * (g + mu * t), grads, trace)
        return updates, {"trace": trace}


@register("adam")
@dataclasses.dataclass
class Adam(_UpdaterBase):
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

    def _mu_dtype(self):
        if self.mu_dtype is None:
            return None
        if self.mu_dtype in MU_DTYPES:
            return torch.bfloat16
        raise NotImplementedError(f"Adam(mu_dtype={self.mu_dtype!r}) is not ported; "
                                  f"ported: None, {', '.join(map(repr, MU_DTYPES))}")

    def init(self, params: dict) -> dict:
        mu_dtype = self._mu_dtype()
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads: dict, state: dict):
        b1, b2, lr, eps = self.beta1, self.beta2, self.learning_rate, self.epsilon
        mu_dtype = self._mu_dtype()
        # JAX takes b1 into a bf16 mu's dtype first (0.9 -> 0.8984375) and
        # rounds the product to bf16; the product of two bf16 values is
        # exact in f32, so torch's rounding of it is the same
        b1m = b1 if mu_dtype is None else float(torch.tensor(b1, dtype=mu_dtype))
        mu = tree_map(lambda g, m: (1 - b1) * g + b1m * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        # the bias corrections from the device count alone (no host copy, so
        # the step can be captured); the float base is taken to f32, as JAX
        # takes ``b ** count``
        steps = count.to(torch.float32)
        c1 = 1 - torch.pow(b1, steps)
        c2 = 1 - torch.pow(b2, steps)
        updates = tree_map(lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)), mu, nu)
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return updates, {"count": count, "mu": mu, "nu": nu}


@register("noop")
@dataclasses.dataclass
class NoOp(_UpdaterBase):
    """No update (optax.set_to_zero)."""

    def init(self, params: dict) -> dict:
        return {}

    def update(self, grads: dict, state: dict):
        return tree_map(torch.zeros_like, grads), state
