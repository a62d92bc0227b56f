"""Loss-function catalog (port of ``deeplearning4j_tpu/nn/losses.py``).

A loss takes ``(labels, pre_output, activation, mask)`` and returns a
per-example score vector; autograd gives its gradient.  ``pre_output``
is the final layer's pre-activation, so softmax + MCXENT and sigmoid +
binary XENT take the stable log-space forms, as the JAX package (and the
reference's special-cased paths) do.  :func:`mean_score` reduces the
vector to the scalar score, honouring a 0/1 labels mask (mean over the
unmasked examples).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations

LossFn = Callable[..., torch.Tensor]

_REGISTRY: dict[str, LossFn] = {}


def register(name: str, *aliases: str):
    def deco(fn: LossFn) -> LossFn:
        for n in (name,) + aliases:
            _REGISTRY[n.lower()] = fn
        return fn
    return deco


def get(name) -> LossFn:
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown loss '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list[str]:
    return sorted(_REGISTRY)


def _activate(pre_output: torch.Tensor, activation) -> torch.Tensor:
    return activations.get(activation)(pre_output)


def _act_name(activation) -> str:
    return "" if callable(activation) else str(activation).lower()


def mean_score(score_array: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The scalar score: the mean of the per-example scores, over the
    unmasked examples when a mask is given."""
    if mask is None:
        return score_array.mean()
    mask = mask.reshape(score_array.shape).to(score_array.dtype)
    return (score_array * mask).sum() / mask.sum().clamp_min(1.0)


@register("mcxent", "multiclass_cross_entropy", "negativeloglikelihood", "nll")
def mcxent(labels, pre_output, activation="softmax", mask=None, weights=None):
    """-sum_c y_c log p_c; with softmax, through log_softmax of the
    pre-activation."""
    if _act_name(activation) == "softmax":
        logp = torch.log_softmax(pre_output, dim=-1)
    else:
        logp = torch.log(torch.clamp(_activate(pre_output, activation), 1e-10, 1.0))
    per_class = -labels * logp
    if weights is not None:
        per_class = per_class * weights
    return per_class.sum(-1)


@register("sparse_mcxent")
def sparse_mcxent(labels, pre_output, activation="softmax", mask=None, weights=None):
    """Labels are integer class indices."""
    logp = torch.log_softmax(pre_output, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


@register("binary_xent", "xent", "binary_cross_entropy")
def binary_xent(labels, pre_output, activation="sigmoid", mask=None, weights=None):
    if _act_name(activation) == "sigmoid":
        # -[y log s(x) + (1-y) log(1-s(x))] = max(x,0) - x*y + log(1+e^-|x|)
        x = pre_output
        per = torch.clamp_min(x, 0.0) - x * labels + torch.log1p(torch.exp(-x.abs()))
    else:
        p = torch.clamp(_activate(pre_output, activation), 1e-7, 1.0 - 1e-7)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weights is not None:
        per = per * weights
    return per.sum(-1)


@register("mse", "squared_loss", "l2_mean")
def mse(labels, pre_output, activation="identity", mask=None, weights=None):
    per = (labels - _activate(pre_output, activation)) ** 2
    if weights is not None:
        per = per * weights
    return per.mean(-1)


@register("l2")
def l2(labels, pre_output, activation="identity", mask=None, weights=None):
    per = (labels - _activate(pre_output, activation)) ** 2
    if weights is not None:
        per = per * weights
    return per.sum(-1)


@register("mae", "mean_absolute_error")
def mae(labels, pre_output, activation="identity", mask=None, weights=None):
    per = (labels - _activate(pre_output, activation)).abs()
    if weights is not None:
        per = per * weights
    return per.mean(-1)


@register("l1")
def l1(labels, pre_output, activation="identity", mask=None, weights=None):
    per = (labels - _activate(pre_output, activation)).abs()
    if weights is not None:
        per = per * weights
    return per.sum(-1)


@register("mape", "mean_absolute_percentage_error")
def mape(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    return (100.0 * ((labels - out) / torch.clamp_min(labels.abs(), 1e-8)).abs()).mean(-1)


@register("msle", "mean_squared_logarithmic_error")
def msle(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    return ((torch.log1p(torch.clamp_min(labels, 0)) - torch.log1p(torch.clamp_min(out, 0)))
            ** 2).mean(-1)


@register("kl_divergence", "kld", "reconstruction_crossentropy")
def kld(labels, pre_output, activation="softmax", mask=None, weights=None):
    out = torch.clamp(_activate(pre_output, activation), 1e-10, 1.0)
    y = torch.clamp(labels, 1e-10, 1.0)
    return (y * (torch.log(y) - torch.log(out))).sum(-1)


@register("poisson")
def poisson(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    return (out - labels * torch.log(torch.clamp_min(out, 1e-10))).mean(-1)


def _signed(labels):
    return torch.where(labels <= 0.0, -1.0, 1.0).to(labels.dtype)


@register("hinge")
def hinge(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    return torch.clamp_min(1.0 - _signed(labels) * out, 0.0).mean(-1)


@register("squared_hinge")
def squared_hinge(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    return (torch.clamp_min(1.0 - _signed(labels) * out, 0.0) ** 2).mean(-1)


@register("cosine_proximity")
def cosine_proximity(labels, pre_output, activation="identity", mask=None, weights=None):
    out = _activate(pre_output, activation)
    num = (labels * out).sum(-1)
    denom = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(out, dim=-1)
    return -num / torch.clamp_min(denom, 1e-8)


@register("wasserstein")
def wasserstein(labels, pre_output, activation="identity", mask=None, weights=None):
    return (labels * _activate(pre_output, activation)).mean(-1)


@register("fmeasure")
def fmeasure(labels, pre_output, activation="sigmoid", mask=None, weights=None,
             beta: float = 1.0):
    """Soft F-beta over the whole batch, broadcast to every example so
    that the mean is the batch score."""
    out = _activate(pre_output, activation)
    tp = (labels * out).sum()
    fp = ((1.0 - labels) * out).sum()
    fn = (labels * (1.0 - out)).sum()
    b2 = beta * beta
    f = ((1 + b2) * tp) / torch.clamp_min((1 + b2) * tp + b2 * fn + fp, 1e-8)
    lead = pre_output.shape[0] if pre_output.ndim > 0 else 1
    return (1.0 - f).expand(lead)


@register("huber")
def huber(labels, pre_output, activation="identity", mask=None, weights=None,
          delta: float = 1.0):
    err = (labels - _activate(pre_output, activation)).abs()
    quad = torch.clamp_max(err, delta)
    per = 0.5 * quad * quad + delta * (err - quad)
    if weights is not None:
        per = per * weights
    return per.mean(-1)


@register("log_poisson")
def log_poisson(labels, pre_output, activation="identity", mask=None, weights=None,
                full: bool = False):
    """exp(log_pred) - labels*log_pred (+ the Stirling term of
    log(labels!) when ``full``, zero for labels <= 1)."""
    log_pred = _activate(pre_output, activation)
    per = torch.exp(log_pred) - labels * log_pred
    if full:
        safe = torch.clamp_min(labels, 1.0)
        stirling = safe * torch.log(safe) - safe + 0.5 * torch.log(2.0 * math.pi * safe)
        per = per + torch.where(labels > 1.0, stirling, 0.0)
    if weights is not None:
        per = per * weights
    return per.mean(-1)


@register("log_poisson_full")
def log_poisson_full(labels, pre_output, activation="identity", mask=None, weights=None):
    return log_poisson(labels, pre_output, activation, mask, weights, full=True)


@register("weighted_cross_entropy_with_logits")
def weighted_cross_entropy_with_logits(labels, pre_output, activation="identity", mask=None,
                                       weights=None, pos_weight: float = 1.0):
    """The positive class's log-term scaled by ``pos_weight``; the input
    is logits, whatever the activation."""
    z = pre_output
    log_w = 1.0 + (pos_weight - 1.0) * labels
    per = (1.0 - labels) * z + log_w * (torch.log1p(torch.exp(-z.abs()))
                                        + torch.clamp_min(-z, 0.0))
    if weights is not None:
        per = per * weights
    return per.mean(-1)


@register("mean_pairwise_squared_error")
def mean_pairwise_squared_error(labels, pre_output, activation="identity", mask=None,
                                weights=None):
    """Mean over ordered pairs of ((d_i - d_j)^2)/2, d = pred - label, by
    sum_ij (d_i - d_j)^2 = 2n sum d^2 - 2 (sum d)^2."""
    d = _activate(pre_output, activation) - labels
    if weights is not None:
        d = d * torch.sqrt(weights)
    n = d.shape[-1]
    return (n * (d * d).sum(-1) - d.sum(-1) ** 2) / max(n * (n - 1), 1)
