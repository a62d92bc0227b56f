"""BERT: the transformer encoder of the MLM fine-tune workload (port of
``deeplearning4j_tpu/models/bert.py``).

The encoder is a set of plain functions over a nested dict of parameters
whose keys mirror the TF BERT checkpoint names (``embeddings/...``,
``encoder/layer_N/attention/query/kernel``, ...), as in the JAX package,
so that its zips, its TF importer and its tests carry over.  Weights are
float32; matmuls run in the dtype policy's compute dtype.  Under the bf16
policy the layer norms' f32 ``gamma`` promotes the residual stream to f32
while q, k, v are bf16, so attention runs in bf16.  From sequence 1024 on
(or with ``use_flash=True``) attention goes through the flash kernels of
``ops/kernels/flash_attention.py``.

:class:`BertForMaskedLM` serves (``predict_mlm``) and fine-tunes (``fit``)
on the CUDA card unless it is given ``device="cpu"``.  Dropout draws from
an explicit ``torch.Generator``; its numbers differ from JAX's.  ``fit``
stages each batch through ``data.device_pipeline.DeviceFeeder`` (batch
N+1 crosses to the card while step N runs) and reports every step
through an ``obs.listeners.ListenerBus``; its train step updates params
and updater state in place and, on the card, replays a CUDA graph after
two eager steps (``train/capture.py``).  :func:`pipeline_stages` splits
the model into stage functions for a pipeline-parallel step, with
:func:`merge_tied_embedding_grads` and :func:`mlm_loss_from_logits`
beside them; ``parallel.pipeline_stages.pipeline_train_step`` runs them
on the 1F1B or GPipe schedule, one process per stage.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from typing import Any, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, dtype_policy, resolve_device
from deeplearning4j_tpu_torch.io.model_serializer import (
    _npz_bytes_to_leaves, _rebuild_like, _tree_to_npz_bytes)
from deeplearning4j_tpu_torch.ops.attention import multi_head_attention
from deeplearning4j_tpu_torch.train import updaters as updater_mod
from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map


@dataclasses.dataclass
class BertConfig:
    """The JAX package's fields and defaults: ``use_flash=None`` routes by
    sequence length; ``flash_block`` is the TPU kernel's tile knob;
    ``max_predictions`` gathers that many masked positions per sequence
    before the vocab decode (0 decodes every position).  ``fused_qkv``
    (one matmul for q, k, v; off by default, and measured slower by the
    JAX package) is read from JSON but not ported: it raises."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    use_flash: Optional[bool] = None
    flash_block: int = 0
    max_predictions: int = 0
    fused_qkv: bool = False

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(vocab_size: int = 1000) -> "BertConfig":
        """Test-sized config."""
        return BertConfig(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, max_position=128)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "BertConfig":
        known = {f.name for f in dataclasses.fields(BertConfig)}
        return BertConfig(**{k: v for k, v in d.items() if k in known})


def _trunc_normal(shape, std, gen):
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return std * t


def _dense_params(gen, n_in, n_out, std):
    return {"kernel": _trunc_normal((n_in, n_out), std, gen), "bias": torch.zeros(n_out)}


def _ln_params(n):
    return {"gamma": torch.ones(n), "beta": torch.zeros(n)}


def init_params(config: BertConfig, gen: torch.Generator, device=DEFAULT_DEVICE) -> dict:
    """Parameter tree with TF-BERT naming, drawn on the CPU from ``gen``
    (the same weights whatever the device) and moved to ``device``."""
    std, h = config.initializer_range, config.hidden_size
    params: dict[str, Any] = {
        "embeddings": {
            "word_embeddings": _trunc_normal((config.vocab_size, h), std, gen),
            "position_embeddings": _trunc_normal((config.max_position, h), std, gen),
            "token_type_embeddings": _trunc_normal((config.type_vocab_size, h), std, gen),
            "layer_norm": _ln_params(h),
        },
        "encoder": {},
        "mlm": {
            "transform": _dense_params(gen, h, h, std),
            "transform_layer_norm": _ln_params(h),
            "output_bias": torch.zeros(config.vocab_size),
        },
        "pooler": _dense_params(gen, h, h, std),
    }
    for i in range(config.num_layers):
        params["encoder"][f"layer_{i}"] = {
            "attention": {
                "query": _dense_params(gen, h, h, std),
                "key": _dense_params(gen, h, h, std),
                "value": _dense_params(gen, h, h, std),
                "output": _dense_params(gen, h, h, std),
                "output_layer_norm": _ln_params(h),
            },
            "intermediate": _dense_params(gen, h, config.intermediate_size, std),
            "output": _dense_params(gen, config.intermediate_size, h, std),
            "output_layer_norm": _ln_params(h),
        }
    dev = torch.device(device)
    return tree_map(lambda t: t.to(dev), params)


def _dense(p, x):
    policy = dtype_policy()
    y = torch.matmul(x.to(policy.compute_dtype), p["kernel"].to(policy.compute_dtype))
    return (y + p["bias"].to(y.dtype)).to(policy.output_dtype)


def _layer_norm(p, x, eps):
    """In x's dtype; the f32 gamma promotes the result (bf16 x -> f32)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _dropout(x, rate, train, gen):
    """Inverted dropout at ``rate`` with masks drawn from ``gen``."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def encoder_layer(lp: dict, config: BertConfig, x, attention_mask=None, *,
                  train: bool = False, gen: Optional[torch.Generator] = None):
    """One transformer block (``encoder/layer_N``)."""
    if config.fused_qkv:
        raise NotImplementedError("BertConfig(fused_qkv=True) is not ported")
    q = _dense(lp["attention"]["query"], x)
    k = _dense(lp["attention"]["key"], x)
    v = _dense(lp["attention"]["value"], x)
    attn = multi_head_attention(q, k, v, n_heads=config.num_heads, kv_mask=attention_mask,
                                use_flash=config.use_flash, flash_block=config.flash_block)
    attn = _dense(lp["attention"]["output"], attn)
    attn = _dropout(attn, config.hidden_dropout, train, gen)
    x = _layer_norm(lp["attention"]["output_layer_norm"], x + attn, config.layer_norm_eps)
    inter = _gelu(_dense(lp["intermediate"], x))
    out = _dense(lp["output"], inter)
    out = _dropout(out, config.hidden_dropout, train, gen)
    return _layer_norm(lp["output_layer_norm"], x + out, config.layer_norm_eps)


def embed(params: dict, config: BertConfig, input_ids, token_type_ids=None):
    """Embedding sum + layer norm (``embeddings``)."""
    t = input_ids.shape[1]
    emb = params["embeddings"]
    x = F.embedding(input_ids.long(), emb["word_embeddings"])
    x = x + emb["position_embeddings"][None, :t, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + F.embedding(token_type_ids.long(), emb["token_type_embeddings"])
    return _layer_norm(emb["layer_norm"], x, config.layer_norm_eps)


def encode(params: dict, config: BertConfig, input_ids, token_type_ids=None,
           attention_mask=None, *, train: bool = False, gen: Optional[torch.Generator] = None):
    """input_ids [B,T] -> hidden states [B,T,H].  ``gen`` feeds every
    dropout mask in order: the embeddings', then each layer's two."""
    x = embed(params, config, input_ids, token_type_ids)
    x = _dropout(x, config.hidden_dropout, train, gen)
    for i in range(config.num_layers):
        x = encoder_layer(params["encoder"][f"layer_{i}"], config, x, attention_mask,
                          train=train, gen=gen)
    return x


def pool(params: dict, hidden):
    """[CLS] pooler (``pooler``, tanh)."""
    return torch.tanh(_dense(params["pooler"], hidden[:, 0]))


def mlm_logits(params: dict, config: BertConfig, hidden):
    """Masked-LM head: transform, layer norm, decode with the TIED word
    embeddings plus the output bias; logits in at least f32."""
    x = _gelu(_dense(params["mlm"]["transform"], hidden))
    x = _layer_norm(params["mlm"]["transform_layer_norm"], x, config.layer_norm_eps)
    policy = dtype_policy()
    logits = torch.matmul(x.to(policy.compute_dtype),
                          params["embeddings"]["word_embeddings"].to(policy.compute_dtype).t())
    logits = logits + params["mlm"]["output_bias"].to(logits.dtype)
    return logits.to(torch.promote_types(policy.output_dtype, torch.float32))


def _weighted_mlm_ce(logits, labels, label_weights):
    """Weighted-mean cross-entropy over the masked positions."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    weights = label_weights.to(logp.dtype)
    return -(picked * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def top_positions(label_weights, k: int):
    """``jax.lax.top_k(label_weights, k)``'s indices: the k largest per row,
    ties toward the lower position (a stable descending sort)."""
    return torch.sort(label_weights, dim=1, descending=True, stable=True).indices[:, :k]


def mlm_loss(params: dict, config: BertConfig, input_ids, labels, label_weights,
             token_type_ids=None, attention_mask=None, *, train: bool = True,
             gen: Optional[torch.Generator] = None):
    """Masked-LM loss: mean cross-entropy over the positions of weight 1.
    With ``config.max_predictions = k`` the k top-weighted positions are
    gathered before the vocab decode."""
    hidden = encode(params, config, input_ids, token_type_ids, attention_mask,
                    train=train, gen=gen)
    k = config.max_predictions
    if k and k < hidden.shape[1]:
        pos = top_positions(label_weights, k)
        hidden = torch.gather(hidden, 1, pos[..., None].expand(-1, -1, hidden.shape[-1]))
        labels = torch.gather(labels, 1, pos)
        label_weights = torch.gather(label_weights, 1, pos)
    return _weighted_mlm_ce(mlm_logits(params, config, hidden), labels, label_weights)


def pipeline_stages(config: BertConfig, params: dict, n_stages: int):
    """Split the MLM model into ``n_stages`` pipeline stages: stage 0
    owns the embeddings and the first encoder layers, the middle stages
    their layers, the last stage its layers and the MLM head, whose tied
    decode uses a copy of the word embeddings (``decode_embeddings``;
    :func:`merge_tied_embedding_grads` keeps the two tied under
    training).  Returns ``(stage_fns, stage_params)``; ``fn(p, h)`` runs
    one stage in inference mode.  Stage 0's input is ``input_ids`` as
    float32 ([B, T]), the last stage's output the MLM logits ([B, T, V],
    f32)."""
    n_layers = config.num_layers
    if n_stages < 2 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} stages")
    per = n_layers // n_stages
    stage_params, stage_fns = [], []
    for s in range(n_stages):
        sp = {"layers": {f"layer_{i}": params["encoder"][f"layer_{i}"]
                         for i in range(s * per, (s + 1) * per)}}
        if s == 0:
            sp["embeddings"] = params["embeddings"]
        if s == n_stages - 1:
            sp["mlm"] = params["mlm"]
            sp["decode_embeddings"] = params["embeddings"]["word_embeddings"]
        stage_params.append(sp)

        def fn(p, h, s=s):
            x = embed(p, config, h.detach().to(torch.int32)) if s == 0 else h
            for i in range(s * per, (s + 1) * per):
                x = encoder_layer(p["layers"][f"layer_{i}"], config, x)
            if s < n_stages - 1:
                return x
            y = _gelu(_dense(p["mlm"]["transform"], x))
            y = _layer_norm(p["mlm"]["transform_layer_norm"], y, config.layer_norm_eps)
            policy = dtype_policy()
            logits = torch.matmul(y.to(policy.compute_dtype),
                                  p["decode_embeddings"].to(policy.compute_dtype).t())
            logits = logits + p["mlm"]["output_bias"].to(logits.dtype)
            return logits.to(torch.float32)

        stage_fns.append(fn)
    return stage_fns, stage_params


def merge_tied_embedding_grads(stage_grads):
    """Re-tie the pipelined decode weights to stage 0's embedding table:
    the sum of the two gradients (stage 0's ``embeddings/word_embeddings``
    and the last stage's ``decode_embeddings``) goes into both leaves, so
    that under any per-leaf updater the two copies, equal at the start,
    stay equal.  Returns a tuple of the stages' gradient trees."""
    grads = list(stage_grads)
    first, last = dict(grads[0]), dict(grads[-1])
    emb = dict(first["embeddings"])
    total = emb["word_embeddings"] + last["decode_embeddings"]
    emb["word_embeddings"] = total
    first["embeddings"] = emb
    last["decode_embeddings"] = total
    grads[0], grads[-1] = first, last
    return tuple(grads)


def mlm_loss_from_logits(logits, packed_labels):
    """Loss head of the pipelined model: ``packed_labels`` [B, T, 2] holds
    (labels, label_weights) on its last axis."""
    return _weighted_mlm_ce(logits, packed_labels[..., 0], packed_labels[..., 1])


class BertForMaskedLM:
    """BERT MLM workload: its params, serving and fine-tuning on one
    device (the card unless ``device="cpu"``)."""

    def __init__(self, config: BertConfig, seed: int = 0, device=DEFAULT_DEVICE):
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        self.params = init_params(config, torch.Generator().manual_seed(seed), self.device)
        self.opt_state = None
        self._step = None
        self.iteration = 0

    def num_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params))

    def _tensor(self, x, dtype):
        return None if x is None else torch.as_tensor(x, device=self.device).to(dtype)

    def make_train_step(self, updater):
        """The MLM train step for a port updater (``train/updaters.py``):
        ``step(params, opt_state, input_ids, labels, label_weights,
        attention_mask, gen) -> (params, opt_state, loss)`` with a fresh
        0-dim device loss.

        DONATION CONTRACT, as in the JAX package: the step updates the
        ``params`` and ``opt_state`` trees it is given in place and returns
        them, so callers rebind to what it returns (``model.params,
        model.opt_state, loss = step(model.params, model.opt_state, ...)``,
        as :meth:`fit` does), and a tree kept from before the step holds
        the new values.  On the card the step runs as CUDA graphs
        (``train/capture.py``): eager for its first calls, then captured
        once and replayed."""
        config = self.config

        def step(params, opt_state, input_ids, labels, label_weights, attention_mask, gen):
            grad_params = tree_map(lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss = mlm_loss(grad_params, config, input_ids, labels, label_weights,
                                attention_mask=attention_mask, train=True, gen=gen)
                leaves = tree_leaves(grad_params)
                # the pooler is not on the MLM path: its gradient is zero, as in JAX
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
            grads = tree_map(lambda _: next(grads), params)
            with torch.no_grad():
                updates, new_opt_state = updater.update(grads, opt_state, params)
                tree_map(lambda p, u: p.add_(u), params, updates)
                write_into(opt_state, new_opt_state)
            return params, opt_state, loss.detach()

        return CapturedStep(step, n_trees=2, name=f"{type(self).__name__}.train_step")

    def fit(self, batches, updater=None, epochs: int = 1, listeners=None):
        """Fine-tune over ``batches`` (dicts of ``input_ids``, ``labels``,
        ``label_weights`` and optionally ``attention_mask``, as
        ``BertIterator`` yields them) for ``epochs``, with ``updater``
        (default ``Adam(2e-5)``).  Batches reach the device through a
        ``DeviceFeeder`` (no bucketing: they are fixed-shape); after every
        step ``iteration_done(model, iteration, epoch, score)`` goes
        through ``listeners``, a ``ListenerBus`` or a list.  Returns the
        last loss."""
        from deeplearning4j_tpu_torch.data.device_pipeline import DeviceFeeder
        from deeplearning4j_tpu_torch.obs.listeners import ListenerBus
        bus = listeners if isinstance(listeners, ListenerBus) else ListenerBus(listeners)
        updater = updater or updater_mod.Adam(2e-5)
        if self.opt_state is None:
            self.opt_state = updater.init(self.params)
        if self._step is None:
            self._step = self.make_train_step(updater)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 31)
        last = float("nan")

        def _place(batch):
            """Host tensors of the step's dtypes; the feeder stages them."""
            attn = batch.get("attention_mask")
            return (torch.as_tensor(batch["input_ids"]).long(),
                    torch.as_tensor(batch["labels"]).long(),
                    torch.as_tensor(batch["label_weights"]).float(),
                    None if attn is None else torch.as_tensor(attn).float())

        feeder = DeviceFeeder(_place, bucketing=False, device=self.device)
        for epoch in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for fed in feeder.feed(batches):
                ids, labels, weights, attn = fed.batch
                self.params, self.opt_state, loss = self._step(
                    self.params, self.opt_state, ids, labels, weights, attn, gen)
                last = loss.item()
                bus.dispatch("iteration_done", self, self.iteration, epoch, last)
                self.iteration += 1
        return last

    @torch.no_grad()
    def predict_mlm(self, input_ids, attention_mask=None):
        """MLM logits [B, T, V] (at least f32) on the model's device."""
        hidden = encode(self.params, self.config, self._tensor(input_ids, torch.long),
                        attention_mask=self._tensor(attention_mask, torch.float32))
        return mlm_logits(self.params, self.config, hidden)

    def save(self, path: str) -> None:
        """A zip of ``bert_config.json`` and ``params.npz``, as the JAX
        package writes it."""
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("bert_config.json", json.dumps(self.config.to_dict()))
            zf.writestr("params.npz", _tree_to_npz_bytes(self.params))

    @staticmethod
    def load(path: str, device=DEFAULT_DEVICE) -> "BertForMaskedLM":
        """A model from a zip that either package wrote."""
        with zipfile.ZipFile(path, "r") as zf:
            config = BertConfig.from_dict(json.loads(zf.read("bert_config.json").decode()))
            model = BertForMaskedLM(config, device=device)
            model.params = _rebuild_like(model.params, _npz_bytes_to_leaves(zf.read("params.npz")))
        return model
