"""The port's BERT pipeline helpers held to the JAX package's.

Tiny BERT (``BertConfig.tiny``: 2 layers, hidden 64) with the JAX model's
weights carried into the port.  ``pipeline_stages`` composed in sequence
equals ``mlm_logits(encode(...))`` in both packages and the JAX stages'
outputs; ``merge_tied_embedding_grads`` and ``mlm_loss_from_logits``
equal the reference's on the same trees.  Bands: f32 logits within 2e-6
of their largest entry, losses 1e-6 relative, merged gradients exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import bert as jbert

from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import bert
from deeplearning4j_tpu_torch.train.updaters import tree_map

B, T, TOL = 2, 12, 2e-6


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jc = jbert.BertConfig.tiny()
    jmodel = jbert.BertForMaskedLM(jc, seed=0)
    port = interop.load_jax_bert_params(
        bert.BertForMaskedLM(bert.BertConfig.from_dict(jc.to_dict()), device="cpu"),
        _np(jmodel.params))
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, (B, T)).astype(np.int32)
    return jmodel, port, ids


@pytest.mark.parametrize("n_stages", [2])
def test_composed_pipeline_stages_equal_the_model(models, n_stages):
    jmodel, port, ids = models
    fns, params = bert.pipeline_stages(port.config, port.params, n_stages)
    jfns, jparams = jbert.pipeline_stages(jmodel.config, jmodel.params, n_stages)
    assert len(fns) == n_stages
    assert [sorted(p) for p in params] == [sorted(p) for p in jparams]
    assert params[-1]["decode_embeddings"] is port.params["embeddings"]["word_embeddings"]
    h, jh = torch.from_numpy(ids.astype(np.float32)), jnp.asarray(ids.astype(np.float32))
    with torch.no_grad():
        for fn, p, jfn, jp in zip(fns, params, jfns, jparams):
            h, jh = fn(p, h), jfn(jp, jh)
            assert _rel(h, jh) <= TOL
        whole = bert.mlm_logits(port.params, port.config,
                                bert.encode(port.params, port.config, torch.from_numpy(ids)))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, T, port.config.vocab_size)
    assert torch.equal(h, whole)


def test_pipeline_stages_refuse_an_uneven_split(models):
    _, port, _ = models
    for n in (1, 3):
        with pytest.raises(ValueError, match="not divisible"):
            bert.pipeline_stages(port.config, port.params, n)


def test_merge_tied_embedding_grads_matches_jax(models):
    jmodel, port, _ = models
    _, jparams = jbert.pipeline_stages(jmodel.config, jmodel.params, 2)
    rng = np.random.default_rng(1)
    grads = [tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), _np(p))
             for p in jparams]
    want = jbert.merge_tied_embedding_grads([tree_map(jnp.asarray, g) for g in grads])
    inputs = [_torch(g) for g in grads]
    got = bert.merge_tied_embedding_grads(inputs)
    assert isinstance(got, tuple) and len(got) == 2
    total = grads[0]["embeddings"]["word_embeddings"] + grads[1]["decode_embeddings"]
    for g, w in zip(got, want):
        flat_g = {k: v for k, v in _flatten(g)}
        flat_w = {k: np.asarray(v) for k, v in _flatten(w)}
        assert set(flat_g) == set(flat_w)
        for k, v in flat_w.items():
            assert np.array_equal(flat_g[k].numpy(), v), k
    assert np.array_equal(got[0]["embeddings"]["word_embeddings"].numpy(), total)
    assert got[1]["decode_embeddings"] is got[0]["embeddings"]["word_embeddings"]
    # the input trees are left as they were
    assert np.array_equal(inputs[1]["decode_embeddings"].numpy(), grads[1]["decode_embeddings"])
    assert np.array_equal(inputs[0]["embeddings"]["word_embeddings"].numpy(),
                          grads[0]["embeddings"]["word_embeddings"])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("weights", ["sparse", "none"])
def test_mlm_loss_from_logits_matches_jax(weights):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, T, 30)).astype(np.float32) * 3
    labels = rng.integers(0, 30, (B, T)).astype(np.float32)
    w = ((rng.random((B, T)) < 0.3) if weights == "sparse" else np.zeros((B, T))).astype(
        np.float32)
    packed = np.stack([labels, w], -1)
    want = float(jbert.mlm_loss_from_logits(jnp.asarray(logits), jnp.asarray(packed)))
    got = bert.mlm_loss_from_logits(torch.from_numpy(logits), torch.from_numpy(packed))
    assert got.ndim == 0
    assert abs(got.item() - want) <= 1e-6 * max(abs(want), 1.0)


def test_loss_from_the_last_stage_equals_mlm_loss(models):
    """The pipelined model's loss head on the composed stages equals
    ``mlm_loss`` (no max_predictions, no dropout)."""
    _, port, ids = models
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(0, port.config.vocab_size, (B, T)))
    w = torch.from_numpy((rng.random((B, T)) < 0.3).astype(np.float32))
    fns, params = bert.pipeline_stages(port.config, port.params, 2)
    h = torch.from_numpy(ids.astype(np.float32))
    with torch.no_grad():
        for fn, p in zip(fns, params):
            h = fn(p, h)
        got = bert.mlm_loss_from_logits(h, torch.stack([labels.float(), w], -1))
        want = bert.mlm_loss(port.params, port.config, torch.from_numpy(ids), labels, w,
                             train=False)
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
