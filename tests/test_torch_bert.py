"""The port's BERT held to the JAX package's.

Tiny BERT (``BertConfig.tiny``: 2 layers, hidden 64, 4 heads, vocab 1000)
with the JAX model's ``init_params`` weights carried into the port
(``interop.load_jax_bert_params``); the same numpy ids, labels, weights
and attention mask (one row padded) go through both packages.  Attention
runs both ways: the einsum path and the flash path (``use_flash=True,
flash_block=8``; the Pallas kernels in interpret mode on the JAX side,
the plain versions on the port's).

Bands (read at most, in brackets).  f32: hidden states and logits to
2e-6 of their largest entry (4.2e-7), the loss to 1e-6 relative
(6.9e-8), one Adam(1e-3) step's every update to 5e-6 absolute, 0.5% of
the learning rate (1.3e-6: Adam's first step is -lr·g/(|g|+eps), which
turns tiny gradients' rounding into O(lr) moves).  bf16 policy: hidden
states to 1e-3 of their largest entry (1.2e-4), logits to 2e-2 (6.9e-3:
one bf16 step of the largest logit), the loss to 5e-4 relative (7.6e-5):
the two frameworks round bf16 matmuls, GELU and the layer norm at
different places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import config as jconfig
from deeplearning4j_tpu.importers import tf_bert as jtf_bert
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.nlp import bert_iterator as jiter
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.train import updaters as jupdaters

from deeplearning4j_tpu_torch import config, interop
from deeplearning4j_tpu_torch.importers import tf_bert
from deeplearning4j_tpu_torch.io.model_serializer import leaf_at, tree_paths
from deeplearning4j_tpu_torch.models import bert
from deeplearning4j_tpu_torch.nlp import bert_iterator, tokenization
from deeplearning4j_tpu_torch.ops.kernels import flash_attention as flash
from deeplearning4j_tpu_torch.train.updaters import Adam

B, T = 2, 24
TOL = {"f32": {"hidden": 2e-6, "logits": 2e-6, "loss": 1e-6},
       "bf16": {"hidden": 1e-3, "logits": 2e-2, "loss": 5e-4}}


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


@pytest.fixture(scope="module")
def jax_model():
    return jbert.BertForMaskedLM(jbert.BertConfig.tiny(), seed=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    attn = np.ones((B, T), np.float32)
    attn[1, 17:] = 0.0
    return {"input_ids": rng.integers(0, 1000, (B, T)).astype(np.int32),
            "labels": rng.integers(0, 1000, (B, T)).astype(np.int32),
            "label_weights": (rng.random((B, T)) < 0.3).astype(np.float32),
            "attention_mask": attn}


@pytest.fixture
def policy(request):
    name = request.param
    jconfig.set_dtype_policy(getattr(jconfig.DTypePolicy, name)())
    config.set_dtype_policy(getattr(config.DTypePolicy, name)())
    yield name
    jconfig.set_dtype_policy(jconfig.DTypePolicy.f32())
    config.set_dtype_policy(config.DTypePolicy.f32())


def _configs(use_flash, **changes):
    jc = dataclasses.replace(jbert.BertConfig.tiny(), use_flash=use_flash, flash_block=8,
                             **changes)
    return jc, bert.BertConfig.from_dict(jc.to_dict())


def _port(jax_model, tc, seed=3):
    return interop.load_jax_bert_params(bert.BertForMaskedLM(tc, seed=seed, device="cpu"),
                                        _np(jax_model.params))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("policy", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("use_flash", [False, True])
def test_encode_and_predict_match_jax(jax_model, data, policy, use_flash):
    jc, tc = _configs(use_flash)
    model = _port(jax_model, tc)
    ids, attn = data["input_ids"], data["attention_mask"]
    jh = jbert.encode(jax_model.params, jc, jnp.asarray(ids), attention_mask=jnp.asarray(attn))
    th = bert.encode(model.params, tc, torch.from_numpy(ids), attention_mask=torch.from_numpy(attn))
    assert th.dtype == torch.float32 and jh.dtype == jnp.float32
    assert _rel(th.numpy(), jh) <= TOL[policy]["hidden"]
    jl = jbert.mlm_logits(jax_model.params, jc, jh)
    tl = bert.mlm_logits(model.params, tc, th)
    assert tl.dtype == torch.float32
    assert _rel(tl.numpy(), jl) <= TOL[policy]["logits"]
    before = flash.launches
    served = model.predict_mlm(ids, attention_mask=attn)
    assert flash.launches == before                        # the CPU runs no kernel
    assert tuple(served.shape) == (B, T, 1000)
    torch.testing.assert_close(served, tl, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("max_predictions", [0, 5])
def test_mlm_loss_matches_jax(jax_model, data, policy, max_predictions):
    jc, tc = _configs(True, max_predictions=max_predictions)
    model = _port(jax_model, tc)
    args = [data[k] for k in ("input_ids", "labels", "label_weights")]
    want = float(jbert.mlm_loss(jax_model.params, jc, *map(jnp.asarray, args),
                                attention_mask=jnp.asarray(data["attention_mask"]), train=False))
    got = bert.mlm_loss(model.params, tc, *map(torch.from_numpy, args),
                        attention_mask=torch.from_numpy(data["attention_mask"]),
                        train=False).item()
    assert abs(got - want) / abs(want) <= TOL[policy]["loss"]


def test_top_positions_break_ties_toward_the_lower_position():
    rng = np.random.default_rng(2)
    w = (rng.random((4, 32)) < 0.2).astype(np.float32)
    w[0] = 0.0                                              # every position tied
    w[1, :] = 1.0
    for k in (3, 8):
        _, want = jax.lax.top_k(jnp.asarray(w), k)
        got = bert.top_positions(torch.from_numpy(w), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_predictions", [0, 5])
def test_one_adam_step_matches_make_train_step(jax_model, data, max_predictions):
    """One f32 step of each package's train step from the same weights
    (dropout 0, flash path): the loss and every param's update, the tied
    word embeddings (input and decode) included."""
    jc, tc = _configs(True, hidden_dropout=0.0, max_predictions=max_predictions)
    jm = jbert.BertForMaskedLM(jc, seed=0)
    p0 = _np(jm.params)
    tx = jupdaters.Adam(1e-3).to_optax()
    jparams, _, jloss = jm.make_train_step(tx)(
        jm.params, tx.init(jm.params), *(jnp.asarray(data[k]) for k in
                                         ("input_ids", "labels", "label_weights",
                                          "attention_mask")), jax.random.key(0))
    jparams = _np(jparams)
    model = interop.load_jax_bert_params(bert.BertForMaskedLM(tc, device="cpu"), p0)
    updater = Adam(1e-3)
    tparams, state, tloss = model.make_train_step(updater)(
        model.params, updater.init(model.params),
        *(torch.from_numpy(data[k]).long() for k in ("input_ids", "labels")),
        torch.from_numpy(data["label_weights"]), torch.from_numpy(data["attention_mask"]), None)
    assert tloss.ndim == 0 and abs(tloss.item() - float(jloss)) / float(jloss) <= 1e-6
    assert int(state["count"]) == 1
    paths = tree_paths(p0)
    assert len(paths) == 2 * 16 + 5 + 5 + 2   # layers, embeddings, mlm, pooler
    for path in paths:
        want = leaf_at(jparams, path) - leaf_at(p0, path)
        got = leaf_at(tparams, path).numpy() - leaf_at(p0, path)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6, err_msg="/".join(path))


def test_fit_runs_over_bert_iterator_batches_and_calls_listeners():
    corpus = [f"the quick brown fox {i} jumps over the lazy dog number {i % 7}"
              for i in range(10)]
    tok = tokenization.BertWordPieceTokenizer(tokenization.build_vocab(corpus))
    it = bert_iterator.BertIterator(tok, bert_iterator.CollectionSentenceProvider(corpus),
                                    seq_len=16, batch_size=4, seed=1)
    tc = bert.BertConfig.tiny(vocab_size=len(tok.vocab))
    model = bert.BertForMaskedLM(tc, device="cpu")
    seen = []

    class Listener:
        def iteration_done(self, m, iteration, epoch, score):
            seen.append((m is model, iteration, epoch, np.isfinite(score)))

    last = model.fit(it, epochs=2, listeners=[Listener()])
    assert np.isfinite(last)
    assert seen == [(True, i, i // 3, True) for i in range(6)]
    assert model.iteration == 6 and int(model.opt_state["count"]) == 6


def test_zips_cross_load_both_ways(jax_model, tmp_path):
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jax_model.save(jpath)
    model = bert.BertForMaskedLM.load(jpath, device="cpu")
    assert model.config.to_dict() == jax_model.config.to_dict()
    for path in tree_paths(_np(jax_model.params)):
        np.testing.assert_array_equal(leaf_at(model.params, path).numpy(),
                                      np.asarray(leaf_at(jax_model.params, path)))
    model.params["mlm"]["output_bias"] += 1.5                 # a change that must carry
    model.save(tpath)
    back = jbert.BertForMaskedLM.load(tpath)
    for path in tree_paths(_np(jax_model.params)):
        np.testing.assert_array_equal(np.asarray(leaf_at(back.params, path)),
                                      leaf_at(model.params, path).numpy())


def test_tf_bert_export_and_map_round_trip(jax_model):
    params = _np(jax_model.params)
    cfg = jbert.BertConfig.tiny()
    tcfg = bert.BertConfig.from_dict(cfg.to_dict())
    exported = tf_bert.export_variables(params, tcfg)
    want = jtf_bert.export_variables(params, cfg)
    assert sorted(exported) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(exported[name], np.asarray(want[name]))
    mapped_cfg, mapped = tf_bert.map_variables(exported, tcfg)
    jcfg, jmapped = jtf_bert.map_variables(want, cfg)
    assert mapped_cfg == tcfg
    for path in tree_paths(params):
        np.testing.assert_array_equal(leaf_at(mapped, path), leaf_at(params, path))
    assert tf_bert.infer_config(exported).to_dict() == jtf_bert.infer_config(want).to_dict()
    model = interop.load_jax_bert_params(bert.BertForMaskedLM(tcfg, device="cpu"), mapped)
    np.testing.assert_array_equal(model.params["encoder"]["layer_1"]["output"]["kernel"].numpy(),
                                  params["encoder"]["layer_1"]["output"]["kernel"])
    headless = {k: v for k, v in exported.items() if not k.startswith("cls/")}
    _, fresh = tf_bert.map_variables(headless, tcfg)
    assert fresh["mlm"]["output_bias"].shape == (1000,)
    with pytest.raises(KeyError, match="layer_1"):
        tf_bert.map_variables({k: v for k, v in exported.items() if "layer_1/output" not in k},
                              tcfg)


def test_load_jax_bert_params_checks_keys_and_shapes(jax_model):
    params = _np(jax_model.params)
    model = bert.BertForMaskedLM(bert.BertConfig.tiny(), device="cpu")
    broken = dict(params, mlm={k: v for k, v in params["mlm"].items() if k != "output_bias"})
    with pytest.raises(KeyError, match="params/mlm"):
        interop.load_jax_bert_params(model, broken)
    wrong = _np(jax_model.params)
    wrong["encoder"]["layer_0"]["attention"]["query"]["kernel"] = np.zeros((64, 32), np.float32)
    with pytest.raises(ValueError, match="layer_0/attention/query/kernel"):
        interop.load_jax_bert_params(model, wrong)


def test_tokenizer_and_bert_iterator_batches_equal_jax():
    corpus = ["Héllo, World! unwanted running", "ab一亍cd x^y $z", "the cat sat on the mat",
              "a much longer sentence that will be truncated at the sequence length",
              "short", "another one, with punctuation; and more", "the end"]
    jv, tv = jtok.build_vocab(corpus, max_size=80), tokenization.build_vocab(corpus, max_size=80)
    assert tv.tokens == jv.tokens
    jt, tt = jtok.BertWordPieceTokenizer(jv), tokenization.BertWordPieceTokenizer(tv)
    for text in corpus + ["UNSEEN words here", "\x00control\tchars\r\n"]:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt.encode(text) == jt.encode(text)
    kwargs = dict(seq_len=12, batch_size=3, seed=5)
    jit_ = jiter.BertIterator(jt, jiter.CollectionSentenceProvider(corpus), **kwargs)
    tit = bert_iterator.BertIterator(tt, bert_iterator.CollectionSentenceProvider(corpus),
                                     **kwargs)
    for _ in range(2):                       # two epochs: fresh masks, replayed alike
        jb, tb = list(jit_), list(tit)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        jit_.reset()
        tit.reset()
    labelled = jiter.CollectionLabeledSentenceProvider(corpus[:4], ["a", "b", "a", "c"])
    tlabelled = bert_iterator.CollectionLabeledSentenceProvider(corpus[:4], ["a", "b", "a", "c"])
    jb = list(jiter.BertIterator(jt, labelled, task="seq_classification", **kwargs))
    tb = list(bert_iterator.BertIterator(tt, tlabelled, task="seq_classification", **kwargs))
    for a, b in zip(jb, tb):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_unported_fused_qkv_raises():
    model = bert.BertForMaskedLM(_configs(False, fused_qkv=True)[1], device="cpu")
    with pytest.raises(NotImplementedError, match="fused_qkv"):
        model.predict_mlm(np.zeros((1, 4), np.int32))


def _swap_dk_dv(*args, **kwargs):
    dq, dk, dv = flash.flash_attention_block_bwd_plain(*args, **kwargs)
    return dq, dv, dk


def _drop_dq(*args, **kwargs):
    dq, dk, dv = flash.flash_attention_block_bwd_plain(*args, **kwargs)
    return torch.zeros_like(dq), dk, dv


def _drop_lse_shift(q, k, v, out, lse, dout, **kwargs):
    return flash.flash_attention_block_bwd_plain(q, k, v, out, torch.zeros_like(lse), dout,
                                                 **kwargs)


@pytest.mark.parametrize("fault", [_swap_dk_dv, _drop_dq, _drop_lse_shift])
def test_smoke_bert_training_check_catches_backward_wiring_faults(fault, monkeypatch, data):
    """chip_smoke.py holds each param's step-0 update through the kernels
    to the one through the plain versions at BERT_UPDATE_TOL (relative, in
    norm, Adam).  A fault in the flash backward moves that reading by far
    more than the limit; without one, on the CPU (where the kernel path
    runs the plain pair) it reads 0."""
    import chip_smoke

    def step0():
        model = bert.BertForMaskedLM(_configs(True)[1], seed=1, device="cpu")
        watch = chip_smoke.StepWatch(bert.tree_map(lambda p: p.clone(), model.params))
        model.fit([data], updater=Adam(chip_smoke.BERT_TRAIN_LR), listeners=[watch])
        return watch.update0

    with chip_smoke.plain_flash():
        plain = step0()
    errs, key_bias = chip_smoke.bert_update_errs(step0(), plain)
    assert max(errs.values()) == 0.0 and key_bias <= chip_smoke.BERT_TRAIN_LR
    monkeypatch.setattr(flash, "flash_attention_block_bwd", fault)
    errs, _ = chip_smoke.bert_update_errs(step0(), plain)
    assert max(errs.values()) > 100 * chip_smoke.BERT_UPDATE_TOL
