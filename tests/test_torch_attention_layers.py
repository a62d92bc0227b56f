"""The config-first attention stack of the port held to the JAX package's.

Each layer (``SelfAttentionLayer``, ``LearnedSelfAttentionLayer``,
``AttentionVertex``, ``LayerNormalization``, ``PReLULayer``,
``EmbeddingLayer``, ``EmbeddingSequenceLayer``) gets the JAX layer's
``init_params`` and the same numpy inputs and is held to the JAX layer's
``apply``: at T = 16 on the einsum path and at T = 64 with
``use_flash=True, flash_block=32`` (the Pallas kernels in interpret mode
on the JAX side, the plain flash versions on the port's).  Then two
graphs built with the JAX package's config API load from its JSON into
the port: a small encoder (embedding, self attention, residual adds,
layer norms, a feed-forward block, pooling, softmax) whose forward and
one ``fit_batch`` step are held to the JAX graph's, and a two-input graph
with every other layer type of this stack.

Bands: f32 outputs within 2e-6 of their largest entry; the step's loss
1e-6 relative, each param after one ``Sgd`` step within 1e-6 of its
largest entry (the attention key biases, whose gradient is exactly zero,
within 1e-7 of where they started, in both packages).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import vertices as jvertices
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, layers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as attention_layers
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.vertices import AttentionVertex, vertex_from_dict
from deeplearning4j_tpu_torch.ops import attention as attention_ops
from deeplearning4j_tpu_torch.train import Trainer

B, D, VOCAB = 2, 16, 50
TOL = 2e-6
PATHS = {"einsum": (16, {}), "flash": (64, {"use_flash": True, "flash_block": 32})}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


def _jax_params(jlayer, itype, seed=0):
    p = jlayer.init_params(jax.random.key(seed), itype)
    # random biases and PReLU slopes, so that they count in the comparison
    rng = np.random.default_rng(seed + 1)
    return {k: (np.asarray(v) if k.startswith("W") or k == "Q" or k == "gamma"
                else rng.normal(size=v.shape).astype(np.float32)) for k, v in p.items()}


def _port_layer(jlayer):
    return layer_from_dict(json.loads(json.dumps(jlayer.to_dict())))


def _run_both(jlayer, jtype, x, mask=None):
    jp = _jax_params(jlayer, jtype)
    want, _ = jlayer.apply({k: jnp.asarray(v) for k, v in jp.items()}, {}, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
    layer = _port_layer(jlayer)
    got, _ = layer.apply({k: torch.from_numpy(v) for k, v in jp.items()}, {},
                         torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    return got, want, layer


def _seq(t, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(B, t, d)).astype(np.float32)


def _mask(t):
    m = np.ones((B, t), np.float32)
    m[1, t * 5 // 8:] = 0.0
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("path", list(PATHS))
def test_self_attention_layer_matches_jax(path, masked):
    t, kw = PATHS[path]
    jl = jlayers.SelfAttentionLayer(n_heads=2, has_bias=True, **kw)
    got, want, _ = _run_both(jl, JInputType.recurrent(D, t), _seq(t), _mask(t) if masked else None)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_learned_self_attention_layer_matches_jax(masked):
    t = PATHS["einsum"][0]
    jl = jlayers.LearnedSelfAttentionLayer(n_heads=2, head_size=4, n_queries=3, has_bias=True)
    got, want, _ = _run_both(jl, JInputType.recurrent(D, t), _seq(t), _mask(t) if masked else None)
    assert tuple(got.shape) == (B, 3, 8)
    _close(got, want)


def test_unprojected_self_attention_matches_jax():
    t = PATHS["einsum"][0]
    jl = jlayers.SelfAttentionLayer(n_heads=4, project_input=False)
    got, want, layer = _run_both(jl, JInputType.recurrent(D, t), _seq(t))
    assert not layer.has_params()
    _close(got, want)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("inputs", [1, 3])
def test_attention_vertex_matches_jax(path, inputs):
    t, kw = PATHS[path]
    jv = jvertices.AttentionVertex(n_heads=2, causal=True, **kw)
    xs = [_seq(t, seed=i) for i in range(inputs)]
    want = jv.apply([jnp.asarray(x) for x in xs])
    v = vertex_from_dict(json.loads(json.dumps(jv.to_dict())))
    assert isinstance(v, AttentionVertex) and v == AttentionVertex(n_heads=2, causal=True, **kw)
    _close(v.apply([torch.from_numpy(x) for x in xs]), want)
    types = [InputType.recurrent(D, t)] * inputs
    assert v.get_output_type(types) == InputType.recurrent(D, t)


def test_attention_vertex_cross_attention_and_arity():
    q, kv = _seq(4, seed=1), _seq(16, seed=2)
    jv = jvertices.AttentionVertex(n_heads=2)
    v = AttentionVertex(n_heads=2)
    _close(v.apply([torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv)]),
           jv.apply([jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv)]))
    assert v.get_output_type([InputType.recurrent(D, 4), InputType.recurrent(D, 16),
                              InputType.recurrent(8, 16)]) == InputType.recurrent(8, 4)
    with pytest.raises(ValueError, match="1 \\(self\\) or 3"):
        v.apply([torch.from_numpy(q), torch.from_numpy(kv)])


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("kind", ["ff", "rnn"])
def test_layer_normalization_matches_jax(kind, use_bias):
    jl = jlayers.LayerNormalization(eps=1e-5, use_bias=use_bias)
    if kind == "ff":
        jtype, x = JInputType.feed_forward(D), _seq(1)[:, 0] * 3.0 + 1.0
    else:
        jtype, x = JInputType.recurrent(D, 8), _seq(8) * 3.0 + 1.0
    got, want, layer = _run_both(jl, jtype, x)
    _close(got, want)
    assert set(layer.init_params(torch.Generator(), InputType.from_dict(jtype.to_dict()))) == \
        ({"gamma", "beta"} if use_bias else {"gamma"})


@pytest.mark.parametrize("kind", ["ff", "rnn", "cnn"])
def test_prelu_matches_jax(kind):
    jtype, x = {"ff": (JInputType.feed_forward(D), _seq(1)[:, 0]),
                "rnn": (JInputType.recurrent(D, 8), _seq(8)),
                "cnn": (JInputType.convolutional(4, 4, D), _seq(16).reshape(B, 4, 4, D))}[kind]
    got, want, _ = _run_both(jlayers.PReLULayer(), jtype, x)
    _close(got, want)


IDS = np.random.default_rng(5).integers(0, VOCAB, size=(B, 6))


@pytest.mark.parametrize("layer,ids", [
    ("embedding", IDS[:, 0]), ("embedding", IDS[:, :1]), ("embedding", IDS),
    ("embedding_sequence", IDS), ("embedding_sequence", IDS[..., None])],
    ids=["B", "B1", "BT", "seq_BT", "seq_BT1"])
def test_embedding_layers_match_jax(layer, ids):
    cls = jlayers.EmbeddingLayer if layer == "embedding" else jlayers.EmbeddingSequenceLayer
    jl = cls(n_in=VOCAB, n_out=D, activation="tanh")
    jtype = JInputType.feed_forward(1) if layer == "embedding" else JInputType.recurrent(1, 6)
    got, want, _ = _run_both(jl, jtype, ids.astype(np.float32))
    _close(got, want)


def test_quantized_embedding_table_raises_and_points_at_the_queue():
    """The quantized table that raised before the int8 gather was ported
    now gathers: int8 rows widened to f32 and scaled per column (the
    gather's parity with the JAX package is held in
    test_torch_embedding_int8.py)."""
    layer = layers.EmbeddingLayer(n_in=VOCAB, n_out=D, has_bias=False)
    w_q = torch.arange(VOCAB * D, dtype=torch.int64).reshape(VOCAB, D).remainder(255).sub(127)
    params = {"W_q": w_q.to(torch.int8), "W_scale": torch.full((D,), 0.5)}
    ids = torch.tensor([0, VOCAB - 1], dtype=torch.long)
    y, _ = layer.apply(params, {}, ids)
    torch.testing.assert_close(y, w_q[ids].float() * 0.5, rtol=0, atol=0)


@pytest.mark.parametrize("jlayer,jtype", [
    (jlayers.SelfAttentionLayer(n_heads=2, head_size=4, has_bias=True), JInputType.recurrent(8, 6)),
    (jlayers.SelfAttentionLayer(n_heads=1, project_input=False), JInputType.recurrent(8, 6)),
    (jlayers.LearnedSelfAttentionLayer(n_heads=2, head_size=4, n_queries=3),
     JInputType.recurrent(8, 6)),
    (jlayers.LayerNormalization(), JInputType.convolutional(4, 4, 5)),
    (jlayers.PReLULayer(), JInputType.feed_forward(12)),
    (jlayers.EmbeddingLayer(n_in=7, n_out=5), JInputType.feed_forward(1)),
    (jlayers.EmbeddingSequenceLayer(n_in=7, n_out=5, has_bias=False), JInputType.recurrent(1, 5)),
], ids=lambda v: getattr(v, "TYPE_NAME", None) or getattr(v, "kind", ""))
def test_output_types_and_param_shapes_match_jax(jlayer, jtype):
    layer = _port_layer(jlayer)
    assert type(layer).__name__ == type(jlayer).__name__
    itype = InputType.from_dict(jtype.to_dict())
    assert layer.get_output_type(itype).to_dict() == jlayer.get_output_type(jtype).to_dict()
    want = {k: tuple(v.shape) for k, v in jlayer.init_params(jax.random.key(0), jtype).items()}
    got = {k: tuple(v.shape) for k, v in layer.init_params(torch.Generator(), itype).items()}
    assert got == want
    assert layer.has_params() == jlayer.has_params()


def test_attention_routing_follows_sequence_length(monkeypatch):
    """``use_flash=None`` takes the flash path from 1024 (the longer of
    the query and key sequences for the learned queries), an explicit
    value wins."""
    calls = []
    real = attention_ops.flash_attention
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape[1]) or real(*a, **k))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 1024, 8)).astype(np.float32))
    itype = InputType.recurrent(8, 1024)
    for layer, launched in ((layers.SelfAttentionLayer(n_heads=2), 1),
                            (layers.SelfAttentionLayer(n_heads=2, use_flash=False), 0),
                            (layers.LearnedSelfAttentionLayer(n_heads=2, n_queries=2), 1),
                            (layers.SelfAttentionLayer(n_heads=2, use_flash=True), 1)):
        calls.clear()
        p = layer.init_params(torch.Generator().manual_seed(0), itype)
        layer.apply(p, {}, x[:, :512] if layer.use_flash else x)
        assert len(calls) == launched, (layer, calls)
    calls.clear()
    AttentionVertex(n_heads=2).apply([x[:, :1023]])
    assert not calls


def test_masked_global_pooling_under_bf16_matches_jax():
    """A bf16 [B, T, C] with an f32 mask: the mask is not rounded to bf16,
    and the pooled result is f32, as JAX promotes."""
    x = torch.from_numpy(_seq(64)).to(torch.bfloat16)
    mask = _mask(64)
    for kind in ("avg", "sum", "max", "pnorm"):
        jl = jlayers.GlobalPoolingLayer(pooling_type=kind)
        want, _ = jl.apply({}, {}, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                           mask=jnp.asarray(mask))
        got, _ = _port_layer(jl).apply({}, {}, x, mask=torch.from_numpy(mask))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), kind
        _close(got, np.asarray(want, np.float32), tol=1e-6)


# ----------------------------------------------------------- whole graphs
T_GRAPH = 16


def _encoder_conf(t=T_GRAPH, **attn):
    g = (JNeuralNetConfiguration.builder().seed(7).updater(JSgd(0.1)).graph()
         .add_inputs("ids").set_input_types(JInputType.recurrent(1, t))
         .add_layer("emb", jlayers.EmbeddingSequenceLayer(n_in=VOCAB, n_out=D), "ids"))
    prev = "emb"
    for i in range(2):
        g = (g.add_layer(f"att{i}", jlayers.SelfAttentionLayer(n_heads=2, has_bias=True, **attn),
                         prev)
             .add_vertex(f"res{i}a", jvertices.ElementWiseVertex(op="add"), prev, f"att{i}")
             .add_layer(f"ln{i}a", jlayers.LayerNormalization(), f"res{i}a")
             .add_layer(f"ff{i}", jlayers.DenseLayer(n_out=2 * D, activation="gelu"), f"ln{i}a")
             .add_layer(f"proj{i}", jlayers.DenseLayer(n_out=D), f"ff{i}")
             .add_vertex(f"res{i}b", jvertices.ElementWiseVertex(op="add"), f"ln{i}a",
                         f"proj{i}")
             .add_layer(f"ln{i}b", jlayers.LayerNormalization(), f"res{i}b"))
        prev = f"ln{i}b"
    return (g.add_layer("pool", jlayers.GlobalPoolingLayer(pooling_type="avg"), prev)
            .add_layer("out", jlayers.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                       "pool")
            .set_outputs("out").build())


def _np_tree(tree):
    return {v: {k: np.array(a) for k, a in d.items()} for v, d in tree.items()}


def _port_graph(jconf, jnet):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    return load_jax_params(ComputationGraph(conf, device="cpu"), _np_tree(jnet.params_),
                           _np_tree(jnet.state_))


@pytest.fixture(scope="module", params=list(PATHS))
def encoder(request):
    """The JAX encoder at one path, its forward, one Sgd step, and the
    data."""
    t, kw = PATHS[request.param]
    t = max(t, T_GRAPH)
    jconf = _encoder_conf(t, **kw)
    jnet = JComputationGraph(jconf).init()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, VOCAB, size=(B, t, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    out = np.asarray(jnet.output(ids))
    p0 = _np_tree(jnet.params_)
    loss = float(JTrainer(jnet).fit_batch(JDataSet(ids, y), jax.random.key(0)))
    return {"path": request.param, "jconf": jconf, "p0": p0, "s0": _np_tree(jnet.state_),
            "out": out, "loss": loss, "p1": _np_tree(jnet.params_), "ids": ids, "y": y}


def test_encoder_graph_from_jax_json_forward_matches(encoder):
    conf = ComputationGraphConfiguration.from_json(encoder["jconf"].to_json())
    kinds = {s.obj.TYPE_NAME for s in conf.vertices}
    assert {"embedding_sequence", "self_attention", "layer_norm", "elementwise"} <= kinds
    net = load_jax_params(ComputationGraph(conf, device="cpu"), encoder["p0"], encoder["s0"])
    _close(net.output(encoder["ids"]), encoder["out"])


def test_encoder_graph_fit_batch_step_matches(encoder):
    conf = ComputationGraphConfiguration.from_json(encoder["jconf"].to_json())
    net = load_jax_params(ComputationGraph(conf, device="cpu"), encoder["p0"], encoder["s0"])
    loss = Trainer(net).fit_batch(DataSet(encoder["ids"], encoder["y"])).item()
    assert abs(loss - encoder["loss"]) <= 1e-6 * abs(encoder["loss"])
    for vname, d in encoder["p1"].items():
        for k, want in d.items():
            if k == "bk":
                # softmax ignores a shift of a row's scores: the key bias's
                # gradient is exactly zero, and its step rounding noise in
                # both packages
                for moved in (net.params_[vname][k].numpy(), want):
                    assert np.abs(moved - encoder["p0"][vname][k]).max() <= 1e-7
                continue
            _close(net.params_[vname][k], want, tol=1e-6)


def _mixed_conf():
    """Two inputs, every other layer type of the stack, and the ff -> rnn
    adapter in front of a self-attention layer."""
    return (JNeuralNetConfiguration.builder().seed(11).graph()
            .add_inputs("ids", "seq")
            .set_input_types(JInputType.feed_forward(1), JInputType.recurrent(8, T_GRAPH))
            .add_layer("emb", jlayers.EmbeddingLayer(n_in=VOCAB, n_out=8), "ids")
            .add_layer("prelu", jlayers.PReLULayer(), "emb")
            .add_layer("att", jlayers.SelfAttentionLayer(n_heads=2), "prelu")
            .add_layer("q", jlayers.DenseLayer(n_out=8), "seq")
            .add_layer("k", jlayers.DenseLayer(n_out=8), "seq")
            .add_layer("v", jlayers.DenseLayer(n_out=8), "seq")
            .add_vertex("attv", jvertices.AttentionVertex(n_heads=2, causal=True), "q", "k", "v")
            .add_layer("learned", jlayers.LearnedSelfAttentionLayer(n_heads=2, n_queries=3),
                       "attv")
            .add_layer("pool1", jlayers.GlobalPoolingLayer(pooling_type="avg"), "att")
            .add_layer("pool2", jlayers.GlobalPoolingLayer(pooling_type="max"), "learned")
            .add_vertex("merge", jvertices.ElementWiseVertex(op="add"), "pool1", "pool2")
            .add_layer("out", jlayers.OutputLayer(n_out=3, activation="softmax"), "merge")
            .set_outputs("out").build())


def test_json_with_every_attention_stack_type_loads_and_matches_jax():
    jconf = _mixed_conf()
    jnet = JComputationGraph(jconf).init()
    rng = np.random.default_rng(4)
    # PReLU's slopes start at zero: give them values, in both packages
    alpha = rng.normal(size=(8,)).astype(np.float32)
    jnet.params_["prelu"]["alpha"] = jnp.asarray(alpha)
    net = _port_graph(jconf, jnet)
    kinds = {s.obj.TYPE_NAME for s in net.conf.vertices}
    assert {"embedding", "prelu", "self_attention", "attention", "learned_self_attention"} <= kinds
    assert net._known["att"] == InputType.recurrent(8, 1)
    ids = rng.integers(0, VOCAB, size=(B, 1)).astype(np.float32)
    seq = rng.normal(size=(B, T_GRAPH, 8)).astype(np.float32)
    _close(net.output(ids, seq), jnet.output(ids, seq))
    assert net.conf.to_dict() == ComputationGraphConfiguration.from_dict(
        json.loads(json.dumps(net.conf.to_dict()))).to_dict()


def test_bf16_encoder_runs_with_bf16_attention():
    """Under a bf16 policy with bf16 params the attention's q, k, v are
    bf16 (with the bf16 policy's f32 params they promote to f32, as in
    JAX); the forward is finite and near the f32 one of the same
    weights."""
    conf = ComputationGraphConfiguration.from_json(_encoder_conf().to_json())
    net = ComputationGraph(conf, device="cpu").init()
    ids = np.random.default_rng(3).integers(0, VOCAB, size=(B, T_GRAPH, 1)).astype(np.float32)
    want = net.output(ids)
    seen = []
    real = attention_layers.multi_head_attention

    def spy(q, *a, **k):
        seen.append(q.dtype)
        return real(q, *a, **k)

    bf16 = config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                              output_dtype=torch.bfloat16)
    config.set_dtype_policy(bf16)
    try:
        attention_layers.multi_head_attention = spy
        net.params_ = {v: {k: t.to(torch.bfloat16) for k, t in d.items()}
                       for v, d in net.params_.items()}
        got = net.output(ids)
    finally:
        attention_layers.multi_head_attention = real
        config.set_dtype_policy(config.DTypePolicy.f32())
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert torch.isfinite(got.float()).all()
    _close(got.float(), want.numpy(), tol=5e-2)
