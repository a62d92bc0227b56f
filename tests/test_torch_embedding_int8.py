"""The port's int8 embedding gather held to the JAX package's.

A seeded table is quantized by both packages' ``quantize_weight`` (which
must give the same int8 rows and scales); the port's
``EmbeddingLayer._lookup`` of the quantized table is held to the JAX
layer's ``_lookup`` under the f32 policy (exactly: a widening and one f32
product per entry) and under the bf16 serving policy (exactly: the same
f32 value rounded once to bf16), for ``[B]`` and ``[B, T]`` indices and
through ``EmbeddingSequenceLayer``.  ``quantize_net`` of a net with an
embedding layer must quantize it and give the JAX package's report.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import config as jconfig
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import quantize as jquantize
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.quantize import quantize_net, quantize_weight

SEED = 20261018
VOCAB, D = 50, 12
POLICIES = {"f32": (config.DTypePolicy.f32(), jconfig.DTypePolicy.f32()),
            "bf16": (config.DTypePolicy.bf16(), jconfig.DTypePolicy.bf16())}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(SEED)
    w = rng.normal(scale=0.3, size=(VOCAB, D)).astype(np.float32)
    w[3] = 0.0                                       # an all-zero row
    q, s = quantize_weight(torch.from_numpy(w))
    jq, js = jquantize.quantize_weight(jnp.asarray(w))
    return {"w": w, "q": q, "s": s, "jq": jq, "js": js,
            "ids": rng.integers(0, VOCAB, size=(4, 7))}


def test_quantized_tables_match(table):
    np.testing.assert_array_equal(table["q"].numpy(), np.asarray(table["jq"]))
    np.testing.assert_array_equal(table["s"].numpy(), np.asarray(table["js"]))
    assert table["q"].dtype == torch.int8 and table["s"].shape == (D,)


@pytest.mark.parametrize("policy", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ["B", "BT"])
def test_lookup_matches_the_reference(table, policy, shape):
    ids = table["ids"][:, 0] if shape == "B" else table["ids"]
    ours_p, theirs_p = POLICIES[policy]
    prev, jprev = config.dtype_policy(), jconfig.dtype_policy()
    config.set_dtype_policy(ours_p)
    jconfig.set_dtype_policy(theirs_p)
    try:
        got = layers.EmbeddingLayer(n_in=VOCAB, n_out=D)._lookup(
            {"W_q": table["q"], "W_scale": table["s"]}, torch.from_numpy(ids).long())
        want = jlayers.EmbeddingLayer(n_in=VOCAB, n_out=D)._lookup(
            {"W_q": table["jq"], "W_scale": table["js"]}, jnp.asarray(ids, jnp.int32))
    finally:
        config.set_dtype_policy(prev)
        jconfig.set_dtype_policy(jprev)
    want_dtype = torch.float32 if policy == "f32" else torch.bfloat16
    assert got.dtype == want_dtype and str(want.dtype) == str(want_dtype).split(".")[1]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the gather is the dequantized table's rows, rounded once
    deq = table["q"].float() * table["s"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  deq[torch.from_numpy(ids).long()].to(want_dtype).float().numpy())


def test_sequence_layer_inherits_the_gather(table):
    ids = torch.from_numpy(table["ids"]).float()[..., None]
    params = {"W_q": table["q"], "W_scale": table["s"], "b": torch.zeros(D)}
    y, _ = layers.EmbeddingSequenceLayer(n_in=VOCAB, n_out=D).apply(params, {}, ids)
    want = (table["q"].float() * table["s"])[table["ids"]]
    assert y.shape == (4, 7, D)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def _confs():
    def build(nnc, lay, input_type):
        return (nnc.builder().seed(SEED).list()
                .layer(lay.EmbeddingLayer(n_in=VOCAB, n_out=D, activation="tanh"))
                .layer(lay.DenseLayer(n_out=16, activation="relu"))
                .layer(lay.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
                .set_input_type(input_type.feed_forward(1)).build())
    return (build(NeuralNetConfiguration, layers, InputType),
            build(JNeuralNetConfiguration, jlayers, JInputType))


def test_quantize_net_quantizes_embeddings_like_the_reference():
    conf, jconf = _confs()
    jnet = JMultiLayerNetwork(jconf).init()
    net = load_jax_params(MultiLayerNetwork(conf, device="cpu"), jnet.params_, jnet.state_)
    rng = np.random.default_rng(SEED + 1)
    calib = [rng.integers(0, VOCAB, size=(16, 1)).astype(np.float32) for _ in range(2)]
    q = quantize_net(net, calibration=calib)
    jq = jquantize.quantize_net(jnet, calibration=calib)
    assert sorted(q.params_[0]) == sorted(jq.params_[0]) == ["W_q", "W_scale", "b"]
    ours, theirs = q.quantization_.to_dict(), jq.quantization_.to_dict()
    assert ours["layers_quantized"] == theirs["layers_quantized"] == 3
    for key in ("fp_weight_bytes", "quantized_weight_bytes", "compression_ratio",
                "calibration_batches"):
        assert ours[key] == theirs[key], key
    # calibration readings: max / mean |int8 - fp| of f32 probabilities in two
    # summation orders; their rounding is at most an ulp at 1.0
    for key in ("max_abs_err", "mean_abs_err"):
        assert abs(ours[key] - theirs[key]) <= 2.0 ** -22, key
    x = rng.integers(0, VOCAB, size=(8, 1)).astype(np.float32)
    np.testing.assert_allclose(q.output(x).numpy(), np.asarray(jq.output(x)), rtol=0, atol=1e-6)
