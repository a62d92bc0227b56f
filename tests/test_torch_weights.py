"""The port's weight initializers (``deeplearning4j_tpu_torch/nn/weights.py``)
against the JAX package's (``deeplearning4j_tpu/nn/weights.py``).

The two draw from different random streams, so no draw can match: every
registered name must exist in both, zero, ones and identity must be
exact, and every random init must give the reference's shape and dtype
and its statistics at a large shape (the std within 2%, a uniform's
bounds exactly: every draw inside them, the extremes within 0.1% of
them).  A config-first layer built without ``weight_init`` takes the
default ``xavier``: a ``.list()`` net of GlobalPoolingLayer + OutputLayer
inits on the CPU and, carried across with ``interop.load_jax_params``,
answers as the JAX net does."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGlobalPoolingLayer
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.layers import GlobalPoolingLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

SHAPE = (1000, 1000)         # a million draws: the sample std moves ~0.07%
FAN_IN, FAN_OUT = 300.0, 700.0
STD_TOL = 0.02
EXACT = ("zero", "ones", "identity")
# (kind, scale) of each random init at (fan_in, fan_out), each fan (or their
# sum) clamped to at least 1 as the reference does: a normal's std, a
# uniform's bound
DIST = {
    "normal": ("normal", lambda fi, fo: 1 / math.sqrt(max(fi, 1))),
    "uniform": ("uniform", lambda fi, fo: math.sqrt(3 / max(fi, 1))),
    "xavier": ("normal", lambda fi, fo: math.sqrt(2 / max(fi + fo, 1))),
    "xavier_uniform": ("uniform", lambda fi, fo: math.sqrt(6 / max(fi + fo, 1))),
    "xavier_fan_in": ("normal", lambda fi, fo: math.sqrt(1 / max(fi, 1))),
    "relu": ("normal", lambda fi, fo: math.sqrt(2 / max(fi, 1))),
    "relu_uniform": ("uniform", lambda fi, fo: math.sqrt(6 / max(fi, 1))),
    "lecun_normal": ("normal", lambda fi, fo: math.sqrt(1 / max(fi, 1))),
    "lecun_uniform": ("uniform", lambda fi, fo: math.sqrt(3 / max(fi, 1))),
    "sigmoid_uniform": ("uniform", lambda fi, fo: 4 * math.sqrt(6 / max(fi + fo, 1))),
    "var_scaling_normal_fan_in": ("normal", lambda fi, fo: math.sqrt(1 / max(fi, 1))),
    "var_scaling_normal_fan_out": ("normal", lambda fi, fo: math.sqrt(1 / max(fo, 1))),
    "var_scaling_normal_fan_avg": ("normal", lambda fi, fo: math.sqrt(2 / max(fi + fo, 1))),
    "var_scaling_uniform_fan_in": ("uniform", lambda fi, fo: math.sqrt(3 / max(fi, 1))),
    "var_scaling_uniform_fan_out": ("uniform", lambda fi, fo: math.sqrt(3 / max(fo, 1))),
    "var_scaling_uniform_fan_avg": ("uniform", lambda fi, fo: math.sqrt(6 / max(fi + fo, 1))),
}


def _draw_both(init_name_or_pair, shape=SHAPE, fi=FAN_IN, fo=FAN_OUT, dtype="float32"):
    """(port draw, JAX draw) of one init, each from a seeded generator."""
    port_fn, jax_fn = (init_name_or_pair if isinstance(init_name_or_pair, tuple)
                       else (weights.get(init_name_or_pair), jweights.get(init_name_or_pair)))
    ours = port_fn(torch.Generator().manual_seed(3), shape, fi, fo, getattr(torch, dtype))
    theirs = jax_fn(jax.random.PRNGKey(3), shape, fi, fo, getattr(jnp, dtype))
    return ours, theirs


def test_the_port_registers_every_reference_init():
    assert weights.names() == jweights.names()
    assert set(DIST) | set(EXACT) == set(jweights.names())


@pytest.mark.parametrize("name", jweights.names())
def test_init_matches_the_reference(name):
    shape = (64, 64) if name == "identity" else SHAPE
    ours, theirs = _draw_both(name, shape)
    assert tuple(ours.shape) == tuple(theirs.shape) == shape
    assert ours.dtype == torch.float32 and theirs.dtype == jnp.float32
    ours, theirs = ours.numpy(), np.asarray(theirs)
    if name in EXACT:
        np.testing.assert_array_equal(ours, theirs)
        return
    kind, scale = DIST[name]
    scale = scale(FAN_IN, FAN_OUT)
    if kind == "normal":
        for sample in (ours, theirs):
            assert abs(sample.std() / scale - 1) <= STD_TOL
            assert abs(sample.mean()) <= 0.01 * scale
        assert abs(ours.std() / theirs.std() - 1) <= STD_TOL
    else:
        for sample in (ours, theirs):
            assert np.abs(sample).max() <= scale
            assert -sample.min() >= 0.999 * scale and sample.max() >= 0.999 * scale
            assert abs(sample.std() / (scale / math.sqrt(3)) - 1) <= STD_TOL
        assert abs(ours.std() / theirs.std() - 1) <= STD_TOL


@pytest.mark.parametrize("name", jweights.names())
def test_init_keeps_the_param_dtype_and_fans(name):
    """bf16 params and a fan of 0 (clamped to 1, as in the reference)."""
    shape = (8, 8)
    ours, theirs = _draw_both(name, shape, fi=0.0, fo=0.0, dtype="bfloat16")
    assert ours.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    assert tuple(ours.shape) == shape and bool(torch.isfinite(ours.float()).all())
    if name in EXACT:
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(theirs, np.float32))
    elif DIST[name][0] == "uniform":
        assert float(ours.float().abs().max()) <= DIST[name][1](0.0, 0.0) * (1 + 2 ** -8)


def test_identity_refuses_a_non_square_weight():
    for get in (weights.get, jweights.get):
        with pytest.raises(ValueError, match="square"):
            get("identity")(None, (3, 4), 3.0, 4.0, None)


def test_unknown_names_raise_a_key_error_naming_the_known_ones():
    with pytest.raises(KeyError, match="xavier"):
        weights.get("nope")
    with pytest.raises(KeyError, match="unknown distribution"):
        weights.distribution("nope")


# (distribution, keywords, what is checked of both draws beside their moments)
DISTRIBUTIONS = [
    ("normal", {"mean": 0.5, "std": 2.0}, "moments"),
    ("gaussian", {}, "moments"),
    ("uniform", {"lower": -0.25, "upper": 0.75}, "bounds"),
    ("truncated_normal", {"mean": 1.0, "std": 0.5}, "truncated"),
    ("constant", {"value": 0.125}, "exact"),
    ("orthogonal", {"gain": 2.0}, "orthogonal"),
    ("binomial", {"n": 4, "p": 0.25}, "moments"),
    ("log_normal", {"mean": 0.0, "std": 0.5}, "moments"),
]


@pytest.mark.parametrize("dist,kw,check", DISTRIBUTIONS, ids=[d[0] for d in DISTRIBUTIONS])
def test_distribution_matches_the_reference(dist, kw, check):
    shape = (256, 256) if check == "orthogonal" else SHAPE
    ours, theirs = _draw_both((weights.distribution(dist, **kw),
                               jweights.distribution(dist, **kw)), shape)
    assert tuple(ours.shape) == tuple(theirs.shape) == shape
    assert ours.dtype == torch.float32 and theirs.dtype == jnp.float32
    ours, theirs = ours.numpy().astype(np.float64), np.asarray(theirs, np.float64)
    if check == "exact":
        np.testing.assert_array_equal(ours, theirs)
    elif check == "orthogonal":
        for sample in (ours, theirs):
            np.testing.assert_allclose(sample @ sample.T, kw["gain"] ** 2 * np.eye(shape[0]),
                                       atol=1e-4)
    else:
        if check == "bounds":
            for sample in (ours, theirs):
                assert sample.min() >= kw["lower"] and sample.max() <= kw["upper"]
        if check == "truncated":
            for sample in (ours, theirs):
                lo, hi = kw["mean"] - 2 * kw["std"], kw["mean"] + 2 * kw["std"]
                assert sample.min() >= lo and sample.max() <= hi
        assert abs(ours.mean() - theirs.mean()) <= 0.01 * max(theirs.std(), 1e-3)
        assert abs(ours.std() / theirs.std() - 1) <= STD_TOL


def _nets():
    """The same GlobalPoolingLayer + OutputLayer config in both packages,
    no weight_init anywhere (each layer's default)."""
    def build(builder, pool, out, input_type):
        return (builder().seed(7).list()
                .layer(pool(pooling_type="avg"))
                .layer(out(n_out=5, activation="softmax", loss="mcxent"))
                .set_input_type(input_type.convolutional(6, 6, 4)).build())
    return (build(NeuralNetConfiguration.builder, GlobalPoolingLayer, OutputLayer, InputType),
            build(JNeuralNetConfiguration.builder, JGlobalPoolingLayer, JOutputLayer, JInputType))


def test_layers_without_weight_init_init_on_the_port_as_in_the_reference():
    conf, jconf = _nets()
    assert conf.layers[1].weight_init is None
    net = MultiLayerNetwork(conf, device="cpu").init(seed=7)
    w = net.params_[1]["W"]
    assert tuple(w.shape) == (4, 5) and w.dtype == torch.float32
    # the default is xavier: N(0, sqrt(2 / (fanIn + fanOut))) at fans (4, 5)
    assert 0 < float(w.std()) < 3 * math.sqrt(2 / 9)
    jnet = JMultiLayerNetwork(jconf).init()
    x = np.random.default_rng(2).normal(size=(3, 6, 6, 4)).astype(np.float32)
    carried = load_jax_params(MultiLayerNetwork(conf, device="cpu"),
                              [{k: np.array(a) for k, a in d.items()} for d in jnet.params_],
                              [{k: np.array(a) for k, a in d.items()} for d in jnet.state_])
    np.testing.assert_allclose(carried.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-5)
