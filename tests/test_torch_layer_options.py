"""Layer options of the port's convolutional layers held to the JAX package.

``ConvolutionLayer`` in the "causal", "truncate" and "strict" modes,
``SubsamplingLayer`` in max, avg (both pad rules), sum and pnorm under
SAME and explicit padding, and ``GlobalPoolingLayer`` in max, avg, sum and
pnorm with and without a mask: the same numpy inputs and weights go
through the reference's ``apply`` and the port's (``deeplearning4j_tpu_torch/
nn/layers/conv.py``), f32, within 1e-5 of the largest output entry (sum
order only).  Then a reference JSON config with these options loads into
the port and its forward answers as the reference net's, weights carried
across with ``interop.load_jax_params``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, layers
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-5            # of the largest output entry: f32 sum order only
X_SHAPE = (2, 7, 7, 3)


def _x(seed=0, shape=X_SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"max |diff| {err:.2e} of the largest entry, over {TOL}"


def _both(name, x, params=None, mask=None, **kw):
    """The reference's and the port's ``apply`` of layer ``name`` on x."""
    params = params or {}
    want, _ = getattr(jlayers, name)(**kw).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, {}, jnp.asarray(x),
        mask=None if mask is None else jnp.asarray(mask))
    got, _ = getattr(layers, name)(**kw).apply(
        {k: torch.from_numpy(v) for k, v in params.items()}, {}, torch.from_numpy(x),
        mask=None if mask is None else torch.from_numpy(mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", ["causal", "truncate", "strict"])
def test_convolution_modes_match_the_reference(mode):
    rng = np.random.default_rng(1)
    params = {"W": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    kw = dict(n_out=4, kernel_size=(3, 3), padding=(1, 1), convolution_mode=mode)
    got, want = _both("ConvolutionLayer", _x(), params, **kw)
    assert got.shape == (2, 7, 7, 4)
    # shape inference agrees with what the forward gives
    out = layers.ConvolutionLayer(**kw).get_output_type(InputType.convolutional(7, 7, 3))
    assert (out.height, out.width, out.channels) == got.shape[1:]
    _close(got, want)


POOLS = [("max", False), ("avg", True), ("avg", False), ("sum", False), ("pnorm", False)]


@pytest.mark.parametrize("mode", ["same", "truncate"])
@pytest.mark.parametrize("kind,include_pad", POOLS)
def test_subsampling_matches_the_reference(kind, include_pad, mode):
    # 3x3 windows at stride 2 over 7x7: SAME pads one row and column on each
    # side; truncate is given padding (1, 1), so both rules see pads
    kw = dict(pooling_type=kind, kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
              convolution_mode=mode, pnorm=3, avg_pool_include_pad=include_pad)
    got, want = _both("SubsamplingLayer", _x(2), **kw)
    assert got.shape == (2, 4, 4, 3)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_the_reference(kind, masked):
    mask = None
    if masked:
        mask = (np.random.default_rng(3).random((2, 7, 7)) > 0.4).astype(np.float32)
        mask[1] = 0
        mask[1, 3, 4] = 1          # one image with a single live pixel
    got, want = _both("GlobalPoolingLayer", _x(4), mask=mask, pooling_type=kind, pnorm=3)
    assert got.shape == (2, 3)
    _close(got, want)


def test_global_pooling_over_time_matches_the_reference():
    x = _x(5, (3, 9, 4))
    mask = (np.arange(9)[None, :] < np.array([9, 5, 1])[:, None]).astype(np.float32)
    for kind in ("max", "pnorm"):
        _close(*_both("GlobalPoolingLayer", x, mask=mask, pooling_type=kind))


def test_reference_json_config_with_these_options_runs_in_the_port():
    jconf = (JNeuralNetConfiguration.builder().seed(3).list()
             .layer(jlayers.ConvolutionLayer(n_out=4, kernel_size=(3, 3), padding=(1, 1),
                                             convolution_mode="causal", activation="relu"))
             .layer(jlayers.SubsamplingLayer(pooling_type="avg", kernel_size=(3, 3),
                                             stride=(2, 2), convolution_mode="same"))
             .layer(jlayers.SubsamplingLayer(pooling_type="pnorm", pnorm=2, kernel_size=(2, 2),
                                             stride=(1, 1), padding=(1, 1)))
             .layer(jlayers.GlobalPoolingLayer(pooling_type="max"))
             .layer(jlayers.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.convolutional(7, 7, 3)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert [type(layer).__name__ for layer in conf.layers] == [
        "ConvolutionLayer", "SubsamplingLayer", "SubsamplingLayer", "GlobalPoolingLayer",
        "OutputLayer"]
    jnet = JMultiLayerNetwork(jconf).init()
    net = load_jax_params(MultiLayerNetwork(conf, device="cpu"),
                          [{k: np.array(a) for k, a in d.items()} for d in jnet.params_],
                          [{k: np.array(a) for k, a in d.items()} for d in jnet.state_])
    x = _x(6)
    _close(net.output(x).numpy(), np.asarray(jnet.output(x)))
