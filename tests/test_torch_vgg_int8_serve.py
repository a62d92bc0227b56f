"""The port's int8 serving slice held to the JAX package: a VGG-shaped
``.list()`` net, ``MultiLayerNetwork``, ``quantize_net`` and the engine.

A 32x32x3 net with VGG-16's layer kinds (two blocks of two 3x3 "same"
convs of 8 and 16 channels, each closed by a 2x2 max pool, dense 64 and
a 10-way softmax output) is initialised by the JAX package and carried
into the port through ``interop.load_jax_params``.  Under the f32 policy
the port's fp and int8 outputs are held to JAX's at 1e-5 in log
probabilities (both sides compute in f32, in other summation orders;
int8 weights dequantize exactly).  Under ``bench_quantized``'s bf16
serving policy the int8 outputs are held at 0.1 in log probabilities:
the two packages' bf16 convolutions round their outputs at other places,
and four bf16 layers carry a one-ulp difference (2^-8 relative) on.
Quantized weights and the report's counts must match JAX's exactly, its
calibration readings to ``CALIB_TOL``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import config as jconfig
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import quantize as jquantize
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMultiLayerConfiguration
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConvolutionLayer
from deeplearning4j_tpu.nn.layers import DenseLayer as JDenseLayer
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JSubsamplingLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.train import Nesterovs as JNesterovs

import chip_smoke
from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import vgg16
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.quantize import calibrate, quantize_net
from deeplearning4j_tpu_torch.ops.kernels import quant_matmul
from deeplearning4j_tpu_torch.serve import InferenceEngine
from deeplearning4j_tpu_torch.train import Nesterovs

F32_TOL = 1e-5
BF16_INT8_TOL = 0.1
# the report's calibration readings (max and mean |int8 - fp| of the output
# probabilities; the band is twice the max): f32, two f32 forwards in other
# orders; bf16, outputs rounded to bf16, whose ulp is 2^-8 in [0.5, 1): two ulps
CALIB_TOL = {"f32": 1e-6, "bf16": 2.0 ** -7}
POLICIES = {
    "f32": (config.DTypePolicy.f32(), jconfig.DTypePolicy.f32()),
    "bf16": (config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                output_dtype=torch.bfloat16),
             jconfig.DTypePolicy(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                                 output_dtype=jnp.bfloat16)),
}


def _stack(builder, conv, pool, dense, output, input_type, updater):
    b = builder().seed(5).updater(updater).weight_init("relu").list()
    for n_out in (8, 16):
        for _ in range(2):
            b.layer(conv(n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
                         activation="relu"))
        b.layer(pool(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
    b.layer(dense(n_out=64, activation="relu"))
    b.layer(output(n_out=10, activation="softmax", loss="mcxent"))
    return b.set_input_type(input_type.convolutional(32, 32, 3)).build()


def _jax_conf():
    return _stack(JNeuralNetConfiguration.builder, JConvolutionLayer, JSubsamplingLayer,
                  JDenseLayer, JOutputLayer, JInputType, JNesterovs(1e-2, 0.9))


def _port_conf():
    return _stack(NeuralNetConfiguration.builder, ConvolutionLayer, SubsamplingLayer,
                  DenseLayer, OutputLayer, InputType, Nesterovs(1e-2, 0.9))


class _policy:
    """Both packages under one named dtype policy inside the ``with``."""

    def __init__(self, name):
        self.port, self.jax = POLICIES[name]

    def __enter__(self):
        config.set_dtype_policy(self.port)
        jconfig.set_dtype_policy(self.jax)

    def __exit__(self, *exc):
        config.set_dtype_policy(config.DTypePolicy.f32())
        jconfig.set_dtype_policy(jconfig.DTypePolicy.f32())


def _np_list(tree):
    return [{k: np.array(a) for k, a in d.items()} for d in tree]


def _log_gap(p, q):
    return chip_smoke.log_prob_err(torch.as_tensor(np.array(p, np.float32)),
                                   torch.as_tensor(np.array(q, np.float32)))


@pytest.fixture(scope="module", params=sorted(POLICIES))
def carried(request):
    """Per policy: the JAX fp and int8 nets and outputs, and the port's
    nets filled from the JAX weights."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(12, 32, 32, 3)).astype(np.float32)
    calib = [x[:6], x[6:]]
    with _policy(request.param):
        jnet = JMultiLayerNetwork(_jax_conf()).init()
        jq = jquantize.quantize_net(jnet, calibration=calib)
        out = {"policy": request.param, "x": x, "calib": calib, "jnet": jnet, "jq": jq,
               "j_fp": np.asarray(jnet.output(x).astype(jnp.float32)),
               "j_int8": np.asarray(jq.output(x).astype(jnp.float32))}
        net = load_jax_params(MultiLayerNetwork(_port_conf(), device="cpu"),
                              _np_list(jnet.params_), _np_list(jnet.state_))
        out["net"] = net
        out["q"] = quantize_net(net, calibration=calib)
    return out


def test_fp_output_matches_jax(carried):
    with _policy(carried["policy"]):
        y = carried["net"].output(carried["x"])
    if carried["policy"] == "f32":
        assert _log_gap(y, carried["j_fp"]) <= F32_TOL
    else:   # bf16 fp: the same roundings as the int8 path's convolutions
        assert y.dtype == torch.bfloat16
        assert _log_gap(y.float(), carried["j_fp"]) <= BF16_INT8_TOL


def test_quantize_net_matches_jax(carried):
    q, jq = carried["q"], carried["jq"]
    assert q.quantized_ == jq.quantized_ == "int8"
    assert carried["net"].quantized_ is None
    for ours, theirs in zip(q.params_, jq.params_):
        assert set(ours) == set(theirs)
        for key, t in ours.items():
            want = np.asarray(theirs[key].astype(jnp.float32) if key == "b" else theirs[key])
            got = t.float().numpy() if key == "b" else t.numpy()
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    ours, theirs = q.quantization_.to_dict(), jq.quantization_.to_dict()
    tol = CALIB_TOL[carried["policy"]]
    for key, times in (("max_abs_err", 1), ("mean_abs_err", 1), ("tolerance_band", 2)):
        assert abs(ours.pop(key) - theirs.pop(key)) <= times * tol, key
    assert ours == theirs and ours["layers_quantized"] == 6
    assert carried["net"].params_[0]["W"].dtype == (
        torch.float32 if carried["policy"] == "f32" else torch.bfloat16)


def test_int8_output_matches_jax(carried):
    before = quant_matmul.launches
    with _policy(carried["policy"]):
        y = carried["q"].output(carried["x"])
    tol = F32_TOL if carried["policy"] == "f32" else BF16_INT8_TOL
    assert _log_gap(y.float(), carried["j_int8"]) <= tol
    assert quant_matmul.launches == before     # the CPU path never launches


def test_int8_stays_within_its_calibrated_band(carried):
    with _policy(carried["policy"]):
        fp, q = carried["net"].output(carried["x"]), carried["q"].output(carried["x"])
    band = carried["q"].quantization_.tolerance_band
    assert 0 < (q.float() - fp.float()).abs().max().item() <= band
    with _policy(carried["policy"]):
        assert calibrate(carried["net"], carried["calib"]).to_dict() == \
            carried["q"].quantization_.to_dict()


def test_engine_over_qnet_matches_output(carried):
    rng = np.random.default_rng(12)
    requests = [rng.normal(size=(n, 32, 32, 3)).astype(np.float32) for n in (1, 3, 5, 2)]
    with _policy(carried["policy"]):
        with InferenceEngine(carried["q"], max_batch=8, max_latency_ms=20.0) as engine:
            assert engine.precision == "int8"
            futures = [engine.submit(r) for r in requests]
            answers = [f.result(timeout=60) for f in futures]
        with InferenceEngine(carried["net"], max_batch=8) as engine:
            assert engine.precision == "fp"
        for r, a in zip(requests, answers):
            want = carried["q"].output(r).float().numpy()
            np.testing.assert_allclose(a, want, rtol=0, atol=F32_TOL)


def test_load_jax_params_carries_a_quantized_net(carried):
    with _policy(carried["policy"]):
        fresh = quantize_net(MultiLayerNetwork(_port_conf(), device="cpu").init(seed=1))
        q = load_jax_params(fresh, _np_list(carried["jq"].params_),
                            _np_list(carried["jq"].state_))
        y = q.output(carried["x"])
    tol = F32_TOL if carried["policy"] == "f32" else BF16_INT8_TOL
    assert _log_gap(y.float(), carried["j_int8"]) <= tol
    bad = _np_list(carried["jq"].params_)
    bad[0]["W_q"] = bad[0]["W_q"].astype(np.float32)
    with pytest.raises(TypeError, match="W_q"):
        load_jax_params(fresh, bad, _np_list(carried["jq"].state_))
    with pytest.raises(KeyError, match="entries"):
        load_jax_params(fresh, bad[:-1], _np_list(carried["jq"].state_))


def test_conf_json_loads_both_ways():
    jconf = _jax_conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert json.loads(_port_conf().to_json()) == json.loads(jconf.to_json())
    back = JMultiLayerConfiguration.from_json(_port_conf().to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert conf.output_type().size == 10
    assert [t.kind for t in conf.input_types()][-2:] == ["cnn", "ff"]


def test_network_surface_matches_jax(carried):
    net, jnet = carried["net"], carried["jnet"]
    assert net.num_params() == jnet.num_params()
    assert net.summary() == jnet.summary()
    x = carried["x"][:2]
    with _policy(carried["policy"]):
        acts = net.feed_forward(x)
        jacts = jnet.feed_forward(jnp.asarray(x))
        assert [tuple(a.shape) for a in acts] == [tuple(a.shape) for a in jacts]
        torch.testing.assert_close(acts[-1], net.output(x), rtol=0, atol=0)
        clone = net.clone()
        clone.params_[0]["W"].zero_()
        assert net.params_[0]["W"].abs().sum() > 0
        assert clone.conf.to_dict() == net.conf.to_dict()


def test_vgg16_param_shapes_match_jax_without_allocating():
    """Shapes only: ``jax.eval_shape`` on the JAX side; on the port's,
    each layer's ``init_params`` on the meta device from the config's
    shape inference."""
    jparams = jax.eval_shape(lambda: jzoo.vgg16().init().params_)
    net = vgg16(device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        params = [layer.init_params(gen, t) if layer.has_params() else {}
                  for layer, t in zip(net.layers, net.conf.input_types())]
    assert [{k: tuple(v.shape) for k, v in d.items()} for d in params] == \
        [{k: tuple(v.shape) for k, v in d.items()} for d in jparams]
    assert sum(v.numel() for d in params for v in d.values()) == 138_357_544
    assert json.loads(net.conf.to_json()) == json.loads(jzoo.vgg16().conf.to_json())
    assert net.params_ is None


def test_tbptt_waits_for_the_recurrent_layers():
    with pytest.raises(NotImplementedError, match="recurrent"):
        NeuralNetConfiguration.builder().list().backprop_type("tbptt")
    conf = _port_conf()
    conf.backprop_type = "tbptt"
    with pytest.raises(NotImplementedError, match="recurrent"):
        MultiLayerNetwork(conf, device="cpu")
