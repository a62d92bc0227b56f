"""The port's ResNet-50 serving slice held to the JAX package.

A 32x32, 10-class ResNet-50 (all 16 bottlenecks, full channel widths) is
initialised by the JAX package; its weights, with BN running statistics,
gammas and betas redrawn from a seed so that no BN is the identity, are
carried into the port through ``interop.load_jax_params``.  The port's
``output`` and answers through ``InferenceEngine`` are held to JAX
``net.output`` at atol 2e-4: f32 sums taken in another order compound
over ResNet-50's ~50 conv/BN layers.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.models import zoo as jzoo

from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import resnet50
from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.serve import EngineClosed, InferenceEngine, Overloaded

ATOL = 2e-4


def _perturb_bn(params, state, rng):
    for d in state.values():
        for k in d:
            n = d[k].shape[0]
            d[k] = (rng.normal(0, 0.1, n) if k.startswith("mean")
                    else rng.uniform(0.5, 1.5, n)).astype(np.float32)
    for d in params.values():
        for k in d:
            if k.startswith("gamma"):
                # damp the residual branches so 16 blocks keep activations O(1)
                g = 0.3 if k in ("gamma_c", "gamma_proj") else 1.0
                d[k] = (g * rng.uniform(0.5, 1.5, d[k].shape)).astype(np.float32)
            elif k.startswith("beta"):
                d[k] = rng.normal(0, 0.1, d[k].shape).astype(np.float32)


def _np_tree(tree):
    return {v: {k: np.array(a) for k, a in d.items()} for v, d in tree.items()}


def _jnp_tree(tree):
    return {v: {k: jnp.asarray(a) for k, a in d.items()} for v, d in tree.items()}


@pytest.fixture(scope="module")
def carried():
    jnet = jzoo.resnet50(height=32, width=32, num_classes=10, fused=True).init()
    rng = np.random.default_rng(7)
    params, state = _np_tree(jnet.params_), _np_tree(jnet.state_)
    _perturb_bn(params, state, rng)
    jnet.params_, jnet.state_ = _jnp_tree(params), _jnp_tree(state)
    x = rng.normal(size=(12, 32, 32, 3)).astype(np.float32)
    return jnet, params, state, x, np.asarray(jnet.output(x))


def _port_net(params, state, fused=True):
    net = resnet50(height=32, width=32, num_classes=10, fused=fused, device="cpu")
    return load_jax_params(net, params, state)


def test_output_matches_jax(carried):
    _, params, state, x, yj = carried
    assert yj.max() < 0.9, "softmax saturated: the comparison would be vacuous"
    yt = _port_net(params, state).output(x)
    assert yt.device.type == "cpu" and tuple(yt.shape) == (12, 10)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=ATOL)


def test_unfused_lowering_matches_jax(carried):
    """fused=False: ConvolutionLayer + BatchNormalization nodes, weights
    moved with the JAX package's own remap."""
    jnet, params, state, x, _ = carried
    uparams, ustate = jzoo.remap_bottleneck_params(params, state, to_fused=False)
    jun = jzoo.resnet50(height=32, width=32, num_classes=10, fused=False)
    jun.params_, jun.state_ = _jnp_tree(uparams), _jnp_tree(ustate)
    yj = np.asarray(jun.output(x[:4]))
    yt = _port_net(uparams, ustate, fused=False).output(x[:4])
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=ATOL)


def test_engine_requests_match_jax(carried):
    _, params, state, x, yj = carried
    net = _port_net(params, state)
    sizes = [1, 3, 2, 4, 2]            # 12 rows from five callers
    offsets = np.cumsum([0] + sizes)
    results = {}
    with InferenceEngine(net, max_batch=8, max_latency_ms=20.0) as engine:
        def call(i):
            results[i] = engine.predict(x[offsets[i]:offsets[i + 1]], timeout_s=60)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert 2 <= engine.batches <= len(sizes)   # 12 rows cannot fit one batch of 8
    for i in range(len(sizes)):
        np.testing.assert_allclose(results[i], yj[offsets[i]:offsets[i + 1]],
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused", [True, False])
def test_config_json_from_jax_builds_same_graph(fused):
    jconf_json = jzoo.resnet50(height=32, width=32, num_classes=10, fused=fused).conf.to_json()
    conf = ComputationGraphConfiguration.from_json(jconf_json)
    assert json.loads(conf.to_json()) == json.loads(jconf_json)
    port_conf = resnet50(height=32, width=32, num_classes=10, fused=fused, device="cpu").conf
    assert json.loads(port_conf.to_json()) == json.loads(jconf_json)
    assert conf.output_types()["out"].size == 10


def test_graph_from_jax_json_serves_same_answers(carried):
    jnet, params, state, x, yj = carried
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = load_jax_params(ComputationGraph(conf, device="cpu"), params, state)
    np.testing.assert_allclose(net.output(x[:2]).numpy(), yj[:2], rtol=0, atol=ATOL)


def test_load_jax_params_rejects_a_mismatched_tree(carried):
    _, params, state, _, _ = carried
    bad = {v: dict(d) for v, d in params.items()}
    bad["res2_0"]["W_a"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="W_a"):
        _port_net(bad, state)
    missing = {v: d for v, d in params.items() if v != "out"}
    with pytest.raises(KeyError, match="out"):
        _port_net(missing, state)


class _Doubler:
    """A stand-in model: answers 2*x, optionally after a wait."""

    device = torch.device("cpu")
    params_ = state_ = None

    def __init__(self, wait: threading.Event | None = None):
        self.wait = wait
        self.rows = []

    def _forward(self, params, state, x, *, train, mask=None):
        if self.wait is not None:
            self.wait.wait(timeout=30)
        self.rows.append(x.shape[0])
        return 2 * x, state


def test_engine_pads_to_bucket_and_slices_rows():
    model = _Doubler()
    with InferenceEngine(model, max_batch=8, max_latency_ms=1.0) as engine:
        x = np.arange(15, dtype=np.float32).reshape(5, 3)
        np.testing.assert_array_equal(engine.predict(x, timeout_s=30), 2 * x)
    assert model.rows == [8]            # 5 rows padded to the bucket of 8


def test_engine_sheds_when_full_and_refuses_after_shutdown():
    gate = threading.Event()
    engine = InferenceEngine(_Doubler(gate), max_batch=1, max_latency_ms=0.0,
                             queue_limit=1)
    try:
        first = engine.submit(np.ones((1, 2), np.float32))
        futures = [first]
        with pytest.raises(Overloaded):
            for _ in range(10):   # the worker holds one, the queue one more
                futures.append(engine.submit(np.ones((1, 2), np.float32)))
    finally:
        gate.set()
        engine.shutdown()
    for f in futures:
        np.testing.assert_array_equal(f.result(timeout=30), 2 * np.ones((1, 2)))
    with pytest.raises(EngineClosed):
        engine.submit(np.ones((1, 2), np.float32))


def test_engine_dispatches_on_the_model_device():
    """The engine takes its device from the model: a CPU net's engine
    stages its batches on the CPU and answers there."""
    seen = []

    class _Recorder(_Doubler):
        def _forward(self, params, state, x, *, train, mask=None):
            seen.append(x.device)
            return super()._forward(params, state, x, train=train, mask=mask)

    model = _Recorder()
    with InferenceEngine(model, max_batch=4, max_latency_ms=1.0) as engine:
        assert engine.device == model.device == torch.device("cpu")
        assert engine.precision == "fp"
        x = np.ones((3, 2), np.float32)
        np.testing.assert_array_equal(engine.predict(x, timeout_s=30), 2 * x)
    assert seen == [torch.device("cpu")]


def _drop_relu_in(x, w, a=None, b=None, relu_in=False):
    return _KERNEL(x, w, a, b, relu_in=False)


def _swap_prologue(x, w, a=None, b=None, relu_in=False):
    return _KERNEL(x, w, b, a, relu_in=relu_in)


_KERNEL = fused_mod.matmul_bn_act


@pytest.mark.parametrize("fault", ["relu_in_dropped", "prologue_a_b_swapped",
                                   "expand_projection_swapped"])
def test_smoke_forward_check_catches_wiring_faults(fault, monkeypatch):
    """chip_smoke.py holds the forward through the kernel to the forward
    through the plain version in log probabilities at PLAIN_FWD_TOL.  With
    1000 classes the probabilities sit near 1e-3, so an absolute limit on
    them would miss a fault in how the layer wires the kernel; this check
    sees each such fault at 100x its limit."""
    net = resnet50(height=32, width=32, num_classes=1000, fused=True, device="cpu")
    net = chip_smoke.damp_residual_gammas(net.init(seed=chip_smoke.SEED))
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(np.float32)
    p0 = net.output(x)
    assert chip_smoke.log_prob_err(net.output(x), p0) <= chip_smoke.PLAIN_FWD_TOL
    if fault == "relu_in_dropped":
        monkeypatch.setattr(fused_mod, "matmul_bn_act", _drop_relu_in)
    elif fault == "prologue_a_b_swapped":
        monkeypatch.setattr(fused_mod, "matmul_bn_act", _swap_prologue)
    else:   # res2_0 is the one block whose W_c and W_proj have one shape
        d = net.params_["res2_0"]
        d["W_c"], d["W_proj"] = d["W_proj"], d["W_c"]
    assert chip_smoke.log_prob_err(net.output(x), p0) > 100 * chip_smoke.PLAIN_FWD_TOL
