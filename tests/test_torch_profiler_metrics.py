"""The port's profiling hooks (``obs/profiler.py``) and jsonl metrics
(``obs/metrics.py``) held to the JAX package's.

- ``check_finite`` raises only under ``nan_panic`` / ``inf_panic``, with
  the JAX package's message (label and leaf path) for the same tree.
- ``nan_panic`` and ``inf_panic`` in ``fit``: a planted NaN or Inf param
  raises ``NonFiniteError`` with the JAX package's message after the
  first step, in a layer stack and in a tBPTT net.
- ``StepTimer.summary``: the JAX package's keys and compile-step rule.
- ``MetricsWriter`` and the metrics ``StatsListener``: the same records
  (``ts`` aside; scores within 1e-5 relative) through ``fit``, where no
  gradient norms arrive in either package, and ``grad_norms`` keyed as
  the JAX package's ``param_table`` when ``on_gradient_calculation`` is
  dispatched by hand.
- ``trace`` writes a Chrome trace on the CPU, also around ``fit`` under
  ``config.profiling``; ``enable_debug_nans`` turns anomaly mode on and
  off.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import config as jconfig
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import metrics as jmetrics
from deeplearning4j_tpu.obs import profiler as jprofiler
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.utils.pytree import param_table as jparam_table

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import metrics, profiler
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.updaters import tree_map
from deeplearning4j_tpu_torch.utils.pytree import param_table

SEED = 20261018
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def panic_off():
    """Each test starts, and leaves both packages, with both panics off."""
    yield
    for cfg in (config, jconfig):
        cfg.set_config(nan_panic=False, inf_panic=False)
    config.set_config(profiling=False)


def _panic(nan: bool, inf: bool):
    for cfg in (config, jconfig):
        cfg.set_config(nan_panic=nan, inf_panic=inf)


def _tree(nan_at=None, inf_at=None):
    rng = np.random.default_rng(SEED)
    tree = [{"W": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=4).astype(np.float32)},
            {},
            {"gamma": np.ones(2, np.float32), "steps": np.arange(3, dtype=np.int32)},
            {"W": rng.normal(size=(4, 2)).astype(np.float32)}]
    for where, value in ((nan_at, np.nan), (inf_at, np.inf)):
        if where is not None:
            layer, key = where
            tree[layer][key].reshape(-1)[1] = value
    return tree


def _message(module, tree, label):
    try:
        module.check_finite(tree, label)
    except module.NonFiniteError as e:
        return str(e)
    return None


@pytest.mark.parametrize("nan_at,inf_at,panics", [
    ((3, "W"), None, (True, False)),
    (None, (0, "b"), (False, True)),
    ((2, "gamma"), (0, "W"), (True, True)),      # the first in flatten order names the error
    ((0, "W"), (3, "W"), (False, True)),         # a NaN without nan_panic passes
    (None, (0, "W"), (True, False)),             # an Inf without inf_panic passes
    (None, None, (True, True)),
    ((0, "b"), None, (False, False)),            # off: nothing is read
])
def test_check_finite_raises_as_jax_does(nan_at, inf_at, panics):
    tree = _tree(nan_at, inf_at)
    _panic(*panics)
    ours = _message(profiler, tree_map(torch.as_tensor, tree), "params after step")
    theirs = _message(jprofiler, jax.tree_util.tree_map(jnp.asarray, tree), "params after step")
    assert ours == theirs
    should_raise = (panics[0] and nan_at is not None) or (panics[1] and inf_at is not None)
    assert (ours is not None) == should_raise
    if ours is not None:
        assert ours.startswith(("NaN detected in params after step at (SequenceKey(idx=",
                                "Inf detected in params after step at (SequenceKey(idx="))


def _conf(mod):
    jax_side = mod == "jax"
    nn = JNeuralNetConfiguration if jax_side else NeuralNetConfiguration
    ly = jlayers if jax_side else layers
    it = JInputType if jax_side else InputType
    return (nn.builder().seed(5).updater((JSgd if jax_side else Sgd)(0.1)).list()
            .layer(ly.DenseLayer(n_out=6, activation="tanh"))
            .layer(ly.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(4)).build())


def _tbptt_conf(mod):
    jax_side = mod == "jax"
    nn = JNeuralNetConfiguration if jax_side else NeuralNetConfiguration
    ly = jlayers if jax_side else layers
    it = JInputType if jax_side else InputType
    return (nn.builder().seed(6).updater((JSgd if jax_side else Sgd)(0.1)).list()
            .layer(ly.LSTM(n_out=5))
            .layer(ly.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(it.recurrent(4)).backprop_type("tbptt", 3, 3).build())


def _batches(n=3, tbptt=False):
    rng = np.random.default_rng(SEED + 1)
    out = []
    for _ in range(n):
        if tbptt:
            x = rng.normal(size=(4, 6, 4)).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 6))]
        else:
            x = rng.normal(size=(8, 4)).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        out.append((x, y))
    return out


def _np_tree(tree):
    return [{k: np.array(v) for k, v in d.items()} for d in tree]


def _fit_error(mod, conf_fn, plant, tbptt):
    if mod == "jax":
        net = JMultiLayerNetwork(conf_fn("jax")).init()
        params = _np_tree(net.params_)
        params[0]["W"].reshape(-1)[2] = plant
        net.params_ = jax.tree_util.tree_map(jnp.asarray, params)
        it = JListDataSetIterator([JDataSet(x, y) for x, y in _batches(tbptt=tbptt)])
    else:
        jnet = JMultiLayerNetwork(conf_fn("jax")).init()
        params = _np_tree(jnet.params_)
        params[0]["W"].reshape(-1)[2] = plant
        net = load_jax_params(MultiLayerNetwork(conf_fn("torch"), device="cpu"), params,
                              _np_tree(jnet.state_))
        it = ListDataSetIterator([DataSet(x, y) for x, y in _batches(tbptt=tbptt)])
    error = jprofiler.NonFiniteError if mod == "jax" else profiler.NonFiniteError
    with pytest.raises(error) as info:
        net.fit(it, epochs=1)
    return str(info.value), net.iteration


@pytest.mark.parametrize("what", ["nan", "inf", "tbptt_nan"])
def test_panic_in_fit_raises_as_jax_does(what):
    plant = np.inf if what == "inf" else np.nan
    _panic(nan=what != "inf", inf=what == "inf")
    conf_fn = _tbptt_conf if what.startswith("tbptt") else _conf
    tbptt = what.startswith("tbptt")
    ours = _fit_error("torch", conf_fn, plant, tbptt)
    theirs = _fit_error("jax", conf_fn, plant, tbptt)
    assert ours == theirs
    label = "params after tBPTT step" if tbptt else "params after step"
    assert ours[0].startswith(f"{'Inf' if what == 'inf' else 'NaN'} detected in {label} at")
    assert ours[1] == 0       # raised inside the first step, before its bookkeeping


def test_step_timer_summary_matches_jax():
    timers = (profiler.StepTimer(), jprofiler.StepTimer())
    assert timers[0].summary() == timers[1].summary()
    for timer in timers:
        for _ in range(3):
            with timer.step():
                pass
    ours, theirs = (t.summary() for t in timers)
    assert set(ours) == set(theirs) == {"compile_s", "steps", "mean_step_s", "min_step_s",
                                        "max_step_s"}
    assert ours["steps"] == theirs["steps"] == 2
    assert ours["compile_s"] is not None and 0 <= ours["min_step_s"] <= ours["max_step_s"]


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def test_metrics_writer_records_match_jax_through_fit(tmp_path):
    jnet = JMultiLayerNetwork(_conf("jax")).init()
    net = load_jax_params(MultiLayerNetwork(_conf("torch"), device="cpu"),
                          _np_tree(jnet.params_), _np_tree(jnet.state_))
    prev = set_registry(MetricsRegistry())
    try:
        for mod, model in (("jax", jnet), ("torch", net)):
            writer = (jmetrics if mod == "jax" else metrics).MetricsWriter(
                str(tmp_path / mod / "run.jsonl"))
            listener = (jmetrics if mod == "jax" else metrics).StatsListener(
                writer, frequency=2, with_norms=True)
            data = _batches(n=5)
            it = (JListDataSetIterator([JDataSet(x, y) for x, y in data]) if mod == "jax"
                  else ListDataSetIterator([DataSet(x, y) for x, y in data]))
            with writer:
                model.fit(it, epochs=2, listeners=[listener])
        written = get_registry().counter("tpudl_obs_records_total").value
    finally:
        set_registry(prev)
    ours, theirs = (_records(tmp_path / m / "run.jsonl") for m in ("torch", "jax"))
    assert written == len(ours) == 5 + 2       # iterations 0, 2, ..., 8 and two epoch ends
    assert [r["event"] for r in ours] == [r["event"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert "grad_norms" not in a and set(a) == set(b)
        for k in a:
            if isinstance(b[k], float):
                tol = 1.0 if k == "epoch_time_s" else SCORE_RTOL * abs(b[k])
                assert abs(a[k] - b[k]) <= tol, k
            else:
                assert a[k] == b[k], k


def test_with_norms_records_gradient_norms_when_dispatched(tmp_path):
    rng = np.random.default_rng(SEED)
    grads = [{"W": rng.normal(size=(4, 6)).astype(np.float32),
              "b": rng.normal(size=6).astype(np.float32)}, {},
             {"W": rng.normal(size=(6, 3)).astype(np.float32)}]
    out = {}
    for mod, convert in (("jax", jnp.asarray), ("torch", torch.as_tensor)):
        m = jmetrics if mod == "jax" else metrics
        path = str(tmp_path / f"{mod}.jsonl")
        with m.MetricsWriter(path) as writer:
            listener = m.StatsListener(writer, with_norms=True)
            tree = jax.tree_util.tree_map(convert, grads) if mod == "jax" \
                else tree_map(convert, grads)
            listener.on_gradient_calculation(None, tree)
            listener.iteration_done(None, 0, 0, 1.5)
            listener.iteration_done(None, 1, 0, 1.25)     # the norms went with the first
        out[mod] = _records(path)
    assert list(out["torch"][0]["grad_norms"]) == list(out["jax"][0]["grad_norms"]) == \
        ["0/W", "0/b", "2/W"]
    assert list(param_table(tree_map(torch.as_tensor, grads))) == list(jparam_table(grads))
    for k, v in out["jax"][0]["grad_norms"].items():
        assert out["torch"][0]["grad_norms"][k] == pytest.approx(v, rel=1e-6)
    assert "grad_norms" not in out["torch"][1] and "grad_norms" not in out["jax"][1]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiler.trace(str(tmp_path)) as traced:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert os.path.dirname(traced.path) == str(tmp_path)
    events = json.loads(open(traced.path).read())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert traced.profile.key_averages()


def test_profiling_fit_writes_a_trace_into_trace_dir(tmp_path):
    net = MultiLayerNetwork(_conf("torch"), device="cpu").init()
    config.set_config(profiling=True, trace_dir=str(tmp_path / "traces"))
    try:
        net.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches()]), epochs=1)
    finally:
        config.set_config(trace_dir="traces")
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(
        open(tmp_path / "traces" / files[0]).read())["traceEvents"]}
    assert "aten::addmm" in names or "aten::mm" in names


def test_enable_debug_nans_traps_a_nan_in_the_backward():
    profiler.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        profiler.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
