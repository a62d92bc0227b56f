"""The port's training telemetry held to the JAX package's: the registry
series, spans, flight-recorder events and fault sites of ``Trainer``,
the feeder, the step cache and the checkpoint writers.

- The verify recipe: MLP-MNIST (784-256-10, Adam 1e-3) on 6000 synthetic
  examples at batch 128 (a ragged tail of 112, padded by the feeder),
  ``fit`` for 2 epochs and then again for 1, each package from the same
  weights (``interop.load_jax_params``), each under a tracer of its own
  and a fresh registry.  After each ``fit`` every ``tpudl_train_*`` and
  ``tpudl_data_*`` count is the JAX package's: one recompile, 12000 real
  examples after the first, step-cache hits and misses over both.
- The ``fit``, ``epoch``, ``step`` and ``feed`` spans: the same number,
  nesting and attributes; the scores of the first steps within 1e-5
  relative, every score finite.
- Checkpoints: writes counted, a truncated newest zip counted corrupt and
  skipped, a resume counted with its iteration and a ``resume`` flight
  record.
- Fault plans on ``trainer.step`` (``nan``, ``error``), ``feeder.stage``
  (a retried ``error``, a ``crash``) and ``checkpoint.write`` (``crash``,
  ``truncate``) fire where and when they fire in the JAX package.
- ``trainer.step@3:nan`` is caught by a ``HealthMonitor`` as
  ``non_finite_loss`` in the same step, with a flight dump named for it
  (the JAX package's ``tests/test_health_monitor.py``).
"""

import math
import os
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import datasets as jdatasets
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.io.checkpoint import CheckpointListener as JCheckpointListener
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import flight_recorder as jflight
from deeplearning4j_tpu.obs import registry as jregistry
from deeplearning4j_tpu.obs import tracing as jtracing
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.resilience.checkpoint import verify_checkpoint as jverify
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train import step_cache as jstep_cache
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator, datasets
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import flight_recorder, registry, tracing
from deeplearning4j_tpu_torch.obs.health import HealthMonitor
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.checkpoint import verify_checkpoint
from deeplearning4j_tpu_torch.train import Adam, Sgd, Trainer, step_cache

SEED = 20261018
SCORE_RTOL = 1e-5
COMPARED_SCORES = 5       # steps whose scores are held to JAX's
RECIPE = {"batch_size": 128, "train": True, "n_synthetic": 6000}
SERIES = ("tpudl_train_recompiles_total", "tpudl_train_examples_total",
          "tpudl_train_steps_total", "tpudl_train_epochs_total",
          "tpudl_train_step_cache_hits_total", "tpudl_train_step_cache_misses_total",
          "tpudl_train_step_seconds", "tpudl_train_epoch_seconds",
          "tpudl_data_etl_wait_seconds", "tpudl_data_prefetch_depth")

JAX = types.SimpleNamespace(
    name="jax", registry=jregistry, tracing=jtracing, flight=jflight, faults=jfaults,
    step_cache=jstep_cache, Checkpoints=JCheckpointListener, Trainer=JTrainer,
    DataSet=JDataSet, ListIterator=JListDataSetIterator, mnist=jdatasets.mnist,
    verify=jverify)
PORT = types.SimpleNamespace(
    name="torch", registry=registry, tracing=tracing, flight=flight_recorder, faults=faults,
    step_cache=step_cache, Checkpoints=CheckpointListener, Trainer=Trainer,
    DataSet=DataSet, ListIterator=ListDataSetIterator, mnist=datasets.mnist,
    verify=verify_checkpoint)


def _np_tree(tree):
    return [{k: np.array(v) for k, v in d.items()} for d in tree]


def _conf(pkg, n_in, hidden, n_out, updater, activation="relu"):
    jax_side = pkg is JAX
    nn = JNeuralNetConfiguration if jax_side else NeuralNetConfiguration
    ly = jlayers if jax_side else layers
    it = JInputType if jax_side else InputType
    return (nn.builder().seed(42).updater(updater).list()
            .layer(ly.DenseLayer(n_out=hidden, activation=activation))
            .layer(ly.OutputLayer(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(n_in)).build())


def _pair(n_in, hidden, n_out, lr, adam=True, activation="relu"):
    """The JAX net and the port's net with its weights."""
    jnet = JMultiLayerNetwork(_conf(JAX, n_in, hidden, n_out, (JAdam if adam else JSgd)(lr),
                                    activation)).init()
    net = MultiLayerNetwork(_conf(PORT, n_in, hidden, n_out, (Adam if adam else Sgd)(lr),
                                  activation), device="cpu")
    return jnet, load_jax_params(net, _np_tree(jnet.params_), _np_tree(jnet.state_))


def _value(metric):
    return metric.count if hasattr(metric, "count") and not hasattr(metric, "value") \
        else metric.value


def _series(pkg) -> dict:
    reg = pkg.registry.get_registry()
    return {name: _value(reg.get(name)) for name in SERIES if reg.get(name) is not None}


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))


def _isolated(pkg):
    """A fresh registry, an empty step cache and flight ring, no fault plan."""
    prev = pkg.registry.set_registry(pkg.registry.MetricsRegistry())
    pkg.step_cache.clear_step_cache()
    pkg.flight.get_recorder().clear()
    return prev


@pytest.fixture(scope="module")
def recipe():
    """Both packages through the verify recipe: fit 2 epochs, then 1."""
    jnet, net = _pair(784, 256, 10, 1e-3)
    out = {}
    for pkg, model in ((JAX, jnet), (PORT, net)):
        prev = _isolated(pkg)
        tracer = pkg.tracing.Tracer(enabled=True)
        scores = _Scores()
        try:
            with pkg.tracing.use_tracer(tracer):
                model.fit(pkg.mnist(**RECIPE), epochs=2, listeners=[scores])
                first = _series(pkg)
                model.fit(pkg.mnist(**RECIPE), epochs=1, listeners=[scores])
                second = _series(pkg)
        finally:
            pkg.registry.set_registry(prev)
        out[pkg.name] = {"first": first, "second": second, "tracer": tracer,
                         "scores": scores.scores, "params": model.num_params()}
    return out


def test_recipe_counts_match_jax(recipe):
    ours, theirs = recipe["torch"], recipe["jax"]
    assert ours["first"]["tpudl_train_recompiles_total"] == 1
    assert ours["first"]["tpudl_train_examples_total"] == 12000
    assert ours["first"]["tpudl_train_steps_total"] == 94
    assert ours["second"]["tpudl_train_step_cache_hits_total"] == 1
    assert ours["second"]["tpudl_train_step_cache_misses_total"] == 1
    assert set(ours["second"]) == set(SERIES)
    for when in ("first", "second"):
        assert set(ours[when]) == set(theirs[when]), when
        assert ours[when] == theirs[when] | {
            k: ours[when][k] for k in ("tpudl_data_prefetch_depth",)}, when
        # the feeder's depth gauge reads a race; it is one of the queue's sizes
        assert 0 <= ours[when]["tpudl_data_prefetch_depth"] <= 2


def _spans(tracer, name):
    return tracer.find(name)


def test_recipe_spans_match_jax(recipe):
    ours, theirs = recipe["torch"]["tracer"], recipe["jax"]["tracer"]
    counts = {n: len(_spans(ours, n)) for n in ("fit", "epoch", "step", "feed")}
    assert counts == {n: len(_spans(theirs, n)) for n in counts}
    assert counts == {"fit": 2, "epoch": 3, "step": 141, "feed": 141}
    for tracer in (ours, theirs):
        by_id = {s.span_id: s for s in tracer.spans}
        for child, parent in (("epoch", "fit"), ("step", "epoch"), ("feed", "epoch")):
            assert all(by_id[s.parent_id].name == parent for s in _spans(tracer, child))
    for name in ("fit", "epoch", "step", "feed"):
        for a, b in zip(_spans(ours, name), _spans(theirs, name), strict=True):
            volatile = {"score", "wait_ms", "hbm_bytes_in_use"}
            assert set(a.attributes) - {"hbm_bytes_in_use"} == \
                set(b.attributes) - {"hbm_bytes_in_use"}, name
            assert {k: v for k, v in a.attributes.items() if k not in volatile} == \
                {k: v for k, v in b.attributes.items() if k not in volatile}, name
    steps = _spans(ours, "step")
    assert steps[0].attributes["compile"] is True and "compile" not in steps[1].attributes
    assert [s.attributes.get("padded") for s in _spans(ours, "feed")].count(16) == 3
    assert all(math.isfinite(s.attributes["score"]) for s in steps)
    assert _spans(ours, "fit")[0].attributes["params"] == recipe["torch"]["params"] == 203530
    got, want = recipe["torch"]["scores"], recipe["jax"]["scores"]
    assert len(got) == len(want) == 141
    for g, w in zip(got[:COMPARED_SCORES], want[:COMPARED_SCORES]):
        assert abs(g - w) <= SCORE_RTOL * abs(w)
    assert [s.attributes["score"] for s in steps] == pytest.approx(got, rel=1e-6)


# ------------------------------------------------------- checkpoints
def _small_batches(n=4, seed=0, size=16):
    rng = np.random.default_rng(SEED + seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(size, 4)).astype(np.float32)
        out.append((x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, size)]))
    return out


def _checkpoint_run(pkg, model, directory):
    prev = _isolated(pkg)
    try:
        ckpt = pkg.Checkpoints(str(directory), save_every_n_epochs=1, keep_last=3)
        model.fit(pkg.ListIterator([pkg.DataSet(x, y) for x, y in _small_batches()]), epochs=4,
                  listeners=[ckpt])
        reg = pkg.registry.get_registry()
        writes = (reg.counter("tpudl_resilience_checkpoint_writes_total").value,
                  reg.histogram("tpudl_resilience_checkpoint_write_seconds").count)
        newest = pkg.Checkpoints.last_checkpoint_in(str(directory))
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) - 300)
        fallback = pkg.Checkpoints.last_checkpoint_in(str(directory))
        corrupt = reg.counter("tpudl_resilience_corrupt_checkpoints_total").value
        trainer = pkg.Trainer(model)
        state = trainer.resume_state(str(directory))
        resumed = [e for e in pkg.flight.get_recorder().events() if e.get("kind") == "resume"]
        return {"writes": writes, "newest": os.path.basename(newest),
                "fallback": os.path.basename(fallback), "corrupt": corrupt,
                "resumes": reg.counter("tpudl_resilience_resumes_total").value,
                "resumed_iteration": reg.gauge("tpudl_resilience_resumed_iteration").value,
                "state_iteration": int(state["iteration"]),
                "resume_event": {k: resumed[-1][k] for k in ("iteration", "epoch", "checkpoint")}}
    finally:
        pkg.registry.set_registry(prev)


def test_checkpoint_and_resume_counters_match_jax(tmp_path):
    jnet, net = _pair(4, 8, 3, 0.1, adam=False)
    theirs = _checkpoint_run(JAX, jnet, tmp_path / "jax")
    ours = _checkpoint_run(PORT, net, tmp_path / "torch")
    assert ours == theirs
    assert ours["writes"] == (4, 4) and ours["corrupt"] == 1 and ours["resumes"] == 1
    assert ours["resumed_iteration"] == ours["state_iteration"] == 12
    assert ours["fallback"] != ours["newest"] and ours["resume_event"]["checkpoint"] == \
        ours["fallback"]


# ---------------------------------------------------------- fault plans
def _fault_run(pkg, model, spec, directory):
    """``fit`` over 5 batches under ``spec`` with a checkpoint a step: what
    raised, the iteration reached, the scores, the zips published and
    which of them verify, and the retry counters."""
    prev = _isolated(pkg)
    scores = _Scores()
    raised = None
    try:
        ckpt = pkg.Checkpoints(str(directory), save_every_n_iterations=1, keep_all=True)
        with pkg.faults.inject(spec):
            try:
                model.fit(pkg.ListIterator([pkg.DataSet(x, y)
                                            for x, y in _small_batches(n=5, seed=1)]),
                          epochs=1, listeners=[scores, ckpt])
            except Exception as e:   # the outcome under comparison
                raised = type(e).__name__
        reg = pkg.registry.get_registry()
        zips = sorted(p for p in os.listdir(directory) if p.endswith(".zip"))
        return {"raised": raised, "iteration": model.iteration,
                "nan_at": [i for i, s in enumerate(scores.scores) if math.isnan(s)],
                "steps_reported": len(scores.scores), "zips": zips,
                "intact": [z for z in zips if not pkg.verify(os.path.join(directory, z))],
                "retries": reg.counter("tpudl_resilience_retries_total").value,
                "giveups": reg.counter("tpudl_resilience_giveups_total").value}
    finally:
        pkg.registry.set_registry(prev)


FAULTS = {
    "trainer.step@2:nan": dict(raised=None, nan_at=[2], steps_reported=5),
    "trainer.step@1:error": dict(raised="InjectedFault", iteration=1),
    "feeder.stage@1:error": dict(raised=None, retries=1, steps_reported=5),
    "feeder.stage@2:crash": dict(raised="InjectedCrash", iteration=2),
    # a checkpoint listener saves after the step it is told of, from the
    # second step on: the second write is at iteration 2
    "checkpoint.write@1:crash": dict(raised="InjectedCrash", iteration=2),
    "checkpoint.write@1:truncate:300": dict(raised=None, steps_reported=5),
}


@pytest.mark.parametrize("spec", sorted(FAULTS))
def test_fault_plans_fire_alike(spec, tmp_path):
    jnet, net = _pair(4, 8, 3, 0.1, adam=False)
    theirs = _fault_run(JAX, jnet, spec, tmp_path / "jax")
    ours = _fault_run(PORT, net, spec, tmp_path / "torch")
    assert ours == theirs
    for key, want in FAULTS[spec].items():
        assert ours[key] == want, key
    if spec.endswith("truncate:300"):
        assert len(ours["zips"]) == 4 and len(ours["intact"]) == 3
        assert "checkpoint_iter2_epoch0.zip" not in ours["intact"]


def test_injected_nan_is_caught_by_the_health_monitor_in_the_same_step(tmp_path):
    """The port's counterpart of the JAX package's
    ``TestNaNDetection.test_injected_nan_detected_within_one_step``."""
    prev = _isolated(PORT)
    try:
        dump = str(tmp_path / "health_box.jsonl")
        monitor = HealthMonitor(actions=("warn", "dump"), dump_path=dump)
        _, net = _pair(4, 8, 3, 0.1, adam=False, activation="tanh")
        trainer = Trainer(net, listeners=[monitor])
        x, y = _small_batches(n=1, size=16)[0]
        batch = DataSet(x, y)
        with faults.inject("trainer.step@3:nan"):
            for i in range(6):
                loss = trainer.step_batch(batch, torch.Generator().manual_seed(i))
                if i < 3:
                    assert not monitor.anomalies
                if i == 3:
                    assert monitor.anomalies, "NaN not caught in the step"
                    assert torch.isnan(loss) and loss.device == net.device
        assert monitor.anomalies[0]["kind"] == "non_finite_loss"
        assert monitor.anomalies[0]["iteration"] == 3
        anomalies = registry.get_registry().labeled_counter(
            "tpudl_health_anomalies_total", label_names=("kind",))
        assert anomalies.labeled_value(kind="non_finite_loss") >= 1
        lines = flight_recorder.read_dump(dump)
        header = next(line for line in lines if line["type"] == "header")
        assert header["reason"] == "health:non_finite_loss"
        assert header["detail"]["kind"] == "non_finite_loss"
        assert header["detail"]["iteration"] == 3
        assert any(line["type"] == "thread" for line in lines)
        steps = [e for e in flight_recorder.get_recorder().events() if e.get("kind") == "step"]
        assert [e["iteration"] for e in steps] == list(range(6))
        # iteration 0 runs the statistics step (the monitor samples every
        # 10th), iteration 1 the plain step: each sees its first signature
        assert [e["compile"] for e in steps] == [True, True] + [False] * 4
    finally:
        registry.set_registry(prev)
