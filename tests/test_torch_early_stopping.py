"""Early stopping, the model savers, MultiDataSet and the iterators of the
port (``train/early_stopping.py``, ``data/dataset.py``,
``data/iterators.py``) against the JAX package on the CPU.

- ``examples/early_stopping.py``'s flow in both packages from the same
  weights: the same termination reason, ``total_epochs`` and
  ``best_model_epoch``, and ``score_vs_epoch`` within 1e-5;
- the iteration termination conditions, each stopping the run in its
  first epoch;
- ``LocalFileModelSaver``'s round trip (and its refusal of a damaged
  zip), ``InMemoryModelSaver``'s copies;
- ``MultiDataSet``, ``DataSet.shuffle``/``split_test_and_train`` and the
  four iterators (``ResumableIterator`` across a restore,
  ``GeneratorDataSetIterator``, ``AsyncDataSetIterator``,
  ``EarlyTerminationIterator``) against the reference's batch order.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jdataset
from deeplearning4j_tpu.data import iterators as jiterators
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.train import early_stopping as jes
from deeplearning4j_tpu.train import updaters as jupd

from deeplearning4j_tpu_torch.data import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSet, EarlyTerminationIterator,
    GeneratorDataSetIterator, ListDataSetIterator, MultiDataSet, ResumableIterator)
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointCorruptError
from deeplearning4j_tpu_torch.train import Adam, Trainer
from deeplearning4j_tpu_torch.train import early_stopping as es

SCORE_TOL = 1e-5
MAX_EPOCHS, PATIENCE = 20, 3     # the example's defaults


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[np.argmax(x @ w, -1)]


def _jax_iter(n, seed, batch=32):
    x, y = _arrays(n, seed)
    return jiterators.ListDataSetIterator([jdataset.DataSet(x[i:i + batch], y[i:i + batch])
                                           for i in range(0, n, batch)])


def _iter(n, seed, batch=32):
    x, y = _arrays(n, seed)
    return ListDataSetIterator([DataSet(x[i:i + batch], y[i:i + batch])
                                for i in range(0, n, batch)])


def _jax_conf():
    return (JNeuralNetConfiguration.builder().seed(0).updater(jupd.Adam(5e-3)).list()
            .layer(jlayers.DenseLayer(n_out=32, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(10)).build())


@pytest.fixture(scope="module")
def jax_result():
    jnet = JMultiLayerNetwork(_jax_conf()).init()
    p0 = [{k: np.asarray(v) for k, v in d.items()} for d in jnet.params_]
    conf = jes.EarlyStoppingConfiguration(
        score_calculator=jes.DataSetLossCalculator(_jax_iter(96, seed=1)),
        epoch_termination_conditions=[jes.MaxEpochsTerminationCondition(MAX_EPOCHS),
                                      jes.ScoreImprovementEpochTerminationCondition(PATIENCE)])
    return p0, jes.EarlyStoppingTrainer(conf, jnet, _jax_iter(256, seed=0)).fit()


def _port_net(p0=None):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_jax_conf().to_json()),
                            device="cpu")
    return load_jax_params(net, p0, [{}, {}]) if p0 is not None else net.init()


def test_early_stopping_flow_matches_jax(jax_result):
    p0, want = jax_result
    net = _port_net(p0)
    conf = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(_iter(96, seed=1)),
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(MAX_EPOCHS),
                                      es.ScoreImprovementEpochTerminationCondition(PATIENCE)])
    got = es.EarlyStoppingTrainer(conf, net, _iter(256, seed=0)).fit()
    print(f"stopped at epoch {got.total_epochs} (best {got.best_model_epoch}): "
          f"{got.termination_details}; JAX {want.total_epochs} ({want.best_model_epoch})")
    assert got.termination_reason == want.termination_reason
    assert got.termination_details == want.termination_details
    assert (got.total_epochs, got.best_model_epoch) == (want.total_epochs, want.best_model_epoch)
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    for epoch, score in want.score_vs_epoch.items():
        assert abs(got.score_vs_epoch[epoch] - score) <= SCORE_TOL * abs(score), epoch
    assert math.isclose(got.best_model_score, want.best_model_score, rel_tol=SCORE_TOL)
    assert net.epoch == got.total_epochs and net.iteration == 8 * got.total_epochs
    best = got.best_model      # the in-memory saver's copy of the best epoch
    assert best is not net and best.params_[0]["W"].data_ptr() != net.params_[0]["W"].data_ptr()


class _NaNBatches(ListDataSetIterator):
    """Batches whose features turn NaN from the third on."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            yield batch if i < 2 else DataSet(np.full_like(batch.features, np.nan), batch.labels)


@pytest.mark.parametrize("condition,iterator,stops_after", [
    (es.MaxScoreIterationTerminationCondition(1e-3), None, 1),
    (es.InvalidScoreIterationTerminationCondition(), "nan", 3),
    (es.MaxTimeIterationTerminationCondition(0.0), None, 1),
], ids=["max_score", "invalid_score", "max_time"])
def test_iteration_conditions_stop_in_the_first_epoch(condition, iterator, stops_after):
    net = _port_net()
    train = _iter(256, seed=0)
    if iterator == "nan":
        train = _NaNBatches(train.datasets)
    conf = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(_iter(96, seed=1)),
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(MAX_EPOCHS)],
        iteration_termination_conditions=[condition])
    result = es.EarlyStoppingTrainer(conf, net, train).fit()
    assert result.termination_reason == "IterationTerminationCondition"
    assert result.termination_details == repr(condition)
    assert result.total_epochs == 1 and result.best_model_epoch == -1
    assert net.iteration == stops_after
    with pytest.raises(ValueError, match="termination condition"):
        es.EarlyStoppingTrainer(es.EarlyStoppingConfiguration(conf.score_calculator), net,
                                train).fit()


def test_local_file_model_saver_round_trip(tmp_path):
    net = _port_net()
    Trainer(net).fit(_iter(64, seed=0))
    saver = es.LocalFileModelSaver(str(tmp_path / "models"))
    assert saver.get_best_model() is None
    saver.save_best_model(net, 0.5)
    saver.save_latest_model(net, 0.6)
    for back in (saver.get_best_model(), saver.get_latest_model()):
        assert type(back) is MultiLayerNetwork and back.device == net.device
        x = _arrays(8, seed=5)[0]
        assert torch.equal(back.output(x), net.output(x))
        assert back.iteration == net.iteration == 2
    with open(saver.best_path, "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 16)
    with pytest.raises(CheckpointCorruptError):
        saver.get_best_model()


def test_classification_and_regression_scores_follow_the_reference_sense():
    net = _port_net()
    calc = es.ClassificationScoreCalculator(_iter(96, seed=1))
    assert not calc.minimize_score() and 0.0 <= calc.calculate_score(net) <= 1.0
    reg = es.RegressionScoreCalculator(_iter(96, seed=1), "rmse")
    assert reg.minimize_score() and reg.calculate_score(net) > 0


def _batch_list(it) -> list:
    return [np.asarray(b.features) for b in it]


def test_dataset_helpers_match_the_reference():
    x, y = _arrays(10, seed=2)
    ours, ref = DataSet(x, y), jdataset.DataSet(x, y)
    for a, b in zip(ours.shuffle(seed=4)._fields(), (ref.shuffle(seed=4).features,
                                                    ref.shuffle(seed=4).labels, None, None)):
        assert (a is None and b is None) or np.array_equal(a, b)
    for got, want in zip(ours.split_test_and_train(7), ref.split_test_and_train(7)):
        assert np.array_equal(got.features, want.features)
        assert np.array_equal(got.labels, want.labels)
    multi = MultiDataSet([x, x[:, :4]], [y])
    assert multi.num_examples() == jdataset.MultiDataSet([x, x[:, :4]], [y]).num_examples() == 10


def test_resumable_iterator_matches_the_reference_across_a_restore():
    x, y = _arrays(50, seed=3)
    runs = []
    for resumable, array_iter in ((ResumableIterator, ArrayDataSetIterator),
                                  (jiterators.ResumableIterator,
                                   jiterators.ArrayDataSetIterator)):
        it = resumable(array_iter(x, y, 8, shuffle=True, seed=7))
        seen = []
        for _ in range(2):
            it.reset()
            seen += _batch_list(it)
        state = {"epoch": 1, "batch_index": 3}
        again = resumable(array_iter(x, y, 8, shuffle=True, seed=7))
        again.set_state(state)
        again.reset()                 # a reset before the first pass keeps the position
        seen += _batch_list(again)
        assert again.state() == {"epoch": 1, "batch_index": 7}
        runs.append(seen)
    assert len(runs[0]) == len(runs[1]) == 18
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][-4:], runs[0][10:14]))


def test_generator_async_and_early_termination_iterators_match_the_reference():
    x, y = _arrays(40, seed=6)
    batches = [DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 40, 8)]
    jbatches = [jdataset.DataSet(b.features, b.labels) for b in batches]
    pairs = [
        (GeneratorDataSetIterator(lambda: iter(batches)),
         jiterators.GeneratorDataSetIterator(lambda: iter(jbatches))),
        (AsyncDataSetIterator(ListDataSetIterator(batches), queue_size=2),
         jiterators.AsyncDataSetIterator(jiterators.ListDataSetIterator(jbatches), 2)),
        (EarlyTerminationIterator(ListDataSetIterator(batches), 3),
         jiterators.EarlyTerminationIterator(jiterators.ListDataSetIterator(jbatches), 3)),
    ]
    for ours, ref in pairs:
        for _ in range(2):          # each pass starts again
            ours.reset()
            ref.reset()
            got, want = _batch_list(ours), _batch_list(ref)
            assert len(got) == len(want) and all(np.array_equal(a, b)
                                                 for a, b in zip(got, want))


def test_graph_trains_on_a_multidataset():
    g = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2)).graph()
         .add_inputs("a", "b")
         .set_input_types(InputType.feed_forward(6), InputType.feed_forward(4)))
    g.add_layer("da", DenseLayer(n_out=5, activation="relu"), "a")
    g.add_layer("db", DenseLayer(n_out=5, activation="relu"), "b")
    g.add_vertex("sum", ElementWiseVertex(op="add"), "da", "db")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "sum")
    g.set_outputs("out")
    net = ComputationGraph(g.build(), device="cpu").init()
    rng = np.random.default_rng(0)
    data = [MultiDataSet([rng.normal(size=(8, 6)).astype(np.float32),
                          rng.normal(size=(8, 4)).astype(np.float32)],
                         [np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]])
            for _ in range(4)]
    net.fit(ListDataSetIterator(data), epochs=3)
    assert net.iteration == 12 and np.isfinite(net.score())
