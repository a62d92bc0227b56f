"""Transfer learning, frozen layers and per-layer updaters in the port
(``nn/transfer.py``, ``train.trainer.net_optimizer``) against the JAX
package on the CPU.

- ``examples/transfer_learning.py``'s flow (LeNet pretrained, a new
  5-class head, the layers up to the second pool frozen, fine-tuned with
  Adam) in both packages from the same weights, the head on an AdamW of
  its own: the fine-tune's losses within 1e-5 a step, the frozen params
  bit-unchanged, the per-layer updater state against
  ``optax.multi_transform``'s leaf for leaf;
- a small graph of a frozen and a trained ``FusedBottleneck`` (8 channels
  at 8x8): the frozen block's params bit-unchanged while its BN running
  statistics move, as the reference's do (``frozen`` only masks updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.transfer import FineTuneConfiguration as JFineTuneConfiguration
from deeplearning4j_tpu.nn.transfer import TransferLearning as JTransferLearning
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import OutputLayer
from deeplearning4j_tpu_torch.nn.transfer import FineTuneConfiguration, TransferLearning
from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.train import Adam, AdamW, Trainer

LOSS_RTOL = 1e-5
STATE_TOL = 1e-5      # of a state leaf's largest entry
STATS_TOL = 1e-5      # BN running statistics, of their largest entry
FROZEN_UNTIL = 3      # conv, pool, conv, pool


def _batches(n, classes, seed, batch=16):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    ys = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return [(xs[i:i + batch], ys[i:i + batch]) for i in range(0, n, batch)]


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))


def _np(tree):
    return [{k: np.asarray(v) for k, v in d.items()} for d in tree]


@pytest.fixture(scope="module")
def jax_flow():
    """The JAX package's flow: pretrain, surgery, fine-tune (its head on
    AdamW)."""
    base = jzoo.lenet(num_classes=10).init()
    base.fit(JListDataSetIterator([JDataSet(x, y) for x, y in _batches(32, 10, seed=0)]),
             epochs=1)
    new = (JTransferLearning.builder(base)
           .fine_tune_configuration(JFineTuneConfiguration(updater=jupd.Adam(1e-3)))
           .set_feature_extractor(FROZEN_UNTIL)
           .remove_output_layer()
           .add_layer(jlayers.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
           .build())
    new.layers[-1].updater = jupd.AdamW(2e-3, weight_decay=0.05)
    out = {"base_p": _np(base.params_), "base_s": _np(base.state_),
           "p0": _np(new.params_), "s0": _np(new.state_), "conf": new.conf.to_json()}
    scores = _Scores()
    new.fit(JListDataSetIterator([JDataSet(x, y) for x, y in _batches(64, 5, seed=1)]),
            epochs=1, listeners=[scores])
    out.update(losses=scores.scores, p_end=_np(new.params_),
               opt_leaves=[np.asarray(v) for v in jax.tree_util.tree_leaves(new.opt_state)])
    return out


def _port_flow(jax_flow):
    base = load_jax_params(lenet(num_classes=10, device="cpu"), jax_flow["base_p"],
                           jax_flow["base_s"])
    new = (TransferLearning.builder(base)
           .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-3)))
           .set_feature_extractor(FROZEN_UNTIL)
           .remove_output_layer()
           .add_layer(OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
           .build())
    new.layers[-1].updater = AdamW(2e-3, weight_decay=0.05)
    return base, new


def test_surgery_copies_the_kept_layers_and_builds_the_reference_config(jax_flow):
    base, new = _port_flow(jax_flow)
    assert new.conf.to_json() == jax_flow["conf"]
    assert [layer.frozen for layer in new.layers] == [True] * 4 + [False] * 2
    for i in range(5):          # the kept layers: copies of the base's, not aliases
        for k, v in new.params_[i].items():
            np.testing.assert_array_equal(v.numpy(), jax_flow["p0"][i][k])
            assert v.data_ptr() != base.params_[i][k].data_ptr()


def test_lenet_transfer_flow_matches_jax(jax_flow):
    _, new = _port_flow(jax_flow)
    load_jax_params(new, jax_flow["p0"], jax_flow["s0"])     # the new head's draw
    scores = CollectScoresListener()
    new.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches(64, 5, seed=1)]),
            epochs=1, listeners=[scores])
    np.testing.assert_allclose(scores.scores, jax_flow["losses"], rtol=LOSS_RTOL)
    for i in range(FROZEN_UNTIL + 1):
        for k, v in new.params_[i].items():
            np.testing.assert_array_equal(v.numpy(), jax_flow["p0"][i][k])
    trainer = Trainer(new)
    assert sorted(new.opt_state) == ["_default", "layer_5"] and trainer._cache_sig is None
    got = trainer.tx.state_leaves(new.opt_state)
    want = jax_flow["opt_leaves"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        scale = np.abs(w).max() if w.size else 0.0
        assert np.abs(g.numpy() - w).max() <= STATE_TOL * (scale if scale else 1.0), i


def test_nout_replace_and_remove_layers_rebuild_the_following_layer():
    base = lenet(num_classes=10, device="cpu").init()
    net = (TransferLearning.builder(base).nout_replace(4, 64).remove_layers_from_output(1)
           .add_layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent")).build())
    assert tuple(net.params_[4]["W"].shape) == (7 * 7 * 50, 64)
    assert tuple(net.params_[5]["W"].shape) == (64, 3)
    torch.testing.assert_close(net.params_[2]["W"], base.params_[2]["W"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="cannot remove"):
        TransferLearning.builder(base).remove_layers_from_output(7)


def _graph_conf():
    g = (JNeuralNetConfiguration.builder().seed(4).updater(jupd.Nesterovs(0.01, 0.9))
         .weight_init("relu").graph().add_inputs("in")
         .set_input_types(JInputType.convolutional(8, 8, 8)))
    g.add_layer("frozen_block", jlayers.FusedBottleneck(filters=(4, 4, 8)), "in")
    g.add_layer("trained_block", jlayers.FusedBottleneck(filters=(4, 4, 8)), "frozen_block")
    g.add_layer("pool", jlayers.GlobalPoolingLayer(pooling_type="avg"), "trained_block")
    g.add_layer("out", jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                "pool")
    g.set_outputs("out")
    conf = g.build()
    conf.vertices[0].obj.frozen = True
    return conf


def test_frozen_fused_bottleneck_moves_its_bn_statistics_as_the_reference():
    rng = np.random.default_rng(8)
    batches = [(rng.normal(size=(4, 8, 8, 8)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]) for _ in range(2)]
    jconf = _graph_conf()
    jnet = JComputationGraph(jconf).init()
    p0 = {v: {k: np.asarray(a) for k, a in d.items()} for v, d in jnet.params_.items()}
    s0 = {v: {k: np.asarray(a) for k, a in d.items()} for v, d in jnet.state_.items()}
    jtrainer = JTrainer(jnet)
    for x, y in batches:
        jtrainer.fit_batch(JDataSet(jnp.asarray(x), jnp.asarray(y)), jax.random.key(0))
    net = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                           device="cpu")
    load_jax_params(net, p0, s0)
    trainer = Trainer(net)
    assert trainer.tx.frozen["frozen_block"] and not trainer.tx.frozen["trained_block"]
    for x, y in batches:
        trainer.fit_batch(DataSet(x, y))
    for k, v in net.params_["frozen_block"].items():
        np.testing.assert_array_equal(v.numpy(), p0["frozen_block"][k])
    moved = 0
    for k, v in net.state_["frozen_block"].items():
        want = np.asarray(jnet.state_["frozen_block"][k])
        moved += int(not np.array_equal(want, s0["frozen_block"][k]))
        assert np.abs(v.numpy() - want).max() <= STATS_TOL * np.abs(want).max(), k
    assert moved == len(s0["frozen_block"])
    changed = [k for k, v in net.params_["trained_block"].items()
               if not np.array_equal(v.numpy(), p0["trained_block"][k])]
    assert sorted(changed) == sorted(p0["trained_block"])
