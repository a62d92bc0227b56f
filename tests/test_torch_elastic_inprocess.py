"""The port's in-process resize (``Trainer.request_resize`` /
``Trainer.resize_mesh`` at ``fit``'s epoch boundaries, layouts narrower
than the gang) held to the JAX package's (``tests/test_elastic.py``).

The port runs one gang of four gloo processes on the CPU
(``tests/torch_cluster_workers.py::inprocess_elastic_worker``, started
first so that its ranks start while the JAX package makes the weights);
the JAX package runs the same fits on four of the conftest's eight CPU
devices.  Cases and tolerances:

- dp2 grown to dp4, and dp4 shrunk to dp2, at the boundary after epoch 2
  of one 4-epoch fit with dropout active: per-step losses and final params
  within 1e-6 of the port's own fixed-width run (the reference's
  contract, on the port's own dropout stream), and, with both packages'
  draws patched to the same global-batch masks, within
  ``tests/test_torch_data_parallel.py``'s 1e-6 of the JAX package's
  resize run;
- the ``tpudl_elastic_*`` series and the ``elastic_resize`` flight event
  equal to the reference's;
- ``gang.grow@0:crash`` fired on rank 0 leaves every rank on dp2, placed
  and trainable, and the same grow lands after it;
- a width past the gang's four processes raises at the call, naming
  ``ClusterSupervisor.request_resize``; a trainer without a layout raises
  the reference's ``ValueError``.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import flight_recorder as jflight
from deeplearning4j_tpu.obs.registry import MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.obs.registry import set_registry as jset_registry
from deeplearning4j_tpu.parallel.mesh import LayoutResizeError as JLayoutResizeError
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.step_cache import clear_step_cache
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 16511
EXACT = 1e-6      # the reference's contract, and tests/test_torch_data_parallel.py's


def _conf():
    # tests/test_elastic.py's _mlp
    return (JConf.builder().seed(11).updater(JSgd(0.1)).weight_init("xavier").list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu", dropout=0.8))
            .layer(jlayers.DenseLayer(n_out=16, activation="tanh", dropout=0.8))
            .layer(jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _spec():
    rng = np.random.default_rng(0)
    # tests/test_elastic.py's _data
    x = rng.normal(size=(32, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.argmax(x @ w, -1)]
    net = JMultiLayerNetwork(_conf()).init()
    masks = {(16, 8): rng.random((16, 8)) < 0.8, (16, 16): rng.random((16, 16)) < 0.8}
    return {"mlp": {"conf": _conf().to_json(), "p0": _np_tree(net.params_),
                    "s0": _np_tree(net.state_)},
            "x": x, "y": y, "masks": masks}


def _jax_run(spec, start, resize_to=None, boundary=2, epochs=4):
    """tests/test_elastic.py's _elastic_run from the spec's weights, every
    dropout draw the spec's mask of its shape."""
    net = JMultiLayerNetwork(_conf()).init()
    net.params_ = jax.tree_util.tree_map(jnp.asarray, spec["mlp"]["p0"])
    net.state_ = jax.tree_util.tree_map(jnp.asarray, spec["mlp"]["s0"])
    trainer = JTrainer(net, layout=start)
    losses = []

    class Rec:
        def iteration_done(self, net, it, ep, loss):
            losses.append(float(loss))

        def on_epoch_end(self, net, epoch, info):
            if resize_to is not None and epoch + 1 == boundary:
                trainer.request_resize(resize_to)

    trainer.bus.listeners.append(Rec())
    reg = JMetricsRegistry()
    prev = jset_registry(reg)
    try:
        trainer.fit(ArrayDataSetIterator(spec["x"], spec["y"], 16, shuffle=False), epochs=epochs)
    finally:
        jset_registry(prev)
    series = {"grows": reg.counter("tpudl_elastic_grows_total").value,
              "shrinks": reg.counter("tpudl_elastic_shrinks_total").value,
              "width": reg.gauge("tpudl_elastic_gang_width").value,
              "flips": reg.histogram("tpudl_elastic_flip_seconds").count}
    event = [e for e in jflight.get_recorder().events() if e.get("kind") == "elastic_resize"][-1]
    return {"losses": losses, "params": np.asarray(net.params()), "series": series,
            "width": trainer._layout.spec.total(),
            "event": {k: event.get(k) for k in ("direction", "from_width", "to_width", "layout")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's resize runs, each port rank's results)."""
    workdir = str(tmp_path_factory.mktemp("elastic_inprocess"))
    spec_path = os.path.join(workdir, "spec.pkl")
    gang = GangHandle(functools.partial(workers.inprocess_elastic_worker, spec_path=spec_path),
                      4, GANG_PORT, timeout=150.0)
    try:
        spec = _spec()
        with open(spec_path + ".tmp", "wb") as f:
            pickle.dump(spec, f)
        os.replace(spec_path + ".tmp", spec_path)
        masks = spec["masks"]
        clear_step_cache()           # a step traced with the real draw must not be reused
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "bernoulli",
                       lambda key, p, shape: jnp.asarray(masks[tuple(shape)]))
            ref = {"grow": _jax_run(spec, "dp2", 4), "shrink": _jax_run(spec, "dp4", 2)}
        clear_step_cache()
        with pytest.raises(ValueError, match="layout"):
            JTrainer(JMultiLayerNetwork(_conf()).init()).request_resize(2)
        with pytest.raises(JLayoutResizeError):
            JTrainer(JMultiLayerNetwork(_conf()).init(), layout="dp2").request_resize(0)
    except BaseException:
        gang.shutdown()
        raise
    ranks = sorted(gang.wait(), key=lambda r: r["pid"])
    assert len(ranks) == 4
    return ref, ranks


@pytest.mark.parametrize("name,fixed", [("grow", "fixed4"), ("shrink", "fixed2")])
def test_resize_inside_one_fit_matches_the_fixed_width_run(runs, name, fixed):
    _, ranks = runs
    got, want = ranks[0][name], ranks[0][fixed]
    assert len(got["losses"]) == len(want["losses"]) == 8
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0, atol=EXACT)
    assert got["width"] == want["width"] == (4 if name == "grow" else 2)
    # the masks really dropped: the reference's masks took another path
    assert not np.allclose(got["losses"], ranks[0][f"{name}_shared"]["losses"])


@pytest.mark.parametrize("name", ["grow", "shrink"])
def test_resize_matches_the_reference_under_shared_masks(runs, name):
    ref, ranks = runs
    want = ref[name]
    for rank in ranks:
        got = rank[f"{name}_shared"]
        if rank["pid"] < 2:      # inside the layout from start to end
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
            np.testing.assert_allclose(got["params"], want["params"], rtol=0, atol=EXACT)
        assert got["width"] == want["width"]
        assert got["series"] == want["series"]
    # after the grow every rank holds the same bytes; after the shrink ranks
    # 2 and 3 are parked and sit out the rest of the run
    assert all(rank["grow_shared"]["equal"] for rank in ranks)
    assert [rank["shrink"]["parked"] for rank in ranks] == [False, False, True, True]
    assert [rank["grow"]["parked"] for rank in ranks] == [False] * 4
    # a parked rank ran the first half only
    assert len(ranks[2]["shrink"]["losses"]) == 4
    assert len(ranks[2]["grow"]["losses"]) == 4


def test_series_and_flight_events_follow_the_reference(runs):
    ref, ranks = runs
    assert ref["grow"]["series"] == {"grows": 1, "shrinks": 0, "width": 4, "flips": 1}
    assert ref["shrink"]["series"] == {"grows": 0, "shrinks": 1, "width": 2, "flips": 1}
    for rank in ranks:
        for name in ("grow", "shrink"):
            assert rank[name]["series"] == ref[name]["series"]
            assert rank[name]["event"] == rank[f"{name}_shared"]["event"] == ref[name]["event"]
    assert ref["grow"]["event"] == {"direction": "grow", "from_width": 2, "to_width": 4,
                                    "layout": "dp4"}
    assert ref["shrink"]["event"] == {"direction": "shrink", "from_width": 4, "to_width": 2,
                                      "layout": "dp2"}


def test_a_crash_at_gang_grow_leaves_every_rank_on_the_old_layout(runs):
    _, ranks = runs
    for rank in ranks:
        c = rank["crash"]
        # rank 0 fires the site; the others raise the same type with its message
        assert c["raised"] == "InjectedCrash"
        assert c["width_after"] == c["width_after_fit"] == 2
        assert c["parked"] == (rank["pid"] >= 2)
        assert c["placed"] == (rank["pid"] < 2)       # nothing torn down
        assert c["landed"] is True and c["width_final"] == 4
        assert c["equal"]
        assert c["series"]["grows"] == 1 and c["series"]["width"] == 4


def test_request_resize_refuses_at_the_decision_site(runs):
    _, ranks = runs
    for rank in ranks:
        r = rank["refusals"]
        assert "ClusterSupervisor.request_resize" in r[8] and "4 processes" in r[8]
        assert "non-data degree" in r[0]
        assert "layout" in r["no_layout"]
