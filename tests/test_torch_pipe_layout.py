"""The port's pipe layouts (``Trainer(layout="pp2" | "dp2xpp2",
n_microbatches=M)``, ``parallel.unified``'s ``validate_pp_net``,
``split_stages`` and ``make_pp_train_step``) held to the JAX package's.

On ``tests/test_unified_mesh.py``'s dropout MLP (Dense 16 relu, Dense 16
tanh, softmax 4, Sgd(0.1), two epochs of two batches of 16), from the
reference's initial weights, in one gang of four gloo processes on the
CPU (``tests/torch_cluster_workers.py::pipe_layout_worker``; ``"pp2"``
takes ranks 0-1 and parks 2-3), against the reference's same layouts and
its single device on the conftest's CPU devices.  Per-step losses and
final params within 1e-6 (the reference's own limit):

- ``pp2`` at M = 1 with dropout, both packages' draws patched with the
  same masks: against the reference's ``pp2`` and its single device;
- ``pp2`` at M = 1 on the port's own stream: equal to the port's single
  process (the stages hand the stream's state up, so the masks are the
  single process's);
- ``dp2xpp2`` and ``pp2`` at M = 2 without dropout (the reference's
  composed layouts run so: masks differ per microbatch shape), and rank
  0's checkpoints holding the whole net;
- the step's key names its microbatches, it runs eagerly, the mesh gauges
  and the collective-bytes estimate follow the reference's, and a
  features mask and tBPTT are refused;
- ``validate_pp_net``'s refusals with the reference's messages,
  ``split_stages``' groups, and a layout with a model axis raising
  ``NotImplementedError`` naming ``ROADMAP.md`` queue A item 2.5.
"""

import functools
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import unified as junified
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.step_cache import clear_step_cache
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh, unified
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 17511
EXACT = 1e-6


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.array(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def _same(a, b):
    """The ranks of a layout hold the same bytes."""
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


def _close(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT, err_msg=f"{what}, leaf {i}")


def _conf(dropout=True, layers=None):
    # tests/test_unified_mesh.py's _mlp
    drop = 0.8 if dropout else None
    b = JConf.builder().seed(11).updater(JSgd(0.1)).weight_init("xavier").list()
    for layer in layers or (jlayers.DenseLayer(n_out=16, activation="relu", dropout=drop),
                            jlayers.DenseLayer(n_out=16, activation="tanh", dropout=drop),
                            jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent")):
        b = b.layer(layer)
    return b.set_input_type(JInputType.feed_forward(8)).build()


def _case(dropout):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.argmax(x @ w, -1)]
    conf = _conf(dropout)
    net = JMultiLayerNetwork(conf).init()
    case = {"conf": conf, "x": x, "y": y, "batch": 16, "epochs": 2, "graph": False,
            "p0": _np(net.params_), "s0": _np(net.state_)}
    if dropout:
        case["masks"] = {(16, 8): rng.random((16, 8)) < 0.8, (16, 16): rng.random((16, 16)) < 0.8}
    return case


def _jax_fit(case, layout=None, mb=1, masks=None):
    net = JMultiLayerNetwork(case["conf"]).init()
    net.params_ = jax.tree_util.tree_map(jnp.asarray, case["p0"])
    trainer = JTrainer(net, layout=layout, n_microbatches=mb)
    losses = []

    class Rec:
        def iteration_done(self, net, it, ep, loss):
            losses.append(float(loss))

    trainer.bus.listeners.append(Rec())
    batches = [JDataSet(case["x"][i:i + 16], case["y"][i:i + 16]) for i in (0, 16)]
    clear_step_cache()
    with pytest.MonkeyPatch.context() as mp:
        if masks is not None:
            mp.setattr(jax.random, "bernoulli",
                       lambda key, p, shape: jnp.asarray(masks[tuple(shape)]))
        trainer.fit(batches, epochs=case["epochs"])
    clear_step_cache()
    return {"losses": losses, "params": _np(net.params_)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pp"))
    spec_path = os.path.join(workdir, "spec.pkl")
    gang = GangHandle(functools.partial(workers.pipe_layout_worker, spec_path=spec_path), 4,
                      GANG_PORT, timeout=150.0)
    try:
        drop, plain = _case(True), _case(False)
        spec = {"dropout": dict(drop, conf=drop["conf"].to_json()),
                "plain": dict(plain, conf=plain["conf"].to_json()), "workdir": workdir}
        with open(spec_path + ".tmp", "wb") as f:
            pickle.dump(spec, f)
        os.replace(spec_path + ".tmp", spec_path)
        ref = {"pp2": _jax_fit(drop, "pp2", masks=drop["masks"]),
               "single": _jax_fit(drop, masks=drop["masks"]),
               "dp2xpp2": _jax_fit(plain, "dp2xpp2", mb=2),
               "pp2_mb2": _jax_fit(plain, "pp2", mb=2),
               "single_plain": _jax_fit(plain)}
    except BaseException:
        gang.shutdown()
        raise
    ranks = gang.wait()
    assert len(ranks) == 4
    return ref, sorted(ranks, key=lambda r: r["pid"])


def _stepping(ranks, n):
    return ranks[:n]


# ---------------------------------------------------------------- the fits
@pytest.mark.parametrize("want", ["pp2", "single"])
def test_pp2_with_dropout_matches_the_reference_under_shared_masks(runs, want):
    ref, ranks = runs
    for r in _stepping(ranks, 2):
        got = r["pp2_shared"]
        np.testing.assert_allclose(got["losses"], ref[want]["losses"], rtol=0, atol=EXACT)
        _close(got["params"], ref[want]["params"], f"pp2 vs the reference's {want}")
        assert not r["parked"]
    assert all(r["parked"] for r in ranks[2:])
    _same(ranks[0]["pp2_shared"]["params"], ranks[1]["pp2_shared"]["params"])


def test_pp2_on_its_own_stream_equals_the_single_process(runs):
    _, ranks = runs
    want = ranks[0]["single_own"]
    for r in _stepping(ranks, 2):
        got = r["pp2_own"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
        _close(got["params"], want["params"], "pp2 own stream vs single")
    assert not np.allclose(want["losses"], ranks[0]["pp2_shared"]["losses"])


@pytest.mark.parametrize("layout,n,want", [("dp2xpp2", 4, "dp2xpp2"),
                                           ("dp2xpp2", 4, "single_plain"),
                                           ("pp2_mb2", 2, "pp2_mb2"),
                                           ("pp2_mb2", 2, "single_plain")])
def test_composed_layouts_at_two_microbatches_match_the_reference(runs, layout, n, want):
    ref, ranks = runs
    for r in _stepping(ranks, n):
        got = r[layout]
        np.testing.assert_allclose(got["losses"], ref[want]["losses"], rtol=0, atol=EXACT)
        _close(got["params"], ref[want]["params"], f"{layout} vs the reference's {want}")
    for r in _stepping(ranks, n)[1:]:
        _same(r[layout]["params"], ranks[0][layout]["params"])


def test_rank_zero_writes_the_whole_net(runs):
    _, ranks = runs
    assert ranks[0]["checkpoints"] >= 1 and ranks[1]["checkpoints"] == 0
    _close(ranks[0]["checkpoint_params"], ranks[0]["pp2_mb2"]["params"], "checkpoint")


def test_the_step_key_gauges_and_refusals(runs):
    _, ranks = runs
    r0 = ranks[0]
    assert r0["step_key"].endswith("|mb:1") and "layout:pp2" in r0["step_key"]
    assert r0["dp2xpp2_key"].endswith("|mb:2") and "layout:dp2xpp2" in r0["dp2xpp2_key"]
    assert "cannot be captured" in r0["eager_reason"]
    g = r0["gauges"]
    assert g["pipe"] == 2
    want = jmesh.resolve_layout(layout="pp2").collective_bytes_per_step(g["param_bytes"])
    assert g["bytes"] == want > 0
    assert "features_mask" in r0["fmask_error"] and "labels_mask" in r0["fmask_error"]
    assert "tBPTT is not supported on pipe-axis layouts" in r0["tbptt_error"]


# ---------------------------------------------------- helpers, no gang
def _port(conf):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu").init()


@pytest.mark.parametrize("kind", ["too_few", "recurrent", "batchnorm", "l2"])
def test_validate_pp_net_refuses_as_the_reference(kind):
    conf = {
        "too_few": lambda: _conf(layers=(jlayers.OutputLayer(n_out=4, activation="softmax",
                                                             loss="mcxent"),)),
        "recurrent": lambda: (JConf.builder().seed(1).list()
                              .layer(jlayers.LSTM(n_out=4))
                              .layer(jlayers.RnnOutputLayer(n_out=2, activation="softmax",
                                                            loss="mcxent"))
                              .set_input_type(JInputType.recurrent(3)).build()),
        "batchnorm": lambda: _conf(layers=(jlayers.DenseLayer(n_out=8, activation="relu"),
                                           jlayers.BatchNormalization(),
                                           jlayers.OutputLayer(n_out=4, activation="softmax",
                                                               loss="mcxent"))),
        "l2": lambda: _conf(layers=(jlayers.DenseLayer(n_out=8, activation="relu", l2=1e-3),
                                    jlayers.OutputLayer(n_out=4, activation="softmax",
                                                        loss="mcxent"))),
    }[kind]()
    layout = types.SimpleNamespace(pipe=2)
    with pytest.raises(ValueError) as want:
        junified.validate_pp_net(JMultiLayerNetwork(conf).init(), layout)
    with pytest.raises(ValueError) as got:
        unified.validate_pp_net(_port(conf), layout)
    assert str(got.value) == str(want.value)


def test_validate_pp_net_refuses_a_graph():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    layout = types.SimpleNamespace(pipe=2)
    with pytest.raises(ValueError, match="MultiLayerNetwork .*models/bert.py:pipeline_stages"):
        unified.validate_pp_net(object.__new__(ComputationGraph), layout)


@pytest.mark.parametrize("n_stages", [2, 3])
def test_split_stages_equals_the_reference(n_stages):
    conf = _conf(layers=(jlayers.DenseLayer(n_out=64, activation="relu"),
                         jlayers.DropoutLayer(0.5),
                         jlayers.DenseLayer(n_out=32, activation="relu"),
                         jlayers.DenseLayer(n_out=16, activation="relu"),
                         jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent")))
    assert unified.split_stages(_port(conf), n_stages) == \
        junified.split_stages(JMultiLayerNetwork(conf).init(), n_stages)


def test_model_axis_layouts_raise_naming_their_item():
    for layout in ("dp2xtp2xpp2", "tp2xpp2"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 2.5"):
            mesh.resolve_layout(layout=layout)
    with pytest.raises(NotImplementedError, match="item 2.5"):
        unified.pp_layer_spec_tree([{}], 2)
    assert unified.pp_param_spec_tree([{"W": 0}, {}], [[0], [1]], 1) == \
        (({"W": unified.REPLICATED},), ({},))
    for spec in ("dp2xpp2", "pp2", "pp4"):
        for width in (4, 8, 6):
            try:
                want = jmesh.resize_spec(jmesh.MeshSpec.parse(spec), width).sizes()
            except jmesh.LayoutResizeError:
                with pytest.raises(mesh.LayoutResizeError, match="keep their"):
                    mesh.resize_spec(mesh.MeshSpec.parse(spec), width)
                continue
            assert mesh.resize_spec(mesh.MeshSpec.parse(spec), width).sizes() == want
