"""The port's dense data parallelism (``Trainer(layout="dp2")``,
``parallel.mesh``, ``ParallelWrapper``) held to the JAX package's.

The JAX package runs each case on two of the conftest's eight CPU devices
(``Trainer(layout="dp2")``: GSPMD shards the batch; ``ParallelWrapper``
on ``make_mesh(data=2)``), from its own initial weights.  The port runs
the same cases in one gang of two gloo processes on the CPU
(``parallel.launcher.GangHandle``, started first so that the ranks
start while the JAX package makes the weights, and run while the
reference runs; ``tests/torch_cluster_workers.py::data_parallel_worker``), from those weights (``interop.load_jax_params``),
one process per data shard.

Cases and tolerances (each against the reference's dp2):

- ``tests/test_unified_mesh.py``'s dropout MLP, both packages' dropout
  draws patched with the same global-batch masks: per-step losses and
  final params within 1e-6; with the port's own stream, the port's dp2
  equals its single-process run within 1e-6 (each rank draws the global
  batch's mask and keeps its rows);
- the two-fused-bottleneck graph of ``tests/test_torch_dcn.py``, through
  the port's plain ``matmul_bn_act`` and the reference's Pallas kernels in
  interpret mode: params and BN state within 1e-5;
- a dense + ``BatchNormalization`` net (Nesterovs), with a
  ``CheckpointListener``: params and BN state within 1e-6, each
  checkpoint written once (rank 0), and a dp2 resume from the mid-run
  checkpoint equal to the uninterrupted run bit for bit;
- an LSTM + ``RnnOutputLayer`` net with l2, whose shards' label-mask
  counts differ (2 against 6 steps a sequence): losses and params within
  1e-6, and the same net under tBPTT (2 segments of 3 steps, each rank
  carrying its own rows' state);
- ``ParallelWrapper(averaging_frequency=2)`` with and without the
  updater state averaged: losses, params and layer state within 1e-6,
  the ranks apart after a local step and byte-equal after each average;
- ZeRO-1 under Nesterovs: params within 1e-6 of the reference's, bit for
  bit the port's unsharded dp2, and each rank's updater bytes about half.
"""

import functools
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs.registry import get_registry as jget_registry
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.train import Nesterovs as JNesterovs
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.step_cache import clear_step_cache
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch import parallel
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle
from deeplearning4j_tpu_torch.train import Trainer, step_cache

GANG_PORT = 13711
EXACT, FUSED_ATOL = 1e-6, 1e-5
PARAM_BYTES = (0, 1000, 102_228_128)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def _close(got, want, atol, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{what}, leaf {i}")


# ------------------------------------------------------------ the cases
def _mlp_conf():
    # tests/test_unified_mesh.py's _mlp
    return (JConf.builder().seed(11).updater(JSgd(0.1)).weight_init("xavier").list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu", dropout=0.8))
            .layer(jlayers.DenseLayer(n_out=16, activation="tanh", dropout=0.8))
            .layer(jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _fused_conf():
    # tests/test_torch_dcn.py's _fused_conf
    g = (JConf.builder().seed(4).updater(JSgd(0.05)).weight_init("relu").graph()
         .add_inputs("in").set_input_types(JInputType.convolutional(8, 8, 8)))
    g.add_layer("b1", jlayers.FusedBottleneck(filters=(4, 4, 8)), "in")
    g.add_layer("b2", jlayers.FusedBottleneck(filters=(4, 4, 8)), "b1")
    g.add_layer("pool", jlayers.GlobalPoolingLayer(pooling_type="avg"), "b2")
    g.add_layer("out", jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                "pool")
    g.set_outputs("out")
    return g.build()


def _dense_bn_conf(seed=21):
    return (JConf.builder().seed(seed).updater(JNesterovs(0.05, 0.9)).weight_init("xavier")
            .list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu"))
            .layer(jlayers.BatchNormalization())
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _zero_conf():
    return (JConf.builder().seed(31).updater(JNesterovs(0.05, 0.9)).weight_init("xavier")
            .list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu"))
            .layer(jlayers.DenseLayer(n_out=16, activation="tanh"))
            .layer(jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _rnn_conf(tbptt=False):
    b = (JConf.builder().seed(41).updater(JSgd(0.1)).weight_init("xavier").l2(1e-2).list()
         .layer(jlayers.LSTM(n_out=8, activation="tanh"))
         .layer(jlayers.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
         .set_input_type(JInputType.recurrent(4)))
    return (b.backprop_type("tbptt", 3, 3) if tbptt else b).build()


def _classes(rng, n, k, shape=()):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, (n,) + shape)]


def _cases():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    # the reference's test data (tests/test_unified_mesh.py's _data)
    mlp = {"conf": _mlp_conf(), "x": x, "y": np.eye(4, dtype=np.float32)[np.argmax(x @ w, -1)],
           "batch": 16, "epochs": 2,
           "masks": {(16, 8): rng.random((16, 8)) < 0.8, (16, 16): rng.random((16, 16)) < 0.8}}
    rng = np.random.default_rng(5)
    fused = {"conf": _fused_conf(), "x": rng.normal(size=(16, 8, 8, 8)).astype(np.float32),
             "y": _classes(rng, 16, 3), "batch": 8, "epochs": 2, "graph": True}
    dense_bn = {"conf": _dense_bn_conf(), "x": rng.normal(size=(32, 8)).astype(np.float32) * 2,
                "y": _classes(rng, 32, 3), "batch": 16, "epochs": 2}
    # rank 0 takes rows 0-3 of each batch of 8 (2 labelled steps each),
    # rank 1 rows 4-7 (all 6)
    lmask = np.ones((16, 6), np.float32)
    lmask[0:4, 2:] = lmask[8:12, 2:] = 0.0
    rnn = {"conf": _rnn_conf(), "x": rng.normal(size=(16, 6, 4)).astype(np.float32),
           "y": _classes(rng, 16, 3, (6,)), "lmask": lmask, "batch": 8, "epochs": 2}
    tbptt = dict(rnn, conf=_rnn_conf(tbptt=True))
    averaging = {"conf": _dense_bn_conf(23), "x": rng.normal(size=(48, 8)).astype(np.float32),
                 "y": _classes(rng, 48, 3), "batch": 16, "epochs": 1}
    zero = {"conf": _zero_conf(), "x": rng.normal(size=(32, 8)).astype(np.float32),
            "y": _classes(rng, 32, 4), "batch": 16, "epochs": 2}
    cases = {"dropout": mlp, "fused": fused, "dense_bn": dense_bn, "masked_rnn": rnn,
             "tbptt_rnn": tbptt, "averaging": averaging, "zero": zero}
    for case in cases.values():
        case.setdefault("graph", False)
        net = (JGraph if case["graph"] else JMultiLayerNetwork)(case["conf"]).init()
        case["p0"], case["s0"] = _np_tree(net.params_), _np_tree(net.state_)
    return cases


def _jax_batches(case):
    b, lm = case["batch"], case.get("lmask")
    return [JDataSet(case["x"][i:i + b], case["y"][i:i + b], None,
                     None if lm is None else lm[i:i + b]) for i in range(0, len(case["x"]), b)]


def _jax_fit(case, make):
    """The reference's fit of ``case`` from its initial weights through
    ``make(net)``; losses, trees after, and the trainer."""
    net = (JGraph if case["graph"] else JMultiLayerNetwork)(case["conf"]).init()
    net.params_ = jax.tree_util.tree_map(jnp.asarray, case["p0"])
    net.state_ = jax.tree_util.tree_map(jnp.asarray, case["s0"])
    trainer = make(net)
    losses = []

    class Rec:
        def iteration_done(self, net, it, ep, loss):
            losses.append(float(loss))

    trainer.bus.listeners.append(Rec())
    trainer.fit(_jax_batches(case), epochs=case["epochs"])
    return {"losses": losses, "params": _np_tree(net.params_), "state": _np_tree(net.state_)}, \
        trainer


def _write_spec(cases, workdir, path):
    """The port's cases (confs as JSON), atomically at ``path``."""
    spec = {name: {k: (v.to_json() if k == "conf" else v) for k, v in case.items()}
            for name, case in cases.items()}
    spec["param_bytes"] = PARAM_BYTES
    spec["workdir"] = workdir
    with open(path + ".tmp", "wb") as f:
        pickle.dump(spec, f)
    os.replace(path + ".tmp", path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each port rank's results): the port's two
    ranks start first and wait for the weights the JAX package makes, then
    run while the reference runs."""
    from deeplearning4j_tpu.parallel.data_parallel import ParallelWrapper as JParallelWrapper
    workdir = str(tmp_path_factory.mktemp("dp"))
    spec_path = os.path.join(workdir, "spec.pkl")
    gang = GangHandle(functools.partial(workers.data_parallel_worker, spec_path=spec_path), 2,
                      GANG_PORT, timeout=150.0)
    try:
        cases = _cases()
        _write_spec(cases, workdir, spec_path)
        out = _reference(cases, JParallelWrapper)
    except BaseException:
        gang.shutdown()
        raise
    ranks = gang.wait()
    assert len(ranks) == 2
    return out, ranks


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def _reference(cases, JParallelWrapper):
    pair = jax.devices()[:2]
    out = {"cases": cases}

    def dp2(net):
        return JTrainer(net, layout="dp2")

    masks = cases["dropout"]["masks"]
    clear_step_cache()           # a step traced with the real draw must not be reused
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(masks[tuple(shape)]))
        out["dropout"], tr = _jax_fit(cases["dropout"], dp2)
    clear_step_cache()           # nor this one, traced with the patched draw
    out["signature"] = tr._layout.cache_signature()
    reg = jget_registry()
    out["gauges"] = {"devices": reg.gauge("tpudl_mesh_devices").value,
                     "axes": {a: reg.labeled_gauge("tpudl_mesh_axis_size", label_names=("axis",))
                              .labeled_value(axis=a) for a in jmesh.MESH_AXES},
                     "active": reg.labeled_gauge("tpudl_mesh_layout_active",
                                                 label_names=("layout",))
                     .labeled_value(layout="dp2"),
                     "bytes": reg.gauge("tpudl_mesh_collective_bytes").value,
                     "parallel_devices": reg.gauge("tpudl_parallel_mesh_devices").value}
    layout = jmesh.resolve_layout(layout="dp2")
    out["collective_bytes"] = [layout.collective_bytes_per_step(b) for b in PARAM_BYTES]
    for name in ("fused", "dense_bn", "masked_rnn", "tbptt_rnn"):
        out[name], _ = _jax_fit(cases[name], dp2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for avg_state in (True, False):
            out[f"averaging_{avg_state}"], _ = _jax_fit(cases["averaging"], lambda net: (
                JParallelWrapper(net, mesh=jmesh.make_mesh(data=2, devices=pair),
                                 averaging_frequency=2, average_updater_state=avg_state)))
        out["zero"], _ = _jax_fit(cases["zero"], lambda net: JParallelWrapper(
            net, mesh=jmesh.make_mesh(data=2, devices=pair), zero_optimizer_sharding=True))
    clear_step_cache()
    return out


# ------------------------------------------------------------------ tests
def test_dropout_mlp_matches_the_reference_dp2_under_shared_masks(reference, port):
    want = reference["dropout"]
    for rank in port:
        got = rank["dropout_shared"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
        _close(got["params"], want["params"], EXACT, "dropout MLP params")
        assert got["equal_ranks"]


def test_dropout_mlp_dp2_equals_the_single_process_run_on_its_own_stream(port):
    for rank in port:
        got, want = rank["dropout_own"], rank["dropout_single"]
        assert len(got["losses"]) == 4
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
        _close(got["params"], want["params"], EXACT, "dropout MLP, own stream")
        assert got["equal_ranks"]
    # the masks really dropped: the shared-mask run took another path
    assert not np.allclose(port[0]["dropout_own"]["losses"], port[0]["dropout_shared"]["losses"])


@pytest.mark.parametrize("name,atol", [("fused", FUSED_ATOL), ("dense_bn", EXACT),
                                       ("masked_rnn", EXACT), ("tbptt_rnn", EXACT)])
def test_layout_dp2_matches_the_reference(reference, port, name, atol):
    want = reference[name]
    for rank in port:
        got = rank[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=atol)
        _close(got["params"], want["params"], atol, f"{name} params")
        _close(got["state"], want["state"], atol, f"{name} state")
        assert got["equal_ranks"]


def test_masked_rnn_shards_carry_unequal_counts(reference):
    lmask = reference["cases"]["masked_rnn"]["lmask"]
    counts = [lmask[i:i + 4].sum() for i in range(0, 16, 4)]
    assert counts == [8.0, 24.0, 8.0, 24.0]


def test_checkpoints_are_written_once_and_a_dp2_resume_repeats_the_run(port):
    r0, r1 = port
    # iterations 0-3: a checkpoint at iteration 2, by rank 0 alone
    assert [p.rsplit("/", 1)[-1] for p in r0["saved"]] == ["checkpoint_iter2_epoch1.zip"]
    assert r1["saved"] == []
    assert r0["listed"] == r1["listed"] == ["checkpoint_iter2_epoch1.zip"]
    for rank in port:
        got, want = rank["resumed"], rank["dense_bn"]
        assert len(got["losses"]) == 1 and got["losses"] == want["losses"][-1:]
        for a, b in zip(_leaves([got["params"], got["state"]]),
                        _leaves([want["params"], want["state"]])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("avg_state", [True, False])
def test_parallel_wrapper_averaging_matches_the_reference(reference, port, avg_state):
    want = reference[f"averaging_{avg_state}"]
    for rank in port:
        got = rank[f"averaging_{avg_state}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=EXACT)
        _close(got["params"], want["params"], EXACT, "averaged params")
        _close(got["state"], want["state"], EXACT, "rank 0's layer state")
        # 3 steps: apart after step 1, equal after the average of step 2
        # (the updater state too, when averaged), apart after step 3; fit's
        # last average makes the params equal, and rank 0's BN state is
        # handed on
        assert got["equal_after_step"] == [(False, False), (True, avg_state), (False, False)]
        assert got["equal_ranks"]


def test_zero1_matches_the_unsharded_run_and_halves_the_updater_state(reference, port):
    for rank in port:
        got, unsharded = rank["zero"], rank["unsharded"]
        _close(got["params"], reference["zero"]["params"], EXACT, "ZeRO-1 params")
        np.testing.assert_allclose(got["losses"], reference["zero"]["losses"], rtol=0,
                                   atol=EXACT)
        for a, b in zip(_leaves(got["params"]), _leaves(unsharded["params"])):
            assert np.array_equal(a, b)
        assert got["equal_ranks"]
    # whole layers: the [8, 16] + [16] first layer and the [16, 16] + [16]
    # second on one rank each, the output layer with the lighter
    assert port[0]["zero"]["owners"] == [1, 0, 1]
    assert port[1]["zero"]["owners"] == [1, 0, 1]
    full = port[0]["unsharded"]["opt_bytes"]
    shares = [rank["zero"]["opt_bytes"] for rank in port]
    assert sum(shares) == full
    assert all(0.4 * full <= s <= 0.6 * full for s in shares), (shares, full)


def test_layout_metrics_signature_and_collective_bytes_match_the_reference(reference, port):
    for rank in port:
        assert rank["gauges"] == reference["gauges"]
        assert rank["collective_bytes"] == reference["collective_bytes"]
        assert rank["signature"] == reference["signature"] == "layout:dp2|tp:dense|devs:2:cpu"
        assert rank["mesh_shape"] == {"pipe": 1, "data": 2, "seq": 1, "expert": 1, "model": 1}


def test_step_keys_differ_per_layout_and_gloo_steps_say_they_run_eagerly(port):
    for rank in port:
        assert rank["step_key"][:-2] == rank["single_key"][:-2]
        assert rank["single_key"][-2:] == ("", "train")
        assert rank["step_key"][-2:] == (
            "layout:dp2|tp:dense|devs:2:cpu|eager:gloo", "train")
        assert "gloo" in rank["eager_reason"] and "CUDA graph" in rank["eager_reason"]
        # the collectives of the last dp2 run: one flat gradient all-reduce a step
        calls, nbytes = rank["stats"]["gradient"]
        assert calls == 4 and nbytes == 4 * 4 * (8 * 16 + 16 + 16 * 16 + 16 + 16 * 4 + 4 + 1)


def test_layouts_that_the_group_does_not_fit_raise(port):
    for rank in port:
        kind, msg = rank["layout_errors"]["dp4"]
        assert kind == "ValueError" and "needs 4 processes" in msg and "initialize" in msg
        kind, msg = rank["layout_errors"]["dp2xtp2"]
        assert kind == "NotImplementedError" and "ROADMAP.md queue A item 2.5" in msg


@pytest.mark.parametrize("layout,item", [("tp2", "2.5"), ("pp2", "2.4"), ("dp2xtp2", "2.5"),
                                         ("sp2", None), ("ep2", "2.4")])
def test_unported_axes_raise_naming_their_roadmap_item(layout, item):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_zero_conf().to_json()),
                            device="cpu").init()
    if item != "2.5":
        # the seq axis, and since item 2.4 the pipe and expert axes, are ported: with
        # no process group they ask for one
        with pytest.raises(RuntimeError, match="spawn_local_cluster.*initialize"):
            Trainer(net, layout=layout)
        with pytest.raises(RuntimeError, match="spawn_local_cluster"):
            mesh.resolve_layout(layout=layout)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A item {item}"):
        Trainer(net, layout=layout)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        mesh.resolve_layout(layout=layout)


def test_layout_rules_without_a_group_follow_the_reference():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_zero_conf().to_json()),
                            device="cpu").init()
    # dp2 with no process group: the message names the launcher's entry points
    with pytest.raises(RuntimeError, match="spawn_local_cluster.*initialize"):
        Trainer(net, layout="dp2")
    assert mesh.resolve_layout() is None is jmesh.resolve_layout()
    assert mesh.resolve_layout(layout="dp1") is None is jmesh.resolve_layout(layout="dp1")
    assert Trainer(net, layout="dp1")._layout is None
    with pytest.raises(ValueError):
        jmesh.resolve_layout(layout="dp64")
    with pytest.raises(RuntimeError):
        mesh.resolve_layout(layout="dp64")
    # the pipe axis's microbatch count is taken, and only a pipe layout splits a batch
    assert Trainer(net, n_microbatches=2)._n_microbatches == 2
    with pytest.raises(ValueError, match="n_microbatches"):
        Trainer(net, n_microbatches=0)
    with pytest.raises(ValueError, match="layout"):
        Trainer(net).request_resize(4)
    assert mesh.resize_spec(mesh.MeshSpec(data=2), 4).sizes() == \
        jmesh.resize_spec(jmesh.MeshSpec(data=2), 4).sizes()
    for text in ("dp2", "dp2xtp2xpp2", "data2_model2", "tp4*dp2", "sp2,ep2", "dp1"):
        got, want = mesh.MeshSpec.parse(text), jmesh.MeshSpec.parse(text)
        assert got.sizes() == want.sizes() and got.describe() == want.describe()
        assert got.total() == want.total()
    for bad in ("", "xx2", "dp0", "dp2xdp2", "x"):
        with pytest.raises(ValueError):
            jmesh.MeshSpec.parse(bad)
        with pytest.raises(ValueError):
            mesh.MeshSpec.parse(bad)
    assert step_cache.sharding_signature(None) == ""


def test_the_parallel_package_exports_the_dense_layouts():
    for name in ("make_mesh", "MeshLayout", "resolve_layout", "ParallelWrapper"):
        assert name in parallel.__all__ and name not in parallel.NOT_PORTED
    assert "data_parallel" not in parallel.NOT_PORTED_MODULES
    assert parallel.MeshLayout is mesh.MeshLayout
    with pytest.warns(DeprecationWarning, match="Trainer\\(layout="):
        import importlib
        import sys
        sys.modules.pop("deeplearning4j_tpu_torch.parallel.data_parallel", None)
        module = importlib.import_module("deeplearning4j_tpu_torch.parallel.data_parallel")
    assert parallel.ParallelWrapper is module.ParallelWrapper
    with pytest.raises(ValueError, match="zero_optimizer_sharding"):
        module.ParallelWrapper(MultiLayerNetwork(MultiLayerConfiguration.from_json(
            _zero_conf().to_json()), device="cpu").init(), mesh=object(),
            averaging_frequency=4, zero_optimizer_sharding=True)
