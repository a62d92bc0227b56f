"""The port's multi-slice dense layout (``parallel.make_multislice_mesh``,
``MultiSliceTrainer(data_per_slice=2)``) held to the JAX package's.

The JAX package trains 2 slices x 2 devices in one process
(``MultiSliceTrainer(n_slices=2, data_per_slice=2,
devices=jax.devices()[:4])``: GSPMD shards each slice's batch over its two
devices).  The port runs the same cases in one gang of four gloo processes
on the CPU (``parallel.launcher.GangHandle``, started first so that the
ranks start while the JAX package makes the weights;
``tests/torch_cluster_workers.py::multislice_worker``), one process per
rank, from those weights (``interop.load_jax_params``).

Cases: ``tests/test_dcn.py``'s Dense(16, tanh) + softmax(3) net on 8
features (``TestMultiSliceTrainer._net``, ``_data``: batch 64), τ 3e-2, 8
steps, on the device codec, the host codec and the overlapped exchange;
and the two-fused-bottleneck graph of ``tests/test_torch_dcn.py`` through
the port's plain ``matmul_bn_act`` (the reference's Pallas kernels in
interpret mode), 4 steps.

Tolerances, ``tests/test_torch_dcn.py``'s: each step's mean loss over the
slices within 1e-5 relative; the slices' divergence exactly 0.0 after
every step, and the two ranks of a slice byte-equal; params within 1e-6,
except at coordinates that one package's messages sent and the other's
did not (the encoder is discontinuous at τ), each such sent value within
1e-4 relative of τ and at most 1% of the entries sent; the values both
sent within 1e-5 relative; the wire stats (encoded counts, wire bytes)
equal wherever no coordinate was one-sided.  The fused graph: losses,
params and BN state within 1e-5 (no coordinate one-sided).
"""

import functools
import os
import pickle

import jax
import jax.flatten_util
import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.parallel import dcn as jdcn
from deeplearning4j_tpu.parallel import dcn_trainer as jdcn_trainer
from deeplearning4j_tpu.parallel.compression import AdaptiveThresholdAlgorithm as JAlgorithm
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.utils.pytree import flat_param_vector as jax_flat_param_vector

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch import parallel
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 13911
TAU0, STEPS, FUSED_STEPS = 3e-2, 8, 4
LOSS_RTOL, PARAM_ATOL, VALUE_RTOL, NEAR_TAU, MISMATCH_SHARE = 1e-5, 1e-6, 1e-5, 1e-4, 0.01
FUSED_ATOL = 1e-5
MODES = {"device": {}, "host": {"device_encode": False}, "overlap": {"overlap": True}}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _dense_conf():
    # tests/test_dcn.py's TestMultiSliceTrainer._net
    return (JConf.builder().seed(77).updater(JSgd(0.1)).weight_init("xavier").list()
            .layer(jlayers.DenseLayer(n_out=16, activation="tanh"))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
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


def _cases():
    # tests/test_dcn.py's TestMultiSliceTrainer._data(64)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    dense = {"conf": _dense_conf(), "x": x,
             "y": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)], "graph": False}
    rng = np.random.default_rng(5)
    fused = {"conf": _fused_conf(), "x": rng.normal(size=(16, 8, 8, 8)).astype(np.float32),
             "graph": True}
    fused["y"] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    for case in (dense, fused):
        case["tau"] = TAU0
        net = (JGraph if case["graph"] else JMultiLayerNetwork)(case["conf"]).init()
        case["p0"], case["s0"] = _np_tree(net.params_), _np_tree(net.state_)
    return {"dense": dense, "fused": fused}


def _jax_run(case, steps, **kw):
    """The reference's 2 x 2 trainer on ``case``: per-step losses and wire
    stats, the compact messages, params and state after."""
    net = (JGraph if case["graph"] else JMultiLayerNetwork)(case["conf"]).init()
    net.params_ = jax.tree_util.tree_map(jax.numpy.asarray, case["p0"])
    net.state_ = jax.tree_util.tree_map(jax.numpy.asarray, case["s0"])
    sent = []
    compact = jdcn_trainer.compact_device_message

    def recording(msg, capacity):
        out = compact(msg, capacity)
        sent.append(np.array(out))
        return out

    jdcn_trainer.compact_device_message = recording
    tr = jdcn_trainer.MultiSliceTrainer(net, n_slices=2, data_per_slice=2,
                                        devices=jax.devices()[:4],
                                        algorithm=JAlgorithm(initial_threshold=case["tau"]), **kw)
    out = {"losses": [], "wire": []}
    try:
        for _ in range(steps):
            out["losses"].append(tr.fit_batch(JDataSet(case["x"], case["y"]), jax.random.key(3)))
            out["wire"].append([dict(w) for w in tr.last_wire_stats])
        tr.finish()
        assert tr.max_param_divergence() == 0.0
    finally:
        jdcn_trainer.compact_device_message = compact
    out.update(messages=sent, capacity=tr.capacity,
               params=np.asarray(jax_flat_param_vector(tr.slice_params[0])),
               states=[_np_tree(s) for s in tr.slice_state])
    tr.close()
    return out


def _write_spec(cases, path):
    spec = {name: {k: (v.to_json() if k == "conf" else v) for k, v in case.items()}
            for name, case in cases.items()}
    spec["steps"], spec["fused_steps"] = STEPS, FUSED_STEPS
    with open(path + ".tmp", "wb") as f:
        pickle.dump(spec, f)
    os.replace(path + ".tmp", path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each port rank's results)."""
    workdir = str(tmp_path_factory.mktemp("multislice"))
    spec_path = os.path.join(workdir, "spec.pkl")
    gang = GangHandle(functools.partial(workers.multislice_worker, spec_path=spec_path), 4,
                      GANG_PORT, timeout=150.0)
    try:
        cases = _cases()
        _write_spec(cases, spec_path)
        ref = {mode: _jax_run(cases["dense"], STEPS, **kw) for mode, kw in MODES.items()}
        ref["fused"] = _jax_run(cases["fused"], FUSED_STEPS)
        ref["meshes"] = {shape: jdcn.make_multislice_mesh(*shape, devices=jax.devices()[:4])
                         for shape in ((2, 2), (4, 1), (1, 4))}
        ref["errors"] = {}
        for args in ((2, 4),):
            with pytest.raises(ValueError) as e:
                jdcn.make_multislice_mesh(*args, devices=jax.devices()[:4])
            ref["errors"][args] = str(e.value)
    except BaseException:
        gang.shutdown()
        raise
    ranks = sorted(gang.wait(), key=lambda r: r["pid"])
    assert len(ranks) == 4
    return ref, ranks


def _entries(m):
    c = int(m[0])
    return dict(zip(m[3:3 + c].tolist(), m[3 + c:3 + 2 * c].view(np.float32).tolist()))


def _one_sided(jax_msgs, port_msgs, steps):
    """Per step: (coordinates sent by one package only, entries sent, worst
    relative value error where both sent); every one-sided value is within
    NEAR_TAU of its threshold.  ``port_msgs``: per slice, its messages in
    step order."""
    out = []
    assert len(jax_msgs) == 2 * steps
    for s in range(steps):
        js = [_entries(m) for m in jax_msgs[2 * s:2 * s + 2]]
        ts = [(_entries(msgs[s]), float(msgs[s][2:3].view(np.float32)[0])) for msgs in port_msgs]
        one, total, worst = 0, 0, 0.0
        for a in js:
            b, tau = max(ts, key=lambda t: len(set(a) & set(t[0])))
            total += len(a)
            for k in set(a) ^ set(b):
                v = a.get(k, b.get(k))
                assert abs(v) <= tau * (1 + NEAR_TAU), (k, v, tau)
                one += 1
            for k in set(a) & set(b):
                worst = max(worst, abs(a[k] - b[k]) / abs(a[k]))
        out.append((one, total, worst))
    return out


def test_mesh_axes_and_rank_positions_match_the_reference(runs):
    ref, ranks = runs
    for shape, jmesh in ref["meshes"].items():
        devs = list(jmesh.devices.reshape(-1))
        for r in ranks:
            got = r[f"mesh_{shape}"]
            assert got["axes"] == tuple(jmesh.axis_names) == ("dcn", "data", "model")
            assert got["shape"] == dict(jmesh.shape)
            # the reference's device at this rank's index is the rank's own
            where = tuple(int(i) for i in np.argwhere(jmesh.devices == jax.devices()[r["pid"]])[0])
            assert got["position"] == where, (shape, r["pid"])
            assert devs[r["pid"]] == jax.devices()[r["pid"]]
            assert got["leader"] == (where[1] == 0)
            assert r["pid"] in got["slice_ranks"] and len(got["slice_ranks"]) == shape[1]
            assert got["layout"] == ("single" if shape[1] == 1 else f"dp{shape[1]}")


def test_mesh_refusals_follow_the_reference(runs):
    ref, ranks = runs
    for r in ranks:
        kind, msg = r["errors"][(2, 4)]
        assert kind == "ValueError" and msg.startswith(ref["errors"][(2, 4)])
        kind, msg = r["errors"][(2, 2, 2)]
        assert kind == "NotImplementedError" and "item 2.5" in msg
        kind, msg = r["errors"][(1, 2)]
        assert kind == "ValueError" and "4 ranks" in msg


@pytest.mark.parametrize("mode", list(MODES))
def test_two_slices_of_two_ranks_follow_the_reference(runs, mode):
    ref, ranks = runs
    want = ref[mode]
    got = {r["pid"]: r[mode] for r in ranks}
    slices = [[got[0], got[1]], [got[2], got[3]]]
    for s, pair in enumerate(slices):
        assert [g["slice"] for g in pair] == [s, s] and pair[0]["world"] == 2
        assert pair[0]["capacity"] == want["capacity"]
    # divergence 0.0 after every step, on every rank; a slice's ranks byte-equal
    for g in got.values():
        assert g["divergence"] == [0.0] * (STEPS + 1)
        for digests in g["digests"]:
            assert digests[0] == digests[1] and digests[2] == digests[3]
    # the mean of the slices' losses against the reference's
    losses = [(a + b) / 2 for a, b in zip(got[0]["losses"], got[2]["losses"])]
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    assert got[0]["losses"] == got[1]["losses"] and got[2]["losses"] == got[3]["losses"]
    # the messages (the device codec's), one per slice per step
    one_sided = [0] * STEPS
    if mode != "host":
        port_msgs = [got[0]["messages"], got[2]["messages"]]
        assert all(len(m) == STEPS for m in port_msgs)
        for a, b in ((got[0], got[1]), (got[2], got[3])):
            assert all(np.array_equal(x, y) for x, y in zip(a["messages"], b["messages"]))
        per_step = _one_sided(want["messages"], port_msgs, STEPS)
        one_sided = [o for o, _, _ in per_step]
        total = sum(t for _, t, _ in per_step)
        assert total > 0 and sum(one_sided) <= MISMATCH_SHARE * total, per_step
        assert max(w for _, _, w in per_step) <= VALUE_RTOL
    # the wire stats per slice per step: equal where nothing was one-sided
    for step in range(STEPS):
        for s in range(2):
            ws, jws = got[2 * s]["wire"][step], want["wire"][step][s]
            assert len(ws) == 1 and ws[0]["dense_bytes"] == jws["dense_bytes"]
            assert 0 < ws[0]["wire_bytes"] < ws[0]["dense_bytes"]
            if one_sided[step] == 0:
                assert ws[0]["encoded"] == jws["encoded"], (step, s)
                assert ws[0]["wire_bytes"] == jws["wire_bytes"], (step, s)
    # params: tight but at one-sided coordinates
    diff = np.abs(got[0]["params"] - want["params"])
    assert np.sum(diff > PARAM_ATOL) <= sum(one_sided)
    assert diff.max() <= PARAM_ATOL + 0.1 * TAU0 * 2 * STEPS
    # the residual and τ are per slice, equal across the slice's ranks
    for a, b in ((got[0], got[1]), (got[2], got[3])):
        assert np.array_equal(a["residual"], b["residual"]) and a["threshold"] == b["threshold"]
    assert not np.array_equal(got[0]["residual"], got[2]["residual"])


def test_the_fused_graph_follows_the_reference(runs):
    ref, ranks = runs
    want = ref["fused"]
    got = [r["fused"] for r in ranks]
    losses = [(a + b) / 2 for a, b in zip(got[0]["losses"], got[2]["losses"])]
    np.testing.assert_allclose(losses, want["losses"], rtol=0, atol=FUSED_ATOL)
    per_step = _one_sided(want["messages"], [got[0]["messages"], got[2]["messages"]],
                          FUSED_STEPS)
    assert sum(o for o, _, _ in per_step) == 0, per_step
    for g in got:
        np.testing.assert_allclose(g["params"], want["params"], rtol=0, atol=FUSED_ATOL)
        assert g["divergence"] == [0.0] * (FUSED_STEPS + 1)
    # BN statistics are the slice's (summed over its two ranks)
    for s in range(2):
        for v, d in want["states"][s].items():
            for k, w in d.items():
                for g in got[2 * s:2 * s + 2]:
                    np.testing.assert_allclose(g["state"][v][k], w, rtol=0, atol=FUSED_ATOL,
                                               err_msg=f"slice {s} {v}/{k}")


def test_slice_steps_run_eagerly_on_gloo_with_their_collectives(runs):
    _, ranks = runs
    for r in ranks:
        for mode in ("device", "host", "overlap", "layout", "fused"):
            assert "gloo" in r[mode]["eager"]
        calls, nbytes = r["device"]["stats"]["gradient"]
        # one flat all-reduce of the gradient and the loss a step
        assert calls == STEPS and nbytes == STEPS * 4 * (8 * 16 + 16 + 16 * 3 + 3 + 1)
        assert "batch_statistics" in r["fused"]["stats"]
        assert r["layout"]["divergence"] == [0.0] * 3


def test_the_parallel_package_exports_the_multislice_mesh():
    for name in ("make_multislice_mesh", "MultiSliceMesh", "resize_spec", "resize_layout",
                 "LayoutResizeError"):
        assert name in parallel.__all__ and name not in parallel.NOT_PORTED
