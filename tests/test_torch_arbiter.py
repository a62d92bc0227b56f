"""The port's device-pool arbiter (``resilience.arbiter``:
``DevicePoolArbiter``, ``TrainerGang``) held to the JAX package's
(``tests/test_elastic.py``).

- The event sequences of the reference's arbiter tests (the borrow and
  return cycle with the training floor, a crash at ``arbiter.borrow`` and
  at ``arbiter.return``, a transient fault retried, hysteresis and
  cooldown) run against both packages' arbiters, each over its own
  package's ``ReplicaRouter`` on a small MLP and the same scripted gang:
  the inventories after every step, the gang's requests, the routers'
  replica counts, the ``tpudl_elastic_*`` series and the cluster store's
  annotations (their ``flip_s`` and times left out) are equal.
- Under live serving: the reference's acceptance cycle in a gang of four
  gloo processes on the CPU (``tests/torch_cluster_workers.py::
  arbiter_live_worker``): rank 0 hosts the router, three client threads
  and the arbiter over ``TrainerGang`` of a ``Trainer(layout="dp4")``; a
  borrow shrinks the gang to dp2 at the next boundary, a return grows it
  back to dp4, no client sees an error (each answer within the
  reference's rtol 1e-5, atol 1e-6 of the served net's output), and the
  inventory, the replicas and the series end as the JAX package's run of
  the same cycle on four of the conftest's CPU devices.
- ``TrainerGang`` refuses a trainer without a layout, as the reference's.
"""

import functools
import os
import pickle
import threading
import types

import jax.numpy as jnp  # noqa: F401  (the conftest's CPU devices)
import numpy as np
import pytest

from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import remote as jremote
from deeplearning4j_tpu.obs.registry import MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.obs.registry import get_registry as jget_registry
from deeplearning4j_tpu.obs.registry import set_registry as jset_registry
from deeplearning4j_tpu.resilience import arbiter as jarbiter
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from deeplearning4j_tpu.serve import ModelRegistry as JModelRegistry
from deeplearning4j_tpu.serve import ReplicaRouter as JReplicaRouter
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import remote
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle
from deeplearning4j_tpu_torch.resilience import DevicePoolArbiter, TrainerGang, arbiter, faults
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
from deeplearning4j_tpu_torch.serve import ModelRegistry, ReplicaRouter
from deeplearning4j_tpu_torch.train import Trainer

GANG_PORT = 16711
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6     # the reference's client check


def _conf(seed=11, dropout=True):
    # tests/test_elastic.py's _mlp
    drop = 0.8 if dropout else None
    return (JConf.builder().seed(seed).updater(JSgd(0.1)).weight_init("xavier").list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu", dropout=drop))
            .layer(jlayers.DenseLayer(n_out=16, activation="tanh", dropout=drop))
            .layer(jlayers.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _data(n=32, seed=0):
    # tests/test_elastic.py's _data
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[np.argmax(x @ w, -1)]


class _FakeGang:
    """tests/test_elastic.py's gang side: width + request_resize, applied
    at once."""

    def __init__(self, width):
        self._width = width
        self.requests = []

    @property
    def width(self):
        return self._width

    def request_resize(self, width, reason=""):
        self.requests.append((int(width), reason))
        self._width = int(width)


# both packages' pieces, under one set of names
JAX = types.SimpleNamespace(
    name="jax", Arbiter=jarbiter.DevicePoolArbiter, RetryPolicy=JRetryPolicy, faults=jfaults,
    Registry=JMetricsRegistry, set_registry=jset_registry, get_registry=jget_registry,
    ClusterStore=jremote.ClusterStore,
    models=lambda: JModelRegistry(max_batch=8, max_latency_ms=2, queue_limit=64),
    Router=JReplicaRouter)
PORT = types.SimpleNamespace(
    name="port", Arbiter=arbiter.DevicePoolArbiter, RetryPolicy=RetryPolicy, faults=faults,
    Registry=MetricsRegistry, set_registry=set_registry, get_registry=get_registry,
    ClusterStore=remote.ClusterStore,
    models=lambda: ModelRegistry(device="cpu", max_batch=8, max_latency_ms=2, queue_limit=64),
    Router=ReplicaRouter)


@pytest.fixture(scope="module")
def serve_zip(tmp_path_factory):
    """tests/test_elastic.py's served MLP (no dropout), saved by the JAX
    package; the port deploys its own zip of the same weights."""
    d = tmp_path_factory.mktemp("arbiter_zip")
    net = JMultiLayerNetwork(_conf(dropout=False)).init()
    jpath = str(d / "jax.zip")
    net.save(jpath)
    port = MultiLayerNetwork(MultiLayerConfiguration.from_json(_conf(dropout=False).to_json()),
                             device="cpu")
    load_jax_params(port, _np_tree(net.params_), _np_tree(net.state_))
    ppath = str(d / "port.zip")
    port.save(ppath)
    return {"jax": jpath, "port": ppath}


def _record(arb, router, gang, note: str, into: list) -> None:
    into.append({"note": note, "snapshot": arb.snapshot(), "gang": gang.width,
                 "requests": list(gang.requests),
                 "router": (router.replicas, router.max_replicas)})


def _scenario(pkg, path, name: str) -> dict:
    """One of tests/test_elastic.py's arbiter tests (:352-455) as an event
    sequence over ``pkg``'s arbiter and router: every step's state, then
    the series and the annotations."""
    reg = pkg.Registry()
    prev = pkg.set_registry(reg)
    pkg.faults.clear_fault_plan()
    models = pkg.models()
    models.deploy("m", path)
    router = pkg.Router(models, "m", replicas=2, max_replicas=4)
    store = pkg.ClusterStore()
    steps: list = []
    gang = _FakeGang(4)
    try:
        if name == "cycle":
            arb = pkg.Arbiter(router, gang, min_train=2, chips_per_flip=2, cooldown_s=0.0,
                              serve_chips=2, cluster_store=store)
            steps.append({"total": arb.total()})
            for note, flip in (("borrow", arb.borrow), ("floor", arb.borrow),
                               ("return", arb.return_chips)):
                steps.append({"result": flip()})
                _record(arb, router, gang, note, steps)
        elif name == "crash":
            arb = pkg.Arbiter(router, gang, min_train=1, chips_per_flip=2, cooldown_s=0.0,
                              serve_chips=2, cluster_store=store)
            with pkg.faults.inject("arbiter.borrow@0:crash"):
                steps.append({"result": arb.borrow()})
            _record(arb, router, gang, "borrow crashed", steps)
            steps.append({"result": arb.borrow()})
            _record(arb, router, gang, "borrow", steps)
            with pkg.faults.inject("arbiter.return@0:crash"):
                steps.append({"result": arb.return_chips()})
            _record(arb, router, gang, "return crashed", steps)
            steps.append({"result": arb.return_chips()})
            _record(arb, router, gang, "return", steps)
        elif name == "retry":
            arb = pkg.Arbiter(router, gang, min_train=1, chips_per_flip=1, cooldown_s=0.0,
                              serve_chips=2, cluster_store=store,
                              policy=pkg.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                                     jitter=0.0))
            with pkg.faults.inject("arbiter.borrow@0:error"):
                steps.append({"result": arb.borrow()})
            _record(arb, router, gang, "borrow retried", steps)
        elif name == "hysteresis":
            arb = pkg.Arbiter(router, gang, min_train=1, chips_per_flip=1, high_water=0.5,
                              low_water=0.05, sustain_polls=3, cooldown_s=0.0, serve_chips=2,
                              cluster_store=store)
            for fill, sat in ((0.9, True), (0.9, True), (0.3, False), (0.9, True),
                              (0.9, False), (0.9, True), (0.9, True), (0.9, True),
                              (0.0, False), (0.0, False), (0.0, False)):
                steps.append({"poll": (fill, sat), "flip": arb.note_pressure(fill, saturated=sat),
                              "borrowed": arb.borrowed, "gang": gang.width})
            # cooldown separates any two flips
            gang2 = _FakeGang(4)
            arb2 = pkg.Arbiter(router, gang2, min_train=1, sustain_polls=1, cooldown_s=3600.0,
                               serve_chips=2)
            steps.append({"cooldown_borrow": arb2.borrow()})
            steps.append({"cooldown_polls": [arb2.note_pressure(0.0) for _ in range(5)],
                          "borrowed": arb2.borrowed})
    finally:
        models.close()
        pkg.faults.clear_fault_plan()
        pkg.set_registry(prev)
    gauge = reg.labeled_gauge("tpudl_elastic_pool_devices", label_names=("owner",))
    notes = [{k: v for k, v in a.items() if k not in ("time", "flip_s")}
             for a in store.summary()["annotations"]]
    return {"steps": steps, "notes": notes,
            "series": {"borrows": reg.counter("tpudl_elastic_borrows_total").value,
                       "returns": reg.counter("tpudl_elastic_returns_total").value,
                       "flips": reg.histogram("tpudl_elastic_flip_seconds").count,
                       "pool": {o: gauge.labeled_value(owner=o) for o in ("serve", "train")}}}


@pytest.mark.parametrize("name", ["cycle", "crash", "retry", "hysteresis"])
def test_arbiter_event_sequences_match_the_reference(serve_zip, name):
    want = _scenario(JAX, serve_zip["jax"], name)
    got = _scenario(PORT, serve_zip["port"], name)
    assert got["steps"] == want["steps"]
    assert got["series"] == want["series"]
    assert got["notes"] == want["notes"]
    if name == "cycle":
        assert [s.get("result") for s in got["steps"][1::2]] == [True, False, True]
        assert got["steps"][-1]["snapshot"] == {"serve": 2, "train": 4, "borrowed": 0,
                                                "total": 6}
    if name == "crash":
        # conserved: the crashed flips leave what was there before them
        assert got["steps"][1]["snapshot"] == {"serve": 2, "train": 4, "borrowed": 0,
                                               "total": 6}
        assert got["steps"][1]["requests"][-1] == (4, "arbiter rollback")
        assert got["steps"][5]["snapshot"] == got["steps"][3]["snapshot"]
        assert [n["event"] for n in got["notes"]] == ["borrow_aborted", "borrow",
                                                      "return_aborted", "return"]


def test_trainer_gang_requires_a_layout():
    with pytest.raises(ValueError, match="layout"):
        jarbiter.TrainerGang(JTrainer(JMultiLayerNetwork(_conf())))
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_conf().to_json()), device="cpu")
    with pytest.raises(ValueError, match="layout"):
        TrainerGang(Trainer(net))


def _jax_live(spec, path) -> dict:
    """tests/test_elastic.py's test_borrow_return_under_live_serve_load,
    the reference's own run, from the spec's weights."""
    import jax
    reg = JMetricsRegistry()
    prev = jset_registry(reg)
    models = JModelRegistry(max_batch=8, max_latency_ms=2, queue_limit=64)
    try:
        models.deploy("m", path)
        router = JReplicaRouter(models, "m", replicas=2, max_replicas=4)
        x, y = spec["x"], spec["y"]
        net = JMultiLayerNetwork(_conf()).init()
        net.params_ = jax.tree_util.tree_map(jnp.asarray, spec["train"]["p0"])
        trainer = JTrainer(net, layout="dp4")
        it = ArrayDataSetIterator(x, y, 16, shuffle=False)
        trainer.fit(it, epochs=1)
        widths = [trainer._layout.spec.total()]
        arb = jarbiter.DevicePoolArbiter(router, jarbiter.TrainerGang(trainer), min_train=2,
                                         chips_per_flip=2, cooldown_s=0.0, serve_chips=2)
        snet = JMultiLayerNetwork.load(path)
        xs = x[:8]
        expected = np.asarray(snet.output(xs))
        stop, errors, served = threading.Event(), [], [0]

        def client():
            while not stop.is_set():
                try:
                    out, _ = models.predict_versioned("m", xs, timeout_s=30)
                    np.testing.assert_allclose(out, expected, rtol=SERVE_RTOL, atol=SERVE_ATOL)
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — the assertion
                    errors.append(repr(e))
                    return
        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            borrowed = arb.borrow()
            trainer.fit(it, epochs=1)
            widths.append(trainer._layout.spec.total())
            returned = arb.return_chips()
            trainer.fit(it, epochs=1)
            widths.append(trainer._layout.spec.total())
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        return {"borrowed": borrowed, "returned": returned, "widths": widths, "errors": errors,
                "served": served[0], "snapshot": arb.snapshot(),
                "replicas": (router.replicas, router.max_replicas),
                "series": {"borrows": reg.counter("tpudl_elastic_borrows_total").value,
                           "returns": reg.counter("tpudl_elastic_returns_total").value,
                           "flips": reg.histogram("tpudl_elastic_flip_seconds").count,
                           "pool": {o: reg.labeled_gauge(
                               "tpudl_elastic_pool_devices",
                               label_names=("owner",)).labeled_value(owner=o)
                               for o in ("serve", "train")}}}
    finally:
        models.close()
        jset_registry(prev)


@pytest.fixture(scope="module")
def live(tmp_path_factory, serve_zip):
    """(the reference's live cycle, each port rank's)."""
    workdir = str(tmp_path_factory.mktemp("arbiter_live"))
    spec_path = os.path.join(workdir, "spec.pkl")
    gang = GangHandle(functools.partial(workers.arbiter_live_worker, spec_path=spec_path), 4,
                      GANG_PORT, timeout=150.0)
    try:
        x, y = _data()
        train = JMultiLayerNetwork(_conf()).init()
        serve = JMultiLayerNetwork.load(serve_zip["jax"])
        spec = {"x": x, "y": y,
                "train": {"conf": _conf().to_json(), "p0": _np_tree(train.params_),
                          "s0": _np_tree(train.state_)},
                "serve": {"conf": _conf(dropout=False).to_json(),
                          "p0": _np_tree(serve.params_), "s0": _np_tree(serve.state_)}}
        with open(spec_path + ".tmp", "wb") as f:
            pickle.dump(spec, f)
        os.replace(spec_path + ".tmp", spec_path)
        ref = _jax_live(spec, serve_zip["jax"])
    except BaseException:
        gang.shutdown()
        raise
    return ref, sorted(gang.wait(), key=lambda r: r["pid"])


def test_borrow_and_return_under_live_serving_match_the_reference(live):
    ref, ranks = live
    assert ref["errors"] == [] and ref["served"] > 0
    r0 = ranks[0]
    assert r0["errors"] == [], r0["errors"][:3]
    assert r0["served"] > 0
    assert r0["borrowed"] is ref["borrowed"] is True
    assert r0["returned"] is ref["returned"] is True
    assert r0["replicas_after_borrow"] == (4, 6)
    assert r0["gang_width_after_borrow"] == 2
    assert r0["widths"] == ref["widths"] == [4, 2, 4]
    assert r0["snapshot"] == ref["snapshot"] == {"serve": 2, "train": 4, "borrowed": 0,
                                                 "total": 6}
    assert r0["replicas"] == ref["replicas"] == (2, 4)
    assert r0["series"] == ref["series"]
    # the gang's other ranks followed rank 0's width; 2 and 3 sat out the dp2 epoch
    for rank in ranks[1:]:
        assert rank["widths"] == [4, 2, 4]
        assert rank["parked"] == [rank["pid"] >= 2, False]
