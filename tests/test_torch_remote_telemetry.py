"""The port's cluster telemetry (``obs.remote``, ``obs.ui_server``) held
to the JAX package's.

- The same record streams, ingested by both packages' ``ClusterStore``,
  give the same ``summary()`` (apart from the liveness ages and the wall
  stamps of restarts): stragglers and skew, the producer's clock, a
  restart's generation reset, stale records dropped, malformed records
  skipped.
- A ``RemoteStatsRouter`` pushes over loopback to a ``UIServer``; its
  buffer is bounded and never blocks; a stalled coordinator never blocks
  ``fit``; garbage ingest is answered 400, never 500; every route and the
  ``get_instance`` contract.
- A gang of ``spawn_local_cluster(remote_ui=...)`` children reports in
  as ``w0..w2``, and the slowed one is flagged a straggler.
"""

import functools
import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.obs import remote as jremote
from deeplearning4j_tpu.obs.registry import MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.obs.registry import set_registry as jset_registry

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import remote
from deeplearning4j_tpu_torch.obs.registry import (MetricsRegistry, get_registry,
                                                   install_standard_metrics, set_registry)
from deeplearning4j_tpu_torch.obs.remote import ClusterStore, RemoteStatsRouter
from deeplearning4j_tpu_torch.obs.stats import InMemoryStatsStorage, StatsListener
from deeplearning4j_tpu_torch.obs.ui_server import UIServer
from deeplearning4j_tpu_torch.parallel import launcher, spawn_local_cluster
from deeplearning4j_tpu_torch.train import Trainer

GANG_PORT = 14911
TIME_FIELDS = ("liveness_age_s",)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.read().decode()


@pytest.fixture
def registry():
    prev = set_registry(MetricsRegistry())
    jprev = jset_registry(JMetricsRegistry())
    yield get_registry()
    set_registry(prev)
    jset_registry(jprev)


def _steps(worker_dt, n=6, start=0, stamp0=None, period=None):
    out = []
    for i in range(start, start + n):
        rec = {"type": "step", "iteration": i, "step_seconds": worker_dt, "score": 1.0 / (i + 1)}
        if stamp0 is not None:
            rec["time"] = stamp0 + (i - start) * period
        out.append(rec)
    return out


def _streams():
    """(name, [(worker, records, generation), ...]) ingest sequences."""
    t0 = 1.7e9
    return [
        ("straggler", [("w0", _steps(0.01), 0), ("w1", _steps(0.011), 0),
                       ("w2", _steps(0.009), 0), ("w3", _steps(0.05), 0)]),
        ("even", [(w, _steps(0.01), 0) for w in ("a", "b", "c")]),
        ("producer_clock", [("w", _steps(0.1, n=11, stamp0=t0, period=0.1), 0),
                            ("bare", _steps(0.05), 0)]),
        ("restart", [("w0", _steps(0.01), 0), ("w2", _steps(0.01), 0), ("w1", _steps(0.08), 0),
                     ("w1", [{"type": "resume", "iteration": 4}], 1),
                     ("w1", _steps(0.01, start=4), 1),
                     ("w1", [{"type": "step", "iteration": 99, "step_seconds": 0.5}], 0)]),
        ("malformed", [("w", [{"type": "step", "iteration": None},
                              {"type": "step", "iteration": 0, "step_seconds": 0.01},
                              {"type": "step", "iteration": "nope"},
                              {"type": "step", "iteration": 1, "step_seconds": 0.01,
                               "mfu": 0.25},
                              {"type": "stats", "iteration": 1, "params": {}},
                              {"type": "heartbeat"}, "not a dict"], 0)]),
    ]


def _comparable(summary):
    out = json.loads(json.dumps(summary))
    for w in out["workers"].values():
        for k in TIME_FIELDS:
            w.pop(k)
    for r in out["restarts"]:
        r.pop("time")
    return out


@pytest.mark.parametrize("name,stream", _streams(), ids=[n for n, _ in _streams()])
def test_cluster_store_summaries_equal_the_reference(registry, name, stream):
    got, want = ClusterStore(straggler_factor=2.0), jremote.ClusterStore(straggler_factor=2.0)
    counts = []
    for worker, records, generation in stream:
        counts.append((got.ingest(worker, records, generation=generation),
                       want.ingest(worker, records, generation=generation)))
    assert all(a == b for a, b in counts), counts
    assert _comparable(got.summary()) == _comparable(want.summary())
    for worker in got.workers():
        assert got.records_for(worker) == want.records_for(worker)
    if name == "straggler":
        assert got.summary()["workers"]["w3"]["straggler"] is True
        anomalies = registry.labeled_counter("tpudl_health_anomalies_total",
                                             label_names=("kind",))
        assert anomalies.labeled_value(kind="straggler") == 1.0
    if name == "restart":
        w1 = got.summary()["workers"]["w1"]
        assert (w1["generation"], w1["restarts"], w1["resumed_iteration"]) == (1, 1, 4)
        assert w1["median_step_ms"] == pytest.approx(10.0) and not w1["straggler"]
        assert registry.counter("tpudl_cluster_stale_records_total").value == 1
        html = got.render_html(refresh_seconds=0)
        assert "generation" in html and "Restarts" in html
    if name == "producer_clock":
        assert got.summary()["workers"]["w"]["steps_per_s"] == pytest.approx(10.0, rel=0.01)
        assert got.summary()["workers"]["bare"]["steps_per_s"] == pytest.approx(20.0, rel=0.01)


def test_gang_width_and_annotations_equal_the_reference(registry):
    got, want = ClusterStore(), jremote.ClusterStore()
    for store in (got, want):
        assert store.summary()["gang_width"] is None and "gang width" in store.render_html()
        store.set_gang_width(4)
        store.annotate("resize", "resize#1 grow 2→4 [committed]", direction="grow",
                       from_width=2, to_width=4, outcome="committed")
    a, b = (json.loads(json.dumps(store.summary())) for store in (got, want))
    for s in (a, b):
        for note in s["annotations"]:
            note.pop("time")
    assert a == b and a["gang_width"] == 4
    assert "[resize]" in got.render_html()


def test_loopback_round_trip(registry):
    """Records pushed through a router land in the coordinator's store and
    on /metrics with a worker label; the router's generation rides along."""
    server = UIServer(port=0)
    router = RemoteStatsRouter(server.url, worker="rt", flush_interval_s=0.02, generation=3)
    try:
        for i in range(4):
            router.put_event("step", iteration=i, step_seconds=0.01,
                             score=torch.tensor(0.5))       # a tensor, read on the router's thread
        router.put({"type": "stats", "iteration": 3, "params": {"0": {"norm": 1.0}}})
        deadline = time.monotonic() + 10
        summary = {}
        while time.monotonic() < deadline:
            summary = json.loads(_get(server.url + "cluster.json"))
            if summary["workers"].get("rt", {}).get("steps") == 4:
                break
            time.sleep(0.02)
        worker = summary["workers"]["rt"]
        assert worker["steps"] == 4 and worker["iteration"] == 3 and worker["score"] == 0.5
        assert worker["median_step_ms"] == pytest.approx(10.0) and worker["generation"] == 3
        assert worker["liveness_age_s"] < 10
        assert server.cluster.records_for("rt")
        body = _get(server.url + "metrics")
        assert 'tpudl_cluster_worker_iteration{worker="rt"} 3' in body
        assert 'tpudl_cluster_step_seconds_count{worker="rt"} 4' in body
        assert 'tpudl_cluster_worker_generation{worker="rt"} 3' in body
        assert router.dropped == 0 and router.pushed >= 5 and router.all() == []
    finally:
        router.close(timeout=2)
        server.stop()


def test_put_is_nonblocking_and_the_buffer_bounded(registry):
    """With no coordinator at all, producers never block and the buffer
    stays bounded (the oldest dropped, and counted)."""
    router = RemoteStatsRouter("http://127.0.0.1:9", worker="nb", flush_interval_s=10.0,
                               max_buffer=16, timeout_s=0.2)
    try:
        t0 = time.perf_counter()
        for i in range(5000):
            router.put_event("step", iteration=i)
        assert time.perf_counter() - t0 < 2.0
        assert len(router._buf) <= 16
        assert router.dropped >= 5000 - 16 - 64
    finally:
        router.close(timeout=5)


def test_a_stalled_coordinator_never_blocks_fit(registry):
    """A coordinator that never accepts leaves the steps' times alone (each
    wait on it would cost a 0.3 s timeout); the router closes cleanly with a
    bounded, counted loss."""
    from deeplearning4j_tpu_torch.data import DataSet
    net = workers.dense_net()
    trainer = Trainer(net)
    x, y = workers.global_batches()[0]
    batch = DataSet(x, y)
    gen = torch.Generator().manual_seed(0)

    def twenty_steps():
        t0 = time.perf_counter()
        for _ in range(20):
            trainer.step_batch(batch, gen)
        return time.perf_counter() - t0

    trainer.step_batch(batch, gen)
    alone = twenty_steps()
    blocked = socket.create_server(("127.0.0.1", 0), backlog=1)
    port = blocked.getsockname()[1]
    router = remote.install(f"http://127.0.0.1:{port}", worker="stalled",
                            flush_interval_s=0.02, max_buffer=8, timeout_s=0.3)
    try:
        wall = twenty_steps()
        assert wall < alone + 2.0, f"20 steps took {wall:.2f}s with a stalled coordinator " \
                                   f"({alone:.2f}s without one)"
        router.close(timeout=5.0)
        assert not router._thread.is_alive()
        assert router.dropped > 0
        assert router.dropped <= 20 + 8 + router.push_failures * 64
    finally:
        remote.close_router()
        blocked.close()
    assert remote.get_router() is None


def test_garbage_ingest_is_answered_400_and_never_500(registry):
    server = UIServer(port=0)
    base = server.url.rstrip("/")

    def post(path, data):
        req = urllib.request.Request(base + path, data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        for bad in (b"not json", b"{}", b'{"worker": "w", "records": 3}', b"[1, 2]",
                    b'{"worker": "w", "generation": "x"}'):
            assert post("/remote/stats", bad)[0] == 400, bad
        assert post("/remote/nope", b"{}")[0] == 404
        code, body = post("/remote/stats", json.dumps({"worker": "w", "records": [
            {"type": "step", "iteration": None}, {"type": "step", "iteration": 3}]}).encode())
        assert code == 200 and body["ok"] == 1
    finally:
        server.stop()


def test_ui_server_routes_and_the_singleton_contract(registry):
    storage = InMemoryStatsStorage()
    net = workers.dense_net()
    trainer = Trainer(net, listeners=[StatsListener(storage, frequency=1)])
    x, y = workers.global_batches()[0]
    from deeplearning4j_tpu_torch.data import DataSet
    for i in range(2):
        trainer.step_batch(DataSet(x, y), torch.Generator().manual_seed(i))
    server = UIServer(port=0)
    try:
        assert server.host == "127.0.0.1" and server.url.startswith("http://127.0.0.1:")
        assert "No StatsStorage attached" in _get(server.url)
        server.attach(storage)
        server.attach(storage)              # once
        assert "<html" in _get(server.url) and "Training session 0" in _get(server.url + "train/0")
        records = json.loads(_get(server.url + "data/0.json"))
        assert [r.get("type") for r in records].count("stats") == 2
        assert json.loads(_get(server.url + "healthz")) == {"status": "ok"}
        assert "tpudl_train_steps_total" in _get(server.url + "metrics")
        assert "Cluster telemetry" in _get(server.url + "cluster")
        assert json.loads(_get(server.url + "cluster.json"))["n_workers"] == 0
        for missing in ("data/1.json", "train/5", "data/x.json"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(server.url + missing)
            assert err.value.code == 404
        server.detach(storage)
        with pytest.raises(urllib.error.HTTPError):
            _get(server.url + "data/0.json")
    finally:
        server.stop()
    wild = UIServer(port=0, host="0.0.0.0")
    try:
        assert wild.url.startswith("http://127.0.0.1:")
    finally:
        wild.stop()
    inst = UIServer.get_instance()
    try:
        assert UIServer.get_instance() is inst and UIServer.get_instance(port=inst.port) is inst
        with pytest.raises(RuntimeError, match="already running"):
            UIServer.get_instance(port=inst.port + 1)
    finally:
        inst.stop()
    assert UIServer._instance is None
    for name in ("remote", "ClusterStore", "RemoteStatsRouter", "UIServer"):
        assert name in obs.__all__


def test_router_defaults_come_from_the_launcher_context(registry):
    assert remote.install_from_context() is None         # no endpoint outside a gang
    prev = launcher.set_child_context(launcher.ChildContext(
        worker="w4", generation=5, remote_ui="http://127.0.0.1:9"))
    try:
        router = remote.install_from_context()
        assert (router.worker, router.generation, router.endpoint) == (
            "w4", 5, "http://127.0.0.1:9")
        assert remote.get_router() is router
    finally:
        remote.close_router(timeout=1)
        launcher.set_child_context(prev)


def test_a_gang_reports_in_and_its_slowed_worker_is_a_straggler(registry):
    """spawn_local_cluster(remote_ui=...): every child pushes its steps as
    w<pid>; the worker slowed by 1 s a step (a CPU step of the others takes
    milliseconds, a few hundred under a loaded host) is flagged from the
    federated telemetry alone."""
    install_standard_metrics()
    server = UIServer(port=0)
    try:
        fn = functools.partial(workers.telemetry_train_worker, steps=5, straggler_pid=0,
                               delay_s=1.0)
        results = spawn_local_cluster(fn, n_processes=3, port=GANG_PORT, timeout=120.0,
                                      remote_ui=server.url)
        assert sorted(r["worker"] for r in results) == ["w0", "w1", "w2"]
        summary = json.loads(_get(server.url + "cluster.json"))
        gang = summary["workers"]
        assert sorted(gang) == ["w0", "w1", "w2"]
        for name, w in gang.items():
            assert w["steps"] == 5 and w["median_step_ms"] is not None, (name, w)
        assert gang["w0"]["straggler"] is True
        assert not gang["w1"]["straggler"] and not gang["w2"]["straggler"]
        body = _get(server.url + "metrics")
        for w in gang:
            assert f'tpudl_cluster_worker_iteration{{worker="{w}"}} 4' in body
        assert np.isfinite(gang["w1"]["score"])
    finally:
        server.stop()
