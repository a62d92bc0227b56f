"""The port's serving stack held to the JAX package's on the CPU.

Two small nets are made and saved by the JAX package's ``write_model``
(``save_updater=False``): an MLP (8 -> dense 16 relu -> softmax 4) and one
whose first layer is an ``EmbeddingLayer`` (a vocabulary of 20 rows of 8,
then dense 16 and softmax 4).  The same zips are deployed in both
packages' ``ModelRegistry`` (the port's with ``device="cpu"``), full
precision and int8, and served by both packages' ``ModelServer``:

- HTTP answers agree at 1e-6 in probabilities for full precision, and at
  ``test_torch_vgg_int8_serve.py``'s ``F32_TOL`` (1e-5) for int8: both
  compute in f32, in other summation orders; the int8 weights are equal;
- the three ``tpudl_serve_quantized_*`` gauges agree: bytes and ratio
  exactly, ``max_abs_err`` to two f32 ulps at 1.0 (2^-22): it is a max of
  differences of probabilities in [0, 1] from two f32 forwards, so each
  side carries the rounding of those outputs, ~1e-5 of the reading here,
  and a limit of 1e-6 of the reading would be below the arithmetic's;
- versions and history after deploy, deploy, rollback and undeploy, the
  ``/v1/models`` rows, and the error statuses and bodies agree, apart
  from the ``deployed_at`` wall-clock timestamps;
- the router's lane and quota decisions and the autoscaler's decisions
  agree on scripted sequences (a scripted clock and queue fill);
- ``buckets=``, ``bucketing=False`` and ``block=True`` serve the same
  buckets and answers in both engines.
"""

import http.client
import json
import threading
import types

import numpy as np
import pytest

from deeplearning4j_tpu.io.model_serializer import write_model as jwrite_model
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import DenseLayer as JDenseLayer
from deeplearning4j_tpu.nn.layers import EmbeddingLayer as JEmbeddingLayer
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import flight_recorder as jflight
from deeplearning4j_tpu.obs import registry as jregistry
from deeplearning4j_tpu import serve as jserve
from deeplearning4j_tpu.serve import autoscale as jautoscale
from deeplearning4j_tpu.serve import router as jrouter
from deeplearning4j_tpu.train import Sgd as JSgd

from deeplearning4j_tpu_torch.obs import flight_recorder, registry
from deeplearning4j_tpu_torch import serve
from deeplearning4j_tpu_torch.serve import autoscale, router

SEED = 20261018
N_IN, N_OUT, VOCAB = 8, 4, 20
FP_TOL = 1e-6
INT8_TOL = 1e-5      # test_torch_vgg_int8_serve.F32_TOL
ERR_ATOL = 2.0 ** -22


def _jnet(seed: int, embedding: bool):
    b = JNeuralNetConfiguration.builder().seed(seed).updater(JSgd(0.1)).list()
    if embedding:
        b = b.layer(JEmbeddingLayer(n_in=VOCAB, n_out=8))
    b = (b.layer(JDenseLayer(n_out=16, activation="relu"))
         .layer(JOutputLayer(n_out=N_OUT, activation="softmax", loss="mcxent")))
    b = b.set_input_type(JInputType.feed_forward(1 if embedding else N_IN))
    return JMultiLayerNetwork(b.build()).init()


def _inputs(rng, n: int, embedding: bool) -> np.ndarray:
    if embedding:
        return rng.integers(0, VOCAB, size=(n, 1)).astype(np.float32)
    return rng.normal(size=(n, N_IN)).astype(np.float32)


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("zips")
    out = {}
    for kind, emb in (("mlp", False), ("emb", True)):
        for v, seed in ((1, SEED), (2, SEED + 1)):
            path = str(d / f"{kind}_v{v}.zip")
            jwrite_model(_jnet(seed, emb), path, save_updater=False)
            out[kind, v] = path
    return out


@pytest.fixture
def metrics():
    """Fresh process-wide metrics in both packages, restored after."""
    prev = registry.set_registry(registry.MetricsRegistry())
    jprev = jregistry.set_registry(jregistry.MetricsRegistry())
    yield registry.get_registry(), jregistry.get_registry()
    registry.set_registry(prev)
    jregistry.set_registry(jprev)


def _registries(**kw):
    return serve.ModelRegistry(device="cpu", **kw), jserve.ModelRegistry(**kw)


def _req(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    raw = r.read().decode()
    conn.close()
    try:
        return r.status, json.loads(raw)
    except ValueError:
        return r.status, raw


def _strip(obj):
    """Drop wall-clock timestamps (``deployed_at``) at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "deployed_at"}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    return obj


@pytest.mark.parametrize("kind", ["mlp", "emb"])
@pytest.mark.parametrize("precision", [None, "int8"])
def test_http_answers_and_quantized_gauges_agree(zips, metrics, kind, precision):
    rng = np.random.default_rng(SEED + (kind == "emb"))
    emb = kind == "emb"
    calib = [_inputs(rng, 16, emb) for _ in range(2)] if precision else None
    ours, theirs = _registries(max_batch=8, max_latency_ms=2)
    ours.deploy("m", zips[kind, 1], precision=precision, calibration=calib)
    theirs.deploy("m", zips[kind, 1], precision=precision, calibration=calib)
    try:
        with serve.ModelServer(ours) as a, jserve.ModelServer(theirs) as b:
            for n in (1, 3, 2, 4):
                body = json.dumps({"instances": _inputs(rng, n, emb).tolist()})
                (sa, ra), (sb, rb) = (_req(s.port, "POST", "/v1/models/m:predict", body)
                                      for s in (a, b))
                assert sa == sb == 200 and ra["model_version"] == rb["model_version"] == 1
                got, want = np.asarray(ra["predictions"]), np.asarray(rb["predictions"])
                assert got.shape == want.shape == (n, N_OUT)
                tol = INT8_TOL if precision else FP_TOL
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            ta = _req(a.port, "GET", "/metrics")[1]
            assert 'tpudl_serve_requests_total{status="ok"} 4' in ta
            assert 'tpudl_serve_model_version{model="m"} 1' in ta
    finally:
        ours.close()
        theirs.close()
    if precision:
        ma, mb = metrics
        for name in ("tpudl_serve_quantized_weight_bytes",
                     "tpudl_serve_quantized_compression_ratio"):
            assert ma.gauge(name).value == mb.gauge(name).value
        ea = ma.gauge("tpudl_serve_quantized_max_abs_err").value
        eb = mb.gauge("tpudl_serve_quantized_max_abs_err").value
        assert abs(ea - eb) <= ERR_ATOL and eb > 0
        assert ma.counter("tpudl_serve_quantized_batches_total").value == \
            mb.counter("tpudl_serve_quantized_batches_total").value > 0


def test_versions_and_history_match(zips, metrics):
    ours, theirs = _registries(max_batch=4, max_latency_ms=2)
    rows = []
    for reg in (ours, theirs):
        seen = []
        reg.deploy("m", zips["mlp", 1])
        seen.append(reg.models())
        reg.deploy("m", zips["mlp", 2], precision="int8")
        seen.append(reg.models())
        back = reg.rollback("m")
        seen.append([back.to_dict(), reg.models(), reg.previous_version("m").to_dict()])
        reg.deploy("e", zips["emb", 1])
        seen.append(reg.names())
        reg.undeploy("m")
        seen.append([reg.names(), reg.models()])
        with pytest.raises(LookupError, match="no previous version"):
            reg.rollback("e")
        with pytest.raises(KeyError, match="no model deployed"):
            reg.get("m")
        with pytest.raises(ValueError, match="unknown deploy precision"):
            reg.deploy("e", zips["emb", 1], precision="fp8")
        reg.close()
        seen.append(reg.names())
        rows.append(_strip(seen))
    assert rows[0] == rows[1]
    assert rows[0][2][0]["version"] == 3 and rows[0][2][0]["precision"] == "bf16"
    a, b = metrics
    assert a.render_prometheus().count("tpudl_serve_model_version") == \
        b.render_prometheus().count("tpudl_serve_model_version")


def test_models_routes_and_error_bodies_match(zips, metrics, tmp_path):
    ours, theirs = _registries(max_batch=4, max_latency_ms=2)
    x = json.dumps({"instances": np.zeros((1, N_IN)).tolist()})
    bad_rows = json.dumps({"instances": [[1.0, 2.0], [3.0]]})
    calls = [("GET", "/healthz", None), ("GET", "/v1/models", None),
             ("GET", "/v1/models/m", None), ("GET", "/v1/models/nope", None),
             ("GET", "/nowhere", None), ("POST", "/nowhere", x),
             ("POST", "/v1/models/nope:predict", x), ("POST", "/v1/models/m:predict", "{broken"),
             ("POST", "/v1/models/m:predict", json.dumps({"inputs": [1]})),
             ("POST", "/v1/models/m:predict", bad_rows),
             ("POST", "/v1/models/m:feedback", json.dumps({"instances": [[1]]})),
             ("POST", "/v1/models/m:feedback",
              json.dumps({"instances": [[1.0], [2.0]], "labels": [[1.0]]})),
             ("POST", "/v1/models/nope:feedback",
              json.dumps({"instances": [[1.0]], "labels": [[1.0]]})),
             ("POST", "/v1/models/m:feedback",
              json.dumps({"instances": [[1.0]], "labels": [[1.0]]}))]
    out = []
    for reg, mod in ((ours, serve), (theirs, jserve)):
        reg.deploy("m", zips["mlp", 1])
        with mod.ModelServer(reg) as srv:
            out.append([_req(srv.port, m, p, body, {"X-Trace-Id": "t1"})
                        for m, p, body in calls])
        reg.close()
    ours_r, theirs_r = (_strip(o) for o in out)
    assert [s for s, _ in ours_r] == [s for s, _ in theirs_r] == \
        [200, 200, 200, 404, 404, 404, 404, 400, 400, 400, 400, 400, 404, 503]
    for i, ((_, ba), (_, bb)) in enumerate(zip(ours_r, theirs_r)):
        if i != 9:      # ragged rows: the two array libraries word the error apart
            assert ba == bb, calls[i]
    a, b = metrics
    for name in ("tpudl_serve_feedback_rejected_total", "tpudl_serve_feedback_accepted_total"):
        assert a.counter(name).value == b.counter(name).value


def _clock():
    t = {"now": 100.0}
    return t, types.SimpleNamespace(monotonic=lambda: t["now"],
                                    perf_counter=lambda: t["now"])


def test_router_lane_and_quota_decisions_match(zips, metrics, monkeypatch):
    fills = [0.0, 0.3, 0.5, 0.7, 0.95, 1.0, 0.1, 0.6, 0.0, 0.85]
    tenants = ["a", "a", "a", "b", "a", None, "b", "b", "a", "c"]
    lanes = ["hi", "lo", None, "lo", "hi", "lo", "mid", "hi", "lo", "nope"]
    steps = [0.0, 0.1, 0.1, 0.5, 0.0, 2.0, 0.0, 0.0, 1.5, 0.2]
    x = np.zeros((1, N_IN), np.float32)
    results = []
    for reg, rmod, mod in ((None, router, serve), (None, jrouter, jserve)):
        t, fake = _clock()
        monkeypatch.setattr(rmod, "time", fake)
        reg = mod.ModelRegistry(**({"device": "cpu"} if mod is serve else {}),
                                max_batch=4, max_latency_ms=1)
        reg.deploy("m", zips["mlp", 1])
        admission = rmod.AdmissionControl(
            lanes=[rmod.Lane("hi", 0, 1.0), rmod.Lane("mid", 1, 0.8), rmod.Lane("lo", 2, 0.5)],
            default_lane="mid",
            quotas={"a": rmod.TenantQuota(rate=2.0, burst=2.0)},
            default_quota=rmod.TenantQuota(rate=1.0, burst=1.0))
        rt = rmod.ReplicaRouter(reg, "m", replicas=2, admission=admission)
        with pytest.raises(mod.RoutedModelError, match="router-managed"):
            reg.deploy("m", zips["mlp", 2])
        script = iter(fills)
        monkeypatch.setattr(rt, "queue_fill", lambda: next(script))
        seen = []
        for tenant, lane, dt in zip(tenants, lanes, steps):
            t["now"] += dt
            try:
                out, version = rt.predict_versioned(x, tenant=tenant, lane=lane, timeout_s=60)
                seen.append(("ok", version, out.shape))
            except mod.Overloaded as e:
                seen.append((type(e).__name__, str(e)))
        seen.append([(r["id"], r["version"], r["ready"]) for r in rt.replica_stats()])
        entry = rt.deploy(zips["mlp", 2])
        seen.append((entry.version, [r["version"] for r in rt.replica_stats()]))
        seen.append(_strip(reg.models()))
        seen.append(rt.rollback().version)
        reg.close()
        seen.append(reg.names())
        results.append(seen)
        monkeypatch.undo()
    assert results[0] == results[1]
    assert [s[0] for s in results[0][:10]].count("QuotaExceeded") >= 2
    assert [s[0] for s in results[0][:10]].count("Overloaded") >= 2


class _ScriptedRouter:
    """The surface the autoscaler reads, driven by a script once armed."""

    name = "scripted"

    def __init__(self, fills):
        self.armed = False
        self.fills = iter(fills)
        self.replicas, self.lo, self.hi = 1, 1, 3
        self.log = []

    def heal(self):
        return 0

    def queue_fill(self):
        return next(self.fills) if self.armed else 0.0

    def add_replica(self):
        if not self.armed or self.replicas >= self.hi:
            return False
        self.replicas += 1
        return True

    def retire_replica(self):
        if not self.armed or self.replicas <= self.lo:
            return False
        self.replicas -= 1
        return True


@pytest.mark.parametrize("cooldowns", [(0.0, 0.0), (0.3, 1.0)])
def test_autoscaler_decisions_match(monkeypatch, cooldowns):
    rng = np.random.default_rng(SEED + 3)
    fills = [float(f) for f in np.round(rng.choice([0.0, 0.01, 0.1, 0.3, 0.8], size=40), 2)]
    steps = [float(s) for s in rng.choice([0.05, 0.2, 0.6], size=40)]
    out = []
    for mod in (autoscale, jautoscale):
        t, fake = _clock()
        monkeypatch.setattr(mod, "time", fake)
        fake_router = _ScriptedRouter(fills)
        cfg = mod.AutoscaleConfig(scale_up_at=0.25, scale_down_at=0.02, poll_s=3600.0,
                                  up_cooldown_s=cooldowns[0], down_cooldown_s=cooldowns[1],
                                  window=3)
        scaler = mod.Autoscaler(fake_router, cfg)
        scaler.close()          # the loop's first poll ran unarmed (no scaling) or not at all
        fake_router.armed = True
        sizes = []
        for dt in steps:
            t["now"] += dt
            scaler.step()
            sizes.append(fake_router.replicas)
        out.append(sizes)
        monkeypatch.undo()
    assert out[0] == out[1]
    sizes = out[0]
    assert any(b > a for a, b in zip(sizes, sizes[1:])) and \
        any(b < a for a, b in zip(sizes, sizes[1:]))


def _bucket_log(engine_cls, net, kw, sizes, rng, recorder):
    recorder.get_recorder().clear()
    answers = []
    with engine_cls(net, name="b", max_batch=8, max_latency_ms=1, **kw) as eng:
        for n in sizes:
            answers.append(eng.predict(rng.normal(size=(n, N_IN)).astype(np.float32),
                                       timeout_s=60))
        buckets = eng.buckets
    served = [e["bucket"] for e in recorder.get_recorder().events() if e["kind"] == "serve"]
    recorder.get_recorder().clear()
    return buckets, served, answers


@pytest.mark.parametrize("kw", [{"buckets": (2, 8)}, {"bucketing": False}, {}],
                         ids=["buckets", "no_bucketing", "default"])
def test_engine_buckets_match(zips, metrics, kw):
    from deeplearning4j_tpu.io.model_serializer import restore_model as jrestore
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    sizes = [1, 3, 2, 8, 5, 11, 4]
    ours = _bucket_log(serve.InferenceEngine, restore_model(zips["mlp", 1], device="cpu"), kw,
                       sizes, np.random.default_rng(SEED), flight_recorder)
    theirs = _bucket_log(jserve.InferenceEngine, jrestore(zips["mlp", 1]), kw, sizes,
                         np.random.default_rng(SEED), jflight)
    assert ours[0] == theirs[0] and ours[1] == theirs[1]
    for a, b in zip(ours[2], theirs[2], strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=FP_TOL)
    if kw.get("bucketing") is False:
        assert ours[1] == sizes
    a, b = metrics
    assert a.counter("tpudl_serve_batches_total").value == len(sizes)
    assert a.render_prometheus().count("\n") > 0 and \
        a.labeled_counter("tpudl_serve_requests_total").labeled_value(status="ok") == len(sizes)


def test_blocking_submit_waits_for_room(zips, metrics):
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    net = restore_model(zips["mlp", 1], device="cpu")
    gate, forward = threading.Event(), net._forward

    def held(*a, **k):
        gate.wait(timeout=30)
        return forward(*a, **k)

    net._forward = held
    x = np.ones((1, N_IN), np.float32)
    with serve.InferenceEngine(net, max_batch=1, max_latency_ms=1, queue_limit=1) as eng:
        first = eng.submit(x)
        futures = []
        shed = 0
        for _ in range(3):
            try:
                futures.append(eng.submit(x))
            except serve.Overloaded:
                shed += 1
        waiter = threading.Thread(target=lambda: futures.append(
            eng.submit(x, block=True, timeout_s=30)))
        waiter.start()
        gate.set()
        waiter.join(timeout=30)
        assert not waiter.is_alive()
        outs = [first.result(timeout=30)] + [f.result(timeout=30) for f in futures]
    assert shed >= 1 and len(outs) == 5 - shed
    assert all(np.array_equal(o, outs[0]) for o in outs)
    a, _ = metrics
    assert a.counter("tpudl_serve_shed_total").value == shed


def test_bake_artifacts_raises_and_names_the_store(zips, metrics):
    reg = serve.ModelRegistry(device="cpu")
    with pytest.raises(NotImplementedError, match="artifact_store"):
        reg.deploy("m", zips["mlp", 1], bake_artifacts=True)
    assert reg.names() == []
    eng_reg = serve.ModelRegistry(device="cpu")
    eng_reg.deploy("m", zips["mlp", 1])
    engine = eng_reg.get("m").engine
    assert engine.compiled_programs == 0 and engine.warm_programs == 0 and engine.healthy
    assert engine.queue_depth == 0
    eng_reg.close()
