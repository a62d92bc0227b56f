"""The port's feedback spool, replay source, eval gate and online loop
held to the JAX package's on the CPU.

- A spool written by either package's ``FeedbackLog`` is read by the
  other's ``read_records`` (records equal, the timestamps included), and
  both packages' ``FeedbackSource`` give the same batches of it (fifo,
  reservoir and recency sampling; bit-equal float32 arrays).
- ``EvalGate`` scores and ``GatedDeployer`` decisions on zips the JAX
  package trained and saved: a deploy, a regression refusal, a truncated
  candidate refused before scoring, and an int8 candidate quantized
  before it is scored.  Accuracies are held exactly (the holdout's
  argmaxes sit far from ties), eval losses to 1e-6 of their value (f32
  forwards in two summation orders).
- ``OnlineTrainer.run_once`` on the port's registry (``device="cpu"``)
  fine-tunes on a JAX-written spool, passes the gate and deploys version
  2, as the JAX package's loop does on the same directories.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import DenseLayer as JDenseLayer
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import online as jonline
from deeplearning4j_tpu import serve as jserve
from deeplearning4j_tpu.obs import registry as jregistry
from deeplearning4j_tpu.serve import feedback as jfeedback
from deeplearning4j_tpu.train import Adam as JAdam

from deeplearning4j_tpu_torch import online, serve
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.obs import registry
from deeplearning4j_tpu_torch.serve import feedback

SEED = 20261018
N_IN, N_OUT = 6, 3
LOSS_RTOL = 1e-6
_TEACHER = np.random.default_rng(SEED).normal(size=(N_IN, N_OUT)).astype(np.float32)


def _xy(n, seed):
    x = np.random.default_rng(seed).normal(size=(n, N_IN)).astype(np.float32)
    return x, np.eye(N_OUT, dtype=np.float32)[np.argmax(x @ _TEACHER, -1)]


def _holdouts(seed=77, n=96):
    x, y = _xy(n, seed)
    return ListDataSetIterator([DataSet(x, y)]), JListDataSetIterator([JDataSet(x, y)])


def _jnet(seed):
    return JMultiLayerNetwork(
        JNeuralNetConfiguration.builder().seed(seed).updater(JAdam(1e-2)).list()
        .layer(JDenseLayer(n_out=16, activation="tanh"))
        .layer(JOutputLayer(n_out=N_OUT, activation="softmax", loss="mcxent"))
        .set_input_type(JInputType.feed_forward(N_IN)).build()).init()


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("gate")
    out = {}
    weak = _jnet(1)
    out["weak"] = str(d / "weak.zip")
    weak.save(out["weak"])
    strong = _jnet(2)
    x, y = _xy(96, 2)
    strong.fit(JListDataSetIterator([JDataSet(x[i:i + 16], y[i:i + 16])
                                     for i in range(0, 96, 16)]), epochs=3)
    out["strong"] = str(d / "strong.zip")
    strong.save(out["strong"])
    raw = open(out["strong"], "rb").read()
    out["torn"] = str(d / "torn.zip")
    with open(out["torn"], "wb") as f:
        f.write(raw[:len(raw) - 200])
    return out


@pytest.fixture
def metrics():
    prev = registry.set_registry(registry.MetricsRegistry())
    jprev = jregistry.set_registry(jregistry.MetricsRegistry())
    yield registry.get_registry(), jregistry.get_registry()
    registry.set_registry(prev)
    jregistry.set_registry(jprev)


def _write_spool(mod, directory, n, seed):
    log = mod.FeedbackLog(directory, max_records_per_segment=16)
    x, y = _xy(n, seed)
    w = np.linspace(0.5, 1.5, n)
    assert log.extend(x, y, weights=list(w), trace_id="t", model="m") == n
    assert log.flush()
    log.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spools_are_read_by_either_package(tmp_path, metrics, writer):
    d = str(tmp_path / "spool")
    _write_spool(feedback if writer == "port" else jfeedback, d, 40, SEED)
    ours, theirs = feedback.read_records(d, 5, 37), jfeedback.read_records(d, 5, 37)
    assert ours == theirs and [i for i, _ in ours] == list(range(5, 37))
    assert feedback.record_count(d) == jfeedback.record_count(d) == 40
    assert [os.path.basename(p) for _, p in feedback.list_segments(d)] == \
        ["spool-000000000000.jsonl", "spool-000000000016.jsonl", "spool-000000000032.jsonl"]
    x, _ = _xy(40, SEED)
    np.testing.assert_array_equal(np.asarray([r["x"] for _, r in ours], np.float32), x[5:37])


@pytest.mark.parametrize("sampling", ["fifo", "reservoir", "recency"])
def test_feedback_sources_give_the_same_batches(tmp_path, metrics, sampling):
    d = str(tmp_path / "spool")
    _write_spool(jfeedback, d, 50, SEED + 1)
    batches = []
    for mod in (online, jonline):
        src = mod.FeedbackSource(d, batch_size=8, max_records_per_round=24,
                                 sampling=sampling, seed=3, weighted=True)
        seen = []
        for r in range(2):
            src.pin_round(r)
            seen.append([(np.asarray(b.features), np.asarray(b.labels),
                          np.asarray(b.labels_mask)) for b in src])
        batches.append((seen, src.consumed(), src.pending(), len(src)))
    (ours, *o_counts), (theirs, *t_counts) = batches
    assert o_counts == t_counts
    for ra, rb in zip(ours, theirs, strict=True):
        assert len(ra) == len(rb) > 0
        for a, b in zip(ra, rb):
            for ta, tb in zip(a, b):
                np.testing.assert_array_equal(ta, tb)


def _decision(d):
    out = d.to_dict()
    out.pop("gate_seconds")
    out["reason"] = out["reason"].split(":")[0]
    return out


def _gate_run(mod, smod, reg_kw, holdout, zips, metric):
    reg = smod.ModelRegistry(**reg_kw, max_batch=8, max_latency_ms=1)
    rng = np.random.default_rng(SEED + 5)
    calib = [rng.normal(size=(16, N_IN)).astype(np.float32) for _ in range(2)]
    try:
        reg.deploy("m", zips["weak"])
        deployer = mod.GatedDeployer(reg, mod.EvalGate(holdout, metric=metric))
        return [deployer.deploy_if_better("m", zips["strong"]),
                deployer.deploy_if_better("m", zips["weak"]),
                deployer.deploy_if_better("m", zips["torn"]),
                deployer.deploy_if_better("m", zips["strong"], precision="int8",
                                          calibration=calib),
                reg.get("m").to_dict()]
    finally:
        reg.close()


@pytest.mark.parametrize("metric", ["accuracy", "loss"])
def test_gate_decisions_match(zips, metrics, metric):
    hold, jhold = _holdouts()
    ours = _gate_run(online, serve, {"device": "cpu"}, hold, zips, metric)
    theirs = _gate_run(jonline, jserve, {}, jhold, zips, metric)
    assert [d.deploy for d in ours[:4]] == [d.deploy for d in theirs[:4]] == \
        [True, False, False, True]
    for a, b in zip(ours[:4], theirs[:4]):
        da, db = _decision(a), _decision(b)
        for key in ("candidate_score", "incumbent_score", "delta"):
            va, vb = da.pop(key), db.pop(key)
            if metric == "accuracy" or not np.isfinite(vb):
                assert va == vb or (np.isnan(va) and np.isnan(vb)), key
            else:
                assert abs(va - vb) <= LOSS_RTOL * max(abs(vb), 1e-3), key
        assert da == db
    assert "failed verification" in ours[2].reason
    assert ours[4]["version"] == theirs[4]["version"] == 3
    assert ours[4]["precision"] == theirs[4]["precision"] == "int8"
    a, b = metrics
    for name in ("tpudl_online_candidates_total", "tpudl_online_deploys_total",
                 "tpudl_online_refusals_total"):
        assert a.counter(name).value == b.counter(name).value


def test_deploy_watch_rolls_back_on_an_error_burst(zips, metrics):
    reg = serve.ModelRegistry(device="cpu", max_batch=8, max_latency_ms=1)
    try:
        reg.deploy("m", zips["weak"])
        reg.deploy("m", zips["strong"])
        a, _ = metrics
        watch = online.DeployWatch(reg, "m", window_s=0.5, poll_s=0.02, min_requests=4)
        requests = a.labeled_counter("tpudl_serve_requests_total")
        before = watch._snapshot()
        requests.inc(3, status="error")
        requests.inc(1, status="ok")
        assert "error rate 75%" in watch._regression(before)
        verdict = watch.run()      # the burst predates this window: clean
        assert not verdict["rolled_back"] and reg.get("m").version == 2
        requests.inc(4, status="error")
        import threading
        timer = threading.Timer(0.05, lambda: requests.inc(4, status="error"))
        timer.start()
        verdict = watch.run()
        timer.join()
        assert verdict["rolled_back"] and verdict["restored_version"] == 3
        assert reg.get("m").path == zips["weak"]
        assert a.counter("tpudl_online_rollbacks_total").value == 1
    finally:
        reg.close()


def _loop_run(mod, smod, reg_kw, holdout, base, spool, workdir):
    reg = smod.ModelRegistry(**reg_kw, max_batch=8, max_latency_ms=1)
    reg.deploy("m", base)
    try:
        trainer = mod.OnlineTrainer(
            reg, "m", spool, workdir, mod.EvalGate(holdout, metric="accuracy", min_delta=0.5),
            base, config=mod.OnlineConfig(min_records=48, batch_size=8,
                                          max_records_per_round=48,
                                          checkpoint_every_n_iterations=2))
        first = trainer.run_once()
        second = trainer.run_once()
        return (first, second, reg.get("m").version, trainer.next_round(),
                "lineage" in trainer.lineage_head())
    finally:
        reg.close()


def test_online_round_deploys_version_two(tmp_path, zips, metrics):
    import shutil
    spool = str(tmp_path / "spool")
    _write_spool(jfeedback, spool, 48, SEED + 11)
    shutil.copytree(spool, str(tmp_path / "spool_jax"))   # round stamps live in the spool
    hold, jhold = _holdouts()
    ours = _loop_run(online, serve, {"device": "cpu"}, hold, zips["weak"], spool,
                     str(tmp_path / "ours"))
    theirs = _loop_run(jonline, jserve, {}, jhold, zips["weak"], str(tmp_path / "spool_jax"),
                       str(tmp_path / "theirs"))
    assert ours[0]["status"] == theirs[0]["status"] == "deployed"
    assert ours[0]["window"] == theirs[0]["window"]
    assert ours[0]["gate"]["version"] == theirs[0]["gate"]["version"] == 2
    assert ours[1]["status"] == theirs[1]["status"] == "skipped"
    assert ours[2:] == theirs[2:] == (2, 1, True)
    a, _ = metrics
    assert a.counter("tpudl_online_deploys_total").value == 1
    assert a.gauge("tpudl_online_spool_depth").value == 0
