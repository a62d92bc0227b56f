"""The port's device feeder, bucketing helpers and listener bus held to the
JAX package's ``data/device_pipeline.py`` and ``obs/listeners.py``, and
``BertForMaskedLM.fit`` through them held to its own train step run by
hand.  The feeder runs on the CPU here (plain tensors); its CUDA staging
(page-locked ring, side stream, events) runs in ``chip_smoke.py``'s
phase 20."""

import logging
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import device_pipeline as jdp
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayDataSetIterator
from deeplearning4j_tpu.obs import listeners as jlisteners

from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.data import device_pipeline as dp
from deeplearning4j_tpu_torch.models import bert
from deeplearning4j_tpu_torch.obs import listeners
from deeplearning4j_tpu_torch.train.updaters import Adam, tree_leaves


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


# ----------------------------------------------------------- bucketing
@pytest.mark.parametrize("n,buckets", [(7, (32, 64)), (33, (32, 64)), (100, (32, 64)),
                                       (5, ()), (64, (64,))])
def test_choose_bucket_matches_jax(n, buckets):
    assert dp.choose_bucket(n, buckets) == jdp.choose_bucket(n, buckets)


@pytest.mark.parametrize("shape,real,total", [((7, 3), 5, 7), ((4, 9, 3), 2, 4), ((3, 2), 3, 3)])
def test_synth_example_mask_matches_jax(shape, real, total):
    got = dp.synth_example_mask(np.zeros(shape), real, total)
    want = jdp.synth_example_mask(np.zeros(shape), real, total)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("masks", ["none", "labels", "both"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_to_bucket_matches_jax(masks, as_tensor):
    x, y = _data(7)
    lm = np.ones(7, np.float32) if masks != "none" else None
    fm = np.ones((7, 5), np.float32) if masks == "both" else None
    want, wn = jdp.pad_to_bucket(JDataSet(x, y, fm, lm), 16)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    got, n = dp.pad_to_bucket(DataSet(conv(x), conv(y), None if fm is None else conv(fm),
                                      None if lm is None else conv(lm)), 16)
    assert n == wn == 7
    for f in ("features", "labels", "features_mask", "labels_mask"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert np.array_equal(_np(g), np.asarray(w)), f


def test_pad_segment_and_ensure_feature_mask_match_jax():
    seg = DataSet(np.ones((2, 3, 5), np.float32), np.ones((2, 3, 4), np.float32),
                  np.ones((2, 3), np.float32), np.ones((2, 3), np.float32))
    jseg = JDataSet(seg.features, seg.labels, seg.features_mask, seg.labels_mask)
    got, want = dp.pad_segment(seg, 8), jdp.pad_segment(jseg, 8)
    for f in ("features", "labels", "features_mask", "labels_mask"):
        assert np.array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f))), f
    tseg = dp.pad_segment(DataSet(torch.ones(2, 3, 5), features_mask=torch.ones(2, 3)), 8)
    assert tuple(tseg.features.shape) == (2, 8, 5) and float(tseg.features_mask[:, 3:].sum()) == 0
    bare = DataSet(np.ones((2, 3, 5), np.float32))
    assert np.array_equal(dp.ensure_feature_mask(bare).features_mask,
                          jdp.ensure_feature_mask(JDataSet(bare.features)).features_mask)
    tmask = dp.ensure_feature_mask(DataSet(torch.ones(2, 3, 5))).features_mask
    assert torch.is_tensor(tmask) and tuple(tmask.shape) == (2, 3)


# ------------------------------------------------------------- the feeder
def test_feeder_yields_every_batch_in_order_as_the_jax_feeder():
    x, y = _data(103, seed=6)
    feeder = dp.DeviceFeeder(depth=2, device="cpu")
    fed = list(feeder.feed(ArrayDataSetIterator(x, y, batch_size=32)))
    jfed = list(jdp.DeviceFeeder(depth=2).feed(JArrayDataSetIterator(x, y, batch_size=32)))
    assert [f.n_examples for f in fed] == [f.n_examples for f in jfed] == [32, 32, 32, 7]
    assert [f.padded for f in fed] == [f.padded for f in jfed]
    assert feeder.buckets == (32,)
    for f, j in zip(fed, jfed):
        assert isinstance(f, dp.FedBatch) and f.bucket == j.bucket
        for name in ("features", "labels", "labels_mask"):
            got = getattr(f.batch, name)
            assert torch.is_tensor(got) and got.device.type == "cpu"
            assert np.array_equal(got.numpy(), np.asarray(getattr(j.batch, name))), name
    assert np.array_equal(fed[-1].batch.features[:7].numpy(), x[96:])


def test_feeder_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp.DeviceFeeder()


def test_a_batch_is_never_overwritten_in_flight():
    """An iterator that refills one buffer for every batch, and a consumer
    that holds every batch it was given until the end: each still holds
    its own values (the feeder's stage is a copy, whatever the iterator
    does next)."""
    buf = np.zeros((4, 3), np.float32)

    def refilled():
        for i in range(8):
            buf[:] = i
            yield (buf,)

    feeder = dp.DeviceFeeder(depth=2, bucketing=False, device="cpu")
    held = []
    for fed in feeder.feed(refilled()):
        time.sleep(0.01)   # the producer runs ahead and refills the buffer
        held.append(fed.batch[0])
    assert [float(t.max()) for t in held] == [float(i) for i in range(8)]
    assert all(float(t.min()) == float(t.max()) for t in held)
    assert feeder.slots >= 2


def test_a_raising_iterator_reraises_in_the_consumer():
    def gen():
        for i in range(3):
            yield DataSet(*_data(4, seed=i))
        raise RuntimeError("ETL exploded at batch 3")

    feeder = dp.DeviceFeeder(bucketing=False, depth=2, device="cpu")
    before = threading.active_count()
    seen = 0
    with pytest.raises(RuntimeError, match="ETL exploded") as exc_info:
        for _ in feeder.feed(gen()):
            seen += 1
    assert seen == 3
    assert any(f.name == "gen" for f in traceback.extract_tb(exc_info.value.__traceback__))
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_abandoning_the_feed_stops_the_producer():
    x, y = _data(400, seed=7)
    feeder = dp.DeviceFeeder(depth=2, device="cpu")
    before = threading.active_count()
    for i, _ in enumerate(feeder.feed(ArrayDataSetIterator(x, y, 10))):
        if i == 2:
            break
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# ------------------------------------------------------------ listeners
class _Recorder(listeners.TrainingListener, jlisteners.TrainingListener):
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch, score):
        self.calls.append(("iteration_done", iteration, epoch, score))

    def on_epoch_end(self, model, epoch, info):
        self.calls.append(("on_epoch_end", epoch, dict(info)))


class _OnlyIterations:
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch, score):
        self.calls.append(iteration)


def test_listener_hooks_fire_as_the_jax_bus_fires_them():
    script = [("on_fit_start", (None,)), ("iteration_done", (None, 0, 0, 1.5)),
              ("on_epoch_end", (None, 0, {"loss": 1.5})), ("iteration_done", (None, 1, 1, 0.5)),
              ("on_forward_pass", (None, [])), ("on_fit_end", (None, {}))]
    runs = []
    for mod in (listeners, jlisteners):
        rec, only = _Recorder(), _OnlyIterations()
        bus = mod.ListenerBus([rec])
        bus.add(only)
        for hook, args in script:
            bus.dispatch(hook, *args)
        runs.append((rec.calls, only.calls))
    assert runs[0] == runs[1]
    assert runs[0][1] == [0, 1]


def test_collect_score_and_evaluative_listeners_match_jax(caplog):
    for mod in (listeners, jlisteners):
        collect = mod.CollectScoresListener()
        for i, s in enumerate((3.0, 2.0, 1.0)):
            collect.iteration_done(None, i, 0, s)
        assert collect.iterations == [0, 1, 2] and collect.scores == [3.0, 2.0, 1.0]

        class _Model:
            def evaluate(self, it):
                return type("E", (), {"accuracy": lambda self: 0.5})()

        ev = mod.EvaluativeListener(lambda: None, frequency=2, invocation="iteration")
        for i in range(5):
            ev.iteration_done(_Model(), i, 0, 0.0)
        assert len(ev.evaluations) == 3
        ev_epoch = mod.EvaluativeListener(lambda: None)
        ev_epoch.on_epoch_end(_Model(), 0, {})
        assert len(ev_epoch.evaluations) == 1
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        listeners.ScoreIterationListener(frequency=2).iteration_done(None, 4, 1, 0.25)
    assert "Score at iteration 4 (epoch 1) is 0.250000" in caplog.text


def test_performance_listener_reads_the_clock_after_a_synchronize(monkeypatch, caplog):
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: events.append("sync"))
    real = time.perf_counter
    monkeypatch.setattr(listeners.time, "perf_counter",
                        lambda: events.append("clock") or real())

    class _CardModel:
        device = torch.device("cuda")

    perf = listeners.PerformanceListener(frequency=2)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        for i in range(5):
            perf.record_batch(8)
            perf.iteration_done(_CardModel(), i, 0, 0.0)
    assert events == ["sync", "clock"] * 5
    assert caplog.text.count("batches/sec") == 2 and "samples/sec" in caplog.text
    events.clear()
    perf.iteration_done(type("M", (), {"device": torch.device("cpu")})(), 5, 0, 0.0)
    assert events == ["clock"]


# --------------------------------------------- BERT fit through the feeder
def test_fit_with_collect_scores_equals_make_train_step_by_hand():
    cfg = bert.BertConfig.tiny(vocab_size=100)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        batches.append({"input_ids": rng.integers(0, 100, (2, 12)),
                        "labels": rng.integers(0, 100, (2, 12)),
                        "label_weights": (rng.random((2, 12)) < 0.3).astype(np.float32),
                        "attention_mask": np.ones((2, 12), np.float32)})
    model = bert.BertForMaskedLM(cfg, seed=4, device="cpu")
    by_hand = bert.BertForMaskedLM(cfg, seed=4, device="cpu")
    collect = listeners.CollectScoresListener()
    bus = listeners.ListenerBus([collect])
    last = model.fit(batches, updater=Adam(1e-3, mu_dtype="bf16"), epochs=2, listeners=bus)

    updater = Adam(1e-3, mu_dtype="bf16")
    step = by_hand.make_train_step(updater)
    params, state = by_hand.params, updater.init(by_hand.params)
    gen = torch.Generator().manual_seed(by_hand.seed + 31)
    losses = []
    for _ in range(2):
        for b in batches:
            params, state, loss = step(
                params, state, torch.as_tensor(b["input_ids"]), torch.as_tensor(b["labels"]),
                torch.as_tensor(b["label_weights"]), torch.as_tensor(b["attention_mask"]), gen)
            losses.append(loss.item())
    assert collect.iterations == list(range(6)) and collect.scores == losses
    assert last == losses[-1] and model.iteration == 6
    for got, want in zip(tree_leaves(model.params), tree_leaves(params)):
        assert torch.equal(got, want)
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(model.opt_state["mu"]))
