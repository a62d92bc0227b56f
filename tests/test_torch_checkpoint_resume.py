"""Net checkpoints and exact resume in the port (``io/model_serializer.py``,
``io/checkpoint.py``, ``resilience/checkpoint.py``, ``Trainer.resume_state``)
against the JAX package on the CPU.

- a zip the port writes restores in the port: params, state, updater
  state and counters, and the same outputs;
- a zip the JAX package writes restores in the port and continues 3
  steps within 1e-5 of the JAX package's own continuation, and the
  reverse, for Nesterovs with a step schedule and for a per-layer AdamW
  beside a frozen layer (no dropout: the two packages' streams differ);
- a damaged zip is refused with ``CheckpointCorruptError``;
- ``CheckpointListener`` keeps the last K, rebuilds its index from a scan,
  falls back to the newest intact zip and raises a failed background save;
- an interrupted ``fit`` resumed with ``resume_from`` repeats the
  uninterrupted run bit for bit, with dropout, mid-epoch through a
  ``ResumableIterator``, and refuses a plain iterator there.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet, ResumableIterator
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.io import model_serializer
from deeplearning4j_tpu_torch.io.checkpoint import INDEX_NAME, CheckpointListener
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener, TrainingListener
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointCorruptError, is_valid_checkpoint, verify_checkpoint)
from deeplearning4j_tpu_torch.train import Trainer
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

LOSS_RTOL = 1e-5       # a continuation's loss against the other package's
PARAM_TOL = 1e-5       # a continued param, of its largest entry
BATCH, N_IN, N_OUT = 8, 12, 4


def _jax_conf(kind: str):
    """A dropout-free MLP of the JAX package: Nesterovs with a step
    schedule, or Adam with the output layer on AdamW and the first layer
    frozen."""
    if kind == "nesterovs_schedule":
        updater = jupd.Nesterovs(jsched.StepSchedule(initial_value=0.05, decay_rate=0.5,
                                                     step=2.0), 0.9)
    else:
        updater = jupd.Adam(5e-3)
    conf = (JNeuralNetConfiguration.builder().seed(5).updater(updater).weight_init("xavier")
            .list()
            .layer(jlayers.DenseLayer(n_out=16, activation="relu"))
            .layer(jlayers.DenseLayer(n_out=8, activation="tanh"))
            .layer(jlayers.OutputLayer(n_out=N_OUT, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(N_IN)).build())
    if kind == "per_layer_adamw_frozen":
        conf.layers[0].frozen = True
        conf.layers[2].updater = jupd.AdamW(learning_rate=jsched.RampSchedule(
            underlying=jsched.ExponentialSchedule(initial_value=1e-2, gamma=0.9),
            num_iterations=3), weight_decay=0.05)
    return conf


def _batches(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BATCH, N_IN)).astype(np.float32),
             np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, BATCH)]) for _ in range(n)]


def _np(tree):
    return [{k: np.asarray(v) for k, v in d.items()} for d in tree]


def _jax_steps(jnet, batches) -> list:
    trainer = JTrainer(jnet)
    return [float(trainer.step_batch(JDataSet(x, y), jax.random.key(0))) for x, y in batches]


def _port_steps(net, batches) -> list:
    trainer = Trainer(net)
    return [trainer.step_batch(DataSet(x, y)).item() for x, y in batches]


def _assert_params_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            diff, scale = np.abs(g[k].detach().numpy() - w[k]).max(), np.abs(w[k]).max()
            assert diff <= PARAM_TOL * scale, f"layer {i} {k}: {diff:.2e} of {scale:.2e}"


KINDS = ["nesterovs_schedule", "per_layer_adamw_frozen"]


@pytest.fixture(scope="module", params=KINDS)
def jax_run(request, tmp_path_factory):
    """The JAX package's run: 2 steps, a zip, 3 more steps."""
    kind = request.param
    jnet = JMultiLayerNetwork(_jax_conf(kind)).init()
    batches = _batches(5)
    p0, s0 = _np(jnet.params_), _np(jnet.state_)
    _jax_steps(jnet, batches[:2])
    path = str(tmp_path_factory.mktemp(kind) / "jax.zip")
    jnet.save(path)
    losses = _jax_steps(jnet, batches[2:])
    return {"kind": kind, "p0": p0, "s0": s0, "batches": batches, "zip": path,
            "losses": losses, "p5": _np(jnet.params_), "iteration": jnet.iteration}


def _port_net(kind, p0, s0) -> MultiLayerNetwork:
    conf = MultiLayerConfiguration.from_json(_jax_conf(kind).to_json())
    return load_jax_params(MultiLayerNetwork(conf, device="cpu"), p0, s0)


def test_jax_zip_restores_in_the_port_and_continues(jax_run):
    net = MultiLayerNetwork.load(jax_run["zip"], device="cpu")
    assert net.iteration == 2 and net._stream_state is None   # JAX zips carry no torch stream
    assert net.opt_state is not None
    losses = _port_steps(net, jax_run["batches"][2:])
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_RTOL)
    _assert_params_close(net.params_, jax_run["p5"])
    if jax_run["kind"] == "per_layer_adamw_frozen":
        assert sorted(net.opt_state) == ["_default", "layer_2"]


def test_port_zip_restores_in_jax_and_continues(jax_run, tmp_path):
    net = _port_net(jax_run["kind"], jax_run["p0"], jax_run["s0"])
    _port_steps(net, jax_run["batches"][:2])
    path = str(tmp_path / "port.zip")
    net.save(path)
    jnet = JMultiLayerNetwork.load(path)
    assert jnet.iteration == 2
    jlosses = _jax_steps(jnet, jax_run["batches"][2:])
    np.testing.assert_allclose(jlosses, jax_run["losses"], rtol=LOSS_RTOL)
    _assert_params_close([{k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}
                          for d in jnet.params_], jax_run["p5"])
    if jax_run["kind"] == "per_layer_adamw_frozen":
        np.testing.assert_array_equal(np.asarray(jnet.params_[0]["W"]), jax_run["p0"][0]["W"])


def test_frozen_layer_stays_bit_unchanged_and_its_state_moves():
    p0, s0 = _init_np("per_layer_adamw_frozen")
    net = _port_net("per_layer_adamw_frozen", p0, s0)
    _port_steps(net, _batches(4))
    np.testing.assert_array_equal(net.params_[0]["W"].numpy(), p0[0]["W"])
    # optax's state of a frozen leaf still moves on its gradient
    assert net.opt_state["_default"]["mu"][0]["W"].abs().max() > 0
    assert net.opt_state["layer_2"]["mu"][0] == {}


def test_port_zip_round_trip(tmp_path):
    net = _port_net("per_layer_adamw_frozen", *_init_np("per_layer_adamw_frozen"))
    _port_steps(net, _batches(3))
    path = str(tmp_path / "m.zip")
    net.save(path)
    assert is_valid_checkpoint(path)
    back = MultiLayerNetwork.load(path, device="cpu")
    assert (back.iteration, back.epoch) == (net.iteration, net.epoch) == (3, 0)
    for a, b in zip(tree_leaves([net.params_, net.state_, net.opt_state]),
                    tree_leaves([back.params_, back.state_, back.opt_state])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    x = _batches(1, seed=9)[0][0]
    assert torch.equal(net.output(x), back.output(x))
    assert model_serializer.restore_model(path, device="cpu").conf.to_json() == net.conf.to_json()
    without = MultiLayerNetwork.load(path, load_updater=False, device="cpu")
    assert without.opt_state is None


def _init_np(kind):
    jnet = JMultiLayerNetwork(_jax_conf(kind)).init()
    return _np(jnet.params_), _np(jnet.state_)


def _flip_byte(path: str, at: float = 0.5) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        pos = int(f.tell() * at)
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_a_damaged_zip_is_refused(tmp_path):
    net = _port_net("nesterovs_schedule", *_init_np("nesterovs_schedule"))
    _port_steps(net, _batches(1))
    path = str(tmp_path / "m.zip")
    net.save(path)
    _flip_byte(path)
    assert verify_checkpoint(path)
    with pytest.raises(CheckpointCorruptError):
        MultiLayerNetwork.load(path, device="cpu")
    with pytest.raises(CheckpointCorruptError):
        model_serializer.restore_into(net, path)
    with open(path, "r+b") as f:
        f.truncate(100)
    with pytest.raises(CheckpointCorruptError, match="unreadable zip"):
        model_serializer.restore_model(path, device="cpu")


def _fit_net(dropout: float = 0.8) -> MultiLayerNetwork:
    net = _port_net("per_layer_adamw_frozen", *_init_np("per_layer_adamw_frozen"))
    for layer in net.layers[1:]:
        layer.dropout = dropout
    return net


def _data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10 * BATCH, N_IN)).astype(np.float32)
    return x, np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, len(x))]


def _iterator(resumable: bool = True, shuffle: bool = True):
    """The run's batches: a plain iterator that shuffles restarts its
    order at epoch 0, so a resume at a later epoch needs the resumable one
    (which tells it the epoch) or no shuffle."""
    x, y = _data()
    it = ArrayDataSetIterator(x, y, BATCH, shuffle=shuffle, seed=1)
    return ResumableIterator(it) if resumable else it


class _Interrupt(TrainingListener):
    """Stops a run after ``at``, as a preemption would."""

    def __init__(self, at: int):
        self.at = at

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == self.at:
            raise KeyboardInterrupt


def test_checkpoint_listener_keeps_the_last_k_rebuilds_its_index_and_falls_back(tmp_path):
    d = str(tmp_path / "ckpt")
    net = _fit_net(dropout=None)
    Trainer(net, [CheckpointListener(d, save_every_n_iterations=2, keep_last=2)]).fit(
        _iterator(), epochs=1)
    names = sorted(n for n in os.listdir(d) if n.endswith(".zip"))
    assert names == ["checkpoint_iter6_epoch0.zip", "checkpoint_iter8_epoch0.zip"]
    os.remove(os.path.join(d, INDEX_NAME))
    again = CheckpointListener(d, keep_last=2)    # the index rebuilt from a scan
    assert [os.path.basename(p) for p in again._saved] == names
    newest = CheckpointListener.last_checkpoint_in(d)
    assert newest.endswith("checkpoint_iter8_epoch0.zip")
    _flip_byte(newest)
    assert CheckpointListener.last_checkpoint_in(d).endswith("checkpoint_iter6_epoch0.zip")
    assert CheckpointListener.last_checkpoint_in(d, verify=False) == newest


def test_background_saves_are_durable_and_a_failed_one_raises(tmp_path, monkeypatch):
    d = str(tmp_path / "bg")
    net = _fit_net(dropout=None)
    listener = CheckpointListener(d, save_every_n_iterations=3, keep_last=5, background=True)
    Trainer(net, [listener]).fit(_iterator(), epochs=1)    # on_fit_end flushes
    assert listener.last_checkpoint().endswith("checkpoint_iter9_epoch0.zip")
    assert all(is_valid_checkpoint(os.path.join(d, n)) for n in os.listdir(d)
               if n.endswith(".zip"))

    def broken(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(model_serializer, "write_model", broken)
    listener.save_now(net)
    with pytest.raises(RuntimeError, match="background checkpoint save failed"):
        listener.flush()
    listener.close()


def test_interrupted_fit_resumed_repeats_the_run_bit_for_bit(tmp_path):
    """Two epochs of 10 batches with dropout: a run stopped after
    iteration 13 (mid-epoch 1, its newest checkpoint at 10) and resumed
    from the directory gives the uninterrupted run's losses and params."""
    whole, scores = _fit_net(), CollectScoresListener()
    Trainer(whole, [scores]).fit(_iterator(), epochs=2)
    d = str(tmp_path / "run")
    cut = _fit_net()
    with pytest.raises(KeyboardInterrupt):
        Trainer(cut, [CheckpointListener(d, save_every_n_iterations=5, keep_last=2),
                      _Interrupt(13)]).fit(_iterator(), epochs=2)
    state = model_serializer.read_training_state(CheckpointListener.last_checkpoint_in(d))
    assert state["iteration"] == 11 and state["epoch"] == 1 and state["epoch_batches"] == 1
    resumed, again = _fit_net(), CollectScoresListener()
    Trainer(resumed, [again]).fit(_iterator(), epochs=2, resume_from=d)
    assert again.iterations == list(range(11, 20))
    assert again.scores == scores.scores[11:]
    for a, b in zip(tree_leaves([whole.params_, whole.state_, whole.opt_state]),
                    tree_leaves([resumed.params_, resumed.state_, resumed.opt_state])):
        assert torch.equal(a, b)
    assert (resumed.iteration, resumed.epoch) == (whole.iteration, whole.epoch) == (20, 2)
    with pytest.raises(ValueError, match="ResumableIterator"):
        Trainer(_fit_net()).fit(_iterator(resumable=False), epochs=2, resume_from=d)


def test_resume_at_an_epoch_boundary_needs_no_resumable_iterator(tmp_path):
    whole, scores = _fit_net(), CollectScoresListener()
    Trainer(whole, [scores]).fit(_iterator(False, shuffle=False), epochs=2)
    d = str(tmp_path / "epochs")
    cut = _fit_net()
    with pytest.raises(KeyboardInterrupt):
        Trainer(cut, [CheckpointListener(d, save_every_n_epochs=1), _Interrupt(12)]).fit(
            _iterator(False, shuffle=False), epochs=2)
    resumed, again = _fit_net(), CollectScoresListener()
    resumed.fit(_iterator(False, shuffle=False), epochs=2, listeners=[again], resume_from=d)
    assert again.scores == scores.scores[10:]


def test_fit_without_the_feeder_takes_the_same_steps():
    """``config.device_feed`` off: ``fit`` iterates the batches itself
    (no labels mask attached), the same steps within f32 rounding."""
    from deeplearning4j_tpu_torch import config
    runs = []
    for feed in (True, False):
        config.set_config(device_feed=feed)
        try:
            net, scores = _fit_net(dropout=None), CollectScoresListener()
            Trainer(net, [scores]).fit(_iterator(), epochs=1)
        finally:
            config.set_config(device_feed=True)
        runs.append(scores.scores)
    assert len(runs[0]) == len(runs[1]) == 10
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
