"""The port's recurrent training path held to the JAX package's.

- ``lstm_classifier(timesteps=16, hidden=16)`` (GravesLSTM -> LastTimeStep
  -> OutputLayer, Adam(5e-3), gradients clipped element-wise at 0.5) at
  batch 8: 3 steps of ``Trainer.fit_batch`` from the JAX net's weights,
  without and with a right-padded features mask.  With the mask,
  ``LastTimeStep.transform_mask`` keeps it from the OutputLayer's loss.
- The five gradient normalizations against the reference's optax
  transform on one gradient tree (a layer stack's list, with an empty
  layer and a nested Bidirectional layer).
- tBPTT: a 2-layer ``text_gen_lstm(vocab_size=11, hidden=8)`` on
  sequences of T = 12 in segments of 5 (so the last is padded with a
  masked tail), 2 calls of ``net.fit`` against the reference's.
- Segment by segment through ``_forward_impl`` with carried state equals
  the whole forward, and ``rnn_time_step`` fed one step at a time equals
  ``output``.

Bands: losses ``rtol=1e-5``; every param within ``PARAM_TOL`` of the
largest entry of its change since the start (as in
``test_torch_multilayer_train.py``); the normalizations 1e-6 of each
leaf's largest entry; forwards ``rtol=1e-5, atol=1e-6``.  No dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayDataSetIterator
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.train import updaters as jupdaters
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import lstm_classifier, text_gen_lstm
from deeplearning4j_tpu_torch.nn.layers import core
from deeplearning4j_tpu_torch.train import Trainer
from deeplearning4j_tpu_torch.train import updaters

LOSS_RTOL, PARAM_TOL, NORM_TOL = 1e-5, 1e-3, 1e-6
STEPS, BATCH, T_CLS, HIDDEN = 3, 8, 16, 16
VOCAB, CHAR_HIDDEN, T_CHAR, SEGMENT, CHAR_BATCH, FITS = 11, 8, 12, 5, 4, 2
LENGTHS = (16, 16, 11, 9, 16, 5, 1, 13)
NORMALIZATIONS = {"renormalize_l2_per_layer": 1.0, "renormalize_l2_per_param_type": 1.0,
                  "clip_element_wise_absolute_value": 0.5, "clip_l2_per_layer": 1.0,
                  "clip_l2_per_param_type": 1.0}


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _port(factory, jnet, **kwargs):
    net = factory(device="cpu", **kwargs)
    return load_jax_params(net, np_tree(jnet.params_), np_tree(jnet.state_))


def assert_params_close(got, want, before, what):
    """Each param of ``got`` within ``PARAM_TOL`` of the largest entry of
    its change in ``want`` since ``before``."""
    for i, (g, w, b) in enumerate(zip(got, want, before)):
        for k in w:
            change = np.abs(w[k] - b[k]).max()
            assert change > 0, f"{what} layer {i} {k} did not move"
            err = np.abs(g[k].detach().numpy() - w[k]).max() / change
            assert err <= PARAM_TOL, f"{what} layer {i} {k}: {err:.3g} of its change"


# ------------------------------------------------------------ the classifier
def _cls_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(STEPS, BATCH, T_CLS, 9)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (STEPS, BATCH))]
    mask = (np.arange(T_CLS)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)
    return x, y, mask


@pytest.fixture(scope="module", params=["unmasked", "masked"])
def classifier(request):
    """The JAX classifier's start and its 3 ``fit_batch`` steps."""
    masked = request.param == "masked"
    jnet = jzoo.lstm_classifier(timesteps=T_CLS, hidden=HIDDEN).init()
    p0 = np_tree(jnet.params_)
    x, y, mask = _cls_data()
    trainer, losses = JTrainer(jnet), []
    for i in range(STEPS):
        batch = JDataSet(x[i], y[i], mask if masked else None)
        losses.append(float(trainer.fit_batch(batch, jax.random.key(i))))
    return {"jnet": jnet, "masked": masked, "p0": p0, "p3": np_tree(jnet.params_),
            "losses": losses}


def test_lstm_classifier_fit_batch_matches_jax(classifier, monkeypatch):
    """Three steps from the JAX weights: the losses, and every param after
    them.  With a features mask, no mask reaches the OutputLayer (its
    ``LastTimeStep`` consumes the time axis)."""
    net = lstm_classifier(timesteps=T_CLS, hidden=HIDDEN, device="cpu")
    load_jax_params(net, classifier["p0"], [{}, {}])
    seen = []
    score = core.OutputLayer.apply_and_score

    def spy(self, *args, mask=None, **kwargs):
        seen.append(mask)
        return score(self, *args, mask=mask, **kwargs)
    monkeypatch.setattr(core.OutputLayer, "apply_and_score", spy)
    x, y, mask = _cls_data()
    trainer = Trainer(net)
    losses = [trainer.fit_batch(DataSet(x[i], y[i], mask if classifier["masked"] else None))
              .item() for i in range(STEPS)]
    np.testing.assert_allclose(losses, classifier["losses"], rtol=LOSS_RTOL)
    assert_params_close(net.params_, classifier["p3"], classifier["p0"], "lstm_classifier")
    assert seen == [None] * STEPS


def test_masked_steps_change_the_classifier_loss(classifier):
    """The mask is read: the masked run's losses are not the unmasked
    run's (the same weights and data)."""
    x, y, mask = _cls_data()
    net = lstm_classifier(timesteps=T_CLS, hidden=HIDDEN, device="cpu")
    load_jax_params(net, classifier["p0"], [{}, {}])
    trainer = Trainer(net)
    plain = trainer.eval_loss(DataSet(x[0], y[0])).item()
    masked = trainer.eval_loss(DataSet(x[0], y[0], mask)).item()
    assert abs(plain - masked) > 1e-3 * abs(plain)
    assert (classifier["losses"][0] == pytest.approx(masked, rel=LOSS_RTOL)
            if classifier["masked"] else classifier["losses"][0] == pytest.approx(
                plain, rel=LOSS_RTOL))


# ------------------------------------------------------------ normalizations
def _grad_tree():
    rng = np.random.default_rng(4)

    def leaf(shape, scale):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return [{"W": leaf((5, 4), 1.0), "b": leaf((4,), 1.0)},
            {},
            {"bwd": {"U": leaf((3, 12), 0.01), "W": leaf((5, 12), 0.01)},
             "fwd": {"U": leaf((3, 12), 0.2), "W": leaf((5, 12), 0.02)}},
            {"W": leaf((3, 3), 2.0), "b": leaf((3,), 1e-3)}]


@pytest.mark.parametrize("kind", sorted(NORMALIZATIONS))
def test_gradient_normalization_matches_the_reference_transform(kind):
    threshold = NORMALIZATIONS[kind]
    grads = _grad_tree()
    tx = jupdaters.gradient_normalization(kind, threshold)
    want, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), tx.init(grads))
    got = updaters.gradient_normalization(kind, threshold)(
        updaters.tree_map(torch.from_numpy, grads))
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    assert len(got_leaves) == len(want_leaves) == 8
    moved = 0
    for g, w, before in zip(got_leaves, want_leaves, jax.tree_util.tree_leaves(grads)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= NORM_TOL * np.abs(w).max()
        moved += not np.array_equal(w, before)
    assert 0 < moved      # every kind changes some leaf of this tree


def test_unknown_gradient_normalization_raises():
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        updaters.gradient_normalization("clip_sometimes")


# ------------------------------------------------------------ tBPTT
def _char_data():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, VOCAB, (FITS, CHAR_BATCH, T_CHAR + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :, :-1]], eye[ids[:, :, 1:]]


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(float(score))


def _char_net_jax():
    jnet = jzoo.text_gen_lstm(vocab_size=VOCAB, hidden=CHAR_HIDDEN)
    jnet.conf.tbptt_fwd_length = jnet.conf.tbptt_back_length = SEGMENT
    return jnet.init()


def _char_net(jnet):
    net = _port(text_gen_lstm, jnet, vocab_size=VOCAB, hidden=CHAR_HIDDEN)
    net.conf.tbptt_fwd_length = net.conf.tbptt_back_length = SEGMENT
    return net


@pytest.fixture(scope="module")
def char_rnn():
    """The JAX char-RNN's start, its outputs there, and 2 ``fit`` calls."""
    jnet = _char_net_jax()
    x, y = _char_data()
    out = {"jnet": jnet, "p0": np_tree(jnet.params_), "out0": np.array(jnet.output(x[0]))}
    watch = _Scores()
    for i in range(FITS):
        jnet.fit(JArrayDataSetIterator(x[i], y[i], CHAR_BATCH), 1, listeners=[watch])
    out["scores"], out["p_end"] = watch.scores, np_tree(jnet.params_)
    return out


def test_tbptt_fit_matches_jax(char_rnn):
    """Two ``fit`` calls of one batch each, 3 segments a batch (5, 5 and 2
    steps padded to 5): the score after each, and every param."""
    jnet = _char_net_jax()
    jnet.params_ = jax.tree_util.tree_map(jnp.asarray, char_rnn["p0"])
    net = _char_net(jnet)
    x, y = _char_data()
    scores = []
    for i in range(FITS):
        net.fit(ArrayDataSetIterator(x[i], y[i], CHAR_BATCH), 1)
        scores.append(net.score())
    assert net.iteration == FITS
    np.testing.assert_allclose(scores, char_rnn["scores"], rtol=LOSS_RTOL)
    assert_params_close(net.params_, char_rnn["p_end"], char_rnn["p0"], "text_gen_lstm")


def test_tbptt_segments_pad_the_tail_and_replay_one_step():
    """T = 12 in segments of 5: three segments of one shape, the last with
    3 masked steps; every segment goes through the one cached step."""
    x, y = _char_data()
    batch = DataSet(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    from deeplearning4j_tpu_torch.data.device_pipeline import ensure_feature_mask
    from deeplearning4j_tpu_torch.train.trainer import tbptt_segments
    segs = list(tbptt_segments(ensure_feature_mask(batch), SEGMENT))
    assert [tuple(s.features.shape) for s in segs] == [(CHAR_BATCH, SEGMENT, VOCAB)] * 3
    assert [s.features_mask.sum(1).tolist() for s in segs] == [[5.0] * 4, [5.0] * 4, [2.0] * 4]
    assert torch.equal(segs[2].features[:, :2], batch.features[:, 10:])
    assert not segs[2].features[:, 2:].any() and not segs[2].labels[:, 2:].any()


def test_segments_with_carried_state_equal_the_whole_forward(char_rnn):
    """``_forward_impl`` over segments of 4 with the carries handed on
    equals the whole forward, and both equal the JAX net's output."""
    net = _char_net(char_rnn["jnet"])
    net.params_ = updaters.tree_map(torch.from_numpy, char_rnn["p0"])
    x = torch.from_numpy(_char_data()[0][0])
    full, _, _ = net._forward(net.params_, net.state_, x)
    carries, outs = [None] * len(net.layers), []
    for s in range(0, T_CHAR, 4):
        y, _, _, carries = net._forward_impl(net.params_, net.state_, x[:, s:s + 4], carries)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full.detach().numpy(), char_rnn["out0"], rtol=1e-5, atol=1e-6)


def test_rnn_time_step_one_step_at_a_time_equals_output(char_rnn):
    net = _char_net(char_rnn["jnet"])
    net.params_ = updaters.tree_map(torch.from_numpy, char_rnn["p0"])
    x = _char_data()[0][0]
    steps = torch.stack([net.rnn_time_step(x[:, t]) for t in range(T_CHAR)], 1)
    np.testing.assert_allclose(steps.numpy(), net.output(x).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(steps.numpy(), char_rnn["out0"], rtol=1e-5, atol=1e-6)
    # the state goes on across calls until it is cleared
    again = net.rnn_time_step(x[:, :3])
    net.rnn_clear_previous_state()
    fresh = net.rnn_time_step(x[:, :3])
    np.testing.assert_allclose(fresh.numpy(), char_rnn["out0"][:, :3], rtol=1e-5, atol=1e-6)
    assert not np.allclose(again.numpy(), fresh.numpy())


def test_chip_smoke_har_batch_is_bench_lstm_batch():
    """The card's UCI-HAR step runs on ``bench.py``'s ``lstm_har_step_ms``
    batch: the same numpy stream after MLP-MNIST's and LeNet's arrays."""
    import chip_smoke
    rng = np.random.default_rng(0)
    rng.normal(size=(128, 784)), rng.integers(0, 10, 128)
    rng.normal(size=(128, 32, 32, 3)), rng.integers(0, 10, 128)
    x = rng.normal(size=(64, 128, 9)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 64)]
    got_x, got_y = chip_smoke.har_batches(1)[0]
    np.testing.assert_array_equal(got_x, x)
    np.testing.assert_array_equal(got_y, y)
