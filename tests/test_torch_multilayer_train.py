"""The port's ``MultiLayerNetwork`` training slice held to the JAX package:
``Trainer.fit_batch`` and ``net.fit`` on a layer stack, ``params`` and
``set_params``, dropout (``Layer._maybe_dropout``, ``DropoutLayer``), LRN,
``ComputationGraph``'s evaluation surface and the zoo's small nets.

MLP-MNIST at full width (784-500-100-10, batch 16) and LeNet at 28x28x1
(batch 4) are initialised by the JAX package, carried into the port
through ``interop.load_jax_params`` and trained for 3 steps of
``net.fit`` over the same seeded, shuffled ``ArrayDataSetIterator`` in
each package.  Bands: the loss at every step within 1e-5 relative; every
param after step 3 within 1e-3 of the largest entry of its total change
since step 0 (both sides compute in f32, in other summation orders), or
within twice the port's own f32 error there, where that is larger.  The
port's f32 error is its distance from the same 3 steps in f64.  MLP-MNIST
(Nesterovs) stays inside 1e-3.  LeNet trains with Adam.  Adam scales
each entry's step by its own gradient history, so an entry whose
gradient is tiny moves by about the learning rate whatever its rounding.
So LeNet's dense weight sits 1.4% of its change from the f64 run in f32
and 1.3% from JAX's f32 run.

The two packages' random streams differ, so the dropout step patches
both draw functions (the port's ``base._keep_mask`` and the reference's
``jax.random.bernoulli``) with the same numpy masks, one per input
shape, and holds the step to the same bands.  The reference's jitted
step donates its buffers: its params are read into numpy after every
step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayDataSetIterator
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JElementWiseVertex
from deeplearning4j_tpu.train import Nesterovs as JNesterovs
from deeplearning4j_tpu.train.step_cache import clear_step_cache
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.models import alexnet, lenet, mlp_mnist, simple_cnn, vgg16, vgg19
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import base
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.train import Nesterovs, Trainer

LOSS_RTOL, PARAM_TOL, LRN_TOL = 1e-5, 1e-3, 1e-5
# a param may sit this many times the port's own f32 error from JAX's run
F32_ERROR_FACTOR = 2
STEPS = 3
# (factory kwargs, input shape per example, batch)
NETS = {"mlp_mnist": ({}, (784,), 16),
        "lenet": ({"height": 28, "width": 28, "channels": 1}, (28, 28, 1), 4)}
FACTORIES = {"mlp_mnist": (jzoo.mlp_mnist, mlp_mnist), "lenet": (jzoo.lenet, lenet)}


def np_params(tree):
    return [{k: np.array(a) for k, a in d.items()} for d in tree]


def _data(name):
    _, shape, batch = NETS[name]
    rng = np.random.default_rng(17)
    x = rng.random((STEPS * batch,) + shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, STEPS * batch)]
    return x, y, batch


class _Losses:
    """The reference's listener: each step's loss and, after the last,
    the params (read into numpy before the next step donates them)."""

    def __init__(self):
        self.losses, self.params = [], None

    def iteration_done(self, model, iteration, epoch, score):
        self.losses.append(float(score))
        self.params = np_params(model.params_)


class _Watch:
    """The port's side: a listener that keeps each step's score (``fit``
    stages batches ahead through its feeder, so an iterator cannot tell
    when a step has run)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, epoch, score):
        self.losses.append(float(score))


@pytest.fixture(scope="module", params=sorted(NETS))
def reference(request):
    name = request.param
    kwargs = NETS[name][0]
    jnet = FACTORIES[name][0](**kwargs).init()
    p0, s0 = np_params(jnet.params_), np_params(jnet.state_)
    flat0 = np.array(jnet.params())
    x, y, batch = _data(name)
    watch = _Losses()
    jnet.fit(JArrayDataSetIterator(x, y, batch, shuffle=True, seed=5), 1, listeners=[watch])
    out = {"name": name, "p0": p0, "s0": s0, "flat0": flat0, "losses": watch.losses,
           "p3": watch.params, "iteration": jnet.iteration, "epoch": jnet.epoch,
           "score": jnet.score(), "x": x, "y": y, "batch": batch}
    # set_params: the step-0 params back in, then one inference forward
    jnet.set_params(jax.tree_util.tree_map(jnp.asarray, p0))
    out["out0"] = np.array(jnet.output(x[:batch]))
    return out


def _port(ref):
    net = FACTORIES[ref["name"]][1](device="cpu", **NETS[ref["name"]][0])
    return load_jax_params(net, ref["p0"], ref["s0"])


def assert_params_close(got, want, before, what, f64=None):
    """Each param of ``got`` within ``PARAM_TOL`` of the largest entry of
    its change in ``want`` since ``before``, or within ``F32_ERROR_FACTOR``
    times its distance from ``f64`` (the same run in f64) where given and
    larger.  Returns the errors, as fractions of the change."""
    errs = {}
    for i, (g, w, b) in enumerate(zip(got, want, before)):
        for k in w:
            change = np.abs(w[k] - b[k]).max()
            assert change > 0, f"{what} layer {i} {k} did not move"
            g32 = g[k].detach().numpy()
            err = np.abs(g32 - w[k]).max() / change
            band = PARAM_TOL
            if f64 is not None:
                own = np.abs(g32 - f64[i][k].numpy()).max() / change
                band = max(band, F32_ERROR_FACTOR * own)
            assert err <= band, f"{what} layer {i} {k}: {err:.3g} of its change > {band:.3g}"
            errs[(i, k)] = err
    return errs


def _fit(ref, policy=None):
    """The port's 3 steps of ``net.fit`` from the reference's start, under
    ``policy`` (f32 by default; f64 also casts the data)."""
    dt = np.float64 if policy is not None else np.float32
    if policy is not None:
        config.set_dtype_policy(policy)
    try:
        net = _port(ref)
        it = ArrayDataSetIterator(ref["x"].astype(dt), ref["y"].astype(dt), ref["batch"],
                                  shuffle=True, seed=5)
        watch = _Watch()
        assert net.fit(it, 1, listeners=[watch]) is net
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    return net, watch.losses


def test_fit_matches_jax_at_every_step(reference):
    net, losses = _fit(reference)
    assert len(losses) == STEPS == len(reference["losses"])
    np.testing.assert_allclose(losses, reference["losses"], rtol=LOSS_RTOL)
    f64, _ = _fit(reference, config.DTypePolicy(torch.float64, torch.float64, torch.float64))
    errs = assert_params_close(net.params_, reference["p3"], reference["p0"],
                               reference["name"], f64.params_)
    if reference["name"] == "mlp_mnist":   # Nesterovs: no entry needs the f32 band
        assert max(errs.values()) <= PARAM_TOL, errs


def test_params_vector_equals_jax(reference):
    net = _port(reference)
    flat = net.params()
    assert flat.device == net.device and flat.shape == (net.num_params(),)
    np.testing.assert_array_equal(flat.numpy(), reference["flat0"])


def test_set_params_score_iteration_and_epoch_follow_jax(reference):
    net = _port(reference)
    assert (net.iteration, net.epoch) == (0, 0) and np.isnan(net.score())
    net.fit(ArrayDataSetIterator(reference["x"], reference["y"], reference["batch"],
                                 shuffle=True, seed=5), 1)
    assert (net.iteration, net.epoch) == (reference["iteration"], reference["epoch"]) == (3, 1)
    np.testing.assert_allclose(net.score(), reference["score"], rtol=LOSS_RTOL)
    net.set_params(reference["p0"])
    assert all(t.device == net.device for d in net.params_ for t in d.values())
    out = net.output(reference["x"][:reference["batch"]]).numpy()
    np.testing.assert_allclose(out, reference["out0"], rtol=1e-5, atol=1e-6)


def test_trainer_fit_batch_trains_a_tiny_mlp():
    """The repair: a list net with Nesterovs and l2 takes Trainer steps and
    ``net.fit``, its params, updater state and counters moving."""
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Nesterovs(0.1, 0.9)).l2(1e-3)
            .list().layer(layers.DenseLayer(n_out=8, activation="relu"))
            .layer(layers.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    before = net.params().clone()
    loss = Trainer(net).fit_batch(DataSet(x, y))
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert isinstance(net.opt_state["trace"], list) and len(net.opt_state["trace"]) == 2
    assert not torch.equal(net.params(), before)
    net.fit(ArrayDataSetIterator(x, y, 4), epochs=2)
    assert (net.iteration, net.epoch) == (6, 2) and np.isfinite(net.score())


# ------------------------------------------------------------------ dropout
def _dropout_confs():
    """One stack in each package: conv (dropout 0.8) -> LRN -> DropoutLayer
    (0.7) -> max pool -> dense (0.9) -> output (0.75); each dropout sees an
    input of its own shape (the dense layer drops before it flattens)."""
    out = []
    for nnc, itype, lay in ((JNeuralNetConfiguration, JInputType, jlayers),
                            (NeuralNetConfiguration, InputType, layers)):
        upd = (JNesterovs if lay is jlayers else Nesterovs)(0.05, 0.9)
        out.append(nnc.builder().seed(7).updater(upd).weight_init("xavier").l2(1e-3).list()
                   .layer(lay.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu",
                                               dropout=0.8))
                   .layer(lay.LocalResponseNormalization(k=1.0, n=3, alpha=0.5, beta=0.75))
                   .layer(lay.DropoutLayer(dropout=0.7))
                   .layer(lay.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                               stride=(2, 2)))
                   .layer(lay.DenseLayer(n_out=6, activation="sigmoid", dropout=0.9))
                   .layer(lay.OutputLayer(n_out=3, activation="softmax", loss="mcxent",
                                          dropout=0.75))
                   .set_input_type(itype.convolutional(8, 8, 3)).build())
    return out


DROPOUT_BATCH = 5
# the input shape of each dropout -> its retain probability
DROPOUT_SHAPES = {(DROPOUT_BATCH, 8, 8, 3): 0.8, (DROPOUT_BATCH, 6, 6, 4): 0.7,
                  (DROPOUT_BATCH, 3, 3, 4): 0.9, (DROPOUT_BATCH, 6): 0.75}


@pytest.fixture(scope="module")
def dropout_reference():
    rng = np.random.default_rng(23)
    masks = {s: rng.random(s) < p for s, p in DROPOUT_SHAPES.items()}
    x = rng.normal(size=(DROPOUT_BATCH, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, DROPOUT_BATCH)]
    jconf, _ = _dropout_confs()
    jnet = JMultiLayerNetwork(jconf).init()
    p0, s0 = np_params(jnet.params_), np_params(jnet.state_)
    drawn = []

    def bernoulli(key, p, shape):
        drawn.append((tuple(shape), p))
        return jnp.asarray(masks[tuple(shape)])

    clear_step_cache()       # a step traced with the real draw must not be reused
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        loss = float(JTrainer(jnet).fit_batch(JDataSet(x, y), jax.random.key(0)))
    clear_step_cache()       # nor this one, traced with the patched draw
    jax.clear_caches()
    return {"masks": masks, "x": x, "y": y, "p0": p0, "s0": s0, "loss": loss,
            "p1": np_params(jnet.params_), "drawn": drawn}


def test_dropout_step_matches_jax_under_shared_masks(dropout_reference, monkeypatch):
    ref = dropout_reference
    # the reference draws the output layer's mask for its forward and its
    # score from one key: four shapes, the last drawn twice
    assert {s for s, _ in ref["drawn"]} == set(DROPOUT_SHAPES)
    drawn = []

    def keep_mask(shape, p, gen, device):
        drawn.append((tuple(shape), p))
        return torch.as_tensor(ref["masks"][tuple(shape)], device=device)

    monkeypatch.setattr(base, "_keep_mask", keep_mask)
    net = load_jax_params(MultiLayerNetwork(_dropout_confs()[1], device="cpu"),
                          ref["p0"], ref["s0"])
    loss = Trainer(net).fit_batch(DataSet(ref["x"], ref["y"]))
    assert sorted(drawn) == sorted(DROPOUT_SHAPES.items())   # one draw each
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    assert_params_close(net.params_, ref["p1"], ref["p0"], "dropout net")


def test_dropout_keeps_its_share_and_repeats_bit_for_bit():
    """Without patches: a fit's masks keep close to the retain probability
    (within 5 sigma), each batch draws new ones, inference draws nothing,
    and a second fit from the same weights draws the same masks (the
    stream is made from the config's seed)."""
    net = MultiLayerNetwork(_dropout_confs()[1], device="cpu").init()
    start = [{k: t.clone() for k, t in d.items()} for d in net.params_]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(20, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    runs = []
    for _ in range(2):
        masks = []
        draw = base._keep_mask

        def record(shape, p, gen, device, draw=draw, masks=masks):
            masks.append((draw(shape, p, gen, device), p))
            return masks[-1][0]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(base, "_keep_mask", record)
            net.set_params(start)
            net.fit(ArrayDataSetIterator(x, y, 10), 1)
            net.output(x)
        runs.append(masks)
    assert len(runs[0]) == 2 * len(DROPOUT_SHAPES)
    n = len(DROPOUT_SHAPES)       # the second batch draws new masks
    assert not any(torch.equal(a, b) for (a, _), (b, _) in zip(runs[0][:n], runs[0][n:]))
    for (m, p), (m2, _) in zip(*runs):
        share = m.float().mean().item()
        assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / m.numel()), (m.shape, share, p)
        assert torch.equal(m, m2)


def test_dropout_layer_and_dense_dropout_pass_through_at_inference():
    net = MultiLayerNetwork(_dropout_confs()[1], device="cpu").init()
    x = np.random.default_rng(2).normal(size=(3, 8, 8, 3)).astype(np.float32)
    layer = layers.DropoutLayer(dropout=0.5)
    xt = torch.as_tensor(x)
    assert layer.apply({}, {}, xt, train=False)[0] is xt
    assert layer.apply({}, {}, xt, train=True)[0] is xt        # no stream
    assert torch.equal(net.output(x), net.output(x))


def test_lrn_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 5, 5, 9)).astype(np.float32) * 3
    for kw in ({}, {"k": 1.0, "n": 3, "alpha": 0.5, "beta": 0.75}, {"n": 7, "alpha": 0.2}):
        want = np.array(jlayers.LocalResponseNormalization(**kw).apply({}, {}, jnp.asarray(x))[0])
        got = layers.LocalResponseNormalization(**kw).apply({}, {}, torch.as_tensor(x))[0]
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= LRN_TOL, (kw, err)


# ------------------------------------------------------------------ graph
def _graph_confs():
    out = []
    for nnc, itype, lay, vertex in (
            (JNeuralNetConfiguration, JInputType, jlayers, JElementWiseVertex),
            (NeuralNetConfiguration, InputType, layers, ElementWiseVertex)):
        gb = (nnc.builder().seed(9).weight_init("xavier").graph().add_inputs("in")
              .set_input_types(itype.feed_forward(6)))
        gb.add_layer("d1", lay.DenseLayer(n_out=5, activation="relu"), "in")
        gb.add_layer("d2", lay.DenseLayer(n_out=5, activation="sigmoid", dropout=0.6), "in")
        gb.add_vertex("add", vertex(op="add"), "d1", "d2")
        gb.add_layer("out", lay.OutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                     "add")
        out.append(gb.set_outputs("out").build())
    return out


def test_graph_evaluate_params_and_summary_match_jax():
    jconf, conf = _graph_confs()
    jnet = JComputationGraph(jconf).init()
    p0 = {v: {k: np.array(a) for k, a in d.items()} for v, d in jnet.params_.items()}
    s0 = {v: {k: np.array(a) for k, a in d.items()} for v, d in jnet.state_.items()}
    net = load_jax_params(ComputationGraph(conf, device="cpu"), p0, s0)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 30)]
    assert net.num_params() == jnet.num_params()
    np.testing.assert_array_equal(net.params().numpy(), np.array(jnet.params()))
    assert net.summary() == jnet.summary()
    for top_n in (1, 2):
        got = net.evaluate(ArrayDataSetIterator(x, y, 8), top_n=top_n)
        want = jnet.evaluate(JArrayDataSetIterator(x, y, 8), top_n=top_n)
        np.testing.assert_array_equal(got.confusion_matrix(), want.confusion_matrix())
        assert got.stats() == want.stats() and got.top_n_accuracy() == want.top_n_accuracy()
    # a graph with dropout set trains (its masks drawn from the trainer's stream)
    net.fit(ArrayDataSetIterator(x, y, 10), 1)
    assert net.iteration == 3 and np.isfinite(net.score())


# ------------------------------------------------------------------ zoo
ZOO = {"mlp_mnist": ({}, mlp_mnist), "lenet": ({"height": 32, "width": 32, "channels": 3}, lenet),
       "simple_cnn": ({}, simple_cnn), "alexnet": ({}, alexnet), "vgg16": ({}, vgg16),
       "vgg19": ({}, vgg19)}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_config_serializes_to_the_jax_json(name):
    """Configs only: no full-width AlexNet or VGG is initialised here."""
    kwargs, factory = ZOO[name]
    net = factory(device="cpu", **kwargs)
    assert net.params_ is None
    want = getattr(jzoo, name)(**kwargs).conf.to_json()
    assert json.loads(net.conf.to_json()) == json.loads(want)


def test_builder_dtype_reaches_the_json():
    def conf(nnc, itype, lay):
        return (nnc.builder().dtype("bfloat16").list()
                .layer(lay.OutputLayer(n_out=2, activation="softmax"))
                .set_input_type(itype.feed_forward(3)).build())
    got = conf(NeuralNetConfiguration, InputType, layers)
    assert got.dtype == "bfloat16"
    assert json.loads(got.to_json()) == json.loads(
        conf(JNeuralNetConfiguration, JInputType, jlayers).to_json())


def test_batch_norm_folds_in_f64_under_an_f64_policy():
    """Inference BN keeps an f64 net's running statistics, gamma and beta in
    f64 (the comparison of a net's f64 forward across devices relies on
    it), and stays in f32 under the f32 policy."""
    rng = np.random.default_rng(12)
    x, mean, gamma, beta = (rng.normal(size=s) for s in ((4, 3, 3, 5), 5, 5, 5))
    var = rng.random(5) + 0.5
    layer = layers.BatchNormalization(eps=1e-5)
    want = (x - mean) / np.sqrt(var + 1e-5) * gamma + beta
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        def t(a):
            return torch.as_tensor(a, dtype=dt)
        y, _ = layer.apply({"gamma": t(gamma), "beta": t(beta)},
                           {"mean": t(mean), "var": t(var)}, t(x))
        assert y.dtype == dt
        np.testing.assert_allclose(y.numpy(), want, rtol=tol, atol=tol)
