"""The port's updaters and losses held to the JAX package.

Updaters: the JAX package's JSON for ``Sgd``, ``Nesterovs``, ``Adam`` and
``NoOp`` builds both packages' updaters; three steps on a small tree of
numpy-seeded gradients give optax's updates and state at 1e-6 (f32, the
same arithmetic in the same order up to the bias-correction powers).
Losses: every ported loss, with and without a labels mask through
``mean_score``, against the JAX function on the same inputs at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.train import updaters as jupdaters

from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.train import updaters

JSON = [
    {"type": "sgd", "learning_rate": 0.05},
    {"type": "nesterovs", "learning_rate": 0.1, "momentum": 0.9},
    {"type": "adam", "learning_rate": 0.01, "beta1": 0.8, "beta2": 0.95, "epsilon": 1e-6,
     "mu_dtype": None},
    {"type": "noop"},
]


def _tree(rng):
    return {"l0": {"W": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": rng.normal(size=3).astype(np.float32)},
            "pool": {},
            "l1": {"gamma": rng.normal(size=5).astype(np.float32)}}


@pytest.mark.parametrize("conf", JSON, ids=[c["type"] for c in JSON])
def test_updates_match_optax(conf):
    jtx = jupdaters.from_dict(conf).to_optax()
    tu = updaters.from_dict(conf)
    assert tu.to_dict() == jupdaters.from_dict(conf).to_dict()
    rng = np.random.default_rng(4)
    params = _tree(rng)
    jstate = jtx.init(params)
    tstate = tu.init({v: {k: torch.from_numpy(a) for k, a in d.items()}
                      for v, d in params.items()})
    for step in range(3):
        grads = _tree(rng)
        jup, jstate = jtx.update(grads, jstate, params)
        tup, tstate = tu.update({v: {k: torch.from_numpy(a) for k, a in d.items()}
                                 for v, d in grads.items()}, tstate)
        for v, d in grads.items():
            for k in d:
                np.testing.assert_allclose(tup[v][k].numpy(), np.asarray(jup[v][k]),
                                           rtol=1e-6, atol=1e-6, err_msg=f"step {step} {v}.{k}")
    if conf["type"] == "adam":
        assert int(tstate["count"]) == int(jstate[0].count) == 3


def _deep_tree(rng):
    """BERT-shaped nesting: leaves four and five levels down, an empty
    branch, a leaf beside a branch."""
    return {"encoder": {"layer_0": {"attention": {"query": {
                "kernel": rng.normal(size=(4, 4)).astype(np.float32),
                "bias": rng.normal(size=4).astype(np.float32)}},
            "output_layer_norm": {"gamma": rng.normal(size=4).astype(np.float32)}}},
            "pooler": {},
            "mlm": {"output_bias": rng.normal(size=6).astype(np.float32),
                    "transform": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("conf", JSON, ids=[c["type"] for c in JSON])
def test_updates_match_optax_on_a_deep_tree(conf):
    """Trees of any depth (BERT's ``encoder/layer_N/attention/query/kernel``):
    three steps against optax at 1e-6, every leaf compared."""
    jtx = jupdaters.from_dict(conf).to_optax()
    tu = updaters.from_dict(conf)
    rng = np.random.default_rng(5)
    params = _deep_tree(rng)
    jstate, tstate = jtx.init(params), tu.init(_torch_tree(params))
    for step in range(3):
        grads = _deep_tree(rng)
        jup, jstate = jtx.update(grads, jstate, params)
        tup, tstate = tu.update(_torch_tree(grads), tstate)
        paths = [p for p, _ in _leaves(grads)]
        assert [p for p, _ in _leaves(tup)] == paths and len(paths) == 5
        for path in paths:
            np.testing.assert_allclose(_get(tup, path).numpy(), np.asarray(_get(jup, path)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {step} {path}")


def _two_level_tree_map(fn, *trees):
    """``tree_map`` as it was before trees of any depth: vertex -> name ->
    tensor only."""
    return {v: {k: fn(*(t[v][k] for t in trees)) for k in d} for v, d in trees[0].items()}


@pytest.fixture(scope="module")
def resnet_tree():
    """A ResNet-50's param tree (vertex -> name -> tensor) and two seeded
    gradient trees of its shapes."""
    from deeplearning4j_tpu_torch.models import resnet50
    params = resnet50(height=32, width=32, num_classes=10, device="cpu").init(seed=1).params_
    gen = torch.Generator().manual_seed(2)
    grads = [updaters.tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
             for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("conf", JSON, ids=[c["type"] for c in JSON])
def test_resnet_updates_are_unchanged_by_the_tree_repair(conf, resnet_tree, monkeypatch):
    """On a ResNet-50's param tree the updaters give bit-identical updates
    and state with the any-depth ``tree_map`` and with the two-level one
    it replaced."""
    params, grads = resnet_tree

    def run():
        tu = updaters.from_dict(conf)
        state = tu.init(params)
        outs = []
        for g in grads:
            u, state = tu.update(g, state)
            outs.append((u, state))
        return outs

    new = run()
    monkeypatch.setattr(updaters, "tree_map", _two_level_tree_map)
    old = run()
    for (un, sn), (uo, so) in zip(new, old):
        for tree_new, tree_old in [(un, uo)] + [(sn[k], so[k]) for k in sn if k != "count"]:
            for v, d in tree_old.items():
                for k, t in d.items():
                    assert torch.equal(tree_new[v][k], t), (v, k)


def test_unported_updaters_and_normalizations_raise():
    # every updater and schedule of the reference is ported; a name the
    # reference does not know raises
    with pytest.raises(ValueError, match="unknown updater 'lars'"):
        updaters.from_dict({"type": "lars", "learning_rate": 0.1})
    sched = updaters.from_dict({"type": "sgd", "learning_rate": {"type": "step",
                                                                 "initial_value": 0.1}})
    assert sched.scheduled and sched.to_dict()["learning_rate"]["type"] == "step"
    # every normalization is ported; a name the reference does not know raises
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        updaters.gradient_normalization("clip_l2_per_everything")
    grads = {"l0": {"W": torch.ones(2)}}
    assert updaters.gradient_normalization("none")(grads) is grads
    assert updaters.gradient_normalization(None)(grads) is grads


LOSSES = [("mcxent", "softmax"), ("mcxent", "sigmoid"), ("binary_xent", "sigmoid"),
          ("binary_xent", "identity"), ("mse", "identity"), ("l2", "identity"),
          ("mae", "identity"), ("l1", "identity"), ("mape", "identity"),
          ("msle", "identity"), ("kld", "softmax"), ("poisson", "relu"),
          ("hinge", "identity"), ("squared_hinge", "identity"),
          ("cosine_proximity", "identity"), ("wasserstein", "identity"),
          ("fmeasure", "sigmoid"), ("huber", "identity"), ("log_poisson", "identity"),
          ("log_poisson_full", "identity"), ("weighted_cross_entropy_with_logits", "identity"),
          ("mean_pairwise_squared_error", "identity")]


@pytest.mark.parametrize("name,act", LOSSES, ids=[f"{n}-{a}" for n, a in LOSSES])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_mean_score_match_jax(name, act, masked):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(6, 4)).astype(np.float32)
    if name in ("mcxent", "kld"):
        labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    elif name in ("binary_xent", "fmeasure", "weighted_cross_entropy_with_logits"):
        labels = rng.integers(0, 2, (6, 4)).astype(np.float32)
    else:
        labels = rng.uniform(0.0, 3.0, (6, 4)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None
    jscore = jlosses.get(name)(jnp.asarray(labels), jnp.asarray(z), act, None)
    tscore = losses.get(name)(torch.from_numpy(labels), torch.from_numpy(z), act, None)
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), rtol=1e-6, atol=1e-6)
    jmean = jlosses.mean_score(jscore, None if mask is None else jnp.asarray(mask))
    tmean = losses.mean_score(tscore, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tmean.item(), float(jmean), rtol=1e-6, atol=1e-6)


def test_sparse_mcxent_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.normal(size=(5, 7)).astype(np.float32)
    idx = rng.integers(0, 7, 5)
    np.testing.assert_allclose(
        losses.get("sparse_mcxent")(torch.from_numpy(idx), torch.from_numpy(z)).numpy(),
        np.asarray(jlosses.get("sparse_mcxent")(jnp.asarray(idx), jnp.asarray(z))),
        rtol=1e-6, atol=1e-6)
    assert set(losses.names()) == set(jlosses.names())


def _mlp(pkg, updater):
    """A dense + softmax-output graph, built by either package's API."""
    conf = (pkg.NeuralNetConfiguration.builder().seed(3).updater(updater).weight_init("relu")
            .l2(1e-3).graph().add_inputs("in")
            .set_input_types(pkg.InputType.feed_forward(8))
            .add_layer("dense", pkg.DenseLayer(n_out=16, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                       "dense")
            .set_outputs("out").build())
    return conf


def test_adam_state_carried_from_jax_continues_the_run():
    """Two JAX Adam steps on a dense graph; the port, given the JAX params
    and optimizer state (count, mu, nu) after step 1, takes step 2 and
    lands on the JAX params at 1e-6."""
    import types

    import jax
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn import InputType as JInputType, NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense, OutputLayer as JOutput
    from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.interop import load_jax_opt_state, load_jax_params
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.train import Adam, Trainer

    jpkg = types.SimpleNamespace(NeuralNetConfiguration=JConf, InputType=JInputType,
                                 DenseLayer=JDense, OutputLayer=JOutput)
    tpkg = types.SimpleNamespace(NeuralNetConfiguration=NeuralNetConfiguration,
                                 InputType=InputType, DenseLayer=DenseLayer,
                                 OutputLayer=OutputLayer)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    jnet = JGraph(_mlp(jpkg, jupdaters.Adam(0.01))).init()
    jtrainer = JTrainer(jnet)
    jtrainer.fit_batch(JDataSet(x, y), jax.random.key(0))
    tree = lambda t: {v: {k: np.array(a) for k, a in d.items()} for v, d in t.items()}  # noqa: E731
    p1, s1 = tree(jnet.params_), tree(jnet.state_)
    opt1 = jax.tree_util.tree_map(np.array, jnet.opt_state)   # the next step donates it
    loss2 = float(jtrainer.fit_batch(JDataSet(x, y), jax.random.key(1)))

    net = load_jax_params(ComputationGraph(_mlp(tpkg, Adam(0.01)), device="cpu"), p1, s1)
    load_jax_opt_state(net, opt1)
    assert int(net.opt_state["count"]) == 1
    loss = Trainer(net).fit_batch(DataSet(x, y))
    np.testing.assert_allclose(loss.item(), loss2, rtol=1e-6)
    for v, d in tree(jnet.params_).items():
        for k, e in d.items():
            np.testing.assert_allclose(net.params_[v][k].numpy(), e, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{v}.{k}")
    assert int(net.opt_state["count"]) == 2


def test_output_layer_scores_and_applies_from_one_product(monkeypatch):
    """A training forward through a graph computes the output layer's
    ``x @ W + b`` once and derives both the activated output and the
    per-example loss from it; both equal the separate ``apply`` and
    ``compute_score_array``."""
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.models import resnet50

    rng = np.random.default_rng(7)
    layer = OutputLayer(n_out=5, activation="softmax", loss="mcxent")
    params = {"W": torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=5).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    labels = torch.eye(5)[torch.from_numpy(rng.integers(0, 5, 4))]
    y, state, scores = layer.apply_and_score(params, {}, x, labels, train=True)
    torch.testing.assert_close(y, layer.apply(params, {}, x, train=True)[0], rtol=0, atol=0)
    torch.testing.assert_close(scores, layer.compute_score_array(params, {}, x, labels,
                                                                 train=True), rtol=0, atol=0)
    assert state == {}

    net = resnet50(height=32, width=32, num_classes=10, device="cpu").init(seed=1)
    calls = []
    real = OutputLayer.pre_output
    monkeypatch.setattr(OutputLayer, "pre_output",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    feats = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out, _, score_array = net._forward(net.params_, net.state_, feats, train=True,
                                           labels=torch.eye(10)[:2])
    assert len(calls) == 1 and tuple(out.shape) == (2, 10) and tuple(score_array.shape) == (2,)
