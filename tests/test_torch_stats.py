"""The port's per-layer statistics pipeline (``obs/stats.py``,
``make_train_step(with_stats=True)``, the trainer's sampling) held to the
JAX package's.

- ``device_layer_stats`` on the same seeded trees (a layer stack's list
  and a graph's dict; a constant layer, exact zeros, values on the bin
  edges).  ``min``, ``max``, ``hist_min`` and ``hist_max`` are held
  exactly; every other scalar within ``STAT_RTOL`` of the larger of its
  JAX value and the layer's mean magnitude (both packages sum in f32, in
  other orders); ``hist_counts`` exactly, except that a value within one
  f32 ulp of one of JAX's edges may land in the next bin: the counts may
  differ by at most twice the number of such values.
- One statistics step of a small stack and of a small graph against JAX's
  ``make_train_step(with_stats=True)`` from the same params (carried with
  ``interop.load_jax_params``).  The gradients and updates themselves
  differ by rounding here, so every scalar is held within ``STAT_RTOL``
  (as above), and a count may move only for a value whose own band
  (``STAT_RTOL`` of its magnitude or of the layer's mean magnitude)
  reaches one of JAX's edges; the vectors are JAX's own (``jax.grad`` of
  its loss, its optimizer's update).
- The statistics step leaves the params, layer state and updater state
  bit-equal to the plain step's, alone and through ``fit`` with a
  ``StatsListener``.
- A ``StatsListener``'s ``FileStatsStorage`` from the port's ``fit`` is
  read by the JAX package's class, and both packages render the same
  HTML from it.
- A ``HealthMonitor(frequency=1)`` on each package's ``fit``, one batch's
  features scaled by ``BLOWUP``, flags the same anomaly kinds at the same
  iterations (the port's ``fit`` fed no statistics to it before).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.obs import health as jhealth
from deeplearning4j_tpu.obs import stats as jstats
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer
from deeplearning4j_tpu.train.trainer import make_train_step as jmake_train_step

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import health, stats
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, set_registry
from deeplearning4j_tpu_torch.train import Adam, Sgd, Trainer
from deeplearning4j_tpu_torch.train.trainer import make_train_step
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

SEED = 20261018
STAT_RTOL = 1e-5
EXACT = ("min", "max", "hist_min", "hist_max")
BLOWUP = 1e5          # the planted batch's feature scale
BLOWN_BATCH = 3       # of HEALTH_BATCHES
HEALTH_BATCHES = 5
BATCH = 16


@pytest.fixture(autouse=True)
def fresh_registry():
    prev = set_registry(MetricsRegistry())
    yield
    set_registry(prev)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _host_jax(tree):
    """A JAX stats tree as numpy, one entry at a time (the reference side
    of the comparison, not timed)."""
    return jax.tree_util.tree_map(np.asarray, tree)


@jax.jit
def _jax_edges(lo, top):
    return jnp.histogram_bin_edges(jnp.zeros(1, jnp.float32), stats.NUM_BINS, range=(lo, top))


def _near_edges(vec, lo, top, band=None) -> int:
    """Values of ``vec`` within one f32 ulp (or within ``band``, an array
    like ``vec``) of one of JAX's bin edges."""
    edges = np.asarray(_jax_edges(jnp.asarray(lo, jnp.float32), jnp.asarray(top, jnp.float32)))
    if band is None:
        return int(sum(np.sum(np.abs(vec - e) <= u) for e, u in
                       zip(edges, np.spacing(np.abs(edges).astype(np.float32)))))
    return int(sum(np.sum(np.abs(vec - e) <= band) for e in edges))


def assert_layer_stats_match(got: dict, want: dict, vec: np.ndarray, where: str,
                             same_input: bool = True) -> dict:
    """One layer's statistics (host numbers) against JAX's (numpy), taken
    over the same vector (``same_input``) or over ones that differ by
    rounding; returns the largest scalar error and the count difference."""
    assert set(got) == set(want), where
    scale = max(abs(float(want["mean_magnitude"])), 1e-30)
    worst = 0.0
    for k in want:
        if k == "hist_counts":
            continue
        g, w = float(got[k]), float(want[k])
        if same_input and k in EXACT:
            assert g == w, f"{where} {k}: {g!r} != {w!r}"
        else:
            err = abs(g - w) / max(abs(w), scale)
            assert err <= STAT_RTOL, f"{where} {k}: {g!r} vs {w!r} ({err:.3g})"
            worst = max(worst, err)
    counts_got = np.asarray(got["hist_counts"], np.float64)
    counts_want = np.asarray(want["hist_counts"], np.float64)
    if same_input:
        assert counts_got.sum() == counts_want.sum(), where
    moved = int(np.abs(counts_got - counts_want).sum())
    if moved:
        band = None if same_input else STAT_RTOL * np.maximum(np.abs(vec), scale)
        near = _near_edges(vec, float(want["hist_min"]), float(want["hist_max"]), band)
        assert moved <= 2 * near, f"{where}: counts {counts_got} vs {counts_want}, {near} near"
    return {"scalar_err": worst, "counts_moved": moved}


def _vec(layer_tree) -> np.ndarray:
    leaves = [np.asarray(l, np.float32).ravel() for l in jax.tree_util.tree_leaves(layer_tree)]
    return np.concatenate(leaves)


def assert_tree_stats_match(got: dict, want: dict, tree, where: str) -> None:
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    layers_ = {str(k): sub for k, sub in items}
    assert set(got) == set(want), where
    for key in want:
        assert_layer_stats_match(got[key], want[key], _vec(layers_[key]), f"{where} {key}")


# ------------------------------------------------------------ the trees
def _trees():
    rng = np.random.default_rng(SEED)
    f = np.float32
    stack = [
        {"W": rng.normal(size=(7, 5)).astype(f), "b": rng.normal(size=5).astype(f) * 1e-3},
        {},                                                        # no params: no entry
        {"W": np.full((3, 4), 0.25, f), "b": np.zeros(4, f)},      # constant-ish, zeros
        {"W": np.linspace(-1, 1, 41, dtype=f).reshape(41, 1)},     # values on the edges
        {"gamma": np.ones(6, f), "beta": np.zeros(6, f), "W": rng.uniform(-3, 9, (64,)).astype(f)},
    ]
    graph = {"d1": {"W": rng.normal(size=(50, 20)).astype(f) * 30, "b": rng.normal(size=20).astype(f)},
             "merge": {}, "const": {"W": np.full((2, 2), -4.0, f)},
             "out": {"W": (rng.standard_cauchy(size=(20, 3)) * 1e-4).astype(f)}}
    return {"stack": stack, "graph": graph}


@pytest.mark.parametrize("kind", ["stack", "graph"])
def test_device_layer_stats_match_jax(kind):
    tree = _trees()[kind]
    # jitted, as the JAX trainer computes them inside its step
    want = _host_jax(jax.jit(jstats.device_layer_stats)(jax.tree_util.tree_map(jnp.asarray, tree)))
    ours = stats.device_layer_stats(tree_map(torch.as_tensor, tree))
    got = stats._host(ours)
    assert_tree_stats_match(got, want, tree, kind)
    assert stats.stats_keys(tree_map(torch.as_tensor, tree)) == list(ours)
    # the device tensors: f32 scalars, int64 counts; a maximum past the
    # rounded min + span falls out of the histogram in both packages
    for key, st in ours.items():
        assert st["hist_counts"].dtype == torch.int64 and st["norm"].dtype == torch.float32
        size = _vec(tree[int(key)] if kind == "stack" else tree[key]).size
        assert size - 1 <= int(st["hist_counts"].sum()) <= size


def test_pack_and_unpack_round_trip():
    tree = tree_map(torch.as_tensor, _trees()["stack"])
    groups = {g: stats.device_layer_stats(tree) for g in stats.GROUPS}
    packed = stats.pack_stats(groups)
    keys = stats.stats_keys(tree)
    assert packed.dtype == torch.float64
    assert packed.numel() == len(stats.GROUPS) * len(keys) * (len(stats.SCALARS) + stats.NUM_BINS)
    assert stats.unpack_stats(packed, keys) == {g: stats._host(groups[g]) for g in stats.GROUPS}
    with pytest.raises(ValueError, match="packed statistics"):
        stats.unpack_stats(packed[:-1], keys)


# ------------------------------------------------- the statistics step
def _stack_conf(mod, updater, second="tanh"):
    nn = JNeuralNetConfiguration if mod == "jax" else NeuralNetConfiguration
    it = JInputType if mod == "jax" else InputType
    ly = jlayers if mod == "jax" else layers
    return (nn.builder().seed(3).updater(updater).list()
            .layer(ly.DenseLayer(n_out=16, activation="relu"))
            .layer(ly.DenseLayer(n_out=8, activation=second))
            .layer(ly.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(6)).build())


def _graph_conf(mod, updater):
    nn = JNeuralNetConfiguration if mod == "jax" else NeuralNetConfiguration
    it = JInputType if mod == "jax" else InputType
    ly = jlayers if mod == "jax" else layers
    return (nn.builder().seed(4).updater(updater).graph()
            .add_inputs("in")
            .add_layer("hidden", ly.DenseLayer(n_out=12, activation="relu"), "in")
            .add_layer("out", ly.OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "hidden")
            .set_outputs("out").set_input_types(it.feed_forward(6)).build())


def _nets(kind, jupdater, updater, **conf):
    if kind == "stack":
        jnet = JMultiLayerNetwork(_stack_conf("jax", jupdater, **conf)).init()
        net = MultiLayerNetwork(_stack_conf("torch", updater, **conf), device="cpu")
    else:
        jnet = JComputationGraph(_graph_conf("jax", jupdater)).init()
        net = ComputationGraph(_graph_conf("torch", updater), device="cpu")
    return jnet, load_jax_params(net, _np_tree(jnet.params_), _np_tree(jnet.state_))


def _batch(n=BATCH, seed=0, scale=1.0):
    rng = np.random.default_rng(SEED + seed)
    x = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


@pytest.mark.parametrize("kind", ["stack", "graph"])
def test_with_stats_step_matches_jax(kind):
    from deeplearning4j_tpu.train.trainer import make_loss_fn as jmake_loss_fn
    jnet, net = _nets(kind, JAdam(1e-2), Adam(1e-2))
    x, y = _batch()
    jtrainer = JTrainer(jnet)
    jtrainer._ensure_ready()
    args = (jnp.asarray(x), jnp.asarray(y), None, None, jax.random.key(0))
    # JAX's gradient and update, for the vectors the counts are bounded on
    loss_fn = jmake_loss_fn(jnet)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, jnet.state_, *args)[0]))(jnet.params_)
    updates, _ = jax.jit(jtrainer.tx.update)(grads, jnet.opt_state, jnet.params_)
    vectors = {"gradients": grads, "updates": updates}
    jstep = jmake_train_step(jnet, jtrainer.tx, with_stats=True)
    jp, _, _, jloss, jst = jstep(jnet.params_, jnet.state_, jnet.opt_state, *args)
    vectors["params"] = jp
    want = _host_jax(jst)
    trainer = Trainer(net)
    trainer._ensure_ready()
    step = make_train_step(net, trainer.tx, with_stats=True)
    _, _, _, loss, packed = step(net.params_, net.state_, net.opt_state, torch.as_tensor(x),
                                 torch.as_tensor(y), None, None, torch.Generator())
    got = stats.unpack_stats(packed, stats.stats_keys(net.params_))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(got) == set(want) == set(stats.GROUPS)
    for group in stats.GROUPS:
        layers_ = dict(enumerate(vectors[group])) if kind == "stack" else vectors[group]
        assert set(got[group]) == set(want[group]) == set(want["params"]), group
        for key in want[group]:
            vec = _vec(layers_[int(key) if kind == "stack" else key])
            assert_layer_stats_match(got[group][key], want[group][key], vec, f"{group} {key}",
                                     same_input=False)


def _snapshot(net):
    return [t.clone() for t in tree_leaves(net.params_) + tree_leaves(net.state_)
            + tree_leaves(net.opt_state)]


def test_stats_step_leaves_the_plain_steps_params():
    _, net = _nets("stack", JAdam(1e-2), Adam(1e-2))
    start = [tree_map(lambda t: t.clone(), tree) for tree in (net.params_, net.state_)]
    trainer = Trainer(net)
    trainer._ensure_ready()
    x, y = (torch.as_tensor(a) for a in _batch())
    out = {}
    for with_stats in (False, True):
        net.params_, net.state_ = (tree_map(lambda t: t.clone(), t) for t in start)
        net.opt_state = trainer.tx.init(net.params_)
        step = make_train_step(net, trainer.tx, with_stats=with_stats)
        for i in range(3):
            step(net.params_, net.state_, net.opt_state, x, y, None, None,
                 torch.Generator().manual_seed(i))
        out[with_stats] = _snapshot(net)
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True], strict=True))


def test_fit_with_a_stats_listener_leaves_the_same_params(tmp_path):
    runs = {}
    batches = [_batch(seed=i) for i in range(4)]
    for sampled in (False, True):
        _, net = _nets("stack", JAdam(1e-2), Adam(1e-2))
        storage = stats.InMemoryStatsStorage()
        listeners = [stats.StatsListener(storage, frequency=2)] if sampled else []
        net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=2,
                listeners=listeners)
        runs[sampled] = (_snapshot(net), storage.all())
    assert all(torch.equal(a, b) for a, b in zip(runs[False][0], runs[True][0], strict=True))
    records = runs[True][1]
    assert [r["type"] for r in records] == ["init"] + ["stats", "score"] * 4
    assert [r["iteration"] for r in records[1:]] == list(range(8))
    assert set(records[1]) == {"type", "iteration", "epoch", "score", *stats.GROUPS}


# --------------------------------------------------- storage and report
def test_file_storage_replays_in_jax_and_renders_alike(tmp_path):
    path = str(tmp_path / "stats.jsonl")
    _, net = _nets("graph", JAdam(1e-2), Adam(1e-2))
    storage = stats.FileStatsStorage(path)
    net.fit(ListDataSetIterator([DataSet(*_batch(seed=i)) for i in range(3)]), epochs=2,
            listeners=[stats.StatsListener(storage, frequency=2)])
    storage.close()
    replayed = jstats.FileStatsStorage(path)
    assert replayed.all() == storage.all()
    assert replayed.all()[0] == {"type": "init", "model": jstats.model_topology(
        JComputationGraph(_graph_conf("jax", JAdam(1e-2))))}
    assert stats.render_html(replayed) == jstats.render_html(replayed)
    reopened = stats.FileStatsStorage(path)
    assert reopened.all() == storage.all()
    reopened.close()
    replayed.close()


@pytest.mark.parametrize("kind", ["stack", "graph"])
def test_model_topology_matches_jax(kind):
    conf = _stack_conf if kind == "stack" else _graph_conf
    jnet = (JMultiLayerNetwork if kind == "stack" else JComputationGraph)(conf("jax", JSgd(0.1)))
    net = (MultiLayerNetwork if kind == "stack" else ComputationGraph)(conf("torch", Sgd(0.1)),
                                                                     device="cpu")
    assert stats.model_topology(net) == jstats.model_topology(jnet)


def test_html_report_renders(tmp_path):
    _, net = _nets("stack", JAdam(1e-2), Adam(1e-2))
    storage = stats.InMemoryStatsStorage()
    net.fit(ListDataSetIterator([DataSet(*_batch(seed=i)) for i in range(3)]), epochs=1,
            listeners=[stats.StatsListener(storage, frequency=1)])
    out = stats.render_html_report(storage, str(tmp_path / "report.html"), title="run")
    text = open(out).read()
    assert text.startswith("<html>") and text.rstrip().endswith("</html>")
    for heading in ("<h2>Model</h2>", "<h2>Score (loss)</h2>", "params: L2 norm per layer",
                    "gradients: L2 norm per layer", "updates: L2 norm per layer",
                    "Latest parameter histograms"):
        assert heading in text
    assert text.count("<polyline") >= 1 + 3 * 3 and text.count("<rect") > 3 * stats.NUM_BINS
    assert text == jstats.render_html(storage, title="run")


# --------------------------------------------------- the health monitor
def _health_batches():
    return [_batch(seed=10 + i, scale=BLOWUP if i == BLOWN_BATCH else 1.0)
            for i in range(HEALTH_BATCHES)]


def _flags(monitor) -> list:
    return [(a["iteration"], a["kind"], a.get("layer")) for a in monitor.anomalies]


def test_health_monitor_on_fit_flags_what_jax_flags():
    jnet, net = _nets("stack", JSgd(0.05), Sgd(0.05), second="relu")
    batches = _health_batches()
    jmonitor = jhealth.HealthMonitor(frequency=1)
    jnet.fit(JListDataSetIterator([JDataSet(x, y) for x, y in batches]), epochs=1,
             listeners=[jmonitor])
    monitor = health.HealthMonitor(frequency=1)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=1,
            listeners=[monitor])
    want = _flags(jmonitor)
    assert (BLOWN_BATCH, "grad_explosion", None) in want     # the planted blow-up
    assert _flags(monitor) == want
    for ours, theirs in zip(monitor.anomalies, jmonitor.anomalies):
        if "grad_norm" in theirs:
            assert ours["grad_norm"] == pytest.approx(theirs["grad_norm"], rel=1e-5)
