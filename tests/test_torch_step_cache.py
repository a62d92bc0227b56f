"""The port's step cache (``train/step_cache.py``) and captured step
(``train/capture.py``) held to the JAX package's step cache, on the CPU.

- Key parity: configurations that differ in seed, width, learning rate,
  updater or gradient normalization, under the f32 and the bf16 policy,
  fall into the same groups of equal keys in both packages (the keys
  themselves differ: the port's dtype names are torch's).
- The cache itself: hits, misses, LRU eviction at ``MAX_ENTRIES``, the
  ``None`` key's bypass and ``clear_step_cache``.
- ``MultiLayerNetwork.fit`` twice: one miss, then one hit, and the params
  after both within ``PARAM_TOL`` of the JAX package's two fits from the
  same weights (dropout 0; f32 summation order alone).
- Two nets of one configuration on one cached step each give the bits of
  the same steps run alone, with an empty cache.
- Adam's bias corrections, now made from the device count alone, equal
  optax's bit for bit at every count, and 5 steps of Adam (f32 and bf16
  mu) give optax's mu bit for bit and its updates within ``UPDATE_TOL``
  (as ``test_torch_adam_bf16.py`` holds them).
- The parts of the captured step that run without a card: the batch
  signature, a second tree taking over the static buffers
  (``Tensor.set_``) while the first keeps its values, and the int8
  kernel's padded weight copy made in the graph while capturing.

Both packages' caches are cleared around every test; the reference runs
once per fixture.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu import config as jconfig
from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator as JArrayDataSetIterator
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.train import step_cache as jstep_cache
from deeplearning4j_tpu.train import updaters as jupdaters

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration, layers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.kernels import quant_matmul
from deeplearning4j_tpu_torch.train import Trainer, capture, step_cache, updaters
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

# PARAM_TOL: of each param's change over the fits, as test_torch_multilayer_train.py
# holds it (one f32 ulp of an entry is ~3e-4 of a change this small)
PARAM_TOL, UPDATE_TOL = 1e-3, 1e-6
ADAM_LR, ADAM_STEPS = 1e-3, 5
BATCH, FEATURES, CLASSES = 8, 12, 3

# name: (seed, hidden width, updater as (class name, kwargs), gradient normalization)
VARIANTS = {
    "base": (1, 16, ("Adam", {"learning_rate": 1e-3}), None),
    "same": (1, 16, ("Adam", {"learning_rate": 1e-3}), None),
    "seed": (2, 16, ("Adam", {"learning_rate": 1e-3}), None),
    "width": (1, 32, ("Adam", {"learning_rate": 1e-3}), None),
    "lr": (1, 16, ("Adam", {"learning_rate": 2e-3}), None),
    "nesterovs": (1, 16, ("Nesterovs", {"learning_rate": 1e-3, "momentum": 0.9}), None),
    "nesterovs_same": (1, 16, ("Nesterovs", {"learning_rate": 1e-3, "momentum": 0.9}), None),
    "normalized": (1, 16, ("Adam", {"learning_rate": 1e-3}), "ClipL2PerLayer"),
}


def _conf(pkg, name):
    """The variant's ``.list()`` configuration in the JAX package
    (``pkg="jax"``) or the port."""
    seed, width, (updater, kwargs), norm = VARIANTS[name]
    if pkg == "jax":
        builder, lay, itype, upd = JNeuralNetConfiguration, jlayers, JInputType, jupdaters
    else:
        builder, lay, itype, upd = NeuralNetConfiguration, layers, InputType, updaters
    b = builder.builder().seed(seed).updater(getattr(upd, updater)(**kwargs))
    if norm is not None:
        b = b.gradient_normalization(norm)
    return (b.list()
            .layer(lay.DenseLayer(n_out=width, activation="relu"))
            .layer(lay.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(itype.feed_forward(FEATURES)).build())


def _key(pkg, name, policy):
    if pkg == "jax":
        jconfig.set_dtype_policy(getattr(jconfig.DTypePolicy, policy)())
        try:
            conf = _conf("jax", name)
            return (jstep_cache.net_signature(JMultiLayerNetwork(conf))
                    + (jstep_cache.updater_signature(conf),))
        finally:
            jconfig.set_dtype_policy(jconfig.DTypePolicy.f32())
    config.set_dtype_policy(getattr(config.DTypePolicy, policy)())
    try:
        conf = _conf("torch", name)
        return (step_cache.net_signature(MultiLayerNetwork(conf, device="cpu"))
                + (step_cache.updater_signature(conf),))
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())


@pytest.fixture(autouse=True)
def empty_caches():
    jstep_cache.clear_step_cache()
    step_cache.clear_step_cache()
    yield
    jstep_cache.clear_step_cache()
    step_cache.clear_step_cache()


CASES = [(name, policy) for policy in ("f32", "bf16") for name in VARIANTS]


@pytest.fixture(scope="module")
def keys():
    return {pkg: [_key(pkg, name, policy) for name, policy in CASES] for pkg in ("jax", "torch")}


@pytest.mark.parametrize("i", range(len(CASES)), ids=[f"{n}-{p}" for n, p in CASES])
def test_keys_group_configs_as_the_reference_does(keys, i):
    """Case i's key equals exactly the keys of the cases whose reference
    key equals its reference key."""
    jkeys, tkeys = keys["jax"], keys["torch"]
    assert None not in tkeys and None not in jkeys
    assert ([j for j in range(len(CASES)) if tkeys[j] == tkeys[i]]
            == [j for j in range(len(CASES)) if jkeys[j] == jkeys[i]])


def test_key_groups_are_the_expected_ones(keys):
    """Only the repeated configurations share a key: each of seed, width,
    lr, updater, normalization and policy splits."""
    groups = {}
    for case, key in zip(CASES, keys["torch"]):
        groups.setdefault(key, []).append(case)
    assert sorted(len(g) for g in groups.values()) == [1] * 8 + [2] * 4
    assert [("base", "f32"), ("same", "f32")] in groups.values()
    assert [("nesterovs", "bf16"), ("nesterovs_same", "bf16")] in groups.values()


def test_a_conf_without_json_or_with_an_unported_updater_is_not_cached():
    class Bare:
        conf = None
    assert step_cache.net_signature(Bare()) is None
    conf = _conf("torch", "base")
    conf.updater = {"type": "lars", "learning_rate": 1e-3}    # no such updater
    assert step_cache.updater_signature(conf) is None
    assert step_cache.sharding_signature(None) == ""
    with pytest.raises(NotImplementedError, match="parallel"):
        step_cache.sharding_signature({"params": "dp2"})


def _counts():
    c = step_cache.counters()
    return c[step_cache.HITS], c[step_cache.MISSES]


def test_hits_misses_and_clear():
    h0, m0 = _counts()
    built = []

    def build():
        built.append(object())
        return built[-1]
    a = step_cache.get_or_build(("k", 1), build)
    assert _counts() == (h0, m0 + 1) and step_cache.cache_size() == 1
    assert step_cache.get_or_build(("k", 1), build) is a and len(built) == 1
    assert _counts() == (h0 + 1, m0 + 1)
    b = step_cache.get_or_build(("k", 2), build)
    assert b is not a and step_cache.cached_steps() == [a, b]
    step_cache.clear_step_cache()
    assert step_cache.cache_size() == 0 and step_cache.cached_steps() == []
    assert step_cache.get_or_build(("k", 1), build) is not a
    assert _counts() == (h0 + 1, m0 + 3)


def test_none_key_bypasses_the_cache():
    before = _counts()
    first, second = (step_cache.get_or_build(None, object) for _ in range(2))
    assert first is not second
    assert step_cache.cache_size() == 0 and _counts() == before


def test_lru_eviction_at_max_entries():
    """Past ``MAX_ENTRIES`` keys the least recently used goes: key 0,
    touched again, outlives key 1."""
    steps = [step_cache.get_or_build(("k", i), object) for i in range(step_cache.MAX_ENTRIES)]
    assert step_cache.cache_size() == step_cache.MAX_ENTRIES
    assert step_cache.get_or_build(("k", 0), object) is steps[0]          # now most recent
    step_cache.get_or_build(("k", "new"), object)
    assert step_cache.cache_size() == step_cache.MAX_ENTRIES
    assert step_cache.get_or_build(("k", 0), object) is steps[0]
    before = _counts()
    assert step_cache.get_or_build(("k", 1), object) is not steps[1]      # evicted: rebuilt
    assert _counts() == (before[0], before[1] + 1)


def _data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4 * BATCH, FEATURES)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 4 * BATCH)]
    return x, y


@pytest.fixture(scope="module")
def reference_fits():
    """The JAX package's net fitted twice (two batches each) from its
    initial weights; the start and the end as numpy."""
    jstep_cache.clear_step_cache()
    jnet = JMultiLayerNetwork(_conf("jax", "nesterovs")).init()
    p0 = [{k: np.array(a) for k, a in d.items()} for d in jnet.params_]
    s0 = [{k: np.array(a) for k, a in d.items()} for d in jnet.state_]
    x, y = _data()
    for half in (slice(0, 2 * BATCH), slice(2 * BATCH, None)):
        jnet.fit(JArrayDataSetIterator(x[half], y[half], BATCH), 1)
    jstep_cache.clear_step_cache()
    return p0, s0, [{k: np.array(a) for k, a in d.items()} for d in jnet.params_]


def test_two_fits_miss_once_then_hit_and_match_the_reference(reference_fits):
    p0, s0, want = reference_fits
    net = load_jax_params(MultiLayerNetwork(_conf("torch", "nesterovs"), device="cpu").init(),
                          p0, s0)
    x, y = _data()
    h0, m0 = _counts()
    net.fit(ArrayDataSetIterator(x[:2 * BATCH], y[:2 * BATCH], BATCH), 1)
    assert _counts() == (h0, m0 + 1)
    net.fit(ArrayDataSetIterator(x[2 * BATCH:], y[2 * BATCH:], BATCH), 1)
    assert _counts() == (h0 + 1, m0 + 1) and step_cache.cache_size() == 1
    assert net.iteration == 4
    for got, ref, start in zip(net.params_, want, p0):
        for k, w in ref.items():
            change = np.abs(w - start[k]).max()
            assert change > 0
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=PARAM_TOL * change)


def _trees(net):
    return [t.clone() for t in tree_leaves([net.params_, net.state_, net.opt_state])]


def test_two_nets_share_one_step_and_each_matches_its_run_alone():
    x, y = _data()
    batches = [DataSet(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
               for i in range(4)]
    conf = _conf("torch", "base")

    def net(seed):
        return MultiLayerNetwork(conf, device="cpu").init(seed=seed)

    def run(trainer, steps):
        gen = torch.Generator().manual_seed(7)
        return [trainer.fit_batch(batches[i], gen) for i in steps]
    a, b = net(11), net(12)
    ta, tb = Trainer(a), Trainer(b)
    losses = {"a": run(ta, range(2)), "b": run(tb, range(4))}
    losses["a"] += run(ta, range(2, 4))
    assert ta._step is tb._step and step_cache.cache_size() == 1
    for name, seed in (("a", 11), ("b", 12)):
        step_cache.clear_step_cache()
        alone = net(seed)
        ta2 = Trainer(alone)
        alone_losses = run(ta2, range(2)) + run(ta2, range(2, 4))
        got = _trees(a if name == "a" else b)
        assert all(torch.equal(p, q) for p, q in zip(got, _trees(alone)))
        assert all(torch.equal(p, q) for p, q in zip(losses[name], alone_losses))


@pytest.mark.parametrize("count", range(1, ADAM_STEPS + 1))
@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_correction_from_the_count_equals_optax(decay, count):
    """``m / (1 - b ** count)`` as the port computes it (a float base and
    the device count) against optax's ``bias_correction``, bit for bit."""
    m = np.random.default_rng(count).normal(size=64).astype(np.float32)
    want = np.asarray(optax.tree.bias_correction(jnp.asarray(m), decay,
                                                 jnp.asarray(count, jnp.int32)))
    steps = torch.tensor(count, dtype=torch.int32).to(torch.float32)
    got = (torch.from_numpy(m) / (1 - torch.pow(decay, steps))).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module", params=[None, "bf16"], ids=["f32_mu", "bf16_mu"])
def adam_runs(request):
    """ADAM_STEPS steps of optax's Adam and the port's on the same params
    and gradients (numpy seed): per step updates, mu, nu and count."""
    mu_dtype = request.param
    rng = np.random.default_rng(5)
    shapes = {"w": (32, 16), "b": (16,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(ADAM_STEPS)]
    tx = jupdaters.Adam(ADAM_LR, mu_dtype=mu_dtype).to_optax()
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    port = updaters.Adam(ADAM_LR, mu_dtype=mu_dtype)
    tstate = port.init({k: torch.from_numpy(v) for k, v in params.items()})
    out = []
    for g in grads:
        jupd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tupd, tstate = port.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        adam = jstate[0]
        out.append({"updates": ({k: np.asarray(v) for k, v in jupd.items()},
                                {k: v.numpy() for k, v in tupd.items()}),
                    "mu": ({k: np.asarray(v, np.float32) for k, v in adam.mu.items()},
                           {k: v.float().numpy() for k, v in tstate["mu"].items()}),
                    "nu": ({k: np.asarray(v) for k, v in adam.nu.items()},
                           {k: v.numpy() for k, v in tstate["nu"].items()}),
                    "count": (int(adam.count), int(tstate["count"]))})
    return out


@pytest.mark.parametrize("step", range(ADAM_STEPS))
def test_adam_steps_match_optax(adam_runs, step):
    run = adam_runs[step]
    assert run["count"][0] == run["count"][1] == step + 1
    for part in ("mu", "nu"):
        want, got = run[part]
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (part, k)
    want, got = run["updates"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=UPDATE_TOL * np.abs(want[k]).max())


def test_batch_signature_names_shapes_dtypes_and_absent_masks():
    x = torch.zeros(4, 3)
    gen = torch.Generator()
    a = capture._batch_signature((x, None, gen))
    assert a == capture._batch_signature((torch.ones(4, 3), None, torch.Generator()))
    assert a != capture._batch_signature((x, torch.ones(4), gen))
    assert a != capture._batch_signature((torch.zeros(5, 3), None, gen))
    assert a != capture._batch_signature((x.double(), None, gen))
    with pytest.raises(TypeError, match="captured step takes"):
        capture._batch_signature((x, 3))


def test_a_second_tree_takes_the_buffers_and_the_first_keeps_its_values():
    """``_adopt``: the new holder's tensors share the buffers' memory with
    its own values; the old holder's tensors keep theirs in memory of
    their own, and a write to the buffers reaches only the new holder."""
    first = [torch.arange(4.0), torch.ones(2, 2)]
    binding = capture._Binding([t.detach() for t in first], list(first))
    second = [torch.full((4,), 7.0), torch.full((2, 2), 3.0)]
    capture.CapturedStep._adopt(binding, second)
    assert binding.holder == second
    for buf, t in zip(binding.buffers, second):
        assert t.data_ptr() == buf.data_ptr() and torch.equal(t, buf)
    for buf in binding.buffers:
        buf.add_(1.0)
    assert torch.equal(first[0], torch.arange(4.0)) and torch.equal(first[1], torch.ones(2, 2))
    assert torch.equal(second[0], torch.full((4,), 8.0))
    assert all(t.data_ptr() != b.data_ptr() for t, b in zip(first, binding.buffers))


def test_eager_runs_the_plain_step_and_nests():
    calls = []
    step = capture.CapturedStep(lambda tree, x: calls.append(x) or x + tree["w"], n_trees=1)
    tree = {"w": torch.ones(2)}
    with capture.eager():
        with capture.eager():
            assert torch.equal(step(tree, torch.zeros(2)), torch.ones(2))
        assert capture._eager_depth == 1
    assert capture._eager_depth == 0
    assert torch.equal(step(tree, torch.ones(2)), torch.full((2,), 2.0))   # the CPU: plain
    assert len(calls) == 2 and step.graph_count == 0


def test_trainer_keys_train_and_eval_as_the_reference():
    net = MultiLayerNetwork(_conf("torch", "base"), device="cpu").init()
    trainer = Trainer(net)
    x, y = _data()
    trainer.fit_batch(DataSet(x[:BATCH], y[:BATCH]))
    trainer.eval_loss(DataSet(x[:BATCH], y[:BATCH]))
    sig = step_cache.net_signature(net) + (step_cache.updater_signature(net.conf),)
    assert trainer._step_key("train") == sig + ("", "train")
    assert trainer._step_key("eval") == sig + ("", "eval")
    assert step_cache.cache_size() == 2
    assert step_cache.captured_graphs(trainer._step, trainer._eval_step, None) == 0


def test_policy_is_part_of_the_key():
    net = MultiLayerNetwork(_conf("torch", "base"), device="cpu")
    f32 = step_cache.net_signature(net)
    config.set_dtype_policy(dataclasses.replace(config.DTypePolicy.f32(),
                                                compute_dtype=torch.bfloat16))
    try:
        assert step_cache.net_signature(net) != f32
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())


def test_int8_weight_copy_is_made_in_the_graph_while_capturing(monkeypatch):
    """``quant_matmul.tma_weight``'s row-padded weight copy (N % 16 != 0,
    as VGG-16's fc8) is kept on the weight between eager calls, but made
    afresh, and kept nowhere, while a graph is captured: a replay then
    copies what the weight buffer holds, whichever net's weights those are."""
    w_q = torch.arange(24, dtype=torch.int8).reshape(2, 12)
    eager_copy, ld = quant_matmul.tma_weight(w_q)
    assert ld == 16 and quant_matmul.tma_weight(w_q)[0] is eager_copy
    monkeypatch.setattr(quant_matmul, "_capturing", lambda t: True)
    del w_q._tma_rows
    first, ld = quant_matmul.tma_weight(w_q)
    second, _ = quant_matmul.tma_weight(w_q)
    assert ld == 16 and first is not second and not hasattr(w_q, "_tma_rows")
    assert torch.equal(first[:, :12], w_q) and not first[:, 12:].any()
