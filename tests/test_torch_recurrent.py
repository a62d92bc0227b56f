"""The port's recurrent layers held to the JAX package's.

Each of the ten registered types (``lstm``, ``graves_lstm``,
``simple_rnn``, ``gru``, ``bidirectional`` in its four modes,
``bidirectional_last``, ``last_time_step``, ``time_distributed``,
``rnn_output``, ``rnn_loss``) is built from one config dict in each
package and given the same params (numpy normals, seed 0, every entry
non-zero: peepholes and biases included) and the same inputs, B = 3,
T = 7, C = 5, H = 6, with no mask and with a right-padded mask (lengths
7, 3, 1).  Held: the output (``apply``; the per-step score of the loss
layers), the final carries from a given and from a zero start
(``apply_with_carry``), and the gradient of every param of a weighted sum
of the output (``jax.grad`` against ``torch.autograd``).

Bands: outputs and carries ``rtol=1e-5, atol=1e-6``; each gradient
within 1e-5 of its leaf's largest entry.  Then: an LSTM under the bf16
policy keeps its carry in f32; the wrappers' JSON written by the JAX
package loads into the port and writes the same JSON back; a
``Bidirectional`` net's ``{"fwd", "bwd"}`` params come across through
``interop.load_jax_params``.
"""

import concurrent.futures
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import DTypePolicy as JDTypePolicy
from deeplearning4j_tpu.config import set_dtype_policy as jset_dtype_policy
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMultiLayerNetwork

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.interop import load_jax_params
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

B, T, C, H = 3, 7, 5, 6
LENGTHS = (7, 3, 1)
RTOL, ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
N_CLASSES = 4

CELLS = {"lstm": {"type": "lstm", "n_out": H},
         "graves_lstm": {"type": "graves_lstm", "n_out": H},
         "simple_rnn": {"type": "simple_rnn", "n_out": H},
         "gru": {"type": "gru", "n_out": H}}
MODES = {"concat": "lstm", "add": "gru", "mul": "simple_rnn", "average": "simple_rnn"}
CASES = dict(CELLS)
CASES.update({f"bidirectional_{mode}": {"type": "bidirectional", "fwd": CELLS[cell],
                                        "mode": mode} for mode, cell in MODES.items()})
CASES.update({
    "bidirectional_last": {"type": "bidirectional_last", "fwd": CELLS["gru"],
                           "mode": "concat"},
    "last_time_step": {"type": "last_time_step", "underlying": CELLS["graves_lstm"]},
    "time_distributed": {"type": "time_distributed",
                         "underlying": {"type": "dense", "n_out": H, "activation": "tanh"}},
    "rnn_output": {"type": "rnn_output", "n_out": N_CLASSES, "activation": "softmax",
                   "loss": "mcxent"},
    "rnn_loss": {"type": "rnn_loss", "activation": "softmax", "loss": "mcxent"},
})
LOSS_LAYERS = ("rnn_output", "rnn_loss")


def _inputs(masked: bool):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)
    return x, mask


def _labels(name):
    n = N_CLASSES if name == "rnn_output" else C
    return np.eye(n, dtype=np.float32)[np.random.default_rng(2).integers(0, n, (B, T))]


def _both(name):
    spec = CASES[name]
    jlayer, layer = jbase.layer_from_dict(dict(spec)), layer_from_dict(dict(spec))
    shapes = jax.eval_shape(lambda: jlayer.init_params(jax.random.key(0),
                                                       JInputType.recurrent(C, T)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: (0.5 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    return jlayer, layer, params


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=grad)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _grads_close(got: dict, want: dict):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, (name, err)


def _forward(layer, name, masked, lib):
    """The layer's held output as a function of its params: the per-step
    score for a loss layer, ``apply``'s output for the others."""
    x, mask = _inputs(masked)
    as_array = jnp.asarray if lib == "jax" else torch.from_numpy
    if name in LOSS_LAYERS:
        return lambda p: layer.compute_score_array(p, {}, as_array(x), as_array(_labels(name)))
    m = None if mask is None else as_array(mask)
    return lambda p: layer.apply(p, {}, as_array(x), mask=m)[0]


def _start_carry(name, lib):
    parts = [np.random.default_rng(3 + i).normal(size=(B, H)).astype(np.float32)
             for i in range(2)]
    as_array = jnp.asarray if lib == "jax" else torch.from_numpy
    return tuple(map(as_array, parts)) if "lstm" in name else as_array(parts[0])


@functools.lru_cache(maxsize=None)
def _reference(name):
    """From one jitted call of the JAX layer, unmasked and masked: the held
    output, the weights of the weighted sum and its gradient; for a cell
    also the output and final carry of ``apply_with_carry`` from zeros and
    from a given carry."""
    jlayer, _, params = _both(name)
    fns = {masked: _forward(jlayer, name, masked, "jax") for masked in (False, True)}
    rng = np.random.default_rng(2)
    weights = {masked: rng.normal(size=jax.eval_shape(fn, params).shape).astype(np.float32)
               for masked, fn in fns.items()}

    def run(p):
        out = {("grad", masked): jax.value_and_grad(lambda q: (jnp.sum(fn(q) * weights[masked]),
                                                     fn(q)), has_aux=True)(p)
               for masked, fn in fns.items()}
        if name in CELLS:
            for masked in (False, True):
                x, mask = _inputs(masked)
                for start in ("zeros", "given"):
                    carry = _start_carry(name, "jax") if start == "given" else None
                    y, _, new = jlayer.apply_with_carry(
                        p, {}, jnp.asarray(x), carry,
                        mask=None if mask is None else jnp.asarray(mask))
                    out[("carry", masked, start)] = (
                        y, new if isinstance(new, tuple) else (new,))
        return out
    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(params))
    for masked in (False, True):
        (_, y), g = out.pop(("grad", masked))
        out[masked] = (y, g, weights[masked])
    return out


@pytest.fixture(scope="module", autouse=True)
def _references():
    """Every layer's JAX reference, compiled in parallel threads (XLA's
    compile, which dominates, runs outside the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(_reference, CASES))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", list(CASES))
def test_layer_output_and_gradients_match_jax(name, masked):
    want, jgrads, weights = _reference(name)[masked]
    jlayer, layer, params = _both(name)
    tparams = _torch_tree(params, grad=True)
    got = _forward(layer, name, masked, "torch")(tparams)
    _close(got, want)
    if name in LOSS_LAYERS:   # apply, and apply_and_score's score, from the same product
        x, _ = _inputs(masked)
        tp = _torch_tree(params)
        y, _, score = layer.apply_and_score(tp, {}, torch.from_numpy(x),
                                            torch.from_numpy(_labels(name)))
        _close(score, want)
        _close(y, jlayer.apply(params, {}, jnp.asarray(x))[0])
    if params:
        (got * torch.from_numpy(weights)).sum().backward()
        _grads_close(jax.tree_util.tree_map(lambda t: t.grad, tparams,
                                            is_leaf=torch.is_tensor), jgrads)


@pytest.mark.parametrize("start", ["zeros", "given"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", list(CELLS))
def test_final_carries_match_jax(name, masked, start):
    jy, jnew = _reference(name)[("carry", masked, start)]
    _, layer, params = _both(name)
    x, mask = _inputs(masked)
    carry = _start_carry(name, "torch") if start == "given" else None
    y, _, new = layer.apply_with_carry(_torch_tree(params), {}, torch.from_numpy(x), carry,
                                       mask=None if mask is None else torch.from_numpy(mask))
    _close(y, jy)
    new = new if isinstance(new, tuple) else (new,)
    assert len(new) == len(jnew)
    for got, want in zip(new, jnew):
        _close(got, want)


def test_step_is_the_scan_one_row_at_a_time():
    """``step`` (the streaming cell) walks the same arithmetic as the
    training loop, for every cell."""
    x, _ = _inputs(False)
    for name in CELLS:
        _, layer, params = _both(name)
        p = _torch_tree(params)
        carry = layer.init_carry(B)
        ys = []
        for t in range(T):
            carry, y_t = layer.step(p, carry, torch.from_numpy(x[:, t]))
            ys.append(y_t)
        torch.testing.assert_close(torch.stack(ys, 1), layer.apply(p, {}, torch.from_numpy(x))[0],
                                   rtol=0, atol=0)


def test_bf16_policy_keeps_the_lstm_carry_in_f32():
    """Under the bf16 policy the products run in bf16, the gates and the
    carried state in f32, and only the output drops to bf16, in both
    packages."""
    jlayer, layer, params = _both("graves_lstm")
    x, _ = _inputs(False)
    config.set_dtype_policy(config.DTypePolicy.bf16())
    jset_dtype_policy(JDTypePolicy.bf16())
    try:
        y, _, (h, c) = layer.apply_with_carry(_torch_tree(params), {}, torch.from_numpy(x), None)
        jy, _, (jh, jc) = jlayer.apply_with_carry(params, {}, jnp.asarray(x), None)
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
        jset_dtype_policy(JDTypePolicy.f32())
    assert (y.dtype, h.dtype, c.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    assert (jy.dtype, jh.dtype, jc.dtype) == (jnp.bfloat16, jnp.float32, jnp.float32)
    # one bf16 rounding of each product apart, compounded over 7 steps
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-2)


def test_layer_defaults_match_jax():
    """Fresh inits where they are fixed values: the LSTM bias is zeros with
    the forget block at ``forget_gate_bias_init``, ``wP`` is zeros, and the
    param shapes are the JAX layer's for every type."""
    gen = torch.Generator().manual_seed(0)
    p = rec.GravesLSTM(n_out=H, forget_gate_bias_init=0.7, bias_init=3.0).init_params(
        gen, JInputType.recurrent(C, T))
    want_b = np.zeros(4 * H, np.float32)
    want_b[H:2 * H] = 0.7
    np.testing.assert_array_equal(p["b"].numpy(), want_b)
    np.testing.assert_array_equal(p["wP"].numpy(), np.zeros(3 * H, np.float32))
    for name in CASES:
        jlayer, layer, params = _both(name)
        itype = JInputType.recurrent(C, T)
        got = layer.init_params(gen, itype)
        assert jax.tree_util.tree_map(np.shape, params) == jax.tree_util.tree_map(
            lambda t: tuple(t.shape), got, is_leaf=torch.is_tensor), name
        jout = jlayer.get_output_type(itype)
        out = layer.get_output_type(itype)
        assert (out.kind, out.size, out.timesteps) == (jout.kind, jout.size, jout.timesteps)
        assert layer.transform_mask("m") == jlayer.transform_mask("m")


def _wrapper_conf(full: bool = True):
    from deeplearning4j_tpu.nn import layers as jl
    b = (JNeuralNetConfiguration.builder().seed(5).weight_init("xavier").list()
         .layer(jl.Bidirectional(fwd=jl.SimpleRnn(n_out=H), mode="add")))
    if full:
        b.layer(jl.TimeDistributed(underlying=jl.DenseLayer(n_out=H, activation="relu")))
        b.layer(jl.Bidirectional(fwd=jl.GRU(n_out=H), mode="concat"))
    return (b.layer(jl.LastTimeStep(underlying=jl.GravesLSTM(n_out=H)))
            .layer(jl.OutputLayer(n_out=N_CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.recurrent(C, T))
            .backprop_type("tbptt", 4, 4)
            .build())


def test_wrapper_json_from_jax_round_trips():
    jconf = _wrapper_conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == json.loads(jconf.to_json())
    assert isinstance(conf.layers[0].fwd, rec.SimpleRnn)
    assert conf.layers[0].fwd.weight_init == "xavier"
    assert conf.backprop_type == "tbptt" and conf.tbptt_fwd_length == 4
    bl = rec.BidirectionalLastStep(fwd=rec.SimpleRnn(n_out=2))
    assert layer_from_dict(json.loads(json.dumps(bl.to_dict()))).to_dict() == bl.to_dict()


def test_nested_params_load_from_jax_and_the_net_matches():
    """A net of the wrappers: the JAX net's params (the Bidirectionals'
    ``{"fwd", "bwd"}`` among them) through ``load_jax_params``, then the
    same output with a masked batch."""
    jconf = _wrapper_conf(full=False)
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    np_tree = [jax.tree_util.tree_map(np.asarray, d) for d in jnet.params_]
    load_jax_params(net, np_tree, [{} for _ in np_tree])
    assert set(net.params_[0]) == {"fwd", "bwd"}
    x, mask = _inputs(True)
    _close(net.output(x, mask=mask), jnet.output(x, mask=mask))
