"""``Adam(mu_dtype="bf16")`` held to optax's ``adam(mu_dtype=bfloat16)``.

The same tree (numpy seed) and the same three gradients go through the
JAX package's updater (``to_optax``, optax 0.2.6) and the port's.  Bands:
``mu`` within one bf16 ulp of optax's per entry at every step (read
bit-equal), the updates within 1e-6 relative of their largest entry per
leaf, nu and the count equal.  A planted fault, an Adam that rounds mu
to bf16 before the update instead of after, must fail the update band:
that shows the comparison sees the order of rounding.

optax runs eagerly here, one XLA op at a time, which is the arithmetic
the port holds to: b1 taken to bf16 (0.8984375), ``b1 * mu`` rounded to
bf16, the sum in f32.  Where XLA fuses the whole update under ``jit`` (the
JAX package's compiled train steps) it keeps ``b1 * mu`` in f32 instead,
and there mu may differ from this by one bf16 ulp.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.train import updaters as jupdaters

from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.train import updaters
from deeplearning4j_tpu_torch.train.updaters import Adam, tree_leaves, tree_map

LR = 2e-5
STEPS = 3
UPDATE_TOL = 1e-6
SHAPES = {"embeddings": {"word": (64, 32), "bias": (32,)},
          "encoder": {"layer_0": {"kernel": (32, 48), "bias": (48,)}}}


def _tree(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = _tree(lambda s: rng.normal(size=s).astype(np.float32), SHAPES)
    # gradients over a wide range of magnitudes, so that mu's bf16 rounding
    # lands at every exponent
    grads = [_tree(lambda s: (rng.normal(size=s) * 10.0 ** rng.integers(-8, 1, size=s))
                   .astype(np.float32), SHAPES) for _ in range(STEPS)]
    return params, grads


@pytest.fixture(scope="module")
def optax_run(inputs):
    """Per step: (updates, mu, nu, count) of optax as numpy."""
    params, grads = inputs
    tx = jupdaters.Adam(LR, mu_dtype="bf16").to_optax()
    state = tx.init(_tree_to_jnp(params))
    out = []
    for g in grads:
        updates, state = tx.update(_tree_to_jnp(g), state)
        adam = state[0]
        out.append((_np(updates), _np(adam.mu), _np(adam.nu), int(adam.count)))
    return out


def _tree_to_jnp(tree):
    return {k: _tree_to_jnp(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else jnp.asarray(tree)


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _port_run(updater, inputs):
    params, grads = inputs
    state = updater.init(_torch(params))
    out = []
    for g in grads:
        updates, state = updater.update(_torch(g), state)
        out.append((updates, state["mu"], state["nu"], int(state["count"])))
    return out


def _pairs(got, want):
    """(port leaf, JAX leaf) pairs matched by key (JAX sorts dict keys)."""
    if isinstance(want, dict):
        return [pair for k in want for pair in _pairs(got[k], want[k])]
    return [(got, want)]


def _bf16_ulp_errs(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in bf16 ulps of want, per entry."""
    want = torch.from_numpy(np.asarray(want).astype(np.float32))
    got = got.to(torch.float32)
    _, exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    return ((got - want).abs() / ulp).numpy()


def _update_errs(got: dict, want: dict) -> list:
    return [((g - torch.from_numpy(np.array(w))).abs().max() / max(np.abs(w).max(), 1e-30)).item()
            for g, w in _pairs(got, want)]


def test_mu_is_bf16_from_init():
    state = Adam(LR, mu_dtype="bf16").init({"w": torch.zeros(3), "b": [torch.zeros(2)]})
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(state["mu"]))
    assert all(v.dtype == torch.float32 for v in tree_leaves(state["nu"]))
    assert Adam(LR, mu_dtype="bfloat16").init({"w": torch.zeros(3)})["mu"]["w"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("step", range(STEPS))
def test_three_steps_match_optax(inputs, optax_run, step):
    port = _port_run(Adam(LR, mu_dtype="bf16"), inputs)
    updates, mu, nu, count = port[step]
    j_updates, j_mu, j_nu, j_count = optax_run[step]
    assert count == j_count == step + 1
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(mu))
    for got, want in _pairs(mu, j_mu):
        assert want.dtype.name == "bfloat16"
        # bit-equal read; the band is one bf16 ulp
        assert _bf16_ulp_errs(got, want).max() <= 1.0
    for got, want in _pairs(nu, j_nu):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert max(_update_errs(updates, j_updates)) <= UPDATE_TOL


def test_mu_is_bit_equal_to_optax(inputs, optax_run):
    port = _port_run(Adam(LR, mu_dtype="bf16"), inputs)
    for (_, mu, _, _), (_, j_mu, _, _) in zip(port, optax_run):
        for got, want in _pairs(mu, j_mu):
            assert np.array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))


@dataclasses.dataclass
class _RoundsMuFirst(Adam):
    """Planted fault: mu rounded to bf16 before the update, not after."""

    def update(self, grads, state):
        b1, b2, lr, eps = self.beta1, self.beta2, self.learning_rate, self.epsilon
        mu = tree_map(lambda g, m: ((1 - b1) * g + b1 * m).to(torch.bfloat16), grads,
                      state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        c1 = 1 - b1 ** count.item()
        c2 = 1 - b2 ** count.item()
        updates = tree_map(lambda m, v: -lr * ((m.float() / c1) / (torch.sqrt(v / c2) + eps)),
                           mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}


def test_rounding_mu_before_the_update_fails_the_comparison(inputs, optax_run):
    port = _port_run(_RoundsMuFirst(LR, mu_dtype="bf16"), inputs)
    worst = max(max(_update_errs(p[0], j[0])) for p, j in zip(port, optax_run))
    # one bf16 ulp of mu is 2^-8 relative: hundreds of times the band
    assert worst > 100 * UPDATE_TOL, worst


@pytest.mark.parametrize("name", ["bf16", "bfloat16"])
def test_json_round_trips_mu_dtype_as_the_jax_package_writes_it(name):
    jd = json.loads(json.dumps(jupdaters.Adam(LR, mu_dtype=name).to_dict()))
    ours = updaters.from_dict(jd)
    assert isinstance(ours, Adam) and ours.mu_dtype == name
    assert json.loads(json.dumps(ours.to_dict())) == jd
    back = jupdaters.from_dict(ours.to_dict())
    assert back == jupdaters.Adam(LR, mu_dtype=name)


@pytest.mark.parametrize("bad", ["float16", "f32", torch.bfloat16])
def test_other_mu_dtypes_raise_naming_what_is_ported(bad):
    with pytest.raises(NotImplementedError, match="ported: None, 'bf16', 'bfloat16'"):
        Adam(LR, mu_dtype=bad).init({"w": torch.zeros(2)})


def test_jax_state_carries_into_the_port_and_continues(inputs, optax_run):
    """A bf16 optax state read by ``load_jax_opt_state`` continues the
    run: the port's third step from optax's second state equals optax's
    third."""
    params, grads = inputs
    tx = jupdaters.Adam(LR, mu_dtype="bf16").to_optax()
    state = tx.init(_tree_to_jnp(params))
    for g in grads[:2]:
        _, state = tx.update(_tree_to_jnp(g), state)

    class _Net:
        conf = dataclasses.make_dataclass("C", [("updater", dict)])(
            Adam(LR, mu_dtype="bf16").to_dict())
        params_ = _torch(params)

    net = interop.load_jax_opt_state(_Net(), state)
    assert net.opt_state["mu"]["embeddings"]["word"].dtype == torch.bfloat16
    updates, new = Adam(LR, mu_dtype="bf16").update(_torch(grads[2]), net.opt_state)
    assert max(_update_errs(updates, optax_run[2][0])) <= UPDATE_TOL
    for got, want in _pairs(new["mu"], optax_run[2][1]):
        assert _bf16_ulp_errs(got, want).max() <= 1.0
