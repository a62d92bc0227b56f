"""The port's schedules and updaters (``train/schedules.py``,
``train/updaters.py``) against the JAX package's on the CPU.

Every schedule at steps 0-40 against the reference's schedule as optax
runs it (inside ``jax.jit``), bit for bit in f32, including epoch keying
(``steps_per_epoch`` > 1) and a ramp over another schedule; every
schedule on a data-less (meta) count tensor, which proves it reads
nothing on the host.  Every updater, and Sgd, Nesterovs and Adam with a
schedule, over 5 steps on the same gradients against the reference's
optax transform (``build_optimizer(...).update``), within 1e-6 of each
leaf's largest update entry, and each state's leaves in optax's
flatten order against ``jax.tree_util.tree_leaves`` of optax's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd

from deeplearning4j_tpu_torch.train import schedules, updaters

STEPS = 41
UPDATE_TOL = 1e-6      # of each leaf's largest update entry
STATE_TOL = 1e-6       # of each state leaf's largest entry

SCHEDULES = [
    {"type": "fixed", "value": 0.01},
    {"type": "exponential", "initial_value": 0.1, "gamma": 0.99},
    {"type": "exponential", "initial_value": 0.1, "gamma": 0.97, "steps_per_epoch": 3},
    {"type": "inverse", "initial_value": 0.1, "gamma": 0.5, "power": 1.0},
    {"type": "inverse", "initial_value": 0.1, "gamma": 0.37, "power": 2.0},
    {"type": "poly", "initial_value": 0.1, "power": 1.0, "max_iter": 30},
    {"type": "poly", "initial_value": 0.1, "power": 0.5, "max_iter": 30, "steps_per_epoch": 2},
    {"type": "sigmoid", "initial_value": 0.1, "gamma": 0.3, "step_size": 20},
    {"type": "sigmoid", "initial_value": 0.05, "gamma": 0.77, "step_size": 13,
     "steps_per_epoch": 2},
    {"type": "step", "initial_value": 0.1, "decay_rate": 0.5, "step": 7.0},
    {"type": "step", "initial_value": 0.03, "decay_rate": 0.7, "step": 3.0, "steps_per_epoch": 4},
    {"type": "map", "values": {0: 0.1, 5: 0.05, "12": 0.01}},
    {"type": "cycle", "initial_value": 0.001, "max_value": 0.01, "cycle_length": 30,
     "annealing_frac": 0.1},
    {"type": "cycle", "initial_value": 0.003, "max_value": 0.07, "cycle_length": 17,
     "annealing_frac": 0.25, "steps_per_epoch": 2},
    {"type": "ramp", "underlying": {"type": "exponential", "initial_value": 1e-3, "gamma": 0.99},
     "num_iterations": 4},
    {"type": "ramp", "underlying": {"type": "sigmoid", "initial_value": 1e-2, "gamma": 0.2,
                                    "step_size": 10}, "num_iterations": 7, "steps_per_epoch": 3},
]


def _id(d):
    return "-".join([d["type"]] + [f"{k}{v}" for k, v in d.items()
                                   if k not in ("type", "underlying", "values")])


@pytest.mark.parametrize("spec", SCHEDULES, ids=[_id(d) for d in SCHEDULES])
def test_schedule_matches_jax_bit_for_bit(spec):
    ref = jsched.from_dict(dict(spec))
    ours = schedules.from_dict(dict(spec))
    jitted = jax.jit(lambda c: ref(c))
    want = np.array([np.asarray(jitted(jnp.int32(i))) for i in range(STEPS)])
    got = np.array([ours(torch.tensor(i, dtype=torch.int32)).numpy() for i in range(STEPS)])
    assert got.dtype == np.float32
    differ = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    assert differ.size == 0, f"steps {differ.tolist()} differ: {got[differ]} vs {want[differ]}"
    assert ours.to_dict() == ref.to_dict()


@pytest.mark.parametrize("spec", SCHEDULES, ids=[_id(d) for d in SCHEDULES])
def test_schedule_is_a_function_of_a_device_tensor(spec):
    """A count on the meta device has no data: a schedule that read its
    step on the host (``.item()``, ``float()``) would raise here."""
    out = schedules.from_dict(dict(spec))(torch.zeros((), dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == () and out.dtype == torch.float32


class _Ops(TorchDispatchMode):
    """The ATen ops dispatched while open."""

    def __enter__(self):
        self.ops = set()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


# a tensor made from host data (its copy to a card cannot be captured) and
# a read of a tensor back on the host (it would freeze the capture's value)
HOST_OPS = {"aten.lift_fresh.default", "aten._local_scalar_dense.default"}


@pytest.mark.parametrize("spec", SCHEDULES, ids=[_id(d) for d in SCHEDULES])
def test_schedule_puts_nothing_of_the_host_into_its_step(spec):
    sched = schedules.from_dict(dict(spec))
    with _Ops() as ops:
        sched(torch.zeros((), dtype=torch.int32))
    assert not ops.ops & HOST_OPS, ops.ops & HOST_OPS


def test_schedules_keep_the_reference_field_order():
    """``steps_per_epoch`` comes first, as in the reference, so the others
    go by name."""
    assert (schedules.StepSchedule(1e-2, 0.5).to_dict()
            == jsched.StepSchedule(1e-2, 0.5).to_dict())
    assert schedules.StepSchedule(initial_value=1e-2, decay_rate=0.5, step=8).steps_per_epoch == 1


RAMP = {"type": "ramp", "underlying": {"type": "exponential", "initial_value": 0.05,
                                       "gamma": 0.9}, "num_iterations": 3}
STEP = {"type": "step", "initial_value": 0.05, "decay_rate": 0.5, "step": 2.0}
UPDATERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": STEP}),
    ("nesterovs", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nesterovs", {"learning_rate": RAMP, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adam", {"learning_rate": RAMP}),
    ("adamw", {"learning_rate": 0.01, "weight_decay": 0.1}),
    ("adamw", {"learning_rate": RAMP}),
    ("adamax", {"learning_rate": 0.01}),
    ("adamax", {"learning_rate": STEP}),
    ("amsgrad", {"learning_rate": 0.01}),
    ("amsgrad", {"learning_rate": RAMP}),
    ("nadam", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": RAMP}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adagrad", {"learning_rate": STEP}),
    ("adadelta", {"rho": 0.9}),
    ("rmsprop", {"learning_rate": 0.01, "rms_decay": 0.9}),
    ("rmsprop", {"learning_rate": RAMP}),
    ("noop", {}),
]


def _params_and_grads():
    rng = np.random.default_rng(11)
    params = {"l0": {"W": rng.normal(size=(3, 4)), "b": rng.normal(size=(4,))},
              "a": {"gamma": rng.normal(size=(5,))}}
    params = {k: {n: v.astype(np.float32) for n, v in d.items()} for k, d in params.items()}
    grads = [{k: {n: rng.normal(size=v.shape).astype(np.float32) for n, v in d.items()}
              for k, d in params.items()} for _ in range(5)]
    return params, grads


def _torch(tree):
    return {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()} for k, d in tree.items()}


@pytest.mark.parametrize("name,kwargs", UPDATERS,
                         ids=[f"{n}-{'sched' if isinstance(k.get('learning_rate'), dict) else 'const'}"
                              for n, k in UPDATERS])
def test_updater_matches_optax(name, kwargs):
    spec = {"type": name, **kwargs}
    ref = jupd.from_dict(dict(spec))
    tx = jupd.build_optimizer(ref)
    ours = updaters.from_dict(dict(spec))
    assert ours.to_dict() == jupd.to_dict(ref)
    opt = updaters.Optimizer(ours)
    params, grads = _params_and_grads()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = _torch(params)
    tstate = opt.init(tp)
    worst = 0.0
    for g in grads:
        ju, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, tstate = opt.update(_torch(g), tstate, tp)
        tp = {k: {n: tp[k][n] + tu[k][n] for n in d} for k, d in tp.items()}
        for k, d in params.items():
            for n in d:
                want = np.asarray(ju[k][n])
                scale = np.abs(want).max()
                err = np.abs(tu[k][n].numpy() - want).max() / (scale if scale else 1.0)
                worst = max(worst, err)
    print(f"{name} {kwargs}: worst update error {worst:.3e} of a leaf's largest entry")
    g0 = _torch(grads[0])
    with _Ops() as ops:       # a step, as a captured graph runs it
        opt.update(g0, tstate, tp)
    assert not ops.ops & HOST_OPS, ops.ops & HOST_OPS
    assert worst <= UPDATE_TOL
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    got = opt.state_leaves(tstate)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, i
        scale = np.abs(w).max() if w.size else 0.0
        assert np.abs(g.numpy() - w).max() <= STATE_TOL * (scale if scale else 1.0), i


def test_adagrad_starts_its_accumulator_at_optax_value_and_adadelta_ignores_a_rate():
    state = updaters.AdaGrad(0.1).init({"w": torch.zeros(3)})
    assert torch.equal(state["sum_of_squares"]["w"], torch.full((3,), 0.1))
    assert "learning_rate" not in updaters.AdaDelta().to_dict()


def test_a_state_carried_from_optax_continues_the_run():
    """optax's state after 3 steps, read through ``state_from_leaves``,
    gives the port's steps 4 and 5 within the update limit."""
    spec = {"type": "nadam", "learning_rate": RAMP}
    tx = jupd.build_optimizer(jupd.from_dict(dict(spec)))
    opt = updaters.Optimizer(updaters.from_dict(dict(spec)))
    params, grads = _params_and_grads()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    for g in grads[:3]:
        _, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
    tstate = opt.state_from_leaves(_torch(params), jax.tree_util.tree_leaves(jstate))
    assert int(tstate["count"]) == 3 and int(tstate["schedule_count"]) == 3
    for g in grads[3:]:
        ju, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        tu, tstate = opt.update(_torch(g), tstate, _torch(params))
        for k, d in params.items():
            for n in d:
                want = np.asarray(ju[k][n])
                assert np.abs(tu[k][n].numpy() - want).max() <= UPDATE_TOL * np.abs(want).max()
    with pytest.raises(KeyError, match="'mu'"):
        opt.state_from_leaves(_torch(params), jax.tree_util.tree_leaves(jstate)[:1])
