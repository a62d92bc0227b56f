"""The port's pipeline parallelism (``parallel.pipeline``,
``parallel.pipeline_stages``) held to the JAX package's.

The port runs one process per stage (``parallel/pipeline_stages.py``'s
docstring): the cases run in one gang of four gloo processes on the CPU
(``tests/torch_cluster_workers.py::pipeline_worker``) over a pipe-4 mesh,
a pipe-2 mesh (ranks 0-1) and a pipe-2 x data-2 mesh, and each rank's
result is held to the JAX package's on a mesh of the same shape over the
conftest's CPU devices, from the same seeded numpy inputs and the
reference's weights.  Cases and tolerances (the reference's own,
``tests/test_pipeline_stages.py``):

- the 1F1B and GPipe schedule tables equal the reference's for S in 2-4
  and M in 1-8;
- ``pipeline_apply`` (homogeneous, on 4 stages and on 2 stages x 2 data
  positions) and ``pipeline_apply_stages`` (non-uniform widths, 4 and 2
  stages): rtol 1e-5, atol 1e-6;
- ``pipeline_train_step`` under 1F1B and GPipe on non-uniform widths (4
  stages, 2 stages at M = 8, 2 stages x 2 data positions): loss rtol 1e-5,
  every stage's gradients rtol 1e-4, atol 1e-5, the same on every rank;
  each stage sends exactly its microbatches' activations up and
  cotangents down (a first activation's header besides);
- the tiny 4-layer BERT over 2 stages (``models/bert.py::
  pipeline_stages``, ``mlm_loss_from_logits``,
  ``merge_tied_embedding_grads``) against the reference's same stages
  and ``pipeline_train_step``: loss rtol 1e-5, merged gradients rtol
  1e-4, atol 1e-5 (read on the CPU: the same loss, every entry within
  7.1e-8 of the reference's);
- ``pipeline_fit_step_local`` with Adam over two steps against the
  reference's with ``optax.adam``: losses rtol 1e-5, each rank's row rtol
  1e-4, atol 1e-6; ``flatten_stage_params`` round-trips;
- the refusals: ``model_axis`` names ``ROADMAP.md`` queue A item 2.5, an
  uneven microbatch split, a wrong stage count and an unknown schedule
  raise ``ValueError`` as the reference's do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.parallel import pipeline as jpipeline
from deeplearning4j_tpu.parallel import pipeline_stages as jps
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.parallel import pipeline_stages as ps
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 17311
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ROW_RTOL, ROW_ATOL = 1e-4, 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(dims, batch=16, seed=0):
    """tests/test_pipeline_stages.py's _mlp_case: per-stage {W, b}."""
    rng = np.random.default_rng(seed)
    params = [{"W": rng.normal(0, 0.3, (dims[i], dims[i + 1])).astype(np.float32),
               "b": np.zeros((dims[i + 1],), np.float32)} for i in range(len(dims) - 1)]
    x = rng.normal(size=(batch, dims[0])).astype(np.float32)
    y = rng.normal(size=(batch, dims[-1])).astype(np.float32)
    return params, x, y


def _bert_case():
    config = dataclasses.replace(jbert.BertConfig.tiny(vocab_size=128), num_layers=4)
    params = _np(jbert.init_params(config, jax.random.key(0)))
    rng = np.random.default_rng(0)
    bsz, t = 8, 16
    ids = rng.integers(5, 128, (bsz, t)).astype(np.int32)
    labels = rng.integers(5, 128, (bsz, t)).astype(np.float32)
    weights = (rng.random((bsz, t)) < 0.3).astype(np.float32)
    return {"kind": "bert", "mesh": (2, 1), "M": 4, "config": config.to_dict(),
            "params": params, "x": ids.astype(np.float32),
            "y": np.stack([labels, weights], axis=-1)}


def _cases() -> dict:
    rng = np.random.default_rng(1)
    homo4 = {"W": rng.normal(0, 0.3, (4, 12, 12)).astype(np.float32),
             "b": rng.normal(0, 0.1, (4, 12)).astype(np.float32)}
    homo2 = {"W": homo4["W"][:2], "b": homo4["b"][:2]}
    x = rng.normal(size=(16, 12)).astype(np.float32)
    p4, x4, y4 = _mlp((12, 24, 10, 18, 6))
    p2, x2, y2 = _mlp((12, 20, 6), seed=2)
    return {
        "apply4": {"kind": "apply", "mesh": (4, 1), "params": homo4, "x": x, "M": 4},
        "apply2_dp": {"kind": "apply", "mesh": (2, 2), "params": homo2, "x": x, "M": 2},
        "stages4": {"kind": "apply_stages", "mesh": (4, 1), "params": p4, "x": x4, "M": 4},
        "stages2": {"kind": "apply_stages", "mesh": (2, 1), "params": p2, "x": x2, "M": 2},
        "train4": {"kind": "train", "mesh": (4, 1), "params": p4, "x": x4, "y": y4, "M": 4},
        "train2": {"kind": "train", "mesh": (2, 1), "params": p2, "x": x2, "y": y2, "M": 8},
        "train_dp": {"kind": "train", "mesh": (2, 2), "params": p2, "x": x2, "y": y2, "M": 2},
        "bert": _bert_case(),
        "fit_local": {"kind": "fit_local", "mesh": (4, 1), "params": p4, "x": x4, "y": y4,
                      "M": 4},
    }


def _jmesh(case):
    s, d = case["mesh"]
    return jmake_mesh(data=d, pipe=s, devices=jax.devices()[:s * d])


def _jstage(p, h):
    return jnp.tanh(h @ p["W"] + p["b"])


def _jmse(out, lab):
    return jnp.mean((out - lab) ** 2)


def _jax_case(case):
    kind, mesh = case["kind"], _jmesh(case)
    s, d = case["mesh"]
    x = jnp.asarray(case["x"])
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    with mesh:
        if kind == "apply":
            return {"y": np.asarray(jax.jit(lambda p, x: jpipeline.pipeline_apply(
                _jstage, p, x, mesh, case["M"], data_axis="data" if d > 1 else None))(
                    params, x))}
        if kind == "apply_stages":
            return {"y": np.asarray(jax.jit(lambda p, x: jps.pipeline_apply_stages(
                [_jstage] * s, p, x, mesh, case["M"]))(params, x))}
        y = jnp.asarray(case["y"])
        if kind == "train":
            out = {}
            for schedule in ("1f1b", "gpipe"):
                loss, grads = jax.jit(lambda p, x, y, schedule=schedule: jps.pipeline_train_step(
                    [_jstage] * s, p, x, y, _jmse, mesh, case["M"], schedule=schedule,
                    data_axis="data" if d > 1 else None))(params, x, y)
                out[schedule] = {"loss": float(loss), "grads": _np(list(grads))}
            return out
        if kind == "bert":
            config = jbert.BertConfig.from_dict(case["config"])
            fns, sp = jbert.pipeline_stages(config, params, s)
            loss, grads = jax.jit(lambda sp, x, y: jps.pipeline_train_step(
                fns, sp, x, y, jbert.mlm_loss_from_logits, mesh, case["M"]))(tuple(sp), x, y)
            return {"loss": float(loss), "grads": _np(list(jbert.merge_tied_embedding_grads(grads)))}
        if kind == "fit_local":
            from jax.sharding import NamedSharding, PartitionSpec as P
            tx = optax.adam(1e-2)
            flat, unravels, sizes = jps.flatten_stage_params(params)
            flat = jax.device_put(flat, NamedSharding(mesh, P("pipe")))
            opt = jps.init_stage_local_opt(tx, flat, mesh)
            losses = []
            step = jax.jit(lambda flat, opt, x, y: jps.pipeline_fit_step_local(
                [_jstage] * s, flat, opt, tx, unravels, sizes, x, y, _jmse, mesh, case["M"]))
            for _ in range(2):
                loss, flat, opt = step(flat, opt, x, y)
                losses.append(float(loss))
            return {"losses": losses, "flat": np.asarray(flat), "sizes": sizes}
    raise ValueError(kind)


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    gang = GangHandle(functools.partial(workers.pipeline_worker, cases=cases), 4, GANG_PORT,
                      timeout=150.0)
    try:
        ref = {name: _jax_case(case) for name, case in cases.items()}
    except BaseException:
        gang.shutdown()
        raise
    ranks = gang.wait()
    assert len(ranks) == 4
    return cases, ref, sorted(ranks, key=lambda r: r["pid"])


def _members(ranks, name):
    return [r[name] for r in ranks if name in r]


def _rows(case, a, rank_pid):
    """The rows of the global ``a`` that rank ``rank_pid`` takes: its data
    position is the faster-varying of (pipe, data)."""
    d = case["mesh"][1]
    per = a.shape[0] // d
    i = rank_pid % d
    return a[i * per:(i + 1) * per]


def _close_trees(got, want, rtol, atol, what):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("S", [2, 3, 4])
def test_schedules_equal_the_reference(S):
    for M in range(1, 9):
        for ours, theirs in ((ps.make_1f1b_schedule, jps.make_1f1b_schedule),
                             (ps.make_gpipe_schedule, jps.make_gpipe_schedule)):
            (f, b), (jf, jb) = ours(S, M), theirs(S, M)
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_array_equal(b, jb)
        f, b = ps.make_1f1b_schedule(S, M)
        for s in range(S):        # stage s never stashes more than S - s inputs
            live = np.cumsum((f[:, s] >= 0).astype(int) - (b[:, s] >= 0).astype(int))
            assert live.max() <= S - s


# ------------------------------------------------------------ forward only
@pytest.mark.parametrize("name", ["apply4", "apply2_dp"])
def test_pipeline_apply_matches_the_reference(runs, name):
    cases, ref, ranks = runs
    s, d = cases[name]["mesh"]
    members = [(r["pid"], r[name]) for r in ranks if name in r]
    assert len(members) == s * d
    for pid, got in members:
        np.testing.assert_allclose(got["y"], _rows(cases[name], ref[name]["y"], pid),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        assert got["calls"] == 1          # tpudl_parallel_pipeline_calls_total


@pytest.mark.parametrize("name", ["stages4", "stages2"])
def test_pipeline_apply_stages_matches_the_reference(runs, name):
    cases, ref, ranks = runs
    for got in _members(ranks, name):
        np.testing.assert_allclose(got["y"], ref[name]["y"], rtol=FWD_RTOL, atol=FWD_ATOL)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("name", ["train4", "train2", "train_dp"])
def test_train_step_matches_the_reference(runs, name, schedule):
    cases, ref, ranks = runs
    want = ref[name][schedule]
    members = _members(ranks, name)
    assert len(members) == np.prod(cases[name]["mesh"])
    for got in members:
        np.testing.assert_allclose(got[schedule]["loss"], want["loss"], rtol=LOSS_RTOL)
        _close_trees(got[schedule]["grads"], want["grads"], GRAD_RTOL, GRAD_ATOL,
                     f"{name} {schedule} grads")


def test_each_stage_sends_only_its_microbatches(runs):
    cases, _, ranks = runs
    case = cases["train4"]
    M, bm = case["M"], case["x"].shape[0] // case["M"]
    widths = [p["W"].shape[1] for p in case["params"]]
    header = 10 * 8
    for got in _members(ranks, "train4"):
        s = got["stage"]
        up = M * bm * widths[s] * 4 + header if s < 3 else 0
        down = M * bm * case["params"][s]["W"].shape[0] * 4 if s > 0 else 0
        for schedule in ("1f1b", "gpipe"):
            assert got[schedule]["hops"][1] == up + down, (s, schedule, got[schedule]["hops"])


def test_bert_over_two_stages_matches_the_reference(runs):
    _, ref, ranks = runs
    members = _members(ranks, "bert")
    assert len(members) == 2
    for got in members:
        np.testing.assert_allclose(got["loss"], ref["bert"]["loss"], rtol=LOSS_RTOL)
        _close_trees(got["grads"], ref["bert"]["grads"], GRAD_RTOL, GRAD_ATOL,
                     "BERT merged grads")
        we = got["grads"][0]["embeddings"]["word_embeddings"]
        np.testing.assert_array_equal(we, got["grads"][-1]["decode_embeddings"])


def test_fit_step_local_matches_the_reference(runs):
    cases, ref, ranks = runs
    want = ref["fit_local"]
    members = _members(ranks, "fit_local")
    assert sorted(g["stage"] for g in members) == [0, 1, 2, 3]
    for got in members:
        assert got["sizes"] == want["sizes"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["row"][0], want["flat"][got["stage"]], rtol=ROW_RTOL,
                                   atol=ROW_ATOL)
        _close_trees(got["round_trip"], cases["fit_local"]["params"], 0, 0, "round trip")


def test_refusals_follow_the_reference(runs):
    _, _, ranks = runs
    mesh = jmake_mesh(data=1, pipe=4, devices=jax.devices()[:4])
    x = jnp.zeros((16, 12))
    params = [{"W": jnp.zeros((12, 12)), "b": jnp.zeros(12)}] * 4
    with pytest.raises(ValueError) as uneven:
        jps.pipeline_train_step([_jstage] * 4, params, x, x, _jmse, mesh, 5)
    with pytest.raises(ValueError) as fns:
        jps.pipeline_train_step([_jstage] * 3, params, x, x, _jmse, mesh, 4)
    for r in ranks:
        errors = r["errors"]
        assert errors["model_axis"].startswith("NotImplementedError") \
            and "ROADMAP.md queue A item 2.5" in errors["model_axis"]
        assert errors["uneven"].startswith("ValueError") and "not divisible" in errors["uneven"] \
            and "not divisible" in str(uneven.value)
        assert errors["fns"] == f"ValueError: {fns.value}"
        assert errors["schedule"] == "ValueError: unknown schedule 'zb'"


def test_no_jax_scan_covers_the_pipeline_slice():
    from test_torch_port_rules import PORT_FILES, ROOT
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("parallel/pipeline.py", "parallel/pipeline_stages.py",
                   "parallel/expert_parallel.py", "parallel/unified.py", "parallel/mesh.py"):
        assert f"deeplearning4j_tpu_torch/{module}" in names
