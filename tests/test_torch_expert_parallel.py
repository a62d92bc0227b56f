"""The port's MoE FFN (``parallel.unified``: ``_top_k_gates``,
``_dispatch_tensors``, ``moe_ffn_dense``, ``shard_moe_params``,
``moe_ffn``; the ``expert_parallel`` shim) held to the JAX package's.

Parameters come from the JAX package's ``init_moe_params`` and cross over
as numpy; tokens are seeded numpy arrays.  The sharded cases run in one
gang of four gloo processes on the CPU
(``tests/torch_cluster_workers.py::expert_parallel_worker``): an ep2 mesh
(ranks 0-1), an ep4 mesh and a dp2 x ep2 mesh, each rank's output and
gradients held to its rows of the JAX package's sharded ``moe_ffn`` on a
mesh of the same shape over the conftest's CPU devices (capacity comes
from the local token count, so the shapes must match).  Tolerances, the
reference's own (``tests/test_expert_parallel.py``): rtol 2e-4, atol
1e-5 for outputs and gradients; gating and dispatch exactly.
"""

import functools
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import unified as junified
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch import parallel
from deeplearning4j_tpu_torch.parallel import unified
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 17111
RTOL, ATOL = 2e-4, 1e-5
D, H, E = 8, 16, 4


@functools.lru_cache(maxsize=None)
def _jparams(seed, d=D, h=H, e=E):
    return _np(jax.jit(junified.init_moe_params, static_argnums=(1, 2, 3))(
        jax.random.key(seed), d, h, e))


@functools.partial(jax.jit, static_argnames=("top_k", "capacity_factor"))
def _jdense(params, x, top_k=2, capacity_factor=2.0):
    return junified.moe_ffn_dense(params, x, top_k=top_k, capacity_factor=capacity_factor)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in tree.items()}


def _tokens(seed, n, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cases() -> dict:
    return {
        # tests/test_expert_parallel.py:99-111 on ep2 and ep4, and :113-125 on dp2 x ep2
        "ep2": {"mesh": (1, 2), "params": _jparams(7), "x": _tokens(5, 32),
                "kw": {"top_k": 2, "capacity_factor": float(E)}},
        "ep4": {"mesh": (1, 4), "params": _jparams(7), "x": _tokens(5, 32),
                "kw": {"top_k": 2, "capacity_factor": float(E)}},
        "dp2xep2": {"mesh": (2, 2), "params": _jparams(9), "x": _tokens(6, 48),
                    "kw": {"top_k": 1, "capacity_factor": float(E)}},
        # the defaults, capacity tight enough to drop tokens
        "ep2_drops": {"mesh": (1, 2), "params": _jparams(11), "x": _tokens(8, 64),
                      "kw": {"top_k": 2, "capacity_factor": 0.5}},
    }


def _jax_case(case) -> dict:
    """The reference's sharded output and its gradients of mean(y * y) in
    the params and the tokens, on a mesh of the case's shape."""
    d, e = case["mesh"]
    mesh = jmake_mesh(data=d, expert=e, devices=jax.devices()[:d * e])
    params = junified.shard_moe_params({k: jnp.asarray(v) for k, v in case["params"].items()},
                                       mesh)
    kw = dict(case["kw"], data_axis="data" if d > 1 else None)
    x = jnp.asarray(case["x"])

    def loss(p, x):
        return jnp.mean(junified.moe_ffn(p, x, mesh, **kw) ** 2)

    with mesh:
        y = jax.jit(lambda p, x: junified.moe_ffn(p, x, mesh, **kw))(params, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return {"y": np.asarray(y), "gp": _np(gp), "gx": np.asarray(gx)}


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    gang = GangHandle(functools.partial(workers.expert_parallel_worker, cases=cases), 4,
                      GANG_PORT, timeout=150.0)
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


# ------------------------------------------------------- gating, dispatch
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
def test_top_k_gates_match_the_reference(dtype, k):
    logits = np.random.default_rng(0).normal(size=(40, E)).astype(np.float32)
    logits[::3, 2] = logits[::3, 0]          # ties: the lower expert first, as lax.top_k
    logits[5] = 0.5                          # every expert tied
    jw, ji = junified._top_k_gates(jnp.asarray(logits).astype(getattr(jnp, dtype)), k)
    w, i = unified._top_k_gates(torch.from_numpy(logits).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.float().numpy(), np.asarray(jw, np.float32), rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-2)
    assert i[5].tolist() == list(range(k))


@pytest.mark.parametrize("capacity", [3, 8, 32])
def test_dispatch_tensors_match_the_reference(capacity):
    logits = np.random.default_rng(1).normal(size=(32, E)).astype(np.float32)
    jc, jd = jax.jit(lambda lg: junified._dispatch_tensors(
        *junified._top_k_gates(lg, 2), E, capacity))(jnp.asarray(logits))
    g, i = unified._top_k_gates(torch.from_numpy(logits), 2)
    c, d = unified._dispatch_tensors(g, i, E, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    assert d.sum(0).max() <= 1.0             # no capacity cell used twice


def test_bf16_ranks_past_256_stay_exact():
    # tests/test_expert_parallel.py:50-62: 600 tokens all routed to expert 0
    n = 600
    logits = np.tile(np.asarray([[10.0, 0, 0, 0]], np.float32), (n, 1))
    jc, jd = jax.jit(lambda lg: junified._dispatch_tensors(
        *junified._top_k_gates(lg, 1), E, n))(jnp.asarray(logits, jnp.bfloat16))
    g, i = unified._top_k_gates(torch.from_numpy(logits).to(torch.bfloat16), 1)
    c, d = unified._dispatch_tensors(g, i, E, n)
    assert d.dtype == torch.bfloat16 and float(d.float().sum()) == n
    assert d.float().sum(0).max() == 1.0
    np.testing.assert_array_equal(d.float().numpy(), np.asarray(jd, np.float32))
    np.testing.assert_array_equal(c.float().numpy(), np.asarray(jc, np.float32))


@pytest.mark.parametrize("top_k,cf", [(2, float(E)), (2, 2.0), (1, 1.0), (2, 0.5)])
def test_moe_ffn_dense_matches_the_reference(top_k, cf):
    params = _jparams(3)
    x = _tokens(2, 24)
    want = _jdense(params, jnp.asarray(x), top_k=top_k, capacity_factor=cf)
    got = unified.moe_ffn_dense(_torch(params), torch.from_numpy(x), top_k=top_k,
                                capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # no mesh, and a mesh-less call with the defaults: the dense oracle
    torch.testing.assert_close(unified.moe_ffn(_torch(params), torch.from_numpy(x), None,
                                               top_k=top_k, capacity_factor=cf), got)


def test_moe_ffn_dense_gradients_match_the_reference():
    params, x = _jparams(4), _tokens(3, 16)

    def jloss(p, x):
        return jnp.mean(junified.moe_ffn_dense(p, x) ** 2)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in _torch(params).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    unified.moe_ffn_dense(p, xt).pow(2).mean().backward()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)


def test_init_moe_params_shapes_and_scales():
    p = unified.init_moe_params(0, 64, 128, 8)
    want = _jparams(0, 64, 128, 8)
    for k in want:
        assert tuple(p[k].shape) == tuple(want[k].shape) and p[k].dtype == torch.float32
    assert abs(float(p["w_in"].std()) - 1 / 8) < 0.01
    assert float(p["b_out"].abs().max()) == 0.0


# --------------------------------------------------------- the sharded path
@pytest.mark.parametrize("name", ["ep2", "ep4", "dp2xep2", "ep2_drops"])
def test_moe_ffn_sharded_matches_the_reference(runs, name):
    cases, ref, ranks = runs
    members = _members(ranks, name)
    d, e = cases[name]["mesh"]
    assert len(members) == d * e
    per = cases[name]["x"].shape[0] // (d * e)
    for r in members:
        rows = slice(r["shard"] * per, (r["shard"] + 1) * per)
        np.testing.assert_allclose(r["y"], ref[name]["y"][rows], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["gx"], ref[name]["gx"][rows], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ep2", "ep4", "dp2xep2", "ep2_drops"])
def test_gradients_through_the_all_to_all_match_the_reference(runs, name):
    cases, ref, ranks = runs
    members = _members(ranks, name)
    want = ref[name]["gp"]
    e = cases[name]["mesh"][1]
    per = E // e
    # the gate is every shard's; each expert's rows the sum over the data positions
    gate = sum(r["grads"]["gate"] for r in members)
    np.testing.assert_allclose(gate, want["gate"], rtol=RTOL, atol=ATOL)
    for key in ("w_in", "b_in", "w_out", "b_out"):
        for j in range(e):
            got = sum(r["grads"][key] for r in members if r["expert_index"] == j)
            np.testing.assert_allclose(got, want[key][j * per:(j + 1) * per], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key} experts of rank {j}")
    assert any(np.abs(g).max() > 0 for r in members for g in r["grads"].values())


def test_two_all_to_alls_each_way_of_the_dispatch_buffers(runs):
    cases, _, ranks = runs
    for name in ("ep2", "ep4"):
        case = cases[name]
        e = case["mesh"][1]
        n_local = case["x"].shape[0] // e
        capacity = int(np.ceil(n_local * case["kw"]["top_k"] / E * case["kw"]["capacity_factor"]))
        sent = E * capacity * D * 4 * (e - 1) // e
        for r in _members(ranks, name):
            fwd, bwd = r["exchange"]
            assert fwd == {"all_to_all": (2, 2 * sent)}, fwd
            assert bwd == {"all_to_all": (2, 2 * sent)}, bwd


def test_refusals_follow_the_reference(runs):
    _, _, ranks = runs
    mesh = jmake_mesh(data=1, expert=2, devices=jax.devices()[:2])
    three = _jparams(0, e=3)
    with pytest.raises(ValueError, match="not divisible") as info:
        with mesh:
            junified.moe_ffn(three, jnp.zeros((8, D)), mesh)
    for r in ranks[:2]:
        assert r["errors"]["experts"] == str(info.value)
        assert "shard_moe_params" in r["errors"]["rows"]
        assert r["errors"]["whole_tree_equal"]      # the whole tree is cut to the rank's rows


def test_a_mesh_without_an_expert_axis_is_the_dense_oracle():
    class _NoExperts:
        shape = {"pipe": 1, "data": 4, "seq": 1, "expert": 1, "model": 1}

    params, x = _torch(_jparams(0)), torch.from_numpy(_tokens(1, 8))
    torch.testing.assert_close(unified.moe_ffn(params, x, _NoExperts()),
                               unified.moe_ffn_dense(params, x))


@pytest.mark.parametrize("package", ["deeplearning4j_tpu", "deeplearning4j_tpu_torch"])
def test_expert_parallel_shim_warns_and_routes(package):
    modname = f"{package}.parallel.expert_parallel"
    sys.modules.pop(modname, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = importlib.import_module(modname)
    assert any(issubclass(w.category, DeprecationWarning) and "deprecated" in str(w.message)
               for w in caught)
    home = importlib.import_module(f"{package}.parallel.unified")
    for name in ("moe_ffn", "moe_ffn_dense", "init_moe_params", "shard_moe_params",
                 "_top_k_gates", "_dispatch_tensors"):
        assert getattr(shim, name) is getattr(home, name)
    if package == "deeplearning4j_tpu_torch":
        assert parallel.moe_ffn is unified.moe_ffn and "moe_ffn" in parallel.__all__
