"""The port's sequence-parallel attention (``parallel.unified``:
``ring_attention``, ``ulysses_attention``, ``reference_attention``; the
``context_parallel`` shim) held to the JAX package's.

The port takes each rank's shard (``parallel/unified.py``'s docstring);
it runs in one gang of four gloo processes on the CPU
(``tests/torch_cluster_workers.py::sequence_parallel_worker``) over a
seq-4 mesh and a dp2 x sp2 mesh, and each rank's output (and gradient) is
held to its slice of the JAX package's global result on the same mesh
shape over the conftest's CPU devices.  Cases, from the reference's tests,
and tolerances (the reference's own):

- ring attention, causal and not, on the einsum path and the "flash" path
  (the port's plain block version on the CPU; the reference's Pallas
  kernel in interpret mode), ``tests/test_parallel.py:71-80`` and
  ``tests/test_pallas.py:280-293``: rtol 2e-4, atol 2e-5 against the JAX
  ring and against ``reference_attention``;
- the flash ring in bf16 with ``data_axis`` (dp2 x sp2),
  ``tests/test_pallas.py:262-277``: the output stays bf16, rtol 0.1, atol
  0.05 (its carries round to bf16);
- the einsum ring's gradient of mean(y * y) in q, k and v against
  ``jax.grad`` of the reference's ring: rtol 2e-4, and atol 2e-5 of the
  gradient's largest entry;
- Ulysses, causal and not, and with ``data_axis`` and its gradient,
  ``tests/test_parallel.py:139-175``: rtol 2e-4, atol 2e-5 (the gradient
  as the ring's), and the heads-divisibility ``ValueError``;
- the ring's exchange: three hops of one K/V block each on the seq-4 mesh
  (point to point, never an all-gather), and three back in the backward;
- ``parallel.context_parallel`` warns once and routes to ``unified``, as
  ``tests/test_unified_mesh.py:248-283`` pins for the reference.
"""

import functools
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import unified as junified

import torch_cluster_workers as workers
from deeplearning4j_tpu_torch.parallel import unified
from deeplearning4j_tpu_torch.parallel.launcher import GangHandle

GANG_PORT = 16911
RTOL, ATOL = 2e-4, 2e-5            # tests/test_parallel.py's and test_pallas.py's
BF16_RTOL, BF16_ATOL = 0.1, 0.05   # tests/test_pallas.py's bf16 ring


def _arrays(seed, b, t, width):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, width)).astype(np.float32) for _ in range(3)]


def _cases() -> dict:
    cases = {}
    q, k, v = _arrays(3, 2, 32, 4 * 8)      # tests/test_parallel.py:71-80
    for causal in (False, True):
        for flash in (False, True):
            cases[f"ring_{'flash' if flash else 'einsum'}_{causal}"] = {
                "fn": "ring", "mesh": (1, 4), "q": q, "k": k, "v": v, "n_heads": 4,
                "kw": {"n_heads": 4, "causal": causal, "use_flash": flash, "flash_block": 8},
                "grad": not flash}
    x = np.random.default_rng(5).normal(size=(2, 32, 32)).astype(np.float32)
    cases["ring_bf16_dp"] = {      # tests/test_pallas.py:262-277, on dp2 x sp2
        "fn": "ring", "mesh": (2, 2), "q": x, "k": x, "v": x, "n_heads": 4, "dtype": "bfloat16",
        "kw": {"n_heads": 4, "causal": True, "use_flash": True, "flash_block": 8,
               "data_axis": "data"}, "grad": False}
    q, k, v = _arrays(4, 2, 32, 8 * 8)      # tests/test_parallel.py:139-155
    for causal in (False, True):
        cases[f"ulysses_{causal}"] = {"fn": "ulysses", "mesh": (1, 4), "q": q, "k": k, "v": v,
                                      "n_heads": 8, "kw": {"n_heads": 8, "causal": causal},
                                      "grad": False}
    q, k, v = _arrays(5, 4, 16, 4 * 4)      # tests/test_parallel.py:158-175, on dp2 x sp2
    cases["ulysses_dp"] = {"fn": "ulysses", "mesh": (2, 2), "q": q, "k": k, "v": v,
                           "n_heads": 4, "kw": {"n_heads": 4, "causal": True,
                                                "data_axis": "data"}, "grad": True}
    return cases


def _jax_case(case) -> dict:
    """The reference's global output (and gradients of mean(y * y)) on a
    mesh of the case's shape over the conftest's CPU devices."""
    d, s = case["mesh"]
    mesh = jmake_mesh(data=d, seq=s, devices=jax.devices()[:d * s])
    dtype = jnp.bfloat16 if case.get("dtype") == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(case[key]).astype(dtype) for key in ("q", "k", "v"))
    fn = junified.ring_attention if case["fn"] == "ring" else junified.ulysses_attention
    kw = dict(case["kw"])
    if case["fn"] == "ring" and d > 1:
        kw.setdefault("data_axis", "data")

    @jax.jit
    def call(q, k, v):
        return fn(q, k, v, mesh, axis="seq", **kw)

    out = {"y": np.asarray(call(q, k, v).astype(jnp.float32)),
           "ref": np.asarray(junified.reference_attention(
               q, k, v, n_heads=case["n_heads"], causal=kw["causal"]).astype(jnp.float32))}
    if case["grad"]:
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.mean(call(q, k, v) ** 2),
                                 argnums=(0, 1, 2)))(q, k, v)
        out["grads"] = [np.asarray(g) for g in grads]
    return out


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    gang = GangHandle(functools.partial(workers.sequence_parallel_worker, cases=cases), 4,
                      GANG_PORT, timeout=150.0)
    try:
        ref = {name: _jax_case(case) for name, case in cases.items()}
    except BaseException:
        gang.shutdown()
        raise
    return cases, ref, sorted(gang.wait(), key=lambda r: r["pid"])


def _slice(case, got, x):
    """The slice of global ``x`` that the rank of result ``got`` holds."""
    d, s = case["mesh"]
    i, j = got["index"]
    b, t = x.shape[0] // d, x.shape[1] // s
    return x[max(i, 0) * b:(max(i, 0) + 1) * b, j * t:(j + 1) * t]


def _each(runs, prefix):
    cases, ref, ranks = runs
    names = [n for n in cases if n.startswith(prefix)]
    assert names
    for name in names:
        for rank in ranks:
            yield name, cases[name], ref[name], rank[name], rank


@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_ring_attention_matches_the_reference(runs, path):
    for name, case, want, got, rank in _each(runs, f"ring_{path}_"):
        np.testing.assert_allclose(got["y"], _slice(case, got, want["y"]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got["y"], _slice(case, got, want["ref"]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        # n - 1 hops of one K/V block ([2, B, H, T/n, D] f32), point to point,
        # and as many back in the backward
        hops = 3 * (1 + case["grad"])
        assert got["exchange"]["ring"] == (hops, hops * 2 * 2 * 4 * 8 * 8 * 4)


def test_flash_ring_in_bf16_with_a_data_axis(runs):
    for name, case, want, got, rank in _each(runs, "ring_bf16_dp"):
        assert got["dtype"] == "bfloat16"
        np.testing.assert_allclose(got["y"], _slice(case, got, want["ref"]), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(got["y"], _slice(case, got, want["y"]), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    _, _, ranks = runs
    assert sorted(r["ring_bf16_dp"]["index"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                                       (1, 1)]


@pytest.mark.parametrize("name", ["ring_einsum_False", "ring_einsum_True", "ulysses_dp"])
def test_gradients_match_jax_grad_of_the_reference(runs, name):
    cases, ref, ranks = runs
    case, want = cases[name], ref[name]
    for rank in ranks:
        for got, g in zip(rank[name]["grads"], want["grads"]):
            np.testing.assert_allclose(got, _slice(case, rank[name], g), rtol=RTOL,
                                       atol=ATOL * np.abs(g).max())


def test_ulysses_attention_matches_the_reference(runs):
    for name, case, want, got, rank in _each(runs, "ulysses_"):
        np.testing.assert_allclose(got["y"], _slice(case, got, want["y"]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got["y"], _slice(case, got, want["ref"]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert got["exchange"]["all_to_all"][0] == 4 + 4 * case["grad"]


def test_refusals_follow_the_reference(runs):
    _, _, ranks = runs
    mesh = jmake_mesh(data=1, seq=4, devices=jax.devices()[:4])
    x = jnp.zeros((2, 16, 24))
    with pytest.raises(ValueError, match="divisible"):
        with mesh:
            junified.ulysses_attention(x, x, x, mesh, axis="seq", n_heads=6)
    for rank in ranks:
        assert "divisible" in rank["errors"]["heads"]
        assert "item 2.5" in rank["errors"]["head_axis"]
    assert callable(unified.moe_ffn)          # item 2.4's remainder is ported
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 2.5"):
        unified.tp_jit(lambda p: p, None)


@pytest.mark.parametrize("package", ["deeplearning4j_tpu", "deeplearning4j_tpu_torch"])
def test_context_parallel_shim_warns_once_and_routes(package):
    modname = f"{package}.parallel.context_parallel"
    sys.modules.pop(modname, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module(modname)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
           and "deprecated" in str(w.message)]
    assert len(dep) == 1
    routed = importlib.import_module(f"{package}.parallel.unified")
    for name in ("ring_attention", "ulysses_attention", "reference_attention", "NEG_INF"):
        assert getattr(mod, name) is getattr(routed, name)
    assert mod.NEG_INF == -1e30
