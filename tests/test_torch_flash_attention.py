"""The port's flash attention held to the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the JAX kernels
(``flash_attention_block`` and the merged ``flash_attention_block_bwd``,
in interpret mode on the CPU, 8 x 8 blocks) and through the port's plain
versions, which the port's wrappers run for CPU tensors.  Cases: no mask,
a key mask, causal at global offsets, Tq != Tk, lengths that are no
multiple of the block, dead rows (all keys masked, or all in the causal
future), query and key tails under causal offsets with a key mask, and
head dims past 128 (192 with a key mask; 256 causal with a
dead batch row), which the kernels run in column slabs.

Bands (read at most, in brackets).  f32: 1e-5 for o, m, l (7.2e-7) and
1e-5 of each gradient's largest entry for dq, dk, dv (7.0e-7): both sides
compute in f32 in other orders.  bf16: m to 1e-5 and l to 1e-4 relative
(3.2e-7: both f32, from the same bf16 products); o to 5e-3 of its
largest entry (1.9e-3), because the JAX kernel rounds p to bf16 against
each block's running max and the plain version against the row's final
max (2^-8 relative per term); dk and dv to 1e-4 (1.2e-7: p and ds round
to bf16 on both sides, so they differ only where exp's last bit moves a
rounding) and dq to 8e-3 (2.3e-3), because the JAX kernel also rounds
each key block's dq partial to bf16 before the sum.  Dead rows must come
out exactly 0, NEG_INF, 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jattention

from deeplearning4j_tpu_torch.ops import attention
from deeplearning4j_tpu_torch.ops.kernels import flash_attention as flash

# the module, not the function the package re-exports under the same name
jflash = importlib.import_module("deeplearning4j_tpu.ops.pallas.flash_attention")

# name: (B, H, Tq, Tk, D, causal, mask, q_offset, k_offset)
CASES = {
    "plain": (2, 2, 24, 24, 16, False, None, 0, 0),
    "key_mask": (2, 2, 24, 24, 16, False, "random", 0, 0),
    "causal_offsets": (1, 2, 20, 28, 16, True, None, 40, 16),
    "cross": (2, 2, 10, 30, 8, False, None, 0, 0),
    "ragged": (1, 3, 21, 19, 8, False, "ragged", 0, 0),
    "dead_mask": (2, 2, 16, 16, 8, False, "dead", 0, 0),
    "dead_causal": (1, 2, 16, 24, 8, True, None, 0, 10),
    "head_dim_192": (1, 2, 20, 24, 192, False, "random", 0, 0),
    "head_dim_256": (2, 2, 24, 20, 256, True, "dead", 8, 0),
    # tails of both the query and the key tiles, causal at offsets, and a
    # batch row whose keys end early (the card's ragged case, made small)
    "ragged_causal_mask": (2, 2, 70, 131, 16, True, "tail", 40, 0),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": {"o": 1e-5, "m": 1e-5, "l": 1e-5}, "bf16": {"o": 5e-3, "m": 1e-5, "l": 1e-4}}
BWD_TOL = {"f32": {"dq": 1e-5, "dk": 1e-5, "dv": 1e-5},
           "bf16": {"dq": 8e-3, "dk": 1e-4, "dv": 1e-4}}
SCALE = 0.3


def _mask(kind, b, tk, rng):
    if kind is None:
        return None
    m = np.ones((b, tk), np.float32)
    if kind == "random":
        m = (rng.random((b, tk)) < 0.7).astype(np.float32)
        m[:, 0] = 1.0
    elif kind == "ragged":
        m[0, 13:] = 0.0
    elif kind == "dead":
        m[1] = 0.0
    elif kind == "tail":
        m[1, 90:] = 0.0
    return m


def _inputs(case, dtype, seed=0):
    b, h, tq, tk, d, causal, kind, qo, ko = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=s).astype(np.float32)
                     for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d)))
    jd, td = DTYPES[dtype]
    # round once to the working type so both sides start from the same values
    q, k, v, dout = (np.array(jnp.asarray(x, jd).astype(jnp.float32)) for x in (q, k, v, dout))
    mask = _mask(kind, b, tk, rng)
    kw = dict(scale=SCALE, causal=causal, q_offset=qo, k_offset=ko)
    jin = [jnp.asarray(x, jd) for x in (q, k, v, dout)]
    tin = [torch.from_numpy(x).to(td) for x in (q, k, v, dout)]
    return jin, tin, mask, kw


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_forward(jin, mask, kw):
    q, k, v, _ = jin
    return jflash.flash_attention_block(
        q, k, v, key_mask=None if mask is None else jnp.asarray(mask), block_q=8, block_k=8,
        **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_pallas(case, dtype):
    jin, tin, mask, kw = _inputs(case, dtype)
    oj, mj, lj = (np.asarray(x, np.float32) for x in _jax_forward(jin, mask, kw))
    before = flash.launches
    ot, mt, lt = flash.flash_attention_block(
        *tin[:3], key_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert flash.launches == before
    assert ot.dtype == mt.dtype == lt.dtype == torch.float32
    ot, mt, lt = ot.numpy(), mt.numpy(), lt.numpy()
    dead = lj == 0
    if case.startswith("dead"):
        assert dead.any()
    np.testing.assert_array_equal(lt[dead], 0.0)
    np.testing.assert_array_equal(mt[dead], np.float32(flash.NEG_INF))
    np.testing.assert_array_equal(ot[dead], 0.0)
    tol = FWD_TOL[dtype]
    assert _rel(ot, oj) <= tol["o"]
    np.testing.assert_allclose(mt[~dead], mj[~dead], rtol=tol["m"], atol=tol["m"])
    np.testing.assert_allclose(lt, lj, rtol=tol["l"], atol=tol["l"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas(case, dtype):
    jin, tin, mask, kw = _inputs(case, dtype, seed=1)
    oj, mj, lj = _jax_forward(jin, mask, kw)
    out = (oj / jnp.maximum(lj[..., None], 1e-20)).astype(jin[0].dtype)
    lse = jflash.flash_lse(mj, lj)
    q, k, v, dout = jin
    jmask = None if mask is None else jnp.asarray(mask)
    want = jflash.flash_attention_block_bwd(q, k, v, out, lse, dout, key_mask=jmask,
                                            block_q=8, block_k=8, **kw)
    before = flash.bwd_launches
    td = tin[0].dtype
    got = flash.flash_attention_block_bwd(
        *tin[:3], torch.from_numpy(np.array(out.astype(jnp.float32))).to(td),
        torch.from_numpy(np.array(lse)), tin[3],
        key_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert flash.bwd_launches == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        err = _rel(g.numpy(), np.asarray(w, np.float32))
        assert err <= BWD_TOL[dtype][name], f"{name}: {err:.2e} over {BWD_TOL[dtype][name]}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_grad_matches_jax_grad(causal, masked):
    """[B, T, H*D] attention and its autograd (the port's Function, plain
    on the CPU) against jax.grad through the Pallas custom_vjp, f32, with
    a non-uniform cotangent: 2e-5 on the output, 2e-4 on the gradients
    (the JAX kernel tests' own bands)."""
    rng = np.random.default_rng(7)
    b, t, h, d = 2, 21, 2, 8
    q, k, v = (rng.normal(size=(b, t, h * d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((b, t)) < 0.8).astype(np.float32) if masked else None
    if masked:
        mask[:, 0] = 1.0

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, n_heads=h, causal=causal, block_q=8, block_k=8,
                                     key_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, n_heads=h, causal=causal,
                                key_mask=None if mask is None else torch.from_numpy(mask))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=name)


def test_flash_attention_bf16_grads_are_bf16():
    """The Function casts dq, dk, dv to the inputs' dtypes and gives the
    key mask no gradient."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 16, 16)).astype(np.float32)).bfloat16()
    q.requires_grad_(True)
    mask = torch.ones(1, 16, requires_grad=True)
    out = flash.flash_attention(q, q, q, n_heads=2, key_mask=mask)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and mask.grad is None


def test_routing_at_the_auto_length(monkeypatch):
    """``use_flash=None`` takes the flash path from FLASH_AUTO_SEQ_LEN = 1024
    on, and the einsum path at 1023; explicit True/False always wins."""
    calls = []
    real = attention.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", spy)
    assert attention.FLASH_AUTO_SEQ_LEN == jattention.FLASH_AUTO_SEQ_LEN == 1024
    rng = np.random.default_rng(0)
    for t in (1023, 1024):
        x = torch.from_numpy(rng.normal(size=(1, t, 16)).astype(np.float32))
        out = attention.multi_head_attention(x, x, x, n_heads=2)
        assert out.shape == (1, t, 16)
        assert attention._auto_flash(x, x) == jattention._auto_flash(jnp.asarray(x.numpy()),
                                                                     jnp.asarray(x.numpy()))
    assert calls == [1024]
    small = torch.zeros(1, 4, 16)
    attention.multi_head_attention(small, small, small, n_heads=2, use_flash=True)
    attention.multi_head_attention(torch.zeros(1, 1024, 16), torch.zeros(1, 1024, 16),
                                   torch.zeros(1, 1024, 16), n_heads=2, use_flash=False)
    assert calls == [1024, 4]
    assert not attention._auto_flash(small.double(), small.double())


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kind", ["mask", "kv_mask", "causal", "cross"])
def test_multi_head_attention_paths_match_jax(use_flash, kind):
    """Both paths against the same JAX path (f32, 2e-5), including the
    query-row zeroing of ``mask=`` and a batch row whose keys are all
    masked: the einsum path gives it a uniform softmax (NEG_INF = -1e9),
    the flash path zeros it; each port path matches its own reference."""
    rng = np.random.default_rng(11)
    b, t, h, d = 2, 12, 2, 8
    tk = 17 if kind == "cross" else t
    q = rng.normal(size=(b, t, h * d)).astype(np.float32)
    k, v = (rng.normal(size=(b, tk, h * d)).astype(np.float32) for _ in range(2))
    m = (rng.random((b, tk)) < 0.7).astype(np.float32)
    m[0, 0] = 1.0
    m[1] = 0.0                                      # dead keys for batch row 1
    kwargs = {"mask": {"mask": m}, "kv_mask": {"kv_mask": m}, "causal": {"causal": True},
              "cross": {"kv_mask": m}}[kind]
    want = jattention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads=h, use_flash=use_flash,
        flash_block=8, **{key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                          for key, x in kwargs.items()})
    got = attention.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_heads=h,
        use_flash=use_flash, flash_block=8,
        **{key: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for key, x in kwargs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    if kind == "kv_mask":
        row = got.numpy()[1]
        assert (np.abs(row).max() == 0.0) == use_flash


def test_dot_product_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 6, 8)).astype(np.float32) for _ in range(3))
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    for m in (None, mask, np.broadcast_to(mask[:, None, :], (2, 6, 6)).copy()):
        want = jattention.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if m is None else jnp.asarray(m))
        got = attention.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
