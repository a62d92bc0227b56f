"""The port's flash backward in its two-kernel form, and the head-dim
padding of the flash wrappers, held to the JAX package.

The JAX reference is ``flash_attention_block_bwd(..., merged=False,
interpret=True)``: its ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in
interpret mode on the CPU, 8 x 8 blocks.  The port's plain backward
(which its wrappers run for CPU tensors in both forms) gets the same
numpy inputs, made from a seed, at the seven cases of
``tests/test_torch_flash_attention.py``; the JAX forward of each case
runs once per module.

Bands (read at most, in brackets).  f32: 1e-5 of each gradient's largest
entry (sum order only; 7.0e-7).  bf16: dk and dv at 1e-4 (p and ds round
to bf16 on both sides, so they differ only where exp's last bit moves a
rounding; 1.2e-7), and dq at 1e-4 (2.0e-7): the JAX dq kernel keeps dq
in f32 across the key blocks as the plain version does, where the merged
kernel's bf16 dq partials need 8e-3.

The padding: the kernels take head dims 32, 64 and 128, and multiples of
128 past it in column slabs; the wrappers zero-pad any other head dim up
to the next of these (192 to 256) and slice the outputs back.  Through
the plain versions, padded inputs give the unpadded result to 1e-6 of its
largest entry (f32 matmuls over a longer row may block differently; reads
0 here).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import flash_attention as flash

# the module, not the function the package re-exports under the same name
jflash = importlib.import_module("deeplearning4j_tpu.ops.pallas.flash_attention")

# name: (B, H, Tq, Tk, D, causal, mask, q_offset, k_offset), as in
# tests/test_torch_flash_attention.py
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
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SPLIT_TOL = {"f32": {"dq": 1e-5, "dk": 1e-5, "dv": 1e-5},
             "bf16": {"dq": 1e-4, "dk": 1e-4, "dv": 1e-4}}
PAD_TOL = 1e-6
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
    return m


@functools.lru_cache(maxsize=None)
def _case(case, dtype):
    """Inputs rounded once to the working type, the JAX forward's
    normalized output and lse, and the JAX two-kernel backward."""
    b, h, tq, tk, d, causal, kind, qo, ko = CASES[case]
    rng = np.random.default_rng(1)
    jd, _ = DTYPES[dtype]
    q, k, v, dout = (np.array(jnp.asarray(rng.normal(size=s).astype(np.float32), jd)
                              .astype(jnp.float32))
                     for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d)))
    mask = _mask(kind, b, tk, rng)
    kw = dict(scale=SCALE, causal=causal, q_offset=qo, k_offset=ko)
    jq, jk, jv, jdo = (jnp.asarray(x, jd) for x in (q, k, v, dout))
    jmask = None if mask is None else jnp.asarray(mask)
    o, m, l = jflash.flash_attention_block(jq, jk, jv, key_mask=jmask, block_q=8, block_k=8, **kw)
    out = (o / jnp.maximum(l[..., None], 1e-20)).astype(jd)
    lse = jflash.flash_lse(m, l)
    want = jflash.flash_attention_block_bwd(jq, jk, jv, out, lse, jdo, key_mask=jmask,
                                            block_q=8, block_k=8, interpret=True, merged=False,
                                            **kw)
    inputs = (q, k, v, np.array(out.astype(jnp.float32)), np.array(lse), dout)
    return inputs, mask, kw, [np.asarray(w, np.float32) for w in want]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _torch(inputs, mask, dtype):
    td = DTYPES[dtype][1]
    q, k, v, out, lse, dout = inputs
    tin = [torch.from_numpy(x).to(td) for x in (q, k, v, out)]
    return (*tin, torch.from_numpy(lse), torch.from_numpy(dout).to(td),
            None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_two_kernel_pallas(case, dtype):
    inputs, mask, kw, want = _case(case, dtype)
    q, k, v, out, lse, dout, tmask = _torch(inputs, mask, dtype)
    before = (flash.bwd_launches, flash.split_launches)
    got = flash.flash_attention_block_bwd(q, k, v, out, lse, dout, key_mask=tmask, merged=False,
                                          **kw)
    assert (flash.bwd_launches, flash.split_launches) == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = _rel(g.numpy(), w)
        assert err <= SPLIT_TOL[dtype][name], f"{name}: {err:.2e} over {SPLIT_TOL[dtype][name]}"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_both_forms_are_the_plain_backward_on_the_cpu(dtype):
    """On CPU tensors ``merged`` picks no kernel: both forms give the plain
    version's gradients, bit for bit, and launch nothing."""
    inputs, mask, kw, _ = _case("causal_offsets", dtype)
    args = _torch(inputs, mask, dtype)
    before = (flash.launches, flash.bwd_launches, flash.split_launches)
    split = flash.flash_attention_block_bwd(*args[:6], key_mask=args[6], merged=False, **kw)
    merged = flash.flash_attention_block_bwd(*args[:6], key_mask=args[6], **kw)
    plain = flash.flash_attention_block_bwd_plain(*args[:6], key_mask=args[6], **kw)
    for s, m, p in zip(split, merged, plain):
        torch.testing.assert_close(s, p, rtol=0, atol=0)
        torch.testing.assert_close(m, p, rtol=0, atol=0)
    assert (flash.launches, flash.bwd_launches, flash.split_launches) == before


@pytest.mark.parametrize("d,template", [(1, 32), (8, 32), (32, 32), (33, 64), (64, 64),
                                        (80, 128), (100, 128), (128, 128), (129, 256),
                                        (192, 256), (256, 256), (257, 384)])
def test_kernel_head_dim_is_the_next_template(d, template):
    assert flash.kernel_head_dim(d) == template


def test_head_dims_past_the_largest_template_are_refused():
    """No longer: past the largest template a head dim is padded to the
    next multiple of the slab width, and the checks pass it on to the
    device check."""
    for d in (129, 192, 256, 300):
        assert flash.kernel_head_dim(d) == -(-d // flash.SLAB) * flash.SLAB
        q = torch.zeros(1, 2, 8, d, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash._check(q, q, q, None, "flash_attention")


# (B, H, Tq, padded head dim) -> the merged backward's scratch beside dq:
# one int32 ticket and one int32 flag per (batch, head, column slab, 64-row
# query tile); slabs of 64 columns past 64 (the bf16 key-tile kernels')
@pytest.mark.parametrize("b,h,tq,d,flags", [
    (2, 12, 4096, 64, 2 * 12 * 64), (2, 12, 1000, 64, 2 * 12 * 16),
    (2, 24, 4096, 32, 2 * 24 * 64), (2, 6, 4096, 128, 2 * 6 * 2 * 64),
    (2, 3, 4096, 256, 2 * 3 * 4 * 64), (1, 1, 1, 32, 1)])
def test_merged_scratch_is_the_ordered_sums_flags(b, h, tq, d, flags):
    assert flash.merged_scratch_bytes(b, h, tq, d) == 4 * (1 + flags)


def test_merged_scratch_is_no_quadratic_partials():
    """At the base case the scratch beside dq is far under an eighth of
    the per-key-tile f32 partials (4 D BH Tq Tk/64 bytes, 1.61 GB), and at
    (2, 12, 32768, 64) it stays a few hundred KB: the merged form runs
    where the partials (103 GB) could not."""
    partials = 4 * 64 * 2 * 12 * 4096 * (4096 // 64)
    assert partials == 1_610_612_736
    assert flash.merged_scratch_bytes(2, 12, 4096, 64) <= partials / 8
    assert flash.merged_scratch_bytes(2, 12, 4096, 64) <= 0.2e9
    assert flash.merged_scratch_bytes(2, 12, 32768, 64) < 1e6


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["key_mask", "causal_offsets", "ragged", "head_dim_192"])
def test_head_dim_padding_gives_the_unpadded_result(case, dtype):
    """Forward and both backward outputs through the plain versions, with
    q, k, v and dout zero-padded to the next template and the outputs
    sliced back, against the same functions on the unpadded tensors."""
    inputs, mask, kw, _ = _case(case, dtype)
    q, k, v, out, lse, dout, tmask = _torch(inputs, mask, dtype)
    d = q.shape[-1]
    dp = flash.kernel_head_dim(d)
    assert dp > d
    qp, kp, vp, outp, dop = flash.pad_head_dim((q, k, v, out, dout), dp)
    assert qp.shape[-1] == dp and qp.is_contiguous() and not qp[..., d:].any()
    o, m, l = flash.flash_attention_block_plain(q, k, v, key_mask=tmask, **kw)
    op, mp, lp = flash.flash_attention_block_plain(qp, kp, vp, key_mask=tmask, **kw)
    (op,) = flash.unpad_head_dim((op,), d)
    assert op.is_contiguous() and op.shape == o.shape
    for got, want in ((op, o), (mp, m), (lp, l)):
        assert _rel(got.numpy(), want.numpy()) <= PAD_TOL
    grads = flash.flash_attention_block_bwd_plain(q, k, v, out, lse, dout, key_mask=tmask, **kw)
    padded = flash.unpad_head_dim(flash.flash_attention_block_bwd_plain(
        qp, kp, vp, outp, lse, dop, key_mask=tmask, **kw), d)
    for name, got, want in zip(("dq", "dk", "dv"), padded, grads):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) <= PAD_TOL, name
