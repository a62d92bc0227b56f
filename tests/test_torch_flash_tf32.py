"""The arithmetic of the f32 flash kernels' three TF32 passes, on the CPU.

On the card the f32 forward and merged backward run every product a.b
as ``a_hi.b_lo + a_lo.b_hi + a_hi.b_hi`` on the tensor cores, with
``x_hi`` = x rounded to TF32 and ``x_lo = x - x_hi``
(``ops/kernels/csrc/flash_attention_sm90.cuh``).  The wrapper module
carries that arithmetic as plain PyTorch (``tf32_split``, ``tf32_cut``,
``tf32_three_pass_matmul``); these tests hold it:

- the split is exact and its hi is a TF32 number, rounded to nearest
  with ties away from zero (``cvt.rna.tf32.f32``);
- a three-pass product stays within 1e-6 of an f64 product, relative to
  sum |a_i b_i| (f32's own order; read at most 3e-8 at K = 4096), where
  one TF32 pass misses that bound by 10x or more;
- p's A operand in the forward: lane t holds keys 2 t and 2 t + 1 of each
  8 in the accumulator and feeds them as the A operand's columns t and
  t + 4, so v^T's keys are permuted the same way (``key_column`` in the
  CUDA source, mirrored here), and the product is p v;
- flash attention whose every product runs in three passes stays within
  the f32 limits ``chip_smoke.py`` holds the kernels to (2e-5 of each
  output's largest entry) against the plain version and against the JAX
  kernel in interpret mode, while one TF32 pass moves some output past
  10x those limits (the planted fault of ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import flash_attention as flash

jflash = importlib.import_module("deeplearning4j_tpu.ops.pallas.flash_attention")

THREE_PASS_BOUND = 1e-6
FLASH_F32_TOL = 2e-5          # chip_smoke.FLASH_TOL["float32"] for o, out, dq, dk, dv
SEED = 20261017


def _rng(i=0):
    return np.random.default_rng(SEED + i)


def _samples(kind):
    r = _rng()
    if kind == "normal":
        x = r.standard_normal(200_000)
    elif kind == "wide":          # magnitudes over 2^-60 .. 2^60, both signs
        x = r.standard_normal(200_000) * np.exp2(r.integers(-60, 60, 200_000))
    else:                          # values next to rounding ties
        base = r.integers(1 << 10, 1 << 11, 50_000).astype(np.float64)
        x = np.concatenate([(base + 0.5) * 2.0 ** -10, -(base + 0.5) * 2.0 ** -5,
                            np.zeros(8), (base + 0.5 - 2 ** -13) * 2.0 ** -10])
    return torch.tensor(x.astype(np.float32))


def _rna_tf32(x):
    """Round-to-nearest, ties away, to 10 mantissa bits, in float64."""
    x = x.double().numpy()
    m, e = np.frexp(np.abs(x))                   # |x| = m 2^e, m in [0.5, 1)
    q = np.floor(m * 2 ** 11 + 0.5) * 2.0 ** -11  # 11 significant bits: 1 + 10
    return torch.tensor(np.sign(x) * np.ldexp(q, e))


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_tf32_split_is_exact_and_its_hi_is_rounded_to_tf32(kind):
    x = _samples(kind)
    hi, lo = flash.tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi.double(), _rna_tf32(x))
    nonzero = x != 0
    assert (lo.abs()[nonzero] <= x.abs()[nonzero] * 2.0 ** -11).all()
    assert torch.equal(flash.tf32_cut(hi), hi)


def test_tf32_cut_drops_the_low_13_bits():
    x = _samples("normal")
    cut = flash.tf32_cut(x)
    assert torch.equal(cut.view(torch.int32), x.view(torch.int32) & -0x2000)
    assert ((x - cut).abs() <= x.abs() * 2.0 ** -10).all()


@pytest.mark.parametrize("k", [64, 4096])
def test_three_pass_product_keeps_f32_accuracy_where_one_pass_does_not(k):
    r = _rng(k)
    a = torch.tensor(r.standard_normal((64, k)).astype(np.float32))
    b = torch.tensor(r.standard_normal((k, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()

    def err(got):
        return ((got.double() - exact).abs() / scale).max().item()

    three = err(flash.tf32_three_pass_matmul(a, b))
    one = err(flash.tf32_cut(a) @ flash.tf32_cut(b))
    assert three <= THREE_PASS_BOUND
    assert one >= 10 * THREE_PASS_BOUND


def _key_column(r):
    """Mirror of key_column<true> (flash_attention_sm90.cuh): key r's
    column among the K columns of the forward's v^T tile."""
    return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1)


def test_p_from_the_accumulator_meets_the_permuted_v():
    """o += p v with p as the accumulator left it: for each 8-key step j,
    lane t's A registers 0..3 are its accumulator entries 4 j, 4 j + 2,
    4 j + 1, 4 j + 3 (keys 8 j + 2 t, 8 j + 2 t, 8 j + 2 t + 1, 8 j + 2 t + 1
    of rows g, g + 8, g, g + 8), which the tf32 A layout reads as columns
    t, t, t + 4, t + 4.  With v^T's keys at key_column, the product is p v."""
    r = _rng(1)
    keys, d = 64, 32
    p = torch.tensor(r.random((16, keys)))
    v = torch.tensor(r.standard_normal((keys, d)))
    vt = torch.zeros(d, keys, dtype=torch.float64)
    for key in range(keys):
        vt[:, _key_column(key)] = v[key]
    # A (16 x 64) as the tensor core sees it, built from the lanes' registers
    a = torch.zeros(16, keys, dtype=torch.float64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(keys // 8):
            acc = {4 * j + 2 * h + e: p[g + 8 * h, 8 * j + 2 * t + e]
                   for h in range(2) for e in range(2)}
            regs = [acc[4 * j], acc[4 * j + 2], acc[4 * j + 1], acc[4 * j + 3]]
            for i, x in enumerate(regs):
                a[g + 8 * (i & 1), 8 * j + t + 4 * (i >> 1)] = x
    assert sorted(_key_column(key) for key in range(keys)) == list(range(keys))
    assert torch.allclose(a @ vt.T, p @ v, rtol=0, atol=1e-12)


def _inputs(b, h, tq, tk, d, i=0):
    r = _rng(100 + i)
    return [torch.tensor(r.standard_normal(s).astype(np.float32))
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d))]


def _emulated(q, k, v, dout, scale, matmul):
    """Normalized flash attention and its backward (the plain versions'
    math, no mask) with every product through ``matmul``."""
    s = matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = matmul(p, v)
    out = o / l
    lse = (m + torch.log(l))
    p = torch.exp(s - lse)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (matmul(dout, v.transpose(-1, -2)) - delta) * scale
    return {"o": o, "out": out, "dq": matmul(ds, k), "dk": matmul(ds.transpose(-1, -2), q),
            "dv": matmul(p.transpose(-1, -2), dout)}


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _one_pass(a, b):
    return flash.tf32_cut(a) @ flash.tf32_cut(b)


@pytest.mark.parametrize("shape", [(1, 2, 128, 256, 64), (1, 1, 64, 512, 32)])
def test_three_pass_flash_stays_within_the_f32_limits_and_one_pass_does_not(shape):
    b, h, tq, tk, d = shape
    q, k, v, dout = _inputs(b, h, tq, tk, d)
    scale = d ** -0.5
    want = _emulated(*(x.double() for x in (q, k, v, dout)), scale, torch.matmul)
    three = _emulated(q, k, v, dout, scale, flash.tf32_three_pass_matmul)
    one = _emulated(q, k, v, dout, scale, _one_pass)
    errs = {key: _rel(three[key].double(), want[key]) for key in want}
    assert max(errs.values()) <= FLASH_F32_TOL / 4, errs
    worst_one = max(_rel(one[key].double(), want[key]) for key in want)
    assert worst_one >= 10 * FLASH_F32_TOL


def test_one_pass_fault_moves_the_plain_flash_past_its_limits():
    """chip_smoke.py's planted fault, small: the plain forward and backward
    on q, k, v and dout cut to TF32 against the plain versions."""
    q, k, v, dout = _inputs(1, 2, 96, 160, 64, 1)
    kw = dict(scale=64 ** -0.5, causal=True, q_offset=64, k_offset=0)
    q4, k4, v4, d4 = (x.reshape(1, 2, *x.shape[2:]) for x in (q, k, v, dout))
    o, m, l = flash.flash_attention_block_plain(q4, k4, v4, **kw)
    out = o / l[..., None]
    lse = flash.flash_lse(m, l)
    want = flash.flash_attention_block_bwd_plain(q4, k4, v4, out, lse, d4, **kw)
    cut = [flash.tf32_cut(x) for x in (q4, k4, v4, d4)]
    moved = {"o": _rel(flash.flash_attention_block_plain(*cut[:3], **kw)[0], o)}
    got = flash.flash_attention_block_bwd_plain(*cut[:3], out, lse, cut[3], **kw)
    moved |= {key: _rel(g, w) for key, g, w in zip(("dq", "dk", "dv"), got, want)}
    assert max(moved.values()) >= 10 * FLASH_F32_TOL, moved


def test_three_pass_forward_matches_the_jax_kernel():
    """The emulated three-pass forward against the Pallas kernel in
    interpret mode (f32, Precision.HIGHEST), at the f32 band of
    tests/test_torch_flash_attention.py (1e-5 of o's largest entry)."""
    q, k, v, dout = _inputs(2, 2, 24, 24, 16, 2)
    scale = 16 ** -0.5
    o_j, m_j, l_j = jflash.flash_attention_block(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), scale=scale, block_q=8, block_k=8,
        interpret=True)
    got = _emulated(q, k, v, dout, scale, flash.tf32_three_pass_matmul)
    out_j = np.asarray(o_j) / np.asarray(l_j)[..., None]
    assert _rel(got["out"].double(), torch.tensor(out_j).double()) <= 1e-5
