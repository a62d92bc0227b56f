"""The forward kernel's launch plan and its f32 arithmetic, on the CPU.

``conv_bn.fwd_plan`` is the shape of the forward's one launch (tiles, K
splits, persistent blocks, one scratch buffer), and the f32 kernel
computes each product in three TF32 passes, a fresh tile per 32-column
chunk of K whose adds round toward zero as the tensor core's do; emulated
here in plain PyTorch at every (K, N) of ResNet-50's 36 calls against the
exact product, with ``chip_smoke.py``'s limits and scales."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.models import resnet50
from deeplearning4j_tpu_torch.ops.kernels import conv_bn
from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_cut, tf32_split

DTYPES = (torch.float32, torch.bfloat16)


def _resnet50_calls(batch):
    return chip_smoke.resnet50_calls(resnet50(fused=True, device="cpu"), batch)


CALLS = {batch: _resnet50_calls(batch) for batch in (32, 256)}


@pytest.mark.parametrize("sms", [132, 114])   # H100 SXM, H100 PCIe
@pytest.mark.parametrize("batch", [32, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fwd_plan_tiles_cover_m_and_n_and_splits_fill_the_card(dtype, batch, sms):
    """At every one of ResNet-50's 36 calls: the tiles cover M and N, the K
    splits cover the chunks in order, each at least one, and with the tiles
    fill one wave of the card's SMs where K allows, no more; the persistent
    blocks are one a tile's split there, else ``rows`` for each column tile,
    at most one an SM, and walking the row tiles ``rows`` apart they cover
    every tile once."""
    calls = CALLS[batch]
    assert len(calls) == 36
    for m, k, n, _ in set(calls):
        p = conv_bn.fwd_plan(m, k, n, dtype, sms)
        assert (p["tiles_m"], p["tiles_n"]) == (-(-m // conv_bn.TILE_M), -(-n // conv_bn.TILE_N))
        assert (p["tiles_m"] - 1) * conv_bn.TILE_M < m <= p["tiles_m"] * conv_bn.TILE_M
        assert (p["tiles_n"] - 1) * conv_bn.TILE_N < n <= p["tiles_n"] * conv_bn.TILE_N
        assert p["chunks"] == -(-k // conv_bn.CHUNK[dtype])
        ranges = p["chunk_ranges"]
        assert len(ranges) == p["splits"] and ranges[0][0] == 0 and ranges[-1][1] == p["chunks"]
        assert all(r0 < r1 for r0, r1 in ranges)
        assert all(u[1] == v[0] for u, v in zip(ranges, ranges[1:]))
        tiles = p["tiles_m"] * p["tiles_n"]
        assert p["splits"] * tiles <= max(sms, tiles)
        assert (p["splits"] == 1 and tiles >= sms or p["splits"] == p["chunks"]
                or (p["splits"] + 1) * tiles > sms)
        assert p["blocks"] == p["rows"] * p["tiles_n"] * p["splits"] <= max(sms, tiles)
        if tiles <= sms:
            assert p["rows"] == p["tiles_m"] and p["blocks"] == tiles * p["splits"]
        else:
            assert p["splits"] == 1 and p["blocks"] > sms - p["tiles_n"]
        items = {(b // p["tiles_n"] + i * p["rows"], b % p["tiles_n"])
                 for b in range(p["rows"] * p["tiles_n"])
                 for i in range(-(-p["tiles_m"] // p["rows"]))
                 if b // p["tiles_n"] + i * p["rows"] < p["tiles_m"]}
        assert len(items) == tiles


def test_fwd_plan_splits_the_last_stage_at_batch_32():
    """Batch 32's last stage (M = 1568): 13 row tiles of 128, and the calls
    with N = 512 (52 tiles) split K in two; N = 2048 (208 tiles) does not."""
    for dtype in DTYPES:
        assert conv_bn.fwd_plan(1568, 2048, 512, dtype)["splits"] == 2
        assert conv_bn.fwd_plan(1568, 1024, 512, dtype)["splits"] == 2
        assert conv_bn.fwd_plan(1568, 512, 2048, dtype)["splits"] == 1
        assert conv_bn.fwd_plan(100352, 64, 64, dtype)["splits"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1568, 2048, 512), (100352, 64, 256), (300, 100, 24),
                                   (7, 4, 8), (1568, 1000, 200), (200, 24, 100)])
def test_fwd_plan_scratch_is_what_the_kernel_takes(dtype, m, k, n):
    """One f32 buffer: s1 and s2 first, then the column-sum tables (each of
    the plan's ``rows`` blocks of a column tile, then each group of
    ``GROUP``), the partials of the splits (with a slice per group past one
    group), W^T with rows of K rounded up to 4 (f32 only), and the arrival
    counts (per tile and split group when split, then per group and column
    tile, then per column tile); sections 64-entry aligned, in order,
    apart."""
    p = conv_bn.fwd_plan(m, k, n, dtype, 132)
    tiles_m, tiles_n, rows = p["tiles_m"], p["tiles_n"], p["rows"]
    groups = -(-rows // conv_bn.GROUP)
    slices, per_tile = conv_bn.split_scratch(p["splits"])
    split = p["splits"] > 1
    assert p["shapes"] == {
        "sums": (2, n), "stats": (2, rows + groups, n),
        "part": (slices, m, n) if split else (0,),
        "wt": (n, -(-k // 4) * 4) if dtype == torch.float32 else (0,),
        "counts": ((tiles_m * tiles_n * per_tile if split else 0) + tiles_n * (groups + 1),)}
    at, names = p["at"], list(p["shapes"])
    assert names == ["sums", "stats", "part", "wt", "counts"] and at["sums"] == 0
    for name, after in zip(names, names[1:] + [None]):
        end = at[name] + math.prod(p["shapes"][name])
        assert at[name] % 64 == 0 and end <= (at[after] if after else p["floats"])
    assert p["floats"] % 64 == 0 and p["floats"] - at["counts"] < p["shapes"]["counts"][0] + 64


def _rz_add(acc, p):
    """``acc + p`` (f32 + f64) rounded toward zero to f32, as the tensor
    core adds a product into its accumulator."""
    exact = acc.double() + p
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _tf32_forward(xh, w, passes, chunk=32):
    """The f32 kernel's y = xh @ w emulated: per chunk of K a fresh tile,
    into which each 8-column k-step's products (exact: TF32 operands) are
    added toward zero, three passes a k-step (hi.lo, lo.hi, hi.hi; the lo
    parts read as TF32) or one (both operands cut to TF32); each tile
    added into y in f32, in chunk order."""
    xh_hi, xh_lo = tf32_split(xh)
    w_hi, w_lo = tf32_split(w)
    if passes == 3:
        pairs = ((xh_hi, tf32_cut(w_lo)), (tf32_cut(xh_lo), w_hi), (xh_hi, w_hi))
    else:
        pairs = ((tf32_cut(xh), tf32_cut(w)),)
    pairs = [(a.double(), b.double()) for a, b in pairs]
    m, k = xh.shape
    y = torch.zeros(m, w.shape[1], dtype=torch.float32)
    for c0 in range(0, k, chunk):
        tile = torch.zeros_like(y)
        for k0 in range(c0, min(c0 + chunk, k), 8):
            for a, b in pairs:
                tile = _rz_add(tile, a[:, k0:k0 + 8] @ b[k0:k0 + 8])
        y = y + tile
    return y


def _rz_add_bits(acc, p):
    """``_rz_add`` by bits: the f64 sum's mantissa cut to f32's 23 bits is
    the sum rounded toward zero, exact in f32 from f32's smallest normal
    (2^-126) up; a sum below that (zero aside) raises instead."""
    bits = (acc.double() + p).view(torch.int64)
    mag = bits & 0x7FFFFFFFFFFFFFFF
    if bool(((mag > 0) & (mag < (897 << 52))).any()):   # f64 exponent field of 2^-126
        raise AssertionError("a tile's sum is below f32's normal range")
    return (bits & ~0x1FFFFFFF).view(torch.float64).float()


def _tf32_forward_batched(xh, w, passes, chunk=32, group=16):
    """``_tf32_forward``'s arithmetic, bit for bit, with every chunk's tile
    formed at once: K zero-padded to whole chunks (a zero product adds
    nothing toward zero), the tiles of ``group`` chunks as one [group, m,
    n] tensor taking the k-steps' products one pass after another (the
    same sequence of round-toward-zero adds per entry, ``_rz_add_bits``),
    then added into y in chunk order."""
    xh_hi, xh_lo = tf32_split(xh)
    w_hi, w_lo = tf32_split(w)
    if passes == 3:
        pairs = ((xh_hi, tf32_cut(w_lo)), (tf32_cut(xh_lo), w_hi), (xh_hi, w_hi))
    else:
        pairs = ((tf32_cut(xh), tf32_cut(w)),)
    m, k = xh.shape
    n = w.shape[1]
    chunks, steps = -(-k // chunk), chunk // 8
    pad = chunks * chunk - k
    # a: [chunks, steps, m, 8], b: [chunks, steps, 8, n], exact in f64
    pairs = [(torch.nn.functional.pad(a.double(), (0, pad)).reshape(m, chunks, steps, 8)
              .permute(1, 2, 0, 3),
              torch.nn.functional.pad(b.double(), (0, 0, 0, pad)).reshape(chunks, steps, 8, n))
             for a, b in pairs]
    y = torch.zeros(m, n, dtype=torch.float32)
    for g0 in range(0, chunks, group):
        g1 = min(g0 + group, chunks)
        tile = torch.zeros(g1 - g0, m, n, dtype=torch.float32)
        for j in range(steps):
            for a, b in pairs:
                tile = _rz_add_bits(tile, a[g0:g1, j] @ b[g0:g1, j])
        for t in tile:
            y = y + t
    return y


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("k,n", [(72, 40), (64, 24)])
def test_batched_tf32_emulation_is_bit_equal_to_the_loop(k, n, passes):
    """The batched emulation the shape test uses gives the loop's bits,
    K a whole number of chunks or not."""
    rng = np.random.default_rng(k + n)
    xh = torch.from_numpy(rng.normal(size=(48, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    want = _tf32_forward(xh, w, passes)
    for group in (1, 2, 16):
        assert torch.equal(_tf32_forward_batched(xh, w, passes, group=group), want)


KN = sorted({(k, n) for k, n in ((c[1], c[2]) for c in CALLS[32])})


@pytest.mark.parametrize("k,n", KN)
def test_three_tf32_passes_hold_the_f32_limit_at_every_resnet50_shape(k, n):
    """Three TF32 passes, a fresh tile per chunk, read at most 0.1 of
    ``chip_smoke.py``'s f32 limits (y over max |y|, s1 over max_n sum_m
    |y|, s2 over max |s2|) against the exact product; one pass (the
    planted fault) reads at least 10x past them."""
    rng = np.random.default_rng(k * 7919 + n)
    m = 256
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / k ** 0.5).astype(np.float32))
    a = torch.from_numpy((rng.random(k) + 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=k) * 0.2).astype(np.float32))
    xh = torch.relu(x * a + b)
    exact = xh.double() @ w.double()
    want = (exact.float(), exact.sum(0).float(), (exact * exact).sum(0).float())
    reading = {}
    for passes in (1, 3):
        y = _tf32_forward_batched(xh, w, passes)
        reading[passes] = chip_smoke.fwd_over_limit((y, y.sum(0), (y * y).sum(0)), want,
                                                    "float32")
    assert reading[3] <= 0.1, reading
    assert reading[1] >= chip_smoke.FWD_FAULT_MARGIN, reading
