"""The host side of the port's ``conv3x3_bn_act`` kernel, on the CPU.

``conv3_bn.plan`` picks the kernel's grid and scratch from (M, Cout, K):
held at ResNet-50's 16 3x3 stages at batch 32 and 256 and at the shapes
the chip check runs besides (``CONV3_RAGGED`` of ``chip_smoke.py``): the
split count (K split only where the tiles leave SMs idle, never into
more parts than chunks), the scratch shapes, and every K column covered
by exactly one split.  ``conv3_bn.kernel_weight``, the weights as the
kernel's B ([Cout', 9, C'], K-major, zero-padded), and its TF32 halves
are held to the plain version: the implicit GEMM of the folded input's
taps with that layout gives the plain conv's y, s1 and s2.  Then the
wrapper's launch through a stub library: what it pads and passes when K
is split."""

import ctypes

import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import conv3_bn
from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_split

# ResNet-50 v1's 3x3 stages (H = W, C = Cout, calls per pass), as chip_smoke.py
STAGES = ((56, 64, 3), (28, 128, 4), (14, 256, 6), (7, 512, 3))
# chip_smoke.py's CONV3_RAGGED: (N, H, W, C, Cout)
RAGGED = ((2, 8, 7, 16, 16), (32, 28, 28, 24, 40), (32, 56, 56, 3, 5), (8, 112, 112, 64, 64),
          (6, 113, 97, 64, 64))
DTYPES = (torch.float32, torch.bfloat16)
SHAPES = ([(b, h, h, c, c) for b in (32, 256) for h, c, count in STAGES]
          + [s for s in RAGGED])


def _k_columns(p, k, split):
    """The K columns (tap-major: tap * C + channel) that split ``split``
    of plan ``p`` multiplies: every tap of its chunks' real channels."""
    c = k // 9
    ck = p["c_pad"] // p["chunks"]
    lo, hi = p["chunk_ranges"][split]
    return [tap * c + ch for tap in range(9) for ch in range(lo * ck, min(hi * ck, c))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_splits_k_only_where_tiles_leave_sms_idle(shape, dtype):
    n, h, w, c, cout = shape
    m, k = n * h * w, 9 * c
    p = conv3_bn.plan(m, cout, k, dtype)
    ck = conv3_bn.CHUNK[dtype]
    assert p["c_pad"] % ck == 0 and c <= p["c_pad"] < c + ck
    assert p["chunks"] == p["c_pad"] // ck
    assert p["tiles_m"] == -(-m // conv3_bn.TILE_M) and p["tiles_n"] == -(-cout // conv3_bn.TILE_N)
    assert p["cout_pad"] == p["tiles_n"] * conv3_bn.TILE_N and p["x_rows"] >= max(m, 136)
    tiles = p["tiles_m"] * p["tiles_n"]
    if tiles >= conv3_bn.SMS:
        assert p["splits"] == 1
    else:
        # enough splits to fill the card, but no split without a chunk
        assert p["splits"] == min(p["chunks"], -(-conv3_bn.SMS // tiles))
        assert tiles * p["splits"] >= conv3_bn.SMS or p["splits"] == p["chunks"]
    assert p["part"] == ((p["splits"], m, cout) if p["splits"] > 1 else (0,))
    groups = -(-p["tiles_m"] // conv3_bn.GROUP)
    assert p["stats"] == (2, p["tiles_m"] + groups, cout)
    assert p["counts"] == (tiles if p["splits"] > 1 else 0) + p["tiles_n"] * (groups + 1)
    # every K column in exactly one split, each split at least one chunk
    cols = [_k_columns(p, k, s) for s in range(p["splits"])]
    assert all(cols) and sorted(col for part in cols for col in part) == list(range(k))


def test_plan_splits_the_smallest_resnet_stage_at_batch_32():
    """7x7x512 at batch 32: 13 x 8 tiles of 128 x 64 leave SMs idle, so K
    splits in two; every other stage, and every stage at batch 256, fills
    the card without a split."""
    for dtype in DTYPES:
        got = {(b, h): conv3_bn.plan(b * h * h, c, 9 * c, dtype)["splits"]
               for b in (32, 256) for h, c, count in STAGES}
        assert got == {(32, 56): 1, (32, 28): 1, (32, 14): 1, (32, 7): 2,
                       (256, 56): 1, (256, 28): 1, (256, 14): 1, (256, 7): 1}


def test_plan_refuses_a_k_that_is_no_3x3():
    with pytest.raises(ValueError, match="no plan"):
        conv3_bn.plan(64, 8, 10, torch.float32)


def _implicit_gemm(x, bmat, c_pad, a, b, relu_in):
    """y of the kernel's GEMM in f64: the folded input's 9 taps (tap-major,
    zero outside the image, channels padded to C') times B [9C', Cout']."""
    n, h, w, c = x.shape
    xf = x.double()
    if a is not None:
        xf = xf * a.double() + b.double()
        if relu_in:
            xf = torch.relu(xf)
    xp = torch.nn.functional.pad(xf, (0, c_pad - c, 1, 1, 1, 1))
    taps = torch.stack([xp[:, di:di + h, dj:dj + w] for di in range(3) for dj in range(3)], 3)
    return taps.reshape(n * h * w, -1) @ bmat.double()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 7, 16, 16), (2, 6, 5, 3, 40), (1, 5, 9, 40, 70),
                                   (1, 4, 4, 64, 64)])
def test_kernel_weight_layout_gives_the_plain_conv(shape, prologue, dtype):
    """f32: [Cout', 9, C'], K-major; bf16: HWIO padded to [3, 3, C', Cout']."""
    n, h, w, c, cout = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, w, c, generator=gen, dtype=torch.float64)
    wt = torch.randn(3, 3, c, cout, generator=gen).to(dtype)   # exact in f64
    a = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5 if prologue else None
    b = torch.randn(c, generator=gen, dtype=torch.float64) if prologue else None
    p = conv3_bn.plan(n * h * w, cout, 9 * c, dtype)
    cp, op = p["c_pad"], p["cout_pad"]
    wk = conv3_bn.kernel_weight(wt, cp, op)
    assert wk.dtype == dtype and wk.is_contiguous()
    if dtype == torch.float32:
        assert tuple(wk.shape) == (op, 9, cp)
        for tap in range(9):
            torch.testing.assert_close(wk[:cout, tap, :c], wt[tap // 3, tap % 3].T, rtol=0,
                                       atol=0)
        assert not wk[cout:].any() and not wk[:, :, c:].any()
        bmat = wk.reshape(op, 9 * cp).T
    else:
        assert tuple(wk.shape) == (3, 3, cp, op)
        assert (wk.data_ptr() == wt.data_ptr()) == ((cp, op) == (c, cout))   # no copy unpadded
        torch.testing.assert_close(wk[:, :, :c, :cout], wt, rtol=0, atol=0)
        assert not wk[:, :, c:].any() and not wk[..., cout:].any()
        bmat = wk.reshape(9 * cp, op)
    got = _implicit_gemm(x, bmat, cp, a, b, True)[:, :cout]
    want = conv3_bn.conv3x3_bn_act_plain(x, wt.double(), a, b, relu_in=True)
    y = want[0].reshape(-1, cout)
    torch.testing.assert_close(got, y, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got.sum(0), want[1], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close((got * got).sum(0), want[2], rtol=1e-12, atol=1e-9)


def test_f32_weight_halves_are_tf32_and_exact():
    w = torch.randn(64, 9, 32, generator=torch.Generator().manual_seed(5))
    hi, lo = tf32_split(w)
    assert torch.equal(hi + lo, w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= w.abs() * 2.0 ** -11).all()


class _StubLib:
    """The built library: ``rc`` from the launch, its arguments kept."""

    def __init__(self):
        self.args = None

    def conv3x3_bn_act_f32(self, *args):
        self.args = args
        return 0


def test_launch_passes_padded_operands_and_split_scratch():
    """7x7 pixels into 512 channels fill 8 tiles: K splits over C = 40's two
    f32 chunks (padded to 64 channels), with the partials' scratch."""
    x, w = torch.randn(1, 7, 7, 40), torch.randn(3, 3, 40, 512)
    a, b = torch.rand(40) + 0.5, torch.randn(40)
    lib = _StubLib()
    before = conv3_bn.launches
    conv3_bn._launch(lib, x, w, a, b, True, 0)
    conv3_bn.launches = before
    ints = lib.args[11:20]
    assert ints == (1, 7, 7, 64, 136, 512, 512, 2, 1)
    assert all(isinstance(v, int) and v for v in lib.args[:11])   # every pointer, part too
    assert len(conv3_bn._C_ARGS[torch.float32]) == len(lib.args)
    assert conv3_bn._C_ARGS[torch.float32][11:20] == [ctypes.c_int] * 9
