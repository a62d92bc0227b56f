"""Fused 3x3 conv + BatchNorm statistics (port of
``deeplearning4j_tpu/ops/pallas/conv3_bn.py::conv3x3_bn_act``).

``conv3x3_bn_act(x, w, a, b, relu_in=...)`` computes, for x [N, H, W, C]
(NHWC), w [3, 3, C, Cout] (HWIO) and the optional per-channel BN fold
a, b [C] (f32)::

    y  = conv3x3_SAME(act(x * a + b))      stride 1, in x's dtype
    s1 = sum y,  s2 = sum y*y              [Cout] f32, over N*H*W

SAME padding pads the folded input with zeros.  Without a and b the
input goes in unfolded, and ``relu_in`` does nothing.  In bf16 the
folded input is rounded to bf16 before the products, y is rounded once,
and s1/s2 are sums of the f32 accumulator (the JAX kernel's rule), not of
the rounded y.  Any N, H, W, C and Cout.

It is a ``torch.autograd.Function``: on a CUDA tensor in f32 or bf16 its
forward launches the hand-written Hopper kernel ``csrc/conv3x3_bn_act.cu``
(an implicit GEMM on wgmma fed by TMA, f32 in three TF32 passes; its
header says what bounds it and how it is built), or raises; on a CPU
tensor it runs :func:`conv3x3_bn_act_plain`, the same arithmetic in plain
PyTorch.  :func:`plan` is the launch's shape: the kernel's tiles, the
split of K over blocks where the tiles alone cannot fill the card, and
the scratch; :func:`kernel_weight` the weights as the kernel takes them
(bf16: HWIO as it is; f32: a [Cout, 9, C] copy, split into TF32 halves).
The JAX function has no Pallas backward: its backward is the vjp of its
XLA reference at the saved inputs.  So is this one's:
autograd of :func:`conv3x3_reference` (``F.conv2d``), with all three
cotangents.

No model calls it, in the reference or here: the bottleneck's 3x3 stage
is a normalize pass, ``F.conv2d`` and two sums
(``nn/layers/fused.py::conv3x3_stage``), whose function this is.

``launches`` counts launches of the kernel (one per call on a CUDA tensor;
the statistics come out of the same launch); nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_split

launches = 0

TILE_M, TILE_N = 128, 64   # the kernel's block: output pixels, output channels
# channels of one K chunk (128 bytes of a pixel); x's channels are padded to it
CHUNK = {torch.float32: 32, torch.bfloat16: 64}
BAND = 136                 # input pixels of one TMA band: x has at least this many rows
SMS = 132                  # the H100's SMs, which split-K fills where the tiles cannot
GROUP = 32                 # pixel tiles whose column sums the kernel adds first
MAX_TILES_M = 65535        # the grid's y

_KERNEL_DTYPES = {torch.float32: "conv3x3_bn_act_f32", torch.bfloat16: "conv3x3_bn_act_bf16"}
# pointers x, w (f32: and w_lo), a, b, y, part, stats, counts, s1, s2; ints
# N, H, W, C', x rows, Cout, Cout', splits, relu_in; stream
_C_ARGS = {torch.float32: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
           torch.bfloat16: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]}
_bound = None


def plan(m: int, cout: int, k: int, dtype) -> dict:
    """The launch for M = N*H*W output pixels, Cout output channels and K =
    9C: the kernel's tiles (``TILE_M`` pixels x ``TILE_N`` channels), the
    channels padded to whole chunks, the number of K splits (1 where the
    tiles fill the card's ``SMS``, else enough to, at most one per chunk;
    split s takes chunks ``chunk_ranges[s]``, every tap of each), and the
    shapes of the scratch: the f32 partials of the splits, the column sums
    of y and y^2 of each pixel tile and then of each group of ``GROUP``
    tiles, and the int32 arrival counts (per tile when split, per group
    and channel block, then per channel block)."""
    c = k // 9
    if k != 9 * c or m <= 0 or cout <= 0 or c <= 0:
        raise ValueError(f"conv3x3_bn_act: no plan for M={m}, Cout={cout}, K={k}")
    ck = CHUNK[dtype]
    chunks = -(-c // ck)
    tiles_m, tiles_n = -(-m // TILE_M), -(-cout // TILE_N)
    groups = -(-tiles_m // GROUP)
    splits = 1 if tiles_m * tiles_n >= SMS else min(chunks, -(-SMS // (tiles_m * tiles_n)))
    return {"c_pad": chunks * ck, "cout_pad": tiles_n * TILE_N, "x_rows": max(m, BAND),
            "chunks": chunks, "tiles_m": tiles_m, "tiles_n": tiles_n, "splits": splits,
            "chunk_ranges": [(s * chunks // splits, (s + 1) * chunks // splits)
                             for s in range(splits)],
            "part": (splits, m, cout) if splits > 1 else (0,),
            "stats": (2, tiles_m + groups, cout),
            "counts": (tiles_m * tiles_n if splits > 1 else 0) + tiles_n * groups + tiles_n}


def kernel_weight(w, c_pad: int, cout_pad: int):
    """HWIO ``w`` [3, 3, C, Cout] as the kernel's B, zero past C and Cout:
    in bf16 HWIO itself, [3, 3, C', Cout'] (read as the N-major [9C',
    Cout']); in f32 [Cout', 9, C'] (the K = 9C of each output channel
    contiguous, tap-major as HWIO reads as [9C, Cout]: K-major, the only B
    that TF32 wgmma takes)."""
    if w.dtype == torch.bfloat16:
        return _pad(w, (3, 3, c_pad, cout_pad))
    c, cout = w.shape[2], w.shape[3]
    return _pad(w.permute(3, 0, 1, 2).reshape(cout, 9, c).contiguous(), (cout_pad, 9, c_pad))


def _conv(x, w):
    """Stride-1 SAME 3x3 conv of NHWC ``x`` with HWIO ``w``, NHWC out."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def conv3x3_bn_act_plain(x, w, a=None, b=None, *, relu_in: bool = True):
    """Plain PyTorch version of the kernel's function: the prologue in f32
    (f64 for f64 input), rounded back to x's dtype as the kernel rounds its
    tile, then an f32 conv whose unrounded result also gives the
    statistics; y rounded to x's dtype once."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xh = x
    if a is not None:
        xh = x.to(acc) * a.to(acc) + b.to(acc)
        if relu_in:
            xh = torch.relu(xh)
        xh = xh.to(x.dtype)
    y = _conv(xh.to(acc), w.to(acc))
    return y.to(x.dtype), y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))


def conv3x3_reference(x, w, a, b, *, has_prologue: bool, relu_in: bool):
    """Twin of the JAX ``_reference`` and the backward's source: the
    prologue in f32 rounded to x's dtype, the conv in x's dtype, and the
    statistics as f32 sums of the rounded y."""
    xh = x
    if has_prologue:
        xh = x.float() * a + b
        if relu_in:
            xh = torch.relu(xh)
        xh = xh.to(x.dtype)
    y = _conv(xh, w.to(x.dtype))
    yf = y.float()
    return y, yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


class _Conv3BnAct(torch.autograd.Function):
    """The kernel (CPU tensors: the plain version) as one differentiable
    op; saves the JAX function's residuals ``x, w, a, b``."""

    @staticmethod
    def forward(ctx, x, w, a, b, has_prologue, relu_in):
        pa, pb = (a, b) if has_prologue else (None, None)
        if x.device.type == "cpu":
            y, s1, s2 = conv3x3_bn_act_plain(x, w, pa, pb, relu_in=relu_in)
        else:
            _check(x, w, pa, pb)
            with torch.cuda.device(x.device):
                y, s1, s2 = _launch(_lib(), x, w, pa, pb, relu_in,
                                    torch.cuda.current_stream(x.device).cuda_stream)
        ctx.save_for_backward(x, w, a, b)
        ctx.has_prologue, ctx.relu_in = has_prologue, relu_in
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, a, b = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (x, w, a, b)]
            outs = conv3x3_reference(*inputs, has_prologue=ctx.has_prologue,
                                     relu_in=ctx.relu_in)
            grads = torch.autograd.grad(outs, inputs, (dy, ds1, ds2), allow_unused=True)
        return (*grads, None, None)


def conv3x3_bn_act(x, w, a=None, b=None, *, relu_in: bool = True):
    """Fused ``y = conv3x3_SAME(act(x*a + b))`` with the BN-statistics
    epilogue; returns ``(y, s1, s2)``.  ``a``/``b`` None skips the
    prologue (the JAX function then passes a = 1, b = 0)."""
    if (a is None) != (b is None):
        raise ValueError("conv3x3_bn_act: pass both a and b, or neither")
    has_prologue = a is not None
    if not has_prologue:
        c = x.shape[-1]
        a = torch.ones(c, dtype=torch.float32, device=x.device)
        b = torch.zeros(c, dtype=torch.float32, device=x.device)
    return _Conv3BnAct.apply(x, w, a, b, has_prologue, relu_in)


def _check(x, w, a, b) -> None:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"conv3x3_bn_act: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_bn_act: shapes x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not [N, H, W, C] and [3, 3, C, Cout]")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("conv3x3_bn_act: w must match x's dtype and device")
    if x.numel() == 0 or w.shape[3] == 0:
        raise ValueError("conv3x3_bn_act: empty input or output")
    c = x.shape[3]
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t is None:
            continue
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3x3_bn_act: {name} must be contiguous and 16-byte aligned")
    for name, t in (("a", a), ("b", b)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                              or t.device != x.device):
            raise ValueError(f"conv3x3_bn_act: {name} must be float32 [{c}] on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_act: unsupported device {x.device}")


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load("conv3x3_bn_act")
        for dtype, fname in _KERNEL_DTYPES.items():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _C_ARGS[dtype], ctypes.c_int
        for fname, args in (("conv3x3_bn_act_tile_m", []), ("conv3x3_bn_act_tile_n", []),
                            ("conv3x3_bn_act_chunk", [ctypes.c_int])):
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = args, ctypes.c_int
        sizes = (lib.conv3x3_bn_act_tile_m(), lib.conv3x3_bn_act_tile_n(),
                 lib.conv3x3_bn_act_chunk(1), lib.conv3x3_bn_act_chunk(0))
        if sizes != (TILE_M, TILE_N, CHUNK[torch.float32], CHUNK[torch.bfloat16]):
            raise RuntimeError(f"conv3x3_bn_act: the library's tiles {sizes} are not the plan's")
        _bound = lib
    return _bound


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pad(t, shape):
    """``t`` in the leading corner of zeros of ``shape``, or ``t`` itself
    where the shapes agree."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _launch(lib, x, w, a, b, relu_in, stream):
    """Pad, allocate the outputs and scratch of the plan, launch, check the
    launch."""
    global launches
    n, h, wd, c = x.shape
    cout = w.shape[3]
    m = n * h * wd
    p = plan(m, cout, 9 * c, x.dtype)
    if p["tiles_m"] > MAX_TILES_M:
        raise ValueError(f"conv3x3_bn_act: N*H*W={m} is past the kernel's grid")
    xk = _pad(x.reshape(m, c), (p["x_rows"], p["c_pad"]))
    wk = kernel_weight(w, p["c_pad"], p["cout_pad"])
    ws = tf32_split(wk) if x.dtype == torch.float32 else (wk,)
    ak, bk = (None, None) if a is None else (_pad(a, (p["c_pad"],)), _pad(b, (p["c_pad"],)))
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty(p["part"], dtype=torch.float32, device=x.device) if p["splits"] > 1 else None
    tile_sums = torch.empty(p["stats"], dtype=torch.float32, device=x.device)
    counts = torch.zeros(p["counts"], dtype=torch.int32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        _ptr(xk), *map(_ptr, ws), _ptr(ak), _ptr(bk), _ptr(y), _ptr(part), _ptr(tile_sums),
        _ptr(counts), _ptr(stats[0]), _ptr(stats[1]), n, h, wd, p["c_pad"], p["x_rows"], cout,
        p["cout_pad"], p["splits"], int(relu_in), stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_act: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return y, stats[0], stats[1]
