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
(whose header says what bounds it and how it is built), or raises; on a
CPU tensor it runs :func:`conv3x3_bn_act_plain`, the same arithmetic in
plain PyTorch.  The JAX function has no Pallas backward: its backward is
the vjp of its XLA reference at the saved inputs.  So is this one's:
autograd of :func:`conv3x3_reference` (``F.conv2d``), with all three
cotangents.

No model calls it, in the reference or here: the bottleneck's 3x3 stage
is a normalize pass, ``F.conv2d`` and two sums
(``nn/layers/fused.py::conv3x3_stage``), whose function this is.

``launches`` counts launches of the conv kernel and ``reduce_launches``
those of its statistics reduction (one each per call on a CUDA tensor);
nothing else changes them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.kernels import _build

launches = 0
reduce_launches = 0

_KERNEL_DTYPES = {torch.float32: "conv3x3_bn_act_f32", torch.bfloat16: "conv3x3_bn_act_bf16"}
# pointers x, w, a, b, y, part1, part2, s1, s2; ints N, H, W, C, Cout,
# prologue, relu_in; stream
_C_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_bound = None


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
        for fname in _KERNEL_DTYPES.values():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
        lib.conv3x3_bn_act_tile_m.argtypes, lib.conv3x3_bn_act_tile_m.restype = [], ctypes.c_int
        _bound = lib
    return _bound


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, x, w, a, b, relu_in, stream):
    """Allocate the outputs and scratch, launch, check the launch."""
    global launches, reduce_launches
    n, h, wd, c = x.shape
    cout = w.shape[3]
    m = n * h * wd
    tiles_m = -(-m // lib.conv3x3_bn_act_tile_m())
    if tiles_m > 65535:
        raise ValueError(f"conv3x3_bn_act: N*H*W={m} is past the kernel's grid")
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, tiles_m, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        _ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(y), _ptr(part[0]), _ptr(part[1]),
        _ptr(stats[0]), _ptr(stats[1]), n, h, wd, c, cout, int(a is not None), int(relu_in),
        stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_act: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    reduce_launches += 1
    return y, stats[0], stats[1]
