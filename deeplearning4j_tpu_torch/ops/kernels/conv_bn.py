"""Fused 1x1-conv + BatchNorm forward (port of
``deeplearning4j_tpu/ops/pallas/conv_bn.py::matmul_bn_act``, forward
only).

``matmul_bn_act(x, w, a, b, relu_in=...)`` computes::

    y  = act(x * a + b) @ w        x [M, K], w [K, N], a/b [K] f32 or None
    s1 = sum_m y,  s2 = sum_m y*y  [N] f32, over the M rows

with y in x's dtype.  On a CUDA tensor in f32 or bf16 it launches the
hand-written Hopper kernel ``csrc/matmul_bn_act.cu`` (whose header says
what bounds it and how it is built), or raises.  On a CPU tensor, and
for f64 (the JAX function's exact branch), it runs
:func:`matmul_bn_act_plain`, the same arithmetic in plain PyTorch.

``launches`` counts kernel launches; nothing else changes it.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops.kernels import _build

launches = 0

_KERNEL_DTYPES = {torch.float32: "matmul_bn_act_f32", torch.bfloat16: "matmul_bn_act_bf16"}
_C_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_bound = None


def matmul_bn_act_plain(x, w, a=None, b=None, *, relu_in: bool = True):
    """Plain PyTorch version: the prologue in f32 (f64 for f64 input),
    rounded back to x's dtype as the kernel rounds its shared-memory
    tile, then an f32 product whose unrounded result also gives the
    statistics."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xh = x
    if a is not None:
        xh = x.to(acc) * a.to(acc) + b.to(acc)
        if relu_in:
            xh = torch.relu(xh)
        xh = xh.to(x.dtype)
    y = torch.matmul(xh.to(acc), w.to(acc))
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


def matmul_bn_act(x, w, a=None, b=None, *, relu_in: bool = True):
    """Fused ``y = act(x*a + b) @ w`` with the BN-statistics epilogue;
    returns ``(y, s1, s2)``.  ``a``/``b`` None skips the prologue."""
    if (a is None) != (b is None):
        raise ValueError("matmul_bn_act: pass both a and b, or neither")
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return matmul_bn_act_plain(x, w, a, b, relu_in=relu_in)
    _check(x, w, a, b)
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, w, a, b, relu_in,
                       torch.cuda.current_stream(x.device).cuda_stream)


def _check(x, w, a, b) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bn_act: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul_bn_act: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"matmul_bn_act: shapes x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not [M, K] and [K, N]")
    m, k = x.shape
    n = w.shape[1]
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("matmul_bn_act: w must match x's dtype and device")
    if k % 32 or n % 32:
        raise ValueError(f"matmul_bn_act: kernel needs K and N multiples of 32, got {k}, {n}")
    if m == 0:
        raise ValueError("matmul_bn_act: x has no rows")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t is None:
            continue
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_bn_act: {name} must be contiguous and 16-byte aligned")
    for name, t in (("a", a), ("b", b)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (k,)
                              or t.device != x.device):
            raise ValueError(f"matmul_bn_act: {name} must be float32 [{k}] on {x.device}")


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load("matmul_bn_act")
        for fname in _KERNEL_DTYPES.values():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
        lib.matmul_bn_act_tile_m.argtypes, lib.matmul_bn_act_tile_m.restype = [], ctypes.c_int
        _bound = lib
    return _bound


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, x, w, a, b, relu_in, stream):
    """Allocate the outputs and scratch, launch, check the launch."""
    global launches
    m, k = x.shape
    n = w.shape[1]
    tiles_m = -(-m // lib.matmul_bn_act_tile_m())
    if tiles_m > 65535:
        raise ValueError(f"matmul_bn_act: M={m} is past the kernel's grid")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, tiles_m, n), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        _ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(y), _ptr(part[0]), _ptr(part[1]),
        _ptr(stats[0]), _ptr(stats[1]), m, n, k, int(a is not None), int(relu_in), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_bn_act: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return y, stats[0], stats[1]
