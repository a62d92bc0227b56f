"""int8-weight dequant-matmul (port of
``deeplearning4j_tpu/ops/pallas/quant_matmul.py``), the serving matmul
of a post-training-quantized net (``nn/quantize.py``).

``int8_matmul(x, w_q, scale)`` computes::

    y = (x @ w_q) * scale          x [M, K] f32/bf16, w_q [K, N] int8,
                                   scale [N] f32 -> y [M, N] in x's dtype

with the sum in f32.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/int8_matmul.cu`` (whose header says what bounds it
and how it is built), or raises.  On a CPU tensor, and for f64, it runs
:func:`int8_matmul_plain`, the semantics of the JAX package's
``int8_matmul_reference``.  Inference only: there is no backward, as in
the JAX package.

The kernel runs on wgmma fed by TMA (f32 as three TF32 passes, x in three
parts against the exact int8 weight) and sums its K splits in the same
launch.
``launches`` counts its launches (one per call); nothing else changes
it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.ops.kernels.conv_bn import row_aligned, split_scratch

launches = 0

KC = 128           # a split's K range is a multiple of this
TILE_N = {torch.float32: 128, torch.bfloat16: 128}   # weight columns per block
MIN_SPLIT_K = 256  # no split takes fewer k rows than this
BLOCKS_PER_SM = 1  # the K split aims at one wave: this many blocks per SM at most

_KERNEL_DTYPES = {torch.float32: "int8_matmul_f32", torch.bfloat16: "int8_matmul_bf16"}
# pointers x, w_q, scale, y, part, counts; ints M, N, K, the row pitches of x
# and w_q, k rows per split, splits; stream
_C_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_bound = None


def int8_matmul_plain(x, w_q, scale):
    """Plain PyTorch version: widen x and w_q to f32, multiply in f32,
    scale per column, cast to x's dtype."""
    y = torch.matmul(x.to(torch.float32), w_q.to(torch.float32))
    return (y * scale.to(torch.float32)).to(x.dtype)


def int8_matmul(x, w_q, scale):
    """``(x @ w_q) * scale`` with the dequantization fused into the
    product: the CUDA kernel for a CUDA tensor in f32 or bf16 (it raises
    on what the kernel does not take), the plain version for a CPU tensor
    or f64."""
    _check_operands(x, w_q, scale)
    if x.device.type == "cpu" or x.dtype == torch.float64:
        return int8_matmul_plain(x, w_q, scale)
    _check_kernel(x, w_q, scale)
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, w_q, scale, torch.cuda.current_stream(x.device).cuda_stream,
                       _sm_count(x.device.index))


def _check_operands(x, w_q, scale) -> None:
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: w_q must be int8, got {w_q.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)} and w_q {tuple(w_q.shape)} "
                         f"are not [M, K] and [K, N]")
    n = w_q.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"int8_matmul: scale must be float32 [{n}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def _check_kernel(x, w_q, scale) -> None:
    """What the kernel takes on top of the operands' contract: f32 or bf16
    x, all three on x's card, contiguous, at least one row."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"int8_matmul: kernel takes float32 or bfloat16 x, got {x.dtype}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if x.shape[0] == 0:
        raise ValueError("int8_matmul: x has no rows")
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``: what the K split fills."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_splits(k: int, n: int, sms: int, tile_n: int) -> tuple[int, int]:
    """(splits, k rows per split) of K: as many splits as the ``sms`` SMs
    hold at ``BLOCKS_PER_SM`` blocks each over the ``ceil(N / tile_n)``
    column tiles (one wave, each block streaming a long K range), each
    split at least ``MIN_SPLIT_K`` rows and a multiple of ``KC``.  M does
    not enter, so a row's sum order does not depend on its batch."""
    want = max(1, BLOCKS_PER_SM * sms // _cdiv(n, tile_n))
    splits = max(1, min(want, _cdiv(k, MIN_SPLIT_K)))
    per = _cdiv(_cdiv(k, splits), KC) * KC
    return _cdiv(k, per), per


def tma_weight(w_q):
    """``(w, ldw)``: w_q as the kernel's TMA takes it, rows of ``ldw``
    bytes (a multiple of 16) from a 16-byte-aligned address: w_q itself
    where it is so, else a copy with rows zero-padded to 16 bytes (VGG-16's
    fc8, N = 1000).  The copy is made once and kept on w_q: a quantized
    net's weights are made once and read at every call (a change to w_q in
    place makes a new copy).  While a CUDA graph is being captured the copy
    is made in the graph instead, so that every replay copies what w_q
    holds then: a captured step takes another net's weights into the same
    buffers (``train/capture.py``)."""
    if w_q.shape[1] % 16 == 0 and w_q.data_ptr() % 16 == 0:
        return w_q, w_q.shape[1]
    if _capturing(w_q):
        aligned = row_aligned(w_q.clone())
        return aligned, aligned.shape[1]
    held = getattr(w_q, "_tma_rows", None)
    if held is None or held[0] != w_q._version:
        held = (w_q._version, row_aligned(w_q.clone()))   # a fresh, aligned allocation
        w_q._tma_rows = held
    return held[1], held[1].shape[1]


def _capturing(t) -> bool:
    """Whether work on ``t``'s device is being captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def tile_m(m: int) -> int:
    """Rows of x a block takes (wgmma's N): the smallest of 8, 16 and 32
    that holds min(M, 32)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


def _cdiv(p: int, q: int) -> int:
    return -(-p // q)


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load("int8_matmul")
        for fname in _KERNEL_DTYPES.values():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
        lib.int8_matmul_kc.argtypes, lib.int8_matmul_kc.restype = [], ctypes.c_int
        lib.int8_matmul_tile_n.argtypes = [ctypes.c_int]
        lib.int8_matmul_tile_n.restype = ctypes.c_int
        built = (lib.int8_matmul_kc(), lib.int8_matmul_tile_n(0), lib.int8_matmul_tile_n(1))
        if built != (KC, TILE_N[torch.float32], TILE_N[torch.bfloat16]):
            raise RuntimeError(f"int8_matmul: the built kernel's (KC, tiles) {built} differ "
                               f"from the wrapper's")
        _bound = lib
    return _bound


def _launch(lib, x, w_q, scale, stream, sms):
    """Allocate y and the split-K scratch, pad x's rows to the TMA's pitch
    where needed, launch on a card with ``sms`` SMs, check the launch;
    returns y."""
    global launches
    m, k = x.shape
    n = w_q.shape[1]
    if _cdiv(m, 32) > 65535:
        raise ValueError(f"int8_matmul: M={m} is past the kernel's grid")
    splits, per = k_splits(k, n, sms, TILE_N[x.dtype])
    xk = row_aligned(x)
    if xk.data_ptr() % 16:
        xk = xk.clone()
    wk, ldw = tma_weight(w_q)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = counts = None
    if splits > 1:
        slices, per_tile = split_scratch(splits)
        # the f32 kernel keeps its sums in f64 past its tiles
        part = torch.empty((slices, m, n), device=x.device,
                           dtype=torch.float64 if x.dtype == torch.float32 else torch.float32)
        counts = torch.zeros(_cdiv(m, tile_m(m)) * _cdiv(n, TILE_N[x.dtype]) * per_tile,
                             dtype=torch.int32, device=x.device)
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        xk.data_ptr(), wk.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), None if counts is None else counts.data_ptr(),
        m, n, k, xk.shape[1], ldw, per, splits, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return y
