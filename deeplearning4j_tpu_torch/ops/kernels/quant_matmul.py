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

``launches`` counts kernel launches (one per call, the partial-sum
kernel and its reduce together); nothing else changes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearning4j_tpu_torch.ops.kernels import _build

launches = 0

KC = 64            # a split's K range is a multiple of this
TILE_N = {torch.float32: 128, torch.bfloat16: 64}   # columns per block of each kernel
MIN_SPLIT_K = 256  # no split takes fewer k rows than this
BLOCKS_PER_SM = 4  # the K split aims at this many blocks per SM (weight loads in flight)
# bytes a weight word takes: w_q's rows are read in such words when N and its
# address allow, else byte by byte
_W_WORD = {torch.float32: 4, torch.bfloat16: 8}

_KERNEL_DTYPES = {torch.float32: "int8_matmul_f32", torch.bfloat16: "int8_matmul_bf16"}
_C_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    """(splits, k rows per split) of K: enough splits for about
    ``BLOCKS_PER_SM`` blocks on each of the ``sms`` SMs over the
    ``ceil(N / tile_n)`` column tiles, each split at least ``MIN_SPLIT_K``
    rows and a multiple of ``KC``.  M does not enter, so a row's sum order
    does not depend on its batch."""
    want = _cdiv(BLOCKS_PER_SM * sms, _cdiv(n, tile_n))
    splits = max(1, min(want, _cdiv(k, MIN_SPLIT_K)))
    per = _cdiv(_cdiv(k, splits), KC) * KC
    return _cdiv(k, per), per


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
    """Allocate y and the partial-sum scratch, launch on a card with
    ``sms`` SMs, check the launch; returns y."""
    global launches
    m, k = x.shape
    n = w_q.shape[1]
    if _cdiv(m, 32) > 65535:
        raise ValueError(f"int8_matmul: M={m} is past the kernel's grid")
    splits, per = k_splits(k, n, sms, TILE_N[x.dtype])
    word = _W_WORD[x.dtype]
    wvec = int(n % word == 0 and w_q.data_ptr() % word == 0)
    xvec = int(k % 4 == 0 and x.data_ptr() % 8 == 0)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), part.data_ptr(),
        m, n, k, per, splits, wvec, xvec, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return y
