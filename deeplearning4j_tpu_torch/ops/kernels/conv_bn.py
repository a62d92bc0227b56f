"""Fused 1x1-conv + BatchNorm, forward and merged backward (port of
``deeplearning4j_tpu/ops/pallas/conv_bn.py::matmul_bn_act``).

``matmul_bn_act(x, w, a, b, relu_in=...)`` computes::

    y  = act(x * a + b) @ w        x [M, K], w [K, N], a/b [K] f32 or None
    s1 = sum_m y,  s2 = sum_m y*y  [N] f32, over the M rows

with y in x's dtype, at any K and N, and is differentiable through all
three outputs (the BN-training chain feeds the batch statistics from
s1/s2).  It is a
``torch.autograd.Function``: on a CUDA tensor in f32 or bf16 its forward
launches the hand-written Hopper kernel ``csrc/matmul_bn_act.cu`` and its
backward ``csrc/matmul_bn_act_bwd.cu`` (whose headers say what bounds
them and how they are built), or raises.  On a CPU tensor the same
Function runs :func:`matmul_bn_act_plain` and
:func:`matmul_bn_act_bwd_plain`, the same arithmetic in plain PyTorch.
Where no input needs a gradient (serving) the forward runs without the
Function, which only adds host time there.
f64 (the JAX function's exact branch) is plain autograd through
:func:`matmul_bn_act_plain`.

The forward kernel and the backward kernel pair (dx, then dW;
``csrc/matmul_bn_act_bwd.cu``) run on wgmma fed by TMA, f32 as three TF32
passes.  :func:`fwd_plan` is the forward launch's shape: its tiles, the
split of K over blocks where the (M, N) tiles alone cannot fill the card,
and its scratch, all in one f32 buffer beside y (the statistics, the
column-sum tables, the split-K partials, the f32 weight's transpose and
the arrival counts).  :func:`bwd_plan` is the backward's: the tiles of
both kernels, the split of M over dW blocks where the (K, N) tiles alone
cannot fill the card, and the scratch.

``launches`` and ``bwd_launches`` count calls that launch the forward
kernel and the backward pair; nothing else changes them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from deeplearning4j_tpu_torch.ops.kernels import _build

launches = 0
bwd_launches = 0

# the forward kernel's block (rows of M, columns of N) and the columns of K
# one stage takes (128 bytes of a row of x)
TILE_M, TILE_N = 128, 128
CHUNK = {torch.float32: 32, torch.bfloat16: 64}

# the backward kernels' blocks: dx (rows of M, columns of K) and dW (rows of
# K, columns of N), and the rows of M a dW stage takes (a split's rows are
# whole stages)
DX_TILE_M, DX_TILE_K = 128, 128
DW_TILE_K, DW_TILE_N = 128, 128
SUM_COLS = 64        # columns of a dx column-sum block (two a dx tile)
M_STEP = {torch.float32: 32, torch.bfloat16: 64}
GROUP = 32           # row tiles whose column sums the kernels add first (forward, dx)
SPLIT_GROUP = 8      # splits of a tile whose partials are added first (forward, dW, int8's K)
MAX_TILES_M = 65535  # the dx kernel's grid y

_KERNEL_DTYPES = {torch.float32: "matmul_bn_act_f32", torch.bfloat16: "matmul_bn_act_bf16"}
_BWD_KERNEL_DTYPES = {torch.float32: "matmul_bn_act_bwd_f32",
                      torch.bfloat16: "matmul_bn_act_bwd_bf16"}
# pointers x, w, a, b, y, then the plan's sums, stats, part, wt and counts;
# ints n_counts, M, N, K, the row pitches of x and w, splits, blocks, rows,
# relu_in; stream
_C_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# pointers x, w, a, b, y, dy, ds1, ds2, dx, dw, da, db, part, stats, counts;
# ints M, N, K, the row pitches of x, w and y/dy, splits, relu_in; stream
_BWD_C_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_bound = None
_bwd_bound = None


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


def matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2, *, relu_in: bool = True):
    """Plain PyTorch version of the merged backward; returns
    ``(dx, dw, da, db)`` (da/db None without a prologue).  Each rounding
    is the JAX kernel's: ``dyt = dy + ds1 + 2*y*ds2`` in f32 rounded to
    dy's dtype, xhat rounded to x's dtype, dx to x's dtype, and dW summed
    in f32 and then rounded to w's dtype."""
    acc = torch.float32
    dyt = (dy.to(acc) + ds1 + 2.0 * y.to(acc) * ds2).to(dy.dtype)
    dxhat = torch.matmul(dyt.to(acc), w.to(acc).t())
    da = db = None
    if a is not None:
        xf = x.to(acc)
        pre = xf * a + b
        xh = (torch.relu(pre) if relu_in else pre).to(x.dtype)
        dpre = torch.where(pre > 0, dxhat, 0.0) if relu_in else dxhat
        dx = (dpre * a).to(x.dtype)
        da, db = (dpre * xf).sum(0), dpre.sum(0)
    else:
        xh, dx = x, dxhat.to(x.dtype)
    dw = torch.matmul(xh.to(acc).t(), dyt.to(acc)).to(w.dtype)
    return dx, dw, da, db


class _MatmulBnAct(torch.autograd.Function):
    """The kernel pair (CPU tensors: the plain pair) as one differentiable
    op; saves the JAX function's residuals ``x, w, a, b, y``."""

    @staticmethod
    def forward(ctx, x, w, a, b, relu_in):
        y, s1, s2 = _forward(x, w, a, b, relu_in)
        ctx.save_for_backward(x, w, a, b, y)
        ctx.relu_in = relu_in
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, a, b, y = ctx.saved_tensors
        dx, dw, da, db = matmul_bn_act_bwd(x, w, a, b, y, dy, ds1, ds2, relu_in=ctx.relu_in)
        return dx, dw, da, db, None


def _forward(x, w, a, b, relu_in):
    """The forward on x's device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (it raises on what the kernel does not take)."""
    if x.device.type == "cpu":
        return matmul_bn_act_plain(x, w, a, b, relu_in=relu_in)
    _check(x, w, a, b)
    index = x.device.index
    # the launch goes to the current card: switch only where x is elsewhere
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        return _launch(_lib(), x, w, a, b, relu_in, torch._C._cuda_getCurrentRawStream(index),
                       _sm_count(index))


def matmul_bn_act(x, w, a=None, b=None, *, relu_in: bool = True):
    """Fused ``y = act(x*a + b) @ w`` with the BN-statistics epilogue;
    returns ``(y, s1, s2)``.  ``a``/``b`` None skips the prologue."""
    if (a is None) != (b is None):
        raise ValueError("matmul_bn_act: pass both a and b, or neither")
    if x.dtype == torch.float64:
        return matmul_bn_act_plain(x, w, a, b, relu_in=relu_in)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            a is not None and (a.requires_grad or b.requires_grad))):
        return _MatmulBnAct.apply(x, w, a, b, relu_in)
    return _forward(x, w, a, b, relu_in)   # no gradient asked for: the same outputs


def matmul_bn_act_bwd(x, w, a, b, y, dy, ds1, ds2, *, relu_in: bool = True):
    """The merged backward, ``(dx, dw, da, db)``: the CUDA kernel for a
    CUDA tensor (it raises on what the kernel does not take), the plain
    version for a CPU tensor.  Cotangents may be strided or expanded."""
    if x.device.type == "cpu":
        return matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2, relu_in=relu_in)
    dy, ds1, ds2 = dy.contiguous(), ds1.contiguous(), ds2.contiguous()
    _check_bwd(x, w, a, b, y, dy, ds1, ds2)
    with torch.cuda.device(x.device):
        return _launch_bwd(_bwd_lib(), x, w, a, b, y, dy, ds1, ds2, relu_in,
                           torch.cuda.current_stream(x.device).cuda_stream,
                           _sm_count(x.device.index))


def _check(x, w, a, b) -> None:
    """What the kernels take (each attribute read once: this runs on every
    call's host path)."""
    dtype, dev = x.dtype, x.device
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul_bn_act: kernel takes float32 or bfloat16, got {dtype}")
    xs, ws = x.shape, w.shape
    if len(xs) != 2 or len(ws) != 2 or ws[0] != xs[1]:
        raise ValueError(f"matmul_bn_act: shapes x {tuple(xs)} and w {tuple(ws)} "
                         f"are not [M, K] and [K, N]")
    if w.dtype != dtype or w.device != dev:
        raise TypeError("matmul_bn_act: w must match x's dtype and device")
    if xs[0] == 0:
        raise ValueError("matmul_bn_act: x has no rows")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"matmul_bn_act: {name} must be contiguous and 16-byte aligned")
    k = xs[1]
    for name, t in (("a", a), ("b", b)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (k,) or t.device != dev):
            raise ValueError(f"matmul_bn_act: {name} must be float32 [{k}] on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"matmul_bn_act: unsupported device {dev}")


def _check_bwd(x, w, a, b, y, dy, ds1, ds2) -> None:
    """What the backward kernel takes, on top of the forward's checks:
    y and dy [M, N] in x's dtype, ds1/ds2 float32 [N], all on x's card,
    contiguous and 16-byte aligned."""
    m, n = x.shape[0], w.shape[-1]
    for name, t in (("y", y), ("dy", dy)):
        if t.dtype != x.dtype or tuple(t.shape) != (m, n) or t.device != x.device:
            raise ValueError(f"matmul_bn_act backward: {name} must be {x.dtype} [{m}, {n}] "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("ds1", ds1), ("ds2", ds2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"matmul_bn_act backward: {name} must be float32 [{n}] "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("y", y), ("dy", dy), ("ds1", ds1), ("ds2", ds2)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_bn_act backward: {name} must be contiguous "
                             f"and 16-byte aligned")
    _check(x, w, a, b)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``: what the splits fill."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def fwd_plan(m: int, k: int, n: int, dtype, sms: int = 132) -> dict:
    """The forward's launch for x [M, K], W [K, N] on a card with ``sms``
    SMs: the kernel's tiles (``TILE_M`` x ``TILE_N``), the ``chunks`` of
    ``CHUNK`` columns of K, the number of K splits (1 where the (M, N)
    tiles fill the SMs, else as many as one wave of blocks holds, at most
    one per chunk; split s takes chunks ``chunk_ranges[s]``), and its
    persistent ``blocks``: one a tile's split where the tiles do not fill
    the SMs; else ``rows`` blocks for each column tile (as many as the SMs
    hold), each of which keeps its column tile and walks the row tiles
    ``rows`` apart.  The scratch is one f32 buffer of ``floats`` entries
    holding, at element offsets ``at`` (each a multiple of 64), the
    sections ``shapes``: s1 and s2 (``sums``), the column sums of each of
    the ``rows`` blocks of a column tile (each row tile's where split) and
    then of each group of ``GROUP`` (``stats``), the split-K partials
    (``part``, when split), W^T with rows of K' = K rounded up to 4 (``wt``,
    f32), and the int32 arrival counts (``counts``: per tile and split
    group when split, then per group and column tile, then per column
    tile).  Cached: a call reads it, never changes it."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"matmul_bn_act: no plan for M={m}, K={k}, N={n}")
    tiles_m, tiles_n = _cdiv(m, TILE_M), _cdiv(n, TILE_N)
    chunks = _cdiv(k, CHUNK[dtype])
    tiles = tiles_m * tiles_n
    splits = 1 if tiles >= sms else min(chunks, sms // tiles)
    rows = tiles_m if tiles <= sms else min(tiles_m, max(1, sms // tiles_n))
    slices, per_tile = split_scratch(splits)
    groups = _cdiv(rows, GROUP)
    counts = (tiles * per_tile if splits > 1 else 0) + tiles_n * (groups + 1)
    shapes = {"sums": (2, n), "stats": (2, rows + groups, n),
              "part": (slices, m, n) if splits > 1 else (0,),
              "wt": (n, _cdiv(k, 4) * 4) if dtype == torch.float32 else (0,),
              "counts": (counts,)}
    at, floats = {}, 0
    for name, shape in shapes.items():
        at[name] = floats
        floats += _cdiv(math.prod(shape), 64) * 64
    return {"tiles_m": tiles_m, "tiles_n": tiles_n, "chunks": chunks, "splits": splits,
            "chunk_ranges": [(s * chunks // splits, (s + 1) * chunks // splits)
                             for s in range(splits)],
            "rows": rows, "blocks": rows * tiles_n * splits, "shapes": shapes, "at": at,
            "floats": floats}


@functools.lru_cache(maxsize=256)
def bwd_plan(m: int, k: int, n: int, dtype, sms: int = 132) -> dict:
    """The backward's launch for x [M, K], W [K, N] on a card with ``sms``
    SMs: the dx kernel's tiles (``DX_TILE_M`` rows x ``DX_TILE_K``
    columns of K, whose da/db sums run in blocks of ``SUM_COLS``
    columns) and its groups of ``GROUP`` row tiles; the dW kernel's tiles
    (``DW_TILE_K`` x ``DW_TILE_N``), its ``steps`` of ``M_STEP`` rows, and
    the number of M splits (1 where the tiles fill the SMs, else as many
    as one wave of blocks holds, at most one per step; split s takes
    steps ``step_ranges[s]``); the shapes of the scratch: dW's f32
    partials (``split_scratch``), the da/db sums of each row tile and then
    of each group, and the int32 arrival counts (dx: per group and
    column-sum block, then per column-sum block; dW: per tile when
    split).  Cached: a call reads it, never changes it."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"matmul_bn_act backward: no plan for M={m}, K={k}, N={n}")
    tiles_m, tiles_kx = _cdiv(m, DX_TILE_M), _cdiv(k, DX_TILE_K)
    groups = _cdiv(tiles_m, GROUP)
    sum_blocks = tiles_kx * DX_TILE_K // SUM_COLS
    tiles_k, tiles_n = _cdiv(k, DW_TILE_K), _cdiv(n, DW_TILE_N)
    steps = _cdiv(m, M_STEP[dtype])
    tiles = tiles_k * tiles_n
    splits = 1 if tiles >= sms else min(steps, sms // tiles)
    slices, per_tile = split_scratch(splits)
    return {"tiles_m": tiles_m, "tiles_kx": tiles_kx, "groups": groups, "tiles_k": tiles_k,
            "tiles_n": tiles_n, "steps": steps, "splits": splits,
            "step_ranges": [(s * steps // splits, (s + 1) * steps // splits)
                            for s in range(splits)],
            "part": (slices, k, n) if splits > 1 else (0,),
            "stats": (2, tiles_m + groups, k),
            "counts": sum_blocks * (groups + 1) + (tiles * per_tile if splits > 1 else 0)}


def split_scratch(splits: int, group: int = SPLIT_GROUP) -> tuple[int, int]:
    """(partial slices, arrival counts) of one output tile split ``splits``
    ways, as the kernels' split-K sum takes them: the splits' partials
    and, past one group of ``group``, each group's sum; one count, or one
    per group and one for the groups."""
    groups = _cdiv(splits, group)
    return (splits + groups, groups + 1) if groups > 1 else (splits, 1)


def row_aligned(t):
    """``t`` [rows, cols], or a copy whose rows are zero-padded to a
    multiple of 16 bytes (the TMA's row pitch) where they are not."""
    per = 16 // t.element_size()
    if t.shape[1] % per == 0:
        return t
    out = t.new_zeros((t.shape[0], _cdiv(t.shape[1], per) * per))
    out[:, :t.shape[1]] = t
    return out


def _cdiv(p: int, q: int) -> int:
    return -(-p // q)


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load("matmul_bn_act")
        for fname in _KERNEL_DTYPES.values():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
        lib.matmul_bn_act_tile.argtypes = [ctypes.c_int]
        lib.matmul_bn_act_tile.restype = ctypes.c_int
        sizes = tuple(lib.matmul_bn_act_tile(i) for i in range(4))
        if sizes != (TILE_M, TILE_N, CHUNK[torch.float32], CHUNK[torch.bfloat16]):
            raise RuntimeError(f"matmul_bn_act: the library's tiles {sizes} are not the plan's")
        _bound = lib
    return _bound


def _bwd_lib():
    global _bwd_bound
    if _bwd_bound is None:
        lib = _build.load("matmul_bn_act_bwd")
        for fname in _BWD_KERNEL_DTYPES.values():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = _BWD_C_ARGS, ctypes.c_int
        lib.matmul_bn_act_bwd_tile.argtypes = [ctypes.c_int]
        lib.matmul_bn_act_bwd_tile.restype = ctypes.c_int
        sizes = tuple(lib.matmul_bn_act_bwd_tile(i) for i in range(6))
        if sizes != (DX_TILE_M, DX_TILE_K, DW_TILE_K, DW_TILE_N, M_STEP[torch.float32],
                     M_STEP[torch.bfloat16]):
            raise RuntimeError(f"matmul_bn_act backward: the library's tiles {sizes} are not "
                               f"the plan's")
        _bwd_bound = lib
    return _bwd_bound


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, x, w, a, b, relu_in, stream, sms):
    """Allocate y and the one scratch buffer of the plan for a card with
    ``sms`` SMs, pad rows to the TMA's pitch where needed (x; bf16 W), make
    the one library call (it zeroes the counts, transposes the f32 weight and
    launches the kernel), check it; returns ``(y, s1, s2)``."""
    global launches
    m, k = x.shape
    n = w.shape[1]
    p = fwd_plan(m, k, n, x.dtype, sms)
    f32 = x.dtype == torch.float32
    xk, wk = row_aligned(x), (w if f32 else row_aligned(w))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    buf = torch.empty(p["floats"], dtype=torch.float32, device=x.device)
    base, at = buf.data_ptr(), p["at"]
    rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
        xk.data_ptr(), wk.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(), base,
        base + 4 * at["stats"], base + 4 * at["part"] if p["splits"] > 1 else None,
        base + 4 * at["wt"] if f32 else None, base + 4 * at["counts"],
        p["shapes"]["counts"][0], m, n, k, xk.shape[1], wk.shape[1], p["splits"], p["blocks"],
        p["rows"], int(relu_in), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_bn_act: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return y, buf[:n], buf[n:2 * n]


def _launch_bwd(lib, x, w, a, b, y, dy, ds1, ds2, relu_in, stream, sms):
    """Allocate dx, dW, da, db and the scratch of the plan for a card with
    ``sms`` SMs, pad rows to the TMA's pitch where needed, launch the pair,
    check the launch; returns ``(dx, dw, da, db)`` (da/db None without a)."""
    global bwd_launches
    m, k = x.shape
    n = w.shape[1]
    p = bwd_plan(m, k, n, x.dtype, sms)
    if p["tiles_m"] > MAX_TILES_M:
        raise ValueError(f"matmul_bn_act backward: M={m} is past the kernel's grid")
    dev = x.device
    xk, wk, yk, dyk = map(row_aligned, (x, w, y, dy))
    dx = torch.empty((m, k), dtype=x.dtype, device=dev)
    dw = torch.empty((k, n), dtype=w.dtype, device=dev)
    part = torch.empty(p["part"], dtype=torch.float32, device=dev) if p["splits"] > 1 else None
    counts = torch.zeros(p["counts"], dtype=torch.int32, device=dev)
    da = db = stats = None
    if a is not None:
        da = torch.empty(k, dtype=torch.float32, device=dev)
        db = torch.empty(k, dtype=torch.float32, device=dev)
        stats = torch.empty(p["stats"], dtype=torch.float32, device=dev)
    rc = getattr(lib, _BWD_KERNEL_DTYPES[x.dtype])(
        _ptr(xk), _ptr(wk), _ptr(a), _ptr(b), _ptr(yk), _ptr(dyk), _ptr(ds1), _ptr(ds2),
        _ptr(dx), _ptr(dw), _ptr(da), _ptr(db), _ptr(part), _ptr(stats), _ptr(counts),
        m, n, k, xk.shape[1], wk.shape[1], yk.shape[1], p["splits"], int(relu_in), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_bn_act backward: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    bwd_launches += 1
    return dx, dw, da, db
