"""Flash attention, forward and backward (port of
``deeplearning4j_tpu/ops/pallas/flash_attention.py``).

``flash_attention_block(q, k, v, scale=...)`` computes, for q
[B,H,Tq,D] and k/v [B,H,Tk,D], the UNNORMALIZED online-softmax result::

    o [B,H,Tq,D] = sum_k exp(s - m) v      (f32)
    m [B,H,Tq]   = max_k s                 (f32; NEG_INF on a dead row)
    l [B,H,Tq]   = sum_k exp(s - m)        (f32; 0 on a dead row)

with ``s = q.k * scale`` over the visible keys: key index below Tk, the
[B, Tk] ``key_mask`` above 0 (broadcast over heads), and under ``causal``
global query position ``q_offset + i`` at or after key position
``k_offset + j``.  A row that sees no key (a dead row) ends with
``o = 0, m = NEG_INF, l = 0``.  ``flash_attention_block_bwd`` is the
backward of the normalized output ``o / l`` from the saved log-sum-exp
(:func:`flash_lse`); it returns dq, dk, dv in f32, from the merged
form (``merged=True``, the reference's default) or the two-kernel form.

On a CUDA tensor in f32 or bf16, at any head dim, they launch the
hand-written Hopper kernels ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu`` (merged) and
``csrc/flash_attention_bwd_split.cu`` (two kernels), whose headers say
what bounds them and how they are built, or raise; every kernel, forward
and both backward forms, in f32 and bf16, runs on wgmma fed by TMA
(``csrc/flash_attention_sm90.cuh``), f32 in three TF32 passes a product
(:func:`tf32_three_pass_matmul` is that arithmetic in plain PyTorch).  The
merged form adds each key tile's share of dq into dq in key-tile order
(deterministic), with a few int32 flags as its only scratch
(:func:`merged_scratch_bytes`).  The kernels are templated on head dims
32, 64 and 128, and run a head dim past 128 in column slabs of the output
(128 columns in the bf16 forward and both dq kernels, 64 in the
key-tile kernels and the f32 forward), one block per slab, each
computing the scores over the whole head dim (``csrc/flash_attention.cuh``).
Any other head dim is zero-padded up to the next template, or past 128 to
the next multiple of 128 (:func:`kernel_head_dim`, :func:`pad_head_dim`),
and the outputs sliced back, which is exact: ``scale`` is passed as it
is, zero columns add nothing to ``q.k`` or ``dout.v``, and the padded
columns of the outputs are dropped.  On a CPU tensor they run
:func:`flash_attention_block_plain` and
:func:`flash_attention_block_bwd_plain`: the same function with the
scores materialized, and the same roundings (in bf16, ``p`` is rounded
to bf16 before ``p.v``, and ``p`` and ``ds`` before their products).

:func:`flash_attention` is the differentiable [B, T, H*D] attention that
``ops/attention.py`` routes long sequences to: a ``torch.autograd.Function``
over (qh, kh, vh, key_mask) that saves q, k, v, the normalized output
and the log-sum-exp (never ``p``) and whose backward is the merged
backward above.

``launches`` and ``bwd_launches`` count kernel launches of the forward
and the merged backward, ``split_launches`` those of the two-kernel
backward (two per call: its dq kernel and its dk/dv kernel); nothing else
changes them.  The ``block_q``/``block_k``
arguments are the TPU kernel's tiling knobs: they are accepted and do
not change the result; the CUDA kernels use their own tiles: in the
forward 128 query rows a block and tiles of 64 keys (bf16: 128 keys below
D = 128); in the key-tile backward kernels 64 keys a block in f32 and
128 in bf16, and query tiles of 64 rows; in the split form's dq kernel 64
query rows a block in f32 and 128 in bf16, and tiles of 64 keys.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the kernels' head-dim templates; others are zero-padded
SLAB = 128                  # past the largest template: columns per slab
TILE = 64                   # rows of a key tile, and of a query tile in the backward

launches = 0
bwd_launches = 0
split_launches = 0

_FWD = {torch.float32: "flash_attention_fwd_f32", torch.bfloat16: "flash_attention_fwd_bf16"}
_BWD = {torch.float32: "flash_attention_bwd_f32", torch.bfloat16: "flash_attention_bwd_bf16"}
_SPLIT = {torch.float32: "flash_attention_bwd_split_f32",
          torch.bfloat16: "flash_attention_bwd_split_bf16"}
# pointers q, k, v, key_mask, o, m, l, out, lse; ints bh, heads, tq, tk,
# q_offset, k_offset, causal, normalize, head dim; scale; stream
_FWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
# pointers q, k, v, key_mask, dout, lse, delta, dq, dk, dv, flags; ints bh,
# heads, tq, tk, q_offset, k_offset, causal, head dim; scale; stream
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# the same without flags
_SPLIT_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_bound = {}


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the smallest of HEAD_DIMS at
    or above it, or past the largest the next multiple of SLAB (the
    slabbed form of the largest template)."""
    for t in HEAD_DIMS:
        if d <= t:
            return t
    return -(-d // SLAB) * SLAB


def merged_scratch_bytes(b: int, h: int, tq: int, d: int) -> int:
    """Bytes of the merged backward's scratch beside dq at padded head dim
    ``d``: one int32 ticket and one int32 flag per (batch, head, column
    slab, 64-row query tile), which order the key tiles' adds into dq;
    past 64 columns, room for 64-column slabs (the bf16 kernel's)."""
    slabs = d // TILE if d > TILE else 1
    return 4 * (1 + b * h * slabs * -(-tq // TILE))


def pad_head_dim(tensors, d: int):
    """Each tensor's last (head) dim zero-padded to ``d``, contiguous."""
    return [t if t.shape[-1] == d else
            torch.nn.functional.pad(t, (0, d - t.shape[-1])).contiguous() for t in tensors]


def unpad_head_dim(tensors, d: int):
    """Each tensor's first ``d`` columns of its last dim, contiguous."""
    return [t if t.shape[-1] == d else t[..., :d].contiguous() for t in tensors]


def _visible(b, tq, tk, device, causal, key_mask, q_offset, k_offset):
    """Bool [B or 1, 1, Tq or 1, Tk]: which (query, key) pairs are seen."""
    vis = torch.ones((1, 1, 1, tk), dtype=torch.bool, device=device)
    if key_mask is not None:
        vis = vis & (key_mask > 0)[:, None, None, :]
    if causal:
        qpos = q_offset + torch.arange(tq, device=device)
        kpos = k_offset + torch.arange(tk, device=device)
        vis = vis & (qpos[:, None] >= kpos[None, :])[None, None]
    return vis


def flash_attention_block_plain(q, k, v, *, scale: float, causal: bool = False,
                                key_mask=None, q_offset: int = 0, k_offset: int = 0):
    """Plain PyTorch version of the forward: ``(o, m, l)`` in f32 from
    materialized f32 scores."""
    b, _, tq, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = _visible(b, tq, k.shape[2], q.device, causal, key_mask, q_offset, k_offset)
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(-1)
    alive = (m > NEG_INF / 2)[..., None]
    p = torch.where(vis & alive, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    pv = p if q.dtype == torch.float32 else p.to(v.dtype)
    return torch.matmul(pv.float(), v.float()), m, l


def flash_attention_block_bwd_plain(q, k, v, out, lse, dout, *, scale: float,
                                    causal: bool = False, key_mask=None,
                                    q_offset: int = 0, k_offset: int = 0):
    """Plain PyTorch version of the backward, of both forms: ``(dq, dk,
    dv)`` in f32, with ``p = exp(s - lse)`` over the visible keys of live
    rows, ``ds = p * (dO.v - delta) * scale`` and ``delta = rowsum(dO *
    out)``.  dq is one f32 sum over all keys: the two-kernel form's
    arithmetic, and the merged form's with its partials in f32."""
    b, _, tq, _ = q.shape
    f32_in = q.dtype == torch.float32
    delta = (dout.float() * out.float()).sum(-1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = _visible(b, tq, k.shape[2], q.device, causal, key_mask, q_offset, k_offset)
    alive = (lse > NEG_INF / 2)[..., None]
    p = torch.where(vis & alive, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    if not f32_in:
        p, ds = p.to(dout.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq, dk, dv


def tf32_split(x):
    """``(hi, lo)``: f32 ``x`` split as the f32 kernels split an operand
    of their three TF32 passes: ``hi`` is ``x`` rounded to TF32 (to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits
    of the f32 word zero) and ``lo = x - hi``, exact in f32."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x.float() - hi


def tf32_cut(x):
    """f32 ``x`` as a tensor core reads an f32 word as TF32: its low 13
    bits dropped (one TF32 pass reads its operands so)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_three_pass_matmul(a, b):
    """``a @ b`` the way the f32 kernels compute every product: three TF32
    passes ``a_hi b_lo + a_lo b_hi + a_hi b_hi`` (the lo terms read as
    TF32 by the tensor core), summed in f32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ tf32_cut(bl) + tf32_cut(al) @ bh + ah @ bh


def normalized_plain(q, k, v, key_mask, scale, causal):
    """The plain forward's normalized output (q's dtype) and log-sum-exp,
    as the kernel gives them in one pass."""
    o, m, l = flash_attention_block_plain(q, k, v, scale=scale, causal=causal, key_mask=key_mask)
    return (o / torch.clamp(l[..., None], min=1e-20)).to(q.dtype), flash_lse(m, l)


def flash_lse(m, l):
    """Log-sum-exp from the forward's (m, l); NEG_INF for dead rows."""
    return torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)),
                       torch.full_like(m, NEG_INF))


def flash_attention_block(q, k, v, *, scale: float, causal: bool = False, key_mask=None,
                          q_offset: int = 0, k_offset: int = 0, block_q: int = 128,
                          block_k: int = 128):
    """One flash pass, ``(o, m, l)`` as above: the CUDA kernel for a CUDA
    tensor (it raises on what the kernel does not take), the plain version
    for a CPU tensor.  ``key_mask``: optional [B, Tk] (1 = attend)."""
    if q.device.type == "cpu":
        return flash_attention_block_plain(q, k, v, scale=scale, causal=causal,
                                           key_mask=key_mask, q_offset=q_offset,
                                           k_offset=k_offset)
    return _forward(q, k, v, key_mask, scale, causal, q_offset, k_offset, normalize=False)


def flash_attention_block_bwd(q, k, v, out, lse, dout, *, scale: float, causal: bool = False,
                              key_mask=None, q_offset: int = 0, k_offset: int = 0,
                              block_q: int = 128, block_k: int = 128, merged: bool = True):
    """Backward of the normalized attention ``out`` with cotangent ``dout``
    and log-sum-exp ``lse`` [B,H,Tq]: ``(dq, dk, dv)`` in f32.  For a CUDA
    tensor the merged kernel (``merged=True``: one pass, each key tile
    adding into dq in key-tile order) or the two-kernel form
    (``merged=False``: a dq kernel over key tiles and a dk/dv kernel over
    query tiles); the plain version for a CPU tensor, whatever ``merged``
    is."""
    if q.device.type == "cpu":
        return flash_attention_block_bwd_plain(q, k, v, out, lse, dout, scale=scale,
                                               causal=causal, key_mask=key_mask,
                                               q_offset=q_offset, k_offset=k_offset)
    dout = dout.contiguous()
    _check(q, k, v, key_mask, "flash_attention backward")
    for name, t, dtype, shape in (("out", out, q.dtype, q.shape), ("dout", dout, q.dtype, q.shape),
                                  ("lse", lse, torch.float32, q.shape[:3])):
        if t.dtype != dtype or t.shape != shape or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be {dtype} "
                             f"{tuple(shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be contiguous")
    delta = (dout.float() * out.float()).sum(-1)
    d = q.shape[3]
    q, k, v, dout = pad_head_dim((q, k, v, dout), kernel_head_dim(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if merged:
            grads = _launch_bwd(_bwd_lib(), q, k, v, key_mask, dout, lse, delta, scale, causal,
                                q_offset, k_offset, stream)
        else:
            grads = _launch_bwd_split(_split_lib(), q, k, v, key_mask, dout, lse, delta, scale,
                                      causal, q_offset, k_offset, stream)
    return tuple(unpad_head_dim(grads, d))


def _forward(q, k, v, key_mask, scale, causal, q_offset, k_offset, *, normalize):
    _check(q, k, v, key_mask, "flash_attention")
    d = q.shape[3]
    q, k, v = pad_head_dim((q, k, v), kernel_head_dim(d))
    with torch.cuda.device(q.device):
        outs = _launch_fwd(_fwd_lib(), q, k, v, key_mask, scale, causal, q_offset, k_offset,
                           normalize, torch.cuda.current_stream(q.device).cuda_stream)
    # out (or o) sliced back to the head dim; lse (or m, l) have none
    return (*unpad_head_dim(outs[:1], d), *outs[1:])


class _FlashAttention(torch.autograd.Function):
    """Normalized attention of heads-layout q, k, v as one differentiable
    op (the JAX ``_mha_core`` custom_vjp); saves q, k, v, the output and
    its log-sum-exp."""

    @staticmethod
    def forward(ctx, qh, kh, vh, key_mask, scale, causal):
        if qh.device.type == "cpu":
            out, lse = normalized_plain(qh, kh, vh, key_mask, scale, causal)
        else:
            out, lse = _forward(qh, kh, vh, key_mask, scale, causal, 0, 0, normalize=True)
        ctx.save_for_backward(qh, kh, vh, key_mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_block_bwd(qh, kh, vh, out, lse, dout, scale=ctx.scale,
                                               causal=ctx.causal, key_mask=key_mask)
        return dq.to(qh.dtype), dk.to(kh.dtype), dv.to(vh.dtype), None, None, None


def flash_attention(q, k, v, *, n_heads: int, causal: bool = False, key_mask=None,
                    block_q: int = 1024, block_k: int = 1024):
    """Single-device flash attention, [B, T, H*D] -> [B, T, H*D]:
    ``softmax(q k^T / sqrt(D)) v`` with no [T, T] matrix on the card,
    differentiable through the merged backward.  ``key_mask``: optional
    [B, Tk] padding mask (1 = attend); Tk may differ from T."""
    b, t, dm = q.shape
    tk = k.shape[1]
    dh = dm // n_heads
    qh = q.reshape(b, t, n_heads, dh).transpose(1, 2).contiguous()
    kh = k.reshape(b, tk, n_heads, dh).transpose(1, 2).contiguous()
    vh = v.reshape(b, tk, n_heads, dh).transpose(1, 2).contiguous()
    if key_mask is not None:
        key_mask = torch.as_tensor(key_mask, dtype=torch.float32, device=q.device).contiguous()
    out = _FlashAttention.apply(qh, kh, vh, key_mask, 1.0 / dh ** 0.5, causal)
    return out.transpose(1, 2).reshape(b, t, dm).to(q.dtype)


def _check(q, k, v, key_mask, what: str) -> None:
    if q.dtype not in _FWD:
        raise TypeError(f"{what}: kernel takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B,H,Tq,D], [B,H,Tk,D], [B,H,Tk,D]")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"{what}: empty sequence")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{what}: {name} must match q's dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if key_mask is not None and (key_mask.dtype != torch.float32 or key_mask.device != q.device
                                 or tuple(key_mask.shape) != (q.shape[0], k.shape[2])):
        raise ValueError(f"{what}: key_mask must be float32 [{q.shape[0]}, {k.shape[2]}] "
                         f"on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")


def _lib(name: str, fnames, argtypes):
    lib = _bound.get(name)
    if lib is None:
        lib = _build.load(name)
        for fname in fnames:
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _bound[name] = lib
    return lib


def _fwd_lib():
    return _lib("flash_attention_fwd", _FWD.values(), _FWD_ARGS)


def _bwd_lib():
    return _lib("flash_attention_bwd", _BWD.values(), _BWD_ARGS)


def _split_lib():
    return _lib("flash_attention_bwd_split", _SPLIT.values(), _SPLIT_ARGS)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(lib, q, k, v, key_mask, scale, causal, q_offset, k_offset, normalize, stream):
    """Allocate the outputs, launch, check the launch.  Returns ``(out,
    lse)`` when ``normalize`` (out in q's dtype), else ``(o, m, l)``."""
    global launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev, f32 = q.device, torch.float32
    if normalize:
        o = m = l = None
        out = torch.empty_like(q)
        lse = torch.empty((b, h, tq), dtype=f32, device=dev)
    else:
        out = lse = None
        o = torch.empty((b, h, tq, d), dtype=f32, device=dev)
        m = torch.empty((b, h, tq), dtype=f32, device=dev)
        l = torch.empty((b, h, tq), dtype=f32, device=dev)
    rc = getattr(lib, _FWD[q.dtype])(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_mask), _ptr(o), _ptr(m), _ptr(l), _ptr(out),
        _ptr(lse), b * h, h, tq, tk, int(q_offset), int(k_offset), int(causal), int(normalize),
        d, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed, cudaGetLastError() = {rc}")
    launches += 1
    return (out, lse) if normalize else (o, m, l)


def _launch_bwd(lib, q, k, v, key_mask, dout, lse, delta, scale, causal, q_offset, k_offset,
                stream):
    """Allocate dq (zeros: the key tiles add into it), dk, dv and the
    zeroed flags that order the adds, launch, check the launch; returns
    ``(dq, dk, dv)`` in f32."""
    global bwd_launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev, f32 = q.device, torch.float32
    dq = torch.zeros((b, h, tq, d), dtype=f32, device=dev)
    dk = torch.empty((b, h, tk, d), dtype=f32, device=dev)
    dv = torch.empty((b, h, tk, d), dtype=f32, device=dev)
    flags = torch.zeros(merged_scratch_bytes(b, h, tq, d) // 4, dtype=torch.int32, device=dev)
    rc = getattr(lib, _BWD[q.dtype])(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_mask), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(dq), _ptr(dk), _ptr(dv), _ptr(flags), b * h, h, tq, tk, int(q_offset),
        int(k_offset), int(causal), d, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    bwd_launches += 1
    return dq, dk, dv


def _launch_bwd_split(lib, q, k, v, key_mask, dout, lse, delta, scale, causal, q_offset,
                      k_offset, stream):
    """Allocate dq, dk, dv, launch the dq and the dk/dv kernel, check the
    launches; returns ``(dq, dk, dv)`` in f32."""
    global split_launches
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dev, f32 = q.device, torch.float32
    dq = torch.empty((b, h, tq, d), dtype=f32, device=dev)
    dk = torch.empty((b, h, tk, d), dtype=f32, device=dev)
    dv = torch.empty((b, h, tk, d), dtype=f32, device=dev)
    rc = getattr(lib, _SPLIT[q.dtype])(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_mask), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(dq), _ptr(dk), _ptr(dv), b * h, h, tq, tk, int(q_offset), int(k_offset),
        int(causal), d, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention split backward: kernel launch failed, "
                           f"cudaGetLastError() = {rc}")
    split_launches += 2
    return dq, dk, dv
