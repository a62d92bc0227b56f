"""Sequence-parallel attention over the ``seq`` axis (port of the first
part of ``deeplearning4j_tpu/parallel/unified.py``): ring attention,
Ulysses attention and their single-device ground truth.

The port's convention.  The JAX package's functions take the GLOBAL
arrays ``[B, T, H*D]`` and run under ``shard_map``; the port runs one
process per mesh position (``parallel.mesh.make_mesh(data=d, seq=n)``
over a ``torch.distributed`` group), so its functions take **each rank's
shard** ``[B/d, T/n, H*D]`` (its rows for its data index, its tokens for
its seq index) and return that rank's shard of the output.  Every rank of
the mesh calls them together.  ``data_axis`` composes as the JAX
package's (dp×sp): the ring and the all-to-alls run within a data
position's seq group, so a rank's batch rows are simply its own.

- :func:`ring_attention`: K and V rotate ``n - 1`` times around the seq
  group, point to point to the next rank as ``lax.ppermute`` sends them
  (``dist.isend`` / ``dist.irecv``, never an all-gather), while each block
  merges into online-softmax carries in q's dtype (bf16 inputs carry bf16
  o, m, l, as the JAX package's scan does).  ``use_flash=True`` runs each
  block through ``ops.kernels.flash_attention.flash_attention_block`` at
  the ring's offsets (``q_offset = my_idx·T/n``, ``k_offset =
  src_idx·T/n``): the CUDA kernel on a CUDA tensor (it raises on what it
  does not take), its plain version on a CPU tensor; the exchange of the
  next block runs while the kernel computes this one.  ``use_flash=False``
  is the JAX package's ``_block_attention`` on torch ops, differentiable:
  the rotation's backward is the reverse rotation (:class:`_Rotate`).
  The flash path has no backward, as in the JAX package
  (``flash_attention_block`` has no ``custom_vjp`` there).
- :func:`ulysses_attention`: the JAX package's two tiled all-to-alls
  (tokens gathered and heads scattered, then back) around dense
  per-head-group attention on torch ops; differentiable, each all-to-all's
  backward being the same exchange of the cotangent (:class:`_AllToAll`).
- :func:`reference_attention`: ``ops.attention.multi_head_attention`` on
  the whole sequence.

The exchanges are ``torch.distributed``'s.  A gloo group moves host
tensors only, so a CUDA tensor goes through page-locked host buffers (one
copy to the host, one back to the card per block received);
:data:`EXCHANGE` counts the calls, the bytes on the wire, the bytes staged
and the host seconds of each kind (:func:`reset_exchange_stats`).

``head_axis`` (heads sharded over the model axis) waits for the model
axis (``ROADMAP.md`` queue A item 2.5); the rest of the JAX module (MoE,
``tp_jit``, the pipeline helpers) for item 2.4's remainder: their names
raise ``AttributeError``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ, CollectiveStats

NEG_INF = -1e30

# the JAX module's names that wait for a later slice
_REMAINDER = ("moe_ffn", "moe_ffn_dense", "init_moe_params", "shard_moe_params", "tp_jit",
              "validate_pp_net", "split_stages", "pp_layer_spec_tree", "pp_param_spec_tree",
              "make_pp_train_step")

_STATS_LOCK = threading.Lock()
# the exchanges' counts by kind: bytes sent on the wire (per rank), bytes
# staged through the host (to it and back), host seconds (staging, posting
# and waiting)
EXCHANGE: dict[str, CollectiveStats] = {}


def reset_exchange_stats() -> dict:
    """The exchange counts so far (``"ring"``, ``"all_to_all"`` →
    ``parallel.mesh.CollectiveStats``), then zeroed."""
    global EXCHANGE
    with _STATS_LOCK:
        out, EXCHANGE = EXCHANGE, {}
    return out


def _count(kind: str, nbytes: int, staged: int, seconds: float) -> None:
    with _STATS_LOCK:
        s = EXCHANGE.setdefault(kind, CollectiveStats())
        s.calls += 1
        s.bytes += nbytes
        s.staged_bytes += staged
        s.seconds += seconds


class _Axis:
    """One rank's view of a mesh axis: its size ``n``, its position
    ``index``, the axis's group and each position's global rank."""

    def __init__(self, mesh, axis: str):
        if axis not in (AXIS_SEQ, AXIS_DATA):
            raise ValueError(f"axis {axis!r}: the port's sequence-parallel attention runs over "
                             f"the {AXIS_SEQ!r} or {AXIS_DATA!r} axis of a parallel.make_mesh mesh")
        if not mesh.member:
            raise RuntimeError("this rank is parked outside the mesh")
        self.mesh = mesh
        self.n = mesh.shape[axis]
        self.index = mesh.seq_index if axis == AXIS_SEQ else mesh.data_index
        self.group = mesh.seq_group if axis == AXIS_SEQ else mesh.data_group
        self.ranks = [mesh.global_rank(axis, j) for j in range(self.n)]

    # -------------------------------------------------------------- host
    @staticmethod
    def _to_host(x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """``x`` as a contiguous host tensor (page-locked when it comes from
        the card), and the bytes copied."""
        if x.device.type == "cpu":
            return x.contiguous(), 0
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host, x.numel() * x.element_size()

    @staticmethod
    def _host_like(x: torch.Tensor) -> torch.Tensor:
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=x.device.type != "cpu")

    @staticmethod
    def _back(host: torch.Tensor, like: torch.Tensor) -> tuple[torch.Tensor, int]:
        if like.device.type == "cpu":
            return host, 0
        return host.to(like.device), host.numel() * host.element_size()

    # ------------------------------------------------------- exchanges
    def post_shift(self, host: torch.Tensor, step: int) -> tuple[list, torch.Tensor]:
        """Send the host tensor ``host`` ``step`` positions along the axis
        and receive the one from ``step`` positions back, without waiting:
        (the requests, the receive buffer)."""
        import torch.distributed as dist
        dst = self.ranks[(self.index + step) % self.n]
        src = self.ranks[(self.index - step) % self.n]
        recv = torch.empty(host.shape, dtype=host.dtype, pin_memory=host.is_pinned())
        reqs = [dist.isend(host, dst, group=self.group), dist.irecv(recv, src, group=self.group)]
        return reqs, recv

    def shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """``x`` from ``step`` positions back along the axis, ours sent as
        many positions on (``lax.ppermute`` with ``i → i + step``)."""
        t0 = time.perf_counter()
        host, staged = self._to_host(x)
        reqs, recv = self.post_shift(host, step)
        for r in reqs:
            r.wait()
        out, back = self._back(recv, x)
        _count("ring", host.numel() * host.element_size(), staged + back,
               time.perf_counter() - t0)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [n, ...]: chunk ``j`` goes to position ``j``; returns the
        chunks received, position ``j``'s at index ``j``."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        host, staged = self._to_host(x)
        recv = self._host_like(x)
        dist.all_to_all_single(recv, host, group=self.group)
        out, back = self._back(recv, x)
        sent = host.numel() * host.element_size() * (self.n - 1) // self.n
        _count("all_to_all", sent, staged + back, time.perf_counter() - t0)
        return out


class _Rotate(torch.autograd.Function):
    """One ring rotation (send to the next position, receive from the
    previous) whose backward is the reverse rotation of the cotangent."""

    @staticmethod
    def forward(ctx, axis, kv):
        ctx.axis = axis
        return axis.shift(kv, 1)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.axis.shift(grad.contiguous(), -1)


class _AllToAll(torch.autograd.Function):
    """A tiled all-to-all of ``[n, ...]`` chunks; its backward is the same
    exchange of the cotangent (chunk ``j`` of a rank's cotangent belongs to
    position ``j``)."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return axis.all_to_all(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.axis.all_to_all(grad.contiguous())


def _block_attention(q, k, v, scale, mask):
    """Scores for one (q-block, kv-block) pair: q [B,H,Tq,D], k/v
    [B,H,Tk,D], ``mask`` [Tq,Tk] (True: visible) or None.  Returns the
    unnormalised out, the row max and the row sum of exponentials, in q's
    dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1)                                    # [B,H,Tq]
    p = torch.exp(scores - m[..., None])
    if mask is not None:
        # rows with no visible key: exp(NEG_INF - NEG_INF) = 1, zero them
        any_visible = mask.any(-1)                         # [Tq]
        p = p * any_visible[None, None, :, None].to(p.dtype)
        m = torch.where(any_visible[None, None, :], m, NEG_INF)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m, l


def _heads(x, n_heads: int):
    b, t, dm = x.shape
    return x.reshape(b, t, n_heads, dm // n_heads).transpose(1, 2).contiguous()


def ring_attention(q, k, v, mesh, axis: str = AXIS_SEQ, n_heads: int = 1,
                   causal: bool = False, data_axis: Optional[str] = None,
                   head_axis: Optional[str] = None, use_flash: bool = False,
                   flash_block: int = 128):
    """Multi-head ring attention on this rank's shard (module docstring):
    q/k/v [B/d, T/n, H*D] for this rank's data and ``axis`` positions of
    ``mesh`` (a ``parallel.make_mesh`` mesh); returns this rank's
    [B/d, T/n, H*D] of the output.  K/V make ``n - 1`` hops around the
    ring; online-softmax carries merge the blocks exactly.  ``n_heads`` is
    the head count; ``head_axis`` needs the model axis (raises
    ``NotImplementedError``); ``flash_block`` is the TPU kernel's tile
    knob, which the CUDA kernel does not need."""
    if head_axis:
        raise NotImplementedError(
            f"ring_attention(head_axis={head_axis!r}) shards heads over the model axis, which is "
            f"not ported yet; ROADMAP.md queue A item 2.5 ports it")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"data_axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
    ring = _Axis(mesh, axis)
    n = ring.n
    b, t_local, dmodel = q.shape
    dh = dmodel // n_heads
    scale = 1.0 / math.sqrt(dh)
    qh, kh, vh = (_heads(x, n_heads) for x in (q, k, v))
    o = torch.zeros_like(qh)
    m = torch.full(qh.shape[:-1], NEG_INF, dtype=qh.dtype, device=qh.device)
    l = torch.zeros(qh.shape[:-1], dtype=qh.dtype, device=qh.device)
    if use_flash:
        o, m, l = _flash_ring(qh, kh, vh, o, m, l, ring, scale, causal, t_local)
    else:
        kv = torch.stack([kh, vh])
        q_pos = ring.index * t_local + torch.arange(t_local, device=q.device)
        for s in range(n):
            src = (ring.index - s) % n
            mask = None
            if causal:
                k_pos = src * t_local + torch.arange(t_local, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]
            o_b, m_b, l_b = _block_attention(qh, kv[0], kv[1], scale, mask)
            o, m, l = _merge(o, m, l, o_b, m_b, l_b)
            if s < n - 1:
                kv = _Rotate.apply(ring, kv)
    out = o / torch.clamp(l[..., None], min=1e-20)
    return out.transpose(1, 2).reshape(b, t_local, dmodel)


def _merge(o, m, l, o_b, m_b, l_b):
    """The online-softmax merge of a block's (o, m, l) into the carries."""
    m_new = torch.maximum(m, m_b)
    c_old = torch.exp(m - m_new)
    c_blk = torch.exp(m_b - m_new)
    return o * c_old[..., None] + o_b * c_blk[..., None], m_new, l * c_old + l_b * c_blk


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel's operands)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_ring(qh, kh, vh, o, m, l, ring, scale, causal, t_local):
    """The ring over ``flash_attention_block``: each hop's exchange posted
    before the block's kernel, waited for after it (no autograd)."""
    from deeplearning4j_tpu_torch.ops.kernels.flash_attention import flash_attention_block
    n = ring.n
    with torch.no_grad():
        kv = torch.stack([kh, vh])
        t0 = time.perf_counter()
        host, staged = ring._to_host(kv) if n > 1 else (None, 0)
        seconds = time.perf_counter() - t0
        for s in range(n):
            src = (ring.index - s) % n
            reqs = recv = None
            if s < n - 1:
                t0 = time.perf_counter()
                reqs, recv = ring.post_shift(host, 1)
                seconds += time.perf_counter() - t0
            o_b, m_b, l_b = flash_attention_block(
                qh, _aligned(kv[0]), _aligned(kv[1]), scale=scale, causal=causal,
                q_offset=ring.index * t_local, k_offset=src * t_local)
            # the kernel accumulates in f32; the carries keep q's dtype
            o, m, l = _merge(o, m, l, o_b.to(o.dtype), m_b.to(m.dtype), l_b.to(l.dtype))
            if reqs is not None:
                t0 = time.perf_counter()
                for r in reqs:
                    r.wait()
                kv, back = ring._back(recv, kv)
                _count("ring", host.numel() * host.element_size(), staged + back,
                       seconds + time.perf_counter() - t0)
                host, staged, seconds = recv, 0, 0.0
    return o, m, l


def reference_attention(q, k, v, n_heads: int, causal: bool = False):
    """Single-device ground truth for the sequence-parallel functions:
    ``ops.attention.multi_head_attention`` on whole sequences."""
    from deeplearning4j_tpu_torch.ops.attention import multi_head_attention
    return multi_head_attention(q, k, v, n_heads=n_heads, causal=causal)


def ulysses_attention(q, k, v, mesh, axis: str = AXIS_SEQ, n_heads: int = 1,
                      causal: bool = False, data_axis: Optional[str] = None):
    """DeepSpeed-Ulysses sequence parallelism on this rank's shard: q/k/v
    [B/d, T/n, H*D] as :func:`ring_attention` takes them.  The first
    all-to-all re-shards from tokens to heads (each rank receives every
    token of H/n heads), attention runs dense per head group (torch ops,
    the JAX package's einsums), and the inverse all-to-all restores the
    token shard.  Needs ``n_heads % n == 0``; differentiable."""
    ring = _Axis(mesh, axis)
    n = ring.n
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} must be divisible by the '{axis}' axis size {n} "
                         f"for Ulysses SP")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"data_axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
    b, t_local, dmodel = q.shape
    dh = dmodel // n_heads
    hn = n_heads // n

    def scatter_heads(x):
        # [n, B, T/n, H/n, dh]: head group j to position j
        chunks = x.reshape(b, t_local, n, hn, dh).permute(2, 0, 1, 3, 4)
        got = _AllToAll.apply(ring, chunks)               # position j's tokens at j
        return got.permute(1, 3, 0, 2, 4).reshape(b, hn, n * t_local, dh)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        t = scores.shape[-1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), vh)   # [B, H/n, T, dh]
    # inverse: position i's tokens back to i, the head groups gathered
    chunks = out.reshape(b, hn, n, t_local, dh).permute(2, 0, 3, 1, 4)      # [n, B, T/n, H/n, dh]
    got = _AllToAll.apply(ring, chunks)                    # head group j at index j
    return got.permute(1, 2, 0, 3, 4).reshape(b, t_local, dmodel)


def __getattr__(name):
    if name in _REMAINDER:
        raise AttributeError(
            f"deeplearning4j_tpu_torch.parallel.unified.{name} is not ported yet (the JAX "
            f"package's parallel/unified.py: MoE, tp_jit and the pipeline helpers); ROADMAP.md "
            f"queue A item 2.4's remainder ports it")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
