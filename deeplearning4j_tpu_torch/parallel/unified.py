"""The unified parallel path (port of ``deeplearning4j_tpu/parallel/
unified.py``): sequence-parallel attention over the ``seq`` axis (ring
attention, Ulysses attention and their single-device ground truth), the
MoE FFN over the ``expert`` axis, and the pipe layout's trainer glue.

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

The MoE FFN, the JAX package's: :func:`init_moe_params`,
:func:`_top_k_gates` (ties toward the lower expert, as ``lax.top_k``
breaks them: a stable descending sort), :func:`_dispatch_tensors` (ranks
in int32 under any dtype), the dense oracle :func:`moe_ffn_dense`,
:func:`shard_moe_params` (each rank's experts' rows) and :func:`moe_ffn`:
on a mesh whose ``expert`` axis is above 1 each rank routes its token
shard, the first tiled all-to-all of the exchange below takes every
shard's tokens to their experts' rank, the second brings the results
back; gradients flow through both (:class:`_AllToAll`).  Capacity comes
from the local token count, as in the JAX package.  The einsums and the
exchanges are torch ops and ``torch.distributed``'s: no TPU kernel stands
behind them.

The pipe layout's glue, the JAX package's: :func:`validate_pp_net`,
:func:`split_stages`, :func:`pp_layer_spec_tree`,
:func:`pp_param_spec_tree` and :func:`make_pp_train_step`, the step that
``Trainer(layout="pp2")`` runs (``parallel.pipeline_stages``).

``head_axis`` (heads sharded over the model axis), ``tp_jit`` and a pipe
layout with ``model > 1`` wait for the model axis (``ROADMAP.md`` queue A
item 2.5): they raise naming it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_SEQ, CollectiveStats)
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

NEG_INF = -1e30

# the ROADMAP.md item that ports the model axis
MODEL_AXIS_ITEM = "ROADMAP.md queue A item 2.5"

_STATS_LOCK = threading.Lock()
# the exchanges' counts by kind: bytes sent on the wire (per rank), bytes
# staged through the host (to it and back), host seconds (staging, posting
# and waiting)
EXCHANGE: dict[str, CollectiveStats] = {}


def reset_exchange_stats() -> dict:
    """The exchange counts so far (``"ring"``, ``"all_to_all"``, ``"pipe"``
    → ``parallel.mesh.CollectiveStats``), then zeroed."""
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

    AXES = (AXIS_SEQ, AXIS_DATA, AXIS_PIPE, AXIS_EXPERT)

    def __init__(self, mesh, axis: str):
        if axis not in self.AXES:
            raise ValueError(f"axis {axis!r}: the port's exchanges run over the "
                             f"{', '.join(map(repr, self.AXES))} axes of a parallel.make_mesh "
                             f"mesh")
        if not mesh.member:
            raise RuntimeError("this rank is parked outside the mesh")
        self.mesh = mesh
        self.n = mesh.shape[axis]
        self.index = mesh.axis_index[axis]
        self.group = mesh.axis_groups[axis]
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
            f"not ported yet; {MODEL_AXIS_ITEM} ports it")
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




# ======================================================================
# expert parallelism (expert axis): the MoE FFN with all-to-all dispatch
# ======================================================================
def _gelu(x):
    # jax.nn.gelu's default: the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_moe_params(gen, d_model: int, d_hidden: int, n_experts: int,
                    dtype=torch.float32, device=None) -> dict:
    """Gate and per-expert FFN (``w_in``, ``b_in``, ``w_out``, ``b_out``)
    parameters, drawn as the JAX package draws them (normal, scaled by
    ``1/sqrt(fan_in)``; zero biases) from ``gen``, a ``torch.Generator``
    or a seed; its numbers differ from JAX's."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=device)

    scale_in, scale_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return {
        "gate": normal((d_model, n_experts), scale_in),
        "w_in": normal((n_experts, d_model, d_hidden), scale_in),
        "b_in": torch.zeros((n_experts, d_hidden), dtype=dtype, device=device),
        "w_out": normal((n_experts, d_hidden, d_model), scale_out),
        "b_out": torch.zeros((n_experts, d_model), dtype=dtype, device=device),
    }


def _top_k_gates(logits, k: int):
    """Top-k softmax gating: (weights [N, k], indices [N, k]), the weights
    renormalised over the k chosen (GShard's convention).  Ties go to the
    lower expert index, as ``lax.top_k`` breaks them."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, top_idx = order.values[:, :k], order.indices[:, :k]
    return torch.softmax(top_vals, dim=-1), top_idx


def _dispatch_tensors(gates, top_idx, n_experts: int, capacity: int):
    """The combine [N, E, C] weights and the dispatch (0/1) tensors: a
    token's place in its expert's capacity buffer is its rank among the
    tokens routed there (cumsum order, after the slots of earlier gate
    slots); a rank at or past ``capacity`` is dropped (combine weight 0).
    The ranks are counted in int32 whatever the gates' dtype: a bf16
    cumsum stops representing ranks past 256."""
    n, k = top_idx.shape
    f = torch.nn.functional
    combine = torch.zeros((n, n_experts, capacity), dtype=gates.dtype, device=gates.device)
    claimed = torch.zeros((n_experts,), dtype=torch.int32, device=gates.device)
    for slot in range(k):
        onehot_i = f.one_hot(top_idx[:, slot].long(), n_experts).to(torch.int32)      # [N, E]
        rank = torch.cumsum(onehot_i, dim=0, dtype=torch.int32) - onehot_i + claimed[None, :]
        pos = (rank * onehot_i).sum(dim=1, dtype=torch.int32)                          # [N]
        keep = pos < capacity
        # jax.nn.one_hot gives a zero row for a position past the capacity
        cap_onehot = f.one_hot(pos.clamp(max=capacity - 1).long(), capacity).to(gates.dtype) \
            * keep[:, None].to(gates.dtype)
        onehot = onehot_i.to(gates.dtype)
        combine = combine + (gates[:, slot:slot + 1] * keep[:, None].to(gates.dtype)
                             )[:, :, None] * onehot[:, :, None] * cap_onehot[:, None, :]
        claimed = claimed + onehot_i.sum(dim=0, dtype=torch.int32)
    return combine, (combine > 0).to(gates.dtype)


def _capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(n_tokens * top_k / n_experts * capacity_factor))


def _experts(expert_in, w_in, b_in, w_out, b_out, activation):
    """Each expert's FFN over its [C, D] buffer: [E, C, D] → [E, C, D]."""
    h = activation(torch.einsum("ecd,edh->ech", expert_in, w_in) + b_in[:, None, :])
    return torch.einsum("ech,ehd->ecd", h, w_out) + b_out[:, None, :]


def moe_ffn_dense(params, x, *, top_k: int = 2, capacity_factor: float = 2.0,
                  activation=_gelu):
    """Single-device MoE forward, the oracle of the sharded path: ``x``
    [N, D] token activations → [N, D]."""
    n = x.shape[0]
    n_experts = params["gate"].shape[1]
    capacity = _capacity(n, top_k, n_experts, capacity_factor)
    gates, top_idx = _top_k_gates(x @ params["gate"], top_k)
    combine, dispatch = _dispatch_tensors(gates, top_idx, n_experts, capacity)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)                  # [E, C, D]
    out = _experts(expert_in, params["w_in"], params["b_in"], params["w_out"],
                   params["b_out"], activation)
    return torch.einsum("nec,ecd->nd", combine, out)


def shard_moe_params(params: dict, mesh, axis: str = AXIS_EXPERT) -> dict:
    """This rank's part of an MoE tree on ``mesh``: the gate whole, each
    expert-major array's rows of this rank's experts (the JAX package's
    ``P(axis)`` placement), on the rank's device."""
    ep = _Axis(mesh, axis)
    out = {}
    for name, arr in params.items():
        arr = torch.as_tensor(arr, device=mesh.device)
        if name != "gate":
            per = arr.shape[0] // ep.n
            arr = arr[ep.index * per:(ep.index + 1) * per]
        out[name] = arr.contiguous()
    return out


def moe_ffn(params, x, mesh=None, *, axis: str = AXIS_EXPERT, data_axis: Optional[str] = None,
            top_k: int = 2, capacity_factor: float = 2.0, activation=_gelu):
    """The MoE FFN.  Without a mesh, or with an ``axis`` of 1, the dense
    oracle (:func:`moe_ffn_dense`).  On a mesh each rank of the ``axis``
    group (within its data position when ``data_axis`` shards the tokens
    too) passes its token shard ``x`` [N/shards, D] and its experts
    (:func:`shard_moe_params`; the whole tree is cut here) and gets its
    shard of the output: its tokens routed, each expert's capacity
    buffers exchanged to the expert's rank and back by two tiled
    all-to-alls, capacity from the local token count.  Differentiable."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return moe_ffn_dense(params, x, top_k=top_k, capacity_factor=capacity_factor,
                             activation=activation)
    ep_axis = _Axis(mesh, axis)
    ep = ep_axis.n
    n_experts = params["gate"].shape[1]
    if n_experts % ep:
        raise ValueError(f"n_experts={n_experts} not divisible by expert-axis size {ep}")
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"data_axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
    per = n_experts // ep
    w = {name: params[name] for name in ("w_in", "b_in", "w_out", "b_out")}
    if w["w_in"].shape[0] == n_experts:
        w = {name: a[ep_axis.index * per:(ep_axis.index + 1) * per] for name, a in w.items()}
    elif w["w_in"].shape[0] != per:
        raise ValueError(f"expert arrays of {w['w_in'].shape[0]} experts: a rank holds "
                         f"{per} of {n_experts} (shard_moe_params) or all of them")
    n_local, d = x.shape
    capacity = _capacity(n_local, top_k, n_experts, capacity_factor)
    gates, top_idx = _top_k_gates(x @ params["gate"], top_k)
    combine, dispatch = _dispatch_tensors(gates, top_idx, n_experts, capacity)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)                  # [E, C, D]
    # chunk j (experts of rank j) to rank j; what comes back holds rank j's
    # tokens for this rank's experts at index j: [E/ep, ep·C, D]
    got = _AllToAll.apply(ep_axis, expert_in.reshape(ep, per, capacity, d))
    expert_in = got.permute(1, 0, 2, 3).reshape(per, ep * capacity, d)
    out = _experts(expert_in, w["w_in"], w["b_in"], w["w_out"], w["b_out"], activation)
    # rank j's tokens back to rank j; rank j's experts at rows j·E/ep
    back = _AllToAll.apply(ep_axis, out.reshape(per, ep, capacity, d).permute(1, 0, 2, 3))
    return torch.einsum("nec,ecd->nd", combine, back.reshape(n_experts, capacity, d))


# ======================================================================
# tensor parallelism (model axis)
# ======================================================================
def tp_jit(fn, params_shardings, **jit_kwargs):
    """The JAX package's tensor-parallel jit binder: the model axis is not
    ported yet (raises ``NotImplementedError``)."""
    raise NotImplementedError(f"tp_jit binds parameter shardings over the model axis, which is "
                              f"not ported yet; {MODEL_AXIS_ITEM} ports it")


# ======================================================================
# the unified trainer's pipeline path (pipe axis)
# ======================================================================
# a leaf's placement under a pipe layout without a model axis: whole on
# every rank (the JAX package's P())
REPLICATED = "replicated"


def validate_pp_net(net, layout) -> None:
    """The pipe path covers feed-forward ``MultiLayerNetwork`` s whose loss
    is the plain masked-mean score: stateless layers (no BN running
    statistics), no recurrent carries, no per-layer L1/L2 (a stage's
    backward cannot see other stages' penalties).  Anything else raises
    here, when the step is built, the JAX package's refusals."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if not isinstance(net, MultiLayerNetwork):
        raise ValueError(
            f"pipe-axis layouts support MultiLayerNetwork (got {type(net).__name__}); use "
            f"parallel.pipeline_stages directly for graph models (models/bert.py:pipeline_stages)")
    if len(net.layers) < layout.pipe:
        raise ValueError(f"{len(net.layers)} layers cannot fill {layout.pipe} pipeline stages")
    if any(isinstance(layer, BaseRecurrentLayer) for layer in net.layers):
        raise ValueError("pipe-axis layouts do not support recurrent layers (tBPTT carries "
                         "cannot ride the 1F1B ring)")
    if net.params_ is None:
        net.init()
    if any(tree_leaves(s) for s in (net.state_ or [])):
        raise ValueError("pipe-axis layouts require stateless layers (BatchNorm running stats "
                         "cannot ride the ring)")
    for i, (layer, p) in enumerate(zip(net.layers, net.params_)):
        if p and float(layer.regularization_penalty(p)) != 0.0:
            raise ValueError(f"layer {i} has L1/L2 regularization — unsupported on the pipe "
                             f"path (stage-local backward sees one stage's params)")


def split_stages(net, n_stages: int) -> list:
    """Contiguous layer groups balanced by parameter count (every group
    non-empty; the output layer lands in the last group by
    construction)."""
    counts = [max(1, sum(t.numel() for t in tree_leaves(p))) for p in net.params_]
    n_layers = len(counts)
    if n_stages > n_layers:
        raise ValueError(f"{n_layers} layers < {n_stages} stages")
    total = sum(counts)
    groups, cur, acc = [], [], 0
    remaining = n_stages
    for i, c in enumerate(counts):
        cur.append(i)
        acc += c
        layers_left = n_layers - i - 1
        stages_left = remaining - 1
        if (acc >= total / n_stages or layers_left == stages_left) \
                and stages_left > 0 and layers_left >= stages_left:
            groups.append(cur)
            cur, acc = [], 0
            remaining -= 1
    groups.append(cur)
    assert len(groups) == n_stages and all(groups)
    return groups


def pp_layer_spec_tree(params, tp: int):
    """Per-layer placement tree (matching ``net.params_``) of a pipe
    layout's parameters: every leaf :data:`REPLICATED` at ``tp == 1``.
    Sharding dim 0 over the model axis (``tp > 1``) raises naming
    ``ROADMAP.md`` queue A item 2.5."""
    if tp > 1:
        raise NotImplementedError(f"a pipe layout with model={tp} gathers each stage's params "
                                  f"over the model axis, which is not ported yet; "
                                  f"{MODEL_AXIS_ITEM} ports it")
    return tree_map(lambda _: REPLICATED, params)


def pp_param_spec_tree(params, groups, tp: int):
    """Per-stage tuple of placement trees (the per-layer trees regrouped
    by stage)."""
    specs = pp_layer_spec_tree(params, tp)
    return tuple(tuple(specs[i] for i in g) for g in groups)


# why a pipe step runs as its plain function on every call
PP_EAGER_REASON = ("pipe steps exchange activations between ranks in every tick, through the "
                   "host, and cannot be captured in a CUDA graph")


def make_pp_train_step(net, tx, layout, n_microbatches: int):
    """The pipe layout's training step, :func:`train.trainer.
    make_train_step`'s call signature — ``(params, state, opt_state,
    features, labels, features_mask, labels_mask, rng) -> (params, state,
    opt_state, loss)``, the trees updated in place — with the forward and
    backward run by ``pipeline_stages.pipeline_train_step`` over the pipe
    group: this rank's layers (:func:`split_stages`, by parameter count)
    on its microbatches, the loss on the last stage from the packed
    ``[bm, C+1]`` labels whose last column weighs each row by ``mask · M ·
    dp / count`` (so the mean over microbatches, averaged over the data
    group, is the global batch's masked mean), every stage's gradients
    on every rank, and the updater (``tx``) applied to the whole tree on
    every rank, so the params stay the same on all of them (the JAX
    package's replicated placement).  Each layer draws its dropout from
    the step's stream as the stage hands it up (``pipeline_stages``: at
    one microbatch the single-process step's masks; under a data axis the
    global batch's, as ``nn.layers.base.DataShard`` draws them).  A
    :class:`train.capture.CapturedStep` that always runs eagerly
    (:data:`PP_EAGER_REASON`)."""
    from deeplearning4j_tpu_torch.nn import preprocessors
    from deeplearning4j_tpu_torch.nn.layers.base import data_shard
    from deeplearning4j_tpu_torch.nn.multilayer import itype_before
    from deeplearning4j_tpu_torch.parallel.pipeline_stages import pipeline_train_step
    from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into

    validate_pp_net(net, layout)
    pp_layer_spec_tree(net.params_, layout.model)
    mesh = layout.mesh
    S, dp, M = layout.pipe, layout.data, n_microbatches
    groups = split_stages(net, S)
    types = net.conf.input_types()
    mini_batch = bool(getattr(net.conf, "mini_batch", True))
    shard = layout.data_shard() if dp > 1 else None
    data_group = mesh.data_group

    def run(layer_ids, stage_p, h, gen):
        x = h
        for j, i in enumerate(layer_ids):
            layer = net.layers[i]
            x = preprocessors.adapt_array(x, itype_before(net, i, types), layer)
            x, _ = layer.apply(stage_p[j], net.state_[i], x, train=True, rng=gen, mask=None)
        return x

    def make_stage_fn(si):
        return lambda stage_p, h, gen: run(groups[si], stage_p, h, gen)

    def head_loss(stage_p, h, packed_mb, gen):
        labels_mb, w_mb = packed_mb[:, :-1], packed_mb[:, -1]
        group = groups[-1]
        x = run(group[:-1], stage_p, h, gen)
        i = group[-1]
        out_layer = net.layers[i]
        x = preprocessors.adapt_array(x, itype_before(net, i, types), out_layer)
        _, _, score = out_layer.apply_and_score(stage_p[-1], net.state_[i], x, labels_mb,
                                                train=True, rng=gen, mask=None)
        return (score.reshape(-1) * w_mb.to(score.dtype)).sum()

    stage_fns = [make_stage_fn(si) for si in range(S)]

    def step(params, state, opt_state, features, labels, features_mask, labels_mask, rng):
        if features_mask is not None:
            raise ValueError("pipe-axis layouts do not support features_mask (per-timestep "
                             "masking) — use a data/model layout; labels_mask (bucket padding) "
                             "rides the packed labels")
        if labels.ndim != 2:
            raise ValueError(f"pipe-axis layouts need 2-D labels [batch, classes] (got "
                             f"{tuple(labels.shape)}) — use a data/model layout")
        b = features.shape[0]
        mask = (labels_mask.reshape(b).to(labels.dtype) if labels_mask is not None
                else torch.ones((b,), dtype=labels.dtype, device=labels.device))
        if mini_batch:
            count = mask.sum().reshape(1)
            if dp > 1:
                import torch.distributed as dist
                dist.all_reduce(count, group=data_group)
            denom = count[0].clamp_min(1.0)
        else:
            denom = 1.0
        packed = torch.cat([labels, (mask * (M * dp) / denom)[:, None]], dim=1)
        stage_params = tuple(tuple(params[i] for i in g) for g in groups)
        with data_shard(shard):
            loss, grads = pipeline_train_step(
                stage_fns, stage_params, features, packed, None, mesh, M, axis=AXIS_PIPE,
                data_axis=AXIS_DATA if dp > 1 else None, rng=rng, head_loss=head_loss)
        flat_grads = [None] * len(params)
        for g, grp in zip(grads, groups):
            for gl, i in zip(g, grp):
                flat_grads[i] = tree_map(lambda a, p: a.to(p.dtype), gl, params[i])
        with torch.no_grad():
            updates, new_opt = tx.update(flat_grads, opt_state, params)
            tree_map(lambda u, p: p.add_(u), updates, params)
            write_into(opt_state, new_opt)
        return params, state, opt_state, loss

    return CapturedStep(step, n_trees=3, name=f"pp{S}:mb{M}", eager_reason=PP_EAGER_REASON)
