"""Attention ops (port of ``deeplearning4j_tpu/ops/attention.py``).

``multi_head_attention`` takes pre-projected q/k/v of shape [B, T, H*Dh].
Below ``FLASH_AUTO_SEQ_LEN`` it runs one einsum chain that materializes
the [T, T] scores (masked with ``NEG_INF = -1e9``, so a row whose keys
are all masked comes out uniform); from there on, or with
``use_flash=True``, it runs :func:`flash_attention`, whose kernels never
hold the [T, T] matrix on the card (a fully masked row comes out 0).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.kernels.flash_attention import flash_attention

NEG_INF = -1e9

# sequences at or above this length take the flash kernels when
# ``use_flash`` is None, as in the JAX package
FLASH_AUTO_SEQ_LEN = 1024


def _auto_flash(q, k) -> bool:
    """Default routing for ``use_flash=None``: long sequences in a
    kernel-supported dtype.  An explicit True/False always wins."""
    return (max(q.shape[1], k.shape[1]) >= FLASH_AUTO_SEQ_LEN
            and q.dtype in (torch.float32, torch.bfloat16))


def dot_product_attention(q, k, v, mask=None, scaled: bool = True):
    """Single-head attention.  q [B,Tq,D], k/v [B,Tk,D], mask [B,Tk] or
    [B,Tq,Tk] (1 = attend)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scaled else 1.0
    scores = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, :]
        scores = torch.where(mask > 0, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", weights, v)


def multi_head_attention(q, k, v, n_heads: int, mask=None, kv_mask=None,
                         causal: bool = False, use_flash: Optional[bool] = None,
                         flash_block: int = 0):
    """Multi-head attention on [B,T,H*Dh] q/k/v.  ``mask``: [B,T] padding
    mask on the keys that also zeroes masked query rows; ``kv_mask`` masks
    keys only (cross attention).  ``causal`` adds the autoregressive mask.
    ``use_flash``: None routes by :func:`_auto_flash`; ``flash_block`` is
    the TPU kernel's tile knob and does not change the result."""
    b, tq, d = q.shape
    if use_flash is None:
        use_flash = _auto_flash(q, k)
    if use_flash:
        key_mask = mask if mask is not None else kv_mask
        out = flash_attention(q, k, v, n_heads=n_heads, causal=causal, key_mask=key_mask,
                              block_q=flash_block or 1024, block_k=flash_block or 1024)
        if mask is not None and tq == k.shape[1]:
            out = out * mask[:, :, None].to(out.dtype)
        return out
    tk = k.shape[1]
    dh = d // n_heads
    qh = q.reshape(b, tq, n_heads, dh).transpose(1, 2)
    kh = k.reshape(b, tk, n_heads, dh).transpose(1, 2)
    vh = v.reshape(b, tk, n_heads, dh).transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(dh)
    key_mask = mask if mask is not None else kv_mask
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :] > 0, scores, NEG_INF)
    if causal:
        cm = torch.tril(torch.ones((tq, tk), dtype=torch.bool, device=q.device))
        scores = torch.where(cm[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vh)
    out = out.transpose(1, 2).reshape(b, tq, d)
    if mask is not None and tq == tk:
        out = out * mask[:, :, None]
    return out
