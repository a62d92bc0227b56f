"""Gradient compression codec: threshold and bitmap encoding (port of
``deeplearning4j_tpu/parallel/compression.py``).

Parity with libnd4j's wire codecs (``encodeThresholdP1/P2/P3``,
``decodeThreshold``, ``encodeBitmap``, ``decodeBitmap``) and DL4J's
residual machinery (``EncodedGradientsAccumulator``,
``AdaptiveThresholdAlgorithm``).

Wire format (threshold): an int32 array ``[n_encoded, flags,
threshold_bits, idx0, idx1, ...]`` where an index's sign is the value's
sign: entry i > 0 means +threshold at position i-1, i < 0 means
-threshold at position |i|-1.  Decode applies ±threshold at those
positions; the quantization residual (g - decoded) carries forward (error
feedback).  The value form (flag 1) carries ``idx+1`` then the f32
values' bits.  Positions are those of the flat parameter vector
(``utils/pytree.py``), so a message is the same in both packages.

Two halves, each the JAX package's:

- the host codecs (numpy; the JAX package's are numpy too, and this
  module keeps its own copy) with the accumulator and the adaptive
  threshold.  The native C++ codec of the JAX package (``native/codec``)
  is not ported yet: ``use_native=True`` then runs the numpy codec, as
  the JAX package does where that library is absent;
- the device twins as torch functions, in the fixed device layout of
  ``capacity`` slots, bit for bit the JAX package's.  They run inside a
  captured step (``train/capture.py``): no host synchronization, no data-
  dependent branch.  On overflow (more hits than ``capacity``) the
  ``capacity`` largest |values| are kept, ties to the lower index, then
  sorted ascending; otherwise every hit, ascending.  One path gives both
  (:func:`_select_indices_device`): a top-k over keys that are unique
  (|value| bits above the index), non-hits below every hit, then an index
  sort with non-hits pushed past every hit.  A decode adds one message at
  a time by a gather, an add and a scatter over distinct indices
  (:func:`_add_message`): the same bits in any order, and allowed under
  ``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

FLAG_SIGN_IDX = 0      # 1-bit ±τ format (reference encodeThreshold parity)
FLAG_VALUE_SPARSE = 1  # sparse index + VALUE format (top-τ sparsification)


def _largest_by_magnitude(flat: np.ndarray, hits: np.ndarray, k: int) -> np.ndarray:
    """When a capacity cap truncates the hit list, keep the k LARGEST
    |values|: ties at the boundary go to the LOWER index, and the
    returned indices are ascending (the semantics every codec twin
    shares)."""
    order = np.lexsort((hits, -np.abs(flat[hits])))
    return np.sort(hits[order[:k]])


def threshold_encode(grad: np.ndarray, threshold: float,
                     max_elements: Optional[int] = None) -> np.ndarray:
    """Threshold encode (the three passes collapsed): the int32 message
    ``[count, 0, threshold_bits, ±(idx+1)...]``."""
    flat = np.ravel(np.asarray(grad, dtype=np.float32))
    hits = np.nonzero(np.abs(flat) >= threshold)[0]
    if max_elements is not None and hits.size > max_elements:
        hits = _largest_by_magnitude(flat, hits, max_elements)
    signs = np.where(flat[hits] >= 0, 1, -1).astype(np.int64)
    encoded = (signs * (hits + 1)).astype(np.int32)
    header = np.array([encoded.size, FLAG_SIGN_IDX,
                       np.float32(threshold).view(np.int32)], dtype=np.int32)
    return np.concatenate([header, encoded])


def threshold_encode_values(grad: np.ndarray, threshold: float,
                            max_elements: Optional[int] = None) -> np.ndarray:
    """Top-τ value sparsification: :func:`threshold_encode`'s header with
    flag 1, then the ``idx+1`` run, then the f32 values' bits.  Twice the
    bytes per entry, but the decode is exact at the sent coordinates, so
    the residual keeps only the sub-τ tail."""
    flat = np.ravel(np.asarray(grad, dtype=np.float32))
    hits = np.nonzero(np.abs(flat) >= threshold)[0]
    if max_elements is not None and hits.size > max_elements:
        hits = _largest_by_magnitude(flat, hits, max_elements)
    header = np.array([hits.size, FLAG_VALUE_SPARSE,
                       np.float32(threshold).view(np.int32)], dtype=np.int32)
    return np.concatenate([header, (hits + 1).astype(np.int32), flat[hits].view(np.int32)])


def threshold_decode(message: np.ndarray, shape: tuple,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode either wire format (by its flag) into a dense array of
    ``shape``, added into ``out`` when given (decodeThreshold's
    accumulate-into-target)."""
    message = np.asarray(message, dtype=np.int32)
    count = int(message[0])
    flag = int(message[1])
    threshold = message[2:3].view(np.float32)[0]
    if out is None:
        out = np.zeros(int(np.prod(shape)), dtype=np.float32)
    else:
        out = np.ravel(out)
    if flag == FLAG_VALUE_SPARSE:
        idx = message[3:3 + count].astype(np.int64) - 1
        vals = message[3 + count:3 + 2 * count].view(np.float32)
        np.add.at(out, idx, vals)
    else:
        body = message[3:3 + count].astype(np.int64)
        idx = np.abs(body) - 1
        np.add.at(out, idx, np.where(body > 0, threshold, -threshold).astype(np.float32))
    return out.reshape(shape)


def bitmap_encode(grad: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """Bitmap codec (``encodeBitmap``), the dense fallback when more than
    ~1/16 of the entries pass τ: 2-bit codes 0 = zero, 1 = +τ, 2 = -τ,
    four to a byte; returns (packed uint8, int64 header [n, τ bits])."""
    flat = np.ravel(np.asarray(grad, dtype=np.float32))
    codes = np.zeros(flat.size, dtype=np.uint8)
    codes[flat >= threshold] = 1
    codes[flat <= -threshold] = 2
    pad = (-codes.size) % 4
    codes_p = np.concatenate([codes, np.zeros(pad, np.uint8)])
    packed = (codes_p[0::4] | (codes_p[1::4] << 2) | (codes_p[2::4] << 4)
              | (codes_p[3::4] << 6))
    return packed, np.array([flat.size, np.float32(threshold).view(np.int32)], dtype=np.int64)


def bitmap_decode(packed: np.ndarray, header: np.ndarray,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    n = int(header[0])
    threshold = float(np.array(int(header[1]), dtype=np.int32).view(np.float32))
    codes = np.zeros(packed.size * 4, dtype=np.uint8)
    codes[0::4] = packed & 0x3
    codes[1::4] = (packed >> 2) & 0x3
    codes[2::4] = (packed >> 4) & 0x3
    codes[3::4] = (packed >> 6) & 0x3
    codes = codes[:n]
    decoded = np.zeros(n, dtype=np.float32)
    decoded[codes == 1] = threshold
    decoded[codes == 2] = -threshold
    if out is not None:
        decoded = decoded + np.ravel(out)
    return decoded


@dataclasses.dataclass
class AdaptiveThresholdAlgorithm:
    """``AdaptiveThresholdAlgorithm`` parity: steer τ so that the encoded
    fraction tracks a target sparsity."""

    initial_threshold: float = 1e-3
    target_sparsity: float = 1e-3   # fraction of elements encoded
    decay: float = 0.95
    min_threshold: float = 1e-5
    max_threshold: float = 1.0

    def __post_init__(self):
        self._threshold = self.initial_threshold

    def current(self) -> float:
        return self._threshold

    def update(self, n_encoded: int, n_total: int) -> float:
        observed = n_encoded / max(n_total, 1)
        if observed > self.target_sparsity * 1.5:
            self._threshold = min(self._threshold / self.decay, self.max_threshold)
        elif observed < self.target_sparsity / 1.5:
            self._threshold = max(self._threshold * self.decay, self.min_threshold)
        return self._threshold


class EncodedGradientsAccumulator:
    """Residual accumulator with error feedback
    (``EncodedGradientsAccumulator.java``)::

        residual += grad
        msg       = encode(residual, τ)      (τ from the threshold algorithm)
        residual -= decode(msg)              (the quantization error carried)

    ``store_update`` returns the wire message; ``apply_update`` decodes a
    peer's message into a parameter-delta buffer.  ``value_coded``
    switches to top-τ value sparsification; ``max_elements`` caps a
    message at its top-|v| entries (the device twins' ``capacity``, so
    host- and device-encoded wires are the same bits under overflow).
    ``use_native`` asks for the native C++ codec, which is not ported
    yet: the numpy codec runs, as in the JAX package without it."""

    def __init__(self, shape: tuple, algorithm: Optional[AdaptiveThresholdAlgorithm] = None,
                 use_native: bool = True, value_coded: bool = False,
                 max_elements: Optional[int] = None):
        self.shape = tuple(shape)
        self.residual = np.zeros(int(np.prod(shape)), dtype=np.float32)
        self.algorithm = algorithm or AdaptiveThresholdAlgorithm()
        self.value_coded = value_coded
        self.max_elements = max_elements

    def store_update(self, grad: np.ndarray) -> np.ndarray:
        self.residual += np.ravel(np.asarray(grad, dtype=np.float32))
        threshold = self.algorithm.current()
        encode = threshold_encode_values if self.value_coded else threshold_encode
        message = encode(self.residual, threshold, max_elements=self.max_elements)
        self.algorithm.update(int(message[0]), self.residual.size)
        decoded = threshold_decode(message, (self.residual.size,))
        self.residual -= np.ravel(decoded)
        return message

    def apply_update(self, message: np.ndarray, target: np.ndarray) -> np.ndarray:
        """Decode ``message`` and add it into ``target`` (UpdatesConsumer parity)."""
        return threshold_decode(message, self.shape, out=target)


# ---------------------------------------------------------------- device side
def _bits(x: torch.Tensor) -> torch.Tensor:
    """The int32 bits of an f32 tensor (``lax.bitcast_convert_type``)."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def _floats(x: torch.Tensor) -> torch.Tensor:
    """The f32 of int32 bits."""
    return x.to(torch.int32).contiguous().view(torch.float32)


def _select_indices_device(mask: torch.Tensor, flat: torch.Tensor, capacity: int):
    """The hit selection shared by the device encoders: ``(idx
    [capacity] int64, count int32 0-dim)``.  The first ``count`` slots are
    the ascending indices of the hits when there are at most
    ``capacity`` of them, the rest ``flat.numel()`` (the fill); on
    overflow, the ``capacity`` largest |values|, ties to the lower index,
    ascending.  One path for both cases (module docstring): the keys
    ``|v| bits << 32 | (2^32 - 1 - idx)`` of the hits (nonnegative) and
    ``-(idx + 1)`` of the rest (negative) are unique, so the top
    ``capacity`` of them is one set whatever order ``torch.topk`` takes
    them in."""
    n = flat.numel()
    total = mask.sum()
    count = torch.clamp(total, max=capacity).to(torch.int32)
    k = min(capacity, n)
    pos = torch.arange(n, device=flat.device)
    magnitude = flat.abs().contiguous().view(torch.int32).to(torch.int64)
    keys = torch.where(mask, (magnitude << 32) | (0xFFFFFFFF - pos), -(pos + 1))
    chosen = torch.topk(keys, k, sorted=False).indices
    # non-hits past every hit, then ascending
    order = torch.sort(torch.where(mask[chosen], chosen, chosen + n)).values
    if k < capacity:
        order = torch.cat([order, torch.full((capacity - k,), 2 * n, dtype=order.dtype,
                                             device=order.device)])
    slot = torch.arange(capacity, device=flat.device)
    idx = torch.where(slot < count, order, torch.full_like(order, n))
    return idx, count


def _header(count: torch.Tensor, flag: int, threshold: torch.Tensor) -> torch.Tensor:
    return torch.stack([count.to(torch.int32),
                        torch.full((), flag, dtype=torch.int32, device=count.device),
                        _bits(threshold.reshape(1))[0]])


def _as_threshold(threshold, device) -> torch.Tensor:
    """τ as an f32 0-dim tensor on ``device``: a tensor as it is (a
    captured step's device scalar), a float made there with
    ``torch.full`` (no host tensor copied)."""
    if torch.is_tensor(threshold):
        return threshold.to(torch.float32).reshape(())
    return torch.full((), float(np.float32(threshold)), dtype=torch.float32, device=device)


def threshold_encode_device(grad: torch.Tensor, threshold, capacity: int) -> torch.Tensor:
    """Device threshold encode in the fixed layout: int32 ``[3 +
    capacity]`` = ``[count, flag, τ_bits, ±(idx+1)..., 0-padding]``.  The
    host decoders take it as it is (they read ``count`` entries).  Only
    this message has to leave the device; overflow keeps the largest
    |values| (:func:`_select_indices_device`)."""
    flat = grad.reshape(-1).to(torch.float32)
    threshold = _as_threshold(threshold, flat.device)
    mask = flat.abs() >= threshold
    idx, count = _select_indices_device(mask, flat, capacity)
    slot = torch.arange(capacity, device=flat.device)
    safe = torch.clamp(idx, max=flat.numel() - 1)
    signs = torch.where(flat[safe] >= 0, 1, -1).to(torch.int32)
    body = torch.where(slot < count, signs * (safe.to(torch.int32) + 1),
                       torch.zeros((), dtype=torch.int32, device=flat.device))
    return torch.cat([_header(count, FLAG_SIGN_IDX, threshold), body])


def _add_message(ext: torch.Tensor, size: int, idx: torch.Tensor, vals: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """One message's scatter-add into ``ext`` (``size`` entries, then one
    scratch entry per slot), in place: the reference adds every slot at
    ``idx`` in slot order, ``vals`` where ``active`` and 0.0 elsewhere (at
    the clipped index, 0 for an empty slot).  The active indices are
    distinct, so each gets its one add by a gather, an add and a scatter
    that no two slots share (an inactive slot writes its own scratch
    entry): the same bits in any order, and no long run of one index for
    a sort-based scatter to walk (100k empty slots at index 0 cost a
    sort-based ``index_put_(..., accumulate=True)`` ~9 ms on an H100).  The
    reference's 0.0 adds at index 0 change only a -0.0 there: one add of
    +0.0 when an empty slot clips to 0, of -0.0 (no change) otherwise."""
    slot = torch.arange(idx.shape[0], device=ext.device)
    zero = torch.zeros((), dtype=torch.float32, device=ext.device)
    zero_at_0 = ((~active) & (idx == 0)).any()
    ext[0:1] += torch.where(zero_at_0, zero, -zero)
    target = torch.where(active, idx, size + slot)
    ext.index_put_((target,), ext[target] + torch.where(active, vals, zero))
    return ext


def _decode(size: int, capacity: int, out, device, add) -> torch.Tensor:
    """``add(ext)`` on a zeroed (or ``out``'s) flat buffer padded with one
    scratch entry per slot; returns ``out`` updated in place, or a fresh
    flat ``size`` vector."""
    if out is None:
        ext = torch.zeros((size + capacity,), dtype=torch.float32, device=device)
        return add(ext)[:size]
    flat = out.reshape(-1)
    ext = torch.cat([flat.to(torch.float32), torch.zeros((capacity,), dtype=torch.float32,
                                                         device=device)])
    return flat.copy_(add(ext)[:size])


def _sign_parts(message: torch.Tensor, size: int):
    """(clipped index, value, active) per slot of a sign-layout message."""
    message = message.to(torch.int32)
    count = message[0]
    threshold = _floats(message[2:3])[0]
    body = message[3:]
    slot = torch.arange(body.shape[0], device=message.device)
    active = (slot < count) & (body != 0)
    idx = torch.clamp(body.abs().to(torch.int64) - 1, 0, size - 1)
    return idx, torch.where(body > 0, threshold, -threshold), active


def _value_parts(message: torch.Tensor, size: int, capacity: int):
    """(clipped index, value, active) per slot of a value-layout message."""
    message = message.to(torch.int32)
    count = message[0]
    idx = torch.clamp(message[3:3 + capacity].to(torch.int64) - 1, 0, size - 1)
    vals = _floats(message[3 + capacity:3 + 2 * capacity])
    return idx, vals, torch.arange(capacity, device=message.device) < count


def threshold_decode_device(message: torch.Tensor, size: int,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode of the sign layout, added into ``out`` (in place, returned
    flat) or into zeros of ``size``."""
    parts = _sign_parts(message, size)
    return _decode(size, parts[0].shape[0], out, message.device,
                   lambda ext: _add_message(ext, size, *parts))


def threshold_encode_values_device(grad: torch.Tensor, threshold,
                                   capacity: int) -> torch.Tensor:
    """Device twin of :func:`threshold_encode_values` in the fixed layout:
    int32 ``[3 + 2*capacity]`` = ``[count, flag, τ_bits, (idx+1)... (capacity
    slots), value bits... (capacity slots)]``; :func:`compact_device_message`
    gives the host wire format after the copy to the host."""
    flat = grad.reshape(-1).to(torch.float32)
    threshold = _as_threshold(threshold, flat.device)
    mask = flat.abs() >= threshold
    idx, count = _select_indices_device(mask, flat, capacity)
    slot = torch.arange(capacity, device=flat.device)
    safe = torch.clamp(idx, max=flat.numel() - 1)
    active = slot < count
    zero = torch.zeros((), dtype=torch.int32, device=flat.device)
    idx_body = torch.where(active, safe.to(torch.int32) + 1, zero)
    val_body = torch.where(active, _bits(flat[safe]), zero)
    return torch.cat([_header(count, FLAG_VALUE_SPARSE, threshold), idx_body, val_body])


def threshold_decode_values_device(message: torch.Tensor, size: int, capacity: int,
                                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode of the fixed value layout, added into ``out`` (in place).
    Summing a rank-ordered stack one message at a time gives the same
    bits on every slice."""
    parts = _value_parts(message, size, capacity)
    return _decode(size, capacity, out, message.device,
                   lambda ext: _add_message(ext, size, *parts))


def decode_sum_device(messages: torch.Tensor, size: int, capacity: int,
                      value_coded: bool) -> torch.Tensor:
    """The sum of a stack of fixed-layout messages, decoded and added one
    at a time in stack order (global rank order: the same bits on every
    slice), into one padded buffer; returns the flat ``size`` total."""
    ext = torch.zeros((size + capacity,), dtype=torch.float32, device=messages.device)
    for message in messages:
        parts = (_value_parts(message, size, capacity) if value_coded
                 else _sign_parts(message, size))
        _add_message(ext, size, *parts)
    return ext[:size]


def compact_device_message(message: np.ndarray, capacity: int) -> np.ndarray:
    """The fixed device layout as the exact host wire format (padding
    dropped): value mode [3+2cap] → [3+2count]; sign mode [3+cap] →
    [3+count]."""
    message = np.asarray(message, dtype=np.int32)
    count = int(message[0])
    if int(message[1]) == FLAG_VALUE_SPARSE:
        return np.concatenate([message[:3], message[3:3 + count],
                               message[3 + capacity:3 + capacity + count]])
    return message[:3 + count]


def pad_to_device_layout(message: np.ndarray, capacity: int) -> np.ndarray:
    """The host wire format in the fixed device layout (for a decode on
    the device): the inverse of :func:`compact_device_message`."""
    message = np.asarray(message, dtype=np.int32)
    count = int(message[0])
    if count > capacity:
        raise ValueError(f"message count {count} exceeds capacity {capacity}")
    if int(message[1]) == FLAG_VALUE_SPARSE:
        out = np.zeros(3 + 2 * capacity, np.int32)
        out[:3] = message[:3]
        out[3:3 + count] = message[3:3 + count]
        out[3 + capacity:3 + capacity + count] = message[3 + count:3 + 2 * count]
        return out
    out = np.zeros(3 + capacity, np.int32)
    out[:3 + count] = message[:3 + count]
    return out


def bitmap_encode_device(grad: torch.Tensor, threshold) -> tuple[torch.Tensor, torch.Tensor]:
    """Device bitmap encode: ``bitmap_encode``'s 2-bit packing, with an
    int32 header ``[n, τ bits]`` (the numpy twin's is int64; they are
    compared by value)."""
    flat = grad.reshape(-1).to(torch.float32)
    threshold = _as_threshold(threshold, flat.device)
    one = torch.ones((), dtype=torch.uint8, device=flat.device)
    codes = torch.where(flat >= threshold, one,
                        torch.where(flat <= -threshold, 2 * one, 0 * one))
    pad = (-flat.numel()) % 4
    codes = torch.cat([codes, torch.zeros((pad,), dtype=torch.uint8, device=flat.device)])
    packed = codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4) | (codes[3::4] << 6)
    header = torch.stack([torch.full((), flat.numel(), dtype=torch.int32, device=flat.device),
                          _bits(threshold.reshape(1))[0]])
    return packed, header


def bitmap_decode_device(packed: torch.Tensor, header: torch.Tensor, size: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    threshold = _floats(header[1:2])[0]
    codes = torch.stack([packed & 0x3, (packed >> 2) & 0x3, (packed >> 4) & 0x3,
                         (packed >> 6) & 0x3], dim=1).reshape(-1)[:size]
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    vals = torch.where(codes == 1, threshold, torch.where(codes == 2, -threshold, zero))
    base = torch.zeros((size,), dtype=torch.float32, device=packed.device) if out is None \
        else out.reshape(-1)
    return base + vals
