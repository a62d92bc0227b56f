"""Device-feed pipeline (port of ``deeplearning4j_tpu/data/device_pipeline.py``):
shape bucketing and a feeder that moves batch N+1 to the card while step
N runs.

Bucketing pads the batch dimension of a ragged batch up to a small set
of static sizes and extends or synthesizes ``labels_mask`` so that padded
rows add zero loss and zero gradient (:func:`pad_to_bucket`);
:func:`pad_segment` does the same on the time axis for a tBPTT tail.
The mask rules are the JAX package's: an existing mask is extended with
zeros; a missing one is synthesized (ones for real examples) and, in a
bucketed stream, attached to every batch so that every batch has the
same structure.

:class:`DeviceFeeder` runs ``bucket-pad -> place_fn -> stage`` for each
batch on a background thread and keeps a bounded queue of staged
batches.  ``place_fn`` does the host-side work (numpy to tensors of the
right dtypes); staging then moves every tensor of its result to the
feeder's device:

- on a CUDA device, each tensor is copied into a page-locked host buffer
  of a ring of at least 2 slots and from there to a new device tensor
  on a side CUDA stream, and an event is recorded after the copy.  The
  consumer's stream waits on that event (no host-side synchronize), and
  each device tensor is marked as used on the consumer's stream, so its
  memory is not reused before the step that reads it is done.  A slot's
  page-locked buffers are rewritten only after the event of the copy
  that last read them has completed;
- on the CPU, each tensor is copied into a new plain tensor.

Either way a yielded batch owns its memory: what the iterator or the
producer does next never changes it.  The feeder never moves to the CPU
on its own: its device is ``"cuda"`` unless the caller says otherwise.
An iterator that raises stops the feed, and the consumer re-raises the
same exception.  A staging attempt fires the ``feeder.stage`` fault site
and is retried on the producer's thread under the feeder's
``retry_policy`` (a transient failure, such as an injected ``error``);
one that persists, or an injected ``crash``, re-raises on the consumer.
Metrics, as the JAX package's: ``tpudl_data_etl_wait_seconds`` (the
consumer's wait for each batch), ``tpudl_data_prefetch_depth`` (the
batches still ready after taking one) and a ``feed`` span per batch
(``wait_ms``, ``n_examples``, and ``padded`` on a padded batch).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.obs import tracing
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, with_retries

# the JAX package's default queue depth (its ``prefetch_size``)
DEFAULT_DEPTH = 2


# ---------------------------------------------------------------- bucketing
def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; n itself when every bucket is too small."""
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    return int(n)


def _pad_axis(a, axis: int, total: int):
    """Zero-pad ``a`` (numpy or tensor) along ``axis`` up to ``total``."""
    if a.shape[axis] >= total:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, total - a.shape[axis])
    if torch.is_tensor(a):
        flat = [w for pair in reversed(widths) for w in pair]
        return torch.nn.functional.pad(a, flat)
    return np.pad(np.asarray(a), widths)


def _pad_rows(a, total: int):
    return _pad_axis(a if torch.is_tensor(a) else np.asarray(a), 0, total)


def synth_example_mask(labels, real: int, total: int) -> np.ndarray:
    """Ones for the ``real`` leading examples, zeros for padding, shaped
    like the per-example score array (``[B]``, or ``[B, T]`` for 3D
    sequence labels)."""
    shape = (total, labels.shape[1]) if labels.ndim == 3 else (total,)
    mask = np.zeros(shape, np.float32)
    mask[:real] = 1.0
    return mask


def pad_to_bucket(batch: DataSet, bucket: int,
                  attach_mask: bool = True) -> tuple[DataSet, int]:
    """Pad ``batch`` along the example dim up to ``bucket``; returns
    ``(padded_batch, real_example_count)``.  Existing masks are
    zero-extended; with ``attach_mask`` a ``labels_mask`` is synthesized
    when absent, even at zero padding."""
    if not isinstance(batch, DataSet):
        return batch, batch.num_examples()
    n = batch.num_examples()
    total = max(int(bucket), n)
    needs_mask = attach_mask and batch.labels is not None and batch.labels_mask is None
    if total == n and not needs_mask:
        return batch, n
    labels = None if batch.labels is None else _pad_rows(batch.labels, total)
    if batch.labels_mask is not None:
        lmask = _pad_rows(batch.labels_mask, total)
    elif needs_mask:
        lmask = synth_example_mask(labels, n, total)
    else:
        lmask = None
    return DataSet(
        _pad_rows(batch.features, total), labels,
        None if batch.features_mask is None else _pad_rows(batch.features_mask, total),
        lmask), n


# ------------------------------------------------------- tBPTT tail padding
def ensure_feature_mask(batch):
    """Attach an all-ones ``[B, T]`` features_mask when absent (numpy for
    numpy features, a tensor on the features' device for a tensor)."""
    if batch.features_mask is not None:
        return batch
    f = batch.features
    if torch.is_tensor(f):
        mask = torch.ones(f.shape[:2], dtype=torch.float32, device=f.device)
    else:
        mask = np.ones(f.shape[:2], np.float32)
    return dataclasses.replace(batch, features_mask=mask)


def pad_segment(seg, length: int):
    """Pad a tBPTT segment's time axis to the static segment ``length``
    with a masked tail (zero features, zero mask)."""
    fields: dict[str, Any] = {"features": _pad_axis(seg.features, 1, length)}
    if seg.labels is not None and getattr(seg.labels, "ndim", 0) == 3:
        fields["labels"] = _pad_axis(seg.labels, 1, length)
    if seg.features_mask is not None:
        fields["features_mask"] = _pad_axis(seg.features_mask, 1, length)
    if seg.labels_mask is not None and getattr(seg.labels_mask, "ndim", 0) >= 2:
        fields["labels_mask"] = _pad_axis(seg.labels_mask, 1, length)
    return dataclasses.replace(seg, **fields)


# ------------------------------------------------------------ device feeder
def _map_tensors(fn: Callable, obj):
    """``fn`` over the tensors and numpy arrays of a staged batch (a
    tensor, an array, a DataSet or MultiDataSet, a dict, a list or tuple
    of them; None and other leaves pass through)."""
    if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def _leading_dim(obj) -> int:
    """Example count of a staged batch (a DataSet, dict or tuple of
    tensors); 0 when it cannot be told."""
    feats = getattr(obj, "features", None)
    if feats is None:
        if isinstance(obj, dict):
            feats = next(iter(obj.values()), None)
        elif isinstance(obj, (list, tuple)):
            feats = obj[0] if obj else None
        else:
            feats = obj
    if isinstance(feats, (list, tuple)):
        feats = feats[0] if feats else None
    shape = getattr(feats, "shape", None)
    return int(shape[0]) if shape else 0


@dataclasses.dataclass
class FedBatch:
    """One staged batch: tensors on the feeder's device, and the real
    (unpadded) example count."""

    batch: Any
    n_examples: int
    padded: int = 0
    bucket: Optional[int] = None


class _PinnedSlot:
    """One slot of the page-locked ring: a host buffer per tensor of a
    batch, and the event of the last copy that read them."""

    def __init__(self):
        self.buffers: list[torch.Tensor] = []
        self.copied: Optional[torch.cuda.Event] = None

    def buffer(self, i: int, src: torch.Tensor) -> torch.Tensor:
        """The slot's i-th buffer, shaped and typed like ``src``."""
        while len(self.buffers) <= i:
            self.buffers.append(torch.empty(0))
        buf = self.buffers[i]
        if buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.buffers[i] = buf
        return buf


class DeviceFeeder:
    """Overlap host work and the host-to-device copy with the device's
    work: a background thread stages each batch (bucket padding,
    ``place_fn``, the copy to ``device``) and keeps up to ``depth``
    staged batches ready."""

    _DONE = object()

    def __init__(self, place_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = DEFAULT_DEPTH,
                 bucketing: bool = True,
                 buckets: Optional[Sequence[int]] = None,
                 device: Any = DEFAULT_DEVICE,
                 retry_policy: Optional[RetryPolicy] = None):
        self.place_fn = place_fn if place_fn is not None else (lambda b: b)
        self.depth = max(1, depth)
        self.bucketing = bucketing
        self.buckets: tuple[int, ...] = tuple(sorted(int(b) for b in buckets)) if buckets else ()
        self.device = resolve_device(device)
        self.etl_wait_s = 0.0
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.02, max_delay_s=0.2)
        # the page-locked ring: a slot per staged batch that can be in the
        # queue, one for the batch being staged, at least 2
        self.slots = max(2, self.depth + 1)
        self._ring: list[_PinnedSlot] = []
        self._stream = None
        self.staged = 0
        # a producer abandoned by an earlier feed may still stage one batch
        self._lock = threading.Lock()

    def _bucket_for(self, n: int) -> int:
        bucket = choose_bucket(n, self.buckets)
        if bucket not in self.buckets:
            # the first batch (or an oversize one) defines a new static bucket
            self.buckets = tuple(sorted(self.buckets + (bucket,)))
        return bucket

    def _copy_to_device(self, placed):
        """``placed``'s tensors on the device (see the module docstring);
        returns ``(batch, event)``, the event None on the CPU."""
        def as_tensor(a):
            return a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))

        if self.device.type == "cpu":
            return _map_tensors(lambda a: as_tensor(a).to("cpu", copy=True), placed), None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.device)
                self._ring = [_PinnedSlot() for _ in range(self.slots)]
            slot = self._ring[self.staged % self.slots]
            self.staged += 1
            if slot.copied is not None:
                slot.copied.synchronize()   # the copy that last read this slot is done
            index = [0]

            def stage(a):
                a = as_tensor(a)
                if a.device == self.device:
                    return a
                if a.is_cuda:
                    return a.to(self.device, non_blocking=True)
                buf = slot.buffer(index[0], a)
                index[0] += 1
                buf.copy_(a)
                out = torch.empty(a.shape, dtype=a.dtype, device=self.device)
                out.copy_(buf, non_blocking=True)
                return out

            with torch.cuda.stream(self._stream):
                batch = _map_tensors(stage, placed)
                event = torch.cuda.Event()
                event.record(self._stream)
            slot.copied = event
        return batch, event

    def stage(self, batch):
        """Producer-side work for one batch: bucket padding, ``place_fn``
        and the copy to the device.  Returns ``(FedBatch, event)``.  The
        ``feeder.stage`` fault site fires on each attempt."""
        padded, bucket = 0, None
        n = batch.num_examples() if hasattr(batch, "num_examples") else None
        if self.bucketing and isinstance(batch, DataSet):
            bucket = self._bucket_for(n)
            batch, n = pad_to_bucket(batch, bucket)
            padded = max(bucket - n, 0)
        faults.fire("feeder.stage")
        placed, event = self._copy_to_device(self.place_fn(batch))
        if n is None:
            n = _leading_dim(placed)
        return FedBatch(placed, n, padded, bucket), event

    def _consume(self, fed: FedBatch, event) -> FedBatch:
        """Make the consumer's stream wait for the copy, and keep each
        device tensor's memory until the consumer's work on it is done."""
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)

            def mark(t):
                if t.is_cuda:
                    t.record_stream(consumer)
                return t

            _map_tensors(mark, fed.batch)
        return fed

    def feed(self, iterator: Iterable) -> Iterator[FedBatch]:
        """Iterate ``iterator`` through the background stage, yielding
        staged :class:`FedBatch` es in order."""
        self.etl_wait_s = 0.0   # fresh per epoch
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        error: list[BaseException] = []

        def producer():
            try:
                for item in iterator:
                    if stop.is_set():
                        return
                    staged = with_retries(lambda item=item: self.stage(item),
                                          policy=self.retry_policy, site="feeder.stage")
                    q.put(staged)   # blocking; the consumer drains on abandon
                    if stop.is_set():
                        return
            except BaseException as e:   # re-raised on the consumer's side
                error.append(e)
            finally:
                if not stop.is_set():
                    q.put(self._DONE)

        thread = threading.Thread(target=producer, daemon=True, name="tpudl-device-feeder")
        thread.start()
        reg = get_registry()
        wait_hist = reg.histogram("tpudl_data_etl_wait_seconds")
        depth_gauge = reg.gauge("tpudl_data_prefetch_depth")
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                wait = time.perf_counter() - t0
                if item is self._DONE:
                    if error:
                        raise error[0]
                    return
                self.etl_wait_s += wait
                wait_hist.observe(wait)
                # batches still ready after taking this one: 0 means the
                # consumer is waiting on the producer
                depth_gauge.set(q.qsize())
                fed = item[0]
                with tracing.span("feed", wait_ms=round(wait * 1e3, 3),
                                  n_examples=fed.n_examples) as sp:
                    if fed.padded:
                        sp.set_attribute("padded", fed.padded)
                yield self._consume(*item)
        finally:
            stop.set()
            _drain(q)


def _drain(q: queue.Queue) -> None:
    """Release a producer blocked in ``put`` after the consumer abandons
    the feed, without waiting for its staging work: the stop flag is set,
    so it stages at most one more item, for which emptying the queue
    makes room; then it exits on its own daemon thread."""
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            break
