"""Dynamic micro-batching inference engine (port of
``deeplearning4j_tpu/serve/engine.py``).

Callers submit ``[n, ...]`` requests from any thread; one worker thread
forms batches and runs the model's forward on its device under
``torch.inference_mode()``:

1. **Deadline-bounded micro-batching**: a batch flushes when
   ``max_batch`` rows are queued (size flush) or ``max_latency_ms`` after
   its oldest request (deadline flush).
2. **Buckets**: ragged batches pad up to a fixed set of sizes (powers of
   two up to ``max_batch``); a request larger than every
   bucket defines a new, sticky one.  Padded rows are sliced off before
   results go back, so a batched answer equals the per-request one
   (inference is row-independent: no dropout, BN uses running stats).
3. **Backpressure**: the queue is bounded; a submit against a full queue
   fails at once with :class:`Overloaded`, and a request may carry a
   deadline after which it is failed instead of dispatched.

Rows are copied into a persistent host staging buffer per request
signature (:class:`_BatchStage`) as requests are admitted, so staging
overlaps the batching window.  The forward is a captured step
(``train/capture.py``: a CUDA graph per bucket on the card, after two
eager calls) cached process-wide under the model's
``step_cache.net_signature`` plus ``"serve_forward"``, so engines of one
configuration share it, as in the JAX package; unlike the JAX package's
engine the port captures the ``ComputationGraph`` family too, since both
families' forward is a function of ``(params, state, x, mask)``.  The JAX
engine's observability and fault hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import resolve_device
from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train.capture import CapturedStep


class Overloaded(RuntimeError):
    """Request shed at submit time: the engine's bounded queue is full."""


class DeadlineExceeded(RuntimeError):
    """Request expired in the queue before it could be dispatched."""


class EngineClosed(RuntimeError):
    """Submit against an engine that has been shut down."""


def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; n itself when every bucket is too small."""
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    return int(n)


def _pad_rows(a, total: int):
    a = np.asarray(a)
    if a.shape[0] >= total:
        return a
    widths = [(0, total - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths)


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    mask: Optional[np.ndarray]
    future: Future
    t_submit: float                   # perf_counter at submit
    deadline: Optional[float]         # absolute perf_counter deadline

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


def _default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch``."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_batch))
    return tuple(buckets)


class _BatchStage:
    """Reusable host staging buffer for one request signature.

    One ``(capacity, *tail)`` features buffer (and a lazily created mask
    buffer) lives across flushes; admitted requests copy their rows in at
    once.  ``dirty``/``mask_dirty`` mark rows holding stale data from
    earlier flushes, so only that tail is re-zeroed.  Only the worker
    thread touches a stage, and a dispatch finishes before the next flush
    reuses it.
    """

    __slots__ = ("features", "mask", "dirty", "mask_dirty", "has_mask")

    def __init__(self, capacity: int, tail: tuple, dtype):
        self.features = np.zeros((capacity,) + tail, dtype)
        self.mask: Optional[np.ndarray] = None
        self.dirty = 0
        self.mask_dirty = 0
        self.has_mask = False

    @property
    def capacity(self) -> int:
        return int(self.features.shape[0])

    def begin(self) -> None:
        self.has_mask = False

    def put(self, req: _Request, offset: int) -> bool:
        """Stage one request's rows at ``offset``; False when it does not
        fit this buffer (the flush then takes the concat path)."""
        x = req.x
        if x.shape[1:] != self.features.shape[1:] \
                or x.dtype != self.features.dtype \
                or offset + req.n > self.capacity:
            return False
        if req.mask is not None:
            mask = req.mask
            if self.mask is None:
                self.mask = np.zeros((self.capacity,) + mask.shape[1:], np.float32)
            elif mask.shape[1:] != self.mask.shape[1:]:
                return False
            if not self.has_mask and offset:
                self.mask[:offset] = 1.0   # earlier maskless rows
            self.has_mask = True
            self.mask[offset:offset + req.n] = mask
            self.mask_dirty = max(self.mask_dirty, offset + req.n)
        elif self.has_mask:
            self.mask[offset:offset + req.n] = 1.0
            self.mask_dirty = max(self.mask_dirty, offset + req.n)
        self.features[offset:offset + req.n] = x
        # the high-water mark moves at write time, so rows of a request
        # that later dies still count as stale
        self.dirty = max(self.dirty, offset + req.n)
        return True

    def restage(self, live: list) -> None:
        """Compact the surviving requests after some died before dispatch."""
        self.begin()
        offset = 0
        for req in live:
            self.put(req, offset)
            offset += req.n

    def view(self, bucket: int, rows: int) -> np.ndarray:
        if self.dirty > rows:
            self.features[rows:self.dirty] = 0
        self.dirty = rows
        return self.features[:bucket]

    def mask_view(self, bucket: int, rows: int) -> Optional[np.ndarray]:
        if not self.has_mask:
            return None
        if self.mask_dirty > rows:
            self.mask[rows:self.mask_dirty] = 0
        self.mask_dirty = rows
        return self.mask[:bucket]


def _build_forward(net, name="") -> CapturedStep:
    """The inference forward ``(params, state, x, mask) -> y`` of ``net``'s
    configuration, captured per bucket; it reads params and state as
    arguments, so every net of the configuration can share it."""

    def forward(params, state, x, mask):
        return net._forward(params, state, x, train=False, mask=mask)[0]

    return CapturedStep(forward, n_trees=2, name=name)


class InferenceEngine:
    """Micro-batching front end for one model on the model's device.

    ``model`` is a ``ComputationGraph`` or ``MultiLayerNetwork`` (anything
    with ``_forward``, ``params_``, ``state_`` and ``device``); the engine
    dispatches on ``model.device`` and raises if that is a CUDA card that
    is absent.  ``batches`` counts dispatched forwards; ``precision`` is
    ``"int8"`` for a quantized net (``nn/quantize.py``), else ``"fp"``.
    A quantized net keeps its full-precision sibling's configuration, so
    the two share the cached forward, each with graphs of its own params'
    shapes and dtypes.
    """

    _SHUTDOWN = object()

    def __init__(self, model, name: str = "default", max_batch: int = 32,
                 max_latency_ms: float = 5.0, queue_limit: int = 128):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.device = resolve_device(model.device)
        self.precision: str = getattr(model, "quantized_", None) or "fp"
        self.model = model
        self.name = name
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_ms) / 1e3
        self.queue_limit = int(queue_limit)
        self.buckets = _default_buckets(self.max_batch)
        self.batches = 0
        self._queue: queue.Queue = queue.Queue(maxsize=self.queue_limit)
        self._closed = threading.Event()
        self._stages: dict[tuple, _BatchStage] = {}
        sig = step_cache.net_signature(model)
        key = sig + ("serve_forward",) if sig is not None else None
        self._fwd = step_cache.get_or_build(key, lambda: _build_forward(model, key))
        self._worker = threading.Thread(
            target=self._run, daemon=True, name=f"tpudl-serve-{name}")
        self._worker.start()

    # ------------------------------------------------------------- submit
    def submit(self, x, mask=None, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request of ``[n, ...]`` examples; returns a Future
        resolving to the ``[n, ...]`` outputs as numpy.  A full queue sheds
        at once with :class:`Overloaded`."""
        if self._closed.is_set():
            raise EngineClosed(f"engine {self.name!r} is shut down")
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must have a leading example dim")
        now = time.perf_counter()
        req = _Request(x, None if mask is None else np.asarray(mask), Future(), now,
                       None if deadline_ms is None else now + float(deadline_ms) / 1e3)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise Overloaded(f"engine {self.name!r} queue full "
                             f"({self.queue_limit} waiting)") from None
        # a submit that lost the race with shutdown fails its leftovers
        if self._closed.is_set() and not self._worker.is_alive():
            self._fail_leftovers()
        return req.future

    def predict(self, x, mask=None, deadline_ms: Optional[float] = None,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking submit + wait."""
        return self.submit(x, mask=mask, deadline_ms=deadline_ms).result(timeout=timeout_s)

    # ------------------------------------------------------------- worker
    def _stage_for(self, req: _Request) -> Optional[_BatchStage]:
        if req.n > self.max_batch:
            return None
        key = (req.x.shape[1:], req.x.dtype.str)
        stage = self._stages.get(key)
        if stage is None:
            if len(self._stages) >= 8:      # bounded scratch memory
                self._stages.pop(next(iter(self._stages)))
            stage = _BatchStage(self.max_batch, req.x.shape[1:], req.x.dtype)
            self._stages[key] = stage
        return stage

    def _run(self) -> None:
        carry = None       # request that would have overflowed max_batch
        while True:
            item = carry if carry is not None else self._queue.get()
            carry = None
            if item is self._SHUTDOWN:
                return
            batch = [item]
            rows = item.n
            stage = self._stage_for(item)
            if stage is not None:
                stage.begin()
                if not stage.put(item, 0):
                    stage = None
            flush_at = time.perf_counter() + self.max_latency_s
            while rows < self.max_batch:
                remaining = flush_at - time.perf_counter()
                if remaining <= 0:
                    break                      # deadline flush
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break                      # deadline flush (idle)
                if nxt is self._SHUTDOWN:
                    self._dispatch(batch, stage)
                    return
                if rows + nxt.n > self.max_batch:
                    carry = nxt                # opens the next batch
                    break                      # size flush
                if stage is not None and not stage.put(nxt, rows):
                    stage = None               # mixed signature: concat path
                batch.append(nxt)
                rows += nxt.n
            self._dispatch(batch, stage)

    def _bucket_for(self, n: int) -> int:
        bucket = choose_bucket(n, self.buckets)
        if bucket not in self.buckets:
            self.buckets = tuple(sorted(self.buckets + (bucket,)))
        return bucket

    def _concat_masks(self, live: list) -> Optional[np.ndarray]:
        if not any(r.mask is not None for r in live):
            return None
        tail = next(r.mask.shape[1:] for r in live if r.mask is not None)
        parts = [r.mask if r.mask is not None
                 else np.ones((r.n,) + tail, np.float32) for r in live]
        return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

    def _forward(self, features: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
        x = torch.as_tensor(features, device=self.device)
        m = None if mask is None else torch.as_tensor(mask, device=self.device)
        with torch.inference_mode():
            y = self._fwd(self.model.params_, self.model.state_, x, m)
        if y.dtype == torch.bfloat16:
            y = y.float()
        return y.cpu().numpy()

    def _dispatch(self, batch: list, stage: Optional[_BatchStage] = None) -> None:
        """Run one micro-batch; every future in ``batch`` is resolved
        (result, deadline error, cancellation, or the forward's error),
        and the worker itself never dies."""
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req.future.set_exception(DeadlineExceeded(
                    f"request expired in queue after "
                    f"{1e3 * (now - req.t_submit):.1f} ms"))
            elif req.future.set_running_or_notify_cancel():
                live.append(req)
        if not live:
            return
        rows = sum(r.n for r in live)
        try:
            bucket = self._bucket_for(rows)
            if stage is not None and bucket > stage.capacity:
                stage = None    # sticky bucket outgrew the buffer
            if stage is not None:
                if len(live) != len(batch):
                    stage.restage(live)
                features = stage.view(bucket, rows)
                mask = stage.mask_view(bucket, rows)
            else:
                features = (np.concatenate([r.x for r in live], axis=0)
                            if len(live) > 1 else live[0].x)
                mask = self._concat_masks(live)
                if bucket > rows:
                    features = _pad_rows(features, bucket)
                    if mask is not None:
                        mask = _pad_rows(mask, bucket)
            out = self._forward(features, mask)
            self.batches += 1
        except Exception as e:
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        offset = 0
        for req in live:
            req.future.set_result(out[offset:offset + req.n])
            offset += req.n

    # ----------------------------------------------------------- lifecycle
    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the engine.  ``drain=True`` serves everything already
        queued first; ``drain=False`` fails it with :class:`EngineClosed`.
        New submits fail either way."""
        if self._closed.is_set():
            self._worker.join(timeout=timeout_s)
            return
        self._closed.set()
        if not drain:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not self._SHUTDOWN:
                    req.future.set_exception(
                        EngineClosed(f"engine {self.name!r} shut down"))
        self._queue.put(self._SHUTDOWN)
        self._worker.join(timeout=timeout_s)
        self._fail_leftovers()

    def _fail_leftovers(self) -> None:
        """Fail every request still queued after the worker has exited."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is self._SHUTDOWN or req.future.done():
                continue
            req.future.set_exception(EngineClosed(f"engine {self.name!r} shut down"))

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
