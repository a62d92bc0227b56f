"""Span-based tracing: nestable, Chrome-trace exportable (port of
``deeplearning4j_tpu/obs/tracing.py``).

- :func:`span` opens a nestable span (``fit`` -> ``epoch`` -> ``step``,
  ``serve``) carrying wall time, attributes, and device-sync time: the
  part of a span spent waiting on the card's stream, attributed
  explicitly via :func:`device_sync`, since CUDA launches are
  asynchronous and plain wall clocks lie.
- Span context (trace id + span id) serializes with :func:`inject` /
  :func:`extract`, so a caller can carry it across a thread, socket or
  process boundary and join a child's spans to the parent trace with
  :meth:`Tracer.set_remote_parent`.  The port reads no environment
  variable for it.
- Finished spans export as append-only jsonl
  (:meth:`Tracer.export_jsonl`) and as Chrome-trace JSON
  (:meth:`Tracer.export_chrome_trace`) loadable in ``chrome://tracing``
  or https://ui.perfetto.dev, in the JAX package's formats.

Tracing is OFF by default (``config.tracing``, set through
``set_config(tracing=True)``); a disabled :func:`span` costs one config
read and yields a no-op span.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Iterator, Optional

from deeplearning4j_tpu_torch.config import get_config


@dataclasses.dataclass
class SpanContext:
    """The serializable identity of a span — what crosses process
    boundaries (W3C traceparent equivalent, minimal form)."""

    trace_id: str
    span_id: str

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_dict(d: dict) -> "SpanContext":
        return SpanContext(str(d["trace_id"]), str(d["span_id"]))


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float                       # epoch seconds (export timestamp)
    end_s: Optional[float] = None
    attributes: dict = dataclasses.field(default_factory=dict)
    device_sync_s: float = 0.0           # time blocked on device→host sync
    pid: int = dataclasses.field(default_factory=os.getpid)
    tid: int = dataclasses.field(default_factory=threading.get_ident)
    _t0: float = 0.0                     # perf_counter at start (duration)

    @property
    def duration_s(self) -> float:
        if self.end_s is None:
            return 0.0
        return self.end_s - self.start_s

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start_s": self.start_s, "end_s": self.end_s,
            "duration_s": self.duration_s,
            "device_sync_s": self.device_sync_s,
            "pid": self.pid, "tid": self.tid,
            "attributes": self.attributes,
        }


class _NullSpan:
    """No-op span handed out when tracing is disabled — same surface, so
    instrumented code never branches on the enable flag."""

    name = ""
    attributes: dict = {}
    device_sync_s = 0.0

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def context(self) -> None:
        return None


NULL_SPAN = _NullSpan()

_current_span: contextvars.ContextVar[Optional[Span]] = \
    contextvars.ContextVar("dl4j_tpu_current_span", default=None)

# observers notified on every finished span (the flight recorder mirrors
# spans into its ring here); hooks must be cheap and never raise
_span_hooks: list = []


def add_span_hook(hook) -> None:
    """Register ``hook(span)`` to run on every finished span (any
    tracer).  Idempotent per function object."""
    if hook not in _span_hooks:
        _span_hooks.append(hook)


def remove_span_hook(hook) -> None:
    if hook in _span_hooks:
        _span_hooks.remove(hook)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Collects finished spans; exports jsonl and Chrome-trace JSON.

    ``enabled=None`` (the default global tracer) defers to
    ``config.tracing`` at each span start; ``True``/``False`` pins it
    (tests use pinned local tracers).  A remote parent context set with
    :meth:`set_remote_parent` becomes the parent of root spans, joining
    this process's spans to the launching process's trace."""

    MAX_SPANS = 200_000   # memory bound; beyond it spans are counted, not kept

    def __init__(self, enabled: Optional[bool] = None):
        self._enabled = enabled
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        self.dropped = 0
        self._jsonl_offsets: dict[str, int] = {}   # per-path export high-water
        self._remote_parent: Optional[SpanContext] = None

    @property
    def enabled(self) -> bool:
        if self._enabled is not None:
            return self._enabled
        return bool(get_config().tracing)

    def set_remote_parent(self, ctx: Optional[SpanContext]) -> None:
        self._remote_parent = ctx

    # ------------------------------------------------------------ spans
    def start_span(self, name: str, parent: Optional[SpanContext] = None,
                   attributes: Optional[dict] = None) -> Span:
        if parent is None:
            cur = _current_span.get()
            parent = cur.context() if cur is not None else self._remote_parent
        trace_id = parent.trace_id if parent else _new_id()
        return Span(name=name, trace_id=trace_id, span_id=_new_id(),
                    parent_id=parent.span_id if parent else None,
                    start_s=time.time(), _t0=time.perf_counter(),
                    attributes=dict(attributes or {}))

    def finish_span(self, s: Span) -> None:
        s.end_s = s.start_s + (time.perf_counter() - s._t0)
        with self._lock:
            if len(self.spans) < self.MAX_SPANS:
                self.spans.append(s)
            else:
                self.dropped += 1
        for hook in _span_hooks:
            try:
                hook(s)
            except Exception:
                pass   # telemetry observers must never break the traced code

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.dropped = 0
            self._jsonl_offsets = {}

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    # ---------------------------------------------------------- exports
    def export_jsonl(self, path: str) -> str:
        """Append-only span export; repeated calls on the same path write
        only spans finished since the last export (per-path high-water
        mark), so periodic flushing never duplicates records."""
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        key = os.path.abspath(path)
        with self._lock:
            start = self._jsonl_offsets.get(key, 0)
            spans = list(self.spans[start:])
            self._jsonl_offsets[key] = start + len(spans)
        with open(path, "a") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
        return path

    def export_chrome_trace(self, path: str) -> str:
        """Chrome trace event format (``ph: "X"`` complete events, µs
        timestamps) — open in ``chrome://tracing`` or Perfetto."""
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with self._lock:
            spans = list(self.spans)
        events = []
        for s in spans:
            args = {k: v for k, v in s.attributes.items()}
            if s.device_sync_s:
                args["device_sync_ms"] = round(s.device_sync_s * 1e3, 3)
            args["span_id"] = s.span_id
            if s.parent_id:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name, "cat": "tpudl", "ph": "X",
                "ts": s.start_s * 1e6, "dur": max(s.duration_s, 0.0) * 1e6,
                "pid": s.pid, "tid": s.tid,
                "args": {k: (v if isinstance(v, (int, float, str, bool,
                                                 type(None))) else str(v))
                         for k, v in args.items()},
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


_global_tracer = Tracer()
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _global_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests / bench pin their own); returns the
    previous one so callers can restore it."""
    global _global_tracer
    with _tracer_lock:
        prev = _global_tracer
        _global_tracer = tracer
    return prev


@contextmanager
def use_tracer(tracer: Tracer) -> Iterator[Tracer]:
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


@contextmanager
def span(name: str, parent: Optional[SpanContext] = None,
         **attributes: Any) -> Iterator[Any]:
    """Open a nested span on the active tracer.  Yields the Span (or a
    no-op when tracing is disabled).  ``parent`` overrides the ambient
    parent — used when hopping threads or processes."""
    tracer = _global_tracer
    if not tracer.enabled:
        yield NULL_SPAN
        return
    s = tracer.start_span(name, parent=parent, attributes=attributes)
    token = _current_span.set(s)
    try:
        yield s
    finally:
        _current_span.reset(token)
        tracer.finish_span(s)


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_context() -> Optional[SpanContext]:
    s = _current_span.get()
    if s is not None:
        return s.context()
    return _global_tracer._remote_parent


# ------------------------------------------------------ wire propagation
def inject() -> Optional[str]:
    """Serialize the current span context for the wire (env var, pickle,
    socket header); None when there is no active span."""
    ctx = current_context()
    return json.dumps(ctx.to_dict()) if ctx else None


def extract(raw: Optional[str]) -> Optional[SpanContext]:
    """Inverse of :func:`inject`; tolerant of absent/malformed input."""
    if not raw:
        return None
    try:
        return SpanContext.from_dict(json.loads(raw))
    except (ValueError, KeyError, TypeError):
        return None


# ------------------------------------------------------ device helpers
def device_sync(value: Any) -> Any:
    """Wait until the card's current stream has finished the work behind
    ``value`` (a tensor or a tree of them), attributing the wait to the
    current span's ``device_sync_s``.  This is how spans separate
    host-side launch from device execution: without it, a step's time
    hides inside whichever later call happens to block first.  CPU
    tensors are ready when returned, and cost no wait."""
    t0 = time.perf_counter()
    if _on_cuda(value):
        import torch
        torch.cuda.current_stream().synchronize()
    dt = time.perf_counter() - t0
    s = _current_span.get()
    if s is not None:
        s.device_sync_s += dt
    return value


def _on_cuda(value: Any) -> bool:
    if isinstance(value, (list, tuple)):
        return any(_on_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    return getattr(getattr(value, "device", None), "type", None) == "cuda"


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's memory in the JAX package's keys: ``bytes_in_use``
    (``allocated_bytes.all.current``), ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``) and ``bytes_limit`` (the card's total
    memory), from ``torch.cuda.memory_stats``; None without a card or
    for a CPU ``device``."""
    import torch
    try:
        if not torch.cuda.is_available():
            return None
        dev = torch.device(device) if device is not None else torch.device("cuda")
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}
    except Exception:
        return None
