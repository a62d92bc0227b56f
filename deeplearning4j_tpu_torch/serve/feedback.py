"""Feedback capture: serve traffic becomes training data (port of
``deeplearning4j_tpu/serve/feedback.py``; the spool's format is the JAX
package's, so either package reads a spool the other wrote).

The write half of the online continual-learning loop
(docs/online.md): labeled serve traffic — ``POST
/v1/models/<name>:feedback`` bodies, or the predict path's optional tap
for requests that carry their own labels — lands in a **spool**: a
bounded, crash-safe directory of JSONL segment files that the
background trainer's :class:`~deeplearning4j_tpu_torch.online.source.
FeedbackSource` replays as training batches.

Contracts (never block the request path):

- **append never blocks and never raises** on the request path: records
  go into a bounded in-memory buffer drained by ONE background writer
  thread; overflow drops the OLDEST buffered records and counts them in
  ``tpudl_online_spool_dropped_total`` — backpressure from a slow disk
  must never reach a serving request.
- **crash-safe on disk**: the writer appends complete JSON lines and
  fsyncs on rotation; a crash mid-append tears at most the final line,
  which readers detect (json parse failure) and skip as a counted drop
  — never a wrong record.
- **bounded on disk**: segments rotate at ``max_records_per_segment``
  records and the oldest segments are pruned past ``max_segments``,
  so the spool holds at most ``max_segments x max_records_per_segment``
  records; pruned-but-unconsumed records are counted drops.

Spool layout: ``<dir>/spool-<start_index:012d>.jsonl`` where
``start_index`` is the GLOBAL index of the segment's first record.
Global record indices are therefore stable across rotation and pruning
— the reader's position (and the online trainer's round stamps) survive
both restarts and retention.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

SEGMENT_RE = re.compile(r"^spool-(\d{12})\.jsonl$")
SEGMENT_FMT = "spool-{:012d}.jsonl"


def _segment_path(directory: str, start_index: int) -> str:
    return os.path.join(directory, SEGMENT_FMT.format(start_index))


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(start_index, path) for every spool segment, oldest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def read_segment(path: str) -> tuple[list[dict], int]:
    """(records, torn_lines) for one segment file.  A torn final line —
    the one shape a crash mid-append can leave — parses as garbage and
    is skipped, counted, never guessed at."""
    records, torn = [], 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except (ValueError, json.JSONDecodeError):
                    torn += 1
    except OSError:
        return [], 0
    return records, torn


def read_records(directory: str,
                 start: int = 0,
                 stop: Optional[int] = None) -> list[tuple[int, dict]]:
    """``(global_index, record)`` pairs in ``[start, stop)``, in spool
    order.  Pruned segments simply don't contribute (their indices are
    gone).  Torn lines are invisible to indexing: only a crash can tear
    a line (always the file's final line at that moment), the writer
    newline-terminates it on reopen, and every reader skips it — so all
    readers agree on the surviving records' indices."""
    out: list[tuple[int, dict]] = []
    for seg_start, path in list_segments(directory):
        records, _ = read_segment(path)
        for offset, record in enumerate(records):
            idx = seg_start + offset
            if idx < start:
                continue
            if stop is not None and idx >= stop:
                return out
            out.append((idx, record))
    return out


def record_count(directory: str) -> int:
    """Highest global record index + 1 (the spool's write position)."""
    segments = list_segments(directory)
    if not segments:
        return 0
    seg_start, path = segments[-1]
    records, _ = read_segment(path)
    return seg_start + len(records)


class FeedbackLog:
    """Bounded, never-blocking feedback spool writer.

    ``append`` is the request-path surface: validate + buffer-append
    only.  The writer thread drains the buffer to the active segment,
    rotates segments, prunes retention, and keeps the
    ``tpudl_online_spool_*`` metrics honest.  ``flush()`` (tests, the
    example) blocks until the buffer has drained to disk.
    """

    def __init__(self, directory: str,
                 max_buffer: int = 4096,
                 max_records_per_segment: int = 1024,
                 max_segments: int = 16,
                 flush_interval_s: float = 0.05,
                 fsync_on_rotate: bool = True):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.max_buffer = max(1, int(max_buffer))
        self.max_records_per_segment = max(1, int(max_records_per_segment))
        self.max_segments = max(1, int(max_segments))
        self.flush_interval_s = float(flush_interval_s)
        self.fsync_on_rotate = bool(fsync_on_rotate)
        self._buffer: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._drained = threading.Event()
        self._drained.set()
        self._closed = threading.Event()
        # resume the global index from whatever a previous process left
        self._next_index = record_count(directory)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudl-feedback-spool")
        self._thread.start()

    # ------------------------------------------------------------ request path
    def append(self, x, y, weight: float = 1.0,
               trace_id: Optional[str] = None,
               model: Optional[str] = None) -> bool:
        """Buffer one (input, label, weight) record.  Never blocks,
        never raises on the serving path: malformed values are rejected
        (returns False, counted), a full buffer drops the OLDEST
        buffered record (counted) to admit the new one."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        try:
            record = {
                "t": time.time(),
                "x": np.asarray(x, dtype=np.float32).tolist(),
                "y": np.asarray(y, dtype=np.float32).tolist(),
                "w": float(weight),
            }
            if trace_id:
                record["trace_id"] = str(trace_id)
            if model:
                record["model"] = str(model)
        except (TypeError, ValueError):
            reg.counter("tpudl_online_spool_dropped_total").inc()
            return False
        if self._closed.is_set():
            reg.counter("tpudl_online_spool_dropped_total").inc()
            return False
        with self._lock:
            while len(self._buffer) >= self.max_buffer:
                self._buffer.popleft()
                reg.counter("tpudl_online_spool_dropped_total").inc()
            self._buffer.append(record)
            self._drained.clear()
        self._wake.set()
        return True

    def extend(self, xs, ys, weights=None,
               trace_id: Optional[str] = None,
               model: Optional[str] = None) -> int:
        """Append row-wise; returns how many rows were accepted.  A row
        with an unusable weight is rejected (counted), never raised —
        this runs on the HTTP feedback path."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        n = 0
        for i, (x, y) in enumerate(zip(xs, ys)):
            try:
                w = 1.0 if weights is None else float(weights[i])
            except (TypeError, ValueError, KeyError, IndexError):
                get_registry().counter(
                    "tpudl_online_spool_dropped_total").inc()
                continue
            if self.append(x, y, weight=w, trace_id=trace_id, model=model):
                n += 1
        return n

    # ------------------------------------------------------------ writer side
    def _active_segment(self) -> tuple[int, str, int]:
        """(segment start index, path, records already in it)."""
        segments = list_segments(self.directory)
        if segments:
            seg_start, path = segments[-1]
            records, _ = read_segment(path)
            if len(records) < self.max_records_per_segment:
                return seg_start, path, len(records)
            seg_start = seg_start + len(records)
            return seg_start, _segment_path(self.directory, seg_start), 0
        return 0, _segment_path(self.directory, 0), 0

    def _open_active(self):
        """Open the active segment for append; a crash mid-append leaves
        a torn final line with no newline — terminate it so the first
        new record cannot merge into the garbage (readers skip the torn
        line either way)."""
        seg_start, seg_path, seg_count = self._active_segment()
        fh = open(seg_path, "a", encoding="utf-8")
        try:
            if os.path.getsize(seg_path) > 0:
                with open(seg_path, "rb") as check:
                    check.seek(-1, os.SEEK_END)
                    if check.read(1) != b"\n":
                        fh.write("\n")
                        fh.flush()
        except OSError:
            pass
        return seg_start, seg_path, seg_count, fh

    def _run(self) -> None:
        import logging
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        log = logging.getLogger("deeplearning4j_tpu")
        fh = None
        try:
            while True:
                self._wake.wait(timeout=self.flush_interval_s)
                self._wake.clear()
                # disk failures (ENOSPC, a yanked volume) cost COUNTED
                # drops and a reopen attempt next pass — the writer
                # never dies silently while appends keep reporting ok
                try:
                    if fh is None:
                        seg_start, seg_path, seg_count, fh = \
                            self._open_active()
                    while True:
                        with self._lock:
                            if not self._buffer:
                                # flush BEFORE signalling drained: a
                                # flush() waiter reads the disk next
                                fh.flush()
                                self._drained.set()
                                break
                            record = self._buffer.popleft()
                        try:
                            fh.write(json.dumps(record) + "\n")
                        except OSError:
                            # the popped record is lost — count it
                            reg.counter(
                                "tpudl_online_spool_dropped_total").inc()
                            raise
                        seg_count += 1
                        # written() reads this from caller threads —
                        # publish the new position under the lock
                        with self._lock:
                            self._next_index += 1
                        reg.counter(
                            "tpudl_online_spool_records_total").inc()
                        if seg_count >= self.max_records_per_segment:
                            fh.flush()
                            if self.fsync_on_rotate:
                                os.fsync(fh.fileno())
                            fh.close()
                            seg_start += seg_count
                            seg_path = _segment_path(self.directory,
                                                     seg_start)
                            fh = open(seg_path, "a", encoding="utf-8")
                            seg_count = 0
                            self._prune(reg)
                except OSError as e:
                    log.warning("feedback spool write failed "
                                "(will retry): %r", e)
                    try:
                        if fh is not None:
                            fh.close()
                    except OSError:
                        pass
                    fh = None
                    self._closed.wait(0.25)   # backoff, wake on close
                if self._closed.is_set():
                    with self._lock:
                        empty = not self._buffer
                        stranded = 0 if fh is not None else len(self._buffer)
                    if empty or fh is None:
                        if stranded:   # closing with the disk still down
                            reg.counter(
                                "tpudl_online_spool_dropped_total").inc(
                                stranded)
                        return
        finally:
            try:
                if fh is not None:
                    fh.flush()
                    fh.close()
            except OSError:
                pass

    def _prune(self, reg) -> None:
        segments = list_segments(self.directory)
        while len(segments) > self.max_segments:
            seg_start, path = segments.pop(0)
            records, _ = read_segment(path)
            try:
                os.remove(path)
            except OSError:
                return
            reg.counter("tpudl_online_spool_dropped_total").inc(len(records))

    # ------------------------------------------------------------- lifecycle
    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until buffered records are on disk (tests/examples —
        never called on the request path)."""
        self._wake.set()
        return self._drained.wait(timeout=timeout_s)

    def pending(self) -> int:
        with self._lock:
            return len(self._buffer)

    def written(self) -> int:
        """Records durably appended so far (global write position)."""
        with self._lock:
            return self._next_index

    def close(self, timeout_s: float = 10.0) -> None:
        self._closed.set()
        self._wake.set()
        self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "FeedbackLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
