"""Cluster telemetry federation: every worker reports in (port of
``deeplearning4j_tpu/obs/remote.py``).

The reference's ``RemoteUIStatsStorageRouter`` counterpart: worker
processes route their progress and statistics records to ONE
``UIServer`` over HTTP, so that a whole gang is watched from one
dashboard.

Two halves:

- **Worker side**, :class:`RemoteStatsRouter`: a bounded in-memory buffer
  drained by a background thread that POSTs JSON batches to the
  coordinator's ``/remote/stats`` endpoint with ``resilience.retry``
  backoff.  Producers (``Trainer.step_batch``, ``MultiSliceTrainer``, a
  ``StatsListener`` through the storage protocol, the heartbeat ticker)
  only append to the buffer: a push never runs on the step path, never
  blocks and never raises.  An unreachable coordinator costs dropped
  telemetry (``tpudl_cluster_records_dropped_total``), not a step.
- **Coordinator side**, :class:`ClusterStore`: per-worker liveness,
  step-time windows, MFU and score, fed by the ``UIServer``'s ingest
  endpoint; it renders the ``/cluster`` dashboard, exports per-worker
  series on ``/metrics`` with a ``worker`` label, and runs the cluster
  health checks (stragglers, through ``obs.health``).

Wiring: ``spawn_local_cluster(..., remote_ui=server.url)`` (and the
supervisor) put the endpoint, the worker id (``w<slot>``) and the restart
generation into each child's launcher context
(``parallel.launcher.child_context``); the child's bootstrap calls
:func:`install_from_context`, after which every trainer step in that
process stamps its progress (:func:`notify_step`).  Nothing here reads
the environment.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import threading
import time
from collections import deque
from typing import Any, Optional

INGEST_PATH = "/remote/stats"
# per-worker record history kept by the coordinator (dashboard replay)
STORE_RECORDS = 256
# step-time window for medians and the straggler check
STEP_WINDOW = 64
# restart annotations kept for the /cluster dashboard
RESTART_ANNOTATIONS = 64
DASHBOARD_ANNOTATIONS = 64


def _jsonable(value: Any) -> Any:
    """JSON coercion at flush time: a device scalar is ``float()``-ed
    here, on the router's thread, so that a worker can buffer a live
    tensor without waiting for the card on the step path."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else repr(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        f = float(value)
        return f if math.isfinite(f) else repr(f)
    except Exception:
        return str(value)


class RemoteStatsRouter:
    """Buffered, non-blocking push channel to a coordinator ``UIServer``.

    It implements the statistics-storage protocol (``put``/``all``), so a
    ``StatsListener(storage=router)`` federates its records;
    ``put_event``/``heartbeat`` are the lighter progress surface the
    trainers use.  The buffer is bounded: overflow drops the OLDEST
    records and counts them, so a slow coordinator never reaches the
    training loop.  ``worker`` and ``generation`` default to the launcher
    context's (``w<slot>`` and the restart generation), else
    ``host:pid`` and 0."""

    def __init__(self, endpoint: str, worker: Optional[str] = None,
                 flush_interval_s: float = 0.25, heartbeat_interval_s: float = 1.0,
                 max_buffer: int = 1024, batch_size: int = 64, timeout_s: float = 2.0,
                 retry_policy=None, generation: Optional[int] = None):
        from deeplearning4j_tpu_torch.parallel.launcher import child_context
        ctx = child_context()
        self.endpoint = endpoint.rstrip("/")
        self.worker = worker or ctx.worker or f"{socket.gethostname()}:{os.getpid()}"
        # the restart generation rides on every push, so that the
        # coordinator tells a respawned worker from its dead predecessor
        self.generation = int(ctx.generation if generation is None else generation)
        self.flush_interval_s = flush_interval_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.max_buffer = max(1, int(max_buffer))
        self.batch_size = max(1, int(batch_size))
        self.timeout_s = timeout_s
        if retry_policy is None:
            from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
            # every push error is worth one quick retry, but the deadline
            # keeps a dead coordinator from making the flush thread a hot
            # retry loop
            retry_policy = RetryPolicy(max_attempts=2, base_delay_s=0.05, max_delay_s=0.25,
                                       deadline_s=2.0, retryable=lambda e: True)
        self._retry_policy = retry_policy
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._dropped = 0
        self._pushed = 0
        self._failures = 0
        self._last_heartbeat = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudl-remote-router")
        self._thread.start()

    # ------------------------------------------------------ producer side
    def put(self, record: dict) -> None:
        """Storage protocol: buffer one record (non-blocking)."""
        with self._lock:
            self._buf.append(record)
            if len(self._buf) > self.max_buffer:
                self._buf.popleft()
                self._dropped += 1
        self._wake.set()

    def all(self) -> list:
        """Storage protocol.  The record history lives on the coordinator
        (:class:`ClusterStore`); the router keeps none, so this is empty."""
        return []

    def put_event(self, kind: str, **data: Any) -> None:
        record = {"type": kind, "time": time.time()}
        record.update(data)
        self.put(record)

    def heartbeat(self) -> None:
        self.put_event("heartbeat")

    # ------------------------------------------------------ consumer side
    @property
    def dropped(self) -> int:
        """Records lost to buffer overflow or spent push retries: bounded
        by design, never an exception."""
        return self._dropped

    @property
    def pushed(self) -> int:
        return self._pushed

    @property
    def push_failures(self) -> int:
        return self._failures

    def _pop_batch(self) -> list:
        with self._lock:
            n = min(len(self._buf), self.batch_size)
            return [self._buf.popleft() for _ in range(n)]

    def _post(self, payload: bytes) -> None:
        import urllib.request
        req = urllib.request.Request(self.endpoint + INGEST_PATH, data=payload,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def _flush_once(self) -> int:
        """Drain one batch; returns the records handled (sent or dropped).
        Failures are counted, never raised: this runs on the router's
        thread only."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        from deeplearning4j_tpu_torch.resilience.retry import with_retries
        batch = self._pop_batch()
        if not batch:
            return 0
        payload = json.dumps({"worker": self.worker, "generation": self.generation,
                              "records": [_jsonable(r) for r in batch]}).encode()
        reg = get_registry()
        try:
            with_retries(lambda: self._post(payload), policy=self._retry_policy,
                         site="remote.push")
            self._pushed += len(batch)
            reg.counter("tpudl_cluster_records_pushed_total").inc(len(batch))
        except Exception:
            # the coordinator is down or stalled: count the loss and move
            # on (re-queueing would lose them again and starve newer
            # records); put() bumps _dropped on other threads, so under
            # the same lock
            self._failures += 1
            with self._lock:
                self._dropped += len(batch)
            reg.counter("tpudl_cluster_push_failures_total").inc()
            reg.counter("tpudl_cluster_records_dropped_total").inc(len(batch))
        return len(batch)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            now = time.monotonic()
            if now - self._last_heartbeat >= self.heartbeat_interval_s:
                self._last_heartbeat = now
                self.put_event("heartbeat")
            while self._flush_once():
                if self._stop.is_set():
                    break
        # the last drain: one bounded attempt per remaining batch
        while self._flush_once():
            pass

    def close(self, timeout: float = 5.0) -> None:
        """Flush what the coordinator takes within ``timeout`` and stop the
        thread.  Never raises."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)


# ------------------------------------------------------- process router
_router: Optional[RemoteStatsRouter] = None
_router_lock = threading.Lock()


def install(endpoint: str, **kwargs: Any) -> RemoteStatsRouter:
    """Install (replacing any previous one) the process-wide router that
    :func:`notify_step` and :func:`notify_event` feed."""
    global _router
    with _router_lock:
        if _router is not None:
            _router.close(timeout=1.0)
        _router = RemoteStatsRouter(endpoint, **kwargs)
        return _router


def install_from_context() -> Optional[RemoteStatsRouter]:
    """A gang child's bootstrap: the launcher context's coordinator
    endpoint (``spawn_local_cluster(remote_ui=...)``), under its worker id
    and generation.  Nothing without an endpoint."""
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    endpoint = (child_context().remote_ui or "").strip()
    if not endpoint:
        return None
    return install(endpoint)


def get_router() -> Optional[RemoteStatsRouter]:
    return _router


def close_router(timeout: float = 5.0) -> None:
    global _router
    with _router_lock:
        if _router is not None:
            _router.close(timeout=timeout)
            _router = None


def notify_step(iteration: int, epoch: int = 0, duration_s: Optional[float] = None,
                score: Any = None, examples: Optional[int] = None, **extra: Any) -> None:
    """A trainer's per-step progress stamp: a buffer append (a device
    ``score`` is read later, on the router's thread); nothing when no
    router is installed, so a single process pays one ``is None``."""
    router = _router
    if router is None:
        return
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    router.put_event("step", iteration=int(iteration), epoch=int(epoch),
                     step_seconds=duration_s, score=score, examples=examples,
                     mfu=get_registry().gauge("tpudl_perf_mfu").value, **extra)


def notify_event(kind: str, **data: Any) -> None:
    router = _router
    if router is not None:
        router.put_event(kind, **data)


# ========================================================= coordinator
class _WorkerState:
    __slots__ = ("first_seen", "last_seen", "steps", "iteration", "epoch", "score", "mfu",
                 "step_window", "records", "straggler", "last_step_s", "first_step_time",
                 "last_step_time", "generation", "restarts", "resumed_iteration")

    def __init__(self, generation: int = 0, restarts: int = 0):
        now = time.time()
        self.first_seen = now
        self.last_seen = now
        self.generation = generation
        self.restarts = restarts          # generation bumps seen so far
        self.resumed_iteration = None     # from the trainer's resume event
        # the producer's stamps of the first and last step record: receipt
        # times collapse when one flush delivers many steps, so rates come
        # from the worker's own clock
        self.first_step_time = None
        self.last_step_time = None
        self.steps = 0
        self.iteration = -1
        self.epoch = 0
        self.score = None
        self.mfu = None
        self.last_step_s = None
        self.step_window: deque = deque(maxlen=STEP_WINDOW)
        self.records: deque = deque(maxlen=STORE_RECORDS)
        self.straggler = False


def _median(values) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return statistics.median(vals) if vals else None


class ClusterStore:
    """The coordinator's federation state: one :class:`_WorkerState` per
    reporting worker, fed by the ``UIServer``'s ``/remote/stats`` ingest.
    Updates the ``tpudl_cluster_*`` series (per-worker ones carry a
    ``worker`` label) and runs the cluster health checks."""

    def __init__(self, straggler_factor: float = 2.0, min_straggler_samples: int = 4):
        self._workers: dict[str, _WorkerState] = {}
        self._restarts: deque = deque(maxlen=RESTART_ANNOTATIONS)
        self._annotations: deque = deque(maxlen=DASHBOARD_ANNOTATIONS)
        self._lock = threading.Lock()
        self.straggler_factor = float(straggler_factor)
        self.min_straggler_samples = int(min_straggler_samples)
        self._gang_width: Optional[int] = None

    def set_gang_width(self, width: int) -> None:
        """The training gang's current width (the supervisor stamps it on
        every spawn, resizes included), for the dashboard and summary."""
        with self._lock:
            self._gang_width = int(width)

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    # ------------------------------------------------------------ ingest
    def ingest(self, worker: str, records: list, generation: int = 0) -> int:
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        generation = int(generation)
        n = 0
        with self._lock:
            state = self._workers.get(worker)
            if state is None:
                state = self._workers[worker] = _WorkerState(generation)
                reg.gauge("tpudl_cluster_workers").set(len(self._workers))
            elif generation > state.generation:
                # the supervisor respawned the worker: start over, so that
                # the dead predecessor's step window feeds neither the
                # straggler check nor median_step_ms
                self._restarts.append({"worker": worker, "time": time.time(),
                                       "from_generation": state.generation,
                                       "to_generation": generation,
                                       "last_iteration": state.iteration})
                state = self._workers[worker] = _WorkerState(generation,
                                                             restarts=state.restarts + 1)
            elif generation < state.generation:
                # a dead predecessor's buffered records arriving after its
                # replacement registered: dropped
                reg.counter("tpudl_cluster_stale_records_total").inc(len(records))
                return 0
            reg.labeled_gauge("tpudl_cluster_worker_generation",
                              label_names=("worker",)).set(generation, worker=worker)
            for record in records:
                if not isinstance(record, dict):
                    continue
                try:
                    n += self._ingest_one(state, worker, record, reg)
                except (TypeError, ValueError):
                    # one malformed record (a null iteration, a string step
                    # time) neither fails the batch nor poisons the state
                    continue
        if n:
            reg.counter("tpudl_cluster_records_ingested_total").inc(n)
        self._check_stragglers()
        return n

    def _ingest_one(self, state: _WorkerState, worker: str, record: dict, reg) -> int:
        """Apply ONE record to the worker's state; returns 1.  Fields are
        coerced before any change, so a malformed one (``TypeError`` or
        ``ValueError`` to :meth:`ingest`) leaves the state untouched."""
        kind = record.get("type")
        if kind == "step":
            iteration = int(record.get("iteration", state.iteration + 1))
            epoch = int(record.get("epoch", state.epoch))
            state.last_seen = time.time()
            state.steps += 1
            state.iteration = iteration
            state.epoch = epoch
            stamp = record.get("time")
            if isinstance(stamp, (int, float)) and math.isfinite(stamp):
                if state.first_step_time is None:
                    state.first_step_time = float(stamp)
                state.last_step_time = float(stamp)
            dt = record.get("step_seconds")
            if isinstance(dt, (int, float)) and dt >= 0:
                state.last_step_s = float(dt)
                state.step_window.append(float(dt))
                reg.labeled_histogram("tpudl_cluster_step_seconds",
                                      label_names=("worker",)).observe(float(dt), worker=worker)
            score = record.get("score")
            if isinstance(score, (int, float)) and math.isfinite(score):
                state.score = float(score)
                reg.labeled_gauge("tpudl_cluster_worker_last_score",
                                  label_names=("worker",)).set(state.score, worker=worker)
            mfu = record.get("mfu")
            if isinstance(mfu, (int, float)) and mfu > 0:
                state.mfu = float(mfu)
                reg.labeled_gauge("tpudl_cluster_worker_mfu",
                                  label_names=("worker",)).set(state.mfu, worker=worker)
            reg.labeled_gauge("tpudl_cluster_worker_iteration",
                              label_names=("worker",)).set(state.iteration, worker=worker)
        else:
            state.last_seen = time.time()
            if kind == "resume":
                # the trainer restored a checkpoint: the resume point, for
                # the supervisor's steps replayed and the dashboard
                it = record.get("iteration")
                if isinstance(it, (int, float)) and math.isfinite(it):
                    state.resumed_iteration = int(it)
            if kind != "heartbeat":
                state.records.append(record)
        reg.labeled_gauge("tpudl_cluster_worker_last_seen_time",
                          label_names=("worker",)).set(state.last_seen, worker=worker)
        return 1

    # ------------------------------------------------------------ health
    def _medians(self) -> dict:
        with self._lock:
            return {w: _median(s.step_window) for w, s in self._workers.items()
                    if len(s.step_window) >= self.min_straggler_samples}

    def _check_stragglers(self) -> None:
        from deeplearning4j_tpu_torch.obs import health
        medians = self._medians()
        flagged = set(health.stragglers(medians, factor=self.straggler_factor))
        with self._lock:
            for worker, state in self._workers.items():
                now_flagged = worker in flagged
                if now_flagged and not state.straggler:
                    health.report_anomaly(
                        "straggler", f"worker {worker} median step "
                        f"{medians.get(worker, 0):.4f}s is >{self.straggler_factor}x the "
                        f"cluster median", worker=worker)
                state.straggler = now_flagged

    # ----------------------------------------------------------- summary
    def straggler_skew(self) -> Optional[float]:
        """The largest worker median step time over the median of the
        medians: 1.0 is an even gang."""
        medians = [m for m in self._medians().values() if m]
        overall = _median(medians)
        if not medians or not overall:
            return None
        return max(medians) / overall

    def summary(self) -> dict:
        now = time.time()
        with self._lock:
            workers = {}
            for name, s in sorted(self._workers.items()):
                # the raw window median: the dashboard shows a number as
                # soon as one step lands
                med = _median(s.step_window)
                # the rate from the worker's own stamps (n-1 intervals
                # between n steps), else from the median
                if (s.steps > 1 and s.first_step_time is not None
                        and s.last_step_time > s.first_step_time):
                    rate = (s.steps - 1) / (s.last_step_time - s.first_step_time)
                elif med:
                    rate = 1.0 / med
                else:
                    rate = None
                workers[name] = {
                    "steps": s.steps, "iteration": s.iteration, "epoch": s.epoch,
                    "score": s.score, "mfu": s.mfu,
                    "last_step_ms": None if s.last_step_s is None else round(s.last_step_s * 1e3,
                                                                              3),
                    "median_step_ms": None if med is None else round(med * 1e3, 3),
                    "steps_per_s": round(rate, 3) if rate is not None else None,
                    "liveness_age_s": round(now - s.last_seen, 3),
                    "straggler": s.straggler, "records": len(s.records),
                    "generation": s.generation, "restarts": s.restarts,
                    "resumed_iteration": s.resumed_iteration,
                }
            restarts = list(self._restarts)
            annotations = list(self._annotations)
            gang_width = self._gang_width
        return {"n_workers": len(workers), "straggler_skew": self.straggler_skew(),
                "gang_width": gang_width, "workers": workers, "restarts": restarts,
                "annotations": annotations}

    def records_for(self, worker: str) -> list:
        with self._lock:
            state = self._workers.get(worker)
            return list(state.records) if state else []

    # -------------------------------------------------------- annotations
    def annotate(self, kind: str, message: str, **facts) -> dict:
        """Pin an event onto the ``/cluster`` timeline (resizes, SLO
        breaches, deploy markers, notes); the facts ride as they are into
        ``/cluster.json``."""
        note = {"kind": str(kind), "message": str(message), "time": time.time(), **facts}
        with self._lock:
            self._annotations.append(note)
        return note

    # -------------------------------------------------------------- html
    def render_html(self, refresh_seconds: int = 5) -> str:
        import datetime
        import html as _html
        summary = self.summary()
        skew = summary["straggler_skew"]
        refresh = (f"<meta http-equiv='refresh' content='{refresh_seconds}'>"
                   if refresh_seconds else "")
        gang_width = summary["gang_width"]
        gw_cell = "—" if gang_width is None else gang_width

        def cell(v):
            return v if v is not None else "—"

        rows = []
        for name, w in summary["workers"].items():
            flag = " &#9888; straggler" if w["straggler"] else ""
            style = " style='background:#fdecea'" if w["straggler"] else ""
            gen = w["generation"]
            if w["restarts"]:
                gen = f"{gen} (&#8635;{w['restarts']})"
            rows.append(
                f"<tr{style}><td>{_html.escape(name)}{flag}</td><td>{gen}</td>"
                f"<td>{w['steps']}</td><td>{w['iteration']}</td>"
                f"<td>{cell(w['median_step_ms'])}</td><td>{cell(w['last_step_ms'])}</td>"
                f"<td>{cell(w['mfu'])}</td><td>{cell(w['score'])}</td>"
                f"<td>{w['liveness_age_s']}</td><td>{gw_cell}</td></tr>")

        def stamp(t):
            return datetime.datetime.fromtimestamp(t).strftime("%H:%M:%S")

        notes = ""
        if summary["restarts"]:
            items = [f"<li>{stamp(r['time'])} — worker {_html.escape(str(r['worker']))} "
                     f"restarted: generation {r['from_generation']} &rarr; "
                     f"{r['to_generation']} (last pre-crash iteration {r['last_iteration']}); "
                     f"flight dumps ride the supervisor incident for generation "
                     f"{r['from_generation']}</li>" for r in summary["restarts"]]
            notes = "<h2>Restarts</h2><ul>" + "".join(items) + "</ul>"
        if summary["annotations"]:
            items = [f"<li>{stamp(a['time'])} — [{_html.escape(str(a['kind']))}] "
                     f"{_html.escape(str(a['message']))}</li>" for a in summary["annotations"]]
            notes += "<h2>Annotations</h2><ul>" + "".join(items) + "</ul>"
        return (
            f"<html><head><meta charset='utf-8'>{refresh}<title>Cluster telemetry</title>"
            "<style>body{font-family:sans-serif;margin:24px} "
            "table{border-collapse:collapse} td,th{border:1px solid #ccc;"
            "padding:4px 10px;text-align:right} th{background:#f5f5f5} "
            "td:first-child{text-align:left}</style></head><body>"
            f"<h1>Cluster telemetry</h1>"
            f"<p>{summary['n_workers']} worker(s) reporting; straggler skew "
            f"{'—' if skew is None else round(skew, 3)} (max worker median step time / "
            f"cluster median).</p>"
            "<table><tr><th>worker</th><th>generation</th><th>steps</th><th>iteration</th>"
            "<th>median step ms</th><th>last step ms</th><th>MFU</th><th>last score</th>"
            "<th>liveness age s</th><th>gang width</th></tr>"
            + "".join(rows) + "</table>" + notes + "</body></html>")
