"""Unified metrics registry: counters, gauges, histograms, Prometheus text
(port of ``deeplearning4j_tpu/obs/registry.py``).

One process-wide registry that every telemetry producer feeds: the
serving engine, the registry and router, the online loop and the health
monitor.  ``serve.server.ModelServer`` exposes it at ``GET /metrics`` in
Prometheus text exposition format.  The same sequence of events renders
the same text as the JAX package's registry.

Naming convention (enforced at registration)::

    tpudl_<area>_<name>

where ``<area>`` is one of the subsystem prefixes (``train``, ``device``,
``obs``, ``serve``, ``online``, ...) and counters end in ``_total``,
histograms/durations in ``_seconds`` (or ``_bytes``).  The catalog is
:func:`install_standard_metrics`; its names are the JAX package's.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Optional, Sequence

METRIC_NAME_RE = re.compile(r"^tpudl_[a-z0-9]+_[a-z][a-z0-9_]*[a-z0-9]$")

# latency buckets in seconds: µs-scale dispatch through minute-scale compiles
DEFAULT_TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                        0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                        10.0, 30.0, 60.0)
# byte-size buckets: 1 KiB .. 16 GiB in powers of 4
DEFAULT_BYTE_BUCKETS = tuple(float(1024 * 4 ** i) for i in range(13))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    """Base: name + help + Prometheus type string."""

    prom_type = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        # reentrant: the flight recorder's signal-path dump snapshots
        # metric values from the main thread, which may have been
        # interrupted while holding this very lock inside observe()/set()
        self._lock = threading.RLock()

    def render(self) -> list[str]:
        raise NotImplementedError


class Counter(Metric):
    prom_type = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self._value)}"]


class Gauge(Metric):
    prom_type = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self._value)}"]


class _LabeledMixin:
    """Shared child bookkeeping for labeled metrics.  A labeled metric
    owns one value per label-value tuple and renders one Prometheus
    series per child (never a bare unlabeled series — mixing the two
    under one name is invalid exposition format)."""

    label_names: tuple
    _children: dict

    def _key(self, labels: dict) -> tuple:
        # Prometheus client semantics: every declared label must be
        # supplied (a forgotten status=... must not mint an invisible
        # `status=""` series), and undeclared labels are a bug
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name} has labels {self.label_names}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.label_names)

    def labeled_value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)

    def child_values(self) -> dict:
        """Snapshot of every child as ``{label_tuple: value}`` (label
        values in declared order).  Readers that judge whole families —
        the SLO evaluator sweeping per-worker freshness gauges — use
        this instead of guessing label values one at a time."""
        with self._lock:
            return {k: (v.count if isinstance(v, Histogram) else v)
                    for k, v in self._children.items()}

    def _series(self, key: tuple) -> str:
        pairs = ",".join(f'{n}="{_escape_label(v)}"'
                         for n, v in zip(self.label_names, key))
        return f"{self.name}{{{pairs}}}"

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self._series(k)} {_fmt(v)}" for k, v in items]


class LabeledCounter(_LabeledMixin, Counter):
    """Counter with label dimensions, e.g.
    ``tpudl_serve_requests_total{status="ok"}``.  ``value`` is the total
    across every label combination."""

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ("status",)):
        super().__init__(name, help)
        self.label_names = tuple(label_names)
        self._children: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount
            self._value += amount


class LabeledGauge(_LabeledMixin, Gauge):
    """Gauge with label dimensions, e.g.
    ``tpudl_serve_model_version{model="mnist"}``.  ``value`` is the most
    recently set child value."""

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ("model",)):
        super().__init__(name, help)
        self.label_names = tuple(label_names)
        self._children: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)
            self._value = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount
            self._value = self._children[key]

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class LabeledHistogram(_LabeledMixin, Metric):
    """Histogram with label dimensions, e.g.
    ``tpudl_perf_step_seconds{program="train:..."}`` — one full
    bucket/sum/count series per label-value tuple.  ``count``/``sum``
    aggregate across every child (the unlabeled totals)."""

    prom_type = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 label_names: Sequence[str] = ("program",)):
        super().__init__(name, help)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = tuple(b)
        self.label_names = tuple(label_names)
        # child key → one plain Histogram; all bucket accounting lives
        # in Histogram so the two layouts can never diverge
        self._children: dict[tuple, "Histogram"] = {}

    def _child(self, key: tuple) -> "Histogram":
        child = self._children.get(key)
        if child is None:
            child = Histogram(self.name, self.help, self.buckets)
            self._children[key] = child
        return child

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._child(key)
        child.observe(value)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(c.count for c in self._children.values())

    @property
    def sum(self) -> float:
        with self._lock:
            return sum(c.sum for c in self._children.values())

    def labeled_count(self, **labels) -> int:
        with self._lock:
            child = self._children.get(self._key(labels))
        return child.count if child else 0

    def bucket_counts(self, **labels) -> dict:
        """Cumulative counts keyed by upper bound for ONE labeled series."""
        with self._lock:
            child = self._children.get(self._key(labels))
        if child is not None:
            return child.bucket_counts()
        out = {ub: 0 for ub in self.buckets}
        out[math.inf] = 0
        return out

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        lines = []
        for key, child in items:
            pairs = ",".join(f'{n}="{_escape_label(v)}"'
                             for n, v in zip(self.label_names, key))
            buckets, total, count = child._snapshot()
            for ub, cum in buckets.items():
                lines.append(f'{self.name}_bucket{{{pairs},le="{_fmt(ub)}"}} '
                             f'{cum}')
            lines.append(f"{self.name}_sum{{{pairs}}} {_fmt(total)}")
            lines.append(f"{self.name}_count{{{pairs}}} {count}")
        return lines


class Histogram(Metric):
    """Fixed-bucket histogram (cumulative buckets, Prometheus layout)."""

    prom_type = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = tuple(b)
        self._counts = [0] * (len(b) + 1)   # +1 for the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _snapshot(self) -> tuple[dict, float, int]:
        """(cumulative buckets, sum, count) under ONE lock acquisition —
        a scrape must never see count != the +Inf bucket."""
        out, cum = {}, 0
        with self._lock:
            for ub, c in zip(self.buckets, self._counts):
                cum += c
                out[ub] = cum
            out[math.inf] = cum + self._counts[-1]
            return out, self._sum, self._count

    def bucket_counts(self) -> dict:
        """Cumulative counts keyed by upper bound (Prometheus semantics)."""
        return self._snapshot()[0]

    def render(self) -> list[str]:
        buckets, total, count = self._snapshot()
        lines = []
        for ub, cum in buckets.items():
            lines.append(f'{self.name}_bucket{{le="{_fmt(ub)}"}} {cum}')
        lines.append(f"{self.name}_sum {_fmt(total)}")
        lines.append(f"{self.name}_count {count}")
        return lines


class MetricsRegistry:
    """Name → metric map with idempotent get-or-create registration.

    Re-registering a name returns the existing metric when the type
    matches (so module-level instrumentation is import-order free) and
    raises when it doesn't (two subsystems fighting over one name is a
    bug worth failing on)."""

    def __init__(self, validate_names: bool = True):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.RLock()   # signal-path dump may re-enter
        self.validate_names = validate_names

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> Metric:
        if self.validate_names and not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the tpudl_<area>_<name> "
                f"convention ({METRIC_NAME_RE.pattern})")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}")
                want = kwargs.get("buckets")
                if want is not None and tuple(sorted(
                        float(b) for b in want)) != existing.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.buckets}, requested "
                        f"{tuple(want)}")
                want_labels = kwargs.get("label_names")
                if want_labels is not None \
                        and tuple(want_labels) != existing.label_names:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.label_names}, requested "
                        f"{tuple(want_labels)}")
                return existing
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def labeled_counter(self, name: str, help: str = "",
                        label_names: Sequence[str] = ("status",)
                        ) -> LabeledCounter:
        return self._get_or_create(LabeledCounter, name, help,
                                   label_names=tuple(label_names))

    def labeled_gauge(self, name: str, help: str = "",
                      label_names: Sequence[str] = ("model",)
                      ) -> LabeledGauge:
        return self._get_or_create(LabeledGauge, name, help,
                                   label_names=tuple(label_names))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def labeled_histogram(self, name: str, help: str = "",
                          buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                          label_names: Sequence[str] = ("program",)
                          ) -> LabeledHistogram:
        return self._get_or_create(LabeledHistogram, name, help,
                                   buckets=buckets,
                                   label_names=tuple(label_names))

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {_escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.prom_type}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests isolate with this); returns
    the previous one."""
    global _default
    prev = _default
    _default = registry
    return prev


def install_standard_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """Register the framework's standard metric set (the catalog in
    docs/observability.md, under the JAX package's names) and return it
    keyed by name.  Idempotent, so the whole catalog is visible to the
    scrape endpoint however few of its producers have run."""
    r = registry or get_registry()
    metrics = [
        r.counter("tpudl_train_steps_total",
                  "Optimization steps completed across all trainers"),
        r.counter("tpudl_train_examples_total",
                  "Training examples consumed"),
        r.counter("tpudl_train_epochs_total", "Epochs completed"),
        r.histogram("tpudl_train_step_seconds",
                    "Wall time per training step (sync-inclusive when "
                    "tracing is on, dispatch-only otherwise)"),
        r.histogram("tpudl_train_epoch_seconds",
                    "Wall time per completed epoch (fit loop, feed "
                    "included)"),
        r.gauge("tpudl_train_compile_seconds",
                "Wall time of the most recent first-call (trace+compile) "
                "step through a jit boundary"),
        r.gauge("tpudl_train_last_score", "Most recent training loss"),
        r.counter("tpudl_train_recompiles_total",
                  "New XLA traces of trainer step functions (first "
                  "compile included; shape churn past step 1 means the "
                  "recompile guard is being bypassed)"),
        r.counter("tpudl_train_step_cache_hits_total",
                  "Compiled-step reuses served by train.step_cache"),
        r.counter("tpudl_train_step_cache_misses_total",
                  "Step builds admitted into train.step_cache"),
        r.counter("tpudl_compile_artifact_hits_total",
                  "Calls dispatched to an executable warm-loaded from "
                  "a checkpoint's compiled-artifact store (zero JIT on "
                  "the request path)"),
        r.counter("tpudl_compile_artifact_misses_total",
                  "Calls on a store-warmed program whose signature had "
                  "no artifact — fell back to live compilation"),
        r.counter("tpudl_compile_artifact_rejects_total",
                  "Artifacts refused at warm-load time (format/jax/"
                  "backend/donation mismatch or undeserializable "
                  "payload) — stale artifacts recompile, never corrupt"),
        r.counter("tpudl_compile_artifacts_baked_total",
                  "Programs AOT-compiled and serialized into a "
                  "checkpoint's artifact store"),
        r.counter("tpudl_compile_artifacts_loaded_total",
                  "Serialized executables deserialized into the "
                  "process warm pool"),
        r.histogram("tpudl_compile_bake_seconds",
                    "Wall time to AOT-lower, compile and serialize one "
                    "program into the artifact store"),
        r.histogram("tpudl_compile_warm_load_seconds",
                    "Wall time to warm-load a checkpoint zip's "
                    "artifacts (the 'deserialize and go' cold-start "
                    "cost)"),
        r.gauge("tpudl_compile_warm_programs",
                "Programs resident in the artifact warm pool after the "
                "most recent load"),
        r.histogram("tpudl_data_etl_wait_seconds",
                    "Consumer-side wait for the next ready batch "
                    "(DeviceFeeder / AsyncDataSetIterator queue get)"),
        r.gauge("tpudl_data_prefetch_depth",
                "Device-ready batches still queued after the most "
                "recent get (0 = consumer racing the producer)"),
        r.gauge("tpudl_device_hbm_bytes_in_use",
                "Device memory in use on local device 0 (memory_stats)"),
        r.gauge("tpudl_device_hbm_bytes_limit",
                "Device memory capacity on local device 0"),
        r.gauge("tpudl_device_hbm_peak_bytes",
                "Peak device memory in use on local device 0"),
        r.counter("tpudl_obs_records_total",
                  "Records written by MetricsWriter jsonl streams"),
        r.counter("tpudl_obs_stats_samples_total",
                  "On-device stats samples taken by StatsListener"),
        r.counter("tpudl_dcn_steps_total",
                  "Multi-slice DCN training steps (per local slice)"),
        r.counter("tpudl_dcn_wire_bytes_total",
                  "Compressed gradient bytes exchanged over DCN"),
        r.counter("tpudl_dcn_d2h_bytes_total",
                  "Device-to-host bytes for DCN message staging"),
        r.histogram("tpudl_dcn_exchange_seconds",
                    "Ring-exchange duration per slice step"),
        r.counter("tpudl_dcn_drained_exchanges_total",
                  "In-flight overlapped exchanges drained by finish()"),
        r.gauge("tpudl_parallel_mesh_devices",
                "Devices in the active data-parallel mesh"),
        r.gauge("tpudl_mesh_devices",
                "Total devices in the active unified-mesh layout"),
        r.labeled_gauge("tpudl_mesh_axis_size",
                        "Unified-mesh axis sizes of the active layout "
                        "(data/model/pipe/seq/expert)",
                        label_names=("axis",)),
        r.labeled_gauge("tpudl_mesh_layout_active",
                        "1 for the layout string a trainer activated "
                        "(dp2xtp2, ...)",
                        label_names=("layout",)),
        r.gauge("tpudl_mesh_collective_bytes",
                "Analytic per-step collective-traffic estimate for the "
                "active layout (MeshLayout.collective_bytes_per_step)"),
        r.counter("tpudl_parallel_avg_syncs_total",
                  "Parameter-averaging resyncs (averaging_frequency mode)"),
        r.counter("tpudl_parallel_pipeline_calls_total",
                  "pipeline_apply invocations (trace-time under jit)"),
        r.histogram("tpudl_bench_step_seconds",
                    "Steady-state step time measured by the bench harness"),
        r.counter("tpudl_resilience_attempts_total",
                  "Calls into retry-wrapped operations (first tries "
                  "included)"),
        r.counter("tpudl_resilience_retries_total",
                  "Retries after a transient failure (with_retries)"),
        r.counter("tpudl_resilience_giveups_total",
                  "Retry-wrapped operations that exhausted attempts/"
                  "deadline or hit a non-retryable error"),
        r.histogram("tpudl_resilience_backoff_seconds",
                    "Backoff slept between retry attempts"),
        r.counter("tpudl_resilience_checkpoint_writes_total",
                  "Durable (atomic + manifested) checkpoint zips "
                  "published"),
        r.histogram("tpudl_resilience_checkpoint_write_seconds",
                    "Wall time to serialize + fsync + publish one "
                    "checkpoint zip"),
        r.counter("tpudl_resilience_corrupt_checkpoints_total",
                  "Checkpoints skipped by discovery after failing "
                  "zip/manifest verification"),
        r.counter("tpudl_resilience_faults_injected_total",
                  "Faults fired by the active FaultPlan (test/drill "
                  "runs only)"),
        r.counter("tpudl_resilience_resumes_total",
                  "Trainer training-state restorations from a verified "
                  "checkpoint (resume_from / supervisor respawns)"),
        r.gauge("tpudl_resilience_resumed_iteration",
                "Iteration restored by the most recent resume (steps "
                "replayed = crash iteration minus this)"),
        r.counter("tpudl_resilience_gang_restarts_total",
                  "Supervised gang respawns after a worker death or "
                  "stall (ClusterSupervisor)"),
        r.histogram("tpudl_resilience_gang_mttr_seconds",
                    "Recovery time per gang incident: failure detection "
                    "to the first post-restart federated step"),
        r.labeled_counter("tpudl_serve_requests_total",
                          "Inference requests by terminal status "
                          "(ok/error/shed/expired/cancelled)",
                          ("status",)),
        r.counter("tpudl_serve_shed_total",
                  "Requests rejected immediately because the engine's "
                  "bounded queue was full (load shedding)"),
        r.counter("tpudl_serve_batches_total",
                  "Micro-batches dispatched by inference engines"),
        r.counter("tpudl_serve_recompiles_total",
                  "New CUDA graphs captured for serving forwards "
                  "(growth past one per shape bucket and precision "
                  "means the bucket set is churning)"),
        r.gauge("tpudl_serve_batch_size",
                "Rows in the most recently dispatched micro-batch "
                "(bucket-padded size)"),
        r.gauge("tpudl_serve_queue_depth",
                "Requests waiting in the engine queue after the most "
                "recent submit"),
        r.histogram("tpudl_serve_latency_seconds",
                    "End-to-end request latency (submit to result "
                    "ready, queue wait + batching delay + device time)"),
        r.labeled_gauge("tpudl_serve_model_version",
                        "Version currently serving per deployed model "
                        "name", ("model",)),
        r.counter("tpudl_serve_feedback_accepted_total",
                  "Feedback rows accepted into the spool by the HTTP "
                  "front-end (:feedback endpoint + labeled-predict tap)"),
        r.counter("tpudl_serve_feedback_rejected_total",
                  "Feedback rows refused by the HTTP front-end (bad "
                  "payload, unknown model, no spool configured) — spool "
                  "loss made visible"),
        r.counter("tpudl_serve_quantized_batches_total",
                  "Micro-batches dispatched by int8-quantized inference "
                  "engines (nn.quantize serve variants)"),
        r.gauge("tpudl_serve_quantized_weight_bytes",
                "Weight bytes (int8 payload + f32 scales) of the most "
                "recently deployed quantized model"),
        r.gauge("tpudl_serve_quantized_compression_ratio",
                "Full-precision weight bytes over quantized weight "
                "bytes for the most recent quantized deploy (~4x from "
                "f32, ~2x from bf16)"),
        r.gauge("tpudl_serve_quantized_max_abs_err",
                "Calibrated max abs output deviation of the quantized "
                "forward vs full precision (quantize calibration pass "
                "over the holdout iterator)"),
        r.counter("tpudl_serve_stage_reuse_total",
                  "Micro-batch flushes served from a REUSED continuous-"
                  "batching staging buffer (per-bucket state reuse "
                  "instead of per-flush re-allocation)"),
        r.labeled_counter("tpudl_serve_tenant_requests_total",
                          "Requests offered per tenant at the router's "
                          "admission control (X-Tenant)", ("tenant",)),
        r.labeled_counter("tpudl_serve_tenant_shed_total",
                          "Requests shed per tenant (token-bucket quota "
                          "exceeded, lane threshold, or fleet "
                          "saturation)", ("tenant",)),
        r.gauge("tpudl_router_replicas",
                "Replica engines currently serving behind the "
                "ReplicaRouter (moved by the autoscaler and manual "
                "scale calls)"),
        r.gauge("tpudl_router_queue_depth",
                "Aggregate requests waiting across all replica queues "
                "at the most recent router submit"),
        r.gauge("tpudl_router_replica_unready",
                "1 while some replica is mid-flip in a fan-out "
                "hot-swap (the rest of the fleet keeps serving; "
                "ready() stays true)"),
        r.labeled_counter("tpudl_router_dispatch_total",
                          "Requests dispatched per replica by the "
                          "least-queue-depth router", ("replica",)),
        r.labeled_counter("tpudl_router_shed_total",
                          "Admission sheds per priority lane (low-"
                          "priority lanes shed first as the aggregate "
                          "queue fills)", ("lane",)),
        r.counter("tpudl_router_swaps_total",
                  "Fan-out hot-swaps completed across the replica set "
                  "(deploys + rollbacks through the router door)"),
        r.counter("tpudl_router_scale_ups_total",
                  "Replicas added by autoscaling/heal/manual scale-up"),
        r.counter("tpudl_router_scale_downs_total",
                  "Replicas retired (always drained, never dropped) by "
                  "autoscaling or manual scale-down"),
        r.counter("tpudl_online_candidates_total",
                  "Fine-tune candidates the online loop produced "
                  "(gated + aborted)"),
        r.counter("tpudl_online_candidates_aborted_total",
                  "Candidate fine-tunes aborted by the attached "
                  "HealthMonitor before reaching the gate"),
        r.counter("tpudl_online_deploys_total",
                  "Candidates that passed the eval gate and hot-swapped "
                  "into serving"),
        r.counter("tpudl_online_refusals_total",
                  "Candidates the eval gate refused (regression, "
                  "non-finite score, failed verification)"),
        r.counter("tpudl_online_rollbacks_total",
                  "Automatic post-deploy rollbacks after a serve-metric "
                  "regression in the watch window"),
        r.gauge("tpudl_online_gate_delta",
                "Candidate minus incumbent gate-metric score of the "
                "most recent gate decision"),
        r.histogram("tpudl_online_gate_seconds",
                    "Wall time per gate evaluation (verify + score "
                    "candidate and incumbent + decide)"),
        r.counter("tpudl_online_spool_records_total",
                  "Feedback records durably appended to the spool"),
        r.counter("tpudl_online_spool_dropped_total",
                  "Feedback records lost to buffer overflow, retention "
                  "pruning, torn lines, or malformed payloads"),
        r.gauge("tpudl_online_spool_depth",
                "Spooled feedback records not yet assigned to a "
                "fine-tune round"),
        r.gauge("tpudl_online_staleness_seconds",
                "Age of the oldest feedback record no fine-tune round "
                "has consumed yet (how far behind live traffic the "
                "online loop runs)"),
        r.gauge("tpudl_perf_mfu",
                "Model FLOPs utilization of the most recent measured "
                "step: XLA cost_analysis FLOPs / step wall time / "
                "backend peak FLOP/s (obs.costmodel)"),
        r.gauge("tpudl_perf_hbm_util",
                "HBM-bandwidth utilization of the most recent measured "
                "step: cost_analysis bytes accessed / step wall time / "
                "backend peak bytes/s"),
        r.gauge("tpudl_perf_arith_intensity",
                "Arithmetic intensity (FLOPs per byte of memory "
                "traffic) of the most recently analyzed compiled "
                "program"),
        r.gauge("tpudl_perf_roofline_fraction",
                "Achieved FLOP/s as a fraction of the roofline ceiling "
                "at the program's arithmetic intensity "
                "(min(peak_flops, AI x peak_bw))"),
        r.gauge("tpudl_perf_peak_flops",
                "Backend peak FLOP/s assumed by the cost model "
                "(per-device; from the peak table)"),
        r.gauge("tpudl_perf_peak_hbm_bytes",
                "Backend peak memory bandwidth in bytes/s assumed by "
                "the cost model"),
        r.labeled_gauge("tpudl_perf_program_flops",
                        "cost_analysis FLOPs per execution of each "
                        "analyzed compiled program", ("program",)),
        r.labeled_gauge("tpudl_perf_program_bytes",
                        "cost_analysis bytes accessed per execution of "
                        "each analyzed compiled program", ("program",)),
        r.labeled_histogram("tpudl_perf_step_seconds",
                            "Measured wall time per execution of each "
                            "cost-model-analyzed program (the "
                            "denominator of MFU/HBM utilization)",
                            label_names=("program",)),
        r.counter("tpudl_cluster_records_pushed_total",
                  "Telemetry records delivered to the coordinator by "
                  "this worker's RemoteStatsRouter"),
        r.counter("tpudl_cluster_push_failures_total",
                  "Router push batches that exhausted their retries "
                  "(coordinator down/stalled)"),
        r.counter("tpudl_cluster_records_dropped_total",
                  "Telemetry records lost to router buffer overflow or "
                  "failed pushes (bounded loss, never an exception)"),
        r.counter("tpudl_cluster_records_ingested_total",
                  "Telemetry records accepted by this coordinator's "
                  "/remote/stats endpoint"),
        r.gauge("tpudl_cluster_workers",
                "Workers that have reported to this coordinator"),
        r.labeled_gauge("tpudl_cluster_worker_iteration",
                        "Most recent training iteration reported per "
                        "worker", ("worker",)),
        r.labeled_gauge("tpudl_cluster_worker_mfu",
                        "Most recent self-reported MFU per worker "
                        "(obs.costmodel via the router)", ("worker",)),
        r.labeled_gauge("tpudl_cluster_worker_last_score",
                        "Most recent training loss reported per worker",
                        ("worker",)),
        r.labeled_gauge("tpudl_cluster_worker_last_seen_time",
                        "Unix time of the last record (incl. heartbeats) "
                        "from each worker — liveness age = now - this",
                        ("worker",)),
        r.labeled_histogram("tpudl_cluster_step_seconds",
                            "Federated per-worker step wall time as "
                            "reported over the router",
                            label_names=("worker",)),
        r.counter("tpudl_cluster_stale_records_total",
                  "Records dropped at ingest because they carried a "
                  "pre-restart generation (a dead predecessor's "
                  "buffered telemetry)"),
        r.labeled_gauge("tpudl_cluster_worker_generation",
                        "Restart generation currently reporting per "
                        "worker (bumped by the ClusterSupervisor on "
                        "each respawn)", ("worker",)),
        r.counter("tpudl_health_checks_total",
                  "HealthMonitor check passes (loss stream + sampled "
                  "stats)"),
        r.labeled_counter("tpudl_health_anomalies_total",
                          "Health verdicts by kind (non_finite_loss/"
                          "loss_spike/grad_explosion/grad_vanish/"
                          "non_finite_grad/update_ratio/dead_units/"
                          "straggler)", ("kind",)),
        r.labeled_counter("tpudl_health_actions_total",
                          "Anomaly responses taken by action "
                          "(warn/dump/checkpoint/halt)", ("action",)),
        r.gauge("tpudl_health_loss_zscore",
                "Robust z-score (median/MAD) of the most recent loss "
                "against the rolling window"),
        r.counter("tpudl_slo_evaluations_total",
                  "SLO evaluator passes (every registered objective "
                  "judged once per pass)"),
        r.labeled_counter("tpudl_slo_breaches_total",
                          "Burn-rate breaches by objective (fired on "
                          "the healthy→breached transition, re-armed "
                          "when the burn clears)", ("slo",)),
        r.labeled_gauge("tpudl_slo_burn_rate",
                        "Worst-window error-budget burn rate per "
                        "objective (1.0 = burning exactly the budget; "
                        "the fast-window page threshold is 14.4)",
                        ("slo",)),
        r.labeled_gauge("tpudl_slo_budget_remaining",
                        "Fraction of the error budget left over the "
                        "longest configured window per objective "
                        "(1.0 = untouched, <=0 = exhausted)", ("slo",)),
        r.labeled_gauge("tpudl_slo_healthy",
                        "1 while the objective's burn is below every "
                        "window threshold, 0 while breached", ("slo",)),
        r.labeled_gauge("tpudl_elastic_pool_devices",
                        "Chips currently assigned to each tenant of the "
                        "DevicePoolArbiter's inventory (serve/train); "
                        "the sum is conserved across every flip",
                        ("owner",)),
        r.gauge("tpudl_elastic_gang_width",
                "Current training gang width (workers/devices) after "
                "the latest elastic grow/shrink"),
        r.counter("tpudl_elastic_borrows_total",
                  "Completed arbiter flips moving chips train -> serve "
                  "under sustained router queue pressure"),
        r.counter("tpudl_elastic_returns_total",
                  "Completed arbiter flips returning borrowed chips "
                  "serve -> train after pressure ebbed"),
        r.counter("tpudl_elastic_grows_total",
                  "Committed elastic gang grows (supervisor relaunch or "
                  "in-process Trainer.resize_mesh at a round boundary)"),
        r.counter("tpudl_elastic_shrinks_total",
                  "Committed elastic gang shrinks (arbiter borrows and "
                  "budget-driven degradation both count here)"),
        r.histogram("tpudl_elastic_flip_seconds",
                    "Wall time of one elastic flip: resize decision "
                    "begun -> resized gang up (supervisor), reshard + "
                    "step rebuild (in-process), or chip move "
                    "(arbiter) — the elastic MTTR"),
    ]
    return {m.name: m for m in metrics}


def record_device_memory(registry: Optional[MetricsRegistry] = None,
                         device=None) -> Optional[dict]:
    """Sample device memory into the device gauges from
    ``torch.cuda.memory_stats`` (in use, reserved limit, peak); returns
    the stats dict (None on the CPU, which has none)."""
    from deeplearning4j_tpu_torch.obs.tracing import device_memory_stats
    stats = device_memory_stats(device)
    if not stats:
        return None
    r = registry or get_registry()
    if "bytes_in_use" in stats:
        r.gauge("tpudl_device_hbm_bytes_in_use").set(stats["bytes_in_use"])
    if "bytes_limit" in stats:
        r.gauge("tpudl_device_hbm_bytes_limit").set(stats["bytes_limit"])
    if "peak_bytes_in_use" in stats:
        r.gauge("tpudl_device_hbm_peak_bytes").set(stats["peak_bytes_in_use"])
    return stats
