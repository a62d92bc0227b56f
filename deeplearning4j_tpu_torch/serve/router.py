"""Multi-replica router: one model, N engines, one front door (port of
``deeplearning4j_tpu/serve/router.py``).

One :class:`~deeplearning4j_tpu_torch.serve.engine.InferenceEngine` saturates
one device; traffic scale comes from running N replicas of the same
model behind a router (the TensorFlow-Serving "one model definition,
N replicated executors" shape, PAPERS.md).  :class:`ReplicaRouter`
spreads one :class:`~deeplearning4j_tpu_torch.serve.registry.ModelRegistry`
model across N replica engines on one host:

- **least-queue-depth dispatch** — every submit goes to the ready,
  healthy replica with the fewest waiting requests; a replica that
  sheds (:class:`~deeplearning4j_tpu_torch.serve.engine.Overloaded`) is
  retried against the next-least-loaded one, so a single hot replica
  never speaks for the fleet;
- **per-replica health** — a replica whose engine worker died or
  closed is routed around immediately (and replaced by the
  autoscaler's heal pass, :mod:`deeplearning4j_tpu_torch.serve.autoscale`);
- **admission control beyond binary shed** — priority lanes with
  per-lane shed thresholds (low-priority traffic sheds FIRST as the
  aggregate queue fills; interactive traffic holds on until the fleet
  is truly saturated) and per-tenant token-bucket quotas (a tenant
  above its rate gets :class:`QuotaExceeded` — still HTTP 429 — while
  every other tenant is untouched);
- **atomic fan-out hot-swap** — :meth:`ReplicaRouter.deploy` runs the
  verified load ONCE, then flips every replica onto the new net under
  the router lock (each old engine drains afterwards: zero dropped or
  garbled in-flight requests).  Only the replica being flipped is ever
  unready — :meth:`ready` (and therefore ``/healthz``) stays true
  through the whole fan-out, unlike a single-engine swap;
- **all-replica rollback** — :meth:`rollback` re-verifies the previous
  version's zip once and fans every replica back together.

Replica scale-up is **milliseconds, not a recapture**: every replica
engine shares the step-cached captured forward, so a new replica is a
worker thread plus a bounded queue.  On one card the replicas share one
net, hence one set of captured graphs: their forwards take turns on the
card (the captured step's lock), while batching, staging and the host
copies of each replica run in its own thread.

The router registers with the registry
(:meth:`ModelRegistry.attach_router`): the registry stays the verified
version book and the HTTP server keeps calling
``registry.predict_versioned`` — routed names dispatch here.  Direct
``registry.deploy`` on a routed name raises
:class:`~deeplearning4j_tpu_torch.serve.registry.RoutedModelError` at runtime
: the atomic fan-out
(here, or :class:`~deeplearning4j_tpu_torch.online.gate.GatedDeployer` above
it) is the only deploy door for a routed model.

Observability: the ``tpudl_router_*`` family (replica count, aggregate
queue depth, per-replica dispatches, per-lane sheds, swap/scale
events) and ``tpudl_serve_tenant_*`` (per-tenant request/shed
counters) — docs/serving.md "Scale-out" has the triage runbook.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.obs import flight_recorder
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.serve.engine import EngineClosed, InferenceEngine, Overloaded


class QuotaExceeded(Overloaded):
    """Request shed by a per-tenant token-bucket quota (not by load):
    the tenant is over its admitted rate while the fleet may be idle.
    An :class:`Overloaded` subclass so the HTTP layer's 429 mapping and
    existing retry semantics apply unchanged."""


@dataclasses.dataclass(frozen=True)
class Lane:
    """One priority lane.  ``shed_at`` is the aggregate queue-fill
    fraction (queued requests / total queue capacity across replicas)
    at which this lane starts shedding — lower-priority lanes carry
    lower thresholds, so under pressure they shed FIRST and the
    high-priority lane keeps its full queue budget."""

    name: str
    priority: int = 0          # 0 = most important (sheds last)
    shed_at: float = 1.0       # 1.0 = only shed when truly full


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Token-bucket quota for one tenant: ``rate`` requests/second
    sustained, ``burst`` requests of headroom."""

    rate: float
    burst: float


class _TokenBucket:
    __slots__ = ("tokens", "last")

    def __init__(self, burst: float, now: float):
        self.tokens = float(burst)
        self.last = now


class AdmissionControl:
    """Lane + quota policy evaluated before any replica is touched.

    ``lanes`` maps lane name → :class:`Lane`; requests without a lane
    (or with an unknown one) ride ``default_lane``.  ``quotas`` maps
    tenant → :class:`TenantQuota`; ``default_quota`` applies to tenants
    without an explicit row (None = unmetered).  Thread-safe: token
    buckets refill under a small lock, nothing blocks while holding it.
    """

    def __init__(self, lanes: Optional[Sequence[Lane]] = None,
                 default_lane: str = "default",
                 quotas: Optional[dict] = None,
                 default_quota: Optional[TenantQuota] = None):
        lanes = list(lanes) if lanes else [Lane("default", 0, 1.0)]
        self.lanes = {lane.name: lane for lane in lanes}
        if default_lane not in self.lanes:
            default_lane = min(self.lanes.values(),
                               key=lambda ln: ln.priority).name
        self.default_lane = default_lane
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        # bounded: with default_quota set, every distinct (attacker-
        # controlled) X-Tenant string would otherwise grow this forever;
        # evicting the oldest bucket refills that tenant to full burst
        # — a bounded generosity, never unbounded memory
        self.max_tracked_tenants = 1024
        self._buckets: dict[str, _TokenBucket] = {}
        self._lock = threading.Lock()

    def lane(self, name: Optional[str]) -> Lane:
        return self.lanes.get(name or "", self.lanes[self.default_lane])

    def take_token(self, tenant: Optional[str]) -> bool:
        """One token from ``tenant``'s bucket; True when admitted."""
        if tenant is None:
            return True
        quota = self.quotas.get(tenant, self.default_quota)
        if quota is None:
            return True
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= self.max_tracked_tenants:
                    self._buckets.pop(next(iter(self._buckets)))
                bucket = self._buckets[tenant] = _TokenBucket(
                    quota.burst, now)
            bucket.tokens = min(float(quota.burst),
                                bucket.tokens
                                + (now - bucket.last) * quota.rate)
            bucket.last = now
            if bucket.tokens < 1.0:
                return False
            bucket.tokens -= 1.0
            return True


class _Replica:
    """One engine slot.  ``ready`` gates dispatch (False only while
    this replica's engine is being flipped or it is draining out);
    ``retired`` marks a slot removed from the set so a concurrent
    fan-out will not flip — and thereby leak — a fresh engine into it."""

    __slots__ = ("id", "engine", "version", "ready", "retired")

    def __init__(self, rid: int, engine: InferenceEngine, version: int):
        self.id = rid
        self.engine = engine
        self.version = version
        self.ready = True
        self.retired = False

    def stats(self) -> dict:
        return {"id": self.id, "version": self.version,
                "ready": self.ready, "healthy": self.engine.healthy,
                "queue_depth": self.engine.queue_depth}


class ReplicaRouter:
    """Least-queue-depth front door over N replicas of one model.

    ``registry`` must already hold a deployed ``name`` (the verified
    door stays the only way a model enters the system); construction
    attaches the router — the registry's own engine is drained and the
    router's replica set takes over serving.  ``min_replicas`` /
    ``max_replicas`` bound what the autoscaler (or manual
    :meth:`add_replica` / :meth:`retire_replica`) may do.
    """

    def __init__(self, registry, name: str, replicas: int = 1,
                 min_replicas: int = 1, max_replicas: int = 8,
                 admission: Optional[AdmissionControl] = None,
                 **engine_kw):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, "
                             f"got {min_replicas}..{max_replicas}")
        replicas = max(min_replicas, min(int(replicas), max_replicas))
        entry = registry.get(name)       # raises KeyError when undeployed
        if entry.engine is None:
            raise RuntimeError(f"model {name!r} has no live engine to "
                               f"build replicas from")
        self.registry = registry
        self.name = name
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.admission = admission or AdmissionControl()
        self.engine_kw = {**getattr(registry, "engine_defaults", {}),
                          **engine_kw}
        # per-tenant metric labels are bounded: the X-Tenant header is
        # attacker-controlled, and labeled-counter children are never
        # evicted — beyond the cap, unknown tenants aggregate under
        # "__other__" (explicitly-quota'd tenants always keep their own)
        self._tenant_lock = threading.Lock()
        self._tenant_labels: set[str] = set(self.admission.quotas)
        self._lock = threading.Lock()     # replica set + version pointer
        self._net = entry.engine.model
        self._precision = entry.precision
        self._path = entry.path
        self._version = entry.version
        self._replicas: tuple[_Replica, ...] = ()
        for _ in range(replicas):
            self._replicas = self._replicas + (self._new_replica(),)
        self._closed = False
        get_registry().gauge("tpudl_router_replicas").set(replicas)
        registry.attach_router(name, self)

    # ------------------------------------------------------------ replicas
    def _new_replica(self) -> _Replica:
        """Build one replica engine from the current net — cheap: the
        captured forward comes from the process-wide step cache, so this
        is a thread + a queue, not a capture.
        Ids are the smallest free slot (bounded by ``max_replicas``):
        a long-lived autoscaler churning replicas must not mint an
        unbounded stream of ``replica=`` metric label values."""
        used = {r.id for r in self._replicas}
        rid = next(i for i in range(len(used) + 1) if i not in used)
        engine = InferenceEngine(self._net, name=f"{self.name}-r{rid}",
                                 **self.engine_kw)
        engine.precision = self._precision
        return _Replica(rid, engine, self._version)

    def add_replica(self) -> bool:
        """Scale up by one (False at ``max_replicas`` or after close)."""
        with self._lock:
            if self._closed or len(self._replicas) >= self.max_replicas:
                return False
            rep = self._new_replica()
            self._replicas = self._replicas + (rep,)
            count = len(self._replicas)
        reg = get_registry()
        reg.gauge("tpudl_router_replicas").set(count)
        reg.counter("tpudl_router_scale_ups_total").inc()
        flight_recorder.record("router_scale", model=self.name, up=True,
                               replicas=count, replica=rep.id)
        return True

    def retire_replica(self, replica_id: Optional[int] = None) -> bool:
        """Scale down by one — ALWAYS drains: the retiring replica stops
        receiving new dispatches, then everything it already queued is
        served before its engine goes away.  False at ``min_replicas``
        (unless ``replica_id`` names an unhealthy replica being healed)
        or when the id is unknown."""
        with self._lock:
            victim = None
            if replica_id is None:
                candidates = [r for r in self._replicas if r.ready]
                if len(self._replicas) <= self.min_replicas:
                    return False
                if candidates:
                    # least-loaded ready replica drains fastest
                    victim = min(candidates,
                                 key=lambda r: r.engine.queue_depth)
            else:
                victim = next((r for r in self._replicas
                               if r.id == replica_id), None)
                if victim is None:
                    return False
                if len(self._replicas) <= self.min_replicas \
                        and victim.engine.healthy:
                    return False
            if victim is None:
                return False
            victim.ready = False
            victim.retired = True
            self._replicas = tuple(r for r in self._replicas
                                   if r is not victim)
            count = len(self._replicas)
        victim.engine.shutdown(drain=True)      # outside the lock
        reg = get_registry()
        reg.gauge("tpudl_router_replicas").set(count)
        reg.counter("tpudl_router_scale_downs_total").inc()
        flight_recorder.record("router_scale", model=self.name, up=False,
                               replicas=count, replica=victim.id)
        return True

    def heal(self) -> int:
        """Replace replicas whose engine died (per-replica health):
        each unhealthy slot is retired (drained — a dead worker has
        nothing queued that can complete, but a merely-closed engine
        does) and a fresh replica joins.  The replacement is added
        BEFORE the sick one retires when capacity allows — on a
        min_replicas=1 fleet the retire's drain window must not leave
        zero serving replicas.  Returns replicas replaced."""
        with self._lock:
            sick = [r for r in self._replicas
                    if not r.retired and not r.engine.healthy]
        replaced = 0
        for rep in sick:
            added = self.add_replica()     # replacement serves first
            if not self.retire_replica(rep.id):
                if added:                  # another healer got it first
                    self.retire_replica()  # keep the size steady
                continue
            if not added:                  # was at max_replicas: the
                self.add_replica()         # retire just freed a slot
            replaced += 1
        return replaced

    # ------------------------------------------------------------ dispatch
    @property
    def replicas(self) -> int:
        return len(self._replicas)

    def replica_stats(self) -> list[dict]:
        return [r.stats() for r in self._replicas]

    @property
    def queue_depth(self) -> int:
        """Aggregate requests waiting across the replica set."""
        return sum(r.engine.queue_depth for r in self._replicas)

    def queue_fill(self) -> float:
        """Aggregate queue-fill fraction in [0, 1] — the autoscaler's
        and the lane-shed policy's shared pressure signal."""
        reps = self._replicas
        capacity = sum(r.engine.queue_limit for r in reps)
        if capacity <= 0:
            return 1.0
        return min(1.0, self.queue_depth / capacity)

    def ready(self) -> bool:
        """True while at least one replica can serve — a fan-out swap
        or a single replica draining never turns the front door away
        (the per-replica ``ready`` flags carry the fine-grained state,
        ``replica_stats()``)."""
        return any(r.ready and r.engine.healthy for r in self._replicas)

    def _tenant_label(self, tenant: str) -> str:
        """The metric label for ``tenant`` — itself below the cap,
        ``__other__`` beyond it (cardinality stays bounded no matter
        what the header says)."""
        with self._tenant_lock:
            if tenant in self._tenant_labels:
                return tenant
            if len(self._tenant_labels) < 64:
                self._tenant_labels.add(tenant)
                return tenant
        return "__other__"

    def _shed(self, lane: Lane, tenant: Optional[str], reason: str):
        reg = get_registry()
        reg.labeled_counter("tpudl_router_shed_total",
                            label_names=("lane",)).inc(lane=lane.name)
        if tenant is not None:
            reg.labeled_counter("tpudl_serve_tenant_shed_total",
                                label_names=("tenant",)).inc(
                tenant=self._tenant_label(tenant))
        if reason == "quota":
            raise QuotaExceeded(
                f"tenant {tenant!r} is over its token-bucket quota on "
                f"model {self.name!r}")
        raise Overloaded(
            f"model {self.name!r}: {reason} (lane {lane.name!r}, "
            f"{self.replicas} replicas)")

    def submit(self, x, mask=None, deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None,
               lane: Optional[str] = None) -> tuple[Future, int]:
        """Admit + dispatch one request; returns ``(future, version)``
        with the version of the replica that will answer.  Sheds with
        :class:`QuotaExceeded` (tenant over rate) or
        :class:`Overloaded` (lane threshold hit, or every replica
        full)."""
        reg = get_registry()
        lane_obj = self.admission.lane(lane)
        if tenant is not None:
            reg.labeled_counter("tpudl_serve_tenant_requests_total",
                                label_names=("tenant",)).inc(
                tenant=self._tenant_label(tenant))
        if not self.admission.take_token(tenant):
            self._shed(lane_obj, tenant, "quota")
        fill = self.queue_fill()
        reg.gauge("tpudl_router_queue_depth").set(self.queue_depth)
        if fill >= lane_obj.shed_at:
            self._shed(lane_obj, tenant,
                       f"lane shed at {fill:.0%} aggregate queue fill "
                       f">= shed_at {lane_obj.shed_at:.0%}")
        for _ in range(8):
            with self._lock:
                # (engine, version, id) captured TOGETHER under the
                # lock: a fan-out flip between snapshot and submit must
                # not let a request served by the old engine (its drain
                # completes it on the old weights) get attributed the
                # NEW version — the engine we submit to and the version
                # we report are one pair
                order = sorted(
                    ((r.engine, r.version, r.id)
                     for r in self._replicas
                     if r.ready and r.engine.healthy),
                    key=lambda ev: ev[0].queue_depth)
            if not order:
                break
            closed = False
            for engine, version, rid in order:   # least queue depth first
                try:
                    future = engine.submit(
                        x, mask=mask, deadline_ms=deadline_ms,
                        trace_id=trace_id)
                except Overloaded:
                    continue       # try the next-least-loaded replica
                except EngineClosed:
                    closed = True  # raced a flip/retire: fresh snapshot
                    break
                reg.labeled_counter("tpudl_router_dispatch_total",
                                    label_names=("replica",)).inc(
                    replica=f"r{rid}")
                return future, version
            if not closed:        # every live replica is genuinely full
                self._shed(lane_obj, tenant, "all replica queues full")
        self._shed(lane_obj, tenant, "no serving replica available")

    def predict_versioned(self, x, mask=None,
                          deadline_ms: Optional[float] = None,
                          timeout_s: Optional[float] = None,
                          trace_id: Optional[str] = None,
                          tenant: Optional[str] = None,
                          lane: Optional[str] = None):
        future, version = self.submit(x, mask=mask, deadline_ms=deadline_ms,
                                      trace_id=trace_id, tenant=tenant,
                                      lane=lane)
        return future.result(timeout=timeout_s), version

    def predict(self, x, mask=None, deadline_ms: Optional[float] = None,
                timeout_s: Optional[float] = None,
                trace_id: Optional[str] = None,
                tenant: Optional[str] = None, lane: Optional[str] = None):
        return self.predict_versioned(
            x, mask=mask, deadline_ms=deadline_ms, timeout_s=timeout_s,
            trace_id=trace_id, tenant=tenant, lane=lane)[0]

    # ----------------------------------------------------------- fan-out
    def _fan_out(self, net, version: int, precision: str) -> None:
        """Flip every replica onto ``net``.  The version pointer and
        each engine reference flip under the router lock (new replicas
        added concurrently are born on the new net); the drained old
        engines finish their queued work OUTSIDE the lock — zero
        dropped, zero garbled, and only the replica mid-flip is ever
        unready."""
        reg = get_registry()
        unready_g = reg.gauge("tpudl_router_replica_unready")
        drains: list[InferenceEngine] = []
        with self._lock:
            self._net = net
            self._version = version
            self._precision = precision
            for rep in self._replicas:
                if rep.retired:
                    continue
                rep.ready = False
                unready_g.set(1)
                old = rep.engine
                rep.engine = InferenceEngine(
                    net, name=f"{self.name}-r{rep.id}", **self.engine_kw)
                rep.engine.precision = precision
                rep.version = version
                rep.ready = True
                unready_g.set(0)
                drains.append(old)
        for old in drains:
            old.shutdown(drain=True)

    def deploy(self, path: str, precision: Optional[str] = None,
               calibration=None, bake_artifacts: bool = False,
               **engine_kw):
        """THE deploy door for a routed model: one verified load
        (corrupt zips are refused before any replica flips — the whole
        fleet keeps serving the incumbent), then an atomic fan-out
        hot-swap across every replica.  Returns the registry's new
        :class:`~deeplearning4j_tpu_torch.serve.registry.ModelVersion` row.
        Route gated deploys through
        :class:`~deeplearning4j_tpu_torch.online.gate.GatedDeployer`, which
        calls this when a router is attached."""
        from deeplearning4j_tpu_torch.serve.registry import load_for_serving
        if engine_kw:
            self.engine_kw = {**self.engine_kw, **engine_kw}
        net, precision = load_for_serving(
            path, precision=precision, calibration=calibration,
            bake_artifacts=bake_artifacts,
            device=getattr(self.registry, "device", self._net.device))
        entry = self.registry.record_routed_version(self.name, path,
                                                    precision)
        t0 = time.perf_counter()
        self._fan_out(net, entry.version, precision)
        self._path = path
        reg = get_registry()
        reg.counter("tpudl_router_swaps_total").inc()
        flight_recorder.record(
            "router_swap", model=self.name, version=entry.version,
            replicas=self.replicas, precision=precision,
            fan_out_ms=round(1e3 * (time.perf_counter() - t0), 3))
        return entry

    def rollback(self):
        """All replicas back together: the newest retired version's zip
        is re-verified ONCE and fanned across the whole replica set as
        a new version number (the single-engine registry rollback
        contract, fleet-wide)."""
        previous = self.registry.previous_version(self.name)
        if previous is None:
            raise LookupError(f"model {self.name!r} has no previous "
                              f"version to roll back to")
        return self.deploy(previous.path, precision=previous.precision)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Drain and retire every replica (undeploy/shutdown path)."""
        with self._lock:
            self._closed = True
            reps = self._replicas
            for rep in reps:
                rep.ready = False
                rep.retired = True
            self._replicas = ()
        for rep in reps:
            rep.engine.shutdown(drain=True)
        get_registry().gauge("tpudl_router_replicas").set(0)

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
