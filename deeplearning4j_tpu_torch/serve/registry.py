"""Versioned model registry: verified loads, atomic hot-swap, rollback
(port of ``deeplearning4j_tpu/serve/registry.py``).

Models enter the registry ONLY through the verified checkpoint path
(:func:`deeplearning4j_tpu_torch.io.model_serializer.restore_model`,
which replays zip CRCs + manifest sha256 digests): a truncated or
bit-rotted zip raises
:class:`~deeplearning4j_tpu_torch.resilience.checkpoint.CheckpointCorruptError`
at :meth:`ModelRegistry.deploy` time, *before* anything is swapped —
the currently-serving version keeps serving.

Hot-swap protocol (``deploy`` onto an existing name):

1. load + verify the new zip onto the registry's device, build its
   :class:`InferenceEngine` (a same-architecture swap reuses the
   step-cached captured forward and its graphs);
2. flip the current-version pointer — new requests route to the new
   engine atomically;
3. drain the old engine (everything already queued completes on the
   OLD version — zero dropped or garbled in-flight requests), then
   retire it.

``rollback`` re-deploys the previous version's zip through the same
verified path (the file is re-verified — disk may have rotted since),
producing a NEW version number, k8s-rollout-undo style.

Readiness: :meth:`ready` is False while any swap is in flight — the
HTTP server's ``/healthz`` turns 503 so a load balancer steers traffic
away during the flip window.

The registry loads onto ``device`` (the card unless the caller says
``device="cpu"``), and each engine serves on its net's device.  Not
ported yet: the compiled-artifact store (the JAX package's
``train/artifact_store.py``), so ``bake_artifacts=True`` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, Optional

from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.serve.engine import EngineClosed, InferenceEngine

SERVING = "serving"
RETIRED = "retired"


class RoutedModelError(RuntimeError):
    """Direct ``ModelRegistry.deploy`` on a router-managed model: the
    registry's single-engine swap would bypass the router's atomic
    fan-out, leaving N replicas serving a version the registry no
    longer records.  Deploy through
    :meth:`~deeplearning4j_tpu_torch.serve.router.ReplicaRouter.deploy` (or
    :class:`~deeplearning4j_tpu_torch.online.gate.GatedDeployer`, which fans
    out automatically)."""


def _apply_precision(net, precision: Optional[str], calibration):
    """Resolve a deploy's precision request.  ``None``/``"bf16"``/
    ``"f32"`` serve the net exactly as loaded; ``"int8"`` post-training-
    quantizes it (``nn.quantize``) and stamps the
    ``tpudl_serve_quantized_*`` gauges from the quantization report."""
    if precision in (None, "bf16", "f32", "fp32", "float32"):
        return net, (precision or "bf16")
    if precision != "int8":
        raise ValueError(f"unknown deploy precision {precision!r}; "
                         f"expected 'int8', 'bf16' or 'f32'")
    from deeplearning4j_tpu_torch.nn import quantize
    from deeplearning4j_tpu_torch.obs import flight_recorder
    qnet = quantize.quantize_net(net, calibration=calibration)
    report = qnet.quantization_
    reg = get_registry()
    reg.gauge("tpudl_serve_quantized_weight_bytes").set(
        report.quantized_weight_bytes)
    reg.gauge("tpudl_serve_quantized_compression_ratio").set(
        report.compression_ratio)
    # always write the gauge: an uncalibrated deploy (rollbacks forward
    # precision but never calibration) must read as unknown (NaN), not
    # as the PREVIOUS model's deviation band
    reg.gauge("tpudl_serve_quantized_max_abs_err").set(
        report.max_abs_err if report.max_abs_err is not None
        else float("nan"))
    flight_recorder.record("serve_quantize", **report.to_dict())
    return qnet, "int8"


def load_for_serving(path: str, precision: Optional[str] = None,
                     calibration=None, bake_artifacts: bool = False,
                     device: Any = DEFAULT_DEVICE):
    """The shared serving load path of :meth:`ModelRegistry.deploy` and
    :meth:`~deeplearning4j_tpu_torch.serve.router.ReplicaRouter.deploy`:
    verified restore onto ``device`` (a torn zip raises
    ``CheckpointCorruptError`` before anything serves) and precision
    resolve (``nn.quantize`` for int8).  Returns ``(net, precision)``.
    ``bake_artifacts=True`` raises: the port has no compiled-artifact
    store yet."""
    if bake_artifacts:
        raise NotImplementedError(
            "bake_artifacts=True needs the compiled-artifact store "
            "(train/artifact_store.py), which is not ported yet")
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    net = restore_model(path, load_updater=False, device=device)
    return _apply_precision(net, precision, calibration)


@dataclasses.dataclass
class ModelVersion:
    """One deployed (name, version): the loaded net rides inside the
    engine; retired versions keep only their zip path (and precision —
    a rollback must restore the variant that actually served, not
    silently change precision)."""

    name: str
    version: int
    path: str
    status: str
    deployed_at: float
    engine: Optional[InferenceEngine] = None
    precision: str = "bf16"

    def to_dict(self) -> dict:
        return {"name": self.name, "version": self.version,
                "path": self.path, "status": self.status,
                "deployed_at": self.deployed_at,
                "precision": self.precision}


class ModelRegistry:
    """Name → current :class:`ModelVersion` map with swap/rollback.

    ``device`` is where deployed zips load (and so where their engines
    serve): the card by default, raising without one; ``device="cpu"``
    serves on the CPU.  ``engine_defaults`` (max_batch, max_latency_ms,
    queue_limit, buckets, bucketing) apply to every deploy unless
    overridden per call."""

    def __init__(self, device: Any = DEFAULT_DEVICE, **engine_defaults):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._current: dict[str, ModelVersion] = {}
        self._history: dict[str, list[ModelVersion]] = {}
        self._next_version: dict[str, int] = {}
        self._routers: dict[str, object] = {}
        self._swaps_in_flight = 0
        self.engine_defaults = dict(engine_defaults)

    # ---------------------------------------------------------- swaps
    @contextlib.contextmanager
    def _swap(self) -> Iterator[None]:
        """Readiness window: /healthz reports 503 while any swap runs."""
        with self._lock:
            self._swaps_in_flight += 1
        try:
            yield
        finally:
            with self._lock:
                self._swaps_in_flight -= 1

    def ready(self) -> bool:
        with self._lock:
            if self._swaps_in_flight != 0:
                return False
            routers = list(self._routers.values())
        # a routed model's fan-out swap keeps ready() TRUE (only the
        # replica mid-flip is unready); false here only when a router
        # has NO serving replica at all
        return all(router.ready() for router in routers)

    # --------------------------------------------------------- routers
    def attach_router(self, name: str, router) -> None:
        """Hand ``name``'s serving over to a
        :class:`~deeplearning4j_tpu_torch.serve.router.ReplicaRouter`: the
        registry's own engine is drained (the router's replica set was
        built from its net) and subsequent predicts dispatch through
        the router.  The registry stays the verified version book —
        ``deploy`` on a routed name raises :class:`RoutedModelError`
        (the router, or the gate above it, is the fan-out door)."""
        with self._lock:
            entry = self._current.get(name)
            if entry is None:
                raise KeyError(f"no model deployed under {name!r}")
            self._routers[name] = router
            engine, entry.engine = entry.engine, None
        if engine is not None:
            engine.shutdown(drain=True)

    def detach_router(self, name: str):
        with self._lock:
            return self._routers.pop(name, None)

    def router_for(self, name: str):
        with self._lock:
            return self._routers.get(name)

    def previous_version(self, name: str) -> Optional[ModelVersion]:
        """Newest retired version (the rollback target), or None."""
        with self._lock:
            history = self._history.get(name, [])
            return next((mv for mv in reversed(history)
                         if mv.status == RETIRED), None)

    def record_routed_version(self, name: str, path: str,
                              precision: str) -> ModelVersion:
        """Version bookkeeping for a router fan-out deploy: the router
        owns the engines, the registry records the flip — one new
        ``ModelVersion`` (engine-less), the old one retired, the
        version gauge moved."""
        with self._lock:
            version = self._next_version.get(name, 0) + 1
            self._next_version[name] = version
            entry = ModelVersion(name, version, str(path), SERVING,
                                 time.time(), None, precision=precision)
            old = self._current.get(name)
            self._current[name] = entry
            self._history.setdefault(name, []).append(entry)
            if old is not None:
                old.status = RETIRED
        get_registry().labeled_gauge("tpudl_serve_model_version").set(
            version, model=name)
        return entry

    # --------------------------------------------------------- deploy
    def deploy(self, name: str, path: str, precision: Optional[str] = None,
               calibration=None, bake_artifacts: bool = False,
               **engine_kw) -> ModelVersion:
        """Load ``path`` through the verified serializer and make it the
        current version of ``name``.  Raises ``CheckpointCorruptError``
        (corrupt zip) or the serializer's errors WITHOUT touching the
        currently-serving version.

        ``bake_artifacts=True`` raises: warm starts from a
        compiled-artifact store are not ported yet.

        ``precision="int8"`` post-training-quantizes the verified load
        (``nn.quantize``: per-channel int8 weights, activations stay on
        the policy compute dtype) before the engine is built — the
        quantized variant shares the step-cached forward and bucket set
        with its full-precision sibling (each precision with graphs of
        its own), so swapping precisions on one architecture captures
        nothing new once both are warm.
        ``calibration`` (optional DataSetIterator) runs the quantize
        calibration pass and stamps the deviation-band gauges.  NOTE:
        an accuracy gate is deliberately NOT applied here — route
        quantized deploys through ``online.gate.GatedDeployer`` so a
        quantization that costs accuracy is refused, not served.

        A name managed by a :class:`~deeplearning4j_tpu_torch.serve.router.
        ReplicaRouter` refuses this path with :class:`RoutedModelError`
        — the router's fan-out deploy (or the gate above it) is the
        only door that reaches every replica atomically.
        """
        if self.router_for(name) is not None:
            raise RoutedModelError(
                f"model {name!r} is router-managed: deploy through "
                f"its ReplicaRouter (or GatedDeployer) so the swap "
                f"fans out to every replica")
        # verified load happens OUTSIDE the swap window: readiness only
        # flips for the engine-build + pointer-flip + drain
        kw = {**self.engine_defaults, **engine_kw}
        net, precision = load_for_serving(
            path, precision=precision, calibration=calibration,
            bake_artifacts=bake_artifacts, device=self.device)
        with self._swap():
            engine = InferenceEngine(net, name=name, **kw)
            with self._lock:
                version = self._next_version.get(name, 0) + 1
                self._next_version[name] = version
                entry = ModelVersion(name, version, str(path), SERVING,
                                     time.time(), engine,
                                     precision=precision)
                old = self._current.get(name)
                self._current[name] = entry
                self._history.setdefault(name, []).append(entry)
            if old is not None:
                # in-flight requests complete on the old version, then
                # it retires (its net is released with the engine)
                old.engine.shutdown(drain=True)
                old.status = RETIRED
                old.engine = None
        get_registry().labeled_gauge("tpudl_serve_model_version").set(
            version, model=name)
        return entry

    def rollback(self, name: str) -> ModelVersion:
        """Redeploy the newest retired version's zip (re-verified, same
        precision it served at) as a new version number.  On a routed
        name this DELEGATES to the router — an emergency path must
        never bypass the fan-out, so every replica rolls back together
        (``DeployWatch`` stays router-agnostic)."""
        router = self.router_for(name)
        if router is not None:
            return router.rollback()
        previous = self.previous_version(name)
        if previous is None:
            raise LookupError(f"model {name!r} has no previous version "
                              f"to roll back to")
        return self.deploy(name, previous.path,
                           precision=previous.precision)

    def undeploy(self, name: str) -> None:
        """Remove ``name`` entirely (drains its engine — or its whole
        replica set when routed)."""
        router = self.detach_router(name)
        with self._lock:
            entry = self._current.pop(name, None)
        if router is not None:
            router.close()
        if entry is not None and entry.engine is not None:
            entry.engine.shutdown(drain=True)
        if entry is not None:
            entry.status = RETIRED
            entry.engine = None

    def close(self) -> None:
        for name in list(self._current):
            self.undeploy(name)

    # ---------------------------------------------------------- lookup
    def get(self, name: str) -> ModelVersion:
        with self._lock:
            entry = self._current.get(name)
        if entry is None:
            raise KeyError(f"no model deployed under {name!r}")
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._current)

    def models(self) -> list[dict]:
        """Status rows for ``GET /v1/models``."""
        with self._lock:
            current = dict(self._current)
            history = {n: list(h) for n, h in self._history.items()}
        rows = []
        for name in sorted(current):
            row = current[name].to_dict()
            row["history"] = [
                {"version": mv.version, "status": mv.status}
                for mv in history.get(name, [])]
            router = self.router_for(name)
            if router is not None:
                row["replicas"] = router.replica_stats()
            rows.append(row)
        return rows

    # --------------------------------------------------------- predict
    def predict(self, name: str, x, mask=None,
                deadline_ms: Optional[float] = None,
                timeout_s: Optional[float] = None,
                trace_id: Optional[str] = None,
                tenant: Optional[str] = None,
                lane: Optional[str] = None):
        """Route one request to the current version of ``name``.  A
        submit that races a hot-swap's drain retries against the freshly
        flipped engine — callers never observe the swap as an error."""
        return self.predict_versioned(name, x, mask=mask,
                                      deadline_ms=deadline_ms,
                                      timeout_s=timeout_s,
                                      trace_id=trace_id,
                                      tenant=tenant, lane=lane)[0]

    def predict_versioned(self, name: str, x, mask=None,
                          deadline_ms: Optional[float] = None,
                          timeout_s: Optional[float] = None,
                          trace_id: Optional[str] = None,
                          tenant: Optional[str] = None,
                          lane: Optional[str] = None):
        """Like :meth:`predict`, but returns ``(outputs, version)`` with
        the version of the entry whose engine actually answered — the
        truthful attribution during a swap window, where the *current*
        version may already be newer than the one that served.
        ``trace_id`` propagates into the engine's serve span / flight
        ring (the ``X-Trace-Id`` path).  ``tenant``/``lane`` feed the
        router's admission control on routed names (token-bucket quota
        + priority-lane shed) and are ignored for single-engine
        models."""
        router = self.router_for(name)
        if router is not None:
            return router.predict_versioned(
                x, mask=mask, deadline_ms=deadline_ms,
                timeout_s=timeout_s, trace_id=trace_id,
                tenant=tenant, lane=lane)
        for _ in range(8):
            entry = self.get(name)
            engine = entry.engine
            if engine is None:          # retired between lookup and read
                continue
            try:
                out = engine.predict(x, mask=mask, deadline_ms=deadline_ms,
                                     timeout_s=timeout_s, trace_id=trace_id)
                return out, entry.version
            except EngineClosed:
                continue                # swap drained this engine; refetch
        raise EngineClosed(
            f"model {name!r}: engine kept closing across retries")
