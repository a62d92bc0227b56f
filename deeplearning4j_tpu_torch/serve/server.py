"""HTTP front-end for the inference engine, stdlib only (port of
``deeplearning4j_tpu/serve/server.py``: the same routes, JSON bodies and
status codes).

A ``ThreadingHTTPServer`` with a closure handler, no new dependencies.
Endpoints (TF-Serving-shaped paths):

- ``POST /v1/models/<name>:predict`` — body ``{"instances": [...],
  "deadline_ms": optional}`` → ``{"predictions": [...],
  "model_version": n}``.  Error mapping: unknown model → 404, bad
  JSON/payload → 400, :class:`~deeplearning4j_tpu_torch.serve.engine.
  Overloaded` → 429 (load shed — retry against another replica),
  deadline/timeout → 504, anything else → 500.  ``X-Tenant`` and
  ``X-Lane`` request headers (or ``"tenant"``/``"lane"`` body fields)
  feed the :class:`~deeplearning4j_tpu_torch.serve.router.ReplicaRouter`
  admission control on router-managed models: a tenant over its
  token-bucket quota, or a lane past its shed threshold, gets the same
  429 — "low-priority shed first" instead of binary overload.
- ``GET /v1/models`` — every deployed model with version, status and
  version history.
- ``GET /v1/models/<name>`` — one model's row.
- ``POST /v1/models/<name>:feedback`` — body ``{"instances": [...],
  "labels": [...], "weights": optional}`` → append (input, label,
  weight, trace id) records to the server's
  :class:`~deeplearning4j_tpu_torch.serve.feedback.FeedbackLog` spool (the
  online continual-learning intake, docs/online.md).  The
  spool append NEVER runs disk I/O on the request path (background
  writer, bounded buffer).  Rows accepted/refused are counted in the
  ``tpudl_serve_feedback_{accepted,rejected}_total`` pair so spool
  loss is visible from the scrape surface.
- ``GET /healthz`` — 200 when ready, 503 while a hot-swap is in
  flight (load balancers steer away during the flip window).
- ``GET /metrics`` — Prometheus text exposition of the process-wide
  registry.

Request tracing: every route (``:predict``, ``:feedback``, and the
unknown-route 404s on both verbs) honors an ``X-Trace-Id`` request
header (minting one when absent), propagates it into the engine's
``serve`` span, the flight-recorder ring and the feedback spool
records, and echoes it on every response including errors — one id
follows a request across client logs, spans, spooled feedback, and
black-box dumps.

Labeled-predict tap: a ``:predict`` body that carries a ``"labels"``
array is live traffic that arrived with its own ground truth — with a
feedback log attached, the server taps it into the spool after
answering (guarded: a spool problem can never fail the prediction).
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.obs.registry import get_registry, install_standard_metrics
from deeplearning4j_tpu_torch.serve.engine import DeadlineExceeded, Overloaded
from deeplearning4j_tpu_torch.serve.registry import ModelRegistry

_PREDICT_SUFFIX = ":predict"
_FEEDBACK_SUFFIX = ":feedback"


def error_status(exc: BaseException) -> int:
    """HTTP status for a predict-path failure (load-shedding semantics:
    429 means 'this replica is saturated', 504 means 'gave up waiting')."""
    if isinstance(exc, Overloaded):
        return 429
    if isinstance(exc, (DeadlineExceeded, concurrent.futures.TimeoutError,
                        TimeoutError)):
        return 504
    if isinstance(exc, KeyError):
        return 404
    if isinstance(exc, (ValueError, TypeError)):
        return 400
    return 500


class ModelServer:
    """JSON inference server over a :class:`ModelRegistry`."""

    def __init__(self, registry: ModelRegistry, port: int = 0,
                 host: str = "127.0.0.1",
                 request_timeout_s: Optional[float] = 30.0,
                 feedback=None):
        """``feedback``: a :class:`~deeplearning4j_tpu_torch.serve.feedback.
        FeedbackLog`; enables ``POST :feedback`` and the labeled-predict
        tap (absent → feedback requests are rejected with 503)."""
        self.registry = registry
        self.request_timeout_s = request_timeout_s
        self.feedback = feedback
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code: int, obj,
                      trace_id: Optional[str] = None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if trace_id:
                    self.send_header("X-Trace-Id", trace_id)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # unknown-route errors echo the trace id too: a client
                # chasing a 404 needs the same cross-log handle a
                # predict error gets
                trace_id = self.headers.get("X-Trace-Id")
                path = self.path.split("?")[0].rstrip("/") or "/"
                if path == "/healthz":
                    if server.registry.ready():
                        return self._send(200, {"status": "ok"})
                    return self._send(503, {"status": "swapping"})
                if path == "/metrics":
                    install_standard_metrics()
                    body = get_registry().render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/v1/models":
                    return self._send(
                        200, {"models": server.registry.models()})
                if path.startswith("/v1/models/"):
                    name = path[len("/v1/models/"):]
                    try:
                        entry = server.registry.get(name)
                    except KeyError:
                        return self._send(
                            404, {"error": f"no model {name!r}"},
                            trace_id=trace_id)
                    return self._send(200, entry.to_dict())
                return self._send(404, {"error": "not found"},
                                  trace_id=trace_id)

            def do_POST(self):
                # per-request trace id: honor the caller's X-Trace-Id or
                # mint one; it rides into the engine's serve span / the
                # flight-recorder ring and echoes back on EVERY response
                # (including errors and the early 404), so one request is
                # findable across client logs, spans and black-box dumps
                trace_id = (self.headers.get("X-Trace-Id")
                            or uuid.uuid4().hex[:16])
                path = self.path.split("?")[0]
                if path.startswith("/v1/models/") \
                        and path.endswith(_FEEDBACK_SUFFIX):
                    return self._feedback(path, trace_id)
                if not (path.startswith("/v1/models/")
                        and path.endswith(_PREDICT_SUFFIX)):
                    return self._send(404, {"error": "not found"},
                                      trace_id=trace_id)
                name = path[len("/v1/models/"):-len(_PREDICT_SUFFIX)]
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                try:
                    payload = json.loads(raw.decode() or "{}")
                    instances = payload["instances"]
                except (ValueError, KeyError, UnicodeDecodeError):
                    return self._send(
                        400, {"error": "body must be JSON with an "
                                       "'instances' array"},
                        trace_id=trace_id)
                # per-tenant / per-lane admission headers: on a
                # router-managed model X-Tenant meters the caller's
                # token-bucket quota and X-Lane picks its priority lane
                # (low-priority lanes shed first under pressure); both
                # are inert on single-engine models.  The body may also
                # carry them ("tenant"/"lane") for header-less clients.
                tenant = self.headers.get("X-Tenant") \
                    or payload.get("tenant")
                lane = self.headers.get("X-Lane") or payload.get("lane")
                try:
                    x = np.asarray(instances, dtype=np.float32)
                    # version of the entry that ACTUALLY answered — the
                    # current pointer may already be newer mid-swap
                    out, version = server.registry.predict_versioned(
                        name, x, deadline_ms=payload.get("deadline_ms"),
                        timeout_s=server.request_timeout_s,
                        trace_id=trace_id, tenant=tenant, lane=lane)
                except BaseException as e:
                    return self._send(error_status(e),
                                      {"error": f"{type(e).__name__}: {e}"},
                                      trace_id=trace_id)
                # labeled-predict tap: live traffic that came with its
                # own ground truth feeds the online loop's spool —
                # guarded, after the answer is computed, never fatal
                if server.feedback is not None and "labels" in payload:
                    try:
                        server._tap_labeled(name, payload, trace_id)
                    except Exception:
                        pass
                return self._send(200, {
                    "predictions": np.asarray(out).tolist(),
                    "model_version": version}, trace_id=trace_id)

            def _feedback(self, path: str, trace_id: str):
                """POST :feedback — spool (input, label, weight,
                trace_id) rows.  Rejections (bad payload, unknown
                model, no spool) are counted per REQUEST'S rows so
                spool loss is visible; accepted rows count on the other
                side of the pair."""
                reg = get_registry()
                rejected_c = reg.counter(
                    "tpudl_serve_feedback_rejected_total")
                name = path[len("/v1/models/"):-len(_FEEDBACK_SUFFIX)]
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                try:
                    payload = json.loads(raw.decode() or "{}")
                    instances = payload["instances"]
                    labels = payload["labels"]
                except (ValueError, KeyError, UnicodeDecodeError):
                    rejected_c.inc()
                    return self._send(
                        400, {"error": "body must be JSON with "
                                       "'instances' and 'labels' arrays"},
                        trace_id=trace_id)
                weights = payload.get("weights")
                if not isinstance(instances, list) \
                        or not isinstance(labels, list) \
                        or len(instances) != len(labels) \
                        or (isinstance(weights, list)
                            and len(weights) != len(instances)):
                    rejected_c.inc(max(len(instances)
                                       if isinstance(instances, list) else 1,
                                       1))
                    return self._send(
                        400, {"error": "instances/labels (and optional "
                                       "weights) must be equal-length "
                                       "arrays"}, trace_id=trace_id)
                try:
                    server.registry.get(name)
                except KeyError:
                    rejected_c.inc(max(len(instances), 1))
                    return self._send(404, {"error": f"no model {name!r}"},
                                      trace_id=trace_id)
                if server.feedback is None:
                    rejected_c.inc(max(len(instances), 1))
                    return self._send(
                        503, {"error": "no feedback spool configured on "
                                       "this server"}, trace_id=trace_id)
                if isinstance(weights, (int, float)):
                    weights = [float(weights)] * len(instances)
                accepted = server.feedback.extend(
                    instances, labels, weights=weights,
                    trace_id=trace_id, model=name)
                reg.counter("tpudl_serve_feedback_accepted_total").inc(
                    accepted)
                refused = len(instances) - accepted
                if refused:
                    rejected_c.inc(refused)
                return self._send(200, {"accepted": accepted,
                                        "rejected": refused},
                                  trace_id=trace_id)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="tpudl-model-server")
        self._thread.start()

    def _tap_labeled(self, name: str, payload: dict,
                     trace_id: Optional[str]) -> None:
        """Spool a labeled :predict request (the engine-side tap).
        Row-count mismatches are rejected (counted), not guessed at."""
        reg = get_registry()
        instances, labels = payload["instances"], payload["labels"]
        if not isinstance(labels, list) or len(labels) != len(instances):
            reg.counter("tpudl_serve_feedback_rejected_total").inc(
                max(len(instances) if isinstance(instances, list) else 1, 1))
            return
        weights = payload.get("weights")
        if isinstance(weights, (int, float)):
            weights = [float(weights)] * len(instances)
        accepted = self.feedback.extend(instances, labels, weights=weights,
                                        trace_id=trace_id, model=name)
        reg.counter("tpudl_serve_feedback_accepted_total").inc(accepted)
        refused = len(instances) - accepted
        if refused:
            reg.counter("tpudl_serve_feedback_rejected_total").inc(refused)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
