"""The live training dashboard and the cluster's coordinator (port of
``deeplearning4j_tpu/obs/ui_server.py``).

The reference's ``UIServer``: a singleton HTTP server that statistics
storages attach to, serving an auto-refreshing dashboard, and the
coordinator that workers' ``RemoteStatsRouter``\\ s (``obs.remote``) push
records, step stamps and heartbeats to.  A standard-library
``ThreadingHTTPServer`` renders each page on request through
``obs.stats.render_html`` (the storage is the one source of truth, so a
reload is the live update).  Routes:

- ``/``              the dashboard of the first attached storage
- ``/train/<i>``     the dashboard of attached storage i
- ``/data/<i>.json`` storage i's raw records
- ``/cluster``       the per-worker dashboard (step time, MFU, liveness,
  stragglers, generations, restarts, annotations)
- ``/cluster.json``  the same as a summary
- ``POST /remote/stats`` the workers' ingest; garbage is answered 400,
  never 500
- ``/metrics``       the registry's Prometheus text (``obs.registry``)
- ``/healthz``       liveness

It binds loopback unless ``host`` says otherwise (a coordinator of
workers on other hosts binds ``"0.0.0.0"``); it reads no environment.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.obs.registry import get_registry, install_standard_metrics
from deeplearning4j_tpu_torch.obs.remote import INGEST_PATH, ClusterStore
from deeplearning4j_tpu_torch.obs.stats import render_html

DEFAULT_HOST = "127.0.0.1"


class UIServer:
    """The dashboard server (``UIServer.getInstance()``'s counterpart:
    :meth:`get_instance`)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 0, refresh_seconds: int = 5,
                 cluster: Optional[ClusterStore] = None, host: str = DEFAULT_HOST):
        self.host = host
        self._storages: list = []
        self._lock = threading.Lock()
        self.refresh_seconds = refresh_seconds
        self.cluster = cluster or ClusterStore()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # no request logging
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, message: str):
                return self._send(json.dumps({"error": message}).encode(), "application/json",
                                  400)

            def do_POST(self):
                path = self.path.split("?")[0].rstrip("/")
                if path != INGEST_PATH:
                    return self._send(b"not found", "text/plain", 404)
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    worker = str(payload["worker"])
                    records = payload.get("records", [])
                    # 0 for an unsupervised worker; lets the store drop a
                    # dead predecessor's window when a respawn registers
                    generation = int(payload.get("generation", 0) or 0)
                    if not isinstance(records, list):
                        raise ValueError("records must be a list")
                except (KeyError, ValueError, TypeError, AttributeError) as e:
                    return self._error(f"bad ingest payload: {e}")
                try:
                    n = server.cluster.ingest(worker, records, generation=generation)
                except Exception as e:
                    # the garbage-ingest contract: a typed 400, never a reset
                    return self._error(f"ingest failed: {e!r}")
                return self._send(json.dumps({"ok": n}).encode(), "application/json")

            def do_GET(self):
                with server._lock:
                    storages = list(server._storages)
                path = self.path.split("?")[0].rstrip("/") or "/"
                if path == "/healthz":
                    return self._send(b'{"status":"ok"}', "application/json")
                if path == "/metrics":
                    # the whole catalog, before the first increment too
                    install_standard_metrics()
                    return self._send(get_registry().render_prometheus().encode(),
                                      "text/plain; version=0.0.4; charset=utf-8")
                if path == "/cluster":
                    html = server.cluster.render_html(refresh_seconds=server.refresh_seconds)
                    return self._send(html.encode(), "text/html")
                if path == "/cluster.json":
                    return self._send(json.dumps(server.cluster.summary()).encode(),
                                      "application/json")
                if path.startswith("/data/") and path.endswith(".json"):
                    idx = path[len("/data/"):-len(".json")]
                    if idx.isdigit() and int(idx) < len(storages):
                        return self._send(json.dumps(storages[int(idx)].all()).encode(),
                                          "application/json")
                    # a stale bookmark after a detach: 404, not 500
                    return self._send(b"not found", "text/plain", 404)
                idx = 0
                if path.startswith("/train/"):
                    tail = path[len("/train/"):]
                    if tail.isdigit():
                        idx = int(tail)
                if not storages:
                    return self._send(b"<html><body><h1>No StatsStorage attached</h1>"
                                      b"</body></html>", "text/html")
                if idx >= len(storages):
                    return self._send(b"not found", "text/plain", 404)
                html = render_html(storages[idx], title=f"Training session {idx}",
                                   refresh_seconds=server.refresh_seconds)
                return self._send(html.encode(), "text/html")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 0) -> "UIServer":
        """The process-wide server, made on the first call.  With one
        running, ``port`` is a contract: 0 or its own port returns it, any
        other raises ``RuntimeError`` (a server on another port than asked
        for is how dashboards go missing)."""
        inst = cls._instance
        if inst is not None:
            if port and port != inst.port:
                raise RuntimeError(
                    f"UIServer already running on port {inst.port}; cannot honor "
                    f"get_instance(port={port}): use the running instance, stop() it first, "
                    f"or construct UIServer(port=...) directly for a non-singleton server")
            return inst
        cls._instance = UIServer(port=port)
        return cls._instance

    @property
    def url(self) -> str:
        # a wildcard bind is no address to connect to: advertise loopback
        host = "127.0.0.1" if self.host in ("", "0.0.0.0", "::") else self.host
        return f"http://{host}:{self.port}/"

    def attach(self, storage) -> None:
        with self._lock:
            if storage not in self._storages:
                self._storages.append(storage)

    def detach(self, storage) -> None:
        with self._lock:
            if storage in self._storages:
                self._storages.remove(storage)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if UIServer._instance is self:
            UIServer._instance = None
