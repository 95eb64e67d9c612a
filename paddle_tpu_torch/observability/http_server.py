"""Tiny stdlib HTTP server for Prometheus scraping + JSON snapshots — the
port's copy of paddle_tpu/observability/http_server.py.

GET /metrics            -> Prometheus text exposition (0.0.4)
GET /snapshot.json      -> one-shot JSON snapshot of every series
GET /trace.json         -> Chrome-trace JSON of the span ring
GET /requests.json      -> per-request summaries + TTFT/TPOT exemplars
                           (?sort=ttft|tpot|queue|tokens, ?limit=N)
GET /request/<id>.json  -> one request's full structured timeline
GET /control/profile    -> arm an on-demand device capture
                           (?steps=N; windowed to N step boundaries)
GET /fleet/metrics      -> fleet-merged Prometheus text (counters
                           summed, histogram buckets merged, gauges
                           per-replica-labeled)
GET /fleet/replicas.json    -> per-replica state/throughput/SLO table
GET /fleet/placements.json  -> router placement-decision audit ring
GET /alerts.json        -> windowed burn-rate + anomaly-watcher alert
                           table (evaluated fresh per scrape)
GET /healthz            -> "ok" (liveness for load balancers)

Serves from a daemon thread; ``port=0`` binds an OS-assigned ephemeral
port (hermetic for tests — read it back from ``server.port``).
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..framework.flags import get_flag
from .exposition import render_prometheus, snapshot
from .tracing import get_tracer

__all__ = ["MetricsServer", "start_http_server", "stop_http_server"]

_server: Optional["MetricsServer"] = None
_lock = threading.Lock()


class _Handler(BaseHTTPRequestHandler):
    registry = None     # set per-server via subclassing in MetricsServer

    def _send(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path, _, query = self.path.partition("?")
        qs = {k: v[-1] for k, v in
              urllib.parse.parse_qs(query).items()}
        if path in ("/metrics", "/"):
            body = render_prometheus(self.registry).encode()
            self._send(body, "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/snapshot.json", "/snapshot"):
            body = json.dumps(snapshot(self.registry)).encode()
            self._send(body, "application/json")
        elif path in ("/trace.json", "/trace"):
            body = json.dumps(get_tracer().chrome_trace()).encode()
            self._send(body, "application/json")
        elif path in ("/requests.json", "/requests"):
            self._send_json(self._requests_payload(qs))
        elif path.startswith("/request/"):
            self._send_request_timeline(path[len("/request/"):])
        elif path == "/control/profile":
            self._send_profile_control(qs)
        elif path.startswith("/fleet/"):
            self._send_fleet(path)
        elif path in ("/alerts.json", "/alerts"):
            self._send_alerts()
        elif path == "/healthz":
            self._send(b"ok", "text/plain")
        else:
            self._send(b"not found", "text/plain", 404)

    def _send_json(self, doc, code: int = 200):
        # default=repr: one stray numpy scalar in a timeline field must
        # not turn the endpoint into a 500
        self._send(json.dumps(doc, default=repr).encode(),
                   "application/json", code)

    def _requests_payload(self, qs):
        from .request_trace import requests_payload

        limit = None
        try:
            limit = int(qs["limit"]) if "limit" in qs else None
        except ValueError:
            pass
        return requests_payload(sort=qs.get("sort", "ttft"), limit=limit)

    def _send_request_timeline(self, rid_part: str):
        from .request_trace import get_request_tracer

        rid_s = rid_part[:-len(".json")] if rid_part.endswith(".json") \
            else rid_part
        # engine ids are ints; fall back to the raw string for callers
        # tracing by an external correlation id (or junk like "--5")
        try:
            rid = int(rid_s)
        except ValueError:
            rid = rid_s
        doc = get_request_tracer().get(rid)
        if doc is None:
            self._send_json({"error": "unknown or evicted request",
                             "request_id": rid_s}, 404)
        else:
            self._send_json(doc)

    def _send_fleet(self, path):
        from . import fleet

        if path in ("/fleet/metrics", "/fleet/metrics.txt"):
            self._send(fleet.fleet_metrics_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/fleet/replicas.json", "/fleet/replicas"):
            self._send_json(fleet.replicas_payload())
        elif path in ("/fleet/placements.json", "/fleet/placements"):
            self._send_json(fleet.placements_payload())
        else:
            self._send(b"not found", "text/plain", 404)

    def _send_alerts(self):
        from . import timeseries

        self._send_json(timeseries.alerts_payload())

    def _send_profile_control(self, qs):
        from . import profiling

        # string truthiness would make ?stop=0 stop the capture
        if qs.get("stop", "").lower() not in ("", "0", "false", "no"):
            self._send_json({"ok": True,
                             "status": profiling.get_controller().stop()})
            return
        steps = None
        try:
            steps = int(qs["steps"]) if "steps" in qs else None
        except ValueError:
            self._send_json({"ok": False,
                             "error": f"bad steps={qs['steps']!r}"}, 400)
            return
        out = profiling.request_capture(steps=steps)
        # invalid input is the caller's fault (400); a capture already
        # in flight is a state conflict (409)
        code = 200 if out.get("ok") \
            else 400 if out.get("bad_request") else 409
        self._send_json(out, code)

    def log_message(self, *args):     # scrapes must not spam stderr
        pass


class MetricsServer:
    def __init__(self, port: Optional[int] = None,
                 host: Optional[str] = None, registry=None):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer(
            (host if host is not None else str(get_flag("obs_host")),
             int(get_flag("obs_port")) if port is None else int(port)),
            handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-tpu-torch-obs-http",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_port

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(2)


def start_http_server(port: Optional[int] = None,
                      host: Optional[str] = None,
                      registry=None) -> MetricsServer:
    """Start (or return the already-running) exposition server."""
    global _server
    with _lock:
        if _server is None:
            _server = MetricsServer(port=port, host=host, registry=registry)
        return _server


def stop_http_server() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
