"""Local HTTP debug listener: /metrics + /debug/traces for every process.

Until now only the apiserver process exposed metrics over HTTP; the
scheduler and controller-manager were SIGUSR2-only — useless the moment
you want a Prometheus scrape or a trace lookup against a live replica
without log access. This module is the small shared listener every
process family can start with ``--debug-port`` (default off):

  * ``GET /metrics``       — Prometheus exposition text (the process's
    registry, exemplar comment lines included);
  * ``GET /debug/traces``  — the tracing ring (utils/tracing.py):
    ``?id=<trace_id>`` returns one trace with its store-side stamps,
    otherwise the slowest-N completed traces (``?n=``, ``?kind=``);
  * ``GET /healthz``       — liveness.

The apiserver's REST mux serves the same two payloads from its own
port (apiserver/rest.py delegates to :func:`traces_payload`), so every
process in the control plane answers the same debug URLs.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .metrics import metrics
from .tracing import tracer


def metrics_payload() -> Tuple[bytes, str]:
    """(body, content-type) for a /metrics scrape of this process — the
    ONE place that knows batch-published tracing series need a flush
    before rendering. Shared by this listener, the apiserver REST mux,
    and the scheduler healthz handler so the three scrapes cannot
    drift."""
    tracer.publish_gauges()
    return (
        metrics.render_prometheus().encode(),
        "text/plain; version=0.0.4",
    )


def traces_payload(query: dict) -> Tuple[int, dict]:
    """The /debug/traces response body for a parsed query dict. Shared
    by this listener and the apiserver REST route so the two views
    cannot drift."""
    trace_id = query.get("id", "")
    if trace_id:
        found = tracer.get(trace_id)
        if found is None:
            return 404, {"error": f"no trace {trace_id!r} in this process"}
        return 200, found
    try:
        n = int(query.get("n", "10"))
    except ValueError:
        n = 10
    kind = query.get("kind", "pod")
    return 200, {
        "kind": kind,
        "slowest": tracer.slowest(n, kind=kind),
        "stages": tracer.stage_stats(kind=kind) if kind == "pod" else {},
    }


class _DebugHandler(BaseHTTPRequestHandler):
    server_version = "ktpu-debug"

    def log_message(self, *args):
        pass

    def _respond(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urlparse(self.path)
        if u.path in ("/healthz", "/livez"):
            return self._respond(200, b"ok", "text/plain")
        if u.path == "/metrics":
            body, ctype = metrics_payload()
            return self._respond(200, body, ctype)
        if u.path == "/debug/traces":
            q = {k: v[-1] for k, v in parse_qs(u.query).items()}
            code, payload = traces_payload(q)
            return self._respond(
                code, json.dumps(payload, indent=1).encode(),
                "application/json",
            )
        return self._respond(404, b"not found", "text/plain")


def serve_debug(
    port: int, host: str = "127.0.0.1"
) -> Optional[ThreadingHTTPServer]:
    """Start the listener (daemon thread); port 0 binds an ephemeral
    port (``srv.server_address[1]``), None/negative disables. Loopback
    by default: this is an operator surface, not a service."""
    if port is None or port < 0:
        return None
    srv = ThreadingHTTPServer((host, port), _DebugHandler)
    srv.daemon_threads = True
    threading.Thread(
        target=srv.serve_forever, daemon=True, name="debug-listener"
    ).start()
    return srv
