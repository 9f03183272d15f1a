"""Live OpenMetrics exporter: scrape a running server without stopping it.

Counterpart of `libgrape_lite_tpu/obs/exporter.py`.  A stdlib
`http.server` endpoint on 127.0.0.1 in a background thread, armed by
`GRAPE_METRICS_PORT` or the serve CLI's `--metrics_port`:

* `/metrics` -- Prometheus text: the armed `MetricsRegistry` (empty
  disarmed) plus the federation snapshot as `grape_stats_<ns>_<field>`
  gauges (a dict field gives one `{key="..."}` sample per entry; other
  non-numeric fields are JSON only).  Every registered namespace gets a
  `grape_stats_registry{namespace="..."} 1` marker.
* `/federation` -- the federation snapshot as JSON.
* `/healthz` -- `{"ok": true, "namespaces": N}`.

A scrape costs the serving loop only the interpreter-lock slices of the
snapshot copy.  Port 0 binds an ephemeral port (`MetricsExporter.port`).
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from libgrape_lite_tpu_torch.obs import federation
from libgrape_lite_tpu_torch.obs.metrics import gang_identity

METRICS_PORT_ENV = "GRAPE_METRICS_PORT"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(ns: str, field: str) -> str:
    return "grape_stats_%s_%s" % (_NAME_OK.sub("_", ns),
                                  _NAME_OK.sub("_", field))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def federation_text(snap=None) -> str:
    """The federation snapshot as Prometheus text: numeric scalars
    directly, numeric dict entries one labelled sample each, and every
    namespace's `grape_stats_registry` marker."""
    if snap is None:
        snap = federation.snapshot()
    lines = []
    rank, nprocs = gang_identity()
    if nprocs > 1:
        lines.append("# TYPE grape_gang_rank gauge")
        lines.append(f"grape_gang_rank {rank}")
        lines.append("# TYPE grape_gang_nprocs gauge")
        lines.append(f"grape_gang_nprocs {nprocs}")
    lines.append("# TYPE grape_stats_registry gauge")
    for ns in sorted(snap):
        lines.append('grape_stats_registry{namespace="%s"} 1'
                     % _escape_label(ns))
    for ns in sorted(snap):
        for field in sorted(snap[ns]):
            v = snap[ns][field]
            name = _metric_name(ns, field)
            if isinstance(v, bool) or isinstance(v, (int, float)):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt_num(v)}")
            elif isinstance(v, dict):
                numeric = {k: x for k, x in v.items()
                           if isinstance(x, (int, float))}
                if numeric:
                    lines.append(f"# TYPE {name} gauge")
                    for k in sorted(numeric):
                        lines.append('%s{key="%s"} %s' % (
                            name, _escape_label(str(k)),
                            _fmt_num(numeric[k])))
            # lists, strings, None: the JSON endpoint only
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "grape-exporter/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 -- the http.server API
        path = self.path.split("?", 1)[0]
        try:
            if path in ("/metrics", "/"):
                from libgrape_lite_tpu_torch import obs

                text = obs.metrics().to_prometheus_text()
                text += federation_text()
                text += "# EOF\n"
                self._send(200, text.encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/federation":
                body = json.dumps(federation.snapshot(), indent=1,
                                  sort_keys=True, default=str)
                self._send(200, body.encode("utf-8"), "application/json")
            elif path == "/healthz":
                health = {"ok": True,
                          "namespaces": len(federation.registered())}
                rank, nprocs = gang_identity()
                if nprocs > 1:
                    health["rank"] = rank
                    health["nprocs"] = nprocs
                self._send(200, json.dumps(health).encode("utf-8"),
                           "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:  # a scrape must never kill the server
            self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                       "text/plain")

    def log_message(self, fmt, *args):  # no stderr line per request
        pass


class MetricsExporter:
    """Background OpenMetrics endpoint over the federation and registry."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="grape-metrics-exporter", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._server.server_address[0]}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


_exporter: Optional[MetricsExporter] = None
_exporter_lock = threading.Lock()


def start_exporter(port: int = 0) -> MetricsExporter:
    """Start the module's exporter, or return the running one."""
    global _exporter
    with _exporter_lock:
        if _exporter is None:
            _exporter = MetricsExporter(port=port)
        return _exporter


def get_exporter() -> Optional[MetricsExporter]:
    return _exporter


def stop_exporter() -> None:
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None


def maybe_start_from_env() -> Optional[MetricsExporter]:
    """Start from GRAPE_METRICS_PORT when it is set; a bad value is
    ignored, not fatal (a stray variable must not stop a server)."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    if port < 0:
        return None
    try:
        return start_exporter(port)
    except OSError:
        return None
