"""Prometheus text exposition + the stdlib HTTP scrape endpoint (twin of
``mpi4dl_tpu/telemetry/export.py``, copied; the text is byte-equal to the JAX
exporter's for the same registry state).

:func:`render_prometheus` serializes a :class:`MetricsRegistry` in the
Prometheus text format (version 0.0.4): ``# HELP`` / ``# TYPE`` headers,
escaped label values, and for histograms the cumulative ``_bucket{le=}``
series plus ``_sum``/``_count``; buckets carrying an exemplar render the
OpenMetrics ``# {trace_id="..."} value ts`` suffix (docs/OBSERVABILITY.md
"Tail forensics"). :class:`MetricsServer` serves it from a
daemon ``http.server`` thread — stdlib only (the container must not need
``prometheus_client``), opt-in via ``ServingEngine(metrics_port=...)`` or
``python -m mpi4dl_tpu_torch.serve --metrics-port`` (port 0 binds an ephemeral
port, reported back on :attr:`MetricsServer.port`).

Routes: ``/metrics`` scrapes the registry; ``/snapshotz`` serves the same
registry state as machine-readable JSON — a schema-valid ``metrics`` event
(:func:`mpi4dl_tpu_torch.telemetry.jsonl.metrics_event`) plus the emitting
``pid``, the endpoint the federation aggregator
(:mod:`mpi4dl_tpu_torch.telemetry.federation`) scrapes so child→parent merges
never round-trip through text-format parsing; ``/`` returns a small text
index of the endpoints this server actually has (an operator probing the
port discovers the surface instead of guessing paths); with providers
attached, ``/healthz`` answers 200/503 from a
:class:`mpi4dl_tpu_torch.telemetry.HealthState` snapshot (the load-balancer /
uptime probe), ``/debugz`` serves the live diagnostic payload (flight
recorder tail, watchdog state, latest attribution), ``/alertz``
serves the SLO evaluator's alert/burn/budget state, and ``/incidentz``
the incident engine's open/recent incidents
(:class:`mpi4dl_tpu_torch.telemetry.incident.IncidentManager`; correlated timelines,
first causes, blast radii). ``HEAD`` mirrors
``GET`` status/headers without a body — probes get 200, not 501 — and
non-GET/HEAD methods get 405.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi4dl_tpu_torch.telemetry.jsonl import metrics_event
from mpi4dl_tpu_torch.telemetry.registry import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_help(text: str) -> str:
    r"""HELP-line escaping: backslash and newline."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def escape_label_value(text: str) -> str:
    r"""Label-value escaping: backslash, double-quote, newline."""
    return (
        text.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"\\": "\\", "n": "\n", '"': '"'}


def _unescape(text: str) -> str:
    # Single left-to-right pass: 'a\\nb' is backslash+n (literal), not a
    # newline — sequential str.replace calls get exactly that case wrong,
    # which is why these exist as the tested inverse of the escapers.
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(0)), text
    )


def unescape_help(text: str) -> str:
    r"""Inverse of :func:`escape_help` (``\\`` → backslash, ``\n`` →
    newline; anything else passes through untouched)."""
    return _unescape(text)


def unescape_label_value(text: str) -> str:
    r"""Inverse of :func:`escape_label_value`."""
    return _unescape(text)


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _labels_str(labels: dict, extra: "dict | None" = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in merged.items()
    )
    return "{" + inner + "}"


def _exemplar_suffix(ex: "dict | None") -> str:
    """OpenMetrics exemplar suffix for a ``_bucket`` sample line:
    ``# {trace_id="..."} value timestamp`` — the scrape-side link from a
    latency bucket to the concrete request that most recently landed in
    it. Empty when the bucket has none."""
    if not ex:
        return ""
    tid = escape_label_value(str(ex["trace_id"]))
    return (
        f' # {{trace_id="{tid}"}} {_fmt_value(ex["value"])} '
        f"{_fmt_value(ex['ts'])}"
    )


def render_prometheus(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for snap_name, m in registry.snapshot().items():
        if m["help"]:
            lines.append(f"# HELP {snap_name} {escape_help(m['help'])}")
        lines.append(f"# TYPE {snap_name} {m['type']}")
        for s in m["series"]:
            if m["type"] == "histogram":
                exemplars = s.get("exemplars", {})
                for le, cum in s["buckets"].items():
                    lines.append(
                        f"{snap_name}_bucket"
                        f"{_labels_str(s['labels'], {'le': le})} {cum}"
                        f"{_exemplar_suffix(exemplars.get(le))}"
                    )
                lines.append(
                    f"{snap_name}_sum{_labels_str(s['labels'])} "
                    f"{_fmt_value(s['sum'])}"
                )
                lines.append(
                    f"{snap_name}_count{_labels_str(s['labels'])} "
                    f"{s['count']}"
                )
            else:
                lines.append(
                    f"{snap_name}{_labels_str(s['labels'])} "
                    f"{_fmt_value(s['value'])}"
                )
    return "\n".join(lines) + "\n"


class MetricsServer:
    """``/metrics`` (+ ``/`` index, optional ``/healthz``, ``/debugz``,
    ``/alertz``) endpoint on a daemon thread.

    Binds immediately in the constructor (so an in-use port fails loudly at
    startup, not on the first scrape); ``port=0`` picks an ephemeral port,
    readable from :attr:`port`.

    health: zero-arg callable returning a dict with a boolean
        ``"healthy"`` key (``HealthState.snapshot``); ``/healthz`` then
        serves it as JSON with status 200/503. Without it ``/healthz``
        is 404 like any unknown path.
    debug: zero-arg callable returning a JSON-serializable diagnostic
        payload for ``/debugz`` (flight-recorder tail, watchdog state,
        latest attribution summary).
    alerts: zero-arg callable returning the SLO/alert state payload for
        ``/alertz`` (``SLOEvaluator.state``).
    incidents: zero-arg callable returning the incident-engine payload
        for ``/incidentz`` (``IncidentManager.state``): open/recent
        incidents with their correlated timelines, first-cause
        candidates, and blast radii.
    numerics: zero-arg callable returning the numerics-sentinel payload
        (``CanaryState.view``): embedded as the ``numerics`` key of
        ``/snapshotz``, so the federation's existing snapshot scrape
        carries the params checksum + canary digests with no extra
        round trip.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
        health=None,
        debug=None,
        alerts=None,
        numerics=None,
        incidents=None,
    ):
        self.registry = registry
        self.health = health
        self.debug = debug
        self.alerts = alerts
        self.numerics = numerics
        self.incidents = incidents
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _payload(self):
                """(status, content-type, body) for GET/HEAD routing."""
                path = self.path.split("?")[0]
                if path == "/":
                    return (200, "text/plain; charset=utf-8",
                            server._index().encode())
                if path == "/metrics":
                    return (200, CONTENT_TYPE,
                            render_prometheus(server.registry).encode())
                if path == "/snapshotz":
                    snap = metrics_event(server.registry)
                    snap["pid"] = os.getpid()
                    if server.numerics is not None:
                        snap["numerics"] = server.numerics()
                    return (200, "application/json",
                            json.dumps(snap).encode())
                if path == "/healthz" and server.health is not None:
                    snap = dict(server.health())
                    status = 200 if snap.get("healthy") else 503
                    return (status, "application/json",
                            json.dumps(snap).encode())
                if path == "/debugz" and server.debug is not None:
                    return (200, "application/json",
                            json.dumps(server.debug(), default=str).encode())
                if path == "/alertz" and server.alerts is not None:
                    return (200, "application/json",
                            json.dumps(server.alerts(), default=str).encode())
                if path == "/incidentz" and server.incidents is not None:
                    return (200, "application/json",
                            json.dumps(server.incidents(),
                                       default=str).encode())
                return (404, "text/plain; charset=utf-8", b"not found\n")

            def _respond(self, send_body: bool):
                try:
                    status, ctype, body = self._payload()
                except Exception as e:  # noqa: BLE001 — a broken debug
                    # provider must answer 500, not kill the connection
                    status, ctype = 500, "text/plain; charset=utf-8"
                    body = f"provider error: {e}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if send_body:
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                self._respond(send_body=True)

            def do_HEAD(self):  # noqa: N802 — LB/uptime probes use HEAD;
                self._respond(send_body=False)  # 501 would page someone

            def _method_not_allowed(self):
                self.send_error(405, "Method Not Allowed")

            # Observability endpoints are read-only: writes are a client
            # bug, answered 405 (wrong method) rather than 404 (no such
            # path) or 501 (server can't).
            do_POST = _method_not_allowed  # noqa: N815
            do_PUT = _method_not_allowed  # noqa: N815
            do_DELETE = _method_not_allowed  # noqa: N815
            do_PATCH = _method_not_allowed  # noqa: N815
            do_OPTIONS = _method_not_allowed  # noqa: N815

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mpi4dl-metrics-server",
            daemon=True,
        )
        self._thread.start()

    def _index(self) -> str:
        """The ``/`` endpoint index: only routes this server actually
        answers (operators probing the port discover the surface)."""
        lines = [
            "mpi4dl_tpu_torch telemetry endpoints:",
            "  /metrics  Prometheus text exposition (0.0.4)",
            "  /snapshotz  registry snapshot as JSON (metrics-event "
            "schema + pid; the federation scrape surface)",
        ]
        if self.health is not None:
            lines.append("  /healthz  liveness JSON, 200 healthy / 503 not")
        if self.debug is not None:
            lines.append(
                "  /debugz   diagnostics JSON (stats, watchdog, flight tail)"
            )
        if self.alerts is not None:
            lines.append(
                "  /alertz   SLO + alert state JSON (burn rates, budgets)"
            )
        if self.incidents is not None:
            lines.append(
                "  /incidentz  incident engine JSON (timelines, first "
                "cause, blast radius)"
            )
        return "\n".join(lines) + "\n"

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
