"""Prometheus-style metrics endpoint on a stdlib http.server thread.

Counterpart of ``deepspeed_tpu/telemetry/server.py``: the same routes and
documents, so one scraper reads a replica of either package.

Off by default; enabled by ``DS_METRICS_PORT=<port>`` (or the runtime
config.s ``telemetry.metrics_port``).  Serves:

- ``/metrics``  — Prometheus text exposition of the registry
- ``/snapshot`` — the registry's flat JSON snapshot;
  ``?window=<seconds>`` returns delta-windowed values from the
  time-series ring instead of lifetime cumulatives;
  ``?raw=1`` returns the structured raw snapshot with histogram bucket
  counts — the body the fleet federation merges exactly;
  ``?digests=1[&top_k=N]`` returns the live engine's bounded
  prefix-cache affinity hint: hex digests only, never page
  contents — so a pool router can scrape placement hints per replica
- ``/fleet``    — the federation's merged ``ds_fleet_*`` view over the
  configured replica targets (text; ``?json=1`` for JSON)
- ``/memory``   — the memory ledger's per-subsystem breakdown, peaks,
  device truth and residual (text table, ``?json=1`` for
  JSON; 404 until an engine build registers accountants)
- ``/trace``    — current span ring buffer as Chrome-trace JSON
- ``/journey``  — ``?uid=<uid>`` returns this process's completed
  journey records and exported fragments for that request; a
  cross-process stitcher (``fleetctl journey``) scrapes
  every replica's endpoint and merges chains by journey id
- ``/healthz``  — watchdog verdicts + SLO burn-rate verdicts + uptime;
  HTTP 200 while healthy, 503 on a non-finite / anomaly-storm /
  SLO-page verdict so a fleet health checker needs no JSON parsing

Binds ``DS_METRICS_ADDR`` (default 127.0.0.1).  ``DS_METRICS_PORT=0``
binds an EPHEMERAL port (two replicas on one host cannot collide); the
bound port is on the returned server handle, in a log line, and in the
``ds_telemetry_port`` gauge so federation can discover it.  Unset =
off (the seed semantics for "no value").

:func:`serve_registry` starts ADDITIONAL servers bound to explicit
registries (same-process replica pools, federation tests) — the
module-level singleton stays the process's own endpoint.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import get_registry
from .tracer import get_tracer

_server: Optional[ThreadingHTTPServer] = None
# RLock: lifecycle lock shared with the
# module's stop path — a SIGTERM landing inside start/stop must not
# deadlock against itself
_lock = threading.RLock()

#: process-wide prefix-digest provider: the live inference
#: engine binds a weakref'd callable at build (newest engine wins — the
#: ds_kv_* gauge convention) and ``/snapshot?digests=1[&top_k=N]``
#: serves its bounded affinity hint so a pool router can scrape a
#: replica's cache hints like any other replica fact
_digest_source = None


def set_digest_source(fn) -> None:
    """Register the ``(top_k: int) -> {"page_size", "digests"}``
    provider behind ``/snapshot?digests=1`` (None to clear)."""
    global _digest_source
    _digest_source = fn


class _MetricsHandler(BaseHTTPRequestHandler):
    def _registry(self):
        return getattr(self.server, "ds_registry", None) or get_registry()

    def do_GET(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        params = urllib.parse.parse_qs(query)
        if path in ("/metrics", "/"):
            body = self._registry().prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/snapshot":
            doc, err = self._snapshot_doc(params)
            if err is not None:
                self.send_error(400, err)
                return
            body = json.dumps(doc).encode()
            ctype = "application/json"
        elif path == "/fleet":
            self._do_fleet(params)
            return
        elif path == "/memory":
            self._do_memory(params)
            return
        elif path == "/trace":
            body = json.dumps({
                "traceEvents": get_tracer().chrome_events(),
                "displayTimeUnit": "ms"}).encode()
            ctype = "application/json"
        elif path == "/journey":
            from .journey import get_journey_log
            try:
                uid = int(params["uid"][0])
            except (KeyError, IndexError, ValueError):
                self.send_error(400, "journey lookup needs ?uid=<int>")
                return
            body = json.dumps(get_journey_log().lookup(uid)).encode()
            ctype = "application/json"
        elif path == "/healthz":
            from .watchdog import get_watchdog
            from .slo import get_slo_evaluator
            health = get_watchdog().health()
            slo = get_slo_evaluator().current()
            health["slo"] = slo
            ok = health["status"] == "ok" and slo["status"] != "page"
            body = json.dumps(health).encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _snapshot_doc(self, params):
        """(/snapshot body, error) honoring ``digests``, ``window`` and
        ``raw``."""
        if params.get("digests", ["0"])[0] not in ("", "0"):
            if _digest_source is None:
                return None, ("no inference engine has bound a digest "
                              "source in this process")
            try:
                top_k = int(params.get("top_k", ["64"])[0])
            except ValueError:
                return None, "top_k must be an integer"
            return _digest_source(max(0, min(top_k, 4096))), None
        if "window" in params:
            try:
                window_s = float(params["window"][0])
            except (ValueError, IndexError):
                return None, "window must be a number of seconds"
            if window_s <= 0:
                return None, "window must be > 0"
            ts = getattr(self.server, "ds_timeseries", None)
            if ts is None:
                if getattr(self.server, "ds_registry", None) is not None:
                    # an extra serve_registry() server without its own
                    # ring: falling back to the process-global ring
                    # would serve windowed data for a DIFFERENT
                    # registry than this port's other endpoints
                    return None, ("this endpoint has no time-series "
                                  "ring bound; pass timeseries= to "
                                  "serve_registry for windowed "
                                  "snapshots")
                from .timeseries import get_timeseries
                ts = get_timeseries()
            if not ts.active:
                # ASCII only: http.server encodes the status line as
                # latin-1
                return None, ("time-series sampling is off; configure "
                              "telemetry.timeseries_interval_s / "
                              "DS_TIMESERIES for windowed snapshots")
            return ts.window_snapshot(window_s), None
        if params.get("raw", ["0"])[0] not in ("", "0"):
            return self._registry().raw_snapshot(), None
        return self._registry().snapshot(), None

    def _do_fleet(self, params) -> None:
        fed = getattr(self.server, "ds_federation", None)
        if fed is None:
            from .federation import get_federation
            fed = get_federation()
        if not fed.labels():
            self.send_error(
                404, "no fleet targets configured (telemetry."
                "fleet_targets / DS_FLEET_TARGETS)")
            return
        if params.get("json", ["0"])[0] not in ("", "0"):
            body = json.dumps(fed.snapshot_json()).encode()
            ctype = "application/json"
        else:
            body = fed.prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _do_memory(self, params) -> None:
        """The memory ledger's breakdown: per-subsystem
        bytes + peaks, totals, device truth and residual.  404 until a
        subsystem registers (an engine build arms the ledger) — the
        /fleet unconfigured convention."""
        from .memory import get_memory_ledger
        doc = get_memory_ledger().to_json()
        if doc is None:
            self.send_error(
                404, "memory ledger unarmed: no subsystem accountants "
                "registered in this process (build an engine first)")
            return
        if params.get("json", ["0"])[0] not in ("", "0"):
            body = json.dumps(doc).encode()
            ctype = "application/json"
        else:
            lines = [f"{'subsystem':<12} {'bytes':>14} {'peak':>14}"]
            for name, b in sorted(doc["subsystems"].items(),
                                  key=lambda kv: -kv[1]):
                lines.append(f"{name:<12} {b:>14} "
                             f"{doc['peaks'].get(name, 0):>14}")
            lines.append(f"{'accounted':<12} "
                         f"{doc['accounted_bytes']:>14} "
                         f"{doc['peak_accounted_bytes']:>14}")
            measured = doc["measured_bytes"]
            lines.append(
                f"{'measured':<12} "
                f"{measured if measured is not None else '-':>14} "
                f"({doc['measured_source']})")
            un = doc["unaccounted_bytes"]
            lines.append(f"{'unaccounted':<12} "
                         f"{un if un is not None else '-':>14}")
            if doc.get("headroom_seqs") is not None:
                lines.append(f"{'headroom':<12} "
                             f"{doc['headroom_seqs']:>14} seqs")
            body = ("\n".join(lines) + "\n").encode()
            ctype = "text/plain; charset=utf-8"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: no per-scrape stderr spam
        pass


def _spawn(srv: ThreadingHTTPServer, name: str) -> None:
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, name=name,
                         daemon=True)
    t.start()


def start_http_server(port: int,
                      addr: Optional[str] = None) -> ThreadingHTTPServer:
    """Start (or return the already-running) process metrics server.
    Port 0 binds an ephemeral port; the bound port is on the returned
    handle (``server_address[1]``), logged, and published as the
    ``ds_telemetry_port`` gauge for federation discovery."""
    global _server
    with _lock:
        if _server is not None:
            bound = _server.server_address[1]
            if int(port) not in (0, bound):
                from ..utils.logging import logger
                logger.warning(
                    "metrics server already bound to port %d; ignoring "
                    "request for port %d (one endpoint per process)",
                    bound, int(port))
            return _server
        addr = addr if addr is not None else os.environ.get(
            "DS_METRICS_ADDR", "127.0.0.1")
        srv = ThreadingHTTPServer((addr, int(port)), _MetricsHandler)
        _spawn(srv, "ds-metrics-http")
        _server = srv
    bound = srv.server_address[1]
    from . import metrics as tm
    tm.TELEMETRY_PORT.set(bound)
    from ..utils.logging import logger
    logger.info("telemetry: metrics endpoint on %s:%d "
                "(/metrics /snapshot /fleet /memory /trace /journey "
                "/healthz)",
                addr, bound)
    return srv


def serve_registry(registry, port: int = 0, addr: Optional[str] = None,
                   timeseries=None,
                   federation=None) -> ThreadingHTTPServer:
    """Start an ADDITIONAL server bound to an explicit registry (and
    optionally its own time-series ring / federation) — same-process
    replica pools and federation tests.  The caller owns shutdown
    (``srv.shutdown(); srv.server_close()``); the process singleton is
    untouched."""
    addr = addr if addr is not None else os.environ.get(
        "DS_METRICS_ADDR", "127.0.0.1")
    srv = ThreadingHTTPServer((addr, int(port)), _MetricsHandler)
    srv.ds_registry = registry
    if timeseries is not None:
        srv.ds_timeseries = timeseries
    if federation is not None:
        srv.ds_federation = federation
    _spawn(srv, "ds-metrics-http-extra")
    return srv


def stop_http_server() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
            # keep the discovery signal truthful: a federation reading
            # ds_telemetry_port must not connect to the dead port
            from . import metrics as tm
            tm.TELEMETRY_PORT.set(0)


def bound_port() -> int:
    """The process endpoint's bound port, 0 when not running."""
    with _lock:
        return _server.server_address[1] if _server is not None else 0


def maybe_start_from_env() -> Optional[ThreadingHTTPServer]:
    """Honor ``DS_METRICS_PORT`` (off when unset; ``0`` = ephemeral
    port, so N replicas on one host never collide).  Bind
    failures degrade to a warning, never an import error: in a
    multi-process job every rank inherits the env var, and only the
    first bind on a host can win a FIXED port — the rest must still be
    able to ``import deepspeed_tpu_torch``."""
    port = os.environ.get("DS_METRICS_PORT", "")
    if not port:
        return None
    try:
        return start_http_server(int(port))
    except (OSError, ValueError) as e:
        from ..utils.logging import logger
        logger.warning(
            "DS_METRICS_PORT=%s: metrics endpoint not started (%s) — "
            "continuing without it", port, e)
        return None
