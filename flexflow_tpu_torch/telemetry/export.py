"""ffpulse continuous export: rolling snapshots, a Prometheus file, /metrics.

While a run is alive the exporter periodically (``--metrics-interval``):

1. merges every attached registry into one snapshot (`merge_snapshots` —
   the same code path a cross-host merge uses, so a single-process run
   still exercises the merge invariants),
2. appends a ``metrics_snapshot`` record to `metrics.jsonl` (rolling — one
   record per interval, each self-contained), and
3. atomically rewrites ``<dir>/metrics.prom`` in text exposition format.

``--metrics-port`` additionally serves the LATEST rendered exposition at
``/metrics`` and liveness at ``/healthz`` from a stdlib ThreadingHTTPServer
daemon thread — no third-party dependency, read-only, coordinator-only
(non-coordinator processes never construct an exporter; see
`TelemetrySession.start_exporter`).

Everything here runs on a daemon thread and must therefore never call into
collectives: snapshots are process-local; cross-host merges happen at
explicit barrier points (`distributed.gather_json`) where every process
participates.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from .metrics import to_prometheus

__all__ = ["MetricsExporter"]


class MetricsExporter:
    """Interval snapshot writer + optional /metrics endpoint.

    `collect` returns a merged snapshot dict; `record` appends one
    metrics_snapshot JSONL record (both supplied by the session so the
    exporter stays free of session internals)."""

    def __init__(self, directory: str, collect: Callable[[], dict],
                 record: Callable[..., None],
                 interval_s: float = 0.0, port: int = 0):
        self.directory = directory
        self._collect = collect
        self._record = record
        self.interval_s = float(interval_s)
        self.port = int(port)
        self.prom_path = os.path.join(directory, "metrics.prom")
        self._latest_prom = ""
        self._latest_t: Optional[float] = None
        self._seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None

    # ------------------------------------------------------------ snapshot

    def snapshot_now(self, reason: str = "interval", **flags) -> dict:
        """One export cycle: collect -> JSONL record -> prom file. Safe to
        call from any thread; also the drain/final hook."""
        snap = self._collect()
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._record("metrics_snapshot", reason=reason, seq=seq,
                     metrics=snap, **flags)
        text = to_prometheus(snap)
        tmp = self.prom_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.prom_path)
        except OSError:
            pass
        with self._lock:
            self._latest_prom = text
            self._latest_t = time.monotonic()
        return snap

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="ffpulse-export", daemon=True)
            self._thread.start()
        if self.port and self._server is None:
            self._start_server()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot_now("interval")
            except Exception:  # never kill the run from the export thread
                pass

    def stop(self, final_reason: Optional[str] = "final", **flags):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:
                pass
            self._server = None
        if final_reason:
            try:
                self.snapshot_now(final_reason, **flags)
            except Exception:
                pass

    # ------------------------------------------------------------ HTTP

    def _start_server(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep stderr clean
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    with exporter._lock:
                        text = exporter._latest_prom
                    if not text:
                        # first scrape before the first interval tick:
                        # render on demand so /metrics is never empty
                        try:
                            text = to_prometheus(exporter._collect())
                        except Exception:
                            text = ""
                    self._send(200, text.encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    with exporter._lock:
                        age = (None if exporter._latest_t is None
                               else time.monotonic() - exporter._latest_t)
                    body = json.dumps({
                        "status": "ok",
                        "snapshots": exporter._seq,
                        "last_snapshot_age_s": age,
                    }).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")

        try:
            self._server = ThreadingHTTPServer(("127.0.0.1", self.port),
                                               Handler)
        except OSError:
            self._server = None
            return
        self.port = self._server.server_address[1]  # resolve port 0
        t = threading.Thread(target=self._server.serve_forever,
                             name="ffpulse-http", daemon=True)
        t.start()
