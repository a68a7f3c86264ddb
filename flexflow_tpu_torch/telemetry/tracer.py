"""Chrome trace-event tracer: host-side spans, counters, instant events.

The reference's observability is per-kernel prints under `m->profiling`
(linear_kernels.cu:95-117) plus the Unity simulator's cost breakdown; what
dominated a *run* (compile, search, input stalls, checkpoint saves) was
invisible. This tracer records host-side phases as Chrome trace events —
the `chrome://tracing` / Perfetto JSON array format, the same format
`jax.profiler` and TensorFlow emit — so run-level timelines load in the
exact tool used for device-level XProf dumps.

Design constraints:
- low overhead ON: one `perf_counter` pair + one dict append per span, no
  I/O until `dump()`;
- near-zero overhead OFF: callers go through `telemetry.span(...)` which
  short-circuits to a shared no-op context manager before any Tracer code
  runs (see __init__.py);
- thread-safe: the resilience writer thread emits serialize/commit spans
  concurrently with the train loop's step spans; events carry the emitting
  thread's id and the buffer append happens under a lock;
- bounded memory: the buffer caps at `max_events` (drops are counted and
  surfaced as a final counter event rather than silently lost).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional


class _Span:
    """Context manager recording one complete ("ph": "X") event."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self.tracer._complete(self.name, self.t0, t1, self.args)
        return False


class Tracer:
    def __init__(self, pid: int = 0, max_events: int = 500_000):
        self.pid = int(pid)
        self.max_events = int(max_events)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0
        self._named_threads: set[int] = set()

    # ------------------------------------------------------------ emit

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _append(self, ev: dict):
        tid = threading.get_ident()
        ev["pid"] = self.pid
        ev["tid"] = tid
        with self._lock:
            if tid not in self._named_threads:
                self._named_threads.add(tid)
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    @property
    def dropped(self) -> int:
        """Events lost to the `max_events` cap — surfaced by the session's
        end-of-fit summary and a telemetry.log warning so a silently
        truncated trace never masquerades as a complete one."""
        with self._lock:
            return self._dropped

    def span(self, name: str, **args) -> _Span:
        """`with tracer.span("compile"): ...` — one X event on exit."""
        return _Span(self, name, args or None)

    def _complete(self, name: str, t0: float, t1: float,
                  args: Optional[dict]):
        ev = {
            "name": name, "ph": "X",
            "ts": self._us(t0), "dur": (t1 - t0) * 1e6,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def complete(self, name: str, t0: float, t1: float, **args):
        """Record a completed span from explicit `perf_counter`
        timestamps — for synthesized events whose window was not
        measured by a live `with span(...)` block (the pipelined engine
        reconstructs per-step spans from one chunk's wall window)."""
        self._complete(name, t0, t1, args or None)

    def instant(self, name: str, **args):
        """Zero-duration marker (preemption notice, resume, best-cost)."""
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self._us(time.perf_counter())}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, values: dict[str, Any]):
        """Counter sample — Perfetto renders these as stacked time series."""
        self._append({
            "name": name, "ph": "C",
            "ts": self._us(time.perf_counter()),
            "args": {k: float(v) for k, v in values.items()},
        })

    # ------------------------------------------------------------ dump

    def to_dict(self) -> dict:
        """Chrome trace-event JSON object ({"traceEvents": [...]})."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        head = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "flexflow_tpu"},
        }]
        if dropped:
            head.append({
                "name": "tracer.dropped_events", "ph": "C", "pid": self.pid,
                "tid": 0, "ts": 0.0, "args": {"dropped": float(dropped)},
            })
        return {"traceEvents": head + events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write the trace atomically (tmp + rename) so a reader never sees
        a torn file; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"  # ranks may share the dir
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
