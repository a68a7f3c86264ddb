"""Multihost hang watchdog: detect a stuck step and leave an artifact
(nearly a copy of `flexflow_tpu/scope/watchdog.py`; a host is a rank).

A hung collective is the worst multihost failure mode: every process
blocks inside a NCCL or CUDA wait, no Python exception fires, and the
job dies by external timeout with no artifact.  The watchdog is a named daemon
thread (``ffscope-watchdog``) that watches *step-boundary progress*:
the fit/serving loop calls :meth:`HangWatchdog.beat` once per step; if
no beat arrives within ``max(timeout_s, step_EMA x multiplier)`` the
watchdog fires — dumps the flight record plus per-host last-heartbeat
state, names the lagging host, and optionally aborts the main thread.

Heartbeats ride a file/dir channel (one small JSON per host under
``<dir>/heartbeats/``), never collectives: a hung collective must not
hang the watchdog.  The lagging host is simply the one whose heartbeat
file is stalest — in a gang-scheduled SPMD program the host that
stopped beating first is the one the others are blocked on. The port
writes a rank's file at every step it ends (the JAX package's at most
every 0.5 s): ranks in lockstep end their steps milliseconds apart, so a
rate-limited file would still hold the step before the stall, on every
rank alike, and name no one.

What it can interrupt: `--watchdog-abort` raises KeyboardInterrupt in the
main thread at its next bytecode. A main thread blocked in a CUDA or
NCCL wait (a `synchronize`, a collective whose peer never comes) does
not run bytecode until the wait returns, so a true NCCL hang is not
interrupted: the flight record and the heartbeats naming the lagging
rank are what it leaves, and the process must be killed from outside.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import flightrec

__all__ = ["HangWatchdog"]

THREAD_NAME = "ffscope-watchdog"


class HangWatchdog:
    """Detect a stuck step from the absence of step-boundary beats."""

    def __init__(self, timeout_s: float = 60.0, multiplier: float = 10.0,
                 directory: Optional[str] = None,
                 host_index: int = 0, abort: bool = False,
                 on_fire=None, poll_interval_s: float = 0.25):
        self.timeout_s = float(timeout_s)
        self.multiplier = float(multiplier)
        self.directory = directory
        self.host_index = int(host_index)
        self.abort = bool(abort)
        self.on_fire = on_fire
        self.poll_interval_s = float(poll_interval_s)
        self.fired = 0
        self.last_fire: Optional[Dict[str, Any]] = None
        self._ema_s: Optional[float] = None
        self._last_beat_t: Optional[float] = None
        self._last_beat_step = -1
        self._armed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --------------------------------------------------------- control

    def start(self) -> "HangWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # ------------------------------------------------------------ beats

    def beat(self, step: int) -> None:
        """Mark step-boundary progress (called from the step loop)."""
        now = time.monotonic()
        prev = self._last_beat_t
        if prev is not None and step > self._last_beat_step:
            dt = now - prev
            self._ema_s = dt if self._ema_s is None else (
                0.8 * self._ema_s + 0.2 * dt)
        advanced = step > self._last_beat_step
        self._last_beat_step = step
        self._last_beat_t = now
        self._armed = True  # a beat (re-)arms after a firing
        if self.directory is not None and advanced:
            self._write_heartbeat(step)

    def deadline_s(self) -> float:
        """Current stall deadline: max(timeout, EMA x multiplier)."""
        if self._ema_s is None:
            return self.timeout_s
        return max(self.timeout_s, self._ema_s * self.multiplier)

    # ------------------------------------------------------- heartbeats

    def _heartbeat_dir(self) -> Optional[str]:
        if self.directory is None:
            return None
        return os.path.join(self.directory, "heartbeats")

    def _write_heartbeat(self, step: int) -> None:
        hb_dir = self._heartbeat_dir()
        if hb_dir is None:
            return
        try:
            os.makedirs(hb_dir, exist_ok=True)
            path = os.path.join(hb_dir, "host-%d.json" % self.host_index)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"host": self.host_index, "step": step,
                           "time_unix": time.time()}, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def read_heartbeats(self) -> List[Dict[str, Any]]:
        """All hosts' last-heartbeat records (file channel only)."""
        hb_dir = self._heartbeat_dir()
        out: List[Dict[str, Any]] = []
        if hb_dir is None or not os.path.isdir(hb_dir):
            return out
        for name in sorted(os.listdir(hb_dir)):
            if not (name.startswith("host-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(hb_dir, name)) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        return out

    @staticmethod
    def lagging_host(heartbeats: List[Dict[str, Any]]) -> Optional[int]:
        """The host whose heartbeat is stalest (lowest step, then oldest
        time) — the one the gang is most plausibly blocked on."""
        if not heartbeats:
            return None
        worst = min(heartbeats, key=lambda h: (
            h.get("step", -1), h.get("time_unix", 0.0)))
        return worst.get("host")

    # ----------------------------------------------------------- firing

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            last = self._last_beat_t
            if last is None or not self._armed:
                continue
            stalled_s = time.monotonic() - last
            if stalled_s <= self.deadline_s():
                continue
            self._armed = False  # fire once; next beat re-arms
            self._fire(stalled_s)

    def _fire(self, stalled_s: float) -> None:
        heartbeats = self.read_heartbeats()
        lagging = self.lagging_host(heartbeats)
        info: Dict[str, Any] = {
            "watchdog": {
                "stalled_s": stalled_s,
                "deadline_s": self.deadline_s(),
                "step_ema_s": self._ema_s,
                "last_step": self._last_beat_step,
                "host": self.host_index,
                "lagging_host": lagging,
                "hosts": heartbeats,
            },
        }
        self.fired += 1
        self.last_fire = info["watchdog"]
        flightrec.record("watchdog", "fire", stalled_s)
        flightrec.dump("watchdog", directory=self.directory, extra=info)
        cb = self.on_fire
        if cb is not None:
            try:
                cb(info["watchdog"])
            except Exception:
                pass
        if self.abort:
            # Best effort: raises KeyboardInterrupt in the main thread
            # at its next bytecode boundary.  A step truly hung inside a
            # native collective won't see it — external supervision must
            # still kill the process; the artifact above is the point.
            import _thread

            _thread.interrupt_main()
