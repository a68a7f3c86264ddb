"""Structured JSONL run-metrics log.

One JSON object per line; the first record of a run is the manifest (mesh
shape, config snapshot, git sha), then one record per
step/epoch/save/compile/search event, plus `summary` records with
percentile step times and throughput — the machine-readable counterpart of
the epoch print lines, following CheckFreq's "measure the save pipeline to
tune it" (PAPERS.md, FAST '21). Summaries are CUMULATIVE snapshots (one
per fit() call); consumers take the last one as the run's numbers.

Schema (stable fields; producers may add more):
  every record: {"kind": str, "t": unix seconds}
  manifest:   config, git_sha, torch_version, cuda_version, device_kind,
              card, process_index, process_count
  compile:    duration_s, num_nodes, searched
  step:       step, epoch, step_time_s, data_wait_s, save_latency_s, ema_step_time_s
  epoch:      epoch, duration_s, examples_per_sec
  checkpoint: step, serialize_s, commit_s, bytes, staleness_s
  search:     evals, cache_hits, best_cost_s
  summary:    steps, p50_step_time_s, p95_step_time_s, examples_per_sec
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Any, Optional


def git_sha(repo_dir: Optional[str] = None) -> str:
    """Best-effort short sha of the enclosing repo ('' when unavailable)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


class MetricsRecorder:
    """Append-only JSONL writer; one flush per record keeps the log live
    (a preempted run's partial log is still readable up to the kill)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")
        # late-write accounting: records arriving after close() (e.g. from
        # the async checkpoint writer outliving the session) are dropped on
        # purpose, but COUNTED — a nonzero count means the log is missing
        # events it was asked to carry, which run_doctor can surface
        self.dropped_after_close = 0

    def record(self, kind: str, **fields: Any):
        rec = {"kind": kind, "t": time.time()}
        rec.update(fields)
        line = json.dumps(rec, default=_json_default)
        with self._lock:
            if self._f.closed:  # late writer-thread event after close
                self.dropped_after_close += 1
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _json_default(o):
    """Tolerate numpy scalars and other simple objects in fields."""
    try:
        return float(o)
    except Exception:
        return repr(o)


def read_jsonl(path: str, strict: bool = False) -> list[dict]:
    """Parse a metrics log back into records (validation / tests / CI).

    A mid-write SIGKILL (real preemptions, fault-injection tests) leaves a
    truncated final line; that partial record is dropped rather than making
    the whole log unreadable — exactly the log a post-mortem most needs to
    read. A malformed record anywhere ELSE still raises (the file is
    corrupt, not merely torn); strict=True raises on any undecodable line,
    including the last."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if strict or i < len(lines) - 1:
                raise
            # torn final record from a mid-write kill: ignore
    return out
