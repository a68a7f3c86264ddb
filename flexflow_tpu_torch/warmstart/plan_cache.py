"""Content-addressed persistent plan cache (twin of
`flexflow_tpu/warmstart/plan_cache.py`).

Layout under the warm-start directory:

    <warmstart-dir>/plans/<full-fingerprint>.json
    {"version": 1, "fingerprint": ..., "structural_fingerprint": ...,
     "strategy": <Strategy.to_json()>, "mesh_axes": {...}, "meta": {...}}

One file per fingerprint, written atomically (tmp + rename) by the
coordinator only. Lookup is a single read keyed by the address; anything
wrong with the entry — unparseable JSON, wrong version, fingerprint not
matching its own filename, strategy that fails schema decode — logs a
warning and reads as a miss (the compile then searches fresh and rewrites
the entry). A cache must never be able to fail a compile.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..telemetry import log as fflog

_PLAN_VERSION = 1


def strategy_json_problems(strategy_json: dict) -> list[str]:
    """Graph-free sanity check of a serialized Strategy (the plan-cache
    entry format): per-assignment axis reuse is detectable from the JSON
    alone, so the cache can reject a poisoned entry without decoding it
    against a graph. A copy of the JAX package's
    `analysis/sharding.strategy_json_problems` (ROADMAP A9 ports the
    module), each finding as its text."""
    findings: list[str] = []

    def reuse(ax, seen, dim, where):
        findings.append(f"ERROR axis_reuse [{where}]: axis {ax!r} on dims "
                        f"{seen[ax]} and {dim}")

    for name, ov in (strategy_json.get("nodes") or {}).items():
        for idx, assignment in (ov.get("outputs") or {}).items():
            seen: dict = {}
            for dim, entry in enumerate(assignment or []):
                for ax in (entry or []):
                    if ax in seen:
                        reuse(ax, seen, dim, f"{name}:output{idx}")
                    else:
                        seen[ax] = dim
        for wname, entries in (ov.get("weights") or {}).items():
            seen = {}
            for dim, entry in enumerate(entries or []):
                axes = (entry if isinstance(entry, list)
                        else [entry] if entry is not None else [])
                for ax in axes:
                    if ax in seen:
                        reuse(ax, seen, dim, f"{name}:{wname}")
                    else:
                        seen[ax] = dim
    return findings


class PlanCache:
    def __init__(self, directory: str):
        self.directory = os.path.join(os.path.abspath(directory), "plans")

    def _path(self, fingerprint: str) -> str:
        return os.path.join(self.directory, f"{fingerprint}.json")

    def lookup(self, fingerprint: str) -> Optional[dict]:
        """The committed entry for `fingerprint`, or None. Corrupt/stale
        entries warn and read as a miss — never raise."""
        path = self._path(fingerprint)
        try:
            with open(path) as f:
                entry = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            fflog.warning(
                "warmstart: plan cache entry %s unreadable (%s) — "
                "treating as a miss", path, e)
            return None
        if (not isinstance(entry, dict)
                or entry.get("version") != _PLAN_VERSION
                or entry.get("fingerprint") != fingerprint
                or not isinstance(entry.get("strategy"), dict)):
            fflog.warning(
                "warmstart: plan cache entry %s malformed/stale — "
                "treating as a miss", path)
            return None
        # graph-free precheck: per-assignment mesh-axis reuse is an
        # invalid placement detectable from the JSON alone; a poisoned or
        # hand-edited entry reads as a miss here, before Strategy.validate
        # sees it against the graph downstream
        problems = strategy_json_problems(entry["strategy"])
        if problems:
            fflog.warning(
                "warmstart: plan cache entry %s fails static "
                "verification (%s) — treating as a miss",
                path, "; ".join(str(p) for p in problems[:3]))
            return None
        return entry

    def store(self, fingerprint: str, strategy_json: dict,
              mesh_axes: dict, structural_fingerprint: str = "",
              meta: Optional[dict] = None) -> Optional[str]:
        """Write one plan entry atomically. Returns the path, or None when
        the write failed (warned, not raised). Callers gate on
        `distributed.is_coordinator()` — multi-host, only host 0 writes."""
        entry = {
            "version": _PLAN_VERSION,
            "fingerprint": fingerprint,
            "structural_fingerprint": structural_fingerprint,
            "strategy": strategy_json,
            "mesh_axes": {k: int(v) for k, v in (mesh_axes or {}).items()},
            "created_unix": time.time(),
            "meta": dict(meta or {}),
        }
        path = self._path(fingerprint)
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(entry, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError as e:
            fflog.warning(
                "warmstart: could not persist plan entry %s: %s", path, e)
            return None
