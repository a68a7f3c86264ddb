"""ffpulse metrics plane: typed Counter/Gauge/Histogram registry.

Design rules (docs/observability.md "metrics plane"):

1. **Fixed bucket boundaries.** Every histogram in the fleet uses the same
   log-spaced boundary table (``LOG4_BOUNDS``, 4 buckets per decade from
   1e-6 s to 1e4 s), identified by a ``bounds_id``. Because boundaries are
   shared *by construction*, merging two snapshots — across hosts, across
   time, across engines — is bucket-wise summation and nothing else.
2. **Snapshots are plain JSON.** ``MetricsRegistry.snapshot()`` returns a
   dict that round-trips through json.dumps; ``merge_snapshots`` operates
   on those dicts, so a coordinator can merge snapshots gathered over the
   wire (`distributed.gather_json`) or read back from `metrics.jsonl`
   without reconstructing metric objects.
3. **Percentiles are bucket estimates.** ``percentile_from_hist`` walks the
   cumulative counts and linearly interpolates inside the target bucket;
   the error is bounded by one bucket width (~1.78x ratio), and estimates
   are clamped to the exact observed [min, max].
4. **Merge semantics.** Counters and histogram counts/sums add; histogram
   min/max take min/max; gauges ADD as well — a merged gauge is a fleet
   total (e.g. active slots across hosts), so ratios must be recorded as
   separate numerator/denominator gauges, never pre-divided.

Thread safety: one registry-wide lock guards both child creation and value
updates. The lock is uncontended host-side work (~100ns), far below the
device-step costs it measures. Hot paths that must be zero-cost when
telemetry is off go through `telemetry.inc/observe/set_gauge`, which do a
single global read before touching any registry.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Iterable, Optional

__all__ = [
    "LOG4_BOUNDS", "BUCKET_SCHEMES", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "merge_snapshots", "percentile_from_hist",
    "to_prometheus", "parse_prometheus",
]

# 4 buckets per decade, 1e-6 .. 1e4 (seconds scale covers ns-rounded host
# timings up to multi-hour checkpoints); adjacent-bound ratio 10^0.25.
LOG4_BOUNDS: tuple = tuple(
    round(10.0 ** (k / 4.0), 10) for k in range(-24, 17))

# bounds_id -> boundary table; snapshots reference tables by id so a
# 41-float list is written once per snapshot, not once per histogram.
BUCKET_SCHEMES = {"log4": LOG4_BOUNDS}


def _key(name: str, labels: dict) -> str:
    """Canonical series key: `name` or `name{k="v",...}` with sorted keys
    (Prometheus notation, so snapshot keys read like exposition lines)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


_KEY_RE = re.compile(r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?$')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_key(key: str):
    """Inverse of `_key`: -> (name, labels dict)."""
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"unparseable series key {key!r}")
    name, raw = m.group(1), m.group(2)
    labels = {}
    if raw:
        for lm in _LABEL_RE.finditer(raw):
            labels[lm.group(1)] = lm.group(2).replace('\\"', '"')
    return name, labels


class Counter:
    """Monotonic accumulator. Merge = sum."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, value: float = 1.0):
        with self._lock:
            self.value += value


class Gauge:
    """Last-set point value. Merge = sum (fleet total)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float):
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0):
        with self._lock:
            self.value += value


class Histogram:
    """Fixed-boundary histogram; merge = element-wise count summation.

    `counts[i]` counts observations in (bounds[i-1], bounds[i]];
    `counts[-1]` is the +Inf overflow bucket. Exact sum/min/max ride
    along so means are exact and percentile estimates are clamped."""

    __slots__ = ("bounds_id", "bounds", "counts", "sum", "count",
                 "min", "max", "_lock")

    def __init__(self, lock: threading.Lock, bounds_id: str = "log4"):
        self.bounds_id = bounds_id
        self.bounds = BUCKET_SCHEMES[bounds_id]
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = lock

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self.counts[bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    # -- read-side helpers (also accept snapshot dicts via the module
    #    functions below; these are the object fast path) --

    def percentile(self, q: float) -> float:
        return percentile_from_hist(self.to_dict(), q)

    def to_dict(self) -> dict:
        return {"bounds_id": self.bounds_id, "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": self.min, "max": self.max}


class MetricsRegistry:
    """Label-keyed home of every live metric object in one process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}  # key -> (kind, obj)

    # -- creation (idempotent; first call wins) --

    def _child(self, kind: str, cls, key: str, **kw):
        with self._lock:
            got = self._metrics.get(key)
            if got is not None:
                if got[0] != kind:
                    raise TypeError(
                        f"metric {key!r} already registered as {got[0]}")
                return got[1]
            obj = cls(self._lock, **kw)
            self._metrics[key] = (kind, obj)
            return obj

    def counter(self, name: str, **labels) -> Counter:
        return self._child("counter", Counter, _key(name, labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child("gauge", Gauge, _key(name, labels))

    def histogram(self, name: str, bounds_id: str = "log4",
                  **labels) -> Histogram:
        return self._child("histogram", Histogram, _key(name, labels),
                           bounds_id=bounds_id)

    def get(self, name: str, **labels):
        """Peek without creating (returns None when absent) — read paths
        use this so summaries never allocate series as a side effect."""
        got = self._metrics.get(_key(name, labels))
        return None if got is None else got[1]

    def __len__(self):
        return len(self._metrics)

    def reset(self, prefix: str = ""):
        """Zero every series whose name starts with `prefix` (objects are
        kept — callers hold references)."""
        with self._lock:
            for key, (kind, obj) in self._metrics.items():
                if not key.startswith(prefix):
                    continue
                if kind == "histogram":
                    obj.counts = [0] * len(obj.counts)
                    obj.sum = 0.0
                    obj.count = 0
                    obj.min = None
                    obj.max = None
                else:
                    obj.value = 0.0

    # -- snapshot --

    def snapshot(self) -> dict:
        """Plain-JSON point-in-time copy (see module docstring, rule 2)."""
        with self._lock:
            counters, gauges, hists = {}, {}, {}
            bounds_used = set()
            for key, (kind, obj) in sorted(self._metrics.items()):
                if kind == "counter":
                    counters[key] = obj.value
                elif kind == "gauge":
                    gauges[key] = obj.value
                else:
                    hists[key] = obj.to_dict()
                    bounds_used.add(obj.bounds_id)
        return {
            "schema": 1,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "bucket_bounds": {bid: list(BUCKET_SCHEMES[bid])
                              for bid in sorted(bounds_used)},
        }


def _empty_snapshot() -> dict:
    return {"schema": 1, "counters": {}, "gauges": {}, "histograms": {},
            "bucket_bounds": {}}


def merge_snapshots(snapshots: Iterable[dict]) -> dict:
    """Bucket-wise / element-wise merge. Associative and order-independent
    because every operation is commutative addition (or min/max)."""
    out = _empty_snapshot()
    for snap in snapshots:
        if not snap:
            continue
        for key, v in snap.get("counters", {}).items():
            out["counters"][key] = out["counters"].get(key, 0.0) + v
        for key, v in snap.get("gauges", {}).items():
            out["gauges"][key] = out["gauges"].get(key, 0.0) + v
        out["bucket_bounds"].update(snap.get("bucket_bounds", {}))
        for key, h in snap.get("histograms", {}).items():
            acc = out["histograms"].get(key)
            if acc is None:
                out["histograms"][key] = {
                    "bounds_id": h["bounds_id"],
                    "counts": list(h["counts"]),
                    "sum": h["sum"], "count": h["count"],
                    "min": h.get("min"), "max": h.get("max")}
                continue
            if acc["bounds_id"] != h["bounds_id"]:
                raise ValueError(
                    f"histogram {key!r}: cannot merge bounds "
                    f"{acc['bounds_id']!r} with {h['bounds_id']!r}")
            acc["counts"] = [a + b for a, b in zip(acc["counts"],
                                                   h["counts"])]
            acc["sum"] += h["sum"]
            acc["count"] += h["count"]
            for fld, pick in (("min", min), ("max", max)):
                a, b = acc.get(fld), h.get(fld)
                acc[fld] = (pick(a, b) if a is not None and b is not None
                            else (a if a is not None else b))
    # sort for deterministic artifacts regardless of merge order
    for section in ("counters", "gauges", "histograms"):
        out[section] = dict(sorted(out[section].items()))
    return out


def percentile_from_hist(h: dict, q: float,
                         bounds: Optional[tuple] = None) -> float:
    """Estimate the q-th percentile (0..100) from bucket counts.

    Linear interpolation inside the target bucket bounds the error by one
    bucket width; results clamp to the exact observed [min, max] so p100
    is exact and estimates never leave the data range."""
    count = h.get("count", 0)
    if count <= 0:
        return 0.0
    if bounds is None:
        bounds = BUCKET_SCHEMES[h["bounds_id"]]
    target = (q / 100.0) * count
    seen = 0.0
    lo = 0.0
    for i, c in enumerate(h["counts"]):
        if c <= 0:
            lo = bounds[i] if i < len(bounds) else lo
            continue
        if seen + c >= target:
            hi = bounds[i] if i < len(bounds) else (
                h.get("max") if h.get("max") is not None else lo)
            frac = (target - seen) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            break
        seen += c
        lo = bounds[i] if i < len(bounds) else lo
    else:  # pragma: no cover — count>0 guarantees a break
        est = lo
    mn, mx = h.get("min"), h.get("max")
    if mn is not None:
        est = max(est, mn)
    if mx is not None:
        est = min(est, mx)
    return est


def hist_quantiles(h: Optional[dict],
                   qs=(50, 95, 99)) -> dict:
    """{p50: ..., p95: ...} convenience for summary builders; empty/None
    histogram -> zeros so summaries stay key-stable."""
    if h is None:
        return {f"p{q:g}": 0.0 for q in qs}
    if isinstance(h, Histogram):
        h = h.to_dict()
    return {f"p{q:g}": percentile_from_hist(h, q) for q in qs}


# ---------------------------------------------------------------- Prometheus

def _prom_line_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _prom_series(key: str, extra_labels: dict = None,
                 suffix: str = "") -> str:
    name, labels = parse_key(key)
    if extra_labels:
        labels = dict(labels, **extra_labels)
    return _key(name + suffix, labels)


def to_prometheus(snapshot: dict) -> str:
    """Render a snapshot dict in Prometheus text exposition format 0.0.4.

    Histograms emit cumulative `_bucket{le=...}` series plus `_sum` and
    `_count`; `parse_prometheus` inverts this exactly (round-trip tested)."""
    lines = []
    typed = set()

    def _type(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, v in snapshot.get("counters", {}).items():
        _type(parse_key(key)[0], "counter")
        lines.append(f"{key} {_prom_line_value(v)}")
    for key, v in snapshot.get("gauges", {}).items():
        _type(parse_key(key)[0], "gauge")
        lines.append(f"{key} {_prom_line_value(v)}")
    bounds_map = snapshot.get("bucket_bounds", {})
    for key, h in snapshot.get("histograms", {}).items():
        name = parse_key(key)[0]
        _type(name, "histogram")
        bounds = bounds_map.get(h["bounds_id"],
                                BUCKET_SCHEMES.get(h["bounds_id"], ()))
        cum = 0
        for i, c in enumerate(h["counts"]):
            cum += c
            le = bounds[i] if i < len(bounds) else math.inf
            lines.append(
                f"{_prom_series(key, {'le': _prom_line_value(le)}, '_bucket')}"
                f" {cum}")
        lines.append(f"{_prom_series(key, suffix='_sum')} "
                     f"{_prom_line_value(h['sum'])}")
        lines.append(f"{_prom_series(key, suffix='_count')} {cum}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse exposition text back into a snapshot-shaped dict.

    Only what `to_prometheus` emits is supported (the round-trip
    contract); histogram min/max/exactness are lost by design — they are
    not part of the exposition format — so round-trip equality is checked
    on counters, gauges, and histogram counts/sum/count."""
    out = _empty_snapshot()
    types: dict = {}
    hist_raw: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        key, _, val = line.rpartition(" ")
        key = key.strip()
        v = math.inf if val == "+Inf" else float(val)
        name, labels = parse_key(key)
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(
                    name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                part = suffix[1:]
                break
        if base is not None:
            le = labels.pop("le", None)
            hkey = _key(base, labels)
            slot = hist_raw.setdefault(hkey, {"buckets": [], "sum": 0.0,
                                              "count": 0})
            if part == "bucket":
                slot["buckets"].append(
                    (math.inf if le == "+Inf" else float(le), v))
            elif part == "sum":
                slot["sum"] = v
            else:
                slot["count"] = int(v)
            continue
        kind = types.get(name, "gauge")
        section = "counters" if kind == "counter" else "gauges"
        out[section][key] = v
    for hkey, raw in hist_raw.items():
        raw["buckets"].sort(key=lambda b: b[0])
        finite = [b[0] for b in raw["buckets"] if b[0] != math.inf]
        bounds_id = None
        for bid, bounds in BUCKET_SCHEMES.items():
            if list(bounds) == finite:
                bounds_id = bid
                break
        counts, prev = [], 0
        for _, cum in raw["buckets"]:
            counts.append(int(cum) - prev)
            prev = int(cum)
        out["histograms"][hkey] = {
            "bounds_id": bounds_id or "custom",
            "counts": counts, "sum": raw["sum"], "count": raw["count"],
            "min": None, "max": None}
        if bounds_id is None:
            out["bucket_bounds"]["custom"] = finite
        else:
            out["bucket_bounds"][bounds_id] = list(
                BUCKET_SCHEMES[bounds_id])
    return out
