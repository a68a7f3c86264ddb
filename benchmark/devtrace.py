"""Device time from `torch.profiler`: a profiled region of the run, its
kernels and the harness's spans on one clock, and the reductions every
per-layer reader shares (busy time, idle gaps, time by kernel name).

The profiler's Chrome trace is written to a temporary directory under
TMPDIR, read back and deleted. Kernels inside a CUDA graph's replay are
reported one by one. A region is the span named `region`: busy time,
gaps and kernels are clipped to it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
REGION = "region"


@dataclass
class Trace:
    """Device intervals and host spans of one profiled region, in
    microseconds on the profiler's clock."""

    kernels: list = field(default_factory=list)   # (name, start, end)
    spans: list = field(default_factory=list)     # (name, start, end)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of device intervals inside the region, sorted."""
        iv = sorted((max(s, self.start), min(e, self.end))
                    for _, s, e in self.kernels
                    if e > self.start and s < self.end)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(label, seconds) of every interval of the region in which no
        device operation ran, longest first. The label is the innermost
        harness span open on the host when the gap began."""
        gaps, at = [], self.start
        for s, e in self.busy_intervals() + [[self.end, self.end]]:
            if s > at:
                gaps.append((self._label(at), (s - at) / 1e6))
            at = max(at, e)
        return sorted(gaps, key=lambda g: -g[1])

    def _label(self, t: float) -> str:
        best = None
        for name, s, e in self.spans:
            if name != REGION and s <= t < e:
                if best is None or s >= best[1]:
                    best = (name, s)
        return best[0] if best else "between spans"

    def time_by_name(self) -> dict:
        """{kernel name: device seconds inside the region}."""
        out: dict = {}
        for name, s, e in self.kernels:
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def matching(self, patterns) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches any
        of the regular expressions `patterns`."""
        rx = [re.compile(p) for p in patterns]
        secs, n = 0.0, 0
        for name, s, e in self.kernels:
            if e <= self.start or s >= self.end:
                continue
            if any(r.search(name) for r in rx):
                secs += (min(e, self.end) - max(s, self.start)) / 1e6
                n += 1
        return secs, n

    def runs_holding(self, anchors, bounds) -> tuple[float, int]:
        """(device seconds, runs) of the runs of consecutive kernels that
        hold a kernel matching `anchors`, where a run is cut at every
        kernel matching `bounds`: a layer that sits between two matrix
        products, read from the kernels of a captured step in the order
        they ran."""
        ra = [re.compile(p) for p in anchors]
        rb = [re.compile(p) for p in bounds]
        ks = sorted((s, e, name) for name, s, e in self.kernels
                    if e > self.start and s < self.end)
        secs, runs, run_s, held = 0.0, 0, 0.0, False
        for s, e, name in ks + [(self.end, self.end, None)]:
            if name is None or any(r.search(name) for r in rb):
                if held:
                    secs, runs = secs + run_s, runs + 1
                run_s, held = 0.0, False
                continue
            run_s += (min(e, self.end) - max(s, self.start)) / 1e6
            held = held or any(r.search(name) for r in ra)
        return secs, runs

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:top]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()[:top]]}


def parse_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            t.kernels.append((ev.get("name", "?"), s, e))
        elif cat == "user_annotation":
            t.spans.append((ev.get("name", "?"), s, e))
    regions = [(s, e) for n, s, e in t.spans if n == REGION]
    if regions:
        t.start, t.end = min(s for s, _ in regions), max(e for _, e in regions)
    elif t.kernels:
        t.start = min(s for _, s, _ in t.kernels)
        t.end = max(e for _, _, e in t.kernels)
    return t


@contextmanager
def profiled(spans, torch):
    """Profile the body, whose work the caller wraps in
    `spans.span("region")` and finishes with a device synchronise; yields
    a list that holds the parsed `Trace` once the block has closed."""
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield out
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            out.append(parse_chrome_trace(path))
    finally:
        spans.profiling = False
