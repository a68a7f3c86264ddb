"""What every cell of the benchmark shares: finding its files by name,
the harness's own host spans, the statistics, the import check and the
result line.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration is
`configs/<config>.json`, its traffic `traffic/<traffic>.json`, whose
`kind` names the module `kinds/<kind>.py` that runs it, its correctness limits
`limits/<cell>.json`, and each per-layer metric it reports is read by
`metrics/<metric>.py`. Nothing here names a cell, a configuration or a
metric: a later cell comes in as new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that may not be loaded in a run's process: the
# JAX stack and the JAX package the port was made from (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "flexflow_tpu")


def load_json(kind: str, name: str, root: Path | None = None) -> dict:
    path = (root or HERE) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


_modules: dict = {}


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module, once a process. Names may hold dots
    (`metrics/train.step_mfu.py`), so the file is loaded by path."""
    key = (kind, name)
    if key not in _modules:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        mod_name = f"benchmark_{kind}_{name}".replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def benchmark_spec() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


class Cell:
    """One workload with everything the harness finds by its names."""

    def __init__(self, name: str, spec: dict | None = None,
                 data_root: Path | None = None):
        """`data_root` (tests) holds configs/, traffic/ and limits/ in
        place of the benchmark's own."""
        spec = spec or benchmark_spec()
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        self.chips = int(self.workload["chips"])
        self.config = load_json("configs", self.workload["config"],
                                data_root)
        self.traffic = load_json("traffic", self.workload["traffic"],
                                 data_root)
        self.limits = load_json("limits", name, data_root)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def kind(self):
        return load_module("kinds", self.traffic["kind"])


# ------------------------------------------------------------ spans

class Spans:
    """The harness's own spans around its calls into the program. Under
    the profiler each is a `record_function` range, so the trace's idle
    gaps can be named by the span open at the time; otherwise a span costs
    nothing."""

    def __init__(self):
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        if self.profiling:
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            yield


# ------------------------------------------------------------ statistics

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks; +inf entries (requests that failed) sort last."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------ the result

def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def checks_block(numbers: dict, limits: dict) -> dict:
    """{name: {"value": x, "limit": y}} of every number compared."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits}


def is_correct(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)


def device_record(torch, chips: int, peak_bytes: int,
                  busy_s=None, window_s=None) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        out["busy_s"] = float(busy_s)
        out["window_s"] = float(window_s)
    return out


def result_metrics(cell, result: dict, trace: bool) -> dict:
    """The result line's metrics: without `trace` the cell's end-to-end
    metrics, from the values the kind's run measured (`result["end_to_end"]`);
    with it the cell's per-layer metrics, each from its reader over the
    window's numbers and the profiled steps. A reader that finds nothing
    to read returns None and its metric is left out."""
    if not trace:
        values = result["end_to_end"]
        return {m["name"]: metric(values[m["name"]], m["unit"])
                for m in cell.end_to_end if m["name"] in values}
    out = {}
    ctx = {"cell": cell, "window": result["window"], **result["traced"]}
    for m in cell.per_layer:
        v = load_module("metrics", m["name"]).read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = metric(v, m["unit"])
    return out


def print_checks(checks: dict, stream=None):
    stream = stream or sys.stderr
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=stream, flush=True)


# ------------------------------------------------------------ for readers

def peaks() -> dict:
    """The card's published peaks (`counts/h100.json`)."""
    return load_json("counts", "h100")


def patterns(name: str) -> list:
    """Kernel-name patterns of one family (`kernel_names/<name>.json`)."""
    return load_json("kernel_names", name)["patterns"]


def counts(name: str):
    """The operation and byte counts of one family (`counts/<name>.py`)."""
    return load_module("counts", name)
