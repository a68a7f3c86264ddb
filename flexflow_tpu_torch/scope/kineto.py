"""Read the Kineto trace of a `torch.profiler` capture: the port's twin
of `flexflow_tpu/scope/xplane.py`, which decodes the XSpace protobufs a
`jax.profiler` capture writes.

`torch.profiler.profile(activities=[CPU, CUDA])` exports a Chrome trace
(`export_chrome_trace`): one JSON object whose `traceEvents` hold

  - host ranges (`ph: "X"`): `user_annotation` (each
    `torch.profiler.record_function` range: the executor's op and
    runtime scopes) and `cpu_op` (each ATen op, each autograd backward
    function as `autograd::engine::evaluate_function: <Fn>`), with
    `args["Sequence number"]` on the ops that record an autograd node and
    on the backward function that runs it;
  - the CUDA runtime's launches (`cuda_runtime` / `cuda_driver`) and the
    device's work (`kernel`, `gpu_memcpy`, `gpu_memset`), joined by
    `args["correlation"]`.

A capture with no device work (the CPU) has its leaf `cpu_op` ranges as
the work. `load_events` reads a file cut short (a process killed while
exporting) up to its last whole event, as the xplane reader tolerates a
torn protobuf.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

__all__ = ["find_trace_files", "load_events", "HOST_CATS", "DEVICE_CATS",
           "LAUNCH_CATS", "BACKWARD_PREFIX"]

HOST_CATS = ("user_annotation", "cpu_op")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "


def find_trace_files(trace_dir: str) -> List[str]:
    """Every exported trace (`*.json`) under `trace_dir`."""
    out = []
    for root, _dirs, files in os.walk(trace_dir):
        out += [os.path.join(root, f) for f in files if f.endswith(".json")]
    return sorted(out)


def _salvage(text: str) -> List[Dict[str, Any]]:
    """The whole events of a `traceEvents` array cut short."""
    start = text.find('"traceEvents"')
    if start < 0:
        return []
    i = text.find("[", start)
    if i < 0:
        return []
    dec = json.JSONDecoder()
    out: List[Dict[str, Any]] = []
    i += 1
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            break
        try:
            obj, i = dec.raw_decode(text, i)
        except json.JSONDecodeError:
            break
        if isinstance(obj, dict):
            out.append(obj)
    return out


def load_events(path: str) -> List[Dict[str, Any]]:
    """The `traceEvents` of one exported trace; a file cut short yields
    its whole events, an unreadable one none."""
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return []
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        return _salvage(text)
    if isinstance(doc, dict):
        evs = doc.get("traceEvents", [])
    else:
        evs = doc
    return [e for e in evs if isinstance(e, dict)]
