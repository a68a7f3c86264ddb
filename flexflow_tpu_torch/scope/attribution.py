"""Attribute profiled device time back to PCG ops (twin of
`flexflow_tpu/scope/attribution.py`).

The executor wraps every op's forward in
``torch.profiler.record_function(node.name)`` (plus the ``grad_sync`` /
``param_gather`` / ``weight_update_shard`` / ``weight_update`` /
``metrics`` runtime scopes) while a profile is taken, where the JAX
executor opens ``jax.named_scope(node.name)``. This module joins the two
halves of a Kineto capture (scope/kineto.py):

  * each device event (a kernel, a copy, a memset: on the CPU each leaf
    ATen op) and the host range its launch falls in, by correlation id;
  * the host ranges: an op's forward kernels launch inside its range;
    its backward kernels launch inside the autograd backward function
    (`autograd::engine::evaluate_function: ...`), outside any op range,
    and are given to the op whose range saw the forward op with the same
    autograd sequence number,

into the report's ``profile`` section: per-op ``measured_s`` next to the
plan's ``predicted_s``, fidelity ratios, and the attribution identity
the doctor re-verifies from the JSON alone:

    attributed_s + unattributed_s == device_time_s * parallelism

within a stated ``slop`` — where ``parallelism`` is the number of
distinct trace lines (device streams; on the CPU, threads) that carried
attributed events. A CUDA-graph replay shows its kernels but no host
range, so a sampled step runs eagerly (`StepProfiler`, the executor's
`scoped`): the same function, the same kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from . import kineto

__all__ = [
    "attribute_trace",
    "build_profile_section",
    "annotate_with_predictions",
    "verify_profile_section",
    "RUNTIME_LABELS",
]

# Runtime scopes the executor emits that are not PCG node names.  They
# are attributed into the section's ``extras`` map instead of ``ops``.
# The port adds ``loss`` (the loss on the logits, forward and backward),
# which the JAX package leaves in no scope.
RUNTIME_LABELS = ("grad_sync", "param_gather", "weight_update_shard",
                  "weight_update", "metrics", "loss")

# Identity slop: the step window is measured with a host clock around
# the dispatch; keep a generous but stated tolerance so the identity is
# meaningful yet robust.
DEFAULT_SLOP = 0.25

_US = 1e-6  # Chrome-trace times are microseconds


def _sweep(ranges: List[tuple], points: List[tuple]) -> Dict[int, tuple]:
    """For each point (time, id) of one thread, the ranges (ts, end,
    payload) of that thread enclosing it, innermost first. The ranges of
    one thread nest, so one sweep in time order keeps them on a stack."""
    items = [(r[0], 0, -(r[1] - r[0]), i) for i, r in enumerate(ranges)]
    items += [(t, 1, 0, pid) for t, pid in points]
    items.sort()
    stack: List[tuple] = []
    out: Dict[int, tuple] = {}
    for t, kind, _neg, idx in items:
        while stack and stack[-1][1] < t:
            stack.pop()
        if kind == 0:
            stack.append(ranges[idx])
        else:
            out[idx] = tuple(reversed(stack))
    return out


def attribute_trace(trace_dir: str, op_names: Iterable[str],
                    ) -> Dict[str, Any]:
    """Parse every Kineto trace under ``trace_dir`` and attribute device
    time to ``op_names`` + runtime labels.

    Returns ``{"ops": {name: {"measured_s", "fwd_s", "bwd_s",
    "events"}}, "extras": {label: seconds}, "attributed_s",
    "unattributed_s", "parallelism", "devices", "unattributed_top"}``;
    the last, the device events no op or scope took, by (name, innermost
    host range of their launch), the largest first (at most 12).
    """
    names = set(op_names)
    ops: Dict[str, Dict[str, float]] = {}
    extras: Dict[str, float] = {}
    attributed = 0.0
    unattributed = 0.0
    lines_with_events: Set[Tuple[Any, Any]] = set()
    devices: Set[Any] = set()
    missed: Dict[Tuple[str, str], float] = {}

    for path in kineto.find_trace_files(trace_dir):
        events = [e for e in kineto.load_events(path)
                  if e.get("ph") == "X" and "ts" in e]
        # host ranges per thread: (ts, end, (name, cat, seq))
        host: Dict[Any, List[tuple]] = {}
        for e in events:
            if e.get("cat") in kineto.HOST_CATS:
                ts = float(e["ts"])
                seq = (e.get("args") or {}).get("Sequence number")
                host.setdefault(e.get("tid"), []).append(
                    (ts, ts + float(e.get("dur", 0.0)),
                     (e.get("name", ""), e.get("cat"), seq)))
        launches = {}
        for e in events:
            if e.get("cat") in kineto.LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), float(e["ts"]))
        # device work: (line, seconds, launching thread, launch time,
        # name)
        work: List[tuple] = []
        for e in events:
            if e.get("cat") in kineto.DEVICE_CATS:
                corr = (e.get("args") or {}).get("correlation")
                at = launches.get(corr)
                work.append(((e.get("pid"), e.get("tid")),
                             float(e.get("dur", 0.0)) * _US,
                             at[0] if at else None,
                             at[1] if at else None, e.get("name", "")))
        if not any(e.get("cat") in kineto.DEVICE_CATS for e in events):
            # no device in the capture: the leaf ATen ops are the work
            for tid, rs in host.items():
                ops_only = sorted((r for r in rs if r[2][1] == "cpu_op"),
                                  key=lambda r: (r[0], r[0] - r[1]))
                stack: List[tuple] = []
                inner: Set[int] = set()
                for r in ops_only:
                    while stack and stack[-1][1] < r[0]:
                        stack.pop()
                    if stack:
                        inner.add(id(stack[-1]))
                    stack.append(r)
                for r in ops_only:
                    if id(r) not in inner:
                        work.append((("host", tid), (r[1] - r[0]) * _US,
                                     tid, r[0] + 1e-3, r[2][0]))
        # forward ops' autograd sequence numbers -> the op range they ran in
        # (else the runtime scope: the loss's backward)
        seq_owner: Dict[Any, str] = {}
        for tid, rs in host.items():
            points = [(r[0], i) for i, r in enumerate(rs)
                      if r[2][1] == "cpu_op" and r[2][2] is not None
                      and not r[2][0].startswith(kineto.BACKWARD_PREFIX)]
            for i, enclosing in _sweep(rs, points).items():
                ranges = [name for _ts, _end, (name, cat, _seq) in enclosing
                          if cat == "user_annotation"]
                owner = next((n for n in ranges if n in names), None) or \
                    next((n for n in ranges if n in RUNTIME_LABELS), None)
                if owner is not None:
                    seq_owner.setdefault(rs[i][2][2], owner)
        # each device event's launch point -> its label
        by_tid: Dict[Any, List[tuple]] = {}
        for i, w in enumerate(work):
            if w[2] is not None:
                by_tid.setdefault(w[2], []).append((w[3], i))
        enclosing_of: Dict[int, tuple] = {}
        for tid, points in by_tid.items():
            enclosing_of.update(_sweep(host.get(tid, []), points))
        for i, (line, dur_s, _tid, _t, ev_name) in enumerate(work):
            lines_with_events.add(line)
            devices.add(line[0])
            label, is_bwd = "", False
            for _ts, _end, (name, cat, seq) in enclosing_of.get(i, ()):
                if cat == "user_annotation" and name in names:
                    label = name
                    break
                if (name.startswith(kineto.BACKWARD_PREFIX)
                        and seq_owner.get(seq) in names):
                    label, is_bwd = seq_owner[seq], True
                    break
            if not label:
                for _ts, _end, (name, cat, seq) in enclosing_of.get(i, ()):
                    if cat == "user_annotation" and name in RUNTIME_LABELS:
                        label = name
                        break
                    if (name.startswith(kineto.BACKWARD_PREFIX)
                            and seq in seq_owner):
                        label = seq_owner[seq]
                        break
            if not label:
                unattributed += dur_s
                encl = enclosing_of.get(i, ())
                key = (ev_name[:80], encl[0][2][0][:80] if encl else "")
                missed[key] = missed.get(key, 0.0) + dur_s
                continue
            attributed += dur_s
            if label in names:
                rec = ops.setdefault(label, {
                    "measured_s": 0.0, "fwd_s": 0.0,
                    "bwd_s": 0.0, "events": 0})
                rec["measured_s"] += dur_s
                rec["bwd_s" if is_bwd else "fwd_s"] += dur_s
                rec["events"] += 1
            else:
                extras[label] = extras.get(label, 0.0) + dur_s

    return {
        "ops": ops,
        "extras": extras,
        "attributed_s": attributed,
        "unattributed_s": unattributed,
        "parallelism": max(1, len(lines_with_events)),
        "devices": max(1, len(devices)),
        "unattributed_top": [
            {"event": k[0], "launched_in": k[1], "s": v}
            for k, v in sorted(missed.items(), key=lambda kv: -kv[1])[:12]],
    }


def build_profile_section(attr: Dict[str, Any], *, step: int,
                          device_time_s: float,
                          source: str = "xplane",
                          all_op_names: Optional[Iterable[str]] = None,
                          slop: float = DEFAULT_SLOP) -> Dict[str, Any]:
    """Shape an :func:`attribute_trace` result (or standalone profiler
    numbers in the same layout) into the report ``profile`` section.

    Every name in ``all_op_names`` gets a row even when no event was
    attributed to it (``measured_s == 0.0`` — e.g. fused away), so
    downstream gates can rely on a measured column for every report op.
    """
    rows: List[Dict[str, Any]] = []
    seen = set()
    for name, rec in sorted(attr["ops"].items()):
        rows.append({"name": name,
                     "measured_s": rec["measured_s"],
                     "fwd_s": rec.get("fwd_s", 0.0),
                     "bwd_s": rec.get("bwd_s", 0.0),
                     "events": rec.get("events", 0)})
        seen.add(name)
    for name in (all_op_names or ()):
        if name not in seen:
            rows.append({"name": name, "measured_s": 0.0, "fwd_s": 0.0,
                         "bwd_s": 0.0, "events": 0})
            seen.add(name)
    return {
        "source": source,
        "step": step,
        "device_time_s": device_time_s,
        "devices": attr.get("devices", 1),
        "parallelism": attr.get("parallelism", 1),
        "slop": slop,
        "attributed_s": attr.get("attributed_s", 0.0),
        "unattributed_s": attr.get("unattributed_s", 0.0),
        "ops": rows,
        "extras": dict(attr.get("extras", {})),
    }


def annotate_with_predictions(section: Dict[str, Any],
                              report: Dict[str, Any]) -> Dict[str, Any]:
    """Attach per-op ``predicted_s`` and ``fidelity`` from a strategy
    report's ``ops`` table.  ``fidelity = measured_s / predicted_s`` —
    recomputable from the JSON alone, which is what run_doctor checks.
    """
    predicted = {o["name"]: float(o.get("compute_s", 0.0))
                 + float(o.get("comm_s", 0.0))
                 for o in report.get("ops", [])}
    for row in section.get("ops", []):
        p = predicted.get(row["name"])
        if p is None:
            continue
        row["predicted_s"] = p
        row["fidelity"] = (row["measured_s"] / p) if p > 0 else None
    return section


def verify_profile_section(section: Dict[str, Any]) -> List[str]:
    """Re-verify the attribution identity from the JSON alone.

    Returns a list of problem strings (empty == green).  Shared by
    ``run_doctor --check`` and the tests.
    """
    problems: List[str] = []
    ops = section.get("ops", [])
    attributed = sum(float(o.get("measured_s", 0.0)) for o in ops)
    attributed += sum(float(v) for v in
                      section.get("extras", {}).values())
    stated = (float(section.get("attributed_s", 0.0)))
    tol = 1e-9 + 1e-6 * abs(stated)
    if abs(attributed - stated) > tol:
        problems.append(
            "profile: sum of per-op measured_s %.9f != stated "
            "attributed_s %.9f" % (attributed, stated))
    budget = (float(section.get("device_time_s", 0.0))
              * float(section.get("parallelism", 1))
              * (1.0 + float(section.get("slop", DEFAULT_SLOP))))
    total = attributed + float(section.get("unattributed_s", 0.0))
    if section.get("source") == "xplane" and total > budget + 1e-9:
        problems.append(
            "profile: attributed+unattributed %.6fs exceeds device "
            "budget %.6fs (device_time_s x parallelism x (1+slop))"
            % (total, budget))
    for o in ops:
        p = o.get("predicted_s")
        f = o.get("fidelity")
        if p and f is not None:
            want = float(o.get("measured_s", 0.0)) / float(p)
            if abs(want - float(f)) > 1e-9 + 1e-6 * abs(want):
                problems.append(
                    "profile: op %s fidelity %.9f not recomputable "
                    "(measured/predicted = %.9f)"
                    % (o.get("name"), float(f), want))
    return problems
