"""Run doctor: post-mortem report from a telemetry directory (twin of
`flexflow_tpu/diagnostics/doctor.py`: it reads only files, so it gives
the JAX package's doctor's verdict on either package's directory).

Reads whatever a run left behind — metrics.jsonl (tolerant of a torn final
line), alerts.jsonl, strategy_report.json, trace.json — and renders one
markdown report answering the post-mortem questions in order: did the run
die (alerts), was it slow (step/percentile stats + top trace spans), did
the input pipeline stall (data-wait fraction), did the cost model drift
(predicted vs measured), and is the trace complete (dropped events).

`diagnose()` returns the structured findings so tests and tooling can
assert on them; the JAX package's `scripts/run_doctor.py` is the CLI (it
reads the port's directories alike).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..telemetry.recorder import read_jsonl


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _load_jsonl(path: str) -> list[dict]:
    try:
        return read_jsonl(path)
    except OSError:
        return []
    except json.JSONDecodeError:
        # read_jsonl tolerates only a torn FINAL line; the doctor's job is
        # to explain damaged runs, so mid-file corruption degrades to
        # "every record that still parses" instead of crashing
        out = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            pass
        return out


def diagnose(directory: str) -> dict:
    """Structured post-mortem of one telemetry dir. Every section is
    present (possibly empty) so renderers/tests need no existence
    checks."""
    directory = os.path.abspath(directory)
    metrics = _load_jsonl(os.path.join(directory, "metrics.jsonl"))
    alerts = _load_jsonl(os.path.join(directory, "alerts.jsonl"))
    report = _load_json(os.path.join(directory, "strategy_report.json"))
    trace = _load_json(os.path.join(directory, "trace.json"))

    by_kind: dict[str, list[dict]] = {}
    for r in metrics:
        by_kind.setdefault(r.get("kind", "?"), []).append(r)
    manifest = (by_kind.get("manifest") or [{}])[0]
    steps = by_kind.get("step", [])
    summary = (by_kind.get("summary") or [None])[-1]
    checkpoints = by_kind.get("checkpoint", [])
    searches = by_kind.get("search", [])
    compiles = by_kind.get("compile", [])
    replans = by_kind.get("replan", [])

    data_wait_frac = None
    if steps:
        tot = sum(s.get("step_time_s", 0.0) for s in steps)
        if tot > 0:
            data_wait_frac = (
                sum(s.get("data_wait_s", 0.0) for s in steps) / tot)

    drift = None
    if report is not None and steps:
        predicted = report.get("total_predicted_s")
        measured = [s.get("device_time_s") for s in steps[1:]
                    if s.get("device_time_s")]
        if predicted and measured:
            mean_meas = sum(measured) / len(measured)
            drift = {
                "predicted_s": predicted,
                "mean_measured_s": mean_meas,
                "error": abs(mean_meas - predicted) / predicted,
            }

    spans: dict[str, dict] = {}
    dropped_events = 0
    if trace is not None:
        for e in trace.get("traceEvents", []):
            if e.get("ph") == "X":
                s = spans.setdefault(e["name"], {"count": 0, "total_us": 0.0})
                s["count"] += 1
                s["total_us"] += e.get("dur", 0.0)
            elif e.get("name") == "tracer.dropped_events":
                dropped_events = int(e.get("args", {}).get("dropped", 0))

    # ffpulse: the LAST metrics_snapshot is the run's final merged
    # registry state; derive the latency/goodput/pool tables from it
    snapshots = by_kind.get("metrics_snapshot", [])
    metrics_plane = None
    if snapshots:
        from ..telemetry.metrics import percentile_from_hist

        snap = snapshots[-1].get("metrics", {}) or {}
        bounds_map = snap.get("bucket_bounds", {})
        latency = {}
        for key, h in (snap.get("histograms") or {}).items():
            if not h.get("count"):
                continue
            bounds = tuple(bounds_map.get(h.get("bounds_id"), ()))
            row = {"count": h["count"],
                   "mean_s": h["sum"] / h["count"]}
            for q in (50, 95, 99):
                row[f"p{q}_s"] = percentile_from_hist(
                    h, q, bounds=bounds or None)
            row["max_s"] = h.get("max")
            latency[key] = row
        metrics_plane = {
            "snapshots": len(snapshots),
            "reason": snapshots[-1].get("reason"),
            "latency": latency,
            "gauges": snap.get("gauges", {}),
            "counters": snap.get("counters", {}),
        }

    # ffscope: the report's profile section (either source) and the
    # flight record, when the run left one behind
    profile = report.get("profile") if report else None
    flight = _load_json(os.path.join(directory, "flight.json"))
    watchdog = None
    if flight is not None and flight.get("watchdog"):
        watchdog = flight["watchdog"]
    else:
        wd_alerts = [a for a in alerts
                     if a.get("rule") == "hang_watchdog"]
        if wd_alerts:
            watchdog = wd_alerts[-1]

    preempted = bool(by_kind.get("preempted"))
    resumed = bool(by_kind.get("resume"))
    errors = [a for a in alerts if a.get("level") == "error"]
    aborted = any(a.get("action") == "abort" for a in alerts)
    if aborted or errors:
        verdict = "dead"
    elif preempted:
        verdict = "preempted"
    elif alerts:
        verdict = "degraded"
    elif steps:
        verdict = "healthy"
    else:
        verdict = "no-steps"

    return {
        "directory": directory,
        "verdict": verdict,
        "manifest": manifest,
        "compile": (compiles or [None])[-1],
        "search": (searches or [None])[-1],
        "steps": len(steps),
        "summary": summary,
        "data_wait_frac": data_wait_frac,
        "alerts": alerts,
        "drift": drift,
        "checkpoints": {
            "count": len(checkpoints),
            "last_staleness_s": (checkpoints[-1].get("staleness_s")
                                 if checkpoints else None),
            "total_bytes": sum(c.get("bytes", 0) for c in checkpoints),
        },
        "preempted": preempted,
        "resumed": resumed,
        "metrics_plane": metrics_plane,
        "replans": replans,
        "trace_spans": spans,
        "trace_dropped_events": dropped_events,
        "strategy_report": report,
        "serving_disagg": (report or {}).get("serving_disagg"),
        "speculation": (report or {}).get("speculation"),
        "profile": profile,
        "flight": flight,
        "watchdog": watchdog,
    }


def render(d: dict) -> str:
    """Markdown post-mortem from a diagnose() result."""
    lines = [f"# Run doctor — `{d['directory']}`", "",
             f"**Verdict: {d['verdict'].upper()}**", ""]
    man = d["manifest"]
    if man:
        mesh = man.get("mesh_axes") or {}
        lines.append(
            "- mesh: `" + ", ".join(f"{k}={v}" for k, v in mesh.items())
            + f"`  ·  backend: "
            f"{man.get('jax_backend') or man.get('device_kind', '?')}"
            + f"  ·  git: {man.get('git_sha', '?') or '?'}")
    if d["compile"]:
        lines.append(f"- compile: {d['compile'].get('duration_s', 0):.2f}s, "
                     f"{d['compile'].get('num_nodes', '?')} nodes")
    if d["search"]:
        s = d["search"]
        lines.append(f"- search: {s.get('evals', '?')} evals, "
                     f"best cost {s.get('best_cost_s', 0) * 1e3:.3f} ms, "
                     f"rewritten={s.get('rewritten')}")
    summ = d["summary"]
    if summ:
        lines.append(
            f"- steps: {d['steps']}  ·  p50 "
            f"{summ.get('p50_step_time_s', 0) * 1e3:.2f} ms  ·  p95 "
            f"{summ.get('p95_step_time_s', 0) * 1e3:.2f} ms  ·  "
            f"{summ.get('examples_per_sec', 0):.1f} examples/s")
    if d["data_wait_frac"] is not None:
        lines.append(f"- data-wait fraction: {d['data_wait_frac']:.1%}")
    ck = d["checkpoints"]
    if ck["count"]:
        lines.append(
            f"- checkpoints: {ck['count']} "
            f"({ck['total_bytes'] / 2**20:.1f} MiB total, last staleness "
            f"{(ck['last_staleness_s'] or 0):.1f}s)")
    if d["preempted"]:
        lines.append("- run was PREEMPTED (final snapshot committed)")
    if d["resumed"]:
        lines.append("- run auto-resumed from a checkpoint")
    if d["trace_dropped_events"]:
        lines.append(f"- ⚠ trace TRUNCATED: {d['trace_dropped_events']} "
                     f"events dropped at the buffer cap")

    lines += ["", "## Alerts", ""]
    if d["alerts"]:
        lines += ["| rule | level | step | action | message |",
                  "|---|---|---|---|---|"]
        for a in d["alerts"]:
            lines.append(
                f"| {a.get('rule')} | {a.get('level')} | {a.get('step')} "
                f"| {a.get('action', 'warn')} | {a.get('message')} |")
    else:
        lines.append("none")

    if d["replans"]:
        lines += ["", "## Elastic re-plans (ffelastic)", "",
                  "| step | trigger | decision | pay-off lhs (ms) "
                  "| rhs (ms) | migration (ms) |",
                  "|---|---|---|---|---|---|"]
        def _ms(v):
            return f"{v * 1e3:.3f}" if v is not None else "—"

        for r in d["replans"]:
            lines.append(
                f"| {r.get('step', '—')} | {r.get('trigger', '?')} "
                f"| {r.get('decision', '?')} | {_ms(r.get('lhs_s'))} "
                f"| {_ms(r.get('rhs_s'))} "
                f"| {_ms(r.get('migration_measured_s'))} |")

    mp = d.get("metrics_plane")
    if mp:
        lines += ["", "## Metrics plane (ffpulse)", "",
                  f"{mp['snapshots']} snapshot(s); last reason: "
                  f"`{mp['reason']}`"]
        if mp["latency"]:
            lines += ["", "### Latency (bucket-estimated percentiles)",
                      "",
                      "| series | count | p50 (ms) | p95 (ms) | p99 (ms) "
                      "| mean (ms) | max (ms) |",
                      "|---|---|---|---|---|---|---|"]
            for key, row in sorted(mp["latency"].items()):
                def _ms(v):
                    return f"{v * 1e3:.3f}" if v is not None else "—"

                lines.append(
                    f"| {key} | {row['count']} | {_ms(row['p50_s'])} "
                    f"| {_ms(row['p95_s'])} | {_ms(row['p99_s'])} "
                    f"| {_ms(row['mean_s'])} | {_ms(row['max_s'])} |")
        goodput = {k: v for k, v in mp["gauges"].items()
                   if k.startswith("train_") or k.endswith("_per_sec")}
        pool = {k: v for k, v in mp["gauges"].items()
                if k.startswith("serve_")}
        if goodput:
            lines += ["", "### Goodput", "", "| gauge | value |",
                      "|---|---|"]
            for k, v in sorted(goodput.items()):
                lines.append(f"| {k} | {v:.4g} |")
        if pool:
            lines += ["", "### Serving slots / block pool", "",
                      "| gauge | value |", "|---|---|"]
            for k, v in sorted(pool.items()):
                lines.append(f"| {k} | {v:.4g} |")
        hits = sum(v for k, v in mp["counters"].items()
                   if k.startswith("serve_prefix_cache_hits_total"))
        misses = sum(v for k, v in mp["counters"].items()
                     if k.startswith("serve_prefix_cache_misses_total"))
        if hits or misses:
            evict = sum(v for k, v in mp["counters"].items()
                        if k.startswith(
                            "serve_prefix_cache_evictions_total"))
            cached = {k: v for k, v in mp["gauges"].items()
                      if k.startswith("serve_prefix_cache_blocks")}
            lines += ["", "### Radix prefix cache", "",
                      f"- admissions: {hits + misses:.0f}  ·  hit rate "
                      f"{hits / max(1.0, hits + misses):.1%}  ·  "
                      f"evictions: {evict:.0f}"]
            for k, v in sorted(cached.items()):
                lines.append(f"- {k}: {v:.0f}")
        if mp["counters"]:
            lines += ["", "### Counters", "", "| counter | value |",
                      "|---|---|"]
            for k, v in sorted(mp["counters"].items()):
                lines.append(f"| {k} | {v:.0f} |")

    sd = d.get("serving_disagg")
    if sd:
        s = sd.get("summary") or {}
        lines += ["", "## Disaggregated serving (KV handoff plane)", "",
                  f"- chips: prefill {sd.get('prefill_chips', '?')} / "
                  f"decode {sd.get('decode_chips', '?')}",
                  f"- handoffs: {s.get('count', 0)} "
                  f"({s.get('fully_cached', 0)} landed fully "
                  f"radix-cached — zero rows moved)",
                  f"- transfer seconds: predicted "
                  f"{s.get('predicted_s', 0.0) * 1e3:.3f} ms, measured "
                  f"{s.get('measured_s', 0.0) * 1e3:.3f} ms",
                  f"- verified transfer programs: "
                  f"{len(sd.get('programs') or {})} (distinct block "
                  f"extents)"]
        if sd.get("rebalances"):
            last = sd["rebalances"][-1]
            lines.append(
                f"- last ratio decision: {last.get('decision')} "
                f"({last.get('old_prefill_chips')}→"
                f"{last.get('new_prefill_chips')} prefill chips, "
                f"lhs {last.get('lhs_s', 0.0) * 1e3:.3f} ms vs rhs "
                f"{last.get('rhs_s', 0.0) * 1e3:.3f} ms)")

    sp = d.get("speculation")
    if sp:
        drafted = sp.get("draft_tokens", 0)
        counts = sp.get("decision_counts") or {}
        place = ("colocated" if sp.get("colocated")
                 else f"{sp.get('draft_chips')} dedicated chip(s)")
        dplan = (sp.get("drafter") or {}).get("plan_source", "?")
        lines += ["", "## Speculative decoding", "",
                  f"- drafter: {place} (plan `{dplan}`)  ·  "
                  f"K max {sp.get('k_max', '?')}  ·  pair "
                  f"`{sp.get('pair_key', '?')}`",
                  f"- acceptance EMA: {sp.get('acceptance_ema', 0.0):.3f} "
                  f"({sp.get('acceptance_samples', 0)} samples)  ·  "
                  f"accepted {sp.get('accepted_tokens', 0)}/{drafted} "
                  f"drafted over {sp.get('rounds', 0)} round(s)",
                  f"- payoff gate: {counts.get('speculate', 0)} "
                  f"speculated / {counts.get('decode', 0)} plain-decode "
                  f"decision(s)"]
        last = next((x for x in reversed(sp.get("decisions") or [])
                     if x.get("reason") == "payoff"), None)
        if last:
            lines.append(
                f"- last payoff decision: {last.get('chosen')} at "
                f"K={last.get('k')} (lhs "
                f"{last.get('lhs_s', 0.0) * 1e3:.3f} ms vs rhs "
                f"{last.get('rhs_s', 0.0) * 1e3:.3f} ms, verify cost "
                f"{last.get('verify_cost_source', '?')})")

    prof = d.get("profile")
    if prof:
        # ONE measured-vs-predicted table for both sources: ffscope
        # xplane attribution and --profiling standalone kernels land in
        # the same section schema
        lines += ["", "## Op profile (ffscope)", "",
                  f"- source: `{prof.get('source', '?')}`  ·  step "
                  f"{prof.get('step', '?')}  ·  attributed "
                  f"{prof.get('attributed_s', 0.0) * 1e3:.3f} ms of "
                  f"{prof.get('device_time_s', 0.0) * 1e3:.3f} ms device "
                  f"time (parallelism x{prof.get('parallelism', 1)})",
                  "",
                  "| op | measured (ms) | predicted (ms) | fidelity |",
                  "|---|---|---|---|"]
        for o in sorted(prof.get("ops", []),
                        key=lambda r: -r.get("measured_s", 0.0))[:10]:
            pred = o.get("predicted_s")
            fid = o.get("fidelity")
            lines.append(
                f"| {o['name']} | {o['measured_s'] * 1e3:.3f} "
                + (f"| {pred * 1e3:.3f} " if pred is not None else "| — ")
                + (f"| {fid:.2f} |" if fid is not None else "| — |"))

    wd = d.get("watchdog")
    if wd:
        lines += ["", "## Hang watchdog (ffscope)", "",
                  f"- FIRED: no step-boundary progress for "
                  f"{wd.get('stalled_s', 0.0):.1f}s "
                  f"(deadline {wd.get('deadline_s', 0.0):.1f}s, last step "
                  f"{wd.get('last_step', '?')})",
                  f"- lagging host: {wd.get('lagging_host', '?')}"]
        for h in wd.get("hosts", []) or []:
            lines.append(f"  - host {h.get('host')}: step "
                         f"{h.get('step')} at t={h.get('time_unix')}")

    fl = d.get("flight")
    if fl:
        lines += ["", "## Flight record (ffscope)", "",
                  f"- reason: `{fl.get('reason', '?')}`  ·  "
                  f"{len(fl.get('events', []))} event(s) of "
                  f"{fl.get('total_recorded', 0)} recorded "
                  f"(ring capacity {fl.get('capacity', '?')})  ·  last "
                  f"step {fl.get('last_step', '?')}"]
        tail = fl.get("events", [])[-5:]
        if tail:
            lines.append("- last events: " + ", ".join(
                f"{e.get('kind')}:{e.get('name')}" for e in tail))

    if d["drift"]:
        dr = d["drift"]
        lines += ["", "## Cost-model drift", "",
                  f"- predicted step makespan: "
                  f"{dr['predicted_s'] * 1e3:.3f} ms",
                  f"- mean measured device time: "
                  f"{dr['mean_measured_s'] * 1e3:.3f} ms",
                  f"- relative error: {dr['error']:.2f}"]

    rep = d["strategy_report"]
    if rep:
        lines += ["", "## Strategy (top ops by predicted cost)", "",
                  "| op | config | compute (ms) | comm (ms) |",
                  "|---|---|---|---|"]
        ranked = sorted(rep.get("ops", []),
                        key=lambda o: -(o["compute_s"] + o["comm_s"]))[:8]
        for o in ranked:
            lines.append(f"| {o['name']} | {o['config']} "
                         f"| {o['compute_s'] * 1e3:.3f} "
                         f"| {o['comm_s'] * 1e3:.3f} |")
        if rep.get("runner_ups"):
            r0 = rep["runner_ups"][0]
            lines.append(
                f"\nchosen plan beat `{r0['label']}` by "
                f"{r0['margin_s'] * 1e3:.3f} ms")

    if d["trace_spans"]:
        lines += ["", "## Where the time went (host spans)", "",
                  "| span | count | total (ms) |", "|---|---|---|"]
        ranked = sorted(d["trace_spans"].items(),
                        key=lambda kv: -kv[1]["total_us"])[:10]
        for name, s in ranked:
            lines.append(f"| {name} | {s['count']} "
                         f"| {s['total_us'] / 1e3:.2f} |")
    lines.append("")
    return "\n".join(lines)
