"""Run doctor for the PyTorch port: render a post-mortem report from any
telemetry dir. Twin of `scripts/run_doctor.py`.

Usage:
    python run_doctor_torch.py TELEMETRY_DIR [--out report.md]
        [--json] [--check] [--strict]

  --out FILE   write the markdown report to FILE (default: stdout)
  --json       emit the structured diagnose() dict instead of markdown
  --check      exit nonzero unless the diagnostics artifacts exist and
               parse (strategy_report.json + alerts.jsonl + metrics.jsonl)
               and every identity the artifacts record reproduces: the
               report total under the makespan rule, the ffsan passes, the
               barrier verdict, the transition, handoff, elastic and
               speculation prices, the profile attribution, the flight
               record, the metrics snapshots — the CI acceptance gate
  --strict     additionally exit nonzero when the verdict is "dead"
               (error-level / abort alerts present)

Reads only files — no devices, no live run — so it works on any telemetry
dir copied off the machine that produced it, the JAX package's as well as
the port's (the two write one format). Exit codes: 0 ok, 1 a failed
--check, 2 no such directory, 3 --strict on a dead run.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("directory", help="telemetry dir of the run")
    ap.add_argument("--out", default="", help="write markdown here")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    if not os.path.isdir(args.directory):
        print(f"run_doctor: no such directory {args.directory!r}",
              file=sys.stderr)
        return 2

    if args.check:
        problems = []
        for name in ("metrics.jsonl", "alerts.jsonl",
                     "strategy_report.json"):
            p = os.path.join(args.directory, name)
            if not os.path.exists(p):
                problems.append(f"missing {name}")
        if not problems:
            from flexflow_tpu_torch.diagnostics.explain import (
                verify_report_total,
            )

            rep = json.load(open(
                os.path.join(args.directory, "strategy_report.json")))
            total = verify_report_total(rep)
            if abs(total - rep["total_predicted_s"]) > 1e-9 + 1e-6 * abs(
                    rep["total_predicted_s"]):
                problems.append(
                    f"strategy_report per-op costs ({total}) do not "
                    f"reproduce total_predicted_s "
                    f"({rep['total_predicted_s']}) under the makespan rule")
            # ffsan gates: the numerics + SPMD passes must have run in
            # the compile gate, and a recorded fingerprint-barrier
            # mismatch means the artifacts describe a diverged fleet
            analysis = rep.get("analysis")
            if analysis is not None:
                for p in ("dtype_flow", "spmd_uniformity"):
                    if p not in analysis.get("passes_run", []):
                        problems.append(
                            f"analysis section missing the {p} pass "
                            f"(ffsan did not run in the compile gate)")
            if rep.get("spmd_barrier") not in (
                    None, "off", "ok", "single_process"):
                problems.append(
                    f"SPMD fingerprint barrier verdict "
                    f"{rep.get('spmd_barrier')!r} — the fleet diverged "
                    f"before the first step")
            # fftrans gate: when the run went through a verified plan
            # transition (restore/migration), the section's predicted
            # migration seconds must reproduce from the per-transfer
            # entries alone — the same identity treatment as the
            # makespan check above
            trans = rep.get("transition")
            if trans is not None:
                from flexflow_tpu_torch.analysis.transition import (
                    verify_transition_total,
                )

                tt = verify_transition_total(trans)
                want = trans.get("predicted_s", 0.0)
                if abs(tt - want) > 1e-9 + 1e-6 * abs(want):
                    problems.append(
                        f"transition section per-transfer costs ({tt}) "
                        f"do not reproduce predicted_s ({want})")
                ta = trans.get("analysis") or {}
                if ta.get("errors", 0):
                    problems.append(
                        f"transition verification recorded "
                        f"{ta['errors']} error(s) — the migration ran "
                        f"unverified (--no-verify-plan)")
            # disagg gate: every KV handoff the serving_disagg section
            # records must reference a verified transfer program whose
            # predicted seconds reproduce from its own per-transfer
            # entries alone (the same makespan identity as the
            # transition gate), and must agree with that program's
            # price; a fully radix-cached handoff moved zero rows and
            # carries no program by construction
            disagg = rep.get("serving_disagg")
            if disagg is not None:
                from flexflow_tpu_torch.analysis.transition import (
                    verify_transition_total,
                )

                programs = disagg.get("programs") or {}
                for key, prog in programs.items():
                    tt = verify_transition_total(prog)
                    want = prog.get("predicted_s", 0.0)
                    if abs(tt - want) > 1e-9 + 1e-6 * abs(want):
                        problems.append(
                            f"handoff program {key}: per-transfer costs "
                            f"({tt}) do not reproduce predicted_s "
                            f"({want})")
                    pa = prog.get("analysis") or {}
                    if pa.get("errors", 0):
                        problems.append(
                            f"handoff program {key}: transfer "
                            f"verification recorded {pa['errors']} "
                            f"error(s)")
                for i, h in enumerate(disagg.get("handoffs", [])):
                    nblk = int(h.get("injected_blocks", 0))
                    if nblk == 0:
                        if h.get("predicted_s", 0.0):
                            problems.append(
                                f"handoff {i}: fully cached (0 blocks) "
                                f"but predicted_s is nonzero")
                        continue
                    prog = programs.get(str(nblk))
                    if prog is None:
                        problems.append(
                            f"handoff {i}: no verified transfer program "
                            f"for its {nblk}-block extent")
                        continue
                    if abs(h.get("predicted_s", 0.0)
                           - prog.get("predicted_s", 0.0)) > 1e-9:
                        problems.append(
                            f"handoff {i}: predicted_s "
                            f"({h.get('predicted_s')}) does not match "
                            f"its program's price "
                            f"({prog.get('predicted_s')})")
            # ffelastic gate: every priced re-plan decision must be
            # reproducible from the record alone — both sides of the
            # pay-off inequality recompute from their recorded factors,
            # and the migrate/decline call must match the inequality
            # (forced = capacity shrink migrates regardless; dry-run
            # and failed decisions are exempt from the call check)
            elastic = rep.get("elastic") or {}
            for i, dec in enumerate(elastic.get("decisions", [])):
                if dec.get("lhs_s") is None or dec.get("rhs_s") is None:
                    continue
                lhs = (dec.get("predicted_migration_s", 0.0)
                       * dec.get("fidelity_ratio", 1.0))
                rhs = (dec.get("benefit_s_per_step", 0.0)
                       * dec.get("horizon_steps", 0))
                for name, got, want in (("lhs_s", dec["lhs_s"], lhs),
                                        ("rhs_s", dec["rhs_s"], rhs)):
                    if abs(got - want) > 1e-9 + 1e-6 * abs(want):
                        problems.append(
                            f"elastic decision {i}: recorded {name} "
                            f"({got}) does not reproduce from its "
                            f"factors ({want})")
                forced = bool(dec.get("forced"))
                call = dec.get("decision")
                if call == "migrated" and not forced and not lhs < rhs:
                    problems.append(
                        f"elastic decision {i}: migrated but the "
                        f"pay-off inequality does not hold "
                        f"({lhs} >= {rhs})")
                if (call == "declined" and not forced
                        and not dec.get("dry_run") and lhs < rhs):
                    problems.append(
                        f"elastic decision {i}: declined but the "
                        f"pay-off inequality holds ({lhs} < {rhs})")
            # speculative-decoding gate: every payoff decision in the
            # speculation section must be reproducible from its own
            # recorded factors — lhs = K·draft + verify, rhs =
            # (Σ_{i=1..K} a^i)·decode (the SAME accumulation order as
            # the engine, so the floats match) — and the chosen call
            # must agree with the inequality. Calibration rounds
            # (calibrate_decode / bootstrap / no_headroom) carry no
            # priced inequality and are exempt from the call check.
            spec = rep.get("speculation")
            if spec is not None:
                for i, dec in enumerate(spec.get("decisions", [])):
                    if dec.get("reason") != "payoff":
                        continue
                    k = int(dec.get("k", 0))
                    lhs = (k * dec.get("draft_cost_s", 0.0)
                           + dec.get("verify_cost_s", 0.0))
                    a = dec.get("acceptance_ema", 0.0)
                    exp = 0.0
                    x = 1.0
                    for _ in range(k):
                        x *= a
                        exp += x
                    rhs = exp * dec.get("decode_cost_s", 0.0)
                    for name, got, want in (
                            ("lhs_s", dec.get("lhs_s"), lhs),
                            ("expected_accepted",
                             dec.get("expected_accepted"), exp),
                            ("rhs_s", dec.get("rhs_s"), rhs)):
                        if got is None or abs(got - want) > (
                                1e-9 + 1e-6 * abs(want)):
                            problems.append(
                                f"speculation decision {i}: recorded "
                                f"{name} ({got}) does not reproduce "
                                f"from its factors ({want})")
                    chosen = dec.get("chosen")
                    if chosen == "speculate" and not lhs < rhs:
                        problems.append(
                            f"speculation decision {i}: speculated but "
                            f"the payoff inequality does not hold "
                            f"({lhs} >= {rhs})")
                    if chosen == "decode" and lhs < rhs:
                        problems.append(
                            f"speculation decision {i}: fell back to "
                            f"plain decode but the payoff inequality "
                            f"holds ({lhs} < {rhs})")
                drafted = spec.get("draft_tokens", 0)
                accepted = spec.get("accepted_tokens", 0)
                if accepted > drafted:
                    problems.append(
                        f"speculation section accepted {accepted} of "
                        f"{drafted} drafted tokens — acceptance cannot "
                        f"exceed the drafted count")
            # ffpulse gate: every metrics_snapshot must be self-
            # consistent from the artifact alone — for each histogram
            # the bucket counts must sum to the recorded total, and on a
            # DRAINED serving snapshot the TTFT observation count must
            # equal the completed-with-token request count (serve.request
            # events with new_tokens > 0 since the last stats_reset —
            # no_token requests are excluded from TTFT by design)
            # ffscope gates: (a) when a profile section is present its
            # attribution identity must re-verify from the JSON alone —
            # per-op seconds sum back to attributed_s, attributed +
            # unattributed bounded by step device time × parallelism
            # within the stated slop, and every fidelity recomputable
            # from its own measured/predicted pair; (b) a flight.json
            # dump must be a well-formed bounded ring snapshot
            prof = rep.get("profile")
            if prof is not None:
                from flexflow_tpu_torch.scope.attribution import (
                    verify_profile_section,
                )

                problems.extend(verify_profile_section(prof))
            fpath = os.path.join(args.directory, "flight.json")
            if os.path.exists(fpath):
                try:
                    flight = json.load(open(fpath))
                except Exception as e:
                    flight = None
                    problems.append(f"flight.json does not parse: {e}")
                if flight is not None:
                    if flight.get("kind") != "flight_record":
                        problems.append(
                            f"flight.json kind is "
                            f"{flight.get('kind')!r}, expected "
                            f"'flight_record'")
                    for key in ("reason", "capacity", "events"):
                        if key not in flight:
                            problems.append(f"flight.json missing {key!r}")
                    events = flight.get("events")
                    if isinstance(events, list):
                        cap = flight.get("capacity")
                        if isinstance(cap, int) and len(events) > cap:
                            problems.append(
                                f"flight.json holds {len(events)} events "
                                f"but claims capacity {cap} — the ring "
                                f"bound did not hold")
                        for i, ev in enumerate(events):
                            if not (isinstance(ev, dict) and "seq" in ev
                                    and "kind" in ev and "name" in ev):
                                problems.append(
                                    f"flight.json event {i} malformed "
                                    f"(needs seq/kind/name)")
                                break
            from flexflow_tpu_torch.telemetry.recorder import read_jsonl

            records = read_jsonl(
                os.path.join(args.directory, "metrics.jsonl"))
            snapshots = [r for r in records
                         if r.get("kind") == "metrics_snapshot"]
            for r in snapshots:
                for key, h in (r.get("metrics", {})
                               .get("histograms") or {}).items():
                    if sum(h.get("counts", [])) != h.get("count"):
                        problems.append(
                            f"snapshot seq {r.get('seq')}: histogram "
                            f"{key} bucket counts sum to "
                            f"{sum(h.get('counts', []))} but count is "
                            f"{h.get('count')}")
            drained = [r for r in snapshots if r.get("drained")]
            if drained:
                last = drained[-1]
                hists = last.get("metrics", {}).get("histograms") or {}
                ttft = hists.get("serve_ttft_s")
                window = []
                for r in records:
                    if r.get("kind") == "serve.stats_reset":
                        window = []
                    elif r.get("kind") == "serve.request":
                        window.append(r)
                with_token = sum(1 for r in window
                                 if r.get("new_tokens", 0) > 0)
                if ttft is not None and ttft.get("count") != with_token:
                    problems.append(
                        f"drained snapshot: serve_ttft_s count "
                        f"({ttft.get('count')}) != completed-with-token "
                        f"requests ({with_token})")
        if problems:
            print("run_doctor: CHECK FAILED: " + "; ".join(problems),
                  file=sys.stderr)
            return 1

    d = diagnose(args.directory)
    out = (json.dumps(d, indent=1, default=str) if args.as_json
           else render(d))
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"run_doctor: report written to {args.out}")
    else:
        print(out)
    if args.strict and d["verdict"] == "dead":
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
