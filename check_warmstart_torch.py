"""Warm-start CI gate for the PyTorch port: compare a cold and a warm
run's metrics.jsonl. Twin of `scripts/check_warmstart.py`.

Usage: python check_warmstart_torch.py COLD_METRICS WARM_METRICS

The two files come from two port `fit` runs against one shared
`--warmstart-dir` with search flags (so there is a search to skip) on a
mesh of two or more ranks, each with its own `--telemetry-dir`. Asserts:

  - the cold compile searched (plan_source: search) and recorded a
    warmstart MISS;
  - the warm compile's record shows plan_source: cache (the plan cache
    hit — zero search evaluations by construction) and a warmstart HIT;
  - the warm compile duration is smaller than the cold one;
  - both runs' fit summaries carry time_to_first_step_s, warm < cold.

Exits nonzero with a diagnostic on any violation.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class WarmstartCheckFailure(SystemExit):
    """A violated assertion: exits 1."""


def fail(msg: str):
    print(f"check_warmstart: FAIL: {msg}", file=sys.stderr)
    raise WarmstartCheckFailure(1)


def load(path: str):
    from flexflow_tpu_torch.telemetry import read_jsonl

    recs = read_jsonl(path)
    compiles = [r for r in recs if r.get("kind") == "compile"]
    if not compiles:
        fail(f"{path}: no compile record")
    warm_events = [r for r in recs if r.get("kind") == "warmstart"]
    summaries = [r for r in recs if r.get("kind") == "summary"]
    return compiles[0], warm_events, summaries[-1] if summaries else None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return check(argv)
    except WarmstartCheckFailure as e:
        return int(e.code)


def check(argv) -> int:
    if len(argv) != 2:
        fail("usage: check_warmstart_torch.py COLD_METRICS WARM_METRICS")
    cold_c, cold_ws, cold_s = load(argv[0])
    warm_c, warm_ws, warm_s = load(argv[1])

    if cold_c.get("plan_source") != "search":
        fail(f"cold compile plan_source={cold_c.get('plan_source')!r}, "
             f"expected 'search' (pass search flags to the smoke)")
    if not any(w.get("plan") == "miss" for w in cold_ws):
        fail("cold run recorded no warmstart miss event")
    if warm_c.get("plan_source") != "cache":
        fail(f"warm compile plan_source={warm_c.get('plan_source')!r}, "
             f"expected 'cache' — the plan cache did not hit")
    if not any(w.get("plan") == "hit" and w.get("source") == "cache"
               for w in warm_ws):
        fail("warm run recorded no warmstart cache-hit event")

    cold_t, warm_t = cold_c["duration_s"], warm_c["duration_s"]
    if not warm_t < cold_t:
        fail(f"warm compile not faster: cold={cold_t:.3f}s "
             f"warm={warm_t:.3f}s")

    ttfs = {}
    for tag, s in (("cold", cold_s), ("warm", warm_s)):
        if s is None or "time_to_first_step_s" not in s:
            fail(f"{tag} summary missing time_to_first_step_s")
        ttfs[tag] = s["time_to_first_step_s"]
    if not ttfs["warm"] < ttfs["cold"]:
        fail(f"warm time-to-first-step not smaller: {ttfs}")

    print(f"check_warmstart: OK — compile {cold_t:.3f}s → {warm_t:.3f}s "
          f"({cold_t / max(warm_t, 1e-9):.1f}x), time-to-first-step "
          f"{ttfs['cold']:.3f}s → {ttfs['warm']:.3f}s, plan_source "
          f"search → cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
