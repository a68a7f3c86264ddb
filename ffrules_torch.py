"""ffrules for the PyTorch port: standalone substitution-rule
verification — the CI gate. Twin of `scripts/ffrules.py`.

Three jobs (docs/analysis.md "ffrules"):

1. **Registry sweep** (default): generate the FULL built-in rule set for
   the CI mesh config (`generate_all_pcg_xfers` on a data=2 x model=4
   mesh, plus the MoE fusion family instantiated from a Group_by graph)
   and verify EVERY rule through all five ffrules passes — symbolic
   shape/dtype transfer, parallel-state soundness, the semantic
   equivalence oracle (forward + backward through the port's Executor on
   a 1-device mesh, on the card by default, on the CPU under `--device
   cpu`), boundary-precondition fuzz, and registry determinism. Zero
   errors required.

2. **Corruption self-test** (`--self-test`, on by default): the shared
   corpus of deliberately-unsound rules (`analysis.rules
   .selftest_classes`), each caught as EXACTLY its finding class.

3. **Load-gate check**: write an unsound JSON rule file and assert
   `load_rule_collection` refuses it with a structured
   RuleVerificationError naming the rule and finding class; with
   verify_rules off (--no-verify-rules) the same file loads with the
   verdict downgraded and recorded for the compile report (the load
   gate's oracle on the config's device).

The rules are verified against the `--mesh` axis sizes alone (no rank
of that mesh is needed: the oracle runs on one device), so one process
checks the CI mesh.

Writes a machine-readable report with `--report OUT.json` (on failure
too). Exits nonzero on any violated assertion.

Usage: python ffrules_torch.py [--report OUT.json] [--no-self-test]
       [--no-oracle] [--mesh data,model,dcn,seq] [--device cpu]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


class FFRulesFailure(SystemExit):
    """A violated assertion: exits 1 (after the report is written)."""


# progressive report state: fail() flushes whatever has been collected so
# far, so the CI artifact exists (with the failure recorded) for red runs
_REPORT: dict = {}
_OPTS: dict = {}


def _write_report():
    path = _OPTS.get("report", "")
    if not path:
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_REPORT, f, indent=1)
    print(f"ffrules: report written to {path}")


def fail(msg: str):
    print(f"ffrules: FAIL: {msg}", file=sys.stderr)
    _REPORT["failure"] = msg
    _write_report()
    raise FFRulesFailure(1)


def _config():
    from flexflow_tpu_torch import FFConfig

    sys.argv = [sys.argv[0]]
    return FFConfig(device=_OPTS["device"])


def _group_by_graph():
    """A minimal PCG exhibiting a Group_by node, so the sweep also covers
    the data-driven fuse_moe_trio family (it only joins the registry when
    a graph exhibits an expert count)."""
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.ops.moe import GroupByParams
    from flexflow_tpu_torch.pcg.graph import Graph, OpNode

    g = Graph()
    g.add_node(OpNode(OT.OP_GROUP_BY, GroupByParams(4, 1.0),
                      name="sweep_gb"))
    return g


def run_sweep(mesh_sizes: dict, oracle: bool) -> None:
    from flexflow_tpu_torch.analysis import rules as R

    cfg = _config()
    cfg.mesh_axis_sizes = tuple(mesh_sizes.values())
    t0 = time.perf_counter()
    res = R.verify_registry(mesh_sizes, cfg, graph=_group_by_graph(),
                            oracle=oracle, device=_OPTS["device"])
    elapsed = time.perf_counter() - t0
    n_rules = next((f.details.get("rules") for f in res.findings
                    if f.code == "rules_clean"), None)
    fp = next((f.details.get("fingerprint") for f in res.findings
               if f.code == "rules_clean"), "")
    errs = res.errors()
    _REPORT["sweep"] = {
        "mesh": mesh_sizes, "elapsed_s": elapsed,
        "fingerprint": fp, **res.summary(),
    }
    if errs:
        fail(f"registry sweep: {len(errs)} error(s): "
             f"{[str(f) for f in errs[:5]]}")
    warns = res.warnings()
    if warns:
        # a rule the verifier cannot even instantiate is an unverified
        # rule — the sweep's whole point is that NONE exist
        fail(f"registry sweep: {len(warns)} unverified rule(s): "
             f"{[str(f) for f in warns[:5]]}")
    print(f"ffrules: sweep — {n_rules} rule(s) verified clean in "
          f"{elapsed:.1f}s on mesh {mesh_sizes} "
          f"(fingerprint {fp[:16]})")


def run_self_test(mesh_sizes: dict, oracle: bool) -> None:
    from flexflow_tpu_torch.analysis import rules as R

    for klass, xfer, expect in R.selftest_classes():
        if not oracle and klass == "numeric_divergence":
            # this class is only observable by executing the graphs
            print(f"ffrules: self-test {klass:26s} — skipped "
                  f"(--no-oracle)")
            continue
        findings = R.verify_rule(xfer, mesh_sizes, oracle=oracle,
                                 device=_OPTS["device"])
        codes = sorted({f.code for f in findings})
        if codes != [expect]:
            fail(f"self-test {klass}: expected exactly {expect!r}, "
                 f"got {codes}")
        print(f"ffrules: self-test {klass:26s} — caught ({expect})")
        _REPORT.setdefault("self_test", []).append(
            {"class": klass, "finding": expect})


_UNSOUND_JSON = {
    "rules": [{
        "name": "external_bad_activation",
        "src": [{"op": "linear", "inputs": ["$0"], "out": "l1",
                 "constraints": [{"attr": "activation", "eq": "none"}]}],
        "dst": [{"op": "linear", "inputs": ["$0"], "match": "l1",
                 "params_update": {"activation": "sigmoid"},
                 "out": "l2"}],
        "map_outputs": [["l1", "l2"]],
    }],
}


def run_load_gate(workdir: str, mesh_sizes: dict) -> None:
    from types import SimpleNamespace

    from flexflow_tpu_torch.analysis.rules import (
        RuleVerificationError,
        _LOAD_RESULTS,
    )
    from flexflow_tpu_torch.search.substitution import load_rule_collection

    path = os.path.join(workdir, "unsound_rules.json")
    with open(path, "w") as f:
        json.dump(_UNSOUND_JSON, f)
    cfg = _config()
    mesh = SimpleNamespace(shape=dict(mesh_sizes))
    try:
        load_rule_collection(path, mesh, config=cfg)
    except RuleVerificationError as e:
        msg = str(e)
        if "external_bad_activation" not in msg \
                or "rule_numeric_divergence" not in msg:
            fail(f"load gate: refusal does not name rule + class: {msg}")
        print("ffrules: load gate — unsound JSON rule refused "
              "(rule + class named)")
    else:
        fail("load gate: unsound JSON rule was NOT refused")
    cfg.verify_rules = False  # --no-verify-rules
    xfers = load_rule_collection(path, mesh, config=cfg)
    if len(xfers) != 1:
        fail("load gate: --no-verify-rules did not load the rule")
    recorded = _LOAD_RESULTS.get(os.path.abspath(path))
    if recorded is None or not recorded.errors():
        fail("load gate: downgraded verdict was not recorded")
    print("ffrules: load gate — --no-verify-rules downgrades, verdict "
          "recorded")
    _REPORT["load_gate"] = {"refused": True, "downgrade_recorded": True}


def main(argv=None) -> int:
    import shutil
    import tempfile

    argv = list(sys.argv[1:] if argv is None else argv)
    _REPORT.clear()
    _REPORT.update({"kind": "ffrules_report", "ok": False})
    _OPTS.clear()
    _OPTS.update(report="", device="cuda")
    self_test = True
    oracle = True
    mesh_sizes = {"data": 2, "model": 4, "dcn": 1, "seq": 1}
    try:
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--report":
                i += 1
                _OPTS["report"] = argv[i]
            elif a == "--no-self-test":
                self_test = False
            elif a == "--self-test":
                self_test = True
            elif a == "--no-oracle":
                oracle = False
            elif a == "--mesh":
                i += 1
                sizes = [int(v) for v in argv[i].split(",")]
                mesh_sizes = dict(zip(("data", "model", "dcn", "seq"),
                                      sizes))
            elif a == "--device":
                i += 1
                _OPTS["device"] = argv[i]
            elif a in ("-h", "--help"):
                print(__doc__)
                return 0
            else:
                fail(f"unknown flag {a!r}")
            i += 1
        sys.argv = [sys.argv[0]]  # FFConfig must not parse ffrules' flags
        from flexflow_tpu_torch.config import resolve_device

        resolve_device(_config())  # an absent CUDA device raises here
        _REPORT["device"] = _OPTS["device"]

        workdir = tempfile.mkdtemp(prefix="ffrules-")
        try:
            run_sweep(mesh_sizes, oracle)
            if self_test:
                run_self_test(mesh_sizes, oracle)
            if oracle:
                # the production load gate always runs the oracle —
                # checking its refusal needs graph execution
                run_load_gate(workdir, mesh_sizes)
            else:
                print("ffrules: load gate — skipped (--no-oracle)")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    except FFRulesFailure as e:
        return int(e.code)

    _REPORT["ok"] = True
    _write_report()
    print("ffrules: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
