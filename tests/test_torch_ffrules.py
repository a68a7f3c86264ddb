"""The port's ffrules (`flexflow_tpu_torch/analysis/rules.py`) against the
JAX package's, on the CPU: the twin of `tests/test_ffrules.py`.

- the generated registry: stable, sorted, deduped, and each rule's
  verdict over it (every finding's severity and code, rule by rule) the
  JAX package's; `rules_fingerprint` gives JAX's hash;
- the corruption corpus: each unsound-rule class caught as exactly its
  class, as in the JAX package;
- the JSON load gate: an unsound rule refused naming the rule and the
  class, `--no-verify-rules` loading it with the verdict recorded, and
  on 2 gloo ranks the compile refusing it, or under `--no-verify-rules`
  carrying the downgraded verdict and the fingerprint in its analysis;
- the oracle runs the port's Executor (torch.autograd for the gradients)
  on the three structurally distinct families;
- the `unverified_rule_load` lint rule and the port tree clean of it.
"""

import json
import os
import sys
from types import SimpleNamespace

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CI_MESH = {"data": 2, "model": 4, "dcn": 1, "seq": 1}
PKGS = ("flexflow_tpu", "flexflow_tpu_torch")


def _mk_config(pkg="flexflow_tpu_torch", argv=()):
    old = sys.argv
    sys.argv = ["t", *argv]
    try:
        mod = __import__(pkg)
        return (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
                else mod.FFConfig())
    finally:
        sys.argv = old


def _rules(pkg):
    return __import__(f"{pkg}.analysis.rules", fromlist=["x"])


def _verdicts(result) -> dict:
    """{where: sorted (severity, code)} of a verification result."""
    out: dict = {}
    for f in result.findings:
        out.setdefault(f.where, []).append((f.severity, f.code))
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def registry():
    """The full generated registry verified in both packages (the JAX
    sweep runs its oracle jitted: ~13 s)."""
    return {p: _rules(p).verify_registry(CI_MESH, _mk_config(p, ["-b", "8"]))
            for p in PKGS}


# ------------------------------------------------------------- registry

def test_registry_stable_sorted_deduped():
    from flexflow_tpu_torch.analysis.rules import (
        rules_fingerprint,
        serialize_rule,
    )
    from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers

    config = _mk_config(argv=["-b", "8"])
    mesh = SimpleNamespace(shape=dict(CI_MESH))
    a = generate_all_pcg_xfers(mesh, config)
    b = generate_all_pcg_xfers(mesh, config)
    sa = [json.dumps(serialize_rule(x), sort_keys=True) for x in a]
    sb = [json.dumps(serialize_rule(x), sort_keys=True) for x in b]
    assert sa == sb
    names = [x.name for x in a]
    assert names == sorted(names) and len(set(names)) == len(names)
    assert rules_fingerprint(a) == rules_fingerprint(b)
    assert rules_fingerprint(a[1:]) != rules_fingerprint(a)


def test_rules_fingerprint_is_the_jax_hash():
    fps = []
    for p in PKGS:
        subs = __import__(f"{p}.search.substitution", fromlist=["x"])
        xfers = subs.generate_all_pcg_xfers(
            SimpleNamespace(shape=dict(CI_MESH)), _mk_config(p, ["-b", "8"]))
        fps.append(_rules(p).rules_fingerprint(xfers))
    assert fps[0] == fps[1]


def test_full_registry_verifies_clean(registry):
    res = registry["flexflow_tpu_torch"]
    assert res.errors() == [], [str(f) for f in res.errors()]
    assert res.warnings() == [], [str(f) for f in res.warnings()]
    clean = res.by_code("rules_clean")
    assert clean and clean[0].details["rules"] > 15


def test_registry_verdicts_rule_by_rule_match_jax(registry):
    jax_res, port_res = registry["flexflow_tpu"], registry["flexflow_tpu_torch"]
    assert _verdicts(port_res) == _verdicts(jax_res)
    assert (port_res.by_code("rules_clean")[0].details
            == jax_res.by_code("rules_clean")[0].details)


# ------------------------------------------------- corruption self-test

@pytest.mark.parametrize("klass", [
    "wrong_output_shape", "dtype_drift", "dropped_replica_dim",
    "degree_product_violation", "partial_sum_nonlinear",
    "matcher_indivisible", "numeric_divergence"])
def test_corruption_class_caught_as_its_class(klass):
    got = {}
    for p in PKGS:
        R = _rules(p)
        _, xfer, expect = next(c for c in R.selftest_classes()
                               if c[0] == klass)
        findings = R.verify_rule(xfer, CI_MESH)
        got[p] = sorted({(f.severity, f.code, f.where) for f in findings})
        assert [c for _, c, _ in got[p]] == [expect], (p, got[p])
        assert all(s == "error" for s, _, _ in got[p])
    assert got["flexflow_tpu"] == got["flexflow_tpu_torch"]


# ------------------------------------------------------- JSON load gate

_BAD_RULE = {
    "name": "external_bad_activation",
    "src": [{"op": "linear", "inputs": ["$0"], "out": "l1",
             "constraints": [{"attr": "activation", "eq": "none"}]}],
    "dst": [{"op": "linear", "inputs": ["$0"], "match": "l1",
             "params_update": {"activation": "sigmoid"}, "out": "l2"}],
    "map_outputs": [["l1", "l2"]],
}

_GOOD_RULES = {"rules": [
    {"generator": "replicate_linear_combine", "degree": 2,
     "activation": "none"},
    {"generator": "linear_relu_merge"},
]}


def test_unsound_json_rule_refused_at_load(tmp_path):
    from flexflow_tpu_torch.analysis.rules import RuleVerificationError
    from flexflow_tpu_torch.search.substitution import load_rule_collection

    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"rules": [_BAD_RULE]}))
    config = _mk_config(argv=["-b", "8"])
    mesh = SimpleNamespace(shape=dict(CI_MESH))
    with pytest.raises(RuleVerificationError) as ei:
        load_rule_collection(str(p), mesh, config=config)
    assert "external_bad_activation" in str(ei.value)
    assert "rule_numeric_divergence" in str(ei.value)
    # without a config (the fingerprint's path) the loader stays
    # permissive
    assert len(load_rule_collection(str(p), mesh)) == 1


def test_no_verify_rules_downgrades_and_records(tmp_path):
    from flexflow_tpu_torch.analysis.rules import _LOAD_RESULTS
    from flexflow_tpu_torch.search.substitution import load_rule_collection

    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"rules": [_BAD_RULE]}))
    config = _mk_config(argv=["-b", "8", "--no-verify-rules"])
    assert config.verify_rules is False
    mesh = SimpleNamespace(shape=dict(CI_MESH))
    assert len(load_rule_collection(str(p), mesh, config=config)) == 1
    recorded = _LOAD_RESULTS[os.path.abspath(str(p))]
    assert [f.code for f in recorded.errors()] == [
        "rule_numeric_divergence"]


def rule_compile_job(rank, tmp):
    """On 2 gloo ranks, --mesh 1,2,1,1 --budget 4 --substitution-json:
    the unsound rule refuses the compile; under --no-verify-rules the
    compile runs with the verdict downgraded in its analysis; the sound
    rules compile clean with their fingerprint. (On --mesh 2,1,1,1 the
    degree-2 replicate_linear_combine pins the feature dim to `data`
    beside the batch dim, and both packages' gates refuse that plan as
    axis_reuse.)"""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer

    def compile_with(path, extra=(), tag=""):
        sys.argv = ["t", "-b", "8", "--mesh", "1,2,1,1",
                    "--substitution-json", path, "--budget", "4", *extra]
        config = FFConfig(device="cpu")
        ff = FFModel(config)
        x = ff.create_tensor((8, 32), name=f"rg{tag}_in")
        ff.dense(x, 8, name=f"rg{tag}_fc")
        ff.compile(optimizer=SGDOptimizer(lr=0.1),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        return ff

    bad = os.path.join(tmp, "bad.json")
    good = os.path.join(tmp, "good.json")
    out = {}
    try:
        compile_with(bad, tag="r")
        out["refused"] = None
    except Exception as e:  # rank 0's refusal reaches every rank
        out["refused"] = f"{type(e).__name__}: {e}"
    ff = compile_with(bad, ("--no-verify-rules",), "d")
    res = ff._analysis
    out["downgraded"] = sorted({(f.severity, f.code)
                                for f in res.findings
                                if f.pass_name == "rule_verify"})
    out["downgraded_source"] = [f.details.get("source")
                                for f in res.by_code("rules_fingerprint")]
    ff = compile_with(good, tag="c")
    res = ff._analysis
    out["clean"] = (res.ok, [f.code for f in res.findings
                             if f.pass_name == "rule_verify"])
    return out


def test_compile_gates_json_rules_on_two_ranks(tmp_path):
    from flexflow_tpu_torch.distributed import spawn

    (tmp_path / "bad.json").write_text(json.dumps({"rules": [_BAD_RULE]}))
    (tmp_path / "good.json").write_text(json.dumps(_GOOD_RULES))
    outs = spawn(rule_compile_job, 2, str(tmp_path), timeout=300)
    for r, out in enumerate(outs):
        assert out["refused"] and "RuleVerificationError" in out["refused"]
        assert "external_bad_activation" in out["refused"]
        assert out["downgraded_source"] == ["json"], r
        assert out["clean"][0], r
        assert "rules_fingerprint" in out["clean"][1], r
    # rank 0 loaded the file through the gate: its verdict rides the
    # report, downgraded to warnings
    assert ("warning", "rule_numeric_divergence") in outs[0]["downgraded"]
    assert "rules_clean" in outs[0]["clean"][1]


# -------------------------------------------------------------- oracle

def test_oracle_executes_whole_registry_families():
    """The oracle end to end through the port's Executor on the three
    structurally distinct families: algebraic merge, attention with a
    Reduction, sample partition."""
    from flexflow_tpu_torch.analysis.rules import _check_oracle, _dim_env
    from flexflow_tpu_torch.search.substitution import (
        create_linear_relu_merge,
        create_partition_softmax_combine,
        create_replicate_attention_reduce,
    )

    for xfer in (create_linear_relu_merge(),
                 create_replicate_attention_reduce(4, ("model",)),
                 create_partition_softmax_combine(2, ("data",))):
        findings = _check_oracle(xfer, _dim_env(4, "oracle"),
                                 f"rule:{xfer.name}")
        assert findings == [], (xfer.name, [str(f) for f in findings])


def test_crashing_rule_refused_structurally():
    from flexflow_tpu_torch.analysis.rules import verify_rules

    class _Broken:
        name = "broken_rule"

    res = verify_rules([_Broken()], CI_MESH)
    errs = res.errors()
    assert errs and errs[0].code == "rule_verification_crash"
    assert "broken_rule" in errs[0].where


def test_rule_verify_pass_skips_manual_and_import_plans():
    from flexflow_tpu_torch.analysis import rules as R

    config = _mk_config(argv=["-b", "8", "--budget", "6"])
    mesh = SimpleNamespace(shape=dict(CI_MESH))
    stamped = R.run(None, mesh, SimpleNamespace(config=config,
                                                plan_source="search"))
    assert any(f.code == "rules_fingerprint"
               and f.details["source"] == "generated" for f in stamped)
    for src in ("manual", "import"):
        ctx = SimpleNamespace(config=config, plan_source=src)
        assert R.run(None, mesh, ctx) == []


# ----------------------------------------------------------- lint rule

_LOADS = {
    "ungated": ("def inject(path, mesh):\n"
                "    return load_rule_collection(path, mesh)\n",
                ["unverified_rule_load"]),
    "gated": ("def inject(path, mesh, config):\n"
              "    return load_rule_collection(path, mesh, config=config)\n",
              []),
    "checker": ("def inject(mesh, config):\n"
                "    xfers = generate_all_pcg_xfers(mesh, config)\n"
                "    verify_rules(xfers, mesh)\n"
                "    return xfers\n", []),
    "pragma": ("def inject(mesh, config):\n"
               "    return generate_all_pcg_xfers(mesh, config)"
               "  # fflint: ok unverified_rule_load\n", []),
    "none_config": ("def inject(path, mesh):\n"
                    "    return load_rule_collection(path, mesh, "
                    "config=None)\n", ["unverified_rule_load"]),
}


@pytest.mark.parametrize("case", sorted(_LOADS))
def test_lint_unverified_rule_load(case):
    from flexflow_tpu_torch.analysis import lint

    src, want = _LOADS[case]
    assert [f.code for f in lint.lint_source(
        src, "snippet.py", select=("unverified_rule_load",))] == want


def test_port_tree_has_no_ungated_rule_load():
    from flexflow_tpu_torch.analysis.lint import lint_paths

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint_paths([os.path.join(root, "flexflow_tpu_torch")],
                          select=("unverified_rule_load",))
    assert findings == [], [str(f) for f in findings]
