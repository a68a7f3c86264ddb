"""The port's warm start (`flexflow_tpu_torch/warmstart/`), the twins of
`tests/test_warmstart.py`, on the CPU.

A compile searches only on a mesh of more than one device (JAX's
`do_search`), and the port's devices are ranks: the searched compiles
run on 2 gloo ranks (`distributed.spawn`, once for the module, every
scenario in turn; rank 0 searches, calibrates and owns the cache), the
JAX test's 2 x 4 virtual mesh being 8 devices of one process. The
scenarios: a second compile against a shared `--warmstart-dir` hits the
plan cache with 0 search evaluations and the identical strategy; a
changed graph, mesh, search flag or device signature searches again; a
corrupt or stale entry falls back and is rewritten; `--auto-resume`
restores the plan from the checkpoint manifest without searching, and a
changed graph does not adopt it; the calibration DB makes the warm
compile measure nothing; the telemetry's warmstart records. Here: the two
packages' `graph_signature` and `rules_fingerprint` agree on the tiny LM,
Strategy validation, time to first step, and the executable-cache layer
that the card has no counterpart for. With --diagnostics the warm
compile's strategy report describes the adopted plan (mode "replayed",
the searched report's configs and predicted makespan).
"""

import json
import os
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEARCH_ARGV = ["--mesh", "2,1,1,1", "--budget", "6",
               "--enable-parameter-parallel"]
TINY = dict(vocab_size=128, hidden_size=64, num_heads=4, num_layers=2,
            sequence_length=32, attention_impl="flash")


def _build(argv, hidden=256, batch=32, in_dim=64):
    """The MLP of the JAX test, with explicit layer names (the plan is
    keyed by name)."""
    sys.argv = ["test"] + list(argv)
    from flexflow_tpu_torch import (
        ActiMode, FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
    )

    config = FFConfig(device="cpu")
    config.batch_size = batch
    ff = FFModel(config)
    x = ff.create_tensor((batch, in_dim))
    t = ff.dense(x, hidden, ActiMode.AC_MODE_RELU, name="ws_fc1")
    t = ff.dense(t, hidden, ActiMode.AC_MODE_RELU, name="ws_fc2")
    t = ff.dense(t, 10, name="ws_head")
    ff.compile(optimizer=SGDOptimizer(lr=0.05),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def _strategy_json(ff) -> str:
    from flexflow_tpu_torch.parallel.strategies import Strategy

    return json.dumps(Strategy(ff._strategy or {}).to_json(),
                      sort_keys=True)


class _EvalSpy:
    """Counts UnitySearch.evaluate calls and joint_graph_optimize
    entries (the search runs on rank 0)."""

    def __enter__(self):
        import flexflow_tpu_torch.search.joint as joint
        import flexflow_tpu_torch.search.unity as unity

        self.evals = self.searches = 0
        self._unity, self._joint = unity, joint
        self._orig_eval = unity.UnitySearch.evaluate
        self._orig_opt = joint.joint_graph_optimize
        spy = self

        def eval_spy(us, *a, **kw):
            spy.evals += 1
            return spy._orig_eval(us, *a, **kw)

        def opt_spy(*a, **kw):
            spy.searches += 1
            return spy._orig_opt(*a, **kw)

        unity.UnitySearch.evaluate = eval_spy
        joint.joint_graph_optimize = opt_spy
        return self

    def __exit__(self, *exc):
        self._unity.UnitySearch.evaluate = self._orig_eval
        self._joint.joint_graph_optimize = self._orig_opt
        return False


def _compile(argv, **kw) -> tuple:
    """Build under the spy: (model, record of the compile)."""
    with _EvalSpy() as spy:
        ff = _build(argv, **kw)
    return ff, {"source": ff._plan_source, "evals": spy.evals,
                "searches": spy.searches, "strategy": _strategy_json(ff),
                "fingerprint": ff._plan_fingerprint}


def warm_job(rank, tmp):
    """Every warm-start scenario on one of 2 gloo ranks; returns what
    rank 0 saw (each rank returns its own)."""
    import glob

    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.telemetry import deactivate, read_jsonl

    out = {}
    rs = np.random.RandomState(0)
    y = rs.randint(0, 10, 128).reshape(-1, 1).astype(np.int32)
    xs = rs.randn(128, 64).astype(np.float32)

    # plan cache: cold, then warm (the warm one fits an epoch)
    ws = os.path.join(tmp, "ws")
    argv = SEARCH_ARGV + ["--warmstart-dir", ws]
    _, out["cold"] = _compile(argv)
    out["plans_dir"] = os.path.isdir(os.path.join(ws, "plans"))
    ff, out["warm"] = _compile(argv)
    ff.fit(xs[:64], y[:64], epochs=1, verbose=False)
    out["warm_fit_steps"] = ff._py_step()

    # any fingerprint component changed -> a fresh search; then the
    # unchanged config still hits
    from flexflow_tpu_torch.warmstart import fingerprint

    changed = {"graph": dict(argv=argv, hidden=128),
               "mesh": dict(argv=["--mesh", "1,2,1,1"] + argv[2:]),
               "budget": dict(argv=[a if a != "6" else "4" for a in argv])}
    for name, kw in changed.items():
        out[f"changed {name}"] = _compile(**kw)[1]
    orig_sig = fingerprint.device_signature
    fingerprint.device_signature = lambda device=None: dict(
        orig_sig(device), device_kind="another card")
    try:
        out["changed device"] = _compile(argv)[1]
    finally:
        fingerprint.device_signature = orig_sig
    out["unchanged again"] = _compile(argv)[1]

    # a torn entry reads as a miss and is rewritten; a stale one too
    ws2 = os.path.join(tmp, "ws2")
    argv2 = SEARCH_ARGV + ["--warmstart-dir", ws2]
    _compile(argv2)
    (plan_file,) = glob.glob(os.path.join(ws2, "plans", "*.json"))
    if rank == 0:
        with open(plan_file, "w") as f:
            f.write('{"version": 1, "fingerpr')
    _, out["torn"] = _compile(argv2)
    entry = json.load(open(plan_file))
    out["repaired"] = entry["version"] == 1 and "strategy" in entry
    _, out["after repair"] = _compile(argv2)
    from flexflow_tpu_torch.distributed import barrier

    barrier()
    if rank == 0:
        entry["strategy"] = {"version": 1, "nodes": {"not_a_node": {
            "outputs": {"0": [["data"], []]}, "weights": {}}}}
        with open(plan_file, "w") as f:
            json.dump(entry, f)
    barrier()
    _, out["stale"] = _compile(argv2)

    # --auto-resume: the plan comes back from the checkpoint manifest
    ck = os.path.join(tmp, "ck")
    argv3 = SEARCH_ARGV + ["--checkpoint-dir", ck, "--checkpoint-every", "2"]
    ff1, out["checkpointed"] = _compile(argv3)
    ff1.fit(xs, y, epochs=1, verbose=False)
    from flexflow_tpu_torch.resilience.checkpointer import latest_checkpoint

    man = json.load(open(os.path.join(latest_checkpoint(ck),
                                      "manifest.json")))
    out["manifest_plan"] = man["extras"].get("plan")
    ff2, out["resumed"] = _compile(argv3 + ["--auto-resume"])
    ff2.fit(xs, y, epochs=2, verbose=False)
    out["resumed_steps"] = ff2._py_step()
    _, out["resumed changed graph"] = _compile(argv3 + ["--auto-resume"],
                                               hidden=128)

    # the calibration DB: the warm compile measures nothing
    ws4 = os.path.join(tmp, "ws4")
    argv4 = SEARCH_ARGV + ["--warmstart-dir", ws4, "--calibrate", "1"]
    _, out["calibrated cold"] = _compile(argv4)
    db_path = os.path.join(ws4, "calibration.json")
    out["db"] = json.load(open(db_path)) if os.path.exists(db_path) else None
    measured = []
    orig = CostModel.calibrate

    def spy(self, node, fn, args):
        measured.append(node.name)
        return orig(self, node, fn, args)

    CostModel.calibrate = spy
    try:
        ffw, out["calibrated warm"] = _compile(argv4)
    finally:
        CostModel.calibrate = orig
    out["warm_measured"] = measured
    out["warm_stats"] = (dict(ffw._warmstart._cost_model.calib_stats)
                         if ffw._warmstart._cost_model is not None else None)

    # the strategy report of the adopted plan: searched cold, replayed
    # warm (on the model axis, so the plan is not the data-parallel
    # default; without --calibrate: a CPU-measured calibration can tip
    # the joint search into a rewritten graph, whose searched report the
    # replayed one cannot match, ROADMAP C4)
    ws6 = os.path.join(tmp, "ws6")
    for tag in ("cold", "warm"):
        tdir = os.path.join(tmp, f"diag_{tag}_{rank}")
        ffd = _build(["--mesh", "1,2,1,1"] + SEARCH_ARGV[2:] + [
                                    "--warmstart-dir", ws6,
                                    "--telemetry-dir", tdir,
                                    "--diagnostics"])
        deactivate()
        rep = json.load(open(os.path.join(tdir, "strategy_report.json")))
        out[f"report {tag}"] = {
            "mode": rep["mode"], "plan_source": rep["plan_source"],
            "configs": {o["name"]: o["config"] for o in rep["ops"]},
            "total": rep["total_predicted_s"],
            "search_result": ffd._search_result is not None,
            "replay_total": (ffd._replay_search[0].evaluate(
                ffd._replay_search[1])[0]
                if ffd._replay_search is not None else None)}

    # telemetry: a miss record, then a hit
    ws5 = os.path.join(tmp, "ws5")
    for tag in ("cold", "warm"):
        tdir = os.path.join(tmp, f"tel_{tag}_{rank}")
        _build(SEARCH_ARGV + ["--warmstart-dir", ws5, "--telemetry-dir",
                              tdir])
        deactivate()
        out[f"tel {tag}"] = [r for r in read_jsonl(os.path.join(
            tdir, "metrics.jsonl")) if r["kind"] in ("warmstart", "compile")]
    return out


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    from flexflow_tpu_torch.distributed import spawn

    tmp = str(tmp_path_factory.mktemp("warm"))
    outs = spawn(warm_job, 2, tmp, timeout=300)
    return outs


def test_warm_compile_hits_plan_cache_zero_evals(warm):
    """The second compile with a shared --warmstart-dir: plan_source
    "cache", 0 evaluate() calls, 0 searches, the cold run's strategy; the
    replayed plan trains; the other rank got the plan by broadcast."""
    r0, r1 = warm
    assert r0["cold"]["source"] == "search" and r0["plans_dir"]
    assert r0["cold"]["searches"] == 1 and r0["cold"]["evals"] > 0
    assert r0["warm"]["source"] == "cache"
    assert r0["warm"]["searches"] == 0 and r0["warm"]["evals"] == 0
    assert r0["warm"]["strategy"] == r0["cold"]["strategy"]
    assert r1["warm"]["source"] == "broadcast"
    assert r1["warm"]["strategy"] == r0["warm"]["strategy"]
    assert r0["warm_fit_steps"] == 2


@pytest.mark.parametrize("component", ["graph", "mesh", "budget", "device"])
def test_fingerprint_invalidation_forces_research(warm, component):
    """A changed graph, mesh, search flag or device signature misses and
    searches; the unchanged config still hits afterwards."""
    r0 = warm[0]
    rec = r0[f"changed {component}"]
    assert rec["searches"] >= 1 and rec["source"] == "search", rec
    again = r0["unchanged again"]
    assert again["evals"] == 0 and again["source"] == "cache"


def test_corrupt_plan_entry_falls_back_and_repairs(warm):
    r0 = warm[0]
    assert r0["torn"]["source"] == "search" and r0["torn"]["searches"] >= 1
    assert r0["repaired"]
    assert (r0["after repair"]["source"] == "cache"
            and r0["after repair"]["evals"] == 0)
    assert r0["stale"]["source"] == "search"


def test_auto_resume_restores_plan_from_manifest(warm):
    """The manifest records the plan and its structural fingerprint;
    --auto-resume adopts it at compile with no search, then fit restores
    the weights and finishes the run."""
    r0 = warm[0]
    plan = r0["manifest_plan"]
    assert plan["structural_fingerprint"] == r0["checkpointed"][
        "fingerprint"]
    assert plan["plan_source"] == "search"
    rec = r0["resumed"]
    assert rec["searches"] == 0 and rec["evals"] == 0
    assert rec["source"] == "checkpoint"
    assert rec["strategy"] == r0["checkpointed"]["strategy"]
    assert r0["resumed_steps"] == 8


def test_auto_resume_plan_mismatch_searches_fresh(warm):
    rec = warm[0]["resumed changed graph"]
    assert rec["searches"] >= 1 and rec["source"] == "search"


def test_calibration_db_persists_measurements(warm):
    """--calibrate 1 persists rank 0's measurement; the warm compile loads
    it and measures nothing."""
    r0 = warm[0]
    (dev_entries,) = r0["db"]["devices"].values()
    assert len(dev_entries) >= 1
    for fwd_bwd in dev_entries.values():
        assert fwd_bwd[0] > 0 and fwd_bwd[1] > 0
    assert list(r0["db"]["devices"]) == ["cpu/cpu"]
    assert r0["warm_measured"] == []
    assert r0["calibrated warm"]["source"] == "cache"
    assert r0["warm_stats"]["measured"] == 0
    assert r0["warm_stats"]["cache_hits"] >= 1
    assert (r0["calibrated cold"]["fingerprint"]
            == r0["calibrated warm"]["fingerprint"])


def test_warmstart_telemetry_records_hit(warm):
    r0 = warm[0]
    (cold_ws,) = [r for r in r0["tel cold"] if r["kind"] == "warmstart"]
    (warm_ws,) = [r for r in r0["tel warm"] if r["kind"] == "warmstart"]
    assert cold_ws["plan"] == "miss" and cold_ws["executable_cache"] is False
    assert warm_ws["plan"] == "hit" and warm_ws["source"] == "cache"
    (cold_c,) = [r for r in r0["tel cold"] if r["kind"] == "compile"]
    (warm_c,) = [r for r in r0["tel warm"] if r["kind"] == "compile"]
    assert cold_c["plan_source"] == "search"
    assert warm_c["plan_source"] == "cache"
    assert warm_c["plan_fingerprint"] == cold_c["plan_fingerprint"]


# ------------------------------------------------------------ one process


def test_strategy_validate_rejects_stale_plans():
    from flexflow_tpu_torch.parallel.strategies import Strategy
    from flexflow_tpu_torch.search.mesh_search import MeshSpec
    from flexflow_tpu_torch.tensor import PartitionSpec as P

    ff = _build(["--only-data-parallel"])
    g = ff.graph
    mesh = MeshSpec({"data": 2, "model": 4, "pipe": 1, "seq": 1})
    ok = Strategy()
    ok.set_output("ws_fc1", 0, (("data",), ("model",)))
    ok.set_weight("ws_fc1", "kernel", P(None, "model"))
    ok.validate(g, mesh)
    cases = [
        (lambda s: s.set_output("phantom_node", 0, (("data",), ())),
         "phantom_node"),
        (lambda s: s.set_output("ws_fc1", 0, (("nonexistent_axis",), ())),
         "nonexistent_axis"),
        (lambda s: s.set_weight("ws_fc1", "no_such_weight", P("model")),
         "no_such_weight"),
        (lambda s: s.set_output("ws_fc1", 0, (("data",),)), "dims"),
        (lambda s: s.set_output("ws_head", 0, ((), ("model",))),
         "divisible"),
        (lambda s: s.set_weight("ws_fc1", "kernel", P("model", None, None)),
         "3 dims"),
    ]
    for make, match in cases:
        bad = Strategy()
        make(bad)
        with pytest.raises(ValueError, match=match):
            bad.validate(g, mesh)


def test_import_strategy_validates_loudly(tmp_path):
    plan = tmp_path / "stale.json"
    plan.write_text(json.dumps({
        "version": 1,
        "nodes": {"some_other_models_layer": {
            "outputs": {"0": [["data"], []]}, "weights": {}}},
    }))
    with pytest.raises(ValueError, match="some_other_models_layer"):
        _build(["--import-strategy", str(plan)])


def test_time_to_first_step_in_summary(tmp_path):
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = str(tmp_path / "tel")
    ff = _build(["--only-data-parallel", "--telemetry-dir", tdir])
    rs = np.random.RandomState(0)
    y = rs.randint(0, 10, 64)
    xs = rs.randn(64, 64).astype(np.float32)
    ff.fit(xs, y.reshape(-1, 1).astype(np.int32), epochs=1, verbose=False)
    recs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
    (summary,) = [r for r in recs if r["kind"] == "summary"]
    assert summary["time_to_first_step_s"] > 0
    compile_recs = [r for r in recs if r["kind"] == "compile"]
    assert compile_recs and compile_recs[0]["plan_source"] == "default"
    assert (summary["time_to_first_step_s"]
            > compile_recs[0]["duration_s"] * 0.5)


def test_executable_cache_is_off_and_says_why(tmp_path, caplog):
    """The JAX package persists XLA executables under the warm-start
    dir; a CUDA graph does not outlive its process, so the port's layer
    is off, says so, and writes no cache directory."""
    ws = str(tmp_path / "ws")
    ff = _build(["--only-data-parallel", "--warmstart-dir", ws])
    assert ff._warmstart is not None
    assert ff._warmstart.executable_cache_on is False
    assert not os.path.exists(os.path.join(ws, "xla_cache"))
    from flexflow_tpu_torch.warmstart import enable_executable_cache

    assert enable_executable_cache(ws) is False


def _tiny_lm(pkg):
    sys.argv = ["test"]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = 2
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(**TINY),
                                batch_size=2)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def test_graph_signature_and_rules_fingerprint_match_jax():
    """The two packages' graph_signature agree node for node on the tiny
    LM, and the ported rules_fingerprint gives the JAX hash on the
    default rule set of a (2, 2) mesh."""
    import flexflow_tpu.search.substitution as jsubs
    from flexflow_tpu.analysis.rules import rules_fingerprint as jrules
    from flexflow_tpu.warmstart.fingerprint import graph_signature as jsig
    import flexflow_tpu_torch.search.substitution as tsubs
    from flexflow_tpu_torch.warmstart.fingerprint import (
        graph_signature, rules_fingerprint)

    jff, tff = _tiny_lm("flexflow_tpu"), _tiny_lm("flexflow_tpu_torch")
    want, got = jsig(jff.graph), graph_signature(tff.graph)
    assert len(got) == len(want) > 20
    for w, g in zip(want, got):
        assert g == w, (g["name"], w["name"])

    class Mesh:
        shape = {"data": 2, "model": 2, "pipe": 1, "seq": 1}

    jx = jsubs.generate_all_pcg_xfers(Mesh, jff.config, jff.graph)
    tx = tsubs.generate_all_pcg_xfers(Mesh, tff.config, tff.graph)
    assert len(tx) == len(jx) > 10
    assert rules_fingerprint(tx) == jrules(jx)


def test_device_signature_names_the_torch_toolchain():
    """The fingerprint's device record carries torch's and CUDA's
    versions and the card's capability (empty on the CPU); the structural
    fingerprint moves with it."""
    import torch

    from flexflow_tpu_torch.warmstart.fingerprint import (
        device_signature, structural_fingerprint)

    sig = device_signature("cpu")
    assert sig["platform"] == "cpu" and sig["torch"] == torch.__version__
    assert set(sig) == {"platform", "device_kind", "device_count",
                        "capability", "torch", "cuda"}
    ff = _build(["--only-data-parallel"])
    axes = dict(ff.mesh.shape)
    a = structural_fingerprint(ff.graph, axes, ff.config)
    assert a == structural_fingerprint(ff.graph, axes, ff.config)
    import flexflow_tpu_torch.warmstart.fingerprint as fp

    orig = fp.device_signature
    fp.device_signature = lambda device=None: dict(orig(device),
                                                   torch="0.0")
    try:
        assert structural_fingerprint(ff.graph, axes, ff.config) != a
    finally:
        fp.device_signature = orig


def test_warm_strategy_report_describes_adopted_plan(warm):
    """With --diagnostics, the warm compile's report attributes the
    ADOPTED plan (mode "replayed", the cold searched report's per-op
    configs and predicted makespan), not the data-parallel fallback; the
    reconstructed (UnitySearch, choice) is kept for a drift
    recalibration."""
    r0 = warm[0]
    cold, warm0 = r0["report cold"], r0["report warm"]
    assert cold["mode"] == "searched" and cold["plan_source"] == "search"
    assert warm0["mode"] == "replayed" and warm0["plan_source"] == "cache"
    assert warm0["configs"] == cold["configs"]
    assert warm0["total"] == pytest.approx(cold["total"], rel=1e-9)
    assert cold["search_result"] and not warm0["search_result"]
    assert warm0["replay_total"] == pytest.approx(warm0["total"], rel=1e-9)
    assert any(c.startswith("tp") for c in cold["configs"].values())


REWRITE_ARGV = ["--mesh", "1,2,1,1", "--budget", "6",
                "--enable-parameter-parallel"]


def rewritten_report_job(rank, tmp):
    """The tiny LM on (1, 2), cold then warm, with --diagnostics: on the
    CPU machine model the joint search's winner is a rewritten graph
    (parallel ops inserted, nodes pinned to "xfer" configs), and compile
    applies its placements to the graph as built. Returns, per compile,
    the report's per-op configs and analysis findings and the running
    graph's placements."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )
    from flexflow_tpu_torch.search.substitution import _logical_assignment
    from flexflow_tpu_torch.telemetry import deactivate

    ws = os.path.join(tmp, "ws")
    out = {}
    for tag in ("cold", "warm"):
        tdir = os.path.join(tmp, f"diag_{tag}_{rank}")
        sys.argv = ["test", *REWRITE_ARGV, "--warmstart-dir", ws,
                    "--telemetry-dir", tdir, "--diagnostics"]
        config = FFConfig(device="cpu")
        config.batch_size = 4
        ff = FFModel(config)
        build_transformer_lm(ff, TransformerLMConfig(
            vocab_size=64, hidden_size=64, num_heads=2, num_layers=2,
            sequence_length=16, attention_impl="xla"), batch_size=4)
        ff.compile(optimizer=SGDOptimizer(lr=0.05),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        deactivate()
        rep = json.load(open(os.path.join(tdir, "strategy_report.json")))
        sr = ff._search_result
        out[tag] = {
            "mode": rep["mode"], "plan_source": rep["plan_source"],
            "rewritten": sr is not None and sr[0].graph is not ff.graph,
            "graph_nodes": sorted(n.name for n in ff.graph.topo_order()),
            "configs": {o["name"]: o["config"] for o in rep["ops"]},
            "placements": {
                n.name: [[list(a) for a in _logical_assignment(pt)]
                         for pt in n.outputs]
                + [sorted((k, repr(v)) for k, v in n.weight_axes.items())]
                for n in ff.graph.topo_order()},
            "total": rep["total_predicted_s"],
            "analysis": [(f["pass"], f["severity"], f["code"],
                          f.get("where", ""))
                         for f in rep["analysis"]["findings"]],
        }
    return out


def test_rewritten_winner_reports_the_graph_that_runs(tmp_path):
    """C4: after a joint search whose winner rewrote the graph, the cold
    report describes the graph as built with the placements compile
    applied (no node of the rewritten graph), and agrees with the warm
    report of the same plan node for node: config names (some of them
    the rewrite's "xfer"), placements, the predicted total and the
    analysis section."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(rewritten_report_job, 2, str(tmp_path), timeout=300)
    cold, warm = outs[0]["cold"], outs[0]["warm"]
    assert cold["rewritten"] and cold["plan_source"] == "search"
    assert warm["plan_source"] == "cache" and not warm["rewritten"]
    assert cold["mode"] == "searched" and warm["mode"] == "replayed"
    assert set(cold["configs"]) <= set(cold["graph_nodes"])
    assert "xfer" in cold["configs"].values()
    assert warm["configs"] == cold["configs"]
    assert warm["placements"] == cold["placements"]
    assert warm["total"] == pytest.approx(cold["total"], rel=1e-9)
    assert warm["analysis"] == cold["analysis"]
    assert outs[1]["cold"]["configs"] == cold["configs"]
