"""The port's diagnostics (`flexflow_tpu_torch/diagnostics/`,
`recompile.py`) against the JAX package's, on the CPU: the twins of
`tests/test_diagnostics.py` (the keras callback's twin is in
`tests/test_torch_frontends.py`) and the
cross-package checks.

- the drift and health monitors on synthetic metric streams (injected NaN
  loss, step-time spike, data-wait stall, drifting predictions); the same
  stream fed to both packages' monitors gives identical alert records;
- the strategy report: its per-op costs reproduce the plan's total under
  the makespan rule (`verify_report_total`), searched (the joint search
  over a virtual 4 x 2 mesh, overlapped sync too) and data-parallel
  fallback; the tiny LM's report and the searched MLP's equal JAX's key
  for key and value for value (prices to 1e-9), the `analysis` section
  (ffcheck) finding for finding;
- fit with diagnostics: an injected NaN gives the nan_loss alert and, in
  --health-abort-on, HealthAbort with the artifacts flushed; a clean run
  no health alert; without --diagnostics no report and no alerts;
- the run doctor on either package's telemetry directory: both packages'
  doctors give the same verdict (healthy, dead);
- RecompileState.alter() drops the built steps and the trajectory after
  it is bit-equal to a run without it.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

from flexflow_tpu_torch import telemetry
from flexflow_tpu_torch.diagnostics import (
    CheckpointStalenessRule,
    DataWaitStallRule,
    DriftMonitor,
    HealthAbort,
    HealthMonitor,
    NaNLossRule,
    StepSpikeRule,
    verify_report_total,
)
from flexflow_tpu_torch.telemetry.recorder import MetricsRecorder, read_jsonl
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKGS = ("flexflow_tpu", "flexflow_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_session_leak():
    yield
    telemetry.deactivate()
    from flexflow_tpu import telemetry as jtel

    jtel.deactivate()


def _step_rec(step, loss=1.0, step_time=0.1, data_wait=0.005, t=None):
    return {"step": step, "epoch": 0, "t": t if t is not None else 1e9 + step,
            "step_time_s": step_time, "data_wait_s": data_wait,
            "save_latency_s": 0.0,
            "device_time_s": max(0.0, step_time - data_wait),
            "loss": loss}


# ---------------------------------------------------------------- drift

def test_drift_monitor_clean_run_no_advisory():
    m = DriftMonitor(predicted_s=0.1, threshold=0.5, warmup=3)
    for i in range(50):
        assert m.observe(i, 0.1 * (1.0 + 0.1 * (-1) ** i)) is None
    assert m.advisories == []
    assert m.error_ema < 0.2


def test_drift_monitor_fires_once_on_sustained_drift():
    m = DriftMonitor(predicted_s=0.1, threshold=0.5, warmup=3)
    fired = [a for a in (m.observe(i, 0.5) for i in range(30))
             if a is not None]
    assert len(fired) == 1  # hysteresis: one advisory per excursion
    adv = fired[0]
    assert adv.error_ema > 0.5 and adv.predicted_s == 0.1
    assert "drift" in adv.message
    rec = adv.to_record()
    assert rec["rule"] == "costmodel_drift"
    json.dumps(rec)


def test_drift_monitor_rearms_after_recovery_and_reset():
    """Once per excursion, re-armed after recovery; a recalibration that
    points the monitor at the new prediction resets it, so a step that
    matches the new prediction fires nothing: recalibrate, recapture,
    fire again does not loop."""
    m = DriftMonitor(predicted_s=0.1, threshold=0.5, warmup=2,
                     ema_alpha=0.5)
    for i in range(10):
        m.observe(i, 0.5)
    assert len(m.advisories) == 1
    for i in range(10, 40):
        m.observe(i, 0.1)
    assert len(m.advisories) == 1
    for i in range(40, 60):
        m.observe(i, 0.5)
    assert len(m.advisories) == 2
    m.set_prediction(0.5)
    for i in range(60, 80):
        assert m.observe(i, 0.5) is None
    assert len(m.advisories) == 2


def test_drift_monitor_drives_recompile_state():
    from flexflow_tpu_torch.recompile import RecompileState

    calls = []

    class _FakeModel:
        executor = None

    rs = RecompileState(trigger_func=lambda ff: True,
                        alter_func=lambda ff: calls.append(1),
                        ffmodel=_FakeModel())
    m = DriftMonitor(predicted_s=0.1, threshold=0.5, warmup=2,
                     recompile_state=rs)
    for i in range(20):
        m.observe(i, 1.0)
    assert calls == [1]
    assert rs.recompilations == 1


def test_drift_monitor_ignores_nonfinite_measurements():
    m = DriftMonitor(predicted_s=0.1, threshold=0.5, warmup=0)
    assert m.observe(1, float("nan")) is None
    assert m.observe(2, float("inf")) is None
    assert m.observe(3, -1.0) is None
    assert m.samples == 0


# ---------------------------------------------------------------- health

def test_nan_loss_rule_fires_once():
    r = NaNLossRule()
    assert r.check(_step_rec(1, loss=0.5)) is None
    a = r.check(_step_rec(2, loss=float("nan")))
    assert a is not None and a.rule == "nan_loss" and a.level == "error"
    assert a.step == 2
    assert r.check(_step_rec(3, loss=float("inf"))) is None


def test_step_spike_rule_warmup_and_fire():
    r = StepSpikeRule(factor=3.0, warmup=3)
    assert r.check(_step_rec(1, step_time=5.0)) is None
    for i in range(2, 10):
        assert r.check(_step_rec(i, step_time=0.1)) is None
    a = r.check(_step_rec(10, step_time=1.0))
    assert a is not None and a.rule == "step_spike" and a.value == 1.0
    assert r.check(_step_rec(11, step_time=0.1)) is None
    baseline = r._ema
    for i in range(12, 21):
        assert r.check(_step_rec(i, step_time=1.0)) is None
    assert r._ema == baseline
    again = r.check(_step_rec(21, step_time=1.0))
    assert again is not None and again.threshold == pytest.approx(
        3.0 * baseline)


def test_data_wait_stall_rule():
    r = DataWaitStallRule(ratio=0.5, warmup=3)
    for i in range(1, 20):
        a = r.check(_step_rec(i, step_time=0.1, data_wait=0.08))
        if a is not None:
            assert a.rule == "data_wait_stall" and a.value > 0.5
            break
    else:
        pytest.fail("sustained 80% data-wait never alerted")
    r2 = DataWaitStallRule(ratio=0.5, warmup=3)
    for i in range(1, 50):
        assert r2.check(_step_rec(i, step_time=0.1, data_wait=0.01)) is None


def test_checkpoint_staleness_rule():
    r = CheckpointStalenessRule(max_age_s=100.0)
    assert r.check(_step_rec(1, t=1000.0)) is None
    r.note_commit(1000.0)
    assert r.check(_step_rec(2, t=1050.0)) is None
    a = r.check(_step_rec(3, t=1200.0))
    assert a is not None and a.rule == "ckpt_stale" and a.value == 200.0
    r.note_commit(1201.0)
    assert r.check(_step_rec(4, t=1250.0)) is None


def test_health_monitor_clean_run_no_alerts():
    sunk = []
    hm = HealthMonitor(sink=sunk.append)
    for i in range(1, 40):
        hm.observe_step(_step_rec(i, loss=1.0 / i, step_time=0.1))
    assert hm.alerts == [] and sunk == []


def test_health_monitor_abort_action():
    sunk = []
    hm = HealthMonitor(abort_on=("nan_loss",), sink=sunk.append)
    hm.observe_step(_step_rec(1))
    with pytest.raises(HealthAbort) as ei:
        hm.observe_step(_step_rec(2, loss=float("nan")))
    assert ei.value.alert.action == "abort"
    assert ei.value.alert.level == "error"
    assert len(sunk) == 1 and sunk[0].rule == "nan_loss"


def test_health_monitor_rejects_unknown_abort_rule():
    with pytest.raises(ValueError, match="unknown rules"):
        HealthMonitor(abort_on=("no_such_rule",))


def test_ckpt_stale_abortable_without_checkpointing():
    hm = HealthMonitor(abort_on=("ckpt_stale",))
    for i in range(1, 20):
        hm.observe_step(_step_rec(i))
    assert hm.alerts == []
    with pytest.raises(ValueError, match="unknown rules"):
        hm.set_abort_on(("bogus",))


def _streams():
    """Synthetic per-step streams, each with the rules it trips."""
    rs = np.random.RandomState(7)
    spiky = [_step_rec(i, step_time=0.1 + 0.01 * rs.rand())
             for i in range(1, 30)]
    spiky[17]["step_time_s"] = 1.5
    stall = [_step_rec(i, step_time=0.1, data_wait=0.09)
             for i in range(1, 30)]
    nan = [_step_rec(i, loss=1.0 / i) for i in range(1, 12)]
    nan[6]["loss"] = float("nan")
    nan[6].update(nonfinite_op="l0_ffn1", nonfinite_phase="bwd",
                  nonfinite_step=6)
    stale = [_step_rec(i, t=1000.0 + 50.0 * i) for i in range(1, 30)]
    drift = [_step_rec(i, step_time=0.1 * (1 + (i > 10) * 4))
             for i in range(1, 40)]
    return {"spike": spiky, "stall": stall, "nan": nan, "stale": stale,
            "drift": drift}


@pytest.mark.parametrize("case", sorted(_streams()))
def test_monitors_emit_jax_alert_records(case):
    """The same step-record stream through both packages' health and
    drift monitors: identical alert and advisory records, in order."""
    stream = _streams()[case]
    out = {}
    for pkg in PKGS:
        health = __import__(f"{pkg}.diagnostics.health",
                            fromlist=["x"])
        drift = __import__(f"{pkg}.diagnostics.drift", fromlist=["x"])
        rules = health.default_rules()
        rules[-1].note_commit(1000.0)  # ckpt_stale's clock
        hm = health.HealthMonitor(rules)
        dm = drift.DriftMonitor(predicted_s=0.1, threshold=0.5)
        recs = []
        for rec in stream:
            recs += [a.to_record() for a in hm.observe_step(dict(rec))]
            adv = dm.observe(rec["step"], rec["device_time_s"])
            if adv is not None:
                recs.append(adv.to_record())
        out[pkg] = recs
    assert out[PKGS[0]] == out[PKGS[1]]
    assert out[PKGS[1]], f"{case}: no record fired"


# ------------------------------------------------------- telemetry satellites

def test_read_jsonl_tolerates_truncated_final_line(tmp_path):
    p = tmp_path / "metrics.jsonl"
    p.write_text('{"kind": "manifest", "t": 1.0}\n'
                 '{"kind": "step", "t": 2.0, "step": 1}\n'
                 '{"kind": "step", "t": 3.0, "st')
    recs = read_jsonl(str(p))
    assert [r["kind"] for r in recs] == ["manifest", "step"]
    with pytest.raises(json.JSONDecodeError):
        read_jsonl(str(p), strict=True)
    p2 = tmp_path / "corrupt.jsonl"
    p2.write_text('{"kind": "manifest"\n{"kind": "step", "t": 2.0}\n')
    with pytest.raises(json.JSONDecodeError):
        read_jsonl(str(p2))


def test_recorder_counts_late_writes_after_close(tmp_path):
    rec = MetricsRecorder(str(tmp_path / "m.jsonl"))
    rec.record("step", step=1)
    rec.close()
    rec.record("late", step=2)
    rec.record("late", step=3)
    assert rec.dropped_after_close == 2
    assert len(read_jsonl(str(tmp_path / "m.jsonl"))) == 1


def test_session_summary_surfaces_dropped_trace_events(tmp_path, capsys):
    sess = telemetry.TelemetrySession(str(tmp_path / "tel"))
    sess.tracer.max_events = 4
    for i in range(20):
        sess.tracer.instant("spam", i=i)
    sess.record_step(1, 0, 0.1, 0.0, 0.0, batch_size=8)
    sess.write_summary()
    sess.close()
    summary = [r for r in read_jsonl(str(tmp_path / "tel/metrics.jsonl"))
               if r["kind"] == "summary"][-1]
    assert summary["trace_dropped_events"] > 0
    assert "dropped" in capsys.readouterr().err


# ---------------------------------------------------------------- explain

def _mlp(pkg="flexflow_tpu_torch", argv=()):
    """tests/test_diagnostics.py's MLP, its layers named (the two packages
    draw the same names)."""
    sys.argv = ["test"] + list(argv)
    mod = __import__(pkg)
    config = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
              else mod.FFConfig())
    if pkg == "flexflow_tpu" and config.mesh_axis_sizes is None:
        config.mesh_axis_sizes = (1, 1, 1, 1)
    ff = mod.FFModel(config)
    x = ff.create_tensor((32, 64), name="x")
    t = ff.dense(x, 128, mod.ActiMode.AC_MODE_RELU, name="dense1")
    t = ff.dense(t, 16, name="dense2")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.1),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    return ff


def _train_data(n=128, in_dim=64, classes=16):
    rs = np.random.RandomState(0)
    return (rs.randn(n, in_dim).astype(np.float32),
            rs.randint(0, classes, (n, 1)).astype(np.int32))


def _searched_report(pkg, tmp_path, argv=()):
    """The MLP compiled on one device, then the joint search over a
    virtual 4 x 2 mesh (the CPU's machine entry): its (UnitySearch,
    choice) is the model's search result, and the report is written."""
    ff = _mlp(pkg, ["--budget", "8", "--enable-parameter-parallel",
                    *argv])
    ms = __import__(f"{pkg}.search.mesh_search", fromlist=["x"])
    mm = __import__(f"{pkg}.search.machine_model", fromlist=["x"])
    cmod = __import__(f"{pkg}.search.cost_model", fromlist=["x"])
    joint = __import__(f"{pkg}.search.joint", fromlist=["x"])
    explain = __import__(f"{pkg}.diagnostics.explain", fromlist=["x"])
    mesh = ms.MeshSpec({"data": 4, "model": 2, "pipe": 1, "seq": 1})
    cm = cmod.CostModel(mm.machine_model_for_mesh(
        mesh, chip=mm.CHIPS["cpu"]))
    _, choice, us = joint.joint_graph_optimize(ff.graph, mesh, ff.config,
                                               cm)
    ff._search_result = (us, choice)
    ff.mesh = mesh
    d = tmp_path / pkg
    return explain.write_strategy_report(ff, str(d)), d


def _finding_keys(analysis: dict) -> list:
    return [(f["pass"], f["severity"], f["code"], f.get("where", ""))
            for f in analysis["findings"]]


def _assert_reports_match(j, t):
    """Key for key, and value for value: strings and ints equal, prices
    to 1e-9; the `analysis` sections by their summary and each finding's
    (pass, severity, code, where) (messages, details and the verify's
    elapsed time are each package's own)."""
    assert set(j) == set(t)
    ja, ta = j["analysis"], t["analysis"]
    for k in ("errors", "warnings", "info", "passes_run"):
        assert ja[k] == ta[k], k
    assert _finding_keys(ja) == _finding_keys(ta)

    def same(a, b, where):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(a, float):
            assert b == pytest.approx(a, rel=1e-9, abs=1e-15), where
        else:
            assert a == b, where

    for k in t:
        if k != "analysis":
            same(j[k], t[k], k)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial_sync", "overlap_sync"])
def test_strategy_report_makespan_property_and_runner_ups(tmp_path,
                                                         overlap):
    """Per-op predicted costs sum, under the makespan rule (with the
    overlapped sync's per-axis bound under
    --search-overlap-backward-update), to the plan's total; runner-ups
    carry the margin they lost by; the report is the JAX package's."""
    argv = ["--search-overlap-backward-update"] if overlap else []
    reps = {p: _searched_report(p, tmp_path, argv) for p in PKGS}
    rep, d = reps["flexflow_tpu_torch"]
    assert rep["mode"] == "searched" and rep["overlap_sync"] is overlap
    assert rep["ops"] and rep["edges"]
    assert verify_report_total(rep) == pytest.approx(
        rep["total_predicted_s"], rel=1e-9)
    for o in rep["ops"]:
        assert o["compute_s"] == pytest.approx(
            o["forward_s"] + o["backward_s"], rel=1e-9)
    assert rep["sum_compute_s"] == pytest.approx(
        sum(o["compute_s"] for o in rep["ops"]), rel=1e-9)
    assert rep["runner_ups"]
    margins = [r["margin_s"] for r in rep["runner_ups"]]
    assert margins == sorted(margins) and all(m >= 0 for m in margins)
    md = (d / "strategy_report.md").read_text()
    assert "predicted step makespan" in md and "Runner-up plans" in md
    assert json.load(open(d / "strategy_report.json")) == json.loads(
        json.dumps(rep))
    _assert_reports_match(reps["flexflow_tpu"][0], rep)


def test_enable_diagnostics_applies_late_settings(tmp_path):
    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir), "--diagnostics"])
    diag = ff.get_diagnostics()
    assert diag.health.abort_on == frozenset()
    same = ff.enable_diagnostics(abort_on=("nan_loss",),
                                 drift_threshold=0.1)
    assert same is diag
    assert diag.health.abort_on == frozenset({"nan_loss"})
    assert diag.drift.threshold == 0.1
    ff.enable_diagnostics()
    assert diag.health.abort_on == frozenset({"nan_loss"})
    assert diag.drift.threshold == 0.1
    # recalibrate arms the drift monitor's recompile hook
    ff.enable_diagnostics(recalibrate=True)
    assert diag.drift.recompile_state is not None


def test_strategy_report_dp_fallback_without_search(tmp_path):
    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir), "--diagnostics"])
    rep = json.load(open(tdir / "strategy_report.json"))
    assert rep["mode"] == "dp_fallback"
    assert verify_report_total(rep) == pytest.approx(
        rep["total_predicted_s"], rel=1e-9)
    assert ff.get_diagnostics() is not None
    assert ff._predicted_step_s == rep["total_predicted_s"]
    # the reconstructed evaluation is kept for a recalibration
    us, choice = ff._replay_search
    assert us.evaluate(choice)[0] == pytest.approx(
        rep["total_predicted_s"], rel=1e-9)
    assert "card" not in rep  # the card is named on the card only


def _tiny_lm(pkg, argv=()):
    sys.argv = ["test"] + list(argv)
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = 2
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=64, num_heads=2, num_layers=2,
        sequence_length=16), batch_size=2)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def test_tiny_lm_strategy_report_matches_jax(tmp_path):
    """The tiny LM's report, written at compile by --diagnostics in each
    package: the JAX package's, key for key and value for value, its
    `analysis` section finding for finding."""
    reps = {}
    for pkg in PKGS:
        tdir = tmp_path / pkg
        _tiny_lm(pkg, ["--telemetry-dir", str(tdir), "--diagnostics"])
        reps[pkg] = json.load(open(tdir / "strategy_report.json"))
    assert "analysis" in reps["flexflow_tpu"]
    assert "analysis" in reps["flexflow_tpu_torch"]
    _assert_reports_match(reps["flexflow_tpu"], reps["flexflow_tpu_torch"])
    assert verify_report_total(reps["flexflow_tpu_torch"]) == pytest.approx(
        reps["flexflow_tpu_torch"]["total_predicted_s"], rel=1e-9)


# ---------------------------------------------------------------- fit e2e

def test_fit_with_diagnostics_nan_injection_alerts(tmp_path):
    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir), "--diagnostics",
                    "--health-abort-on", "nan_loss"])
    x, y = _train_data()
    x[40, 3] = np.nan  # poison one batch
    with pytest.raises(HealthAbort):
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    alerts = read_jsonl(tdir / "alerts.jsonl")
    nan_alerts = [a for a in alerts if a.get("rule") == "nan_loss"]
    assert len(nan_alerts) == 1
    assert nan_alerts[0]["action"] == "abort"
    assert nan_alerts[0]["level"] == "error"
    assert (tdir / "trace.json").exists()
    recs = read_jsonl(tdir / "metrics.jsonl")
    assert [r for r in recs if r["kind"] == "step"]


def test_fit_clean_run_emits_no_health_alerts(tmp_path):
    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir), "--diagnostics"])
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    alerts = read_jsonl(tdir / "alerts.jsonl")
    assert [a for a in alerts if a.get("kind") == "alert"] == []
    diag = ff.get_diagnostics()
    assert diag.health.alerts == []
    recs = read_jsonl(tdir / "metrics.jsonl")
    assert [r for r in recs if r["kind"] == "diagnostics_summary"]
    assert [r for r in recs if r["kind"] == "strategy_report"]


def test_fit_without_diagnostics_unchanged(tmp_path):
    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir)])
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    assert ff.get_diagnostics() is None
    assert not (tdir / "alerts.jsonl").exists()
    assert not (tdir / "strategy_report.json").exists()


# ---------------------------------------------------------------- doctor

def test_run_doctor_post_mortem(tmp_path):
    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    tdir = tmp_path / "tel"
    ff = _mlp(argv=["--telemetry-dir", str(tdir), "--diagnostics",
                    "--health-abort-on", "nan_loss"])
    x, y = _train_data()
    x[40, 3] = np.nan
    with pytest.raises(HealthAbort):
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    d = diagnose(str(tdir))
    assert d["verdict"] == "dead"
    assert d["steps"] >= 1
    assert any(a["rule"] == "nan_loss" for a in d["alerts"])
    assert d["strategy_report"] is not None
    md = render(d)
    assert "Verdict: DEAD" in md and "nan_loss" in md
    assert "Strategy (top ops by predicted cost)" in md
    assert d["flight"]["reason"] == "HealthAbort"


def test_run_doctor_empty_dir_and_corrupt_logs(tmp_path):
    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    d = diagnose(str(tmp_path))
    assert d["verdict"] == "no-steps" and d["alerts"] == []
    render(d)
    (tmp_path / "metrics.jsonl").write_text(
        '{"kind": "manifest", "t": 1.0}\n'
        'GARBAGE NOT JSON\n'
        '{"kind": "step", "t": 2.0, "step": 1, "step_time_s": 0.1}\n')
    d = diagnose(str(tmp_path))
    assert d["steps"] == 1 and d["manifest"]["kind"] == "manifest"
    render(d)


def _run(pkg, tdir, poison: bool):
    """A 4-step MLP fit with --diagnostics in one package (poisoned: a
    NaN batch under --health-abort-on nan_loss)."""
    argv = ["--telemetry-dir", str(tdir), "--diagnostics"]
    if poison:
        argv += ["--health-abort-on", "nan_loss"]
    ff = _mlp(pkg, argv)
    x, y = _train_data()
    if poison:
        x[40, 3] = np.nan
    abort = __import__(f"{pkg}.diagnostics", fromlist=["x"]).HealthAbort
    try:
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    except abort:
        assert poison
    __import__(f"{pkg}.telemetry", fromlist=["x"]).deactivate()


@pytest.mark.parametrize("poison", [False, True], ids=["healthy", "dead"])
def test_doctor_verdicts_agree_across_packages(tmp_path, poison):
    """The doctor reads only files: each package's doctor on each
    package's telemetry dir gives the same verdict, and the JAX package's
    run_doctor --check passes on the port's dir."""
    dirs = {pkg: tmp_path / pkg for pkg in PKGS}
    for pkg, d in dirs.items():
        _run(pkg, d, poison)
    want = "dead" if poison else "healthy"
    for reader in PKGS:
        doctor = __import__(f"{reader}.diagnostics.doctor", fromlist=["x"])
        for d in dirs.values():
            got = doctor.diagnose(str(d))
            assert got["verdict"] == want, (reader, d)
            doctor.render(got)
    _run_doctor([str(dirs["flexflow_tpu_torch"]), "--check"])


def _run_doctor(argv):
    """The JAX package's scripts/run_doctor.py main() in-process
    (SystemExit on a failed --check)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_doctor_under_test",
        os.path.join(REPO, "scripts", "run_doctor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["run_doctor"] + list(argv)
    try:
        mod.main()
    finally:
        sys.argv = old


# ------------------------------------------------------------ recompile

def _lm_data(n=16, seq=16, vocab=64, seed=0):
    rs = np.random.RandomState(seed)
    x = {"tokens": rs.randint(0, vocab, (n, seq)).astype(np.int32),
         "positions": np.tile(np.arange(seq, dtype=np.int32), (n, 1))}
    return x, rs.randint(0, vocab, (n, seq, 1)).astype(np.int32)


def test_recompile_alter_drops_steps_and_keeps_the_trajectory():
    """RecompileState.alter() drops every built step (train, eval,
    forward, chunked); the next fit builds them anew and its trajectory is
    bit-equal to a run that never recompiled."""
    import torch

    from flexflow_tpu_torch.recompile import RecompileState

    x, y = _lm_data()
    runs = []
    for alter in (False, True):
        ff = _tiny_lm("flexflow_tpu_torch")
        ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
        ff.executor.build_chunked_train_step(2)
        ff.executor.build_eval_step()
        if alter:
            seen = []
            rs = RecompileState(lambda m: True,
                                lambda m: seen.append(m), ff)
            assert rs.trigger()
            rs.alter()
            assert seen == [ff] and rs.recompilations == 1
            ex = ff.executor
            assert (ex._train_step, ex._eval_step, ex._forward_fn,
                    ex._chunk_steps) == (None, None, None, {})
        ff.fit(x, y, epochs=1, batch_size=2, shuffle=False, verbose=False)
        runs.append({f"{n}.{k}": t.clone() for n, ws in ff._params.items()
                     for k, t in ws.items()})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


# ------------------------------------------------------------ the mesh

def mesh_diag_job(rank):
    """chip_smoke's phase-20 torchrun leg on one of 4 gloo ranks, at 2
    layers of width 128, sequence 64."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=256, hidden_size=128, num_heads=2,
                             num_layers=2, sequence_length=64)
    return chip_smoke.mesh_diag_check("cpu", lm, captured=False)


def test_mesh_health_abort_agreed_on_four_cpu_ranks():
    """A health abort on a mesh stops every rank at the same step, none
    left waiting in a collective (the rehearsal of chip_smoke's
    torchrun leg, `mesh_diag_check`, on 4 gloo ranks): a NaN in rank 1's
    forward alone, and a rule that fires on rank 1 alone (per step and in
    chunks of 2: the others raise by the flag agreed in the step edge's
    all-reduce); a 3 s stall in rank 2's step fires every rank's watchdog
    and the heartbeats name rank 2."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(mesh_diag_job, 4, timeout=300)
    for o in outs:
        assert o["failures"] == [], o["failures"]
        c = o["checks"]
        assert [g["step"] for g in c["nan on rank 1"]] == [3] * 4
        assert [g["raised"] for g in c["rank-local rule, chunks of 1"]] == [
            "peer_abort", "rank_local", "peer_abort", "peer_abort"]
        assert c["stall on rank 2"]["lagging_named"] == [2]
