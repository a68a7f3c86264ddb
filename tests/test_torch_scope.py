"""The port's ffscope (`flexflow_tpu_torch/scope/`: op-grain profiling
over torch.profiler, the flight recorder, the hang watchdog): the twin of
`tests/test_scope.py`, on the CPU.

- a synthetic Kineto trace (the JSON `torch.profiler` exports) decodes
  and attributes device time to PCG ops through `record_function`
  ranges: forward kernels by the op's range, backward kernels by the
  autograd sequence number that links the backward function to the
  forward op inside the op's range; runtime scopes land in extras,
  others in unattributed_s; a trace cut short is read up to its last
  whole event;
- a --profile-every fit gives the report a `profile` section with a
  measured column for every report op, the identity re-verifies from the
  JSON (the JAX package's run_doctor --check passes on the port's dir,
  and a tampered fidelity trips it);
- the flight recorder's ring bound and zero-alloc steady state, and a
  HealthAbort fit leaving a well-formed flight.json;
- an injected stall fires the watchdog, which names the lagging rank
  from the file heartbeats and dumps flight.json; with --watchdog-abort a
  stall in Python is interrupted;
- an injected single-op slowdown yields one op-grain drift advisory and
  the recalibration re-measures only that op;
- the serving engine's profile_step and --xprof-dir;
- the fflint `unnamed_op_scope` rule flags an op dispatch outside a
  `record_function` range, and the port's tree has none.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from flexflow_tpu_torch import telemetry
from flexflow_tpu_torch.scope import flightrec
from flexflow_tpu_torch.scope.attribution import (
    attribute_trace,
    build_profile_section,
    verify_profile_section,
)
from flexflow_tpu_torch.scope.flightrec import FlightRecorder
from flexflow_tpu_torch.scope.watchdog import THREAD_NAME, HangWatchdog
from flexflow_tpu_torch.telemetry.recorder import read_jsonl
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_session_leak():
    yield
    telemetry.deactivate()
    flightrec.configure(capacity=flightrec.DEFAULT_CAPACITY, enabled=True)


# --------------------------------------------------------- Kineto traces

def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kineto_trace() -> dict:
    """dense1's forward (an mm in its range, a kernel launched there),
    its backward (the MmBackward0 function on the autograd thread, its
    sequence number the forward mm's), the optimizer in weight_update,
    and a kernel launched outside every range."""
    ev = [
        _x("user_annotation", "dense1", 0.0, 100.0, 1),
        _x("cpu_op", "aten::linear", 5.0, 40.0, 1,
           **{"Sequence number": 5}),
        _x("cpu_op", "aten::mm", 10.0, 20.0, 1, **{"Sequence number": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 2.0, 1,
           correlation=101),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           120.0, 40.0, 2, **{"Sequence number": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 125.0, 2.0, 2,
           correlation=102),
        _x("user_annotation", "weight_update", 200.0, 50.0, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 210.0, 2.0, 1,
           correlation=103),
        _x("cuda_runtime", "cudaLaunchKernel", 300.0, 2.0, 1,
           correlation=104),
    ]
    for corr, dur in ((101, 2000.0), (102, 1000.0), (103, 500.0),
                      (104, 300.0)):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "pid": 0, "tid": 7, "ts": 1000.0 + corr, "dur": dur,
                   "args": {"correlation": corr, "device": 0,
                            "stream": 7}})
    return {"schemaVersion": 1, "traceEvents": ev}


def test_kineto_decode_and_attribution_synthetic(tmp_path):
    """A hand-written Kineto trace → per-op seconds: the forward kernel
    by the op's range, the backward one by the sequence number, the
    runtime scope in extras, the kernel outside every range in
    unattributed_s — and the built section passes its identity check."""
    d = tmp_path / "trace"
    d.mkdir()
    (d / "trace.json").write_text(json.dumps(_kineto_trace()))
    attr = attribute_trace(str(d), ["dense1", "dense2"])
    op = attr["ops"]["dense1"]
    assert op["fwd_s"] == pytest.approx(2e-3)
    assert op["bwd_s"] == pytest.approx(1e-3)
    assert op["measured_s"] == pytest.approx(3e-3)
    assert op["events"] == 2
    assert attr["extras"]["weight_update"] == pytest.approx(0.5e-3)
    assert attr["unattributed_s"] == pytest.approx(0.3e-3)
    assert attr["attributed_s"] == pytest.approx(3.5e-3)
    assert attr["parallelism"] == 1 and attr["devices"] == 1
    section = build_profile_section(
        attr, step=7, device_time_s=4e-3, source="xplane",
        all_op_names=["dense1", "dense2"])
    rows = {r["name"]: r for r in section["ops"]}
    assert rows["dense2"]["measured_s"] == 0.0
    assert verify_profile_section(section) == []
    bad = dict(section, device_time_s=1e-6, parallelism=1)
    assert any("exceeds device budget" in p
               for p in verify_profile_section(bad))


def test_truncated_kineto_trace_is_tolerated(tmp_path):
    """A trace cut short (a process killed while exporting) yields its
    whole events; one cut anywhere never raises."""
    d = tmp_path / "trace"
    d.mkdir()
    text = json.dumps(_kineto_trace())
    for cut in range(1, len(text), 97):
        (d / "trace.json").write_text(text[:cut])
        attr = attribute_trace(str(d), ["dense1"])
        assert attr["attributed_s"] >= 0.0
    # cut inside the last kernel: the other three still attribute
    (d / "trace.json").write_text(text[:text.rindex('"k104"')])
    attr = attribute_trace(str(d), ["dense1"])
    assert attr["attributed_s"] == pytest.approx(3.5e-3)


def test_cpu_capture_attributes_leaf_ops(tmp_path):
    """A real torch.profiler capture on the CPU (no device events): the
    leaf ATen ops are the work; an op's forward by its range, its
    backward by the sequence number."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64, requires_grad=True)
    w = torch.randn(64, 64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("dense1"):
            y = torch.relu(x @ w)
        loss = y.square().sum()
        torch.autograd.grad(loss, [w])
    d = tmp_path / "t"
    d.mkdir()
    prof.export_chrome_trace(str(d / "trace.json"))
    attr = attribute_trace(str(d), ["dense1"])
    op = attr["ops"]["dense1"]
    assert op["fwd_s"] > 0 and op["bwd_s"] > 0
    assert attr["unattributed_s"] > 0  # the loss and its backward


# --------------------------------------------------------- flight recorder

def test_flight_ring_bound_and_order():
    rec = FlightRecorder(capacity=16)
    for i in range(3 * 16 + 5):
        rec.record("span", "op%d" % i, i)
    snap = rec.snapshot()
    assert len(snap) == 16
    seqs = [e["seq"] for e in snap]
    assert seqs == sorted(seqs) and seqs[-1] == 3 * 16 + 5
    assert snap[-1]["name"] == "op%d" % (3 * 16 + 4)


def test_flight_zero_alloc_steady_state():
    rec = FlightRecorder(capacity=32)
    ring_id = id(rec._ring)
    slot_ids = [id(s) for s in rec._ring]
    for _ in range(10 * 32):
        rec.record("span", "step", None)
    assert id(rec._ring) == ring_id
    assert [id(s) for s in rec._ring] == slot_ids


def test_flight_dump_well_formed(tmp_path):
    rec = FlightRecorder(capacity=8)
    rec.note_step(3)
    rec.record("instant", "alert.nan_loss", None)
    rec.record("span", "obj", object())
    path = rec.dump(str(tmp_path), "unit_test", extra={"k": 1})
    doc = json.load(open(path))
    assert doc["kind"] == "flight_record" and doc["reason"] == "unit_test"
    assert doc["capacity"] == 8 and doc["last_step"] == 3
    assert doc["k"] == 1 and len(doc["events"]) <= doc["capacity"]
    json.dumps(doc)


def test_flight_module_plane_and_disable(tmp_path, monkeypatch):
    flightrec.configure(capacity=64, enabled=True)
    rec = flightrec.get_recorder()
    before = rec._seq
    telemetry.instant("x.y")
    with telemetry.span("a.b"):
        pass
    assert rec._seq >= before + 2
    monkeypatch.delenv("FF_FLIGHT_DIR", raising=False)
    assert flightrec.dump("nowhere") is None
    monkeypatch.setenv("FF_FLIGHT_DIR", str(tmp_path))
    assert flightrec.dump("env_dir") == str(tmp_path / "flight.json")
    flightrec.configure(enabled=False)
    telemetry.instant("dropped")
    assert flightrec.get_recorder() is None
    assert flightrec.dump("disabled") is None


# ---------------------------------------------------------------- watchdog

def test_watchdog_lagging_host_from_heartbeats():
    hbs = [{"host": 0, "step": 7, "time_unix": 100.0},
           {"host": 1, "step": 3, "time_unix": 120.0},
           {"host": 2, "step": 7, "time_unix": 90.0}]
    assert HangWatchdog.lagging_host(hbs) == 1
    hbs[1]["step"] = 7
    assert HangWatchdog.lagging_host(hbs) == 2
    assert HangWatchdog.lagging_host([]) is None


def test_watchdog_fires_on_stall_and_names_host(tmp_path):
    fired = []
    wd = HangWatchdog(timeout_s=0.3, multiplier=10.0,
                      directory=str(tmp_path), host_index=1,
                      on_fire=fired.append, poll_interval_s=0.05)
    hb_dir = tmp_path / "heartbeats"
    hb_dir.mkdir()
    (hb_dir / "host-0.json").write_text(
        json.dumps({"host": 0, "step": 1, "time_unix": time.time()}))
    wd.start()
    try:
        wd.beat(4)
        wd.beat(5)
        deadline = time.time() + 5.0
        while not fired and time.time() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert wd.fired == 1 and fired
    info = fired[0]
    assert info["stalled_s"] > 0.3 and info["last_step"] == 5
    assert info["lagging_host"] == 0
    assert {h["host"] for h in info["hosts"]} == {0, 1}
    doc = json.load(open(tmp_path / "flight.json"))
    assert doc["reason"] == "watchdog"
    assert doc["watchdog"]["lagging_host"] == 0


def test_watchdog_rearms_only_after_beat(tmp_path):
    wd = HangWatchdog(timeout_s=0.15, multiplier=0.0,
                      directory=str(tmp_path), poll_interval_s=0.03)
    wd.start()
    try:
        wd.beat(1)
        time.sleep(0.6)
        assert wd.fired == 1
        wd.beat(2)
        time.sleep(0.5)
        assert wd.fired == 2
    finally:
        wd.stop()
    assert wd._thread is None
    assert all(t.name != THREAD_NAME for t in threading.enumerate())


# ------------------------------------------------------------ model e2e

def _compiled_model(extra_argv=(), pkg="flexflow_tpu_torch"):
    sys.argv = ["test"] + list(extra_argv)
    mod = __import__(pkg)
    config = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
              else mod.FFConfig())
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


def _run_doctor(argv):
    """The JAX package's scripts/run_doctor.py main() in-process
    (SystemExit on a failed --check): it reads the port's directory."""
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


def test_profile_every_fit_attribution_and_doctor_gate(tmp_path):
    """--profile-every: the report gains a `profile` section (the sampled
    step run eagerly) with a measured column for every report op; the
    identity re-verifies from the JSON alone (the JAX package's
    run_doctor --check), and tampering trips the gate."""
    import torch

    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir), "--diagnostics",
                          "--profile-every", "2"])
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    telemetry.deactivate()
    rep = json.load(open(tdir / "strategy_report.json"))
    prof = rep["profile"]
    assert prof["source"] == "xplane" and prof["mode"] == "eager_sampled"
    assert prof["step"] == 4  # the last of steps 2 and 4 sampled
    rows = {r["name"]: r for r in prof["ops"]}
    assert {o["name"] for o in rep["ops"]} <= set(rows)
    assert rows["dense1"]["fwd_s"] > 0 and rows["dense1"]["bwd_s"] > 0
    assert prof["extras"]["weight_update"] > 0
    assert prof["extras"]["loss"] > 0  # forward and backward
    measured = [r for r in prof["ops"] if r["measured_s"] > 0]
    assert all("fidelity" in r for r in measured if r.get("predicted_s"))
    assert verify_profile_section(prof) == []
    md = (tdir / "strategy_report.md").read_text()
    assert "Measured profile (ffscope)" in md
    recs = read_jsonl(tdir / "metrics.jsonl")
    assert any(r.get("kind") == "profile" for r in recs)
    snaps = [r for r in recs if r.get("kind") == "metrics_snapshot"]
    assert any(any(k.startswith("op_time_s") for k in
                   (s.get("metrics", {}).get("histograms") or {}))
               for s in snaps)
    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    d = diagnose(str(tdir))
    assert d["profile"] is not None
    assert "Op profile (ffscope)" in render(d)
    _run_doctor([str(tdir), "--check", "--out", str(tmp_path / "r.md")])
    for r in rep["profile"]["ops"]:
        if r.get("fidelity"):
            r["fidelity"] *= 3.0
            break
    json.dump(rep, open(tdir / "strategy_report.json", "w"))
    with pytest.raises(SystemExit):
        _run_doctor([str(tdir), "--check"])
    # no range is opened once the profile is taken: the executor's scopes
    # are off again
    assert ff.executor._scoped is False


def test_profiled_fit_is_bit_equal_to_the_plain_fit(tmp_path):
    """The sampled steps run eagerly under the profiler: the masters after
    the fit are the plain fit's, bit for bit."""
    import torch

    x, y = _train_data()
    out = []
    for argv in ([], ["--telemetry-dir", str(tmp_path / "t"),
                      "--profile-every", "2"]):
        ff = _compiled_model(argv)
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
        telemetry.deactivate()
        out.append([t.clone() for ws in ff._params.values()
                    for t in ws.values()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_profile_step_arms_one_capture(tmp_path):
    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir), "--diagnostics"])
    ff.profile_step()
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    rep = json.load(open(tdir / "strategy_report.json"))
    assert rep["profile"]["step"] == 1  # the armed one-shot: the next step
    recs = read_jsonl(tdir / "metrics.jsonl")
    assert len([r for r in recs if r.get("kind") == "profile"]) == 1


def test_step_profiler_does_not_nest_in_a_running_capture(tmp_path):
    """Inside a running torch.profiler capture (--xprof-dir's) a sampled
    capture does not start: `begin` says so and nothing is attributed;
    outside it starts."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.scope.profile import (StepProfiler,
                                                  profiler_active)

    sp = StepProfiler(trace_root=str(tmp_path))
    sp.arm()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler_active() and sp.begin(1) is False
    assert not sp.enabled  # the one-shot is spent
    assert not profiler_active() and sp.begin(2) is True
    section = sp.end(2, ["x"])
    assert section["step"] == 2 and section["ops"][0]["name"] == "x"
    sp.close()


def test_health_abort_leaves_flight_record(tmp_path):
    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir), "--diagnostics",
                          "--health-abort-on", "nan_loss",
                          "--flight-events", "64"])
    x, y = _train_data()
    x[40, 3] = np.nan
    from flexflow_tpu_torch.diagnostics import HealthAbort

    with pytest.raises(HealthAbort):
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    telemetry.deactivate()
    doc = json.load(open(tdir / "flight.json"))
    assert doc["kind"] == "flight_record" and doc["reason"] == "HealthAbort"
    assert doc["capacity"] == 64 and 0 < len(doc["events"]) <= 64
    kinds = {e["kind"] for e in doc["events"]}
    assert "step" in kinds or "span" in kinds
    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    d = diagnose(str(tdir))
    assert d["flight"]["reason"] == "HealthAbort"
    assert "Flight record (ffscope)" in render(d)
    _run_doctor([str(tdir), "--check"])
    doc["events"] = doc["events"] * 40
    json.dump(doc, open(tdir / "flight.json", "w"))
    with pytest.raises(SystemExit):
        _run_doctor([str(tdir), "--check"])


def test_injected_stall_fires_watchdog_in_fit(tmp_path):
    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir), "--diagnostics",
                          "--watchdog-timeout", "0.6"])

    def stall(step):
        if step == 2:
            time.sleep(1.8)

    ff.set_fault_hook(stall)
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    telemetry.deactivate()
    doc = json.load(open(tdir / "flight.json"))
    assert doc["reason"] == "watchdog"
    wd = doc["watchdog"]
    assert wd["stalled_s"] > 0.6
    assert wd["host"] == 0 and wd["lagging_host"] == 0
    assert (tdir / "heartbeats" / "host-0.json").exists()
    alerts = read_jsonl(tdir / "alerts.jsonl")
    hang = [a for a in alerts if a.get("rule") == "hang_watchdog"]
    assert hang and hang[0]["level"] == "error"
    from flexflow_tpu_torch.diagnostics.doctor import diagnose, render

    d = diagnose(str(tdir))
    assert d["watchdog"] is not None
    assert "Hang watchdog (ffscope)" in render(d)


def test_watchdog_abort_interrupts_a_stall_in_python(tmp_path):
    """--watchdog-abort: a stall in Python (a hook that sleeps) is
    interrupted in the main thread (KeyboardInterrupt), after the watchdog
    fired and wrote its flight record; fit leaves its own dump."""
    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir),
                          "--watchdog-timeout", "0.4", "--watchdog-abort"])
    woke = []

    def stall(step):
        if step == 2:
            t_end = time.time() + 10.0
            while time.time() < t_end:
                time.sleep(0.05)
            woke.append(step)

    ff.set_fault_hook(stall)
    x, y = _train_data()
    t0 = time.time()
    with pytest.raises(KeyboardInterrupt):
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
    telemetry.deactivate()
    assert woke == [] and time.time() - t0 < 8.0
    doc = json.load(open(tdir / "flight.json"))
    assert doc["reason"] == "KeyboardInterrupt"
    assert json.load(open(tdir / "heartbeats" / "host-0.json"))["host"] == 0


# -------------------------------------------- targeted recalibration

def test_op_drift_targeted_recalibration_refreshes_only_drifted_op(
        tmp_path):
    """An injected single-op slowdown yields an op-grain advisory and the
    recalibration re-measures ONLY that op (pinned by counting
    CostModel.calibrate calls). The plan: the joint search over a virtual
    4 x 2 mesh."""
    from flexflow_tpu_torch.diagnostics.drift import recalibrate_model
    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.search.joint import joint_graph_optimize
    from flexflow_tpu_torch.search.machine_model import (
        CHIPS, machine_model_for_mesh)
    from flexflow_tpu_torch.search.mesh_search import MeshSpec

    tdir = tmp_path / "tel"
    ff = _compiled_model(["--telemetry-dir", str(tdir), "--diagnostics",
                          "--budget", "8", "--enable-parameter-parallel"])
    mesh = MeshSpec({"data": 4, "model": 2, "pipe": 1, "seq": 1})
    cm = CostModel(machine_model_for_mesh(mesh, chip=CHIPS["cpu"]))
    _, choice, us = joint_graph_optimize(ff.graph, mesh, ff.config, cm)
    ff._search_result = (us, choice)
    ff.mesh = mesh
    diag = ff.get_diagnostics()
    diag.on_compile()
    rep = diag.report
    assert rep["mode"] == "searched" and diag.drift is not None
    priced = [o for o in rep["ops"] if o["compute_s"] + o["comm_s"] > 0]
    assert len(priced) >= 3
    slow_op = priced[1]["name"]
    rows = []
    for o in priced:
        pred = o["compute_s"] + o["comm_s"]
        scale = 200.0 if o["name"] == slow_op else 2.0
        rows.append({"name": o["name"], "measured_s": pred * scale,
                     "fwd_s": pred * scale, "bwd_s": 0.0, "events": 4})
    section = {
        "source": "xplane", "step": 9, "device_time_s": 1.0,
        "devices": 1, "parallelism": 8, "slop": 0.25,
        "attributed_s": sum(r["measured_s"] for r in rows),
        "unattributed_s": 0.0, "ops": rows, "extras": {},
    }
    diag.on_profile(section)
    assert diag.drift.pending_op_refresh == {slow_op}
    assert [a.op for a in diag.drift.op_advisories] == [slow_op]
    alerts = read_jsonl(tdir / "alerts.jsonl")
    op_advs = [a for a in alerts if a.get("rule") == "costmodel_op_drift"]
    assert [a["op"] for a in op_advs] == [slow_op]
    rep2 = json.load(open(tdir / "strategy_report.json"))
    assert rep2["profile"]["step"] == 9
    measured = []
    us.cm.calibrate = (lambda node, fn, args, **kw:
                       (measured.append(node.name), (1e-4, 2e-4))[1])
    t = recalibrate_model(ff)
    assert t is not None and ff._predicted_step_s == t
    assert measured == [slow_op]
    assert diag.drift.pending_op_refresh == set()
    assert us.cm.calib_stats["targeted"] == [slow_op]


def test_drift_recalibration_on_fit_fires_once_and_recaptures(tmp_path,
                                                             monkeypatch):
    """A planted prediction far under the measured step: ONE advisory, ONE
    recalibration (the dominant ops re-measured on the model's device,
    the harness's repetitions cut to (1, 2)), the step dropped and built
    again, then no advisory (the recalibrated prediction re-arms the
    monitor); the trajectory is bit-equal to the unperturbed fit."""
    import torch

    from flexflow_tpu_torch.search.cost_model import CostModel

    monkeypatch.setattr(CostModel, "_REPS", (1, 2))

    # 8 steps: the advisory at step 6 (after the monitor's 5-sample
    # warm-up), the recalibrated prediction's warm-up covering the rest
    x, y = _train_data(n=256)
    out = []
    for plant in (False, True):
        tdir = tmp_path / f"t{int(plant)}"
        ff = _compiled_model(["--telemetry-dir", str(tdir),
                              "--diagnostics", "--drift-threshold", "1e9"])
        diag = ff.enable_diagnostics(recalibrate=plant)
        calls = []
        if plant:
            diag.drift.set_prediction(1e-9)
            diag.drift.threshold = 0.5
            us = ff._replay_search[0]
            real = us.cm.calibrate_graph

            def counted(*a, **kw):
                calls.append(kw)
                return real(*a, **kw)
            us.cm.calibrate_graph = counted
        ff.fit(x, y, epochs=1, batch_size=32, shuffle=False, verbose=False)
        telemetry.deactivate()
        if plant:
            assert len(diag.drift.advisories) == 1
            assert calls == [{"top_k": 4, "remeasure": True}]
            assert diag.drift.recompile_state.recompilations == 1
        out.append([t.clone() for ws in ff._params.values()
                    for t in ws.values()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_standalone_profile_source_emits_no_op_drift():
    from flexflow_tpu_torch.diagnostics.drift import DriftMonitor
    from flexflow_tpu_torch.profiling import profile_section_from_rows

    rows = [("dense1", "OP_LINEAR", 1e-3, 2e-3),
            ("dense2", "OP_LINEAR", 5e-4, 1e-3)]
    section = profile_section_from_rows(rows)
    assert section["source"] == "standalone"
    assert {r["name"] for r in section["ops"]} == {"dense1", "dense2"}
    assert verify_profile_section(section) == []
    m = DriftMonitor(predicted_s=0.1)
    if section.get("source") == "xplane":
        m.note_profile(section)
    assert m.op_advisories == [] and m.pending_op_refresh == set()


# ------------------------------------------------------------- serving

def test_serving_profile_step_and_xprof_dir(tmp_path):
    """The serving engine's profile_step returns a `source: serving`
    section (the iteration run eagerly), and --xprof-dir wraps
    run_until_drained in torch.profiler, leaving a trace behind."""
    xdir = tmp_path / "xprof"
    sys.argv = ["test", "--xprof-dir", str(xdir)]
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import (TransformerLMConfig,
                                           build_transformer_lm)

    cfg = FFConfig(device="cpu")
    cfg.batch_size = 1
    ff = FFModel(cfg)
    build_transformer_lm(
        ff, TransformerLMConfig(vocab_size=64, hidden_size=32,
                                num_heads=4, num_layers=2,
                                sequence_length=32, attention_impl="xla"),
        batch_size=1)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    eng = ff.serve(slots=2, max_new_tokens=4, prefill_chunk=4)
    eng.submit([3, 7, 11, 2])
    eng.step()
    section = eng.profile_step()
    assert section is not None and section["source"] == "serving"
    assert section["mode"] == "eager_sampled"
    assert section["ops"] and verify_profile_section(section) == []
    assert sum(r["measured_s"] for r in section["ops"]) > 0
    assert eng.last_profile is section
    eng.run_until_drained()
    assert xdir.exists() and any(os.scandir(xdir))


# ---------------------------------------------------------------- config

def test_config_flags_parse():
    sys.argv = ["test", "--profile-every", "3", "--watchdog-timeout",
                "5.5", "--watchdog-multiplier", "12", "--watchdog-abort",
                "--flight-events", "128"]
    from flexflow_tpu import FFConfig as JConfig
    from flexflow_tpu_torch import FFConfig

    for cfg in (FFConfig(device="cpu"), JConfig()):
        assert cfg.profile_every == 3
        assert cfg.watchdog_timeout == 5.5
        assert cfg.watchdog_multiplier == 12.0
        assert cfg.watchdog_abort is True
        assert cfg.flight_events == 128


# ----------------------------------------------------------------- lint

def test_lint_unnamed_op_scope_matrix():
    """A dispatch outside a record_function range flags (the port's
    attribution joins kernels to those ranges), inside one (or pragma'd)
    not; the range must wrap this dispatch, not live past a def; the path
    gate exempts the calibration harness."""
    from flexflow_tpu_torch.analysis.lint import lint_source

    def lint(src, path="flexflow_tpu_torch/executor.py"):
        return [f.code for f in lint_source(src, path=path,
                                            select=("unnamed_op_scope",))]

    bare = ("def fwd(node, ins):\n"
            "    return node.op_def.forward(node.params, ins, {}, None, ctx)\n")
    assert lint(bare) == ["unnamed_op_scope"]
    ranged = ("def fwd(node, ins):\n"
              "    with torch.profiler.record_function(node.name):\n"
              "        return node.op_def.forward(node.params, ins, {},\n"
              "                                   None, ctx)\n")
    assert lint(ranged) == []
    pragma = ("def fwd(node, ins):\n"
              "    return node.op_def.forward(  # fflint: ok unnamed_op_scope\n"
              "        node.params, ins, {}, None, ctx)\n")
    assert lint(pragma) == []
    nested = ("def outer(self, node, ins):\n"
              "    with self._scope(node.name):\n"
              "        def run(t):\n"
              "            return node.op_def.forward(node.params, t, {},\n"
              "                                       None, ctx)\n"
              "        return run(ins)\n")
    assert lint(nested) == ["unnamed_op_scope"]
    assert lint(bare, path="flexflow_tpu_torch/search/cost_model.py") == []
    assert lint(bare, path="flexflow_tpu_torch/ops/core.py") == [
        "unnamed_op_scope"]


def test_lint_repo_sweep_clean():
    """Every op dispatch of the port is inside a range or carries a
    justified pragma."""
    from flexflow_tpu_torch.analysis.lint import lint_paths

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint_paths([os.path.join(root, "flexflow_tpu_torch")],
                          select=("unnamed_op_scope",))
    assert findings == [], [str(f) for f in findings]
