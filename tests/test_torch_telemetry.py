"""The port's telemetry/ (and scope/flightrec.py) against the JAX package's.

The port's twins of `tests/test_telemetry.py` (tracer nesting, threads,
counters and instants, the event cap, the recorder's schema, log levels,
disabled telemetry a no-op, `fit` with and without `--telemetry-dir`) and
of `tests/test_metrics_plane.py` (bucket percentiles, snapshot merges,
the Prometheus round trip, telemetry off allocating nothing), on the CPU.
One test runs the same MLP `fit` in both packages with telemetry on: the
record kinds and their field names in `metrics.jsonl` are the same, but
for the manifest's device fields (the port's torch and CUDA versions and
device kind in place of `jax_backend`) and the records of subsystems the
port has not got yet (named with their ROADMAP items).
"""

import json
import socket
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import telemetry
from flexflow_tpu_torch.scope import flightrec
from flexflow_tpu_torch.telemetry import log as fflog
from flexflow_tpu_torch.telemetry.recorder import MetricsRecorder, read_jsonl
from flexflow_tpu_torch.telemetry.tracer import Tracer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_session_leak():
    """A session activated by one test must not instrument the next."""
    yield
    telemetry.deactivate()


def _events(tracer, ph=None):
    evs = tracer.to_dict()["traceEvents"]
    return [e for e in evs if ph is None or e.get("ph") == ph]


# ---------------------------------------------------------------- tracer


def test_tracer_span_nesting():
    tr = Tracer()
    with tr.span("outer", phase="compile"):
        with tr.span("inner"):
            pass
        with tr.span("inner2"):
            pass
    xs = {e["name"]: e for e in _events(tr, "X")}
    assert set(xs) == {"outer", "inner", "inner2"}
    out, inn, inn2 = xs["outer"], xs["inner"], xs["inner2"]
    for child in (inn, inn2):
        assert child["ts"] >= out["ts"]
        assert child["ts"] + child["dur"] <= out["ts"] + out["dur"] + 1e-3
    assert inn2["ts"] >= inn["ts"] + inn["dur"] - 1e-3
    assert out["args"] == {"phase": "compile"}


def test_tracer_thread_safety():
    tr = Tracer()
    n_threads, n_spans = 8, 200
    errors = []
    gate = threading.Barrier(n_threads)

    def worker(i):
        try:
            gate.wait()
            for k in range(n_spans):
                with tr.span(f"w{i}", k=k):
                    pass
        except Exception as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    xs = _events(tr, "X")
    assert len(xs) == n_threads * n_spans
    tids = {e["tid"] for e in xs}
    assert len(tids) == n_threads
    metas = [e for e in _events(tr, "M") if e["name"] == "thread_name"]
    assert tids <= {e["tid"] for e in metas}
    json.loads(json.dumps(tr.to_dict()))


def test_tracer_counter_instant_and_cap(tmp_path):
    tr = Tracer(max_events=8)
    tr.counter("c", {"v": 1})
    tr.instant("marker", step=3)
    for _ in range(50):
        tr.instant("spam")
    path = tr.dump(str(tmp_path / "trace.json"))
    data = json.load(open(path))
    phs = {e["ph"] for e in data["traceEvents"]}
    assert {"C", "i", "M"} <= phs
    dropped = [e for e in data["traceEvents"]
               if e["name"] == "tracer.dropped_events"]
    assert dropped and dropped[0]["args"]["dropped"] > 0


# ---------------------------------------------------------------- recorder


def test_recorder_jsonl_schema(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    rec = MetricsRecorder(path)
    rec.record("manifest", mesh_axes={"data": 1}, git_sha="abc")
    rec.record("step", step=1, step_time_s=0.5, data_wait_s=0.1,
               save_latency_s=0.0)
    rec.close()
    recs = read_jsonl(path)
    assert [r["kind"] for r in recs] == ["manifest", "step"]
    for r in recs:
        assert isinstance(r["t"], float)
    assert recs[1]["step_time_s"] == 0.5
    rec.record("late", x=1)  # after close: dropped and counted
    assert len(read_jsonl(path)) == 2
    assert rec.dropped_after_close == 1
    # a torn final line (a kill mid-write) is dropped, not an error
    with open(path, "a") as f:
        f.write('{"kind": "step", "st')
    assert len(read_jsonl(path)) == 2
    with pytest.raises(json.JSONDecodeError):
        read_jsonl(path, strict=True)


# ---------------------------------------------------------------- logger


def test_logger_levels_and_rank(capsys, monkeypatch):
    fflog.set_level("warning")
    fflog.info("invisible %d", 1)
    fflog.warning("visible %d", 2)
    out = capsys.readouterr()
    assert "invisible" not in out.out
    assert "visible 2" in out.err
    fflog.set_level("debug")
    fflog.debug("now shown")
    assert "now shown" in capsys.readouterr().out
    monkeypatch.setenv("FF_LOG_LEVEL", "error")
    fflog._level = None
    fflog.warning("filtered")
    assert "filtered" not in capsys.readouterr().err
    fflog._level = None
    monkeypatch.delenv("FF_LOG_LEVEL")
    # without a torch.distributed process group this is process 0 of 1;
    # a rank other than 0 keeps its info lines to itself
    assert fflog.process_index() == 0 and fflog.process_count() == 1
    monkeypatch.setattr(fflog, "process_index", lambda: 3)
    fflog.info("rank three")
    assert "rank three" not in capsys.readouterr().out
    monkeypatch.setenv("FF_LOG_ALL_HOSTS", "1")
    fflog.info("rank three again")
    assert "rank three again" in capsys.readouterr().out


def test_disabled_telemetry_is_noop():
    telemetry.deactivate()
    s1 = telemetry.span("anything", a=1)
    s2 = telemetry.span("else")
    assert s1 is s2  # the shared no-op singleton: no allocation per call
    with s1:
        pass
    telemetry.instant("x")
    telemetry.counter("x", {"v": 1})
    telemetry.event("x", y=2)
    telemetry.inc("never_created_total")
    telemetry.observe("never_created_s", 0.5)
    telemetry.set_gauge("never_created", 1.0)


def test_flight_recorder_ring_is_fed_and_dumped(tmp_path):
    rec = flightrec.configure(capacity=16)
    slots = [id(s) for s in rec._ring]
    for i in range(40):
        telemetry.span(f"s{i}")
    flightrec.note_step(7)
    assert [id(s) for s in rec._ring] == slots  # no allocation per event
    snap = rec.snapshot()
    assert len(snap) == 16 and snap[-1]["kind"] == "step"
    sess = telemetry.activate(telemetry.TelemetrySession(str(tmp_path)))
    path = flightrec.dump("test")
    assert path == str(tmp_path / "flight.json")
    doc = json.load(open(path))
    assert doc["reason"] == "test" and doc["last_step"] == 7
    telemetry.deactivate(sess)
    flightrec.configure(capacity=flightrec.DEFAULT_CAPACITY)


# ---------------------------------------------------------------- metrics


def test_percentile_within_one_bucket_width():
    from flexflow_tpu_torch.telemetry.metrics import (
        MetricsRegistry, percentile_from_hist,
    )

    rs = np.random.RandomState(11)
    samples = rs.lognormal(mean=-4.0, sigma=1.0, size=2000)
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    for v in samples:
        h.observe(float(v))
    hd = reg.snapshot()["histograms"]["lat_s"]
    width = 10.0 ** 0.25
    for q in (50.0, 95.0, 99.0):
        exact = float(np.percentile(samples, q))
        est = percentile_from_hist(hd, q)
        assert exact / width <= est <= exact * width


def test_merge_associative_and_order_independent():
    from flexflow_tpu_torch.telemetry.metrics import (
        MetricsRegistry, merge_snapshots,
    )

    rs = np.random.RandomState(3)
    snaps = []
    for host in range(3):
        reg = MetricsRegistry()
        c = reg.counter("train_tokens_total")
        h = reg.histogram("train_step_time_s")
        g = reg.gauge("slots_active", host=str(host))
        for v in rs.lognormal(-2.0, 1.0, size=50 * (host + 1)):
            h.observe(float(v))
            c.inc(8.0)
        g.set(float(host + 1))
        snaps.append(reg.snapshot())
    a = merge_snapshots(snaps)
    b = merge_snapshots([merge_snapshots(snaps[:2]), snaps[2]])
    c = merge_snapshots([snaps[2], snaps[0], snaps[1]])
    assert a == b == c
    hist = a["histograms"]["train_step_time_s"]
    assert hist["count"] == 300 and sum(hist["counts"]) == 300
    assert a["counters"]["train_tokens_total"] == 8.0 * 300
    assert a["gauges"]['slots_active{host="2"}'] == 3.0


def test_prometheus_round_trip():
    from flexflow_tpu_torch.telemetry.metrics import (
        MetricsRegistry, parse_prometheus, to_prometheus,
    )

    reg = MetricsRegistry()
    reg.counter("serve_tokens_out_total").inc(41.0)
    reg.gauge("serve_slots_active", host="0").set(3.0)
    h = reg.histogram("serve_ttft_s")
    for v in (0.01, 0.02, 0.5, 1.7):
        h.observe(v)
    snap = reg.snapshot()
    back = parse_prometheus(to_prometheus(snap))
    assert back["counters"] == snap["counters"]
    assert back["gauges"] == snap["gauges"]
    want = snap["histograms"]["serve_ttft_s"]
    got = back["histograms"]["serve_ttft_s"]
    assert got["counts"] == want["counts"] and got["count"] == want["count"]
    assert got["sum"] == pytest.approx(want["sum"])


# ---------------------------------------------------------------- fit


def _build_mlp(argv=(), pkg="flexflow_tpu_torch"):
    sys.argv = ["test"] + list(argv)
    m = __import__(pkg, fromlist=["x"])
    if pkg == "flexflow_tpu_torch":
        config = m.FFConfig(device="cpu")
    else:
        config = m.FFConfig()
        config.mesh_axis_sizes = (1, 1, 1, 1)
    ff = m.FFModel(config)
    x = ff.create_tensor((32, 64))
    t = ff.dense(x, 64, m.ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 10)
    t = ff.softmax(t)
    ff.compile(optimizer=m.SGDOptimizer(lr=0.1),
               loss_type=m.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[m.MetricsType.METRICS_ACCURACY])
    return ff


def _train_data(n=256, in_dim=64):
    rs = np.random.RandomState(0)
    return (rs.randn(n, in_dim).astype(np.float32),
            rs.randint(0, 10, (n, 1)).astype(np.int32))


def test_fit_with_telemetry_dir_produces_artifacts(tmp_path):
    """fit under --telemetry-dir: a Chrome trace with compile, step and
    data_wait spans; a JSONL log with the manifest first, a compile
    record, one step record per step with the data-wait split, the MFU
    anchor, an epoch record and a summary; metrics.prom."""
    tdir = tmp_path / "telemetry"
    ff = _build_mlp(["--telemetry-dir", str(tdir)])
    x, y = _train_data()
    ff.fit(x, y, epochs=1, batch_size=32)

    trace = json.load(open(tdir / "trace.json"))
    evs = trace["traceEvents"]
    for e in evs:
        assert "name" in e and "ph" in e
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    names = {e["name"] for e in evs}
    assert {"compile", "step", "data_wait"} <= names
    steps_x = [e for e in evs if e["name"] == "step" and e["ph"] == "X"]
    assert [e["args"]["step"] for e in steps_x] == list(range(1, 9))

    recs = read_jsonl(tdir / "metrics.jsonl")
    assert recs[0]["kind"] == "manifest"
    man = recs[0]
    assert man["device_kind"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["process_index"] == 0 and man["process_count"] == 1
    assert man["mesh_axes"] == {"data": 1, "model": 1, "pipe": 1, "seq": 1}
    assert man["config"]["batch_size"] == 64
    assert man["config"]["metrics_interval"] == 0.0
    compile_recs = [r for r in recs if r["kind"] == "compile"]
    assert compile_recs and compile_recs[0]["duration_s"] > 0
    assert compile_recs[0]["num_nodes"] == 4
    anchor = [r for r in recs if r["kind"] == "goodput_anchor"][0]
    assert anchor["flops_per_step"] == 3.0 * (2 * 32 * 64 * 64
                                              + 2 * 32 * 64 * 10 + 32 * 10)
    steps = [r for r in recs if r["kind"] == "step"]
    assert [s["step"] for s in steps] == list(range(1, 9))
    for s in steps:
        assert 0 <= s["data_wait_s"] <= s["step_time_s"]
        assert s["save_latency_s"] == 0.0
        assert s["device_time_s"] == pytest.approx(
            s["step_time_s"] - s["data_wait_s"])
        assert s["ema_step_time_s"] > 0 and s["mfu"] > 0
    assert [r["epoch"] for r in recs if r["kind"] == "epoch"] == [0]
    summary = [r for r in recs if r["kind"] == "summary"][-1]
    assert summary["steps"] == 8
    assert summary["p95_step_time_s"] >= summary["p50_step_time_s"] > 0
    assert summary["examples_per_sec"] > 0
    assert summary["time_to_first_step_s"] > 0
    snaps = [r for r in recs if r["kind"] == "metrics_snapshot"]
    assert snaps[-1]["reason"] == "fit_end"
    assert snaps[-1]["metrics"]["histograms"]["train_step_time_s"][
        "count"] == 8
    assert (tdir / "metrics.prom").exists()
    assert ff.get_telemetry() is not None
    assert telemetry.active_session() is None  # only inside compile/fit


def test_metrics_interval_and_port_export(tmp_path):
    """--metrics-interval writes rolling snapshots and metrics.prom;
    --metrics-port serves them at /metrics on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdir = tmp_path / "tel"
    ff = _build_mlp(["--telemetry-dir", str(tdir), "--metrics-interval",
                     "0.05", "--metrics-port", str(port)])
    assert (ff.config.metrics_interval, ff.config.metrics_port) == (
        0.05, port)
    x, y = _train_data(n=64)
    ff.fit(x, y, epochs=1, batch_size=32)
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert "train_step_time_s_count 2" in body
    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10).read())
    assert health["status"] == "ok"
    ff.get_telemetry().close()
    recs = read_jsonl(tdir / "metrics.jsonl")
    reasons = [r["reason"] for r in recs if r["kind"] == "metrics_snapshot"]
    assert reasons[-1] == "final" and "fit_end" in reasons
    assert "train_step_time_s_count 2" in (tdir / "metrics.prom").read_text()


def test_fit_without_telemetry_leaves_no_session():
    telemetry.deactivate()
    ff = _build_mlp()
    x, y = _train_data(n=64)
    ff.fit(x, y, epochs=1, batch_size=32)
    assert ff.get_telemetry() is None
    assert telemetry.active_session() is None


def test_telemetry_off_fit_allocates_no_metric_objects(monkeypatch):
    """With telemetry off, a fit makes no session, registry or metric
    object: every hook is one global read (the dispatchers return the
    shared no-op span), and the flight recorder writes into its
    preallocated slots."""
    from flexflow_tpu_torch.telemetry import metrics, session

    def refuse(*a, **k):
        raise AssertionError("telemetry object made with telemetry off")

    ff = _build_mlp()
    for cls in (session.TelemetrySession, metrics.MetricsRegistry,
                metrics.Histogram, metrics.Counter, metrics.Gauge):
        monkeypatch.setattr(cls, "__init__", refuse)
    spans = []
    real = telemetry.span
    monkeypatch.setattr(telemetry, "span",
                        lambda *a, **k: spans.append(real(*a, **k))
                        or spans[-1])
    rec = flightrec.get_recorder()
    slots = [id(s) for s in rec._ring]
    x, y = _train_data(n=64)
    ff.fit(x, y, epochs=1, batch_size=32)
    assert spans and all(s is telemetry._NOOP for s in spans)
    assert [id(s) for s in rec._ring] == slots


def test_dataloader_spans(tmp_path):
    ff = _build_mlp()
    x, _ = _train_data(n=64)
    loader = ff.create_data_loader(ff._input_tensors[0], x)
    sess = telemetry.activate(telemetry.TelemetrySession(str(tmp_path)))
    b = loader.next_batch_sharded()
    telemetry.deactivate(sess)
    assert torch.equal(b, torch.as_tensor(x[:32]))
    names = [e["name"] for e in _events(sess.tracer, "X")]
    assert names == ["data.next_batch", "data_wait"]


# JAX records of subsystems the port does not have yet, by ROADMAP item
# (none since A9 brought plan_verify and the compile's
# weight_update_decision)
_NOT_PORTED_KINDS: dict = {}
# the manifest's device fields: JAX's jax_backend, the port's torch and
# CUDA versions and device kind (and `card` on the card)
_JAX_MANIFEST_ONLY = {"jax_backend"}
_PORT_MANIFEST_ONLY = {"torch_version", "cuda_version", "device_kind"}


def test_fit_records_match_the_jax_packages(tmp_path):
    """The same MLP fit in both packages with telemetry on: the same
    record kinds in the same order and, kind by kind, the same field
    names (the manifest's device fields aside)."""
    x, y = _train_data(n=128)
    logs = {}
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        tdir = tmp_path / pkg
        ff = _build_mlp(["--telemetry-dir", str(tdir)], pkg=pkg)
        ff.fit(x, y, epochs=2, batch_size=32, shuffle=False)
        if pkg == "flexflow_tpu":
            from flexflow_tpu import telemetry as jtel

            jtel.deactivate()
        logs[pkg] = read_jsonl(tdir / "metrics.jsonl")
    jrecs = [r for r in logs["flexflow_tpu"]
             if r["kind"] not in _NOT_PORTED_KINDS]
    trecs = logs["flexflow_tpu_torch"]
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    for j, t in zip(jrecs, trecs):
        jk, tk = set(j), set(t)
        if j["kind"] == "manifest":
            jk -= _JAX_MANIFEST_ONLY
            tk -= _PORT_MANIFEST_ONLY
            assert set(t["config"]) == set(j["config"])
        if j["kind"] == "metrics_snapshot":
            assert set(t["metrics"]) == set(j["metrics"])
            assert set(t["metrics"]["histograms"]) == set(
                j["metrics"]["histograms"])
        assert tk == jk, j["kind"]
    jsum = [r for r in jrecs if r["kind"] == "summary"][-1]
    tsum = [r for r in trecs if r["kind"] == "summary"][-1]
    assert tsum["steps"] == jsum["steps"] == 8
