"""Three assertions of the JAX package's CI smokes that no other port test
held (ROADMAP A13), each held on the port's run as the smoke holds it on
the JAX package's:

- `scripts/obs_smoke.py:23-28` (and 150-161): a fit and a shared-prefix
  serving trace through one telemetry session; the drained snapshot's
  TTFT count equals the completed-with-token requests, and
  `run_doctor_torch.py --check` re-derives that identity from the files
  (a copy missing one request record fails it);
- `scripts/elastic_smoke.py:189-233`: an elastic run on 4 gloo ranks (a
  forced capacity shrink 4 -> 2, then an injected 50x drift) whose
  strategy report reproduces every priced decision's payoff sides from
  their factors, whose telemetry carries a `replan` event a decision and
  a `migrate` event, and whose directory passes `run_doctor_torch.py
  --check` (the payoff and makespan identities);
- `scripts/fsdp_smoke.py:100-113, 194-200`: a dp-4 LM under a 0.9 MiB
  cap that stage 2 exceeds, with no update flag: the search chooses
  stage 3 for the memory (stage 2's predicted bytes over the cap, stage
  3's under it), the executor gathers, the fit runs, and the report's
  update stage and makespan identity hold.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def doctor_check(tdir: str) -> tuple:
    """`run_doctor_torch.py DIR --check`: (exit code, its output)."""
    import run_doctor_torch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = run_doctor_torch.main([tdir, "--check"])
    return rc, buf.getvalue()


def test_doctor_holds_the_drained_ttft_identity_of_fit_and_serve(tmp_path):
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = str(tmp_path / "tel")
    sys.argv = ["test"]
    config = FFConfig(device="cpu")
    config.parse_args(["--telemetry-dir", tdir, "--diagnostics",
                       "--metrics-interval", "0.2"])
    lm = TransformerLMConfig(
        vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
        sequence_length=32, attention_impl="xla")
    batch = 8
    config.batch_size = batch
    ff = FFModel(config)
    build_transformer_lm(ff, lm, batch_size=batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rs = np.random.RandomState(0)
    n = batch * 8  # 8 steps
    toks = rs.randint(1, lm.vocab_size,
                      (n, lm.sequence_length)).astype(np.int32)
    pos = np.tile(np.arange(lm.sequence_length, dtype=np.int32), (n, 1))
    labels = rs.randint(0, lm.vocab_size,
                        (n, lm.sequence_length, 1)).astype(np.int32)
    ff.fit({"tokens": toks, "positions": pos}, labels, epochs=1,
           batch_size=batch, verbose=False)
    engine = ff.serve(slots=2, max_new_tokens=4, prefill_chunk=4,
                      kv_layout="paged", kv_block_size=4)
    system = rs.randint(1, lm.vocab_size, 8).tolist()
    prompts = [system] + [system + rs.randint(1, lm.vocab_size,
                                              4).tolist()
                          for _ in range(5)]
    outs = engine.generate(prompts)
    assert [len(o) for o in outs] == [4] * 6
    ff.get_telemetry().close()

    # obs_smoke.py's leg 4, from the files alone
    recs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
    snaps = [r for r in recs if r.get("kind") == "metrics_snapshot"]
    assert len(snaps) >= 2
    for r in snaps:
        for h in (r["metrics"].get("histograms") or {}).values():
            assert sum(h["counts"]) == h["count"]
    final = snaps[-1]["metrics"]
    assert final["histograms"]["train_step_time_s"]["count"] >= 8
    assert final["gauges"]["train_mfu"] > 0
    drained = [r for r in snaps if r.get("drained")]
    assert drained, "no drained serving snapshot"
    ttft = drained[-1]["metrics"]["histograms"]["serve_ttft_s"]
    with_token = sum(1 for r in recs if r.get("kind") == "serve.request"
                     and r.get("new_tokens", 0) > 0)
    assert ttft["count"] == with_token == 6

    rc, text = doctor_check(tdir)
    assert rc == 0, text
    # the doctor holds the identity: a request record lost from the
    # files breaks it
    bad = str(tmp_path / "bad")
    shutil.copytree(tdir, bad)
    path = os.path.join(bad, "metrics.jsonl")
    lines = open(path).read().splitlines()
    drop = next(i for i, t in enumerate(lines)
                if '"serve.request"' in t and '"new_tokens": 4' in t)
    with open(path, "w") as f:
        f.write("\n".join(lines[:drop] + lines[drop + 1:]) + "\n")
    rc, text = doctor_check(bad)
    assert rc == 1 and "serve_ttft_s count" in text, text


def _mlp(mesh, argv=()):
    """elastic_smoke.py's model: 16 -> 32 -> 4, softmax, batch 8,
    SGD(0.05, momentum 0.9)."""
    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )

    sys.argv = ["test"]
    config = FFConfig(device="cpu")
    config.parse_args(list(argv))
    config.mesh_axis_sizes = mesh
    config.batch_size = 8
    ff = FFModel(config)
    x = ff.create_tensor((8, 16), name="x")
    t = ff.dense(x, 32, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def elastic_smoke_rank(rank, tdir):
    """elastic_smoke.py's run on one of 4 gloo ranks: an epoch on dp 4,
    the visible ranks cut to 2 (a forced shrink at fit entry), then the
    drift monitor's prediction cut 50x over two more epochs."""
    rs = np.random.RandomState(0)
    n = 48  # 6 steps an epoch at batch 8
    X = {"x": rs.randn(n, 16).astype(np.float32)}
    Y = rs.randint(0, 4, (n, 1)).astype(np.int32)

    def fit(ff, seed):
        ff.fit({"x": np.roll(X["x"], seed, axis=0)}, np.roll(Y, seed, axis=0),
               epochs=1, batch_size=8, shuffle=False, verbose=False)

    ff = _mlp((4, 1, 1, 1), ["--telemetry-dir", tdir, "--diagnostics"])
    fit(ff, 0)
    visible = {"ranks": [0, 1]}
    ctrl = ff.enable_elastic(cooldown_steps=10_000, horizon_steps=1000,
                             visible_devices_fn=lambda: visible["ranks"],
                             capacity_check_every=1)
    fit(ff, 1)
    out = {"member": ff.mesh.member,
           "shrinks": [{k: d.get(k) for k in ("trigger", "forced",
                                               "decision", "lhs_s", "rhs_s")}
                       for d in ctrl.decisions]}
    if ff.mesh.member:
        out["mesh"] = dict(ff.mesh.shape)
        out["plan_source"] = ff._plan_source
        diag = ff.get_diagnostics()
        ctrl.cooldown_steps = 6
        n_before = len(ctrl.decisions)
        diag.drift.set_prediction((ff._predicted_step_s or 1e-3) / 50)
    fit(ff, 2)
    fit(ff, 3)
    if ff.mesh.member:
        out["drifts"] = [d for d in ctrl.decisions[n_before:]
                         if d.get("trigger") == "drift"]
        out["decisions"] = len(ctrl.decisions)
        ff._telemetry.flush()
    return json.loads(json.dumps(out, default=str))


def test_doctor_holds_the_payoff_and_makespan_identities_of_an_elastic_run(
        tmp_path):
    from flexflow_tpu_torch.distributed import spawn
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = str(tmp_path / "tel")
    ranks = spawn(elastic_smoke_rank, 4, tdir, timeout=300)
    r0 = ranks[0]
    shrink = [d for d in r0["shrinks"]
              if d["trigger"] == "capacity" and d["forced"]]
    assert len(shrink) == 1 and shrink[0]["decision"] == "migrated"
    assert shrink[0]["lhs_s"] is not None and shrink[0]["rhs_s"] is not None
    assert r0["mesh"]["data"] == 2 and r0["plan_source"] == "replan"
    assert [r["member"] for r in ranks] == [True, True, False, False]
    assert r0["drifts"], "no drift decision after the injected drift"
    for k in ("lhs_s", "rhs_s", "predicted_migration_s", "fidelity_ratio",
              "benefit_s_per_step", "horizon_steps", "research_s",
              "advisory"):
        assert k in r0["drifts"][0], k

    # elastic_smoke.py:189-233, from the artifacts alone
    report = json.load(open(os.path.join(tdir, "strategy_report.json")))
    assert report["plan_source"] == "replan"
    decs = report["elastic"]["decisions"]
    assert len(decs) == r0["decisions"]
    priced = [d for d in decs if d.get("lhs_s") is not None]
    assert priced
    for d in priced:
        lhs = d["predicted_migration_s"] * d["fidelity_ratio"]
        rhs = d["benefit_s_per_step"] * d["horizon_steps"]
        assert abs(d["lhs_s"] - lhs) <= 1e-9 + 1e-6 * abs(lhs)
        assert abs(d["rhs_s"] - rhs) <= 1e-9 + 1e-6 * abs(rhs)
    recs = list(read_jsonl(os.path.join(tdir, "metrics.jsonl")))
    assert sum(r.get("kind") == "replan" for r in recs) >= len(decs)
    assert any(r.get("kind") == "migrate" for r in recs)
    rc, text = doctor_check(tdir)
    assert rc == 0, text


def fsdp_smoke_rank(rank, tdir):
    """fsdp_smoke.py's run on one of 4 gloo ranks."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    sys.argv = ["test"]
    config = FFConfig(device="cpu")
    config.parse_args(["--mesh", "4,1,1,1", "-ll:fsize", "0.9",
                       "--diagnostics", "--telemetry-dir", tdir])
    config.batch_size = 4
    ff = FFModel(config)
    cfg = TransformerLMConfig(vocab_size=128, hidden_size=64, num_heads=2,
                              num_layers=2, sequence_length=32)
    build_transformer_lm(ff, cfg, batch_size=4)
    ff.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    dec = dict(ff._update_sharding or {})
    gathers = bool(ff.executor.gather_specs and ff.executor.gather_schedule)
    rs = np.random.RandomState(0)
    n = 8
    X = {"tokens": rs.randint(0, cfg.vocab_size,
                              (n, cfg.sequence_length)).astype(np.int32),
         "positions": np.tile(np.arange(cfg.sequence_length,
                                        dtype=np.int32), (n, 1))}
    Y = rs.randint(0, cfg.vocab_size,
                   (n, cfg.sequence_length, 1)).astype(np.int32)
    ff.fit(X, Y, epochs=1, batch_size=4, shuffle=False, verbose=False)
    return json.loads(json.dumps({"decision": dec, "gathers": gathers,
                                  "step": ff._py_step()}, default=str))


def test_stage3_is_chosen_under_a_cap_stage2_exceeds(tmp_path):
    from flexflow_tpu_torch.diagnostics.explain import verify_report_total
    from flexflow_tpu_torch.distributed import spawn

    tdir = str(tmp_path / "tel")
    ranks = spawn(fsdp_smoke_rank, 4, tdir, timeout=300)
    for r in ranks:
        dec = r["decision"]
        # fsdp_smoke.py:100-113: auto mode, stage 3, for the memory
        assert dec.get("forced") is None, dec
        assert dec["enabled"] and dec["stage"] == 3, dec
        assert dec["reason"] == "memory_bound", dec
        pred = dec["predicted"]
        assert (pred["stage2_mem_bytes"] > pred["hbm_cap_bytes"]
                >= pred["stage3_mem_bytes"]), pred
        assert r["gathers"] and r["step"] == 2
    # fsdp_smoke.py:194-200: the report's stage and makespan identity
    report = json.load(open(os.path.join(tdir, "strategy_report.json")))
    assert report["update_stage"] == 3
    assert report["update_shards"] == ranks[0]["decision"]["shards"] == 4
    total = verify_report_total(report)
    want = report["total_predicted_s"]
    assert abs(total - want) <= 1e-9 + 1e-6 * abs(want)
    assert (report.get("analysis") or {}).get("errors", 1) == 0
