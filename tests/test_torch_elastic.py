"""The port's elastic re-planner (`flexflow_tpu_torch/elastic/`) and its
in-process migration against the JAX package's, on the CPU: the twin of
`tests/test_elastic.py`.

One spawn of 4 gloo ranks (`elastic_job`) runs the mesh cases, the JAX
package's side runs here on its virtual mesh, float32 throughout, the
port loading the JAX model's initial weights (`load_params`):

- a capacity SHRINK at fit entry (4 -> 2 visible ranks, the JAX test's
  sequence): the same decision record as the JAX package's (trigger,
  decision, forced, new mesh axes, capacity, both payoff sides), ranks 2
  and 3 parked, the final masters and slots within `F32_TOL` of JAX's and
  bit-equal to a checkpoint-restart at dp 2 on the same 2-rank sub-mesh;
  a parked rank reaching no collective but the world agreements it was
  counted in;
- a regrow within the world (back to dp 4, the payoff deciding) and the
  parked ranks training again; a visible count past the torchrun world
  declined with no search; an undividable count declined; an
  unprofitable move declined with the executor object kept;
- a drift advisory on one rank alone: every rank re-plans at the same
  step (the flag agreed at the step edge);
- a shrink at a step edge mid-fit, per step and in chunks of 2, the two
  bit-equal;

a second spawn rehearses the torchrun legs of `chip_smoke.py` (C5's
abort check and the elastic leg) at 2 layers of width 128;

and in one process, each against the JAX package: a sustained drift
excursion gives exactly one re-plan, --elastic-dry-run decides but never
migrates, the serving engine's decode re-plan keeps every in-flight token
stream (equal to JAX's on the same weights; the re-plan to DP2 runs on 2
gloo ranks), and the migration fidelity's EMA round-trips the warm-start
calibration DB.
"""

import json
import os
import sys

import numpy as np
import pytest

PORT, JAX = "flexflow_tpu_torch", "flexflow_tpu"
DP4 = (4, 1, 1, 1)
DP2 = (2, 1, 1, 1)
DP2_TP2 = (2, 2, 1, 1)
ONE = (1, 1, 1, 1)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# the decision-record fields both packages must agree on
RECORD = ("trigger", "decision", "forced", "dry_run", "would_migrate")


def _mlp(pkg, mesh=DP4, argv=(), seed=0, ranks=None, batch=8):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    config = (mod.FFConfig(device="cpu") if pkg == PORT
              else mod.FFConfig())
    config.mesh_axis_sizes = mesh
    config.batch_size = batch
    config.seed = seed
    ff = mod.FFModel(config)
    if ranks is not None:
        ff._mesh_ranks = list(ranks)  # a control run on a sub-mesh
    x = ff.create_tensor((batch, 16), name="x")
    t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = {"x": rs.randn(n, 16).astype(np.float32)}
    y = rs.randint(0, 4, (n, 1)).astype(np.int32)
    return x, y


def _fit(ff, seed=0, n=16, **kw):
    x, y = _data(n, seed)
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False, **kw)
    return ff


def _record(dec) -> dict:
    """The fields of a decision record both packages must agree on."""
    out = {k: dec.get(k) for k in RECORD}
    out["new_mesh_axes"] = dec.get("new_mesh_axes")
    out["capacity"] = dec.get("capacity")
    out["sides"] = ("lhs_s" in dec, "rhs_s" in dec)
    return out


def _jax_flat(tree) -> dict:
    import jax.tree_util as jtu

    return {jtu.keystr(p): np.asarray(v)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


def _port_state(ff) -> dict:
    """Masters and slots whole (collective over the mesh), the step."""
    from flexflow_tpu_torch.resilience.checkpointer import (
        _keystr, tree_items)

    ex = ff.executor
    out = {"params": {}, "slots": {}, "step": int(ff._step)}
    for path, t in tree_items(ff._params):
        out["params"][_keystr(path)] = ex.full_weight(
            path[-2], path[-1], t).numpy().copy()
    for path, t in tree_items(ff._opt_slots):
        out["slots"][_keystr(path)] = ex.full_weight(
            path[-2], path[-1], t).numpy().copy()
    return out


def _plain(decisions) -> list:
    return json.loads(json.dumps(decisions, default=str))


# the collectives a parked rank could reach
_COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "barrier",
                "broadcast_object_list", "all_gather_object", "new_group",
                "all_gather_into_tensor", "reduce_scatter_tensor",
                "batch_isend_irecv", "all_to_all_single")


def _count_parked(ctrl) -> dict:
    """Count each torch.distributed collective this rank calls while its
    controller keeps it parked (inside `_park`)."""
    import torch.distributed as dist

    calls, parked = {}, [False]

    def wrap(name):
        fn = getattr(dist, name)

        def counted(*a, **kw):
            if parked[0]:
                calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        setattr(dist, name, counted)

    for name in _COLLECTIVES:
        wrap(name)
    park = ctrl._park

    def parking(*a, **kw):
        parked[0] = True
        try:
            return park(*a, **kw)
        finally:
            parked[0] = False
    ctrl._park = parking
    return calls


def elastic_job(rank, tmp, init):
    """The mesh cases on one of 4 gloo ranks (module docstring)."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.elastic import replan

    out = {}
    vis = {"ranks": [0, 1]}
    # --- a shrink at fit entry, then a checkpoint-restart control
    ff = _mlp(PORT, DP4)
    load_params(ff, init)
    _fit(ff)
    ck = os.path.join(tmp, "ck")
    ff.save_checkpoint(ck)
    ctrl = ff.enable_elastic(cooldown_steps=0, horizon_steps=10 ** 6,
                             visible_devices_fn=lambda: vis["ranks"],
                             capacity_check_every=1)
    calls = _count_parked(ctrl)
    _fit(ff, seed=1)
    shrink = {"decisions": _plain(ctrl.decisions),
              "member": ff.mesh.member, "ranks": list(ff.mesh.ranks),
              "mesh": dict(ff.mesh.shape), "polls": ctrl.parked_polls,
              "calls": dict(calls)}
    if ff.mesh.member:
        shrink["state"] = _port_state(ff)
    out["shrink"] = shrink
    ctl = _mlp(PORT, DP2, ranks=[0, 1])
    out["control_member"] = ctl.mesh.member
    if ctl.mesh.member:
        ctl.load_checkpoint(ck)
        out["control"] = _port_state(_fit(ctl, seed=1))
    # --- the regrow: every rank visible again, the payoff decides (the
    # strategy report's predicted step times price the benefit)
    ff.enable_diagnostics(os.path.join(tmp, f"tel{rank}"),
                          drift_threshold=1e9)
    vis["ranks"] = [0, 1, 2, 3]
    n0 = len(ctrl.decisions)
    _fit(ff, seed=2)
    out["regrow"] = {"decisions": _plain(ctrl.decisions[n0:]),
                     "member": ff.mesh.member,
                     "mesh": dict(ff.mesh.shape),
                     "state": _port_state(ff)}
    # --- a visible count past the torchrun world: declined, no search
    vis["ranks"] = list(range(8))
    ex, n0 = ff.executor, len(ctrl.decisions)
    _fit(ff, seed=3)
    out["past"] = {"decisions": _plain(ctrl.decisions[n0:]),
                   "same_executor": ff.executor is ex}
    # --- an undividable visible count at (2, 2)
    u = _mlp(PORT, DP2_TP2)
    uc = u.enable_elastic(cooldown_steps=0,
                          visible_devices_fn=lambda: [0, 1, 2],
                          capacity_check_every=1)
    ex = u.executor
    out["undividable"] = {"moved": uc.maybe_replan(u._py_step()),
                          "decision": _plain(uc.decisions[-1]),
                          "same_executor": u.executor is ex}
    # --- an unprofitable move: declined, the running plan kept
    p = _fit(_mlp(PORT, DP4))
    p._migration_fidelity = (1e12, 3)
    ex, before = p.executor, _port_state(p)
    dec = replan(p, step=p._py_step(), trigger="capacity",
                 horizon_steps=1000, new_mesh_axes=DP2_TP2)
    after = _port_state(p)
    out["payoff"] = {
        "decision": _plain(dec), "same_executor": p.executor is ex,
        "mesh": dict(p.mesh.shape),
        "same_bits": all(np.array_equal(before["params"][k],
                                        after["params"][k])
                         for k in before["params"]),
        "last_is_dec": p._elastic_decisions[-1] is dec}
    _fit(p)
    # --- a drift advisory on rank 1 alone: the flag is agreed at the
    # step edge, so every rank re-plans at the same step
    d = _mlp(PORT, DP4, argv=["--telemetry-dir",
                              os.path.join(tmp, f"drift{rank}"),
                              "--diagnostics"])
    dc = d.enable_elastic(cooldown_steps=0, horizon_steps=10 ** 6,
                          visible_devices_fn=lambda: [0, 1, 2, 3],
                          capacity_check_every=1000)
    drift = d.get_diagnostics().drift
    if rank == 1:
        drift.set_prediction(1e-9)
    else:
        drift.threshold = 1e9  # the other ranks see no drift
    _fit(d, n=64)
    out["drift"] = {"decisions": _plain(dc.decisions),
                    "step": d._py_step()}
    # --- a shrink at a step edge mid-fit, per step and in chunks of 2
    out["mid"] = {}
    for steps in (1, 2):
        m = _mlp(PORT, DP4)
        load_params(m, init)
        mc = m.enable_elastic(
            cooldown_steps=0, horizon_steps=1000,
            visible_devices_fn=lambda m=m: ([0, 1] if m._py_step() >= 2
                                            else [0, 1, 2, 3]),
            capacity_check_every=1)
        _fit(m, n=32, pipeline_steps=steps)
        out["mid"][steps] = {
            "decisions": _plain(mc.decisions), "member": m.mesh.member,
            "state": _port_state(m) if m.mesh.member else None}
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(the 4 ranks' outputs, the JAX package's shrink run and its
    initial weights)."""
    from flexflow_tpu_torch.distributed import spawn

    import jax

    tmp = str(tmp_path_factory.mktemp("elastic"))
    j = _mlp(JAX, DP4)
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in j._params.items()}
    outs = spawn(elastic_job, 4, tmp, init, timeout=300)
    _fit(j)
    ctrl = j.enable_elastic(
        cooldown_steps=0, horizon_steps=10 ** 6,
        visible_devices_fn=lambda: jax.devices()[:2],
        capacity_check_every=1)
    _fit(j, seed=1)
    ref = {"decisions": _plain(ctrl.decisions),
           "params": _jax_flat(j._params), "slots": _jax_flat(j._opt_slots),
           "step": int(j._step), "mesh": dict(j.mesh.shape)}
    return outs, ref


def test_capacity_shrink_decision_matches_jax(mesh_runs):
    """Devices vanish (4 -> 2 visible): one forced, migrated capacity
    decision on every rank, the same record as the JAX package's."""
    outs, ref = mesh_runs
    assert len(ref["decisions"]) == 1
    want = _record(ref["decisions"][0])
    for o in outs:
        got = o["shrink"]["decisions"]
        assert [_record(d) for d in got] == [want], got
        assert got[0]["capacity"]["shrink"] is True
        assert got[0]["new_mesh_axes"] == ref["mesh"]
    assert [o["shrink"]["member"] for o in outs] == [True, True, False,
                                                    False]
    assert outs[0]["shrink"]["ranks"] == [0, 1]


def test_capacity_shrink_matches_jax_and_checkpoint_restart(mesh_runs):
    """The shrink run's final masters and slots: within F32_TOL of the
    JAX package's, and bit-equal to a checkpoint-restart at dp 2 on the
    same 2-rank sub-mesh (its ranks 2 and 3 parked at compile)."""
    outs, ref = mesh_runs
    assert [o["control_member"] for o in outs] == [True, True, False,
                                                  False]
    for o in outs[:2]:
        got, ctl = o["shrink"]["state"], o["control"]
        assert got["step"] == ctl["step"] == ref["step"] == 4
        for part in ("params", "slots"):
            assert got[part].keys() == ctl[part].keys()
            for k in got[part]:
                assert np.array_equal(got[part][k], ctl[part][k]), (part, k)
        assert set(got["params"]) == set(ref["params"])
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **F32_TOL,
                                       err_msg=k)
        assert len(got["slots"]) == len(ref["slots"])
        for k, v in ref["slots"].items():
            np.testing.assert_allclose(
                got["slots"][k], v, **F32_TOL, err_msg=k)


def test_parked_rank_reaches_only_the_agreement(mesh_runs):
    """While parked, ranks 2 and 3 call one collective a world agreement
    (the active ranks' step-edge checks and their leaving fit) and no
    other; the active ranks never wait on them."""
    outs, _ = mesh_runs
    for o in outs[2:]:
        s = o["shrink"]
        # steps 3 and 4 each checked, then the release
        assert s["polls"] == 3, s
        assert s["calls"] == {"all_reduce": s["polls"]}, s
    for o in outs[:2]:
        assert o["shrink"]["calls"] == {}


def test_regrow_within_the_world_migrates(mesh_runs):
    """Every rank visible again: the payoff moves the run back to dp 4,
    the parked ranks receive the live state and train on, all ranks
    equal."""
    outs, _ = mesh_runs
    for o in outs:
        r = o["regrow"]
        decs = [d for d in r["decisions"] if d["decision"] == "migrated"]
        assert len(decs) == 1, r["decisions"]
        d = decs[0]
        assert d["trigger"] == "capacity" and d["forced"] is False
        assert d["would_migrate"] is True and d["lhs_s"] < d["rhs_s"]
        assert d["new_mesh_axes"]["data"] == 4
        assert r["member"] and r["mesh"]["data"] == 4
        assert r["state"]["step"] == 6
    for k, v in outs[0]["regrow"]["state"]["params"].items():
        for o in outs[1:]:
            assert np.array_equal(o["regrow"]["state"]["params"][k], v), k


def test_growth_past_the_world_declined_without_search(mesh_runs):
    outs, _ = mesh_runs
    for o in outs:
        p = o["past"]
        assert p["same_executor"] and p["decisions"]
        for d in p["decisions"]:
            assert d["decision"] == "declined"
            assert d["capacity"]["visible"] == 8
            assert d["capacity"]["new_axes"] is None
            assert "past the torchrun world" in d["reason"]
            assert "lhs_s" not in d  # no search ran: nothing priced


def test_capacity_undividable_declines_without_search(mesh_runs):
    """3 visible at (2, 2): the fixed model axis cannot divide it. The
    JAX package's record: declined, no new axes, nothing priced."""
    outs, _ = mesh_runs
    for o in outs:
        u = o["undividable"]
        assert u["moved"] is False and u["same_executor"]
        d = u["decision"]
        assert d["decision"] == "declined"
        assert d["capacity"]["new_axes"] is None
        assert d["capacity"]["visible"] == 3 and d["capacity"]["shrink"]
        assert "lhs_s" not in d
        assert d["reason"] == "no mesh factorization for visible device set"


def test_payoff_declines_unprofitable_move(mesh_runs):
    """A ruinous fidelity: the payoff rule declines, the running plan
    survives object-identically with the same bits, and training goes
    on (the fit after it ran)."""
    outs, _ = mesh_runs
    for o in outs:
        p = o["payoff"]
        d = p["decision"]
        assert d["decision"] == "declined" and d["would_migrate"] is False
        assert not d["lhs_s"] < d["rhs_s"]
        assert d["fidelity_ratio"] == pytest.approx(1e12)
        assert p["same_executor"] and p["same_bits"] and p["last_is_dec"]
        assert p["mesh"]["data"] == 4


def test_drift_on_one_rank_replans_every_rank(mesh_runs):
    """A drift advisory on rank 1 alone (its prediction planted at 1 ns,
    the other ranks' threshold out of reach): the flag agreed in the step edge's all-reduce, every rank takes the
    same drift decision at the same step (the payoff priced on rank 0
    and shared), and all finish the fit together."""
    outs, _ = mesh_runs
    decs = [o["drift"]["decisions"] for o in outs]
    assert all(len(d) == 1 for d in decs), decs
    assert len({(d[0]["trigger"], d[0]["step"], d[0]["decision"],
                 d[0]["lhs_s"], d[0]["rhs_s"]) for d in decs}) == 1
    assert decs[0][0]["trigger"] == "drift"
    assert decs[1][0]["advisory"]["rule"] == "costmodel_drift"
    assert decs[0][0]["advisory"] is None
    assert {o["drift"]["step"] for o in outs} == {8}


def test_mid_fit_shrink_per_step_and_in_chunks(mesh_runs):
    """A shrink at the step-2 edge: per step and in chunks of 2 (the
    prefetcher restaged for the new mesh) the same decision and the same
    bits; the parked ranks skip the steps they sat out."""
    outs, _ = mesh_runs
    for o in outs:
        for steps in (1, 2):
            m = o["mid"][steps]
            migrated = [d for d in m["decisions"]
                        if d["decision"] == "migrated"]
            assert len(migrated) == 1 and migrated[0]["step"] == 2, m
            assert migrated[0]["forced"] is True
    for o in outs[:2]:
        a, b = o["mid"][1]["state"], o["mid"][2]["state"]
        assert a["step"] == b["step"] == 4
        for k in a["params"]:
            assert np.array_equal(a["params"][k], b["params"][k]), k
    assert [o["mid"][2]["member"] for o in outs] == [True, True, False,
                                                      False]


def mesh_legs_job(rank):
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=512, hidden_size=128, num_heads=4,
                             num_layers=2, sequence_length=128)
    return {"c5": chip_smoke.mesh_c5_check("cpu", lm),
            "elastic": chip_smoke.mesh_elastic_check("cpu", lm, steps=3)}


def test_mesh_c5_and_elastic_legs_pass_on_four_cpu_ranks():
    """The torchrun legs of chip_smoke.py on 4 gloo ranks: C5's check (a
    HealthAbort and an SPMDDivergenceError out of fit on every rank,
    caught; the aborted step freed, a fresh compile stepping, an
    all-reduce returning) and the elastic leg (dp 4 -> a forced shrink to
    dp 2 with ranks 2 and 3 parked, bit-equal to a checkpoint-restart on
    the same sub-mesh -> a regrow to dp 4 by the payoff -> a count past
    the world declined; every rank leaving at the same step)."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(mesh_legs_job, 4, timeout=300)
    for o in outs:
        assert o["c5"]["failures"] == [], o["c5"]
        assert o["c5"]["all_ranks_ok"]
        assert o["elastic"]["failures"] == [], o["elastic"]
    n = [o["elastic"]["numbers"] for o in outs]
    assert [x["parked"] for x in n] == [False, False, True, True]
    assert all(x["final_step"] == 10 for x in n)
    assert all(x["restart_differ"] == [] for x in n[:2])
    assert all(x["regrow"][0]["moved_bytes"] > 0 for x in n[2:])


# ================================================= one process, both


def _both(build):
    return build(JAX), build(PORT)


def test_sustained_drift_triggers_exactly_one_replan(tmp_path):
    """One sustained excursion, one re-plan in both packages: the
    advisory's hysteresis is the single trigger source, cooldown swallows
    the tail, and the recompile is plan_source "replan" with the same
    decision record; the strategy report's elastic section carries it."""
    recs = {}
    for pkg in (JAX, PORT):
        tel = tmp_path / pkg
        ff = _fit(_mlp(pkg, ONE, argv=["--telemetry-dir", str(tel),
                                       "--diagnostics"]))
        diag = ff.get_diagnostics()
        ctrl = ff.enable_elastic(
            cooldown_steps=4, horizon_steps=10_000,
            visible_devices_fn=lambda pkg=pkg: (
                [0] if pkg == PORT else __import__("jax").devices()[:1]))
        assert diag.elastic is ctrl
        assert diag.drift.recompile_state is None
        pred = ff._predicted_step_s
        step0 = ff._py_step()
        old_executor = ff.executor
        for i in range(1, 11):
            step = step0 + i
            dev = (ff._predicted_step_s if ctrl.decisions else pred * 10)
            diag.on_step({"step": step, "loss": 0.1,
                          "step_time_s": dev, "device_time_s": dev})
            ctrl.maybe_replan(step)
        assert len(ctrl.decisions) == 1, ctrl.decisions
        dec = ctrl.decisions[0]
        lhs = dec["predicted_migration_s"] * dec["fidelity_ratio"]
        rhs = dec["benefit_s_per_step"] * dec["horizon_steps"]
        assert dec["lhs_s"] == pytest.approx(lhs)
        assert dec["rhs_s"] == pytest.approx(rhs) and lhs < rhs
        assert dec["advisory"]["rule"] == "costmodel_drift"
        assert ff._plan_source == "replan"
        assert ff.executor is not old_executor
        rep = json.load(open(tel / "strategy_report.json"))
        assert rep["plan_source"] == "replan"
        assert rep["elastic"]["migrations"] == 1
        assert rep["elastic"]["decisions"][0]["lhs_s"] == pytest.approx(
            dec["lhs_s"])
        recs[pkg] = dict(_record(dec), step=dec["step"],
                         origin=ff._plan_origin)
        _fit(ff)
    assert recs[PORT] == recs[JAX]


def test_dry_run_decides_but_never_migrates():
    """--elastic-dry-run: the whole pipeline runs and records what it
    WOULD do, in both packages alike; the model is untouched."""
    recs = {}
    for pkg in (JAX, PORT):
        from importlib import import_module

        replan = import_module(f"{pkg}.elastic").replan
        ff = _fit(_mlp(pkg, ONE))
        old_executor, old_source = ff.executor, ff._plan_source
        dec = replan(ff, step=ff._py_step(), trigger="drift",
                     horizon_steps=10_000, dry_run=True,
                     measured_ema_s=(ff._predicted_step_s or 1e-3) * 10)
        assert dec["decision"] == "dry_run" and dec["would_migrate"] is True
        assert ff.executor is old_executor
        assert ff._plan_source == old_source
        recs[pkg] = _record(dec)
        _fit(ff)
    assert recs[PORT] == recs[JAX]


def _lm(pkg):
    sys.argv = ["test"]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = mod.FFConfig(device="cpu") if pkg == PORT else mod.FFConfig()
    cfg.mesh_axis_sizes = ONE
    cfg.batch_size = 1
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
        sequence_length=32, attention_impl="xla"), batch_size=1)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.01),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def serving_replan_job(rank, params, prompts):
    """One rank of the serving re-plan: mid-decode onto a fresh one-card
    decode model, then onto DP2 over both gloo ranks, then drained."""
    from flexflow_tpu_torch import load_params

    ff = _lm(PORT)
    load_params(ff, params)
    eng = ff.serve(slots=2, max_new_tokens=8, prefill_chunk=4)
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(4):
        eng.step()
    mid = [list(r.generated) for r in reqs]
    unfinished = any(not r.finished for r in reqs)
    old = eng.decode_model
    one = eng.replan_mesh(ONE, trigger="capacity")
    fresh = eng.decode_model is not old
    two = eng.replan_mesh(DP2, trigger="capacity")
    for _ in range(64):
        if all(r.finished for r in reqs):
            break
        eng.step()
    return {"mid": mid, "unfinished": unfinished, "fresh": fresh,
            "got": [list(r.generated) for r in reqs],
            "decisions": [d["decision"] for d in eng.replan_decisions],
            "last_is_two": eng.replan_decisions[-1] is two,
            "keys": sorted({"compile_s", "migrate_s", "rebuild_s"}
                           & set(one)),
            "mesh": {k: int(v)
                     for k, v in eng.decode_model.mesh.shape.items()},
            "chips": eng.num_chips}


def test_serving_replan_preserves_inflight_token_streams():
    """A decode re-plan between scheduler iterations, on 2 gloo ranks (the
    JAX test moves to 2 devices): mid-decode onto a fresh one-card decode
    model, then onto DP2 over both ranks (the slots split over `data`,
    the paged pool replicated over it); the requests keep their KV state
    (migrated, verified) and finish with exactly the tokens an
    undisturbed engine, and the JAX package's, produce."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.distributed import spawn

    prompts = [[3, 7, 11, 2, 5], [60, 1, 2]]
    j = _lm(JAX)
    want_jax = j.serve(slots=2, max_new_tokens=8,
                       prefill_chunk=4).generate(prompts)
    params = {n: {k: np.asarray(v) for k, v in ws.items()}
              for n, ws in j._params.items()}
    ff = _lm(PORT)
    load_params(ff, params)
    want = ff.serve(slots=2, max_new_tokens=8,
                    prefill_chunk=4).generate(prompts)
    assert want == want_jax

    outs = spawn(serving_replan_job, 2, params, prompts, timeout=300)
    for out in outs:
        assert out["unfinished"] and out["fresh"] and out["last_is_two"]
        assert out["decisions"] == ["migrated", "migrated"]
        assert out["keys"] == ["compile_s", "migrate_s", "rebuild_s"]
        assert out["mesh"]["data"] == 2 and out["chips"] == 2
        assert out["got"] == want
        for g, m in zip(out["got"], out["mid"]):
            assert g[:len(m)] == m


def test_migration_fidelity_ema_and_db_roundtrip(tmp_path):
    """record_fidelity in both packages: the first sample replaces the
    default, later ones fold (EMA alpha 0.5), and the ratio persists in
    the warm-start calibration DB under the device kind's reserved key,
    so a fresh model reads it back; no DB: the default."""
    for pkg in (JAX, PORT):
        from importlib import import_module

        payoff = import_module(f"{pkg}.elastic.payoff")
        wdir = str(tmp_path / pkg)
        ff = _mlp(pkg, ONE, argv=["--warmstart-dir", wdir])
        assert payoff.load_fidelity(ff) == (1.0, 0)
        assert payoff.record_fidelity(ff, 40.0) == (40.0, 1)
        r, n = payoff.record_fidelity(ff, 20.0)
        assert n == 2 and r == pytest.approx(30.0)
        ff2 = _mlp(pkg, ONE, argv=["--warmstart-dir", wdir])
        assert payoff.load_fidelity(ff2) == (pytest.approx(30.0), 2)
        assert payoff.load_fidelity(_mlp(pkg, ONE)) == (1.0, 0)
