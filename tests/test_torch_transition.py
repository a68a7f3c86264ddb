"""The port's fftrans (`flexflow_tpu_torch/analysis/transition.py`) and its
restore gate and its in-process migration against the JAX package's, on
the CPU: the twin of `tests/test_transition.py`.

- the (dp 4 stage 3) -> (dp 2 x tp 2) transition of the MLP, the port's
  on 4 gloo ranks, the JAX package's on its virtual mesh, both priced
  with one machine-model file: the same transfers (keys, collectives),
  `predicted_s` to 1e-9 relative, `predicted_s` reproduced from the JSON
  alone, and the same findings, clean and under every corruption of the
  fuzzer (dropped mapping, dtype change, stage 3 without a gather path,
  a non-bijective ring, an over-cap peak, a corrupt digest, a swapped
  order);
- synthetic sides: a same-mesh axis move is an all_to_all, a KV pool's
  block size change is kv_pool_mismatch, in both packages;
- the restore gate: a checkpoint saved at dp 4 stage 3 restores at dp 2
  x tp 2 with a clean transition on every rank; a poisoned leaf dtype is
  refused naming the leaf and the class before any tensor is written,
  and --no-verify-plan downgrades it; the strategy report of an
  auto-resumed run carries the `transition` section;
- `migrate_state` (resilience/migrate.py) on the same 4 gloo ranks, from
  the JAX model's initial weights: dp 4 stage 3 -> dp 2 x tp 2 and dp 4
  -> dp 2 x tp 2 stage 2 (the JAX test's second case goes to dp 4 x tp
  2, 8 devices) land the bits of a checkpoint-restart and keep the
  continued trajectory bit-exact, the first within 1e-5 of the JAX
  package's migrated run; an architecture mismatch is refused naming the
  leaf before a tensor moves; the report carries the `transition`
  section; `donate=True` frees each source and lands the same bits; the
  fftrans donation scan of the port's migrate.py finds nothing, and
  finds a donated reuse planted in a copy.
"""

import json
import os
import sys

import numpy as np
import pytest

DP4 = (4, 1, 1, 1)
DP2_TP2 = (2, 2, 1, 1)
ONE = (1, 1, 1, 1)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# (name, old flags, new mesh, new flags) of the migrate_state cases
MIGRATE_CASES = (
    ("stage3_dp4->off_dp2tp2", ("--weight-update-sharding=stage3",),
     DP2_TP2, ()),
    ("off_dp4->stage2_dp2tp2", (), DP2_TP2,
     ("--weight-update-sharding=stage2",)),
)
PKGS = ("flexflow_tpu", "flexflow_tpu_torch")
REL = 1e-9


def _mlp(pkg, mesh=DP4, argv=(), momentum=0.9, batch=8):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    config = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
              else mod.FFConfig())
    config.mesh_axis_sizes = mesh
    config.batch_size = batch
    ff = mod.FFModel(config)
    x = ff.create_tensor((batch, 16), name="x")
    t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05, momentum=momentum),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _trans(pkg):
    return __import__(f"{pkg}.analysis.transition", fromlist=["x"])


def _plan(pkg, old, new, machine_file):
    mm = __import__(f"{pkg}.search.machine_model", fromlist=["x"])
    T = _trans(pkg)
    return T.build_transition_plan(
        T.PlanSide.from_model(old, label="old"),
        T.PlanSide.from_model(new, label="new"),
        machine=mm.machine_model_from_file(machine_file, old.mesh),
        hbm_cap_bytes=mm.machine_model_from_file(
            machine_file, new.mesh).chip.hbm_bytes)


def _keys(result) -> list:
    return [(f.pass_name, f.severity, f.code, f.where)
            for f in result.findings]


def fuzz_cases(pkg, old, new, machine_file) -> dict:
    """Every corruption of the transition fuzzer on a fresh plan each:
    {case: the findings' (pass, severity, code, where)}; `clean` too."""
    T = _trans(pkg)
    ops = __import__(f"{pkg}.parallel.ops", fromlist=["x"])
    out = {}

    def fresh():
        return _plan(pkg, old, new, machine_file)

    out["clean"] = _keys(T.verify_transition(fresh()))
    plan = fresh()
    victim = next(t for t in plan.transfers
                  if "kernel" in t["key"] and "params" in t["key"])
    plan.transfers.remove(victim)
    plan.schedule_digest = T.schedule_digest(plan.transfers)
    out["dropped_mapping"] = _keys(T.verify_transition(plan))
    plan = fresh()
    next(t for t in plan.transfers
         if "kernel" in t["key"])["dst_dtype"] = "bfloat16"
    out["dtype_change"] = _keys(T.verify_transition(plan))
    plan = fresh()
    victim = next(t for t in plan.transfers if t["update_sharded"])
    victim["collectives"] = [c for c in victim["collectives"]
                             if c["kind"] != "all_gather"]
    plan.schedule_digest = T.schedule_digest(plan.transfers)
    out["stage3_without_gather"] = _keys(T.verify_transition(plan))
    good = ops.ring_permutation
    ops.ring_permutation = lambda n: good(n)[:-1]
    try:
        out["nonbijective_ring"] = _keys(T.verify_transition(fresh()))
    finally:
        ops.ring_permutation = good
    plan = fresh()
    plan.hbm_cap_bytes = 64.0
    out["overcap"] = _keys(T.verify_transition(plan))
    plan = fresh()
    plan.schedule_digest = "0" * 16
    out["digest"] = _keys(T.verify_transition(plan))
    plan = fresh()
    a = next(t for t in plan.transfers if "fc1" in t["key"])
    b = next(t for t in plan.transfers if "fc2" in t["key"])
    a["order"], b["order"] = b["order"], a["order"]
    plan.schedule_digest = T.schedule_digest(plan.transfers)
    out["order"] = _keys(T.verify_transition(plan))
    return out


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = {"x": rs.randn(n, 16).astype(np.float32)}
    y = rs.randint(0, 4, (n, 1)).astype(np.int32)
    return x, y


def _fit(ff, seed=0):
    x, y = _data(seed=seed)
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False)
    return ff


def _whole(ff) -> dict:
    """Every leaf of a port model's training state, whole (collective
    over its mesh), as numpy."""
    from flexflow_tpu_torch.resilience.checkpointer import (
        _keystr, tree_items)
    from flexflow_tpu_torch.resilience.reshard import (
        _weight_of, model_state_tree)

    ex, out = ff.executor, {}
    for path, t in tree_items(model_state_tree(ff)):
        w = _weight_of(ex, path, t)
        whole = ex.full_weight(*w, t) if w is not None else t
        out[_keystr(path)] = whole.detach().cpu().numpy().copy()
    return out


def _same(a: dict, b: dict) -> list:
    """The keys whose arrays differ (by bits), or are missing."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b
                  or not np.array_equal(a[k], b[k]))


def migrate_cases(tmp, init) -> dict:
    """The migrate_state cases on this rank: migrated vs restored from a
    checkpoint, before and after one more epoch each."""
    from flexflow_tpu_torch import load_params
    from flexflow_tpu_torch.resilience import migrate_state

    out = {}
    for name, old_args, new_mesh, new_args in MIGRATE_CASES:
        pkg = "flexflow_tpu_torch"
        old = _mlp(pkg, DP4, old_args)
        load_params(old, init)
        _fit(old)
        ck = os.path.join(tmp, f"mig_{name}")
        old.save_checkpoint(ck)
        ctrl = _mlp(pkg, new_mesh, new_args)
        ctrl.load_checkpoint(ck)
        mig = _mlp(pkg, new_mesh, new_args)
        section = migrate_state(old, mig)
        case = {"errors": section["analysis"]["errors"],
                "measured_s": section["measured_s"],
                "moved_bytes": section["moved_bytes"],
                "stages": (old._update_sharding.get("stage", 0),
                           mig._update_sharding.get("stage", 0)),
                "landed": _same(_whole(ctrl), _whole(mig))}
        _fit(ctrl, seed=1)
        _fit(mig, seed=1)
        case["continued"] = _same(_whole(ctrl), _whole(mig))
        case["params"] = {k: v for k, v in _whole(mig).items()
                          if k.startswith("['params']")}
        out[name] = case
    return out


def transition_job(rank, tmp, machine_file, init):
    """On 4 gloo ranks: the MLP at dp 4 stage 3 and at dp 2 x tp 2, the
    plan between them and the fuzzer over it; then a checkpoint of the
    first restored into the second through the gate; then the
    migrate_state cases."""
    pkg = "flexflow_tpu_torch"
    old = _mlp(pkg, DP4, ["--weight-update-sharding=stage3"])
    new = _mlp(pkg, DP2_TP2)
    T = _trans(pkg)
    plan = _plan(pkg, old, new, machine_file)
    res = T.verify_transition(plan)
    out = {"stage": old._update_sharding.get("stage"),
           "section": json.loads(json.dumps(plan.to_json(analysis=res))),
           "memory": res.by_code("transition_memory_timeline")[0].details,
           "fuzz": fuzz_cases(pkg, old, new, machine_file)}
    root = os.path.join(tmp, "ck")
    old.save_checkpoint(root)
    new.load_checkpoint(root)
    out["restored"] = new._transition
    out["migrate"] = migrate_cases(tmp, init)
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(the port's rank outputs, the JAX package's plan JSON and fuzzer
    findings), both priced with one machine-model file."""
    from flexflow_tpu_torch.distributed import spawn

    tmp = str(tmp_path_factory.mktemp("trans"))
    machine_file = os.path.join(tmp, "machine.json")
    with open(machine_file, "w") as f:
        json.dump({"chip": "v5p"}, f)
    old = _mlp("flexflow_tpu", DP4, ["--weight-update-sharding=stage3"])
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in old._params.items()}
    outs = spawn(transition_job, 4, tmp, machine_file, init, timeout=300)
    new = _mlp("flexflow_tpu", DP2_TP2)
    T = _trans("flexflow_tpu")
    plan = _plan("flexflow_tpu", old, new, machine_file)
    jax_side = {"section": json.loads(json.dumps(
                    plan.to_json(analysis=T.verify_transition(plan)))),
                "fuzz": fuzz_cases("flexflow_tpu", old, new, machine_file)}
    # the JAX package's migration of the first case, from the same
    # initial weights
    from flexflow_tpu.resilience import migrate_state

    import jax.tree_util as jtu

    mig = _mlp("flexflow_tpu", DP2_TP2)
    migrate_state(_fit(old), mig)
    _fit(mig, seed=1)
    jax_side["migrated"] = {
        "['params']" + jtu.keystr(p): np.asarray(v)
        for p, v in jtu.tree_flatten_with_path(mig._params)[0]}
    return outs, jax_side


def _by_key(section) -> dict:
    return {t["key"]: t for t in section["transfers"]}


def test_transfers_and_collectives_match_jax(pair):
    outs, jax_side = pair
    assert outs[0]["stage"] == 3
    port, ref = _by_key(outs[0]["section"]), _by_key(jax_side["section"])
    assert set(port) == set(ref)
    for k, t in ref.items():
        if k == "['rng']":
            continue  # a torch.Generator's state, a jax key's data
        p = port[k]
        for f in ("shape", "dtype", "dst_shape", "dst_dtype", "src_spec",
                  "dst_spec", "update_sharded", "order"):
            assert p[f] == t[f], (k, f)
        assert ([(c["kind"], c["axis"]) for c in p["collectives"]]
                == [(c["kind"], c["axis"]) for c in t["collectives"]]), k
        assert p["seconds"] == pytest.approx(t["seconds"], rel=REL), k
    # every rank derived the same program
    assert len({o["section"]["schedule_digest"] for o in outs}) == 1


def test_predicted_seconds_match_jax_and_reproduce_from_json(pair):
    from flexflow_tpu_torch.analysis.transition import (
        verify_transition_total,
    )

    outs, jax_side = pair
    section = outs[0]["section"]
    assert section["predicted_s"] > 0
    assert section["predicted_s"] == pytest.approx(
        jax_side["section"]["predicted_s"], rel=REL)
    assert verify_transition_total(section) == pytest.approx(
        section["predicted_s"], rel=REL)
    assert section["bytes_on_wire"] == pytest.approx(
        jax_side["section"]["bytes_on_wire"], rel=REL)


def test_clean_transition_findings_match_jax(pair):
    outs, jax_side = pair
    clean = outs[0]["fuzz"]["clean"]
    assert [c for _, s, c, _ in clean if s == "error"] == []
    assert ("state_mapping", "info", "transition_clean", "") in clean
    assert clean == jax_side["fuzz"]["clean"]
    d = outs[0]["memory"]
    assert d["peak_bytes"] <= d["conservative_bytes"] and d["timeline"]


@pytest.mark.parametrize("case,codes", [
    ("dropped_mapping", {"dropped_state", "unmapped_state"}),
    ("dtype_change", {"state_dtype_change"}),
    ("stage3_without_gather", {"missing_gather_path"}),
    ("nonbijective_ring", {"bad_transfer_permutation"}),
    ("overcap", {"transition_oom"}),
    ("digest", {"transfer_schedule_divergence"}),
    ("order", {"nontopological_transfer_order"}),
])
def test_fuzzer_corruption_caught_as_jax_catches_it(pair, case, codes):
    outs, jax_side = pair
    got = outs[0]["fuzz"][case]
    assert {c for _, s, c, _ in got if s == "error"} == codes
    assert got == jax_side["fuzz"][case]


def test_restore_through_the_gate_on_every_rank(pair):
    """Saved at dp 4 stage 3, restored at dp 2 x tp 2: every rank has the
    verified transition, from the checkpoint, with no error."""
    outs, _ = pair
    for o in outs:
        t = o["restored"]
        assert t is not None and t["src"]["plan_source"] == "checkpoint"
        assert t["analysis"]["errors"] == 0, t["analysis"]
        assert t["predicted_s"] > 0


# ------------------------------------------------------ synthetic sides

def _axis_move(pkg):
    T = _trans(pkg)

    def side(assignment):
        s = T.PlanSide(axis_sizes={"data": 2}, on_device=True)
        s.leaves["['params']['l']['w']"] = T.LeafInfo(
            key="['params']['l']['w']", shape=(4, 4), dtype="float32",
            assignment=assignment, topo_pos=0)
        return s

    plan = T.build_transition_plan(side((("data",), ())),
                                   side(((), ("data",))))
    return plan, T.verify_transition(plan)


def test_same_mesh_axis_move_is_not_a_missing_gather():
    (jplan, jres), (plan, res) = (_axis_move(p) for p in PKGS)
    assert [c["kind"] for c in plan.transfers[0]["collectives"]
            if c["kind"] != "slice"] == ["all_to_all"]
    assert res.ok, [str(f) for f in res.errors()]
    assert _keys(res) == _keys(jres)


def _kv_pool(pkg, src_block, dst_block):
    T = _trans(pkg)

    def side(block_size, blocks=8):
        s = T.PlanSide(axis_sizes={"data": 2}, on_device=True,
                       kv_block_size=block_size)
        s.leaves["['state']['attn']['pool_k']"] = T.LeafInfo(
            key="['state']['attn']['pool_k']",
            shape=(blocks, block_size, 16), dtype="float32",
            assignment=((), (), ()), kv_pool=True, topo_pos=0)
        return s

    return T.verify_transition(T.build_transition_plan(
        side(src_block), side(dst_block)))


@pytest.mark.parametrize("blocks", [(16, 16), (16, 8)],
                         ids=["same", "mismatch"])
def test_kv_pool_block_size(blocks):
    jres, res = (_kv_pool(p, *blocks) for p in PKGS)
    want = set() if blocks[0] == blocks[1] else {"kv_pool_mismatch"}
    assert {f.code for f in res.errors()} == want
    assert _keys(res) == _keys(jres)


# ---------------------------------------------------------- restore gate

def _poison_leaf_dtype(root):
    """Rewrite one committed checkpoint leaf as float16 (arrays.npz and
    the manifest together, so the load returns a valid fp16 array: the
    drift the gate must catch against the fp32 model)."""
    from flexflow_tpu_torch.resilience import latest_checkpoint

    ckdir = latest_checkpoint(root)
    with open(os.path.join(ckdir, "manifest.json")) as f:
        manifest = json.load(f)
    path = next(k for k in manifest["leaves"]
                if "fc1" in k and "kernel" in k)
    meta = manifest["leaves"][path]
    npz = os.path.join(ckdir, "arrays.npz")
    data = dict(np.load(npz))
    data[meta["key"]] = data[meta["key"]].astype(np.float16)
    meta["dtype"] = "float16"
    np.savez(npz, **data)
    with open(os.path.join(ckdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def _params(ff) -> dict:
    return {(n, w): t.detach().clone() for n, ws in ff._params.items()
            for w, t in ws.items()}


def test_restore_gate_names_leaf_and_class(tmp_path):
    from flexflow_tpu_torch.analysis import PlanVerificationError

    ff = _mlp("flexflow_tpu_torch", (1, 1, 1, 1))
    root = str(tmp_path / "ck")
    ff.save_checkpoint(root)
    leaf = _poison_leaf_dtype(root)
    ff2 = _mlp("flexflow_tpu_torch", (1, 1, 1, 1))
    before = _params(ff2)
    with pytest.raises(PlanVerificationError,
                       match="state_dtype_change") as ei:
        ff2.load_checkpoint(root)
    assert leaf in str(ei.value)
    after = _params(ff2)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_restore_gate_no_verify_plan_downgrades(tmp_path):
    import torch

    ff = _mlp("flexflow_tpu_torch", (1, 1, 1, 1))
    root = str(tmp_path / "ck")
    ff.save_checkpoint(root)
    _poison_leaf_dtype(root)
    ff2 = _mlp("flexflow_tpu_torch", (1, 1, 1, 1), ["--no-verify-plan"])
    ff2.load_checkpoint(root)  # restores, casting as before
    assert ff2._transition["analysis"]["errors"] >= 1
    assert ff2._params["fc1"]["kernel"].dtype == torch.float32


def test_auto_resumed_report_carries_transition(tmp_path):
    """The strategy report of a run that resumed from a checkpoint gains
    the `transition` section: the gate's verdict and a predicted_s that
    reproduces from the section alone."""
    from flexflow_tpu_torch.analysis.transition import (
        verify_transition_total,
    )

    rs = np.random.RandomState(0)
    x = {"x": rs.randn(16, 16).astype(np.float32)}
    y = rs.randint(0, 4, (16, 1)).astype(np.int32)
    ck = str(tmp_path / "ck")
    ff = _mlp("flexflow_tpu_torch", (1, 1, 1, 1),
              ["--checkpoint-dir", ck, "--checkpoint-every", "1"])
    ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False)
    tel = str(tmp_path / "tel")
    ff2 = _mlp("flexflow_tpu_torch", (1, 1, 1, 1),
               ["--checkpoint-dir", ck, "--auto-resume", "--telemetry-dir",
                tel, "--diagnostics"])
    ff2.fit(x, y, epochs=2, batch_size=8, shuffle=False, verbose=False)
    with open(os.path.join(tel, "strategy_report.json")) as f:
        t = json.load(f).get("transition")
    assert t is not None and t["transfers"]
    assert t["analysis"]["errors"] == 0
    assert verify_transition_total(t) == pytest.approx(t["predicted_s"],
                                                       rel=REL, abs=1e-15)


# ----------------------------------------------------- migrate_state


@pytest.mark.parametrize("case", [c[0] for c in MIGRATE_CASES])
def test_migrate_bit_exact_vs_checkpoint_restart(pair, case):
    """The acceptance property on every rank: the in-process migration
    lands the SAME bits as a checkpoint-restart of the same state, and
    the continued trajectory stays bit-exact, across mesh factorization
    and ZeRO stage toggles, with SGD-momentum slots in play."""
    outs, _ = pair
    want_stages = {"stage3_dp4->off_dp2tp2": (3, 0),
                   "off_dp4->stage2_dp2tp2": (0, 2)}[case]
    for o in outs:
        c = o["migrate"][case]
        assert c["errors"] == 0 and c["measured_s"] >= 0
        assert c["stages"] == want_stages
        assert c["landed"] == [] and c["continued"] == []
    # the stage-3 masters moved over the wire (gathered whole)
    if want_stages[0] == 3:
        assert all(o["migrate"][case]["moved_bytes"] > 0 for o in outs)


def test_migrated_run_matches_jax(pair):
    """dp 4 stage 3 -> dp 2 x tp 2 from the JAX model's initial weights:
    the port's migrated and continued run within 1e-5 of the JAX
    package's."""
    outs, jax_side = pair
    got = outs[0]["migrate"]["stage3_dp4->off_dp2tp2"]["params"]
    want = jax_side["migrated"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **F32_TOL, err_msg=k)


def test_migrate_refuses_architecture_mismatch():
    """A new model whose graph differs is an unverifiable mapping: the
    gate raises PlanVerificationError NAMING the leaf and class before
    any live state moves."""
    from flexflow_tpu_torch import (
        ActiMode, FFConfig, FFModel, LossType, SGDOptimizer,
    )
    from flexflow_tpu_torch.analysis import PlanVerificationError
    from flexflow_tpu_torch.resilience import migrate_state

    old = _fit(_mlp("flexflow_tpu_torch", ONE))
    sys.argv = ["test"]
    config = FFConfig(device="cpu")
    config.mesh_axis_sizes = ONE
    config.batch_size = 8
    other = FFModel(config)
    x = other.create_tensor((8, 16), name="x")
    t = other.dense(x, 48, ActiMode.AC_MODE_RELU, name="fc1")  # 48 != 32
    t = other.dense(t, 4, name="fc2")
    other.softmax(t, name="sm")
    other.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    before = _params(other)
    with pytest.raises(PlanVerificationError,
                       match="state_shape_change.*fc1"):
        migrate_state(old, other)
    after = _params(other)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_migrate_report_carries_transition_section(tmp_path):
    """strategy_report.json gains the `transition` section after a
    migration: the identity reproduces, no error, measured seconds."""
    from flexflow_tpu_torch.analysis.transition import (
        verify_transition_total,
    )
    from flexflow_tpu_torch.resilience import migrate_state

    old = _fit(_mlp("flexflow_tpu_torch", ONE))
    new = _mlp("flexflow_tpu_torch", ONE)
    new.enable_telemetry(str(tmp_path / "tel"))
    new.enable_diagnostics()
    migrate_state(old, new)
    with open(tmp_path / "tel" / "strategy_report.json") as f:
        t = json.load(f).get("transition")
    assert t is not None and t["transfers"]
    assert t["analysis"]["errors"] == 0
    assert verify_transition_total(t) == pytest.approx(t["predicted_s"],
                                                       rel=REL, abs=1e-15)
    assert t.get("measured_s") is not None


def test_migrate_donate_frees_sources_and_lands_the_same_bits():
    """donate=True: each source tensor's storage is released once its
    transfer is queued, the old model is no longer compiled, and the new
    model holds the bits of a migration without donation."""
    from flexflow_tpu_torch.resilience import migrate_state

    pkg = "flexflow_tpu_torch"
    old = _fit(_mlp(pkg, ONE))
    keep = _mlp(pkg, ONE)
    migrate_state(old, keep)
    want = _whole(keep)
    given = _mlp(pkg, ONE)
    sources = [t for ws in old._params.values() for t in ws.values()]
    migrate_state(old, given, donate=True)
    assert _same(want, _whole(given)) == []
    assert all(t.untyped_storage().nbytes() == 0 for t in sources)
    assert old._compiled is False


def test_migrate_source_scan_finds_a_planted_donated_reuse(tmp_path,
                                                           monkeypatch):
    """The fftrans migration_donation pass lints the port's
    resilience/migrate.py: clean; a copy with a donated reuse planted
    (an alias of a held argument read after the replay) is found."""
    import shutil

    from flexflow_tpu_torch.analysis import sources
    from flexflow_tpu_torch.analysis import transition as T

    monkeypatch.setattr(T, "_migrate_scan_cache", None)
    assert T._migrate_source_findings() == []
    root = tmp_path / "pkg"
    (root / "resilience").mkdir(parents=True)
    src = os.path.join(sources.package_root(), "resilience", "migrate.py")
    shutil.copy(src, root / "resilience" / "migrate.py")
    with open(root / "resilience" / "migrate.py", "a") as f:
        f.write(
            "\n\ndef _planted(new, batch):\n"
            "    before = new._params\n"
            "    new.executor._train_step(new._params, new._state,\n"
            "                             new._opt_slots, new._step,\n"
            "                             new._counters, batch, new._rng)\n"
            "    return before\n")
    monkeypatch.setattr(sources, "package_root", lambda: str(root))
    monkeypatch.setattr(T, "_migrate_scan_cache", None)
    found = T._migrate_source_findings()
    assert [f.code for f in found] == ["donated_reuse"]
    assert "new._params" in found[0].message
    monkeypatch.setattr(T, "_migrate_scan_cache", None)
