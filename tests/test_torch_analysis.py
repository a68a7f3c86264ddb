"""The port's ffcheck compile gate and fflint (`flexflow_tpu_torch/
analysis/`) against the JAX package's, on the CPU: the twin of
`tests/test_analysis.py` and of the lattice and barrier half of
`tests/test_numerics.py`.

- the findings, as (pass, severity, code, where), equal the JAX
  package's on the same graph, mesh and strategy: the tiny LM and the MLP
  at (1, 1, 1, 1), dp 4 and dp 2 x tp 2, a ring at seq 2, stages 2 and 3
  (compiled on 4 gloo ranks, where the executor's update specs need a
  real mesh) and every corruption of the fuzzer (axis reuse, a dropped
  parallel op, an oversharded dim, a non-bijective ring, out-of-order
  update buckets, a predicted OOM); the passes read only the mesh's axis
  sizes, so the other cases place the port's graph on a mesh of absent
  ranks;
- the memory pass's JAX terms equal the JAX package's to the byte; the
  port's own buffers (bf16 weight copies, the serving weight cache, a
  CUDA graph's static inputs) are checked by name;
- the compile gate: it runs on every compile before any weight is
  allocated, refuses a predicted OOM (--no-verify-plan launches anyway),
  emits plan_verify and weight_update_decision, rides the report;
  Strategy.validate gives JAX's texts, a poisoned plan-cache entry reads
  as a miss;
- the dtype lattice's findings equal JAX's; a warm numerics pass on the
  tiny LM stays under JAX's 5 ms;
- the SPMD fingerprint barrier simulated in one process, and on 2 gloo
  ranks in lockstep and aborting every rank on a planted mismatch;
- each fflint rule fires on its torch-idiom snippet and stays quiet on
  the fixed form; the port's tree lints clean; the donation registry
  (the executor's held positions) is re-derived from executor.py.
"""

import json
import os
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKGS = ("flexflow_tpu", "flexflow_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model", "pipe", "seq")


def _config(pkg, argv=(), mesh=None):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.batch_size = 4
    if mesh is not None:
        cfg.mesh_axis_sizes = tuple(mesh)
    return cfg


def _lm(pkg, argv=(), mesh=None, ring=False, layers=1, heads=4):
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    ff = mod.FFModel(_config(pkg, argv, mesh))
    models.build_transformer_lm(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=32, num_heads=heads, num_layers=layers,
        sequence_length=16, attention_impl="ring" if ring else "xla"),
        batch_size=4)
    return ff


def _mlp(pkg, argv=(), mesh=None):
    mod = __import__(pkg)
    ff = mod.FFModel(_config(pkg, argv, mesh))
    x = ff.create_tensor((4, 16), name="x")
    t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 32, mod.ActiMode.AC_MODE_RELU, name="fc2")
    t = ff.dense(t, 8, name="fc3")
    ff.softmax(t, name="sm")
    return ff


def _compile(ff, pkg, momentum=0.0):
    mod = __import__(pkg)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.01, momentum=momentum),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _pspec(pkg):
    if pkg == "flexflow_tpu":
        from jax.sharding import PartitionSpec
    else:
        from flexflow_tpu_torch.tensor import PartitionSpec
    return PartitionSpec


def _mlp_tp(pkg, ff):
    """fc1 column-parallel, fc2 row-parallel (the Megatron pair)."""
    S = __import__(f"{pkg}.parallel.strategies", fromlist=["x"]).Strategy
    P = _pspec(pkg)
    s = S()
    s.set_output("fc1", 0, (("data",), ("model",)))
    s.set_weight("fc1", "kernel", P(None, "model"))
    s.set_weight("fc1", "bias", P("model"))
    s.set_output("fc2", 0, (("data",), ()))
    s.set_weight("fc2", "kernel", P("model", None))
    return s


def _strategy(pkg, name, ff):
    strategies = __import__(f"{pkg}.parallel.strategies", fromlist=["x"])
    if name == "megatron":
        return strategies.megatron_transformer(ff)
    if name == "seq":
        return strategies.sequence_parallel_attention(ff)
    if name == "mlp_tp":
        return _mlp_tp(pkg, ff)
    return None


def _place(ff, mesh, strategy=None):
    """The port's compiled (one-device) graph placed on `mesh`: a Mesh of
    absent ranks (the passes read only its axis sizes)."""
    import torch

    from flexflow_tpu_torch.machine import Mesh, MeshShape

    ff.mesh = Mesh(MeshShape(tuple(mesh), AXES), torch.device("cpu"))
    ff._strategy = getattr(strategy, "overrides", strategy)
    ff._assign_strategy()
    return ff


def _analyze(ff, pkg):
    A = __import__(f"{pkg}.analysis", fromlist=["x"])
    return A.run_analysis(ff.graph, ff.mesh, A.context_for_model(ff))


def _keys(result) -> list:
    return [(f.pass_name, f.severity, f.code, f.where)
            for f in result.findings]


def _build(pkg, model, mesh, plan, argv=()):
    """(model on `mesh` under `plan`): the JAX package's compiled on its
    virtual mesh, the port's compiled on one device and placed."""
    make = {"lm": _lm, "mlp": _mlp, "ring": lambda p, a, m: _lm(
        p, a, m, ring=True)}[model]
    if pkg == "flexflow_tpu":
        argv = list(argv) + (["--no-weight-update-sharding"]
                             if np.prod(mesh) > 1 else [])
        ff = make(pkg, argv, mesh)
        s = _strategy(pkg, plan, ff)
        if s is not None:
            ff.set_strategy(s)
        return _compile(ff, pkg)
    ff = _compile(make(pkg, argv, (1, 1, 1, 1)), pkg)
    return _place(ff, mesh, _strategy(pkg, plan, ff))


CASES = {
    "lm_1": ("lm", (1, 1, 1, 1), None),
    "lm_dp4": ("lm", (4, 1, 1, 1), None),
    "lm_dp2_tp2": ("lm", (2, 2, 1, 1), "megatron"),
    "mlp_1": ("mlp", (1, 1, 1, 1), None),
    "mlp_dp4": ("mlp", (4, 1, 1, 1), None),
    "mlp_dp2_tp2": ("mlp", (2, 2, 1, 1), "mlp_tp"),
    "ring_seq2": ("ring", (2, 1, 1, 2), "seq"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_jax(case):
    model, mesh, plan = CASES[case]
    j, t = (_build(p, model, mesh, plan) for p in PKGS)
    jres, tres = _analyze(j, "flexflow_tpu"), _analyze(t, "flexflow_tpu_torch")
    assert _keys(tres) == _keys(jres)
    assert tres.ok, [str(f) for f in tres.errors()]
    assert tres.passes_run == [
        "sharding_dataflow", "memory_liveness", "collective_uniformity",
        "donation_aliasing", "dtype_flow", "spmd_uniformity",
        "rule_verify"]


_MEM_TERMS = ("persistent_bytes", "weight_bytes", "activation_bytes",
              "peak_bytes", "peak_at", "gather_peak_bytes", "timeline")


def _memory(ff, pkg, **kw):
    M = __import__(f"{pkg}.analysis.memory", fromlist=["x"])
    return M.analyze(ff.graph, ff.mesh, **kw)


@pytest.mark.parametrize("case", ["lm_dp4", "lm_dp2_tp2", "mlp_dp2_tp2",
                                  "ring_seq2"])
@pytest.mark.parametrize("training", [True, False],
                         ids=["train", "infer"])
def test_memory_terms_match_jax_to_the_byte(case, training):
    model, mesh, plan = CASES[case]
    j, t = (_build(p, model, mesh, plan) for p in PKGS)
    jm = _memory(j, "flexflow_tpu", opt_slots=1, training=training)
    tm = _memory(t, "flexflow_tpu_torch", opt_slots=1, training=training)
    for k in _MEM_TERMS:
        assert tm[k] == jm[k], k


def test_port_memory_terms_by_name():
    """The port's extra buffers: a bf16 step's compute copy of every
    trainable master (2 bytes an element), the serving cache of an
    inference compile, a captured step's static inputs on CUDA only."""
    from flexflow_tpu_torch.analysis.memory import port_terms
    from flexflow_tpu_torch.fftype import DataType

    ff = _build("flexflow_tpu_torch", "mlp", (2, 2, 1, 1), "mlp_tp")
    bf16 = DataType.DT_BFLOAT16
    # fc1 kernel/bias split over model (2), fc2 kernel split, fc3 whole
    elems = (16 * 32 // 2 + 32 // 2) + (32 * 32 // 2 + 32) + (32 * 8 + 8)
    assert port_terms(ff.graph, ff.mesh, compute_dtype=bf16) == {
        "bf16_weight_copies": 2.0 * elems, "serving_weight_cache": 0.0,
        "graph_static_inputs": 0.0}
    assert port_terms(ff.graph, ff.mesh, training=False,
                      compute_dtype=bf16)["serving_weight_cache"] == (
                          2.0 * elems)
    assert port_terms(ff.graph, ff.mesh)["bf16_weight_copies"] == 0.0
    # the batch input x (4, 16) over data (2), f32
    assert port_terms(ff.graph, ff.mesh, device_type="cuda")[
        "graph_static_inputs"] == 2 * 16 * 4.0
    res = _analyze(ff, "flexflow_tpu_torch")
    d = res.by_code("memory_timeline")[0].details
    assert d["port_peak_bytes"] == d["peak_bytes"] + sum(
        d["port_terms"].values())


def test_memory_inference_accounting():
    from flexflow_tpu_torch.analysis.memory import analyze

    ff = _build("flexflow_tpu_torch", "lm", (2, 2, 1, 1), "megatron")
    train = analyze(ff.graph, ff.mesh, opt_slots=2, training=True)
    infer = analyze(ff.graph, ff.mesh, opt_slots=2, training=False)
    assert infer["persistent_bytes"] < train["persistent_bytes"]
    assert infer["peak_bytes"] < train["peak_bytes"]
    assert all(t["phase"] == "fwd" for t in infer["timeline"])


# ---------------------------------------- stages 2 and 3 on gloo ranks

def stage_job(rank, stage):
    """The tiny LM and the MLP at dp 4 under the forced update stage, on
    4 gloo ranks: the compile gate's findings and the memory terms."""
    from flexflow_tpu_torch.analysis.memory import analyze

    out = {}
    for model in ("lm", "mlp"):
        make = _lm if model == "lm" else _mlp
        ff = _compile(make("flexflow_tpu_torch",
                           [f"--weight-update-sharding=stage{stage}"],
                           (4, 1, 1, 1)), "flexflow_tpu_torch",
                      momentum=0.9)
        ex = ff.executor
        out[model] = {
            "stage": ex.update_stage,
            "specs": sorted(f"{n}/{w}" for n, w in ex.update_specs),
            "findings": _keys(ff._analysis),
            "memory": analyze(ff.graph, ff.mesh, opt_slots=1,
                              update_specs=ex.update_specs,
                              update_stage=ex.update_stage)}
    return out


@pytest.fixture(scope="module")
def stages():
    from flexflow_tpu_torch.distributed import spawn

    return {s: spawn(stage_job, 4, s, timeout=300) for s in (2, 3)}


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("model", ["lm", "mlp"])
def test_update_stage_findings_and_memory_match_jax(stages, stage, model):
    from flexflow_tpu.analysis import context_for_model, run_analysis
    from flexflow_tpu.analysis.memory import analyze

    make = _lm if model == "lm" else _mlp
    j = _compile(make("flexflow_tpu", [f"--weight-update-sharding=stage{stage}"],
                      (4, 1, 1, 1)), "flexflow_tpu", momentum=0.9)
    ex = j.executor
    outs = stages[stage]
    got = outs[0][model]
    assert got["stage"] == ex.update_stage == stage
    assert got["specs"] == sorted(f"{n}/{w}" for n, w in ex.update_specs)
    assert got["findings"] == _keys(run_analysis(
        j.graph, j.mesh, context_for_model(j)))
    jm = analyze(j.graph, j.mesh, opt_slots=1,
                 update_specs=ex.update_specs,
                 update_stage=ex.update_stage)
    for k in _MEM_TERMS:
        assert got["memory"][k] == jm[k], k
    for o in outs[1:]:
        assert o[model]["findings"] == got["findings"]


def test_update_sharding_shrinks_the_persistent_term(stages):
    from flexflow_tpu_torch.analysis.memory import analyze

    rep = _build("flexflow_tpu_torch", "lm", (4, 1, 1, 1), None)
    m_rep = analyze(rep.graph, rep.mesh, opt_slots=1)
    assert stages[2][0]["lm"]["memory"]["persistent_bytes"] \
        < m_rep["persistent_bytes"]
    assert stages[3][0]["lm"]["memory"]["persistent_bytes"] \
        < stages[2][0]["lm"]["memory"]["persistent_bytes"]


# ======================================================= the fuzzer


@pytest.fixture(scope="module")
def fuzz_models():
    """The tiny LM under Megatron on (2, 4) in both packages (mutations
    always restore what they touch)."""
    return {p: _build(p, "lm", (2, 4, 1, 1), "megatron") for p in PKGS}


def _mutate(ff, pkg, pred, new_assign):
    node = next(n for n in ff.graph.topo_order() if pred(n))
    pt = node.outputs[0]
    saved = pt.axis_assignment
    pt.axis_assignment = new_assign(pt)
    try:
        return _analyze(ff, pkg)
    finally:
        pt.axis_assignment = saved


def _layout_preserving(pkg):
    return __import__(f"{pkg}.analysis.sharding",
                      fromlist=["x"])._LAYOUT_PRESERVING


MUTATIONS = {
    "axis_reuse": (
        lambda pkg: lambda n: n.outputs and len(n.outputs[0].shape.dims) >= 2,
        lambda pt: (("data",), ("data",))
        + tuple(() for _ in pt.shape.dims[2:])),
    "dropped_parallel_op": (
        lambda pkg: lambda n: (n.op_type in _layout_preserving(pkg)
                               and n.inputs and any(
                                   a for a in n.inputs[0].axis_assignment)),
        lambda pt: tuple(() for _ in pt.shape.dims)),
    "overshard": (
        lambda pkg: lambda n: (n.outputs and not n.outputs[0].shape.dims[
            0].is_replica_dim and n.outputs[0].shape.dims[0].size < 8),
        lambda pt: (("data", "model"),) + tuple(
            () for _ in pt.shape.dims[1:])),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_fuzzer_mutation_findings_match_jax(fuzz_models, case):
    pred, assign = MUTATIONS[case]
    got = {p: _mutate(fuzz_models[p], p, pred(p), assign) for p in PKGS}
    assert _keys(got["flexflow_tpu_torch"]) == _keys(got["flexflow_tpu"])
    codes = {f.code for f in got["flexflow_tpu_torch"].findings}
    want = {"axis_reuse": "axis_reuse", "overshard": "overshard",
            "dropped_parallel_op": "implicit_reshard"}[case]
    assert want in codes


def test_fuzzer_clean_baseline_matches_jax(fuzz_models):
    got = {p: _analyze(fuzz_models[p], p) for p in PKGS}
    assert got["flexflow_tpu_torch"].ok
    assert _keys(got["flexflow_tpu_torch"]) == _keys(got["flexflow_tpu"])


def test_fuzzer_bad_permutation_matches_jax(monkeypatch):
    """Corrupting the ONE shared ring-schedule builder is caught for a
    plan that runs a ring, in both packages alike."""
    res = {}
    for p in PKGS:
        ff = _build(p, "ring", (2, 1, 1, 2), "seq")
        clean = _analyze(ff, p)
        assert clean.ok
        ops = __import__(f"{p}.parallel.ops", fromlist=["x"])
        good = ops.ring_permutation
        monkeypatch.setattr(ops, "ring_permutation",
                            lambda n, good=good: good(n)[:-1])
        res[p] = _analyze(ff, p)
    assert [f.code for f in res["flexflow_tpu_torch"].errors()] == [
        "bad_permutation"]
    assert _keys(res["flexflow_tpu_torch"]) == _keys(res["flexflow_tpu"])


def test_fuzzer_bucket_order_matches_jax(fuzz_models):
    order = [n.name for n in fuzz_models["flexflow_tpu"].graph.topo_order()
             if n.weight_specs]
    got = {}
    for p in PKGS:
        C = __import__(f"{p}.analysis.collectives", fromlist=["x"])
        P = _pspec(p)
        for tag, seq in (("bad", (order[-1], order[0])),
                         ("ok", (order[0], order[-1]))):
            class Ctx:
                update_specs = {(n, "kernel"): (P("data"), (32, 32))
                                for n in seq}
            got[(p, tag)] = [(f.severity, f.code, f.where) for f in C.run(
                fuzz_models[p].graph, fuzz_models[p].mesh, Ctx())]
    for tag in ("bad", "ok"):
        assert got[("flexflow_tpu_torch", tag)] == got[("flexflow_tpu", tag)]
    assert "nondeterministic_bucket_order" in {
        c for _, c, _ in got[("flexflow_tpu_torch", "bad")]}


def test_permutation_and_assignment_checks_match_jax():
    out = {}
    for p in PKGS:
        C = __import__(f"{p}.analysis.collectives", fromlist=["x"])
        S = __import__(f"{p}.analysis.sharding", fromlist=["x"])
        ring = __import__(f"{p}.parallel.ops", fromlist=["x"]).ring_permutation
        axes = {"data": 2, "model": 4}
        out[p] = [
            [f.code for f in C.check_permutation(ring(4), 4)],
            [f.code for f in C.check_permutation(ring(4)[:-1], 4)],
            [f.code for f in C.check_permutation(
                [(0, 1), (1, 1), (2, 0), (3, 2)], 4)],
            [f.code for f in S.assignment_problems(
                (("data",), ("data",)), (8, 8), axes, "t")],
            [f.code for f in S.assignment_problems(
                (("model",), ()), (6, 8), axes, "t")],
            [f.code for f in S.assignment_problems(
                (("data", "model"), ()), (2, 8), axes, "t")],
            [f.code for f in S.assignment_problems(
                (("ghost",),), (8,), axes, "t")],
        ]
    assert out["flexflow_tpu_torch"] == out["flexflow_tpu"]
    assert out["flexflow_tpu_torch"][1] == ["bad_permutation"]


def test_validate_rejects_axis_reuse_with_jax_text(fuzz_models):
    msgs = {}
    for p in PKGS:
        S = __import__(f"{p}.parallel.strategies", fromlist=["x"]).Strategy
        ff = fuzz_models[p]
        node = next(n for n in ff.graph.topo_order()
                    if n.outputs and len(n.outputs[0].shape.dims) >= 2)
        nd = len(node.outputs[0].shape.dims)
        bad = S()
        bad.set_output(node.name, 0,
                       (("data",), ("data",)) + ((),) * (nd - 2))
        bad.set_weight("no_such_node", "kernel", _pspec(p)("model"))
        with pytest.raises(ValueError, match="axis_reuse") as ei:
            bad.validate(ff.graph, ff.mesh)
        msgs[p] = str(ei.value)
    assert msgs["flexflow_tpu_torch"] == msgs["flexflow_tpu"]


def test_strategy_json_precheck_and_poisoned_cache_entry(tmp_path):
    from flexflow_tpu_torch.analysis.sharding import strategy_json_problems
    from flexflow_tpu_torch.warmstart.plan_cache import PlanCache

    clean = {"nodes": {"l": {"outputs": {"0": [["data"], []]},
                             "weights": {}}}}
    assert strategy_json_problems(clean) == []
    poisoned = {"nodes": {"l": {"outputs": {"0": [["data"], ["data"]]},
                                "weights": {"kernel": ["model", "model"]}}}}
    assert [f.code for f in strategy_json_problems(poisoned)] == [
        "axis_reuse", "axis_reuse"]
    cache = PlanCache(str(tmp_path))
    assert cache.store("f" * 64, {"version": 1, **poisoned},
                       {"data": 2}) is not None
    assert cache.lookup("f" * 64) is None


# ======================================================= the compile gate


def test_gate_runs_before_any_weight_is_allocated(monkeypatch):
    from flexflow_tpu_torch.executor import Executor

    seen = []
    orig = Executor.init_variables

    def spy(self, seed):
        seen.append(ff._analysis)
        return orig(self, seed)

    monkeypatch.setattr(Executor, "init_variables", spy)
    ff = _mlp("flexflow_tpu_torch")
    _compile(ff, "flexflow_tpu_torch")
    assert seen and seen[0] is ff._analysis and ff._analysis.ok


def test_memory_oom_gate_and_escape_hatch():
    from flexflow_tpu_torch.analysis import PlanVerificationError

    ff = _lm("flexflow_tpu_torch", ["-ll:fsize", "0.001"])
    with pytest.raises(PlanVerificationError) as e:
        _compile(ff, "flexflow_tpu_torch")
    assert "oom_predicted" in [f.code for f in e.value.result.errors()]
    assert ff._params is None  # nothing allocated
    ff = _compile(_lm("flexflow_tpu_torch", ["-ll:fsize", "0.001",
                                             "--no-verify-plan"]),
                  "flexflow_tpu_torch")
    assert ff._compiled
    assert "oom_predicted" in [f.code for f in ff._analysis.errors()]
    j = _compile(_lm("flexflow_tpu", ["-ll:fsize", "0.001",
                                      "--no-verify-plan"]), "flexflow_tpu")
    assert _keys(ff._analysis) == _keys(j._analysis)


def test_clean_plan_sources_on_one_device(tmp_path):
    """default, manual, import and checkpoint (the searched and cached
    sources: tests/test_torch_warmstart.py, 2 gloo ranks) each compile
    through the gate with zero errors."""
    from flexflow_tpu_torch.parallel.strategies import Strategy

    seen = {}
    ff = _compile(_mlp("flexflow_tpu_torch"), "flexflow_tpu_torch")
    seen[ff._plan_source] = ff._analysis
    ff = _mlp("flexflow_tpu_torch")
    ff.set_strategy(Strategy())
    _compile(ff, "flexflow_tpu_torch")
    seen[ff._plan_source] = ff._analysis
    plan = str(tmp_path / "plan.json")
    Strategy().save(plan)
    ff = _compile(_mlp("flexflow_tpu_torch", ["--import-strategy", plan]),
                  "flexflow_tpu_torch")
    seen[ff._plan_source] = ff._analysis
    assert sorted(seen) == ["default", "import", "manual"]
    for src, res in seen.items():
        assert res is not None and res.ok, (src, res.render())


def test_report_and_telemetry_carry_the_verdict(tmp_path):
    from flexflow_tpu_torch.telemetry import deactivate, read_jsonl

    tdir = str(tmp_path / "tel")
    ff = _compile(_mlp("flexflow_tpu_torch", ["--telemetry-dir", tdir,
                                              "--diagnostics"]),
                  "flexflow_tpu_torch")
    deactivate()
    with open(os.path.join(tdir, "strategy_report.json")) as f:
        a = json.load(f)["analysis"]
    assert a["errors"] == 0 and a["passes_run"] == ff._analysis.passes_run
    assert any(f["code"] == "memory_timeline" for f in a["findings"])
    recs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
    pv = [r for r in recs if r.get("kind") == "plan_verify"]
    assert pv and pv[0]["errors"] == 0 and pv[0]["plan_source"] == "default"
    wu = [r for r in recs if r.get("kind") == "weight_update_decision"]
    assert wu and wu[0]["enabled"] is False and wu[0]["stage"] == 0
    assert {"shards", "reason"} <= set(wu[0])


# ===================================================== the dtype lattice


def _chain(pkg, *nodes):
    pcg = __import__(f"{pkg}.pcg.graph", fromlist=["x"])
    tensor = __import__(f"{pkg}.tensor", fromlist=["x"])
    g = pcg.Graph()
    prev = None
    for op_type, params, name, shape, dtype in nodes:
        node = g.add_node(pcg.OpNode(op_type, params, name=name))
        node.outputs = [tensor.ParallelTensor(
            tensor.ParallelTensorShape.from_shape(shape, dtype))]
        if prev is not None:
            node.inputs = [prev.outputs[0]]
            g.add_edge(prev, node)
        prev = node
    return g


def _lattice_graph(pkg, case):
    ft = __import__(f"{pkg}.fftype", fromlist=["x"])
    ops = __import__(f"{pkg}.ops", fromlist=["x"])
    par = __import__(f"{pkg}.parallel.ops", fromlist=["x"])
    OT, DT = ft.OperatorType, ft.DataType
    bf, f32 = DT.DT_BFLOAT16, DT.DT_FLOAT
    inp = (OT.OP_INPUT, None, "x")
    return {
        "parallel_dtype_mismatch": lambda: _chain(
            pkg, (*inp, (8, 8), bf),
            (OT.OP_COMBINE, par.CombineParams(0, 2), "combine", (8, 8),
             f32)),
        "big_reduce": lambda: _chain(
            pkg, (*inp, (64, 1024), bf),
            (OT.OP_REDUCE_SUM, ops.ReduceParams(OT.OP_REDUCE_SUM, (0, 1)),
             "big_sum", (1,), bf)),
        "small_reduce": lambda: _chain(
            pkg, (*inp, (4, 4), bf),
            (OT.OP_REDUCE_SUM, ops.ReduceParams(OT.OP_REDUCE_SUM, (0, 1)),
             "small_sum", (1,), bf)),
        "f32_reduce": lambda: _chain(
            pkg, (*inp, (64, 1024), f32),
            (OT.OP_REDUCE_SUM, ops.ReduceParams(OT.OP_REDUCE_SUM, (0, 1)),
             "f32_sum", (1,), f32)),
        "wide_psum": lambda: _chain(
            pkg, (*inp, (8, 8), bf),
            (OT.OP_REDUCTION, par.ReductionParams(64), "wide_psum", (8, 8),
             bf)),
        "narrow_psum": lambda: _chain(
            pkg, (*inp, (8, 8), bf),
            (OT.OP_REDUCTION, par.ReductionParams(4), "narrow_psum", (8, 8),
             bf)),
        "roundtrip": lambda: _chain(
            pkg, (*inp, (8, 8), f32),
            (OT.OP_CAST, ops.CastParams(bf), "down", (8, 8), bf),
            (OT.OP_RESHAPE, ops.ReshapeParams((64,)), "view", (64,), bf),
            (OT.OP_CAST, ops.CastParams(f32), "up", (64,), f32)),
        "clean": lambda: _chain(
            pkg, (*inp, (8, 8), f32),
            (OT.OP_RELU, None, "act", (8, 8), f32)),
    }[case]()


@pytest.mark.parametrize("case", [
    "parallel_dtype_mismatch", "big_reduce", "small_reduce", "f32_reduce",
    "wide_psum", "narrow_psum", "roundtrip", "clean"])
def test_lattice_findings_match_jax(case):
    from flexflow_tpu_torch.machine import Mesh, MeshShape

    got = {}
    for p in PKGS:
        N = __import__(f"{p}.analysis.numerics", fromlist=["x"])
        mesh = Mesh(MeshShape((2, 4, 1, 1), AXES), "cpu")
        got[p] = [(f.severity, f.code, f.where, f.details)
                  for f in N.run(_lattice_graph(p, case), mesh, None)
                  if f.code != "numerics_clean"]
        got[p + "_codes"] = [f.code for f in N.run(
            _lattice_graph(p, case), mesh, None)]
    assert got["flexflow_tpu_torch"] == got["flexflow_tpu"]
    assert got["flexflow_tpu_torch_codes"] == got["flexflow_tpu_codes"]
    expect = {"parallel_dtype_mismatch": "parallel_dtype_mismatch",
              "big_reduce": "low_precision_accum",
              "wide_psum": "low_precision_accum",
              "roundtrip": "downcast_roundtrip"}.get(case, "numerics_clean")
    assert expect in got["flexflow_tpu_torch_codes"]


@pytest.mark.parametrize("training,weight_dtype", [
    (True, "DT_BFLOAT16"), (False, "DT_BFLOAT16"), (True, "DT_FLOAT")])
def test_lattice_master_bypass_and_grad_reduce_scatter(training,
                                                       weight_dtype):
    got = {}
    for p in PKGS:
        A = __import__(f"{p}.analysis", fromlist=["x"])
        ft = __import__(f"{p}.fftype", fromlist=["x"])
        base = __import__(f"{p}.ops.base", fromlist=["x"])
        pcg = __import__(f"{p}.pcg.graph", fromlist=["x"])
        tensor = __import__(f"{p}.tensor", fromlist=["x"])
        DT = ft.DataType
        g = pcg.Graph()
        node = g.add_node(pcg.OpNode(ft.OperatorType.OP_LINEAR, None,
                                     name="fc"))
        node.outputs = [tensor.ParallelTensor(
            tensor.ParallelTensorShape.from_shape((8, 8), DT.DT_FLOAT))]
        node.weight_specs = [base.WeightSpec(
            "kernel", (8, 8), getattr(DT, weight_dtype))]
        cfg = _config(p)
        cfg.computation_dtype = DT.DT_BFLOAT16
        ctx = A.AnalysisContext(config=cfg, training=training, update_specs={
            ("fc", "kernel"): (_pspec(p)("data"), (8, 8))})
        got[p] = [(f.severity, f.code, f.where)
                  for f in A.numerics.run(g, {"data": 2}, ctx)]
    assert got["flexflow_tpu_torch"] == got["flexflow_tpu"]


def test_clean_sweep_bf16_lm_and_warm_budget():
    """The bf16 LM's ffsan findings are all info, and a warm dtype-flow
    pass stays under JAX's 5 ms compile budget."""
    import math
    import time

    from flexflow_tpu_torch.analysis import context_for_model, numerics

    ff = _lm("flexflow_tpu_torch", ["--bfloat16"])
    _compile(ff, "flexflow_tpu_torch")
    ffsan = [f for f in ff._analysis.findings
             if f.pass_name in ("dtype_flow", "spmd_uniformity")]
    assert ffsan and all(f.severity == "info" for f in ffsan)
    ctx = context_for_model(ff)
    numerics.run(ff.graph, ff.mesh, ctx)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        numerics.run(ff.graph, ff.mesh, ctx)
        best = min(best, time.perf_counter() - t0)
    assert best < 0.005, f"dtype_flow warm pass took {best * 1e3:.2f} ms"


# ================================================= the SPMD barrier


@pytest.fixture(scope="module")
def bf16_lm():
    return _compile(_lm("flexflow_tpu_torch", ["--bfloat16"]),
                    "flexflow_tpu_torch")


def test_fingerprint_barrier_simulated(bf16_lm):
    from flexflow_tpu_torch.analysis import spmd

    ff = bf16_lm
    assert spmd.fingerprint_barrier(ff)["status"] == "single_process"
    v = spmd.fingerprint_barrier(ff, broadcast=lambda p: p)
    assert v == {"status": "ok", "fingerprint": spmd.step_fingerprint(ff)}
    with pytest.raises(spmd.SPMDDivergenceError) as ei:
        spmd.fingerprint_barrier(ff, broadcast=lambda p: {
            "fingerprint": "divergent",
            "payload": dict(spmd.fingerprint_payload(ff),
                            numerics="divergent")})
    assert "numerics" in str(ei.value)
    with pytest.raises(spmd.SPMDDivergenceError) as ei:
        spmd.fingerprint_barrier(ff, broadcast=lambda p: p,
                                 gather=lambda m: [m, False])
    assert ei.value.peer_mismatch


def test_fingerprint_tracks_numerics_runtime_and_kernels(bf16_lm):
    from flexflow_tpu_torch.analysis import spmd

    ff = bf16_lm
    payload = spmd.fingerprint_payload(ff)
    assert {"runtime", "kernels", "donation", "numerics"} <= set(payload)
    fp = spmd.step_fingerprint(ff)
    assert fp == spmd.step_fingerprint(ff)
    ff.config.sanitize_numerics = not ff.config.sanitize_numerics
    try:
        assert spmd.step_fingerprint(ff) != fp
    finally:
        ff.config.sanitize_numerics = not ff.config.sanitize_numerics


def barrier_job(rank, plant):
    """The MLP at dp 2 with --spmd-barrier on 2 gloo ranks; with `plant`
    rank 1 runs another numerics policy (no tensor-op math)."""
    from flexflow_tpu_torch.analysis.spmd import SPMDDivergenceError

    ff = _mlp("flexflow_tpu_torch", ["--spmd-barrier"], (2, 1, 1, 1))
    if plant and rank == 1:
        ff.config.allow_tensor_op_math_conversion = False
    try:
        _compile(ff, "flexflow_tpu_torch")
    except SPMDDivergenceError as e:
        return {"raised": True, "peer": e.peer_mismatch,
                "params": ff._params is None}
    return {"raised": False, "barrier": ff._spmd_barrier}


@pytest.mark.parametrize("plant", [False, True], ids=["lockstep",
                                                      "planted"])
def test_fingerprint_barrier_on_two_ranks(plant):
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(barrier_job, 2, plant, timeout=120)
    if not plant:
        assert [o["barrier"]["status"] for o in outs] == ["ok", "ok"]
        assert outs[0]["barrier"]["fingerprint"] == \
            outs[1]["barrier"]["fingerprint"]
    else:
        assert all(o["raised"] and o["params"] for o in outs)
        # rank 1 diverged from rank 0; rank 0 aborts in lockstep with it
        assert [o["peer"] for o in outs] == [True, False]


# ============================================================== lint

LINT = {
    "host_sync_in_loop": (
        "def fit(self, batches):\n"
        "    for b in batches:\n"
        "        loss = step(b).item()\n",
        "def fit(self, batches, tel):\n"
        "    for b in batches:\n"
        "        out = step(b)\n"
        "        if tel is not None:\n"
        "            loss = out.item()\n"),
    "unsorted_dict_hash": (
        "def calibration_fingerprint(db):\n"
        "    return _sha([[k, v] for k, v in db.items()] and\n"
        "                [1 for k in db.keys() for _ in [0]])\n"
        "def plan_digest(db):\n"
        "    out = []\n"
        "    for k, v in db.items():\n"
        "        out.append((k, v))\n"
        "    return hashlib.sha256(repr(out).encode())\n",
        "def plan_digest(db):\n"
        "    out = []\n"
        "    for k, v in sorted(db.items()):\n"
        "        out.append((k, v))\n"
        "    return hashlib.sha256(repr(out).encode())\n"),
    "global_rng": (
        "def shuffle(x):\n"
        "    torch.manual_seed(0)\n",
        "def shuffle(x):\n"
        "    gen = torch.Generator().manual_seed(0)\n"
        "    return torch.randperm(8, generator=gen)\n"),
    "time_in_trace": (
        "def build(self):\n"
        "    def step(x):\n"
        "        return x + time.time()\n"
        "    return self._compiled('step', step, held=(0,))\n",
        "def build(self):\n"
        "    def step(x, t):\n"
        "        return x + t\n"
        "    return self._compiled('step', step, held=(0,))\n"),
    "coordinator_collective": (
        "def commit(payload, rank):\n"
        "    if rank == 0:\n"
        "        dist.all_reduce(payload)\n",
        "def commit(payload):\n"
        "    return broadcast_json(payload if is_coordinator() else None)\n"),
    "donated_reuse": (
        "def loop(self, batch):\n"
        "    before = self._params['head']\n"
        "    out = step_fn(self._params, self._state, self._slots,\n"
        "                  self._step, self._counters, batch, self._rng)\n"
        "    return self._params['head']['kernel'] - before['kernel']\n",
        "def loop(self, batch):\n"
        "    before = self._params['head']['kernel'].clone()\n"
        "    out = step_fn(self._params, self._state, self._slots,\n"
        "                  self._step, self._counters, batch, self._rng)\n"
        "    return self._params['head']['kernel'] - before\n"),
    "low_precision_accum": (
        "def f(x):\n"
        "    return torch.sum(x.to(torch.bfloat16))\n",
        "def f(x):\n"
        "    return torch.sum(x.float()).to(torch.bfloat16)\n"),
    "host_divergent_branch": (
        "def f(payload):\n"
        "    if time.perf_counter() > 100.0:\n"
        "        barrier('resync')\n",
        "def f(payload, decision):\n"
        "    if decision['resync']:\n"
        "        barrier('resync')\n"),
    "unverified_transition": (
        "def restore(ff, flat):\n"
        "    restore_tree(model_state_tree(ff), flat)\n",
        "def restore(ff, flat, manifest):\n"
        "    verify_restore_transition(ff, flat, manifest)\n"
        "    restore_tree(model_state_tree(ff), flat)\n"),
    "unverified_rule_load": (
        "def inject(path, mesh):\n"
        "    return load_rule_collection(path, mesh)\n",
        "def inject(path, mesh, config):\n"
        "    return load_rule_collection(path, mesh, config=config)\n"),
    "raw_timer_in_hot_path": (
        "def train_step(self, batch):\n"
        "    t0 = time.perf_counter()\n"
        "    out = self._step(batch)\n"
        "    return out, time.perf_counter() - t0\n",
        "def train_step(self, batch, tel):\n"
        "    with telemetry.span('step'):\n"
        "        return self._step(batch)\n"),
    "unnamed_op_scope": (
        "def fwd(self, node, ins):\n"
        "    return node.op_def.forward(node.params, ins, {}, None, ctx)\n",
        "def fwd(self, node, ins):\n"
        "    with self._scope(node.name):\n"
        "        return node.op_def.forward(node.params, ins, {}, None,\n"
        "                                   ctx)\n"),
}


@pytest.mark.parametrize("rule", sorted(LINT))
def test_lint_rule_fires_on_torch_idiom_and_not_on_fix(rule):
    from flexflow_tpu_torch.analysis.lint import ALL_RULES, lint_source

    assert rule in ALL_RULES
    bad, good = LINT[rule]
    path = "flexflow_tpu_torch/executor.py"
    found = {f.code for f in lint_source(bad, path, select=(rule,))}
    assert found == {rule}
    assert lint_source(good, path, select=(rule,)) == []


def test_lint_more_torch_idioms():
    from flexflow_tpu_torch.analysis.lint import lint_source

    def codes(src, rule):
        return [f.code for f in lint_source(src, select=(rule,))]

    sync = "def f(xs):\n    for x in xs:\n        torch.cuda.synchronize()\n"
    assert codes(sync, "host_sync_in_loop") == ["host_sync_in_loop"]
    pragma = ("def f(xs):\n    for x in xs:\n"
              "        v = x.tolist()  # fflint: ok host_sync_in_loop\n")
    assert codes(pragma, "host_sync_in_loop") == []
    graph = ("def f(g, x):\n    with torch.cuda.graph(g):\n"
             "        y = x * random.random()\n")
    assert codes(graph, "time_in_trace") == ["time_in_trace"]
    half = "def f(x):\n    return x.half().sum()\n"
    assert codes(half, "low_precision_accum") == ["low_precision_accum"]
    kw = "def f(x):\n    return torch.mean(x, dtype=torch.float16)\n"
    assert codes(kw, "low_precision_accum") == ["low_precision_accum"]
    order_stat = "def f(x):\n    return torch.amax(x.to(torch.bfloat16))\n"
    assert codes(order_stat, "low_precision_accum") == []
    neg = ("def f(p):\n    if not is_coordinator():\n        pass\n"
           "    else:\n        dist.broadcast(p, src=0)\n")
    assert codes(neg, "coordinator_collective") == [
        "coordinator_collective"]
    capture = ("def f(self, fn):\n    if os.getenv('FAST'):\n"
               "        return self._compiled('s', fn, held=())\n"
               "    return fn\n")
    assert codes(capture, "host_divergent_branch") == [
        "host_divergent_branch"]


def test_port_tree_lints_clean():
    """The CI invariant the JAX package enforces on its tree: the port's
    runtime code carries no fflint finding (each hazard fixed or under a
    justified pragma)."""
    from flexflow_tpu_torch.analysis.lint import lint_paths

    findings = lint_paths([os.path.join(ROOT, "flexflow_tpu_torch")])
    assert findings == [], [str(f) for f in findings]


def test_donation_registry_matches_executor():
    from flexflow_tpu_torch.analysis.donation import (
        executor_donation_table,
        registry_problems,
    )

    assert registry_problems() == []
    table = executor_donation_table()
    assert table["build_train_step"] == (0, 1, 2, 3, 4, 6)
    assert table["build_chunked_train_step"] == (0, 1, 2, 3, 4, 6)
    assert table["build_eval_step"] == (0, 1, 2)
    assert table["build_decode_step"] == (0, 1, 4)


def test_donation_registry_detects_drift(tmp_path):
    from flexflow_tpu_torch.analysis.donation import registry_problems

    fake = tmp_path / "executor.py"
    fake.write_text(
        "class Executor:\n"
        "    def build_train_step(self):\n"
        "        self._train_step = self._compiled(\n"
        "            'train_step', self.train_step, held=(0, 1))\n"
        "        return self._train_step\n")
    codes = [f.code for f in registry_problems(str(fake))]
    assert "donation_registry_mismatch" in codes
