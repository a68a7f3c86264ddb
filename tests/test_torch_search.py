"""The port's Unity search (`flexflow_tpu_torch/search/`) against the JAX
package's, in one process.

Both packages build the same graph from the same seed and price it on the
same machine: the JAX package's TPU constants (`CHIPS["v5p"]`, or the CPU
entry each detects here), so the port's copies of the machine model, the
cost model, the rewrites and the searches must agree to the bit:

- the machine models' collective and roofline costs, to 1e-12 relative
  (JAX's cases of tests/test_machine_model.py and test_search.py), and the
  H100 switch model's own laws;
- the cost model: each node's priced cost under the search's evaluator,
  `classify_reshard`, `graph_makespan` (native and fallback), the
  calibration key of every node of the tiny LM, and a calibration table
  loaded into both giving equal prices and the same plan; on the CPU,
  `calibrate_graph` measuring the top 4 ops, then hitting its cache;
- the searches, each giving the identical Strategy JSON: the joint search
  on the big MLP and on the 2-layer LM of tests/test_joint_search.py,
  `search_mesh_shapes` over 8 devices, `mcmc_search_strategy` at a fixed
  seed, `lambda_memory_search` under a small cap;
- the priced weight-update decision (`choose_update_sharding`) giving the
  JAX package's record on tests/test_weight_update.py's memory-pressure,
  replicated-wins and stage-3 cases.
"""

import json
import sys

import numpy as np
import pytest

PKGS = ("flexflow_tpu", "flexflow_tpu_torch")
REL = 1e-12


def _sub(pkg, name):
    return __import__(f"{pkg}.{name}", fromlist=["x"])


def _close(a, b, what=""):
    assert abs(a - b) <= REL * max(abs(a), abs(b)), (what, a, b)


def _config(pkg, mesh=(1, 1, 1, 1), batch=16, argv=()):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    return mod, cfg


def big_mlp(pkg, hidden=4096, argv=(), mesh=(1, 1, 1, 1)):
    """tests/test_search.py:51's MLP, compiled."""
    mod, cfg = _config(pkg, mesh, 16, argv)
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((16, 64))
    t = ff.dense(x, hidden, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, hidden, mod.ActiMode.AC_MODE_RELU, name="fc2")
    t = ff.dense(t, 8, name="head")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def encoder_lm(pkg, argv=(), layers=2, batch=16):
    """tests/test_joint_search.py:24's 2-layer stack (attention + MLP),
    compiled on one device."""
    mod, cfg = _config(pkg, (1, 1, 1, 1), batch, argv)
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((batch, 32, 64), name="x")
    t = x
    for i in range(layers):
        a = ff.multihead_attention(t, t, t, 64, 4, name=f"l{i}_attn")
        t = ff.dense(a, 256, mod.ActiMode.AC_MODE_RELU, name=f"l{i}_ffn1")
        t = ff.dense(t, 64, name=f"l{i}_ffn2")
    ff.dense(t, 16, name="head")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff


def tiny_lm(pkg):
    """The tiny transformer LM (build_transformer_lm, 2 layers)."""
    mod, cfg = _config(pkg, batch=2)
    models = _sub(pkg, "models")
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
        sequence_length=16), batch_size=2)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def mesh_spec(pkg, sizes):
    return _sub(pkg, "search.mesh_search").MeshSpec(dict(sizes))


def plan_json(strategy) -> str:
    return json.dumps(strategy.to_json(), sort_keys=True)


MESH_24 = {"data": 2, "model": 4, "pipe": 1, "seq": 1}


# ------------------------------------------------------------ machine model


MACHINES = {
    "uniform": lambda mm: mm.TPUMachineModel(
        mm.CHIPS["v5p"], {"data": 4, "model": 2}),
    "uniform_dcn_congested": lambda mm: mm.TPUMachineModel(
        mm.CHIPS["v4"], {"data": 4, "model": 2}, {"data": 2},
        frozenset({"model"}), {"data": 2.0}),
    "for_mesh_v5p": lambda mm: mm.machine_model_for_mesh(
        {"data": 2, "model": 4}, chip=mm.CHIPS["v5p"]),
    "for_mesh_v5e_dcn": lambda mm: mm.machine_model_for_mesh(
        {"dcn": 2, "data": 4}, chip=mm.CHIPS["v5e"], num_hosts=2),
    "for_mesh_two_hosts": lambda mm: mm.machine_model_for_mesh(
        {"data": 4, "model": 2}, chip=mm.CHIPS["v6e"], num_hosts=2),
    "for_mesh_cpu": lambda mm: mm.machine_model_for_mesh(
        {"data": 8, "model": 1}),
    "open_torus": lambda mm: mm.TorusMachineModel(
        mm.CHIPS["v5e"], {"data": 8, "model": 2, "dcn": 2},
        topology={"data": mm.AxisTopology(links=1, wraparound=False),
                  "model": mm.AxisTopology(links=2),
                  "dcn": mm.AxisTopology(over_dcn=True)},
        chips_per_host=4),
}


def _prices(m) -> list:
    out = [type(m).__name__]
    for axis in ("data", "model", "dcn", "seq"):
        for b in (1.0, 4096.0, 64 * 2**20):
            out += [m.all_gather(b, axis), m.reduce_scatter(b, axis),
                    m.all_reduce(b, axis), m.all_to_all(b, axis),
                    m.ppermute(b, axis), m.rotate(b, axis)]
    out += [m.compute_time(f, b) for f in (0.0, 1e9, 1e13)
            for b in (0.0, 1e6, 1e10)]
    return out


def _assert_prices(want, got):
    assert got[0] == want[0]
    for i, (a, b) in enumerate(zip(want[1:], got[1:])):
        _close(a, b, i)


@pytest.mark.parametrize("case", sorted(MACHINES))
def test_machine_model_prices_match_jax(case):
    want, got = (_prices(MACHINES[case](_sub(p, "search.machine_model")))
                 for p in PKGS)
    _assert_prices(want, got)


def test_machine_model_file_matches_jax(tmp_path):
    path = tmp_path / "machine.json"
    path.write_text(json.dumps({
        "chip": {"name": "v5p", "ici_bandwidth": 5e10},
        "dcn_axes": ["data"], "congestion": {"model": 1.5},
        "topology": {"model": {"wraparound": False, "links": 2}}}))
    sizes = {"data": 2, "model": 4, "seq": 1}
    want, got = (_prices(_sub(p, "search.machine_model")
                         .machine_model_from_file(str(path), sizes))
                 for p in PKGS)
    _assert_prices(want, got)
    path.write_text(json.dumps({"congestion": {"nope": 2.0}}))
    for p in PKGS:
        with pytest.raises(ValueError, match="congestion axes"):
            _sub(p, "search.machine_model").machine_model_from_file(
                str(path), sizes)


def test_h100_is_priced_as_a_switch():
    """The H100 model: every intra-node axis rings at the GPU's whole
    NVLink rate (18 x 25 GB/s each way), with no fold over two torus
    dimensions and no wraparound term; the dcn axis at the GPU's own
    400 Gb/s NIC; from a file as from the mesh."""
    from flexflow_tpu_torch.search import machine_model as mm

    m = mm.machine_model_for_mesh({"dcn": 2, "data": 4, "model": 8},
                                  chip=mm.CHIPS["h100"])
    assert isinstance(m, mm.NVSwitchMachineModel)
    nv, lat = 18 * 25e9, 1e-6
    b = 256 * 2**20
    _close(m.all_reduce(b, "data"), 2 * 3 / 4 * b / nv + 2 * 3 * lat)
    _close(m.all_gather(b, "model"), 7 / 8 * b / nv + 7 * lat)
    _close(m.all_to_all(b, "data"), 3 / 4 * b / nv + 3 * lat)
    # no fold: the largest axis is priced at the same rate as the others
    _close(m.all_gather(b, "model") - 7 * lat,
           (m.all_gather(b, "data") - 3 * lat) * (7 / 8) / (3 / 4))
    _close(m.rotate(b, "model"), m.ppermute(b, "model"))
    _close(m.all_reduce(b, "dcn"), 2 * 1 / 2 * b / 50e9 + 2 * 10e-6)
    _close(m.compute_time(989e12, 0.0), 1.0)
    _close(m.compute_time(0.0, 3.35e12), 1.0)
    torus = mm.machine_model_for_mesh({"data": 4, "model": 8},
                                      chip=mm.CHIPS["v5p"])
    assert torus.axis_links == {"data": 1, "model": 2}


def test_h100_from_file(tmp_path):
    from flexflow_tpu_torch.search import machine_model as mm

    path = tmp_path / "h100.json"
    path.write_text(json.dumps({"chip": "h100", "congestion": {"data": 2}}))
    m = mm.machine_model_from_file(str(path), {"data": 4, "model": 2})
    assert isinstance(m, mm.NVSwitchMachineModel)
    _close(m.all_gather(1e6, "data"), 3 / 4 * 1e6 / (450e9 / 2) + 3e-6)
    _close(m.all_gather(1e6, "model"), 1 / 2 * 1e6 / 450e9 + 1e-6)


# --------------------------------------------------------------- cost model


def test_classify_reshard_matches_jax():
    cases = [((64, 1024), (("data",), ()), (("data",), ())),
             ((64, 1024), (("data",), ()), (("data",), ("model",))),
             ((64, 1024), (("data",), ("model",)), (("data",), ())),
             ((64, 1024), (("data",), ()), ((), ("data",))),
             ((8, 30, 7), ((), ("model", "data"), ()),
              (("data",), (), ("model",)))]
    for shape, a, b in cases:
        vals = []
        for p in PKGS:
            mm = _sub(p, "search.machine_model")
            cm = _sub(p, "search.cost_model")
            dt = _sub(p, "fftype").DataType.DT_FLOAT
            m = mm.TPUMachineModel(mm.CHIPS["v5p"], {"data": 4, "model": 4})
            vals.append(cm.classify_reshard(shape, a, b, dt, m))
        _close(*vals, (shape, a, b))


def test_graph_makespan_native_and_fallback_match_jax(monkeypatch):
    rs = np.random.RandomState(0)
    n = 40
    compute = list(rs.rand(n))
    comm = list(rs.rand(n) * 0.5)
    src, dst = [], []
    for v in range(1, n):
        for u in rs.choice(v, size=min(v, 2), replace=False):
            src.append(int(u))
            dst.append(v)
    axis = [int(a) for a in rs.randint(-1, 3, n)]
    from flexflow_tpu.search.cost_model import graph_makespan as jspan

    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.search.cost_model import graph_makespan

    assert native.available()
    for ax in (None, axis):
        want = jspan(compute, comm, src, dst, axis=ax)
        _close(want, graph_makespan(compute, comm, src, dst, axis=ax))
        with monkeypatch.context() as m:
            m.setattr(native, "_lib", None)
            _close(want, graph_makespan(compute, comm, src, dst, axis=ax))
    with pytest.raises(ValueError, match="cycle"):
        graph_makespan([1.0, 1.0], [0.0, 0.0], [0, 1], [1, 0])


def test_search_evaluator_prices_every_node_as_jax():
    """UnitySearch.evaluate's per-node attribution (op_cost, reshard,
    psum, sync, memory) on the big MLP on (2, 4) under every candidate
    config of each node, and the searched choice."""
    out = {}
    for p in PKGS:
        ff = big_mlp(p, hidden=512, argv=["--enable-parameter-parallel"])
        mm = _sub(p, "search.machine_model")
        cm = _sub(p, "search.cost_model").CostModel(
            mm.machine_model_for_mesh(mesh_spec(p, MESH_24),
                                      chip=mm.CHIPS["v5p"]), opt_slots=2)
        us = _sub(p, "search.unity").UnitySearch(
            ff.graph, mesh_spec(p, MESH_24), ff.config, cm)
        rows = []
        base = {n.guid: us.node_configs(n)[0] for n in us.order}
        for n in us.order:
            for cfg in us.node_configs(n):
                choice = dict(base)
                choice[n.guid] = cfg
                coll = []
                t, mem = us.evaluate(choice, collect=coll)
                rows.append((n.name, cfg.name, t, mem, [
                    (d["name"], d["forward_s"], d["backward_s"],
                     d["sync_s"], d["reshard_s"], d["memory_bytes"])
                    for d in coll]))
        out[p] = rows
    want, got = out.values()
    assert len(want) == len(got) > 8
    for (n0, c0, t0, m0, d0), (n1, c1, t1, m1, d1) in zip(want, got):
        assert (n0, c0) == (n1, c1)
        _close(t0, t1, (n0, c0))
        _close(m0, m1, (n0, c0))
        for a, b in zip(d0, d1):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                _close(x, y, (n0, c0, a[0]))


def _key_by_name(key):
    return (key[0].name, key[1], key[2])


def test_calibration_keys_match_jax_on_every_node():
    keys = []
    for p in PKGS:
        ff = tiny_lm(p)
        cm = _sub(p, "search.cost_model")
        keys.append([_key_by_name(cm._params_key(n))
                     for n in ff.graph.topo_order()])
    assert len(keys[0]) > 15
    assert keys[0] == keys[1]


def test_a_loaded_calibration_table_prices_both_alike():
    """A table keyed by `_params_key` (op type by name) loaded into both
    cost models: the joint search picks the same plan at the same
    price."""
    out = {}
    for p in PKGS:
        ff = encoder_lm(p, argv=["--budget", "4",
                                 "--enable-parameter-parallel"])
        mm = _sub(p, "search.machine_model")
        cmod = _sub(p, "search.cost_model")
        ot = _sub(p, "fftype").OperatorType
        cm = cmod.CostModel(mm.machine_model_for_mesh(
            mesh_spec(p, MESH_24), chip=mm.CHIPS["v5p"]))
        for i, n in enumerate(ff.graph.topo_order()):
            if n.op_type.name in ("OP_INPUT",):
                continue
            k = _key_by_name(cmod._params_key(n))
            cm._calibration[(ot[k[0]], k[1], k[2])] = (1e-4 * (i + 1),
                                                        3e-4 * (i + 1))
        jn = _sub(p, "search.joint")
        _, choice, us = jn.joint_graph_optimize(
            ff.graph, mesh_spec(p, MESH_24), ff.config, cm)
        t, mem = us.evaluate(choice)
        out[p] = (plan_json(us.to_strategy(choice)), t, mem)
    (pj, tj, mj), (pt, tt, mt) = out.values()
    assert pj == pt
    _close(tj, tt)
    _close(mj, mt)


def test_calibrate_graph_on_the_cpu_measures_then_hits():
    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.search.machine_model import machine_model_for_mesh

    ff = tiny_lm("flexflow_tpu_torch")
    cm = CostModel(machine_model_for_mesh(ff.mesh))
    cm._REPS = (2, 10)
    assert cm.calibrate_graph(ff.graph, top_k=4) == 4
    assert cm.calib_stats["measured"] == 4
    assert cm.calib_stats["candidates"] >= 4
    for fwd, bwd in cm._calibration.values():
        assert fwd > 0 and bwd >= 0.25 * fwd
    kinds = {k[0].name for k in cm._calibration}
    assert "OP_MULTIHEAD_ATTENTION" in kinds and "OP_LINEAR" in kinds
    assert cm.calibrate_graph(ff.graph, top_k=4) == 0
    assert cm.calib_stats == {"measured": 0, "cache_hits": 4,
                              "candidates": cm.calib_stats["candidates"]}


# ------------------------------------------------------------------ searches


def _joint(p, ff, sizes=MESH_24, chip="v5p"):
    mm = _sub(p, "search.machine_model")
    cm = _sub(p, "search.cost_model").CostModel(mm.machine_model_for_mesh(
        mesh_spec(p, sizes), chip=mm.CHIPS[chip]))
    _, choice, us = _sub(p, "search.joint").joint_graph_optimize(
        ff.graph, mesh_spec(p, sizes), ff.config, cm)
    t, mem = us.evaluate(choice)
    return plan_json(us.to_strategy(choice)), t, mem, us.evals


SEARCHES = {
    "big_mlp_joint": lambda p: _joint(
        p, big_mlp(p, argv=["--enable-parameter-parallel"])),
    "encoder_lm_joint": lambda p: _joint(
        p, encoder_lm(p, argv=["--budget", "4",
                               "--enable-parameter-parallel"])),
    "encoder_lm_joint_cpu": lambda p: _joint(
        p, encoder_lm(p, argv=["--budget", "4",
                               "--enable-parameter-parallel"]),
        {"data": 4, "model": 2, "pipe": 1, "seq": 1}, "cpu"),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_joint_search_picks_the_jax_plan(case):
    (pj, tj, mj, ej), (pt, tt, mt, et) = (SEARCHES[case](p) for p in PKGS)
    assert pj == pt
    assert "model" in pj or case == "encoder_lm_joint_cpu"
    _close(tj, tt)
    _close(mj, mt)
    assert ej == et


def test_search_strategy_and_mcmc_pick_the_jax_plan():
    out = {}
    for p in PKGS:
        ff = big_mlp(p, hidden=1024, argv=["--enable-parameter-parallel",
                                           "--budget", "40"])
        mm = _sub(p, "search.machine_model")
        unity = _sub(p, "search.unity")
        mesh = mesh_spec(p, MESH_24)
        machine = mm.machine_model_for_mesh(mesh, chip=mm.CHIPS["v5p"])
        s1 = unity.search_strategy(ff.graph, mesh, ff.config, machine)
        ff.config.seed = 3
        s2 = unity.mcmc_search_strategy(
            ff.graph, mesh, ff.config,
            _sub(p, "search.cost_model").CostModel(machine))
        out[p] = (plan_json(s1), plan_json(s2))
    assert out[PKGS[0]] == out[PKGS[1]]


def test_mesh_shape_search_over_eight_devices_matches_jax():
    out = {}
    for p in PKGS:
        ff = encoder_lm(p, argv=["--budget", "2",
                                 "--enable-parameter-parallel"])
        mm = _sub(p, "search.machine_model")
        shape, _, choice, us, results = _sub(
            p, "search.mesh_search").search_mesh_shapes(
                ff.graph, 8, ff.config, chip=mm.CHIPS["v5p"])
        out[p] = (shape, plan_json(us.to_strategy(choice)), results)
    (sj, pj, rj), (st, pt, rt) = out.values()
    assert (sj, pj) == (st, pt)
    assert [r[0] for r in rj] == [r[0] for r in rt] and len(rj) == 4
    for a, b in zip(rj, rt):
        _close(a[1], b[1], a[0])


def pipelined_lm(pkg, layers=4):
    """The tiny pipelined LM (build_transformer_lm_pipelined: the block
    stack one PIPE_BLOCKS node), compiled on one device."""
    mod, cfg = _config(pkg, batch=16)
    models = _sub(pkg, "models")
    ff = mod.FFModel(cfg)
    models.build_transformer_lm_pipelined(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=128, num_heads=2, num_layers=layers,
        sequence_length=32, attention_impl="xla"), batch_size=16,
        num_microbatches=2)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


@pytest.mark.parametrize("layers", [4, 3], ids=["divisible", "odd"])
def test_mesh_shape_search_over_the_pipe_axis_matches_jax(layers):
    """A PIPE_BLOCKS stack makes `pipe` a searched axis (`model._search`):
    the factorizations of 8 devices over data, model and pipe, each
    priced with the pipeline's bubble and hops (a stack of 3 blocks
    prunes the pipe shapes it does not divide), end on JAX's mesh and
    Strategy JSON, every candidate at JAX's price."""
    out = {}
    for p in PKGS:
        ff = pipelined_lm(p, layers)
        mm = _sub(p, "search.machine_model")
        shape, _, choice, us, results = _sub(
            p, "search.mesh_search").search_mesh_shapes(
                ff.graph, 8, ff.config, axes=("data", "model", "pipe"),
                chip=mm.CHIPS["v5p"])
        out[p] = (shape, plan_json(us.to_strategy(choice)), results)
    (sj, pj, rj), (st, pt, rt) = out.values()
    assert (sj, pj) == (st, pt)
    assert [r[0] for r in rj] == [r[0] for r in rt]
    assert any(dict(r[0]).get("pipe", 1) > 1 for r in rt) == (layers == 4)
    for a, b in zip(rj, rt):
        _close(a[1], b[1], a[0])


def test_lambda_memory_search_under_a_small_cap_matches_jax():
    """The lambda blend under -ll:fsize: every probe over the cap, so the
    bisection runs all its iterations; both packages end on the same
    plan."""
    out = {}
    for p in PKGS:
        ff = big_mlp(p, hidden=2048, argv=["--enable-parameter-parallel",
                                           "--memory-search"])
        assert ff.config.perform_memory_search
        # after compile: the JAX package's plan check refuses the plan
        # over this cap at compile (--no-verify-plan is ROADMAP A9)
        ff.config.parse_args(["-ll:fsize", "8"])
        assert ff.config.device_mem == 8 * 2**20
        mm = _sub(p, "search.machine_model")
        unity = _sub(p, "search.unity")
        mesh = mesh_spec(p, MESH_24)
        cm = _sub(p, "search.cost_model").CostModel(
            mm.machine_model_for_mesh(mesh, chip=mm.CHIPS["v5p"]))
        choice, us = unity.lambda_memory_search(
            lambda: unity.UnitySearch(ff.graph, mesh, ff.config, cm),
            ff.config.device_mem)
        t, mem = us.evaluate(choice)
        out[p] = (plan_json(us.to_strategy(choice)), t, mem, us._lambda)
    (pj, tj, mj, lj), (pt, tt, mt, lt) = out.values()
    assert pj == pt and lj == lt
    _close(tj, tt)
    _close(mj, mt)


# ----------------------------------------------------- update sharding


def wu_mlp(pkg, argv=(), depth=0):
    """tests/test_weight_update.py:25's MLP (Adam); the JAX one compiled
    on its dp-4 mesh, the port's on one device, then placed on a dp-4
    mesh of four (absent) ranks."""
    mod, cfg = _config(pkg, (4, 1, 1, 1) if pkg == "flexflow_tpu"
                       else (1, 1, 1, 1), 8, argv)
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((8, 16), name="x")
    t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
    for i in range(depth):
        t = ff.dense(t, 32, mod.ActiMode.AC_MODE_RELU, name=f"fc_h{i}")
    t = ff.dense(t, 4, name="fc2")
    ff.softmax(t, name="sm")
    ff.compile(optimizer=mod.AdamOptimizer(alpha=0.01),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    if pkg == "flexflow_tpu_torch":
        import torch

        tm = _sub(pkg, "machine")
        ff.mesh = tm.Mesh(tm.MeshShape((4, 1, 1, 1)), torch.device("cpu"))
        ff._assign_strategy()
    return ff


def _port_decision(ff, overlap=True):
    from flexflow_tpu_torch.search.unity import choose_update_sharding

    return choose_update_sharding(ff.graph, ff.mesh, ff.config,
                                  opt_slots=ff.optimizer.num_slots,
                                  overlap=overlap)


def _assert_decision(want, got):
    for k in ("enabled", "stage", "shards", "axes", "forced",
              "forced_stage", "reason"):
        assert got[k] == want[k], k
    for k, v in want["predicted"].items():
        _close(v, got["predicted"][k], k)


@pytest.mark.parametrize("case", ["memory_pressure", "default",
                                  "replicated_wins", "stage3", "bare_flag"])
def test_priced_update_sharding_decides_as_jax(case):
    if case == "stage3":
        probe = wu_mlp("flexflow_tpu", depth=6)._update_sharding
        pred = probe["predicted"]
        mid = (pred["stage2_mem_bytes"] + pred["stage3_mem_bytes"]) / 2
        argv, depth = ["-ll:fsize", f"{mid / 2**20:.6f}"], 6
    else:
        argv = {"memory_pressure": ["-ll:fsize", "0.007"], "default": [],
                "replicated_wins": ["--no-overlap-collectives"],
                "bare_flag": ["--weight-update-sharding"]}[case]
        depth = 0
    want = wu_mlp("flexflow_tpu", argv, depth)._update_sharding
    got = _port_decision(wu_mlp("flexflow_tpu_torch", argv, depth),
                         overlap=case != "replicated_wins")
    _assert_decision(want, got)
    assert got["overlap_runtime"] is False
    assert got["overlap_priced"] is (case != "replicated_wins")
    expect = {"memory_pressure": (True, 2, "memory_bound"),
              "replicated_wins": (False, 0, "replicated_cheaper"),
              "stage3": (True, 3, "memory_bound"),
              "bare_flag": (True, 2, "flag")}.get(case)
    if expect:
        assert (got["enabled"], got["stage"], got["reason"]) == expect


def test_split_search_joins_its_halves_where_jax_loses_the_seam():
    """Reference-side fault (ROADMAP queue C): on a graph the joint search
    splits twice over (more than 4 x --base-optimize-threshold nodes in a
    half), the JAX package's `_join` looks post's boundary input up by
    identity, which the inner split-join replaced with a clone: the input
    stays a source, its edges are lost and the plan is priced as two
    halves running side by side. The port finds it by its marker, so the
    joined graph is whole and its data-parallel plan prices as the
    unsplit graph's; the plans of graphs the search splits at most once
    stay the JAX package's (the joint searches above)."""
    out = {}
    for p in PKGS:
        mod, cfg = _config(p, batch=8, argv=["--budget", "2"])
        models = _sub(p, "models")
        ff = mod.FFModel(cfg)
        models.build_transformer_lm(ff, models.TransformerLMConfig(
            vocab_size=64, hidden_size=64, num_heads=2, num_layers=12,
            sequence_length=16), batch_size=8)
        ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
                   loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        sizes = {"data": 4, "model": 1, "pipe": 1, "seq": 1}
        mm = _sub(p, "search.machine_model")
        cm = _sub(p, "search.cost_model").CostModel(
            mm.machine_model_for_mesh(mesh_spec(p, sizes),
                                      chip=mm.CHIPS["v5p"]))
        clone = _sub(p, "search.mesh_search").clone_graph
        unity = _sub(p, "search.unity")
        dp = unity.UnitySearch(clone(ff.graph), mesh_spec(p, sizes),
                               ff.config, cm)
        dp_s, _ = dp.evaluate({n.guid: dp.node_configs(n)[0]
                               for n in dp.order})
        g, choice, us = _sub(p, "search.joint").joint_graph_optimize(
            clone(ff.graph), mesh_spec(p, sizes), ff.config, cm)
        assert {c.name for c in choice.values()} == {"dp"}
        out[p] = (len(g.sources()), len(g.sinks()), us.evaluate(choice)[0],
                  dp_s)
    (jsrc, jsink, jt, jdp), (tsrc, tsink, tt, tdp) = out.values()
    assert (jsrc, jsink) == (3, 2) and jt < jdp  # the lost seam
    assert (tsrc, tsink) == (2, 1)
    _close(tt, tdp)
    _close(jdp, tdp)
