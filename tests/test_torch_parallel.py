"""The port's parallel half against the JAX package's, in one process.

No ranks are spawned here (tests/test_torch_distributed*.py run the
mesh): these hold the port's pure rules to the JAX package's on the same
inputs:

- the parallel ops' shape transforms (`apply_parallel_op_shape`) and
  output placements (`derive_parallel_assignment`);
- the weight-update sharding rules (`choose_update_dim`,
  `weight_update_spec`, `grad_sync_axes`) and the ring schedule
  (`ring_permutation`; a permutation that is not a bijection raises);
- the strategies `megatron_transformer` and `sequence_parallel_attention`
  on the same model, and Strategy JSON written by either package read by
  the other, with `validate`'s verdicts;
- the flags: `--mesh` (and `--nodes`) parsed into JAX's mesh shape, the
  search flags raising (ROADMAP A7) only with more than one device, the
  forced update-sharding decisions equal to JAX's and the unforced one
  raising (A7);
- a mesh of one device built with no process group, a larger one
  refused; `set_strategy` and the parallel-op builders on one device.
"""

import json
import sys

import numpy as np
import pytest


def _jax():
    import flexflow_tpu.parallel as jpar
    from flexflow_tpu import machine as jm
    from flexflow_tpu import tensor as jt
    from flexflow_tpu.fftype import DataType, OperatorType

    return jpar, jm, jt, DataType, OperatorType


def _torch():
    import flexflow_tpu_torch.parallel as tpar
    from flexflow_tpu_torch import machine as tm
    from flexflow_tpu_torch import tensor as tt
    from flexflow_tpu_torch.fftype import DataType, OperatorType

    return tpar, tm, tt, DataType, OperatorType


def _dims(shape):
    return [(d.size, d.degree, d.is_replica_dim, tuple(d.axes))
            for d in shape.dims]


SHAPE_CHAINS = {
    "degrees": [("OP_REPARTITION", "RepartitionParams", (0, 4)),
                ("OP_COMBINE", "CombineParams", (0, 2)),
                ("OP_REPLICATE", "ReplicateParams", (4,)),
                ("OP_REDUCTION", "ReductionParams", (4,))],
    "named_axes": [("OP_REPARTITION", "RepartitionParams",
                    (1, 2, ("model",))),
                   ("OP_REPARTITION", "RepartitionParams", (0, 2, ("data",))),
                   ("OP_COMBINE", "CombineParams", (1, 2, ("model",)))],
}


@pytest.mark.parametrize("chain", sorted(SHAPE_CHAINS))
def test_parallel_op_shapes_match_jax(chain):
    outs = []
    for jaxside in (True, False):
        par, _, t, DT, OT = _jax() if jaxside else _torch()
        s = t.ParallelTensorShape.from_shape((64, 32), DT.DT_FLOAT)
        seen = []
        for op, cls, args in SHAPE_CHAINS[chain]:
            s = par.apply_parallel_op_shape(s, getattr(OT, op),
                                            getattr(par, cls)(*args))
            seen.append((_dims(s), s.logical_shape, s.total_degree,
                         s.piece_shape()))
        outs.append(seen)
    assert outs[0] == outs[1]


def _port_mesh(sizes, names=None):
    import torch

    _, tm, _, _, _ = _torch()
    shape = tm.MeshShape(tuple(sizes), names or tm.DEFAULT_AXES)
    return tm.Mesh(shape, torch.device("cpu"))


ASSIGN_CASES = [
    ("OP_REPARTITION", "RepartitionParams", (1, 4), (("data",), ())),
    ("OP_REPARTITION", "RepartitionParams", (1, 2, ("data",)), ((), ())),
    ("OP_COMBINE", "CombineParams", (1, 4), (("data",), ("model",))),
    ("OP_COMBINE", "CombineParams", (0, 2, ("data",)), (("data",), ())),
    ("OP_REPLICATE", "ReplicateParams", (2,), (("data",), ())),
    ("OP_REDUCTION", "ReductionParams", (2,), (("data",), ("model",))),
]


@pytest.mark.parametrize("case", range(len(ASSIGN_CASES)))
def test_derive_parallel_assignment_matches_jax(case):
    op, cls, args, ins = ASSIGN_CASES[case]
    jpar, jm, _, _, JOT = _jax()
    tpar, _, _, _, TOT = _torch()
    jmesh = jm.build_mesh(jm.MeshShape((2, 4, 1, 1)))
    tmesh = _port_mesh((2, 4, 1, 1))
    want = jpar.ops.derive_parallel_assignment(
        getattr(JOT, op), getattr(jpar, cls)(*args), ins, jmesh)
    got = tpar.derive_parallel_assignment(
        getattr(TOT, op), getattr(tpar, cls)(*args), ins, tmesh)
    assert got == want


def test_repartition_onto_a_used_or_missing_axis_raises_as_jax():
    jpar, jm, _, _, JOT = _jax()
    tpar, _, _, _, TOT = _torch()
    jmesh = jm.build_mesh(jm.MeshShape((2, 4, 1, 1)))
    tmesh = _port_mesh((2, 4, 1, 1))
    for args, ins in (((1, 3), ((), ())),
                      ((1, 2, ("data",)), (("data",), ()))):
        with pytest.raises(ValueError):
            jpar.ops.derive_parallel_assignment(
                JOT.OP_REPARTITION, jpar.RepartitionParams(*args), ins, jmesh)
        with pytest.raises(ValueError):
            tpar.derive_parallel_assignment(
                TOT.OP_REPARTITION, tpar.RepartitionParams(*args), ins,
                tmesh)


UPDATE_CASES = [
    ((64, 32), None, ("data",), {"data": 4}),
    ((6, 32), None, ("data",), {"data": 4}),
    ((64, 32), (None, "model"), ("data",), {"data": 2, "model": 2}),
    ((64, 32), ("model", None), ("data",), {"data": 2, "model": 2}),
    ((128,), ("model",), ("data",), {"data": 2, "model": 2}),
    ((64, 32), ("data", None), ("data",), {"data": 4}),
    ((7, 5), None, ("data",), {"data": 4}),
    ((64, 32), None, ("dcn", "data"), {"dcn": 2, "data": 2}),
    ((64, 32), None, (), {"data": 4}),
]


@pytest.mark.parametrize("case", range(len(UPDATE_CASES)))
def test_weight_update_rules_match_jax(case):
    from flexflow_tpu.parallel import ops as jops
    from jax.sharding import PartitionSpec as P

    from flexflow_tpu_torch.parallel import ops as tops
    from flexflow_tpu_torch.tensor import PartitionSpec, spec_assignment

    shape, base, axes, sizes = UPDATE_CASES[case]
    jbase = P(*base) if base is not None else None
    tbase = PartitionSpec(*base) if base is not None else None
    ja = jops._spec_assignment(jbase, len(shape))
    ta = spec_assignment(tbase, len(shape))
    assert ja == ta
    assert (tops.choose_update_dim(shape, ta, axes, sizes)
            == jops.choose_update_dim(shape, ja, axes, sizes))
    want = jops.weight_update_spec(shape, jbase, axes, sizes)
    got = tops.weight_update_spec(shape, tbase, axes, sizes)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


def test_grad_sync_axes_and_ring_schedule_match_jax():
    from flexflow_tpu.parallel import ops as jops

    from flexflow_tpu_torch.parallel import ops as tops

    for out_axes, w_axes in (({"data", "model"}, {"model"}),
                             ({"seq", "data"}, set()), (set(), {"data"}),
                             ({"dcn", "data"}, {"data"})):
        assert (tops.grad_sync_axes(out_axes, w_axes)
                == jops.grad_sync_axes(out_axes, w_axes))
    for n in (1, 2, 3, 8):
        assert tops.ring_permutation(n) == jops.ring_permutation(n)
        for i in range(n):
            dst, src = tops._ring_peers(tops.ring_permutation(n), n, i)
            assert (dst, src) == ((i + 1) % n, (i - 1) % n)
    for bad in ([(0, 1), (1, 1)], [(0, 1)], [(0, 0), (1, 0)]):
        with pytest.raises(ValueError, match="not a bijection"):
            tops._ring_peers(bad, 2, 0)


# ------------------------------------------------------------ strategies


def _mlp(pkg, batch=32, argv=()):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    cfg = mod.FFConfig(device="cpu") if pkg.endswith("torch") \
        else mod.FFConfig()
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((batch, 64), name="x")
    t = ff.dense(x, 128, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.gelu(t, name="act")
    t = ff.dense(t, 10, name="fc2")
    t = ff.dense(t, 10, name="fc3")
    ff.softmax(t, name="sm")
    return ff


def _lm(pkg):
    sys.argv = ["test"]
    mod = __import__(pkg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    cfg = mod.FFConfig(device="cpu") if pkg.endswith("torch") \
        else mod.FFConfig()
    ff = mod.FFModel(cfg)
    models.build_transformer_lm(ff, models.TransformerLMConfig(
        vocab_size=64, hidden_size=128, num_heads=2, num_layers=2,
        sequence_length=16), batch_size=4)
    return ff


def _plain(overrides) -> dict:
    """A Strategy's overrides with every spec as a plain tuple."""
    return {n: {"outputs": {i: tuple(tuple(e) for e in a)
                            for i, a in ov["outputs"].items()},
                "weights": {w: tuple(tuple(e) if isinstance(e, (list, tuple))
                                     else e for e in spec)
                            for w, spec in ov["weights"].items()}}
            for n, ov in overrides.items()}


@pytest.mark.parametrize("model", ["mlp", "lm"])
@pytest.mark.parametrize("gen", ["megatron_transformer",
                                 "sequence_parallel_attention"])
def test_strategies_match_jax_on_the_same_model(model, gen):
    import flexflow_tpu.parallel as jpar

    import flexflow_tpu_torch.parallel as tpar

    build = _mlp if model == "mlp" else _lm
    jff, tff = build("flexflow_tpu"), build("flexflow_tpu_torch")
    assert [l.name for l in jff.layers] == [l.name for l in tff.layers]
    want = getattr(jpar, gen)(jff)
    got = getattr(tpar, gen)(tff)
    assert _plain(got.overrides) == _plain(want.overrides)
    # the MLP has no 3-D activation for the sequence dim to shard
    assert bool(got) == (model == "lm" or gen == "megatron_transformer")


def test_strategy_json_reads_in_either_package(tmp_path):
    """A plan written by the port loads in JAX and one written by JAX
    loads in the port: the same overrides, and `validate` passes on the
    model it was made for."""
    import flexflow_tpu.parallel as jpar
    from flexflow_tpu.parallel.strategies import Strategy as JStrategy

    import flexflow_tpu_torch.parallel as tpar
    from flexflow_tpu_torch.parallel.strategies import Strategy as TStrategy

    tff, jff = _lm("flexflow_tpu_torch"), _lm("flexflow_tpu")
    ts = tpar.megatron_transformer(tff).merge(
        tpar.sequence_parallel_attention(tff))
    js = jpar.megatron_transformer(jff).merge(
        jpar.sequence_parallel_attention(jff))
    assert ts.to_json() == js.to_json()
    ts.save(str(tmp_path / "port.json"))
    js.save(str(tmp_path / "jax.json"))
    assert (json.load(open(tmp_path / "port.json"))
            == json.load(open(tmp_path / "jax.json")))
    from_port = JStrategy.load(str(tmp_path / "port.json"))
    from_jax = TStrategy.load(str(tmp_path / "jax.json"))
    assert _plain(from_port.overrides) == _plain(js.overrides)
    assert _plain(from_jax.overrides) == _plain(ts.overrides)
    assert from_jax.to_json() == js.to_json()
    with pytest.raises(ValueError, match="version"):
        TStrategy.from_json({"version": 2})


def _validate_both(overrides_json, mesh_sizes):
    from flexflow_tpu import machine as jm
    from flexflow_tpu.parallel.strategies import Strategy as JStrategy

    from flexflow_tpu_torch.parallel.strategies import Strategy as TStrategy

    verdicts = []
    for jaxside in (True, False):
        ff = _mlp("flexflow_tpu" if jaxside else "flexflow_tpu_torch")
        ff.compile()
        s = (JStrategy if jaxside else TStrategy).from_json(overrides_json)
        mesh = (jm.build_mesh(jm.MeshShape(mesh_sizes)) if jaxside
                else _port_mesh(mesh_sizes))
        try:
            s.validate(ff.graph, mesh)
            verdicts.append(None)
        except ValueError as e:
            verdicts.append(str(e).count("\n"))
    return verdicts


VALIDATE_CASES = {
    "fits": {"fc1": {"weights": {"kernel": [None, "model"]},
                     "outputs": {"0": [["data"], ["model"]]}}},
    "unknown_node": {"nope": {"outputs": {"0": [["data"], []]}}},
    "unknown_weight": {"fc1": {"weights": {"kern": [None, "model"]}}},
    "axis_reuse": {"fc1": {"outputs": {"0": [["model"], ["model"]]}}},
    "absent_axis": {"fc1": {"outputs": {"0": [["expert"], []]}}},
    "indivisible": {"fc2": {"outputs": {"0": [[], ["model"]]}}},
    "rank_mismatch": {"fc1": {"outputs": {"0": [["data"]]}}},
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_strategy_validate_agrees_with_jax(case):
    """The same verdict (and as many problems) from either package."""
    j, t = _validate_both({"version": 1, "nodes": VALIDATE_CASES[case]},
                          (2, 4, 1, 1))
    assert j == t
    assert (j is None) == (case == "fits")


# ------------------------------------------------------------ flags


MESH_ARGVS = [
    [], ["--mesh", "8,1,1,1"], ["--mesh", "2,4,1,1"],
    ["--mesh", "2,2,2,1,1"], ["--nodes", "2", "--mesh", "2,1,1,1"],
]


@pytest.mark.parametrize("argv", MESH_ARGVS, ids=lambda a: " ".join(a)
                         or "none")
def test_mesh_flag_parsed_as_jax(argv):
    from flexflow_tpu import FFConfig as JConfig

    from flexflow_tpu_torch import FFConfig as TConfig

    sys.argv = ["test", *argv]
    j = JConfig()
    t = TConfig(device="cpu")
    js, ts = j.mesh_shape(), t.mesh_shape()
    if not argv:
        # no --mesh: every device on `data`; JAX's process sees 8 virtual
        # devices, the port's world is this one process
        assert ts.axis_sizes == (1, 1, 1, 1) and ts.axis_names == js.axis_names
    else:
        assert (ts.axis_sizes, ts.axis_names) == (js.axis_sizes,
                                                  js.axis_names)


UPDATE_FLAGS = {
    "off": ["--weight-update-sharding=off"],
    "no": ["--no-weight-update-sharding"],
    "stage2": ["--weight-update-sharding=stage2"],
    "stage3": ["--weight-update-sharding", "stage3"],
}


@pytest.mark.parametrize("flags", sorted(UPDATE_FLAGS))
def test_forced_update_sharding_decides_as_jax(flags):
    """The forced decisions on a 4-way data mesh: the same record as the
    JAX package's choose_update_sharding."""
    from flexflow_tpu import machine as jm
    from flexflow_tpu.search.unity import choose_update_sharding as jchoose

    from flexflow_tpu_torch.search.unity import choose_update_sharding

    argv = UPDATE_FLAGS[flags]
    jff = _mlp("flexflow_tpu", argv=argv)
    jff.config.mesh_axis_sizes = (4, 1, 1, 1)
    jff.compile()
    tff = _mlp("flexflow_tpu_torch", argv=argv)
    tff.compile()
    want = jchoose(jff.graph, jm.build_mesh(jm.MeshShape((4, 1, 1, 1))),
                   jff.config)
    got = choose_update_sharding(tff.graph, _port_mesh((4, 1, 1, 1)),
                                 tff.config)
    keys = ("enabled", "stage", "shards", "axes", "forced", "forced_stage",
            "reason")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_unforced_update_sharding_and_search_flags_raise_naming_a7():
    """With more than one data shard the unforced decision (and the bare
    --weight-update-sharding, whose stage JAX prices) raises naming A7;
    on one shard, or for inference, it stays replicated without pricing.
    The search flags raise naming A7 only on more than one device."""
    from flexflow_tpu_torch.fftype import CompMode
    from flexflow_tpu_torch.search.unity import choose_update_sharding

    for argv in ([], ["--weight-update-sharding"]):
        tff = _mlp("flexflow_tpu_torch", argv=argv)
        tff.compile()
        with pytest.raises(NotImplementedError, match="A7"):
            choose_update_sharding(tff.graph, _port_mesh((4, 1, 1, 1)),
                                   tff.config)
        one = choose_update_sharding(tff.graph, _port_mesh((1, 1, 1, 1)),
                                     tff.config)
        assert not one["enabled"] and one["reason"] == "no_grad_sync"
        tff.config.computation_mode = CompMode.COMP_MODE_INFERENCE
        inf = choose_update_sharding(tff.graph, _port_mesh((4, 1, 1, 1)),
                                     tff.config)
        assert not inf["enabled"] and inf["reason"] == "inference"
    for flag in (["--budget", "10"], ["--enable-parameter-parallel"],
                 ["--enable-attribute-parallel"], ["--enable-substitutions"],
                 ["--substitution-json", "rules.json"]):
        one = _mlp("flexflow_tpu_torch", argv=flag)
        one.compile()  # one device: harmless, as in JAX
        assert one.mesh.size == 1
        many = _mlp("flexflow_tpu_torch", argv=flag + ["--mesh", "4,1,1,1"])
        with pytest.raises(NotImplementedError, match="A7"):
            many.compile()
        dp = _mlp("flexflow_tpu_torch",
                  argv=flag + ["--mesh", "4,1,1,1", "--only-data-parallel"])
        with pytest.raises(ValueError, match="mesh needs 4 devices"):
            dp.compile()  # past the search check: no 4 ranks here
    for flag in (["--calibrate", "3"], ["--search-mesh-shapes"],
                 ["--machine-model-file", "m.json"]):
        ff = _mlp("flexflow_tpu_torch", argv=flag + ["--mesh", "4,1,1,1"])
        with pytest.raises(ValueError, match="mesh needs 4 devices"):
            ff.compile()  # inert without the search, as in JAX


def test_one_device_mesh_strategy_and_parallel_ops():
    """On one device: a (1, 1, 1, 1) mesh with no process group, the
    strategy installed by set_strategy (or read by --import-strategy)
    placing nothing, the parallel-op builders as identities, exported
    plans, and the manifest's mesh axes."""
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.fftype import ActiMode, LossType
    from flexflow_tpu_torch.parallel import Strategy, megatron_transformer

    sys.argv = ["test"]
    ff = _mlp("flexflow_tpu_torch")
    ff.set_strategy(megatron_transformer(ff))
    ff.compile()
    assert dict(ff.mesh.shape) == {"data": 1, "model": 1, "pipe": 1,
                                   "seq": 1}
    assert ff._plan_source == "manual" and not ff.executor.spmd
    fc1 = next(n for n in ff.graph.topo_order() if n.name == "fc1")
    assert tuple(fc1.weight_axes["kernel"]) == (None, "model")
    assert tuple(fc1.outputs[0].partition_spec()) == ("data", "model")
    assert ff._goodput_anchor["num_chips"] == 1

    ff2 = FFModel(FFConfig(device="cpu"))
    x = ff2.create_tensor((8, 16), name="x")
    t = ff2.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff2.repartition(t, dim=1, degree=1, name="rp")
    t = ff2.combine(t, dim=1, degree=1, name="cb")
    t = ff2.replicate(t, 1, name="rep")
    t = ff2.reduction(t, 1, name="red")
    t = ff2.dense(t, 4, name="fc2")
    ff2.compile(optimizer=SGDOptimizer(lr=0.1),
                loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    assert [n.is_parallel_op for n in ff2.graph.topo_order()
            if n.name in ("rp", "cb", "rep", "red")] == [True] * 4
    rs = np.random.RandomState(0)
    xs = rs.randn(16, 16).astype(np.float32)
    ys = rs.randint(0, 4, (16, 1)).astype(np.int32)
    before = ff2.get_weight("fc2", "kernel").copy()
    ff2.fit(xs, ys, epochs=1, batch_size=8, verbose=False)
    assert not np.array_equal(before, ff2.get_weight("fc2", "kernel"))
    ff2.start_batch(xs[:8], ys[:8])
    assert tuple(ff2.forward().shape) == (8, 4)
    assert torch.isfinite(ff2.backward())
    ff2.update()


def test_import_and_export_strategy_flags(tmp_path):
    from flexflow_tpu_torch.parallel import Strategy

    path = str(tmp_path / "plan.json")
    exp = _mlp("flexflow_tpu_torch", argv=["--export-strategy", path])
    from flexflow_tpu_torch.parallel import megatron_transformer

    exp.set_strategy(megatron_transformer(exp))
    exp.compile()
    saved = Strategy.load(path)
    assert _plain(saved.overrides) == _plain(exp._strategy)
    imp = _mlp("flexflow_tpu_torch", argv=["--import-strategy", path])
    imp.compile()
    assert imp._plan_source == "import"
    assert _plain(imp._strategy) == _plain(exp._strategy)
    bad = str(tmp_path / "bad.json")
    json.dump({"version": 1,
               "nodes": {"nope": {"outputs": {"0": [["data"], []]}}}},
              open(bad, "w"))
    with pytest.raises(ValueError, match="--import-strategy"):
        _mlp("flexflow_tpu_torch", argv=["--import-strategy", bad]).compile()


def test_mesh_needs_a_process_group_and_enough_ranks():
    from flexflow_tpu_torch import machine as tm

    one = tm.build_mesh(tm.MeshShape((1, 1, 1, 1)))
    assert one.size == 1 and one.coords == {a: 0 for a in tm.DEFAULT_AXES}
    assert tm.spec_num_shards(_port_mesh((2, 4, 1, 1)), ("data", "model")) \
        == 8
    for sizes in ((2, 1, 1, 1), (1, 2, 1, 1), (2, 1, 2, 1, 1)):
        names = tm.MULTIHOST_AXES if len(sizes) == 5 else tm.DEFAULT_AXES
        with pytest.raises(ValueError, match="mesh needs"):
            tm.build_mesh(tm.MeshShape(sizes, names))


def test_entry_forward_is_the_tiny_lm():
    """`entry.entry()`, the twin of `__graft_entry__.entry`: the tiny LM's
    forward and its example arguments, on the device asked for."""
    from flexflow_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    logits = fn(*args)
    assert tuple(logits.shape) == (2, 128, 512)
    assert bool(logits.isfinite().all())


def test_dryrun_on_a_card_without_a_world_raises():
    """`dryrun_multichip` asked for the card (its default) with no process
    group of that many ranks raises, naming torchrun: it spawns CPU ranks
    only when the caller asks for the CPU."""
    from flexflow_tpu_torch.entry import dryrun_multichip

    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            dryrun_multichip(2, **kw)
