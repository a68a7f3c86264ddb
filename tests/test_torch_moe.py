"""The port's MoE family (ROADMAP A12: `ops/moe.py`, the MoE builders,
expert parallelism) against the JAX package's, on the CPU.

- Every MoE op (Group_by, Aggregate with its load-balance term,
  AggregateSpec, Cache with `cache_score`, the fused stacked Experts with
  relu and gelu), forward, op state and gradients, through
  `tests/test_torch_builders._parity`: float32 at rtol = atol = 2e-5,
  bfloat16 at 2e-2 (atol scaled by the largest entry); the routing
  (slots, drops) exactly equal. Capacity factors below 1 drop tokens.
- The flat MoE (fused and unfused) and the MoE encoder trained 3 SGD
  steps from the JAX model's weights, the load-balance term on: every
  loss at rtol 1e-5, every master at rtol = atol = 1e-5 (float32);
  AggregateSpec's label replication trained alike.
- `create_fuse_moe_trio`'s rewrite gives the JAX rewrite's graph, ffrules
  gives it the JAX verifier's findings, and the joint search reaches the
  same expert-parallel plan.
- Expert parallelism on 2 and 4 gloo ranks (ep 2, ep 4, dp 2 x ep 2)
  (and the unfused trio at dp 4, its load-balance term counted once)
  held to one rank and to the JAX package's virtual mesh (masters at
  rtol = atol = 2e-5, losses at 2e-5), at a capacity where the global
  routing drops tokens that a per-rank routing would not; 5 experts over
  ep 2 refused by both compile gates (`indivisible_dim`); and
  `chip_smoke.mesh_moe_check`, the torchrun MoE leg, on the 4 ranks at a
  small width (the dry run's "lm", "sp" and "moe" legs, the MoE encoder
  at ep 4 and dp 2 x ep 2 within MESH_TOL's float32 bound of one rank,
  the same tokens dropped).
"""

import re
import sys

import numpy as np
import pytest

from tests.test_torch_builders import _compile_pair, _copy, _parity
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
MESH_TOL = dict(rtol=2e-5, atol=2e-5)


def _rs(seed=0):
    return np.random.RandomState(seed)


def _assign(b, k, n, seed):
    """(b, k) distinct expert ids a row, as top_k gives them."""
    rs = _rs(seed)
    return np.stack([rs.permutation(n)[:k] for _ in range(b)]).astype(
        np.int32)


# ------------------------------------------------------------------ ops

def _op_case(case):
    b, k, n, d, h = 12, 2, 4, 6, 5
    rs = _rs(3)
    assign = _assign(b, k, n, 4)
    if case == "group_by":
        return ("OP_GROUP_BY", "GroupByParams", (n, 0.5),
                [rs.randn(b, d).astype(np.float32), assign], {}, (0,), {})
    if case in ("aggregate", "aggregate_spec"):
        cap = 3  # below the 6 tokens an expert gets on average: drops
        gate = rs.rand(b, k).astype(np.float32)
        full = rs.rand(b, n).astype(np.float32)
        preds = [rs.randn(cap, h).astype(np.float32) for _ in range(n)]
        cls = "AggregateParams" if case == "aggregate" else \
            "AggregateSpecParams"
        op = "OP_AGGREGATE" if case == "aggregate" else "OP_AGG_SPEC"
        # the load-balance term (op state) reaches the full gate: its
        # gradient is held through the models' training below
        diff = ((0,) if case == "aggregate" else ()) + tuple(
            range(4, 4 + n))
        return (op, cls, (n, 0.05), [gate, assign, assign, full] + preds,
                {}, diff, {})
    if case.startswith("cache"):
        x = rs.randn(b, d).astype(np.float32)
        cached = rs.randn(b, d).astype(np.float32)
        # evaluation reads the cache: no gradient reaches x
        diff = (0,) if case == "cache_train" else ()
        return ("OP_CACHE", "CacheParams", (2,), [x], {}, diff,
                dict(training=case == "cache_train",
                     state={"cached": cached, "score": np.float32(0.0)}))
    act = case.split("_")[1]
    kern = rs.randn(n, d, h).astype(np.float32)
    bias = rs.randn(n, h).astype(np.float32)
    return ("OP_EXPERTS", "ExpertsParams", (n, h, 0.5, 0.04, True, act),
            [rs.randn(b, d).astype(np.float32),
             rs.rand(b, k).astype(np.float32), assign],
            {"kernel": kern, "bias": bias}, (0, 1), {})


OP_CASES = ("group_by", "aggregate", "aggregate_spec", "cache_train",
            "cache_eval", "experts_relu", "experts_gelu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", OP_CASES)
def test_moe_op_matches_jax(case, dtype):
    from flexflow_tpu import ops as jops
    from flexflow_tpu_torch import ops as tops

    op, cls, args, inputs, weights, diff, kw = _op_case(case)
    _parity(op, getattr(jops, cls)(*args), getattr(tops, cls)(*args),
            inputs, weights, dtype, diff, **kw)


@pytest.mark.parametrize("alpha", [0.25, 1.0, 2.0])
def test_routing_slots_and_drops_equal_jax(alpha):
    import jax.numpy as jnp
    import torch

    from flexflow_tpu.ops.moe import _routing_slots, expert_capacity as jcap
    from flexflow_tpu_torch.ops.moe import expert_capacity, routing_slots

    b, k, n = 64, 2, 5
    assign = _assign(b, k, n, 11)
    cap = expert_capacity(n, k, b, alpha)
    assert cap == jcap(n, k, b, alpha)
    js, jv = _routing_slots(jnp.asarray(assign), n, cap)
    ts, tv = routing_slots(torch.tensor(assign), n, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if alpha < 1:
        assert not tv.all()


def test_cache_score_equals_jax():
    import jax.numpy as jnp
    import torch

    from flexflow_tpu.ops.moe import cache_score as jscore
    from flexflow_tpu_torch.ops.moe import cache_score

    rs = _rs(5)
    x, c = rs.randn(8, 4).astype(np.float32), rs.randn(8, 4).astype(
        np.float32)
    for a, b in ((x, c), (x, x), (x, 100 * c)):
        np.testing.assert_allclose(
            float(cache_score(torch.tensor(a), torch.tensor(b))),
            float(jscore(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# ------------------------------------------------------------------ models

def _ff(pkg, batch, argv=()):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = batch
    return mod.FFModel(cfg)


SMALL = dict(num_exp=4, num_select=2, alpha=0.75, lambda_bal=0.04,
             hidden_size=16, num_attention_heads=2, num_encoder_layers=1,
             in_dim=24, num_classes=6)


def _by_position(ff) -> dict:
    """A model's masters keyed "<layer index>.<weight>": the MoE
    composite names its layers from each package's own layer counter,
    which other tests advance differently in one process."""
    return {f"{i}.{w}": np.asarray(v) for i, l in enumerate(ff.layers)
            if l.name in ff._params for w, v in ff._params[l.name].items()}


def _moe_pair(kind, batch=8):
    """(jax model, port model) of `kind` ("flat", "flat_fused",
    "encoder"), compiled, the port holding the JAX model's weights."""
    out = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        ff = _ff(pkg, batch)
        models = __import__(f"{pkg}.models", fromlist=["x"])
        from importlib import import_module

        moe = import_module(f"{pkg}.models.moe")
        cfg = moe.MoeConfig(**SMALL)
        if kind == "encoder":
            moe.build_moe_encoder(ff, cfg, batch_size=batch, seq_length=8)
        else:
            models.build_moe(ff, cfg, batch_size=batch,
                             fused=kind == "flat_fused")
        out.append(ff)
    _compile_pair(*out)
    import chip_smoke

    chip_smoke.load_by_position(out[1], _by_position(out[0]))
    return out


def _moe_data(kind, batch, steps, seed=21):
    rs = _rs(seed)
    shape = (batch * steps, 8, 16) if kind == "encoder" else \
        (batch * steps, 24)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 6, (batch * steps, 1)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("kind", ["flat", "flat_fused", "encoder"])
def test_moe_models_train_three_steps_as_jax(kind):
    """Three SGD steps through fit from the same weights: each step's loss
    (the load-balance term in it) and every master after them."""
    jff, tff = _moe_pair(kind)
    x, y = _moe_data(kind, 8, 3)
    losses = {}
    for name, ff in (("jax", jff), ("port", tff)):
        seen = []
        for i in range(3):
            sl = slice(8 * i, 8 * i + 8)
            ff.start_batch({"input": x[sl]}, y[sl])
            seen.append(float(ff.backward()))
            ff.update()
        losses[name] = seen
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    got = {f"{i}.{w}": tff.get_weight(l.name, w)
           for i, l in enumerate(tff.layers) if l.name in tff._params
           for w in tff._params[l.name]}
    want = _by_position(jff)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **F32, err_msg=f"{kind} {k}")


def test_aggregate_spec_head_replicates_labels_as_jax():
    """AggregateSpec as the output head: (k * b, classes) logits scored
    against labels replicated k times (model.cc:2875), fit for an epoch
    of 4 batches from the same weights: masters and the metric counters
    (k * b samples a batch) as JAX's."""
    ffs = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        ff = _ff(pkg, 8)
        mod = __import__(pkg)
        x = ff.create_tensor((8, 12), name="input")
        gate = ff.dense(x, 4, mod.ActiMode.AC_MODE_RELU, name="gate")
        probs = ff.softmax(gate, name="gate_sm")
        vals, assign = ff.top_k(probs, 2)
        ins = ff.group_by(x, assign, 4, 2.0, name="gb")
        outs = [ff.dense(e, 5, mod.ActiMode.AC_MODE_RELU, name=f"exp{i}")
                for i, e in enumerate(ins)]
        t = ff.aggregate_spec([vals, assign, assign, probs] + outs, 4,
                              name="agg_spec")
        ff.softmax(t, name="sm")
        ffs.append(ff)
    jff, tff = ffs
    from flexflow_tpu import LossType as JL, MetricsType as JM
    from flexflow_tpu import SGDOptimizer as JSGD
    from flexflow_tpu_torch import LossType as TL, MetricsType as TM
    from flexflow_tpu_torch import SGDOptimizer as TSGD

    jff.compile(optimizer=JSGD(lr=0.1),
                loss_type=JL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[JM.METRICS_ACCURACY])
    tff.compile(optimizer=TSGD(lr=0.1),
                loss_type=TL.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[TM.METRICS_ACCURACY])
    _copy(jff, tff)
    assert tff.executor.label_replication == \
        jff.executor.label_replication == 2
    rs = _rs(8)
    x = rs.randn(32, 12).astype(np.float32)
    y = rs.randint(0, 5, (32, 1)).astype(np.int32)
    for ff in (jff, tff):
        ff.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=False)
    jm, tm = jff.get_perf_metrics(), tff.get_perf_metrics()
    assert tm.train_all == jm.train_all == 32 * 2
    assert tm.train_correct == jm.train_correct
    for n, ws in jff._params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(tff.get_weight(n, w), np.asarray(v),
                                       **F32, err_msg=f"{n}.{w}")


def test_cache_state_trains_and_loads_as_jax():
    """A Cache op between two dense layers: its non-trainable `cached` and
    `score` state through fit (written in place) and `load_params`."""
    ffs = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        ff = _ff(pkg, 4)
        x = ff.create_tensor((4, 6), name="input")
        t = ff.dense(x, 8, name="fc1")
        t = ff.cache(t, 2, name="cache")
        ff.softmax(ff.dense(t, 3, name="fc2"), name="sm")
        ffs.append(ff)
    jff, tff = ffs
    _compile_pair(jff, tff)
    assert set(tff._state["cache"]) == {"cached", "score"}
    held = tff._state["cache"]["cached"]
    _copy(jff, tff, with_state=True)
    rs = _rs(9)
    x = rs.randn(8, 6).astype(np.float32)
    y = rs.randint(0, 3, (8, 1)).astype(np.int32)
    for ff in (jff, tff):
        ff.fit(x, y, epochs=1, batch_size=4, shuffle=False, verbose=False)
    assert tff._state["cache"]["cached"] is held
    for k in ("cached", "score"):
        np.testing.assert_allclose(
            tff._state["cache"][k].numpy(),
            np.asarray(jff._state["cache"][k]), **F32, err_msg=k)
    assert float(tff._state["cache"]["score"]) > 0


# ------------------------------------------------------------------ search

def _unfused(pkg, n=4, batch=64, argv=(), dims=(32, 8)):
    ff = _ff(pkg, batch, argv)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    models.build_moe(ff, models.MoeConfig(
        num_exp=n, num_select=2, in_dim=dims[0], num_classes=dims[1]),
        batch_size=batch, fused=False)
    mod = __import__(pkg)
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.05),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _graph_summary(g):
    # by operator and params: the auto-named layers take each package's
    # own counter
    return [(n.op_type.name, repr(n.params)) for n in g.topo_order()]


def test_fuse_moe_trio_rewrite_equals_jax():
    got = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        ff = _unfused(pkg)
        sub = __import__(f"{pkg}.search.substitution", fromlist=["x"])
        xfer = sub.create_fuse_moe_trio(4)
        matches = xfer.find_matches(ff.graph)
        assert len(matches) == 1
        g = xfer.apply(ff.graph, matches[0])
        exp = next(n for n in g.topo_order()
                   if n.op_type.name == "OP_EXPERTS")
        assert {ws.name: tuple(ws.shape) for ws in exp.weight_specs} == {
            "kernel": (4, 32, 8), "bias": (4, 8)}
        got.append(_graph_summary(g))
    assert got[0] == got[1]
    kinds = [k for k, _ in got[1]]
    assert "OP_EXPERTS" in kinds and "OP_GROUP_BY" not in kinds


def test_unfused_moe_joint_search_reaches_expert_parallel_as_jax():
    """The joint search on the unfused MoE over (data 2, model 4) priced
    for v5p: the fuse rewrite fires, the fused Experts takes "ep", and
    the plan is the JAX search's."""
    from tests.test_torch_search import _joint

    out = []
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        ff = _unfused(pkg, argv=["--budget", "8",
                                 "--enable-attribute-parallel",
                                 "--search-overlap-backward-update"],
                      dims=(512, 512))
        plan, *rest = _joint(pkg, ff, {"data": 2, "model": 4, "pipe": 1,
                                       "seq": 1})
        # the layer names by position (each package's own counter),
        # the rewrite's fresh Experts node by its kind
        for i, l in sorted(enumerate(ff.layers),
                           key=lambda il: -len(il[1].name)):
            plan = plan.replace(l.name, f"<layer {i}>")
        plan = re.sub(r"op_experts_\d+", "<experts>", plan)
        out.append((plan, *rest))
    (pj, tj, mj, ej), (pt, tt, mt, et) = out
    assert pj == pt
    assert "model" in pt
    np.testing.assert_allclose(tt, tj, rtol=1e-9)
    assert ej == et


@pytest.mark.parametrize("n", [2, 4])
def test_moe_fusion_rule_verdict_equals_jax(n):
    """ffrules on `create_fuse_moe_trio(n)` (its Group_by and Aggregate
    instances synthesized): no error, the oracle skipped with its info
    finding (fresh Experts weights), the findings as the JAX verifier's."""
    ci_mesh = {"data": 2, "model": 4, "dcn": 1, "seq": 1}
    got = {}
    for pkg in ("flexflow_tpu", "flexflow_tpu_torch"):
        rules = __import__(f"{pkg}.analysis.rules", fromlist=["x"])
        sub = __import__(f"{pkg}.search.substitution", fromlist=["x"])
        findings = rules.verify_rule(sub.create_fuse_moe_trio(n), ci_mesh)
        got[pkg] = sorted({(f.severity, f.code, f.where) for f in findings})
    assert got["flexflow_tpu"] == got["flexflow_tpu_torch"]
    assert not [f for f in got["flexflow_tpu_torch"] if f[0] == "error"]
    assert any(f[1] == "rule_oracle_skipped" for f in got["flexflow_tpu_torch"])


# ------------------------------------------------------------------ mesh

EP_BATCH, EP_STEPS = 16, 3
# capacity 2 x 16 x 0.25 / 4 = 2 of the 8 token copies an expert gets on
# average: the global routing drops tokens
EP_CFG = dict(num_exp=4, num_select=2, alpha=0.25, lambda_bal=0.04,
              in_dim=12, num_classes=6)


def _ep_model(pkg, mesh, fused=True, argv=()):
    sys.argv = ["test", "--weight-update-sharding=off", *argv]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = EP_BATCH
    ff = mod.FFModel(cfg)
    models = __import__(f"{pkg}.models", fromlist=["x"])
    par = __import__(f"{pkg}.parallel", fromlist=["x"])
    models.build_moe(ff, models.MoeConfig(**EP_CFG), batch_size=EP_BATCH,
                     fused=fused)
    ff.set_strategy(par.expert_parallel_moe(ff))
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.1),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    return ff


def _ep_data():
    rs = _rs(31)
    x = rs.randn(EP_BATCH * EP_STEPS, 12).astype(np.float32)
    y = rs.randint(0, 6, (EP_BATCH * EP_STEPS, 1)).astype(np.int32)
    return x, y


def _ep_train(ff, params):
    """Load `params` (by layer position, `chip_smoke.by_position`'s keys:
    two processes number their layers from different counters), fit
    EP_STEPS steps; (losses, masters, routes): the losses a step, the
    whole masters by position, and each routing's (assign, slot, valid)
    (`chip_smoke.moe_routes`)."""
    import chip_smoke

    chip_smoke.load_by_position(ff, params)
    x, y = _ep_data()
    rec, losses = [], []
    step = ff.executor.build_train_step()

    def logged(*a):
        out = step(*a)
        losses.append(float(out[-1]))
        return out

    ff.executor._train_step = logged
    with chip_smoke.moe_routes(rec):
        ff.fit(x, y, epochs=1, batch_size=EP_BATCH, shuffle=False,
               verbose=False)
    routes = [(r["assign"], r["slot"], r["valid"]) for r in rec]
    return losses, chip_smoke.by_position(ff), routes


def ep_rank(rank, world, params):
    """One rank of the expert-parallel runs: one rank alone, ep over the
    world, and (a world of 4) dp 2 x ep 2; each (losses, masters,
    routes), plus the rules the executor ran."""
    out = {}
    meshes = {"one": (1, 1, 1, 1), f"ep {world}": (1, world, 1, 1)}
    if world == 4:
        meshes["dp 2 x ep 2"] = (2, 2, 1, 1)
        # the unfused trio at dp 4 (group_by and aggregate run on the
        # whole batch: the load-balance term counted once)
        import chip_smoke

        one = _ep_model("flexflow_tpu_torch", (1, 1, 1, 1), fused=False)
        init = chip_smoke.by_position(one)
        out["unfused"] = (_ep_train(one, init)[:2], _ep_train(_ep_model(
            "flexflow_tpu_torch", (4, 1, 1, 1), fused=False), init)[:2])
        # chip_smoke's torchrun MoE leg, rehearsed at a small width
        import dataclasses

        import chip_smoke
        from flexflow_tpu_torch.models import MoeConfig

        out["mesh_moe"] = chip_smoke.mesh_moe_check(
            "cpu", dataclasses.replace(
                MoeConfig(), num_exp=4, alpha=0.5, hidden_size=16,
                num_attention_heads=2, num_encoder_layers=2),
            batch=4, seq=8, steps=3)
    else:
        # MoeConfig's 5 experts over ep 2: the compile gate refuses it
        try:
            sys.argv = ["test"]
            from flexflow_tpu_torch import FFConfig, FFModel, LossType
            from flexflow_tpu_torch import SGDOptimizer
            from flexflow_tpu_torch.models import MoeConfig, build_moe
            from flexflow_tpu_torch.parallel import expert_parallel_moe

            cfg = FFConfig(device="cpu")
            cfg.mesh_axis_sizes = (1, 2, 1, 1)
            cfg.batch_size = 8
            ff = FFModel(cfg)
            build_moe(ff, MoeConfig(in_dim=16, num_classes=8),
                      batch_size=8, fused=True)
            ff.set_strategy(expert_parallel_moe(ff))
            ff.compile(optimizer=SGDOptimizer(lr=0.01),
                       loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
            out["uneven"] = None
        except Exception as e:
            out["uneven"] = (type(e).__name__, str(e))
    for name, mesh in meshes.items():
        ff = _ep_model("flexflow_tpu_torch", mesh)
        out[name] = _ep_train(ff, params)
        if ff.executor.spmd:
            out[name + " rules"] = {
                node.op_type.name: ff.executor._rules[node.guid]["kind"]
                for node in ff.executor.order
                if node.guid in ff.executor._rules}
    return out


def _jax_ep(mesh):
    """The JAX package's run on its virtual mesh: (initial params, losses,
    masters)."""
    jff = _ep_model("flexflow_tpu", mesh)
    params = {f"{i}.{w}": np.asarray(v)
              for i, l in enumerate(jff.layers) if l.name in jff._params
              for w, v in jff._params[l.name].items()}
    x, y = _ep_data()
    losses = []
    for i in range(EP_STEPS):
        sl = slice(EP_BATCH * i, EP_BATCH * (i + 1))
        jff.start_batch({"input": x[sl]}, y[sl])
        losses.append(float(jff.backward()))
        jff.update()
    masters = {f"{i}.{w}": np.asarray(v)
               for i, l in enumerate(jff.layers) if l.name in jff._params
               for w, v in jff._params[l.name].items()}
    return params, losses, masters


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_matches_one_rank_and_jax(world):
    from flexflow_tpu_torch.distributed import spawn

    mesh = (2, 2, 1, 1) if world == 4 else (1, 2, 1, 1)
    params, jlosses, jmasters = _jax_ep(mesh)
    outs = spawn(ep_rank, world, world, params, timeout=300)
    import torch

    from flexflow_tpu_torch.ops.moe import expert_capacity, routing_slots

    one_losses, one_masters, one_routes = outs[0]["one"]
    # the global routing drops tokens at this capacity, and a routing of
    # each half of the batch alone (a data rank's rows) would drop others
    assign, slot, valid = one_routes[0]
    assert assign.shape == (EP_BATCH, 2) and not valid.all()
    half = EP_BATCH // 2
    cap = expert_capacity(4, 2, half, EP_CFG["alpha"])
    local = np.concatenate([routing_slots(torch.tensor(a), 4, cap)[
        1].numpy() for a in (assign[:half], assign[half:])])
    assert (local != valid).any()
    np.testing.assert_allclose(one_losses, jlosses, **MESH_TOL)
    for k, v in jmasters.items():
        np.testing.assert_allclose(one_masters[k], v, **MESH_TOL,
                                   err_msg=f"one rank {k}")
    for o in outs:
        for name in o:
            if name in ("one", "uneven", "mesh_moe", "unfused") or \
                    name.endswith("rules"):
                continue
            losses, masters, routes = o[name]
            assert o[name + " rules"]["OP_EXPERTS"] == "experts"
            np.testing.assert_allclose(losses, one_losses, **MESH_TOL,
                                       err_msg=name)
            for k, v in one_masters.items():
                np.testing.assert_allclose(masters[k], v, **MESH_TOL,
                                           err_msg=f"{name} {k}")
            # each step's global routing: the same drops as one rank's
            assert len(routes) == len(one_routes) == EP_STEPS
            for got, want in zip(routes, one_routes):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
        if world == 4:
            (ul, um), (dl, dm) = o["unfused"]
            np.testing.assert_allclose(dl, ul, **MESH_TOL)
            for k, v in um.items():
                np.testing.assert_allclose(dm[k], v, **MESH_TOL,
                                           err_msg=f"unfused dp 4 {k}")
            # the dry run's three legs, then the encoder at ep 4 and dp 2
            # x ep 2 held to one rank with the same drops
            m = o["mesh_moe"]
            assert m["failures"] == [], m["failures"]
            assert len(m["dry_run_losses"]) == 3
            assert set(m["checks"]) == {"ep 4", "dp 2 x ep 2"}
            assert any(m["runs"][0]["dropped"])
        if world == 2:
            name, msg = o["uneven"]
            assert name == "PlanVerificationError", msg
            assert msg.count("indivisible_dim") == 2, msg


def test_uneven_expert_split_is_refused_by_the_jax_gate():
    """MoeConfig's 5 experts over ep 2: GSPMD would pad the split, and
    the JAX package's compile gate refuses it (`indivisible_dim` on the
    stacked kernel and bias); the port's gate refuses it alike on 2 gloo
    ranks (`test_expert_parallel_matches_one_rank_and_jax[2]`)."""
    sys.argv = ["test"]
    from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu.analysis import PlanVerificationError
    from flexflow_tpu.models import MoeConfig, build_moe
    from flexflow_tpu.parallel import expert_parallel_moe

    cfg = FFConfig()
    cfg.mesh_axis_sizes = (1, 2, 1, 1)
    cfg.batch_size = 8
    ff = FFModel(cfg)
    build_moe(ff, MoeConfig(in_dim=16, num_classes=8), batch_size=8,
              fused=True)
    ff.set_strategy(expert_parallel_moe(ff))
    with pytest.raises(PlanVerificationError) as e:
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    assert str(e.value).count("indivisible_dim") == 2
