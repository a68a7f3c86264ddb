"""The port on a mesh of 4 gloo ranks on the CPU, against the JAX package
on its virtual 8-device mesh and against itself.

Each test spawns 4 processes once (`flexflow_tpu_torch.distributed.spawn`)
and runs several configurations in them; the JAX side runs here. Float32,
tensor-op math off on both sides:

- the ring collectives (`ring_reduce_scatter`, `ring_all_gather`) and
  `allgather_matmul` against their plain versions, bit for bit (each
  sums the same values in the same order), and the port's own
  collectives (`parallel.spmd`: all-gather, reduce-scatter, all-reduce,
  `sync_grad`) over a group whose ranks torch orders otherwise;
- the MLP of `tests/test_weight_update.py` at dp 4 (Adam, 2 shuffled
  epochs) and the MLP of `tests/test_parallel.py` at (2, 2, 1, 1) under
  `megatron_transformer` (SGD, 2 epochs), each from the JAX model's
  initial weights (`load_params`), held to the JAX package's run at
  `F32_TOL` (rtol = atol = 2e-5, `tests/test_torch_train.py`): weights,
  and the metric counters summed over the data ranks;
- stage 2 and stage 3 (`--weight-update-sharding=stage2|stage3`) bit-equal
  to the replicated update on the same mesh over 2 shuffled epochs (Adam,
  and SGD with momentum): masters, slots, counters, step; each rank
  holding 1/dp of every shardable master and slot, and at stage 3 of the
  weights at rest;
- the repartition / combine builders giving JAX's partition specs
  (`tests/test_parallel.py:183`) and training as JAX does;
- `entry.dryrun_multichip(4)` (its fused-MoE leg at dp 2 x ep 2 equal on
  every rank and to the one-rank step), eval, the granular API and the data
  loader on the mesh, `distributed`'s JSON exchanges, and the refusals:
  a mesh larger than the world or smaller than it (the search flags and
  the unforced update decision on 4 devices build); `spawn` naming a rank
  that died.
"""

import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
WORLD = 4


def _spawn(fn, *args):
    from flexflow_tpu_torch.distributed import spawn

    return spawn(fn, WORLD, *args, timeout=300)


def _config(pkg, mesh, batch, argv=(), seed=0):
    sys.argv = ["test", *argv]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    cfg.seed = seed
    return mod, cfg


def build_mlp(pkg, kind, mesh, argv=(), opt="adam", strategy=None):
    """`kind` "wu": the 16 -> 32 -> 4 MLP of test_weight_update.py (batch
    8); "tp": the 64 -> 128 -> 10 MLP of test_parallel.py (batch 32);
    "rp": that MLP with a repartition / combine pair between its layers."""
    batch = 8 if kind == "wu" else 32
    mod, cfg = _config(pkg, mesh, batch, argv)
    ff = mod.FFModel(cfg)
    if kind == "wu":
        x = ff.create_tensor((batch, 16), name="x")
        t = ff.dense(x, 32, mod.ActiMode.AC_MODE_RELU, name="fc1")
        t = ff.dense(t, 4, name="fc2")
    else:
        x = ff.create_tensor((batch, 64), name="x")
        t = ff.dense(x, 128 if kind == "tp" else 64,
                     mod.ActiMode.AC_MODE_RELU, name="fc1")
        if kind == "rp":
            t = ff.repartition(t, dim=1, degree=2, name="rp")
            t = ff.combine(t, dim=1, degree=2, name="cb")
        t = ff.dense(t, 10, name="fc2")
    ff.softmax(t, name="sm")
    if strategy == "megatron":
        par = __import__(f"{pkg}.parallel", fromlist=["x"])
        ff.set_strategy(par.megatron_transformer(ff))
    optimizer = (mod.AdamOptimizer(alpha=0.01) if opt == "adam"
                 else mod.SGDOptimizer(lr=0.05, momentum=0.9)
                 if opt == "sgd_momentum" else mod.SGDOptimizer(lr=0.05))
    ff.compile(optimizer=optimizer,
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY,
                        mod.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def data(kind, seed=0):
    rs = np.random.RandomState(seed)
    d, k = (16, 4) if kind == "wu" else (64, 10)
    x = rs.randn(64, d).astype(np.float32)
    y = rs.randint(0, k, (64, 1)).astype(np.int32)
    return x, y


def port_state(ff) -> dict:
    """Every trajectory-defining tensor of a port model, whole (gathered
    from the ranks' blocks), as numpy; with each master's and slot's
    local element count beside the whole one."""
    ex = ff.executor
    out = {"params": {}, "slots": {}, "local": {}}
    for n, ws in ff._params.items():
        for k, t in ws.items():
            out["params"][f"{n}.{k}"] = ff.get_weight(n, k).copy()
            out["local"][f"{n}.{k}"] = (t.numel(), int(np.prod(
                ex.weight_shape(n, k))))
    for slot, tree in ff._opt_slots.items():
        for n, ws in tree.items():
            for k, t in ws.items():
                out["slots"][f"{slot}.{n}.{k}"] = ex.full_weight(
                    n, k, t).numpy().copy()
                out["local"][f"{slot}.{n}.{k}"] = (t.numel(), int(np.prod(
                    ex.weight_shape(n, k))))
    # the stage-2/3 masters gathered back to their compute placement
    gathered = ex.build_param_gather()(ff._params)
    out["gathered"] = {f"{n}.{k}": tuple(t.shape)
                       for n, ws in gathered.items() for k, t in ws.items()}
    out["counters"] = {k: float(v) for k, v in ff._counters.items()}
    out["step"] = int(ff._step)
    out["update"] = {k: ff._update_sharding.get(k)
                     for k in ("enabled", "stage", "shards")}
    return out


def train_job(rank, job) -> dict:
    """One port run on this rank: build, load the given weights, fit."""
    from flexflow_tpu_torch import load_params

    ff = build_mlp("flexflow_tpu_torch", job["kind"], job["mesh"],
                   job.get("argv", ()), job.get("opt", "adam"),
                   job.get("strategy"))
    if job.get("init") is not None:
        load_params(ff, job["init"])
    x, y = data(job["kind"])
    ff.fit(x, y, epochs=2, batch_size=ff.config.batch_size,
           shuffle=job.get("shuffle", True), verbose=False)
    out = port_state(ff)
    out["specs"] = {n.name: tuple(n.outputs[0].partition_spec())
                    for n in ff.graph.topo_order() if n.outputs}
    return out


def run_jobs(rank, jobs) -> list:
    return [train_job(rank, j) for j in jobs]


def jax_run(kind, mesh, argv=(), opt="adam", strategy=None, shuffle=True):
    """The JAX package's run: its initial weights (for the port to load)
    and its final weights, counters and node specs."""
    jff = build_mlp("flexflow_tpu", kind, mesh, argv, opt, strategy)
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in jff._params.items()}
    x, y = data(kind)
    jff.fit(x, y, epochs=2, batch_size=jff.config.batch_size,
            shuffle=shuffle, verbose=False)
    final = {f"{n}.{k}": np.asarray(v) for n, ws in jff._params.items()
             for k, v in ws.items()}
    counters = {k: float(np.asarray(v)) for k, v in jff._counters.items()}
    specs = {n.name: tuple(n.outputs[0].partition_spec())
             for n in jff.graph.topo_order() if n.outputs}
    return init, final, counters, specs


def assert_ranks_agree(outs):
    for o in outs[1:]:
        for k, v in o["params"].items():
            assert np.array_equal(v, outs[0]["params"][k]), k


def assert_bit_equal(a, b, what):
    for part in ("params", "slots", "counters"):
        assert set(a[part]) == set(b[part]), (what, part)
        for k in a[part]:
            assert np.array_equal(np.asarray(a[part][k]),
                                  np.asarray(b[part][k])), (what, part, k)
    assert a["step"] == b["step"], what


# ------------------------------------------------------------ collectives


def collectives_job(rank):
    import torch

    from flexflow_tpu_torch import machine as tm
    from flexflow_tpu_torch.parallel import (
        allgather_matmul,
        ring_all_gather,
        ring_reduce_scatter,
    )

    mesh = tm.build_mesh(tm.MeshShape((2, 2, 1, 1)))
    full = torch.arange(4 * 12 * 6, dtype=torch.float32).reshape(
        4, 12, 6) / 7.0
    out = {}
    # each rank contributes its own tensor; the data axis has 2 ranks
    contrib = full[rank] * (rank + 1)
    out["rs"] = ring_reduce_scatter(contrib, mesh=mesh,
                                    axis_name="data").numpy()
    for dim in (0, 1):
        blk = full[rank].narrow(dim, 0, 4)
        out[f"ag{dim}"] = ring_all_gather(blk, mesh=mesh, axis_name="model",
                                          dim=dim).numpy()
    w = torch.linspace(-1, 1, 12 * 5).reshape(12, 5)
    x_blk = full[rank, :3, :].reshape(3, 6)
    out["agmm"] = allgather_matmul(x_blk, w, mesh=mesh,
                                   axis_name="model").numpy()
    # the port's collectives over (model, data), model major: the group's
    # ranks are [0, 2, 1, 3], an order torch's own is not
    from flexflow_tpu_torch.parallel import spmd

    group = mesh.group(("model", "data"))
    ints = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) * (rank + 1)
    out["order"] = (group.ranks, group.order, group.index)
    out["spmd_ag"] = spmd.all_gather(ints[:2], group, 0).numpy()
    out["spmd_rs"] = spmd.reduce_scatter(ints, group, 0).numpy()
    out["spmd_ar"] = spmd.all_reduce(ints, group).numpy()
    out["spmd_sync"] = spmd.sync_grad(ints, group, 0).numpy()
    return out


def test_ring_collectives_and_dtensor_bridge_match_plain():
    """The rings against their plain versions, and the port's own
    collectives (the executor's placement engine, which stands in for
    DTensor) over a group in an order of its own."""
    import torch

    outs = _spawn(collectives_job)
    full = torch.arange(4 * 12 * 6, dtype=torch.float32).reshape(
        4, 12, 6) / 7.0
    coords = {r: (r // 2, r % 2) for r in range(WORLD)}  # (data, model)
    base = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    total_ints = base * sum(q + 1 for q in range(WORLD))
    for r, out in enumerate(outs):
        d, m = coords[r]
        peers = [q for q in range(WORLD) if coords[q][1] == m]  # data ring
        mates = [q for q in range(WORLD) if coords[q][0] == d]  # model ring
        total = sum(full[q] * (q + 1) for q in peers)
        w = torch.linspace(-1, 1, 12 * 5).reshape(12, 5)
        x_full = torch.cat([full[q, :3, :].reshape(3, 6) for q in mates], -1)
        np.testing.assert_array_equal(out["rs"],
                                      total[6 * d:6 * (d + 1)].numpy())
        for dim in (0, 1):
            want = torch.cat([full[q].narrow(dim, 0, 4) for q in mates], dim)
            np.testing.assert_array_equal(out[f"ag{dim}"], want.numpy())
        np.testing.assert_allclose(out["agmm"], (x_full @ w).numpy(),
                                   **F32_TOL)
        ranks, order, index = out["order"]
        assert ranks == [0, 2, 1, 3] and order is not None
        assert index == ranks.index(r)
        np.testing.assert_array_equal(out["spmd_ag"], torch.cat(
            [base[:2] * (q + 1) for q in ranks]).numpy())
        np.testing.assert_array_equal(
            out["spmd_rs"], total_ints[2 * index:2 * index + 2].numpy())
        np.testing.assert_array_equal(out["spmd_ar"], total_ints.numpy())
        np.testing.assert_array_equal(out["spmd_sync"], total_ints.numpy())


# ------------------------------------------------------------ parity


def test_dp4_and_megatron_mlps_match_jax():
    """dp 4 (Adam, shuffled) and (2, 2, 1, 1) megatron (SGD): the port
    from the JAX model's initial weights ends where JAX ends, every rank
    holding the same weights; the counters are the JAX package's (summed
    over the data ranks)."""
    cases = [("wu", (4, 1, 1, 1), "adam", None, True),
             ("tp", (2, 2, 1, 1), "sgd", "megatron", False)]
    ref, jobs = [], []
    for kind, mesh, opt, strat, shuffle in cases:
        init, final, counters, _ = jax_run(kind, mesh, opt=opt,
                                           strategy=strat, shuffle=shuffle)
        ref.append((final, counters))
        jobs.append(dict(kind=kind, mesh=mesh, opt=opt, strategy=strat,
                         shuffle=shuffle, init=init,
                         argv=["--weight-update-sharding=off"]))
    outs = _spawn(run_jobs, jobs)
    for i, (final, counters) in enumerate(ref):
        runs = [o[i] for o in outs]
        assert_ranks_agree(runs)
        for k, want in final.items():
            np.testing.assert_allclose(runs[0]["params"][k], want,
                                       **F32_TOL, err_msg=f"case {i} {k}")
        got = runs[0]["counters"]
        assert got["train_all"] == counters["train_all"] == 128
        assert got["train_correct"] == counters["train_correct"]
        np.testing.assert_allclose(got["sparse_cce_loss"],
                                   counters["sparse_cce_loss"], rtol=2e-5)
    # the megatron run really sharded fc1 over `model`
    assert runs[0]["local"]["fc1.kernel"] == (64 * 128 // 2, 64 * 128)


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_stage2_and_stage3_are_bit_equal_to_replicated(opt):
    """2 shuffled epochs at dp 4 and at (2, 2, 1, 1) under megatron: the
    stage-2 and stage-3 trajectories equal the replicated one bit for bit
    (masters, slots, counters, step), and at rest each rank holds 1/dp of
    every shardable master and slot (stage 2 and 3 alike: the masters are
    the weights stage 3 keeps at rest)."""
    jobs = []
    for mesh, strat in (((4, 1, 1, 1), None), ((2, 2, 1, 1), "megatron")):
        for mode in ("off", "stage2", "stage3"):
            jobs.append(dict(kind="wu", mesh=mesh, opt=opt, strategy=strat,
                             argv=[f"--weight-update-sharding={mode}"]))
    outs = _spawn(run_jobs, jobs)
    for r in range(WORLD):
        runs = outs[r]
        for base in (0, 3):
            rep, s2, s3 = runs[base:base + 3]
            assert rep["update"]["enabled"] is False
            assert s2["update"] == {"enabled": True, "stage": 2,
                                    "shards": 4 if base == 0 else 2}
            assert s3["update"]["stage"] == 3
            assert_bit_equal(rep, s2, f"rank {r} mesh {base} stage 2")
            assert_bit_equal(rep, s3, f"rank {r} mesh {base} stage 3")
            dp = 4 if base == 0 else 2
            assert s3["gathered"] == s2["gathered"] == rep["gathered"]
            for k, (local, whole) in s3["local"].items():
                rk = rep["local"][k]
                # replicated: the compute block; sharded: 1/dp of it
                assert local * dp == rk[0], (k, local, rk)
                assert s2["local"][k][0] == local


def test_parallel_op_builders_reshard_as_jax():
    """repartition / combine give JAX's partition specs on (2, 2, 1, 1)
    and train to JAX's weights."""
    init, final, _, specs = jax_run("rp", (2, 2, 1, 1), opt="sgd",
                                    shuffle=False)
    assert specs["rp"] == ("data", "model") and specs["cb"] == ("data",)
    outs = _spawn(run_jobs, [dict(kind="rp", mesh=(2, 2, 1, 1), opt="sgd",
                                  init=init, shuffle=False,
                                  argv=["--weight-update-sharding=off"])])
    run = outs[0][0]
    assert run["specs"]["rp"] == specs["rp"]
    assert run["specs"]["cb"] == specs["cb"]
    assert_ranks_agree([o[0] for o in outs])
    for k, want in final.items():
        np.testing.assert_allclose(run["params"][k], want, **F32_TOL,
                                   err_msg=k)


def granular_job(rank) -> dict:
    """eval, the granular forward/backward/update and the data loader on
    dp 4 (stage 2), each against the same model on one rank (a mesh of
    one device in this rank) from the same weights."""
    import torch

    from flexflow_tpu_torch import load_params

    x, y = data("wu")
    out = {}
    dp = build_mlp("flexflow_tpu_torch", "wu", (4, 1, 1, 1),
                   ["--weight-update-sharding=stage2"])
    one = build_mlp("flexflow_tpu_torch", "wu", (1, 1, 1, 1))
    load_params(one, {n: {k: dp.get_weight(n, k) for k in ws}
                      for n, ws in dp._params.items()})
    for name, ff in (("dp", dp), ("one", one)):
        m = ff.eval(x, y)
        ff.start_batch(x[:8], y[:8])
        logits = ff.forward().detach().numpy().copy()
        loss = float(ff.backward())
        ff.update()
        out[name] = dict(eval=(m.train_all, m.train_correct,
                               m.get_mean_loss()),
                         logits=logits, loss=loss,
                         fc1=ff.get_weight("fc1", "kernel").copy())
    loader = dp.create_data_loader(dp._input_tensors[0], x)
    out["shard"] = loader.next_batch_sharded().numpy()
    return out


def refusals_job(rank):
    from flexflow_tpu_torch.entry import dryrun_multichip

    from flexflow_tpu_torch import distributed as fdist
    from flexflow_tpu_torch.parallel import Strategy

    out = {"loss": dryrun_multichip(WORLD, device="cpu")[0],
           "granular": granular_job(rank)}
    # rank 0's payload (or its failure) reaches every rank
    out["bcast"] = fdist.broadcast_json({"from": rank} if rank == 0
                                        else None)
    out["gathered"] = fdist.gather_json({"rank": rank})
    plan = Strategy()
    plan.set_output("fc1", 0, (("data",), ()))
    out["plan"] = fdist.run_search_on_host0(
        lambda: plan if fdist.is_coordinator() else None)
    try:
        fdist.run_search_on_host0(lambda: 1 / 0)
    except RuntimeError as e:
        out["search_error"] = str(e)
    import tempfile

    from flexflow_tpu_torch import telemetry

    with tempfile.TemporaryDirectory() as d:
        session = telemetry.TelemetrySession(d)
        out["merged"] = fdist.gather_merged_snapshot(session)
        out["local"] = session.collect_snapshot()
        session.close()
    fdist.barrier()
    for name, mesh, argv in (
            ("too_big", (8, 1, 1, 1), ["--weight-update-sharding=off"]),
            ("search", (4, 1, 1, 1), ["--budget", "5"]),
            ("unforced", (4, 1, 1, 1), []),
            ("smaller", (2, 1, 1, 1), ["--weight-update-sharding=off"])):
        try:
            build_mlp("flexflow_tpu_torch", "wu", mesh, argv)
            out[name] = "built"
        except Exception as e:  # the message names what refused
            out[name] = f"{type(e).__name__}: {e}"
    return out


def test_dryrun_granular_api_and_refusals_on_four_ranks():
    outs = _spawn(refusals_job)
    assert len({o["loss"] for o in outs}) == 1
    assert np.isfinite(outs[0]["loss"])
    x, _ = data("wu")
    for r, o in enumerate(outs):
        g = o["granular"]
        dp, one = g["dp"], g["one"]
        assert dp["eval"][:2] == one["eval"][:2]
        np.testing.assert_allclose(dp["eval"][2], one["eval"][2], rtol=2e-5)
        np.testing.assert_allclose(dp["logits"], one["logits"], **F32_TOL)
        np.testing.assert_allclose(dp["loss"], one["loss"], rtol=2e-5)
        np.testing.assert_allclose(dp["fc1"], one["fc1"], **F32_TOL)
        np.testing.assert_array_equal(g["shard"], x[2 * r:2 * r + 2])
    for o in outs:
        assert o["bcast"] == {"from": 0}
        assert o["gathered"] == [{"rank": r} for r in range(WORLD)]
        assert o["plan"] == {"fc1": {"outputs": {0: (("data",), ())},
                                     "weights": {}}}
        assert "search failed on process 0: ZeroDivisionError" \
            in o["search_error"]
        # every rank gets the same merge of the four ranks' snapshots
        assert o["merged"] == outs[0]["merged"]
        assert set(o["merged"]) == set(o["local"])
        assert o["too_big"].startswith(
            "ValueError: mesh needs 8 devices but only 4 available")
        # the Unity search and the priced update decision (A7) build
        assert o["search"] == "built" and o["unforced"] == "built"
        assert o["smaller"].startswith("ValueError: mesh of 2 devices")
    # the dry run's fused-MoE leg (dp 2 x ep 2 on the 4 ranks): finite,
    # the same loss on every rank, and the one-rank step's
    from flexflow_tpu_torch.entry import _moe_step, dryrun_multichip

    legs = dryrun_multichip(WORLD, legs=("lm", "moe"), device="cpu")
    moe = [l[1] for l in legs]
    assert np.isfinite(moe).all() and len(set(moe)) == 1, moe
    np.testing.assert_allclose(moe[0], _moe_step(1, 1, 4, "cpu"),
                               rtol=1e-5)


def _abort_on_rank_one(rank):
    import os

    if rank == 1:
        os.abort()  # a native abort: the rank dies with no result
    return rank


def test_spawn_reports_a_rank_that_died():
    """A rank killed outright (as gloo's std::terminate does) fails the
    spawn at once, naming it, instead of waiting out the time limit."""
    import time

    from flexflow_tpu_torch.distributed import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited with code"):
        spawn(_abort_on_rank_one, 2, timeout=120)
    assert time.monotonic() - t0 < 60


def mesh_smoke_job(rank):
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=512, hidden_size=256, num_heads=4,
                             num_layers=2, sequence_length=128)
    seq_lm = TransformerLMConfig(vocab_size=512, hidden_size=256,
                                 num_heads=4, num_layers=2,
                                 sequence_length=512)
    pipe_lm = TransformerLMConfig(vocab_size=512, hidden_size=256,
                                  num_heads=4, num_layers=4,
                                  sequence_length=128)
    return chip_smoke.mesh_check("cpu", lm, steps=4, captured=False,
                                 search=True, seq_lm=seq_lm,
                                 pipe_lm=pipe_lm)


def mesh_resume_job(rank):
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=512, hidden_size=256, num_heads=4,
                             num_layers=2, sequence_length=128)
    return chip_smoke.mesh_resume_check("cpu", lm, steps=2, captured=False)


def test_mesh_resume_leg_passes_on_four_cpu_ranks():
    """Phase 19's torchrun leg (`chip_smoke.mesh_resume_check`) on 4 gloo
    ranks, at 2 layers of width 256: saved at dp 4 under stage 3 (each
    rank holding 1/4 of a master), restored at dp 2 x tp 2 and on one
    rank through the fftrans gate (the transition priced, no error) with
    the masters bit-equal to the saved ones, the next 2 steps held to one
    rank's by MESH_TOL; a SIGTERM to rank 0 alone stops every rank at
    step 3 with one final snapshot."""
    outs = _spawn(mesh_resume_job)
    for o in outs:
        assert o["failures"] == [], o["failures"]
        c = o["checks"]
        assert c["restored one rank"]["bitwise_equal"]
        assert c["restored dp 2 x tp 2"]["bitwise_equal"]
        for name in ("one rank", "dp 2 x tp 2"):
            t = c[f"transition {name}"]
            assert t["set"] and t["errors"] == 0 and t["predicted_s"] > 0
        assert c["dp 2 x tp 2 after restore"]["within_tolerance"]
        assert c["sigterm to rank 0"]["stopped"] == [3] * WORLD
        local, whole = o["numbers"]["local_of_whole"]
        assert o["numbers"]["saved_stage"] == 3 and local * 4 == whole


def mesh_barrier_job(rank):
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=512, hidden_size=256, num_heads=4,
                             num_layers=2, sequence_length=128)
    return chip_smoke.mesh_barrier_check("cpu", lm)


def test_mesh_barrier_leg_passes_on_four_cpu_ranks():
    """Phase 21(e)'s torchrun leg (`chip_smoke.mesh_barrier_check`) on 4
    gloo ranks: --spmd-barrier at dp 2 x tp 2 agrees on every rank; a
    numerics policy planted on rank 2 alone raises SPMDDivergenceError
    on every rank (rank 2 naming the component, the others in lockstep)
    and no rank hangs."""
    outs = _spawn(mesh_barrier_job)
    for o in outs:
        assert o["failures"] == [], o["failures"]
        assert o["checks"]["lockstep"] == {"status": "ok",
                                           "one_fingerprint": True}
        raised = o["checks"]["planted"]["raised"]
        assert raised["peer_mismatch"] is (o["rank"] != 2)


def test_mesh_smoke_checks_pass_on_four_cpu_ranks():
    """The mesh smoke's checks (`chip_smoke.mesh_check`: phase 16 on one
    card, the whole run under torchrun on N cards) on 4 gloo ranks, its
    CPU rehearsal at 2 layers of width 256: dp 4, dp 2 x tp 2 and tp 4
    held to one rank in f32 and bf16 by each master's change and each
    step's loss, stages 2 and 3 bit-equal to dp 4, the flash kernels'
    heads cut by tp; in bf16 also dp 4 with the update decision priced
    and the Unity search's plan over the mesh's factorizations (rank 0
    searches and broadcasts), each held to one rank; then, in both
    dtypes, the LM at seq 512 on sp 4 (ring attention, the sequence
    split four ways) held to one rank with flash attention, and the
    pipelined LM at 4 layers on pp 4 and dp 2 x pp 2 held to its one-rank
    run."""
    outs = _spawn(mesh_smoke_job)
    for o in outs:
        assert o["failures"] == [], o["failures"]
        names = [(r["name"], r["dtype"]) for r in o["runs"]]
        assert ("dp 4 stage 3", "bf16") in names and ("tp 4", "f32") in names
        for key in ("dp 4 priced bf16", "searched bf16"):
            assert o["checks"][key]["within_tolerance"], o["checks"][key]
        runs = {r["name"]: r for r in o["runs"]}
        assert runs["searched"]["plan_source"] == (
            "search" if o["rank"] == 0 else "broadcast")
        first = next(r for r in outs[0]["runs"] if r["name"] == "searched")
        assert (runs["searched"]["plan"], runs["searched"]["mesh"]) == (
            first["plan"], first["mesh"])
        assert runs["dp 4 priced"]["update_sharding"]["reason"] in (
            "replicated_cheaper", "overlap_bound", "memory_bound")
        assert {r["name"]: r["flash_heads"] for r in o["runs"]}["tp 4"] \
            == [1]
        for key in ("dp 4 f32", "tp 4 f32", "dp 2 x tp 2 bf16"):
            assert o["checks"][key]["within_tolerance"], o["checks"][key]
        # the sequence-parallel LM (ring attention) and the pipelined LM
        # held to their one-rank runs in both dtypes
        for name in ("sp 4", "pp 4", "dp 2 x pp 2"):
            for dtype in ("f32", "bf16"):
                c = o["checks"][f"{name} {dtype}"]
                assert c["within_tolerance"], (name, dtype, c)
        assert {r["name"]: r["flash_heads"] for r in o["runs"]}["sp 4"] \
            == [4]
        assert "ring" in runs["sp 4"]["rules"], runs["sp 4"]["rules"]
        assert "pipe" in runs["pp 4"]["rules"], runs["pp 4"]["rules"]


def rank_job(rank):
    return rank


def test_spawn_moves_past_a_taken_port(monkeypatch):
    """A rendezvous port another process took between `free_port` and
    the group's start (parallel test workers race for them) starts the
    ranks again on a fresh port."""
    import socket

    from flexflow_tpu_torch import distributed as D

    held = socket.socket()
    held.bind(("localhost", 0))
    held.listen()
    ports = iter([held.getsockname()[1], D.free_port()])
    monkeypatch.setattr(D, "free_port", lambda: next(ports))
    try:
        assert D.spawn(rank_job, 2, timeout=120) == [0, 1]
    finally:
        held.close()
