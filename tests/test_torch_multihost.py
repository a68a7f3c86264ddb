"""Multi-node training over the `dcn` axis in the port, on the CPU: the
twin of `tests/test_multihost.py`, on gloo worlds launched as emulated
torchrun nodes (`distributed.spawn(..., nodes=N)`: every rank gets its
node's LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK and GROUP_WORLD_SIZE, as
`torchrun --nnodes N --nproc-per-node world/N` gives them).

- `test_train_on_dcn_mesh`: 8 ranks as 2 nodes x 4 with the JAX test's
  flags, model and data: the (dcn 2, data 2, model 2) mesh, the batch
  over ("dcn", "data"), the search on rank 0 broadcast to every rank,
  accuracy >= 0.85. The port's plan is the JAX package's on its virtual
  8-device mesh, and the port from the JAX model's initial weights ends
  where the JAX model ends (unshuffled, float32, rtol = atol = 2e-5: the
  tolerance of `test_torch_distributed.py`'s rank-count parity tests).
- The search's pricing keeps `model` traffic off `dcn` on the port's
  H100 machine model (and on the TPU one, as the JAX test has it).
- A node's ranks take its cards by LOCAL_RANK, not by global rank
  (without it, the global rank wrapped onto the node's cards, in
  `initialize` and in FFConfig alike), and `workers_per_node` is the
  node's size.
- The nodes leg of `chip_smoke.py` rehearsed as the card runs it
  (`--launch-nodes --device cpu`: two real torchrun nodes of 2 gloo
  ranks, c10d on localhost, each rank's world joined by its first
  FFConfig) at a small LM, both launches: (a) dcn x dp, (b) dcn x tp,
  (c) the search, each held to one rank by chip_smoke's MESH_TOL, and (d) a checkpointed run stopped
  after step 4 and resumed by a second launch, bit-equal to 6
  uninterrupted steps, with rank 0 alone committing and
  `--checkpoint-every-seconds` refused.
"""

import json
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGV = ["--mesh", "2,2,2,1,1", "--budget", "4", "--enable-parameter-parallel"]
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # test_torch_distributed.F32_TOL


def _model(pkg):
    """The JAX test's MLP under its flags."""
    sys.argv = ["t", *ARGV]
    mod = __import__(pkg)
    cfg = (mod.FFConfig(device="cpu") if pkg == "flexflow_tpu_torch"
           else mod.FFConfig())
    cfg.batch_size = 32
    ff = mod.FFModel(cfg)
    x = ff.create_tensor((32, 32))
    t = ff.dense(x, 64, mod.ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 64, mod.ActiMode.AC_MODE_RELU, name="fc2")
    ff.softmax(ff.dense(t, 10, name="out"), name="sm")
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.1),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[mod.MetricsType.METRICS_ACCURACY])
    return ff


def _data():
    rs = np.random.RandomState(0)
    c = rs.randn(10, 32) * 3
    y = rs.randint(0, 10, 1024)
    xs = (c[y] + rs.randn(1024, 32)).astype(np.float32)
    return xs, y.reshape(-1, 1).astype(np.int32)


def _plan(ff, pkg) -> str:
    par = __import__(f"{pkg}.parallel", fromlist=["x"])
    return json.dumps(par.Strategy(ff._strategy or {}).to_json(),
                      sort_keys=True)


def _input_axes(ff):
    node = next(n for n in ff.graph.topo_order()
                if n.op_type.name == "OP_INPUT")
    return tuple(node.outputs[0].axis_assignment[0])


def dcn_job(rank, init):
    import os

    from flexflow_tpu_torch import load_params

    xs, ys = _data()
    ff = _model("flexflow_tpu_torch")
    out = {"mesh": dict(ff.mesh.shape), "input_axes": _input_axes(ff),
           "plan": _plan(ff, "flexflow_tpu_torch"),
           "source": ff._plan_source,
           "workers_per_node": ff.config.workers_per_node,
           "node": int(os.environ["GROUP_RANK"])}
    ff.fit(xs, ys, epochs=2, verbose=False)
    out["accuracy"] = ff.get_perf_metrics().get_accuracy()
    # the parity run: the JAX model's initial weights, unshuffled
    ff = _model("flexflow_tpu_torch")
    load_params(ff, init)
    ff.fit(xs, ys, epochs=2, shuffle=False, verbose=False)
    out["final"] = {f"{n}.{k}": ff.get_weight(n, k).copy()
                    for n, ws in ff._params.items() for k in ws}
    return out


def test_train_on_dcn_mesh():
    """End-to-end: (dcn=2, data=2, model=2) over 2 nodes of 4 gloo ranks,
    batch sharded over (dcn, data), searched TP over `model`, converges;
    held to the JAX package's run of the same flags."""
    from flexflow_tpu_torch.distributed import spawn

    jff = _model("flexflow_tpu")
    assert dict(jff.mesh.shape)["dcn"] == 2
    jplan = _plan(jff, "flexflow_tpu")
    init = {n: {k: np.asarray(v) for k, v in ws.items()}
            for n, ws in jff._params.items()}
    xs, ys = _data()
    jff.fit(xs, ys, epochs=2, shuffle=False, verbose=False)
    want = {f"{n}.{k}": np.asarray(v) for n, ws in jff._params.items()
            for k, v in ws.items()}
    outs = spawn(dcn_job, 8, init, timeout=300, nodes=2)
    for rank, o in enumerate(outs):
        assert o["mesh"] == {"dcn": 2, "data": 2, "model": 2, "pipe": 1,
                             "seq": 1}
        assert o["input_axes"] == ("dcn", "data")
        assert o["node"] == rank // 4 and o["workers_per_node"] == 4
        assert o["source"] == ("search" if rank == 0 else "broadcast")
        # both packages' searches pick one plan: TP over `model`, never
        # a weight over `dcn`
        assert o["plan"] == jplan, rank
        assert o["accuracy"] >= 0.85, (rank, o["accuracy"])
        for k, v in want.items():
            np.testing.assert_allclose(o["final"][k], v, **F32_TOL,
                                       err_msg=f"rank {rank} {k}")
    plan = json.loads(jplan)["nodes"]
    assert plan["fc1"]["weights"]["kernel"] == [None, "model"]
    assert not any("dcn" in json.dumps(v["weights"]) for v in plan.values())


@pytest.mark.parametrize("chip", ["h100", "v5p"])
def test_search_avoids_tp_across_dcn(chip):
    """The cost model keeps `model`-axis traffic inside a node: the same
    all-reduce is far cheaper on `model` than over `dcn`, on the port's
    H100 (switch) model and on its TPU torus model alike."""
    from flexflow_tpu_torch.search.machine_model import (
        CHIPS,
        NVSwitchMachineModel,
        machine_model_for_mesh,
    )

    m = machine_model_for_mesh({"dcn": 2, "model": 4}, chip=CHIPS[chip],
                               num_hosts=2)
    assert isinstance(m, NVSwitchMachineModel) is (chip == "h100")
    assert m.axis_over_dcn == frozenset({"dcn"})
    nbytes = 64 * 1024 * 1024
    assert m.all_reduce(nbytes, "model") < m.all_reduce(nbytes, "dcn")
    # on the H100 the dcn axis is the card's 400 Gb/s NIC, NVLink inside
    if chip == "h100":
        assert m.all_reduce(nbytes, "dcn") > 5 * m.all_reduce(nbytes,
                                                              "model")


def test_node_env_lays_ranks_node_major():
    from flexflow_tpu_torch.distributed import node_env

    envs = [node_env(r, 8, 2) for r in range(8)]
    assert [e["LOCAL_RANK"] for e in envs] == list("01230123")
    assert [e["GROUP_RANK"] for e in envs] == list("00001111")
    assert {e["LOCAL_WORLD_SIZE"] for e in envs} == {"4"}
    assert {e["GROUP_WORLD_SIZE"] for e in envs} == {"2"}
    assert node_env(5, 8)["LOCAL_RANK"] == "5"  # one node: the rank
    with pytest.raises(ValueError, match="do not split"):
        node_env(0, 6, 4)


def cards_job(rank):
    import os

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.distributed import card_index

    sys.argv = ["t", "--nodes", "2"]
    cfg = FFConfig(device="cpu")
    out = {"card": card_index(2), "local": int(os.environ["LOCAL_RANK"]),
           "workers_per_node": cfg.workers_per_node,
           "mesh": list(cfg.mesh_shape().axis_sizes)}
    try:
        card_index(1)
        out["one_card"] = "taken"
    except RuntimeError as e:
        out["one_card"] = str(e)
    del os.environ["LOCAL_RANK"]  # a start without torchrun's variables
    out["wrapped"] = card_index(2)
    return out


def test_node_ranks_take_their_node_cards():
    """On 2 nodes of 2 ranks each, "cuda" is `cuda:LOCAL_RANK` of the
    node's visible cards (global ranks 2 and 3 take cards 0 and 1 of
    theirs), a rank past its node's cards is refused, and `--nodes 2`
    lays (dcn 2, data 2) from the node's size."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(cards_job, 4, timeout=120, nodes=2)
    assert [o["card"] for o in outs] == [0, 1, 0, 1]
    assert [o["local"] for o in outs] == [0, 1, 0, 1]
    assert {o["workers_per_node"] for o in outs} == {2}
    assert {tuple(o["mesh"]) for o in outs} == {(2, 2, 1, 1, 1)}
    assert outs[0]["one_card"] == outs[2]["one_card"] == "taken"
    for o in (outs[1], outs[3]):
        assert "LOCAL_RANK 1 has no card of its own" in o["one_card"]
    # without LOCAL_RANK the global ranks 2 and 3 wrap onto cards 0 and 1
    assert [o["wrapped"] for o in outs] == [0, 1, 0, 1]


def test_coordinator_start_and_config_pick_one_card(monkeypatch):
    """Without LOCAL_RANK (the `coordinator_address` start, the twin of
    `jax.distributed.initialize`), rank 5 of 8 on nodes of 4 cards:
    `initialize` makes cuda:1 current, and FFConfig's "cuda" resolves to
    that same card, by one rule (`card_index`)."""
    import types

    import torch

    from flexflow_tpu_torch import distributed as fd
    from flexflow_tpu_torch.config import resolve_device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    current = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.append(torch.device("cuda", d)
                                                 if isinstance(d, int)
                                                 else d))
    started = []
    monkeypatch.setattr(fd.dist, "init_process_group",
                        lambda *a, **k: started.append(k))
    fd.initialize("localhost:29500", num_processes=8, process_id=5)
    assert started[0]["rank"] == 5 and started[0]["world_size"] == 8
    monkeypatch.setattr(fd, "world_rank", lambda: 5)
    monkeypatch.setattr(fd, "process_count", lambda: 8)
    dev = resolve_device(types.SimpleNamespace(device="cuda"))
    assert current == [torch.device("cuda", 1)] * 2 and dev == current[0]


# ------------------------------------------------ chip_smoke's nodes leg


@pytest.fixture(scope="module")
def nodes_leg(tmp_path_factory):
    """`chip_smoke.py --launch-nodes --device cpu`: both launches of the
    nodes leg as two real torchrun nodes of 2 gloo ranks each, at the
    rehearsal LM; each rank's record of each launch."""
    import os
    import subprocess

    from flexflow_tpu_torch.distributed import child_env

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("nodes")
    p = subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py"),
         "--launch-nodes", "--device", "cpu", "--json",
         str(out / "nodes.json")],
        cwd=repo, env=dict(child_env(), PYTHONPATH=repo,
                           OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    verdict = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and verdict["ok"], p.stdout[-4000:]
    legs = {stage: [json.load(open(out / f"nodes_{legs}_rank{r}.json"))
                    ["nodes"] for r in range(4)]
            for stage, legs in (("train", "nodes"),
                                ("resume", "nodes-resume"))}
    # each launch's first FFConfig joined the two nodes' ranks in one
    # gloo world, node-major (ROADMAP C8: the script starts no group)
    for outs in legs.values():
        for r, o in enumerate(outs):
            assert (o["rank"], o["world"], o["backend"]) == (r, 4, "gloo")
            assert (o["layout"]["node"], o["layout"]["local_rank"]) == \
                divmod(r, 2)
    return legs


def test_nodes_leg_trains_over_dcn_as_one_rank(nodes_leg):
    """(a) dcn 2 x dp 2 with the batch over (dcn, data), (b) dcn 2 x tp
    2, in f32 and bf16, and (c) the search on dcn 2 x model 2 (rank 0
    searches, the others take its plan), each held to one rank; every
    model group inside one node, no weight over dcn."""
    outs = nodes_leg["train"]
    for o in outs:
        assert o["failures"] == [], o["failures"]
        lay = o["layout"]
        assert (lay["node"], lay["local_rank"]) == divmod(o["rank"], 2)
        runs = {(r["name"], r["dtype"]): r for r in o["runs"]}
        for dtype in ("f32", "bf16"):
            a = runs[("(a) dcn 2 x dp 2", dtype)]
            assert a["mesh"] == [2, 2, 1, 1, 1]
            assert a["batch_axes"] == ["dcn", "data"]
            b = runs[("(b) dcn 2 x tp 2", dtype)]
            assert b["mesh"] == [2, 1, 2, 1, 1] and b["attn_tp"] == 2
            assert b["model_groups"] == [[0, 1], [2, 3]]
            for name in ("(a) dcn 2 x dp 2", "(b) dcn 2 x tp 2"):
                assert o["checks"][f"{name} {dtype}"]["within_tolerance"]
        c = runs[("(c) dcn 2 searched", "bf16")]
        assert o["checks"]["(c) dcn 2 searched bf16"]["within_tolerance"]
        assert c["plan_source"] == ("search" if o["rank"] == 0
                                    else "broadcast")
        assert c["plan"] == next(
            r for r in outs[0]["runs"]
            if r["name"] == "(c) dcn 2 searched")["plan"]
        assert o["checks"]["plans agree"] == {"differ": []}


def test_nodes_leg_checkpoints_resume_bit_equal_with_one_committer(
        nodes_leg):
    """(d): saves every 2 steps on 2 nodes, the first launch stopped after
    step 4 with rank 0 alone committing steps 2 and 4; the second launch
    resumes at step 4 and runs steps 5 and 6, its masters and losses
    bit-equal to the 6 uninterrupted steps', rank 0 alone committing step
    6; --checkpoint-every-seconds refused with the JAX package's
    warning."""
    for o in nodes_leg["train"]:
        assert o["failures"] == [], o["failures"]
        d = o["checks"]["(d) first launch"]
        assert d["stopped"]["killed"] and d["stopped"]["py_step"] == 4
        assert d["stopped"]["commits"] == [
            ["step_00000002", "step_00000004"], [], [], []]
        assert d["seconds_refused"]["every_t_seconds"] == 0.0
        assert "not multi-host safe" in d["seconds_refused"]["warning"][0]
    for o in nodes_leg["resume"]:
        assert o["failures"] == [], o["failures"]
        d = o["checks"]["(d) resumed"]
        assert d["bitwise_equal"] and d["steps"] == 2 and d["py_step"] == 6
        assert d["losses"] == d["reference_losses"]
        assert d["commits"] == [["step_00000006"], [], [], []]


def sync_job(rank):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from flexflow_tpu_torch import machine as tm
    from flexflow_tpu_torch.parallel.ops import grad_sync_axes
    from flexflow_tpu_torch.parallel.spmd import sync_grad

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    mesh = tm.build_mesh(tm.MeshShape((2, 2, 1, 1, 1), tm.MULTIHOST_AXES))
    axes = grad_sync_axes(("dcn", "data"), ())
    group = mesh.group(axes)
    g = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) * (rank + 1)
    with Ops() as ops:
        got = sync_grad(g, group, 0)
    return {"axes": axes, "order": group.order, "ops": sorted(ops.seen),
            "got": got.numpy()}


def test_dcn_grad_sync_permutes_chunks_without_a_host_index():
    """C12: on a (dcn, data) mesh the gradient sync's group is sorted
    ("data", "dcn"), data major, so torch's rank order differs from the
    group's and the reduce-scatter and all-gather permute their chunks.
    They do so by stacking rows (device ops only), with no list index,
    which would copy an index from the host (a CUDA-graph capture refuses
    that: every captured step over --nodes failed on the cards). The
    sum is every rank's."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(sync_job, 4, timeout=120, nodes=2)
    want = np.arange(24, dtype=np.float32).reshape(8, 3) * (1 + 2 + 3 + 4)
    for o in outs:
        assert o["axes"] == ("data", "dcn") and o["order"] == [0, 2, 1, 3]
        assert not any(op.startswith("aten.index.") for op in o["ops"]), \
            o["ops"]
        np.testing.assert_array_equal(o["got"], want)
