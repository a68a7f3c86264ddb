"""ffcheck for the PyTorch port: standalone static plan verification —
the CI gate. Twin of `scripts/ffcheck.py`.

Three jobs (docs/analysis.md):

1. **Six-source sweep** (`--sources all`, the default): compile one
   small transformer LM through every plan-adoption path — search,
   cache, checkpoint, import, manual, default — and assert the port's
   ffcheck compile gate ran on each with ZERO errors and ran the ffsan
   passes (dtype_flow, spmd_uniformity).

2. **Corruption self-test** (`--self-test`, also on by default): inject
   each corruption class into a real plan and assert the verifier
   reports exactly that finding class — axis reuse, a dropped parallel
   op (implicit reshard), an oversharded dim, a non-bijective ring
   permutation, a dtype mismatch across a parallel edge, an fp32-master
   bypass, a low-precision accumulation (graph-level), and a diverged
   SPMD fingerprint. The source-level classes (donated-then-reused
   buffer, coordinator-only collective, low-precision accumulation,
   host-divergent branch) plant the PORT's form of each hazard and must
   trip the port's lint rule of the same class.

3. **Smoke suites** (`--suite longcontext`, `--suite wus`): the ring
   plan over `seq` (the bijection check must see the sp plan's rings)
   and the memory-capped dp plan whose update sharding the decision
   turned on (the OOM rule must not fire on it).

The mesh is the `torch.distributed` world's (`torchrun
--nproc-per-node N ffcheck_torch.py`): the sweep compiles on the JAX CI
mesh (2, 4, 1, 1) when the world holds 8 ranks, else on the world laid
over `data`. The self-test's plan mutations need a sharded mesh: a plan
compiled on a smaller world is placed on the CI mesh (the ring on
2,1,1,2) as a mesh of absent ranks, as the port's analysis tests do (the passes
read only the mesh's axis sizes). The suites compile on their own
meshes and need a world of 4 ranks. The port searches only a mesh of
two or more devices, so on one rank the `search`, `cache` and
`checkpoint` sources are skipped under `--sources all` (and reported
so) and fail when named.

Runs on the card by default; `--device cpu` runs on the CPU. Writes a
machine-readable report with `--report OUT.json` (rank 0; on failure
too). Exits nonzero on any violated assertion.

Usage: python ffcheck_torch.py [--report OUT.json] [--device cpu]
       [--sources all|none|s1,s2,...] [--self-test] [--no-self-test]
       [--suite longcontext] [--suite wus]
"""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

ALL_SOURCES = ("search", "cache", "checkpoint", "import", "manual",
               "default")
AXES = ("data", "model", "pipe", "seq")
CI_MESH = (2, 4, 1, 1)
RING_MESH = (2, 1, 1, 2)
# the sources whose plan the search path finds or restores (the port
# searches a mesh of two or more devices only)
SEARCHED = {"search", "cache", "checkpoint"}


class FFCheckFailure(SystemExit):
    """A violated assertion: exits 1 (after the report is written)."""


# progressive report state: fail() flushes whatever has been collected so
# far, so the CI artifact exists (with the failure recorded) for red runs
_REPORT: dict = {}
_OPTS: dict = {}


def _write_report():
    from flexflow_tpu_torch.distributed import is_coordinator

    path = _OPTS.get("report", "")
    if not path or not is_coordinator():
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_REPORT, f, indent=1)
    print(f"ffcheck: report written to {path}")


def fail(msg: str):
    print(f"ffcheck: FAIL: {msg}", file=sys.stderr)
    _REPORT["failure"] = msg
    _write_report()
    raise FFCheckFailure(1)


def _lm(config, seq=16, ring=False):
    from flexflow_tpu_torch import FFModel
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    ff = FFModel(config)
    cfg = TransformerLMConfig(
        vocab_size=64, hidden_size=32, num_heads=2, num_layers=1,
        sequence_length=seq,
        attention_impl="ring" if ring else "xla")
    build_transformer_lm(ff, cfg, batch_size=4)
    return ff, cfg


def _config(**kw):
    from flexflow_tpu_torch import FFConfig

    cfg = FFConfig(device=_OPTS["device"])
    cfg.mesh_axis_sizes = tuple(_OPTS["mesh"])
    cfg.batch_size = 4
    cfg.search_budget = 6
    cfg.enable_parameter_parallel = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _compile(ff):
    from flexflow_tpu_torch import LossType, SGDOptimizer

    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _codes(result) -> list:
    return sorted({f"{f.severity}:{f.code}" for f in result.findings})


def _check_clean(ff, source: str) -> dict:
    from flexflow_tpu_torch.distributed import is_coordinator

    res = getattr(ff, "_analysis", None)
    if res is None:
        fail(f"source {source}: compile gate did not run "
             f"(model._analysis is None)")
    # a searched (or cached) plan is found on rank 0 and reaches the
    # other ranks as a broadcast
    want = (source if is_coordinator() or source not in SEARCHED
            else "broadcast")
    if ff._plan_source != want:
        fail(f"expected plan_source {want!r}, got "
             f"{ff._plan_source!r}")
    errs = res.errors()
    if errs:
        fail(f"source {source}: plan verification errors: "
             f"{[str(f) for f in errs[:5]]}")
    missing = {"dtype_flow", "spmd_uniformity"} - set(res.passes_run)
    if missing:
        fail(f"source {source}: ffsan passes did not run: "
             f"{sorted(missing)}")
    print(f"ffcheck: source {source:10s} — clean "
          f"({len(res.findings)} finding(s), "
          f"{res.elapsed_s * 1e3:.0f} ms)")
    entry = {"plan_source": source, **res.summary(),
             "elapsed_s": res.elapsed_s, "codes": _codes(res)}
    _REPORT.setdefault("sources", []).append(entry)
    return entry


def run_sources(workdir: str, sources) -> list:
    from flexflow_tpu_torch.parallel.strategies import (
        Strategy,
        megatron_transformer,
    )

    out = []
    plan_path = os.path.join(workdir, "plan.json")
    if int(np.prod(_OPTS["mesh"])) == 1:
        # the port searches only a mesh of more than one device
        if _OPTS["sources_named"] and SEARCHED & set(sources):
            fail(f"sources {sorted(SEARCHED & set(sources))} need a mesh "
                 f"of 2+ ranks (torchrun --nproc-per-node N); this one "
                 f"is {_OPTS['mesh']}")
        for src in sorted(SEARCHED & set(sources)):
            print(f"ffcheck: source {src:10s} — skipped (a search needs a "
                  f"mesh of 2+ ranks; this one is {_OPTS['mesh']})")
            _REPORT.setdefault("sources", []).append(
                {"plan_source": src, "skipped": "one-device mesh"})
        sources = [s for s in sources if s not in SEARCHED]

    if "search" in sources or "import" in sources:
        ff = _compile(_lm(_config())[0])
        if "search" in sources:
            out.append(_check_clean(ff, "search"))
        Strategy(ff._strategy or {}).save(plan_path)

    if "cache" in sources:
        ws = os.path.join(workdir, "warmstart")
        _compile(_lm(_config(warmstart_dir=ws))[0])  # cold: populates
        ff = _compile(_lm(_config(warmstart_dir=ws))[0])  # warm: hit
        out.append(_check_clean(ff, "cache"))

    if "checkpoint" in sources:
        ck = os.path.join(workdir, "ckpt")
        ff, cfg = _lm(_config(checkpoint_dir=ck, checkpoint_every=1,
                              auto_resume=True))
        _compile(ff)
        rs = np.random.RandomState(0)
        n = 8
        X = {"tokens": rs.randint(
                0, cfg.vocab_size,
                (n, cfg.sequence_length)).astype(np.int32),
             "positions": np.tile(np.arange(cfg.sequence_length,
                                            dtype=np.int32), (n, 1))}
        Y = rs.randint(0, cfg.vocab_size,
                       (n, cfg.sequence_length, 1)).astype(np.int32)
        ff.fit(X, Y, epochs=1, batch_size=4, shuffle=False,
               verbose=False)
        ff2 = _compile(_lm(_config(checkpoint_dir=ck, checkpoint_every=1,
                                   auto_resume=True))[0])
        out.append(_check_clean(ff2, "checkpoint"))

    if "import" in sources:
        ff = _compile(_lm(_config(import_strategy_file=plan_path))[0])
        out.append(_check_clean(ff, "import"))

    if "manual" in sources:
        ff, _ = _lm(_config(search_budget=0,
                            enable_parameter_parallel=False))
        ff.set_strategy(megatron_transformer(ff))
        _compile(ff)
        out.append(_check_clean(ff, "manual"))

    if "default" in sources:
        ff = _compile(_lm(_config(search_budget=0,
                                  enable_parameter_parallel=False))[0])
        out.append(_check_clean(ff, "default"))
    return out


# ---------------------------------------------------------------- fuzzer
# the source-level classes, each planted in the port's form of its hazard

_DONATED_SNIPPET = """
def fit_loop(self, batch):
    before = self._params["head"]
    new = step_fn(self._params, self._state, self._opt_slots,
                  self._step, self._counters, batch, self._rng)
    delta = self._params["head"]["kernel"] - before["kernel"]
    return new, float(delta.sum())
"""

_COORD_SNIPPET = """
def save_plan(payload):
    from flexflow_tpu_torch.distributed import barrier, is_coordinator
    if is_coordinator():
        write(payload)
        barrier("plan-committed")
"""

_LP_ACCUM_SNIPPET = """
def bad_loss(logits):
    import torch
    return torch.sum(logits.to(torch.bfloat16)) / logits.shape[0]
"""

_DIVERGENT_SNIPPET = """
def maybe_recompile(model, fn):
    import time
    if time.perf_counter() - model.t0 > 60.0:
        return model.executor._compiled("step", fn, held=(0,))
    return fn
"""


def _placed(ff, mesh, strategy=None):
    """`ff` as the passes see it on `mesh`: itself where it was compiled
    on that mesh, else its graph placed on a mesh of absent ranks of that
    shape under `strategy` (or its own plan)."""
    from flexflow_tpu_torch.machine import Mesh, MeshShape

    if tuple(ff.mesh.shape.values()) == tuple(mesh):
        return ff
    ff.mesh = Mesh(MeshShape(tuple(mesh), AXES), ff.mesh.device)
    if strategy is not None:
        ff._strategy = getattr(strategy, "overrides", strategy)
    ff._assign_strategy()
    return ff


def _world_fits(mesh) -> bool:
    from flexflow_tpu_torch.distributed import world_size

    return int(np.prod(mesh)) == world_size()


def run_self_test(workdir: str) -> list:
    """Inject each corruption class into a real plan / source snippet and
    assert the verifier reports exactly that class."""
    import dataclasses

    from flexflow_tpu_torch.analysis import (
        context_for_model,
        lint,
        numerics,
        run_analysis,
        spmd,
    )
    from flexflow_tpu_torch.analysis.sharding import _LAYOUT_PRESERVING
    from flexflow_tpu_torch.fftype import DataType, OperatorType as OT
    from flexflow_tpu_torch.ops import ReduceParams
    from flexflow_tpu_torch.parallel import ops as par_ops
    from flexflow_tpu_torch.parallel.ops import CombineParams
    from flexflow_tpu_torch.parallel.strategies import (
        sequence_parallel_attention,
    )
    from flexflow_tpu_torch.pcg.graph import Graph, OpNode
    from flexflow_tpu_torch.tensor import (
        ParallelTensor,
        ParallelTensorShape,
    )

    results = []

    def check(klass: str, codes, expect: str):
        if expect not in codes:
            fail(f"self-test {klass}: expected finding {expect!r}, "
                 f"got {sorted(set(codes))}")
        print(f"ffcheck: self-test {klass:26s} — caught ({expect})")
        results.append({"class": klass, "finding": expect})
        _REPORT.setdefault("self_test", []).append(
            {"class": klass, "finding": expect})

    mesh = CI_MESH
    ff = _compile(_lm(_config(
        mesh_axis_sizes=mesh if _world_fits(mesh) else _OPTS["mesh"]))[0])
    ff = _placed(ff, mesh)
    ctx = context_for_model(ff)
    clean = run_analysis(ff.graph, ff.mesh, ctx)
    if clean.errors():
        fail(f"self-test baseline not clean: "
             f"{[str(f) for f in clean.errors()]}")

    def mutate(node_pred, new_assign_fn, expect, klass):
        node = next(n for n in ff.graph.topo_order() if node_pred(n))
        pt = node.outputs[0]
        saved = pt.axis_assignment
        pt.axis_assignment = new_assign_fn(pt)
        try:
            res = run_analysis(ff.graph, ff.mesh, ctx)
        finally:
            pt.axis_assignment = saved
        check(klass, [f.code for f in res.findings], expect)

    # 1) axis reuse: same mesh axis on two dims of one assignment
    mutate(lambda n: len(n.outputs) > 0 and len(n.outputs[0].shape.dims) >= 2,
           lambda pt: (("data",), ("data",))
           + tuple(() for _ in pt.shape.dims[2:]),
           "axis_reuse", "axis_reuse")

    # 2) dropped parallel op: a layout-preserving consumer loses its
    # producer's sharding — the reshard is implicit now
    def _ew_with_sharded_producer(n):
        if n.op_type not in _LAYOUT_PRESERVING or not n.inputs:
            return False
        return any(a for a in n.inputs[0].axis_assignment)

    mutate(_ew_with_sharded_producer,
           lambda pt: tuple(() for _ in pt.shape.dims),
           "implicit_reshard", "dropped_parallel_op")

    # 3) oversharded dim: more shards than elements
    mutate(lambda n: (len(n.outputs) > 0
                      and not n.outputs[0].shape.dims[0].is_replica_dim
                      and n.outputs[0].shape.dims[0].size < 8),
           lambda pt: (("data", "model"),)
           + tuple(() for _ in pt.shape.dims[1:]),
           "overshard", "oversharded_dim")

    # 4) non-bijective ring permutation: corrupt the ONE shared schedule
    # function every ring body uses, on a plan that actually runs a ring
    fits = _world_fits(RING_MESH)
    ring_cfg = _config(search_budget=0, enable_parameter_parallel=False,
                       mesh_axis_sizes=RING_MESH if fits else _OPTS["mesh"])
    ring_ff, _ = _lm(ring_cfg, seq=16, ring=True)
    if fits:
        ring_ff.set_strategy(sequence_parallel_attention(ring_ff))
        _compile(ring_ff)
    else:
        _compile(ring_ff)
        _placed(ring_ff, RING_MESH, sequence_parallel_attention(ring_ff))
    rctx = context_for_model(ring_ff)
    good = par_ops.ring_permutation
    par_ops.ring_permutation = lambda n: good(n)[:-1]  # drop a pair
    try:
        res = run_analysis(ring_ff.graph, ring_ff.mesh, rctx)
    finally:
        par_ops.ring_permutation = good
    check("non_bijective_permutation",
          [f.code for f in res.findings], "bad_permutation")

    # 5) donated-then-reused buffer (source-level)
    codes = [f.code for f in lint.lint_source(
        _DONATED_SNIPPET, "snippet.py", select=("donated_reuse",))]
    check("donated_then_reused", codes, "donated_reuse")

    # 6) coordinator-only collective (source-level)
    codes = [f.code for f in lint.lint_source(
        _COORD_SNIPPET, "snippet.py",
        select=("coordinator_collective",))]
    check("coordinator_collective", codes, "coordinator_collective")

    # --- ffsan classes (dtype-flow + SPMD uniformity) ---

    def _pt(shape, dtype):
        return ParallelTensor(
            ParallelTensorShape.from_shape(shape, dtype))

    # 7) dtype mismatch across a parallel edge: flip a Combine output's
    # dtype (a synthesized mini-graph — a plan need not hold explicit
    # parallel ops)
    g2 = Graph()
    src = g2.add_node(OpNode(OT.OP_INPUT, None, name="x"))
    src.outputs = [_pt((8, 8), DataType.DT_BFLOAT16)]
    comb = g2.add_node(OpNode(OT.OP_COMBINE, CombineParams(0, 2),
                              name="combine"))
    comb.inputs = [src.outputs[0]]
    comb.outputs = [_pt((8, 8), DataType.DT_FLOAT)]
    g2.add_edge(src, comb)
    codes = [f.code for f in numerics.run(g2, ff.mesh, ctx)]
    check("parallel_dtype_mismatch", codes, "parallel_dtype_mismatch")

    # 8) fp32-master bypass: flip one trainable weight to bf16 under the
    # bf16 policy
    node = next(n for n in ff.graph.topo_order()
                if any(ws.trainable for ws in n.weight_specs))
    idx = next(i for i, ws in enumerate(node.weight_specs)
               if ws.trainable)
    saved_ws = node.weight_specs[idx]
    saved_cd = ff.config.computation_dtype
    node.weight_specs[idx] = dataclasses.replace(
        saved_ws, dtype=DataType.DT_BFLOAT16)
    ff.config.computation_dtype = DataType.DT_BFLOAT16
    try:
        res = run_analysis(ff.graph, ff.mesh, ctx)
    finally:
        node.weight_specs[idx] = saved_ws
        ff.config.computation_dtype = saved_cd
    check("master_bypass", [f.code for f in res.findings],
          "master_bypass")

    # 9) low-precision accumulation: a bf16 Reduce over 64k terms
    # (graph-level) and a bf16-cast torch.sum (source-level)
    g3 = Graph()
    src3 = g3.add_node(OpNode(OT.OP_INPUT, None, name="acts"))
    src3.outputs = [_pt((64, 1024), DataType.DT_BFLOAT16)]
    red = g3.add_node(OpNode(
        OT.OP_REDUCE_SUM, ReduceParams(OT.OP_REDUCE_SUM, (0, 1)),
        name="big_sum"))
    red.inputs = [src3.outputs[0]]
    red.outputs = [_pt((1,), DataType.DT_BFLOAT16)]
    g3.add_edge(src3, red)
    codes = [f.code for f in numerics.run(g3, ff.mesh, ctx)]
    check("low_precision_accum_graph", codes, "low_precision_accum")
    codes = [f.code for f in lint.lint_source(
        _LP_ACCUM_SNIPPET, "snippet.py",
        select=("low_precision_accum",))]
    check("low_precision_accum_src", codes, "low_precision_accum")

    # 10) host-divergent branch feeding a captured step (source-level)
    codes = [f.code for f in lint.lint_source(
        _DIVERGENT_SNIPPET, "snippet.py",
        select=("host_divergent_branch",))]
    check("host_divergent_branch", codes, "host_divergent_branch")

    # 11) SPMD fingerprint barrier catches a diverged fleet (a simulated
    # second process through injected channels, local to each rank)
    local = {"payload": spmd.fingerprint_payload(ff),
             "fingerprint": spmd.step_fingerprint(ff)}
    verdict = spmd.fingerprint_barrier(
        ff, broadcast=lambda p: local,
        gather=lambda m: [m])  # lockstep fleet: OK
    if verdict["status"] != "ok":
        fail(f"self-test fingerprint_barrier: lockstep verdict "
             f"{verdict!r}")
    try:
        spmd.fingerprint_barrier(
            ff, broadcast=lambda p: {"fingerprint": "divergent"},
            gather=lambda m: [m])
    except spmd.SPMDDivergenceError:
        check("spmd_fingerprint_mismatch", ["spmd_divergence"],
              "spmd_divergence")
    else:
        fail("self-test fingerprint_barrier: divergent fleet "
             "not detected")
    return results


# ---------------------------------------------------------------- suites

SUITE_RANKS = 4


def run_suite(name: str) -> dict:
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.distributed import world_size

    if name not in ("longcontext", "wus"):
        fail(f"unknown suite {name!r} (have longcontext, wus)")
    if world_size() != SUITE_RANKS:
        fail(f"suite {name} compiles on a mesh of {SUITE_RANKS} ranks; "
             f"run it as torchrun --nproc-per-node {SUITE_RANKS} "
             f"ffcheck_torch.py (this world: {world_size()})")
    if name == "longcontext":
        # the longcontext smoke's config: ring LM on a seq=4 mesh, search
        # on — the bijection check must see the sp plan's rings
        cfg = _config(search_budget=4, enable_parameter_parallel=False,
                      mesh_axis_sizes=(1, 1, 1, 4))
        cfg.enable_sample_parallel = True
        cfg.batch_size = 2
        ff, _ = _lm(cfg, seq=256, ring=True)
        _compile(ff)
        res = ff._analysis
        if res is None or res.errors():
            fail(f"suite longcontext: verification errors "
                 f"{[str(f) for f in (res.errors() if res else [])]}")
        msgs = " ".join(f.message for f in res.findings)
        if "ring schedule" not in msgs and "ring attention" not in msgs:
            fail("suite longcontext: collective pass saw no ring "
                 "schedule in the sp plan")
    else:
        # the wus smoke's config: dp=4, the memory capped below the
        # replicated update — the auto-sharded plan must verify clean
        # (the two-keyed OOM rule must NOT fire on a plan the
        # update-sharding decision made fit)
        from flexflow_tpu_torch import FFModel, LossType, SGDOptimizer
        from flexflow_tpu_torch.models import (
            TransformerLMConfig,
            build_transformer_lm,
        )

        cfg = FFConfig(device=_OPTS["device"])
        cfg.mesh_axis_sizes = (4, 1, 1, 1)
        cfg.batch_size = 4
        cfg.device_mem = 1.5 * 1024 * 1024
        ff = FFModel(cfg)
        c = TransformerLMConfig(vocab_size=128, hidden_size=64,
                                num_heads=2, num_layers=2,
                                sequence_length=32)
        build_transformer_lm(ff, c, batch_size=4)
        ff.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
                   loss_type=LossType
                   .LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        res = ff._analysis
        if res is None or res.errors():
            fail(f"suite wus: verification errors "
                 f"{[str(f) for f in (res.errors() if res else [])]}")
        if not (ff._update_sharding or {}).get("enabled"):
            fail("suite wus: update sharding not selected — the suite "
                 "no longer exercises the sharded-update memory path")
    print(f"ffcheck: suite {name} — clean")
    _REPORT.setdefault("suites", []).append({"suite": name, "ok": True})
    return {"suite": name, "ok": True}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _REPORT.clear()
    _REPORT.update({"kind": "ffcheck_report", "ok": False})
    _OPTS.clear()
    _OPTS.update(report="", device="cuda", mesh=None, sources_named=False)
    sources = list(ALL_SOURCES)
    self_test = True
    suites = []
    try:
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--report":
                i += 1
                _OPTS["report"] = argv[i]
            elif a == "--sources":
                i += 1
                _OPTS["sources_named"] = argv[i] not in ("all", "none")
                sources = ([] if argv[i] == "none"
                           else list(ALL_SOURCES) if argv[i] == "all"
                           else [s.strip() for s in argv[i].split(",")])
                unknown = set(sources) - set(ALL_SOURCES)
                if unknown:
                    fail(f"unknown sources {sorted(unknown)}")
            elif a == "--self-test":
                self_test = True
            elif a == "--no-self-test":
                self_test = False
            elif a == "--suite":
                i += 1
                suites.append(argv[i])
            elif a == "--device":
                i += 1
                _OPTS["device"] = argv[i]
            elif a in ("-h", "--help"):
                print(__doc__)
                return 0
            else:
                fail(f"unknown flag {a!r}")
            i += 1
        sys.argv = [sys.argv[0]]  # FFConfig must not parse ffcheck's flags

        from flexflow_tpu_torch.distributed import (
            barrier,
            initialize_from_env,
            is_coordinator,
            shared_tempdir,
            world_size,
        )

        initialize_from_env(_OPTS["device"])
        n = world_size()
        _OPTS["mesh"] = (CI_MESH if n == int(np.prod(CI_MESH))
                         else (n, 1, 1, 1))
        _REPORT["mesh"] = list(_OPTS["mesh"])
        _REPORT["device"] = _OPTS["device"]
        workdir = shared_tempdir("ffcheck-")
        try:
            if sources:
                run_sources(workdir, sources)
            if self_test:
                run_self_test(workdir)
            for s in suites:
                run_suite(s)
        finally:
            barrier("ffcheck-done")
            if is_coordinator():
                shutil.rmtree(workdir, ignore_errors=True)
    except FFCheckFailure as e:
        return int(e.code)

    _REPORT["ok"] = True
    _write_report()
    print("ffcheck: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
