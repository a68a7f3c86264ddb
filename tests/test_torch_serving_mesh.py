"""Serving on a mesh of gloo ranks against one rank and the JAX package.

The tiny LM of tests/test_serving.py (vocab 64, hidden 32, 4 heads, 2
layers, seq 32), float32, its JAX weights copied into the port with
`load_params`. Each mesh runs in one spawn of gloo ranks
(`mesh_job`, the port's ranks are processes), every rank serving the
same prompts:

- at (2, 1, 1, 1) and (1, 2, 1, 1) on 2 ranks and (2, 2, 1, 1) on 4,
  paged and contiguous, the greedy token streams equal one rank's and
  the JAX engine's on its virtual mesh with the same plan (the data
  default; `megatron_transformer` where the mesh has a model axis);
- the KV state's local shapes: the paged pool's feature dim over
  `model`, its block dim whole; the contiguous cache's feature dim over
  `model` and, where the plan puts its slot dim over `data` (the JAX
  test's placement), 2 of its 4 slots on each rank (the JAX test's shard
  shapes, tests/test_serving.py:103-150);
- a radix hit across data ranks: a prefix written by the slot of data
  rank 1 is read back by a later request in data rank 0's slot, the
  streams still one rank's (the pool is replicated over `data`, the new
  rows gathered before the write);
- temperature > 0: each rank draws every slot's noise from a generator
  seeded alike, so the sampled streams equal one rank's;
- `replan_mesh` from one card to 2 ranks mid-decode keeps the streams;
- under --spmd-barrier every rank's call is checked alike, and a rank
  whose prefill chunking differs is refused on every rank before any
  collective of the step;

and in one process the KV bytes a layer equal the JAX engine's in both
layouts. Token streams are compared exactly (integers); no tolerance.
"""

import sys

import numpy as np
import pytest

TINY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
            sequence_length=32, attention_impl="xla")
PROMPTS = [[3, 7, 11, 2, 5], [5, 2], [1, 9, 30, 30, 12, 4, 8], [60, 1, 2]]
KW = dict(slots=4, max_new_tokens=6, prefill_chunk=4)
SHARED = [7, 7, 7, 7, 3, 3, 3, 3]
# four requests fill the four slots in order: the shared prompt lands in
# slot 3, data rank 1's; the later one in slot 0, data rank 0's
RADIX_FIRST = [[1, 2], [4, 5], [9, 8], SHARED + [1]]
RADIX_SECOND = [SHARED + [2, 6]]
RADIX_KW = dict(slots=4, max_new_tokens=5, prefill_chunk=4,
                kv_block_size=4, kv_num_blocks=40)
MESHES = {(2, 1, 1, 1): 2, (1, 2, 1, 1): 2, (2, 2, 1, 1): 4}


def _jax_lm(mesh=(1, 1, 1, 1), batch=4):
    sys.argv = ["test"]
    from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu.models import TransformerLMConfig, build_transformer_lm

    cfg = FFConfig()
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _port_lm(mesh, params, batch=4):
    sys.argv = ["test"]
    from flexflow_tpu_torch import FFConfig, FFModel, load_params
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    cfg = FFConfig(device="cpu")
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=batch)
    ff.compile()
    load_params(ff, params)
    return ff


def _cache_over_data(strategy, ff, spec_cls):
    """The JAX test's contiguous placement: the cache's slot dim over
    `data`, its feature dim over `model`."""
    for layer in ff.layers:
        if layer.op_type.name == "OP_MULTIHEAD_ATTENTION":
            for w in ("cache_k", "cache_v"):
                strategy.set_weight(layer.name, w,
                                    spec_cls("data", None, "model"))
    return strategy


def _local_kv(eng) -> dict:
    st = eng.decode_model._state
    name = sorted(st)[0]
    return {k: tuple(v.shape) for k, v in st[name].items()
            if k in ("pool_k", "cache_k")}


def mesh_job(rank, mesh, params):
    """One rank of a mesh: both layouts' streams and local KV shapes, the
    contiguous cache with its slot dim over data where the mesh has a
    model axis, and on (2, 1, 1, 1) the radix, temperature and re-plan
    cases."""
    from flexflow_tpu_torch.parallel import megatron_transformer
    from flexflow_tpu_torch.tensor import PartitionSpec

    ff = _port_lm(mesh, params)
    tp = mesh[1] > 1
    out = {}
    for layout in ("paged", "contiguous"):
        kw = dict(KW, kv_layout=layout)
        if tp:
            kw["strategy"] = megatron_transformer(ff)
        eng = ff.serve(**kw)
        out[layout] = (eng.generate(PROMPTS), _local_kv(eng))
    if tp:
        strat = _cache_over_data(megatron_transformer(ff), ff,
                                 PartitionSpec)
        eng = ff.serve(kv_layout="contiguous", strategy=strat, **KW)
        out["contiguous_split"] = (eng.generate(PROMPTS), _local_kv(eng))
    if mesh == (2, 1, 1, 1):
        eng = ff.serve(**RADIX_KW)
        first = [eng.submit(p) for p in RADIX_FIRST]
        eng.run_until_drained()
        second = eng.submit(RADIX_SECOND[0])
        slot = []
        orig = eng.scheduler.admissions

        def admissions(can_admit=None):
            got = orig(can_admit=can_admit)
            slot.extend(s.index for s, _ in got)
            return got

        eng.scheduler.admissions = admissions
        eng.run_until_drained()
        out["radix"] = ([r.generated for r in first], second.generated,
                        second.matched_prefix_len,
                        eng.block_manager.stats.cross_time_hits, slot)
        eng = ff.serve(**KW)
        out["sampled"] = eng.generate(PROMPTS, temperature=0.8)
    if mesh == (1, 2, 1, 1):
        # --spmd-barrier: every call checked alike over the world; a
        # rank whose chunking differs is refused on every rank
        ff.config.spmd_barrier = True
        eng = ff.serve(strategy=megatron_transformer(ff), **KW)
        out["barrier"] = eng.generate(PROMPTS)
        bad = dict(KW, prefill_chunk=4 if rank == 0 else 2)
        eng = ff.serve(strategy=megatron_transformer(ff), **bad)
        try:
            eng.generate(PROMPTS)
            out["diverged"] = None
        except RuntimeError as e:
            out["diverged"] = str(e)
        ff.config.spmd_barrier = False
    if mesh == (2, 1, 1, 1):
        one = _port_lm((1, 1, 1, 1), params, batch=1)
        eng = one.serve(slots=2, max_new_tokens=8, prefill_chunk=4)
        reqs = [eng.submit(p) for p in PROMPTS[:2]]
        for _ in range(4):
            eng.step()
        mid = [list(r.generated) for r in reqs]
        dec = eng.replan_mesh(mesh, trigger="capacity")
        eng.run_until_drained()
        out["replan"] = (mid, [r.generated for r in reqs], dec["decision"],
                         eng.num_chips)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every mesh's spawn, one rank's streams, and the JAX engines on
    their virtual meshes with the same plans."""
    from flexflow_tpu.parallel.strategies import megatron_transformer as jmeg
    from flexflow_tpu_torch.distributed import spawn
    from jax.sharding import PartitionSpec

    jff = _jax_lm()
    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    one = _port_lm((1, 1, 1, 1), params, batch=1)
    want = {layout: one.serve(kv_layout=layout, **KW).generate(PROMPTS)
            for layout in ("paged", "contiguous")}
    eng = one.serve(**RADIX_KW)
    first = eng.generate(RADIX_FIRST)
    want["radix"] = (first, eng.generate(RADIX_SECOND)[0])
    want["sampled"] = one.serve(**KW).generate(PROMPTS, temperature=0.8)
    eng = one.serve(slots=2, max_new_tokens=8, prefill_chunk=4)
    want["replan"] = eng.generate(PROMPTS[:2])

    jax_out, ports = {}, {}
    for mesh, n in MESHES.items():
        jm = _jax_lm(mesh, batch=8)
        for node, ws in params.items():
            for w, v in ws.items():
                jm.set_weight(node, w, v)
        for layout in ("paged", "contiguous"):
            kw = dict(KW, kv_layout=layout)
            if mesh[1] > 1:
                kw["strategy"] = jmeg(jm)
            jax_out[(mesh, layout)] = jm.serve(**kw).generate(PROMPTS)
        if mesh[1] > 1:
            strat = _cache_over_data(jmeg(jm), jm, PartitionSpec)
            jax_out[(mesh, "contiguous_split")] = jm.serve(
                kv_layout="contiguous", strategy=strat, **KW).generate(
                PROMPTS)
        ports[mesh] = spawn(mesh_job, n, mesh, params, timeout=300)
    return want, jax_out, ports


CASES = [(mesh, layout) for mesh in MESHES
         for layout in ("paged", "contiguous")]


@pytest.mark.parametrize("mesh,layout", CASES,
                         ids=[f"{m[0]}x{m[1]}-{l}" for m, l in CASES])
def test_mesh_streams_equal_one_rank_and_jax(runs, mesh, layout):
    want, jax_out, ports = runs
    assert jax_out[(mesh, layout)] == want[layout]
    for out in ports[mesh]:
        assert out[layout][0] == want[layout]


def test_pool_and_cache_shard_shapes(runs):
    """E = 32 over model = 2: 16 features a rank; the pool's blocks and
    the default cache's slots whole; the split cache 2 slots a rank."""
    want, jax_out, ports = runs
    for mesh, outs in ports.items():
        feat = 32 // mesh[1]
        for out in outs:
            pool = out["paged"][1]["pool_k"]
            cache = out["contiguous"][1]["cache_k"]
            assert pool[1:] == (16, feat) and pool[0] >= 2
            assert cache == (4, 33, feat)
            if mesh[1] > 1:
                assert out["contiguous_split"][1]["cache_k"] == (
                    4 // mesh[0], 33, feat)
                assert out["contiguous_split"][0] == want["contiguous"]
                assert jax_out[(mesh, "contiguous_split")] == \
                    want["contiguous"]


def test_radix_hit_across_data_ranks(runs):
    want, _, ports = runs
    first_want, second_want = want["radix"]
    for out in ports[(2, 1, 1, 1)]:
        first, second, matched, hits, slots = out["radix"]
        assert first == first_want and second == second_want
        assert slots == [0], "the later request must land in slot 0"
        assert matched >= 8 and hits > 0, "no cross-rank radix hit"


def test_sampled_draws_equal_one_rank(runs):
    want, _, ports = runs
    assert want["sampled"] != want["paged"], "temperature did nothing"
    for out in ports[(2, 1, 1, 1)]:
        assert out["sampled"] == want["sampled"]


def test_replan_from_one_card_to_two_ranks_mid_decode(runs):
    want, _, ports = runs
    for out in ports[(2, 1, 1, 1)]:
        mid, got, decision, chips = out["replan"]
        assert decision == "migrated" and chips == 2
        assert got == want["replan"]
        for g, m in zip(got, mid):
            assert g[:len(m)] == m and len(m) < len(g)


def test_spmd_barrier_holds_every_rank_to_the_same_call(runs):
    want, _, ports = runs
    for out in ports[(1, 2, 1, 1)]:
        assert out["barrier"] == want["paged"]
        assert out["diverged"] and "next device calls differ" in \
            out["diverged"]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_kv_bytes_per_layer_equal_jax(layout):
    jff = _jax_lm(batch=1)
    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    tff = _port_lm((1, 1, 1, 1), params, batch=1)
    kw = dict(slots=2, max_new_tokens=4, prefill_chunk=4, kv_layout=layout,
              kv_num_blocks=12)
    j, t = jff.serve(**kw), tff.serve(**kw)
    assert t.kv_bytes_per_layer() == j.kv_bytes_per_layer() > 0
    assert t.stats()["kv_hbm_bytes_per_layer"] == t.kv_bytes_per_layer()


def serving_leg_job(rank):
    """chip_smoke's torchrun serving leg on one gloo rank, at a small
    width (vocab 512, hidden 128, 4 heads, 1 layer; the drafter hidden
    64, 2 heads) and 16 new tokens."""
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(vocab_size=512, hidden_size=128, num_heads=4,
                             num_layers=1, sequence_length=512)
    draft = TransformerLMConfig(vocab_size=512, hidden_size=64, num_heads=2,
                                num_layers=1, sequence_length=512)
    return chip_smoke.mesh_serve_check("cpu", lm=lm, draft_lm=draft,
                                       tokens=16)


def test_chip_smoke_serving_leg_passes_on_four_cpu_ranks():
    """The torchrun leg's rehearsal (e)-(g): tp 4, dp 2 x tp 2, the dp 2
    re-plan, the 2 + 2 split with its ratio shift and the drafter on
    ranks 2-3, every stream equal to one rank's on every rank."""
    from flexflow_tpu_torch.distributed import spawn

    outs = spawn(serving_leg_job, 4, timeout=600)
    for out in outs:
        assert out["failures"] == [], out["failures"]
        n = out["numbers"]
        assert n["tp"]["mesh"]["model"] == 4
        assert n["tp"]["pool_local"][-1] == 128 // 4
        assert n["replan"]["decision"] == "migrated"
        assert n["disagg"]["split"] == [2, 2]
        assert n["disagg"]["split_after"] != [2, 2]
        assert any(h["blocks"] for h in n["disagg"]["handoffs"])
        assert n["speculate"]["target_ranks"] == [0, 1]
        assert n["speculate"]["drafter_ranks"] == [2, 3]
