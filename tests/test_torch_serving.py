"""The port's serving slice against the JAX package's serving engine.

The tiny LM of tests/test_serving.py (vocab 64, hidden 32, 4 heads, 2
layers, seq 32) is built in both packages; the JAX model's weights are
copied into the port with `convert.load_params`, so both compute the same
function. The JAX engine runs on a one-device CPU mesh (its CPU path is
the einsum reference); the port runs on the CPU, where its kernel
wrappers take their plain versions. Float32 throughout, with the
tensor-op policy off on both sides (it applies on the accelerator only):
greedy token streams must be identical, and the logits of one decode
step agree to atol 1e-4.

The serving telemetry (the engines' metrics planes): on the same request
trace both engines' `metrics_summary` have the same keys (the KV bytes
a layer among them, with the same value) and the same counts, their
histograms the
same observation counts; the percentiles are there mid-run and after a
drain, `reset_stats` opens a clean window, and with a telemetry dir the
drain leaves the JAX package's `serve.*` records.

Also here: no source of the port imports jax or flexflow_tpu, importing
the port pulls in neither (checked in a subprocess, since this process
imports both), and a model asked for no device raises without CUDA.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

PROMPTS = [[3, 7, 11, 2, 5], [5, 2], [1, 9, 30, 30, 12, 4, 8], [60, 1, 2]]
LOGIT_ATOL = 1e-4
LAYOUTS = ["paged", "contiguous"]
TINY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
            sequence_length=32, attention_impl="xla")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_lm():
    sys.argv = ["test"]
    from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu.models import TransformerLMConfig, build_transformer_lm

    cfg = FFConfig()
    cfg.mesh_axis_sizes = (1, 1, 1, 1)
    cfg.batch_size = 1
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=1)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _torch_lm(jff):
    sys.argv = ["test"]
    from flexflow_tpu_torch import FFConfig, FFModel, load_params
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    cfg = FFConfig(device="cpu")
    cfg.batch_size = 1
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=1)
    ff.compile()
    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    assert set(params) == set(ff._params)
    assert load_params(ff, params) == sum(len(w) for w in params.values())
    return ff


@pytest.fixture(scope="module")
def models():
    jff = _jax_lm()
    return jff, _torch_lm(jff)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_greedy_streams_identical(models, layout):
    jff, tff = models
    kw = dict(slots=2, max_new_tokens=8, prefill_chunk=4, kv_layout=layout)
    want = jff.serve(**kw).generate(PROMPTS)
    eng = tff.serve(**kw)
    assert eng.generate(PROMPTS) == want
    assert eng.stats()["requests_completed"] == len(PROMPTS)


# the metrics_summary counts both engines must agree on (timings differ)
_COUNTS = ("requests_completed", "decode_iterations", "decode_tokens",
           "prefill_tokens", "prefill_calls", "no_token_requests", "slots",
           "max_seq_len", "num_chips", "kv_layout", "kv_block_size",
           "kv_pool_blocks", "kv_blocks_in_use_peak", "prefix_hit_rate",
           "prefix_shared_tokens", "cow_copies", "prefix_cache",
           "cross_time_hits", "radix_evictions", "radix_evicted_blocks",
           "prefix_cached_blocks", "prefix_cached_only_blocks",
           "kv_peak_vs_contiguous")


def _hist_counts(eng) -> dict:
    snap = eng.metrics.snapshot()
    return {k: h["count"] for k, h in snap["histograms"].items()}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_metrics_summary_matches_jax(models, layout):
    """Five requests through two slots (a shared prefix, mid-run
    admission): both engines' metrics_summary has the same keys (the
    port adds the rates over the engine and its device) and the same
    counts, the KV bytes a layer among them, every latency percentile is
    there, and the histograms hold the same observation counts."""
    jff, tff = models
    prompts = PROMPTS + [[3, 7, 11, 2, 9]]
    kw = dict(slots=2, max_new_tokens=6, prefill_chunk=4, kv_layout=layout)
    out = {}
    for name, ff in (("jax", jff), ("port", tff)):
        eng = ff.serve(**kw)
        eng.generate(prompts)
        out[name] = (eng.metrics_summary(), _hist_counts(eng))
    (js, jh), (ts, th) = out["jax"], out["port"]
    assert set(js) == set(ts) - {
        "device", "requests_per_sec", "decode_tokens_per_sec"}
    assert ts["kv_hbm_bytes_per_layer"] == js["kv_hbm_bytes_per_layer"] > 0
    for k in _COUNTS:
        if k in js:
            assert ts[k] == js[k], k
    for short in ("queue_wait", "ttft", "tbt", "e2e"):
        for q in ("p50", "p95", "p99", "max", "mean"):
            assert ts[f"{short}_{q}_s"] >= 0.0, (short, q)
    assert th == jh
    assert th["serve_ttft_s"] == th["serve_e2e_s"] == len(prompts)
    assert th["serve_tbt_s"] == ts["decode_tokens"] - len(prompts)


def test_metrics_summary_mid_run_reset_and_drain_records(models, tmp_path):
    """metrics_summary mid-run (cumulative histograms), reset_stats opens
    a clean window, and with telemetry on the drain leaves serve.request
    / serve.summary records and a serve_drain snapshot, as the JAX
    engine's."""
    from flexflow_tpu_torch import telemetry
    from flexflow_tpu_torch.telemetry.recorder import read_jsonl

    _, tff = models
    tff.enable_telemetry(str(tmp_path))
    try:
        eng = tff.serve(slots=2, max_new_tokens=4, prefill_chunk=4)
        for p in PROMPTS:
            eng.submit(p)
        for _ in range(4):
            eng.step()
        mid = eng.metrics_summary()
        assert "ttft_p50_s" in mid and "queue_wait_p99_s" in mid
        eng.run_until_drained()
        assert eng.metrics_summary()["requests_completed"] == len(PROMPTS)
        eng.reset_stats()
        st = eng.metrics_summary()
        assert st["requests_completed"] == 0 and "ttft_p50_s" not in st
        assert _hist_counts(eng)["serve_ttft_s"] == 0
        eng.generate([PROMPTS[0]])
        assert eng.metrics_summary()["requests_completed"] == 1
    finally:
        tff._telemetry = None
        telemetry.deactivate()
    recs = read_jsonl(str(tmp_path / "metrics.jsonl"))
    kinds = [r["kind"] for r in recs]
    assert kinds.count("serve.request") == len(PROMPTS) + 1
    assert kinds.count("serve.summary") == 2
    assert "serve.compile" in kinds and "serve.stats_reset" in kinds
    snaps = [r for r in recs if r["kind"] == "metrics_snapshot"]
    assert snaps and snaps[-1]["reason"] == "serve_drain"
    assert "serve_ttft_s" in snaps[-1]["metrics"]["histograms"]


def test_serving_sanitizer_reports_a_nonfinite_decode_once(tmp_path):
    """--sanitize-numerics in serving: a fault in a decode op surfaces as
    ONE serve.nonfinite event per (op, phase), from the decode step's
    probe table (step-less: step -1). Idle padding elements read the
    position table one past its end, a NaN row by the JAX package's
    `take` semantics (ops/core.embedding_lookup), so the position
    embedding and its consumers report too, once each."""
    from flexflow_tpu_torch import sanitize, telemetry
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.telemetry.recorder import read_jsonl

    sys.argv = ["test", "--sanitize-numerics"]
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import (TransformerLMConfig,
                                           build_transformer_lm)

    cfg = FFConfig(device="cpu")
    cfg.batch_size = 1
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**TINY), batch_size=1)
    ff.compile()
    ff.enable_telemetry(str(tmp_path))
    eng = ff.serve(slots=2, max_new_tokens=3, prefill_chunk=4)
    target = next(n.name for n in eng.decode_model.graph.topo_order()
                  if n.op_type == OT.OP_LAYERNORM)
    eng.decode_model.executor.set_numeric_fault(target, "fwd", 0)
    eng._step_fn = eng.decode_model.executor.build_decode_step()
    sanitize.get_monitor().reset()
    eng.generate(PROMPTS[:2])
    telemetry.deactivate()
    events = [r for r in read_jsonl(str(tmp_path / "metrics.jsonl"))
              if r["kind"] == "serve.nonfinite"]
    assert {(e["op"], e["phase"]) for e in events} >= {(target, "fwd")}
    assert len(events) == len({(e["op"], e["phase"]) for e in events})
    assert all(e["step"] == -1 for e in sanitize.get_monitor().snapshot())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_interleaved_batch_matches_single_requests(models, layout):
    """Five requests through two slots force mid-run admission and slot
    reuse; the interleaved streams equal single-request runs and the JAX
    engine's."""
    jff, tff = models
    prompts = PROMPTS + [[2, 4, 6, 8]]
    kw = dict(slots=2, max_new_tokens=6, prefill_chunk=4, kv_layout=layout)
    eng = tff.serve(**kw)
    interleaved = eng.generate(prompts)
    assert eng.scheduler.drained
    solo_eng = tff.serve(**kw)
    solo = [solo_eng.generate([p])[0] for p in prompts]
    assert interleaved == solo
    assert interleaved == jff.serve(**kw).generate(prompts)


def _prefill_all(eng, prompts):
    """Submit and step until every slot has finished its prefill."""
    for p in prompts:
        eng.submit(p, max_new_tokens=16)
    while (eng.scheduler.pending
           or any(s.prefilling for s in eng.scheduler.slots)):
        eng.step()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_step_logits_match(models, layout):
    """The logits of one pure-decode step (q_len 1: the decode kernels'
    path) after the same prefills. The idle slot's row is never read and
    is left out: the JAX CPU path spreads it over the whole cache, the
    decode kernels write 0."""
    import jax

    jff, tff = models
    kw = dict(slots=3, prefill_chunk=4, kv_layout=layout)
    jeng, teng = jff.serve(**kw), tff.serve(**kw)
    prompts = PROMPTS[:2]
    _prefill_all(jeng, prompts)
    _prefill_all(teng, prompts)

    jdec = jeng.decode_model
    tokens = np.zeros((3, 1), np.int32)
    positions = np.full((3, 1), jeng.max_seq_len, np.int32)
    writes = {}
    for s in jeng.scheduler.slots:
        if s.decoding:
            tokens[s.index, 0] = s.last_token
            positions[s.index, 0] = s.length
            writes[s.index] = range(s.length, s.length + 1)
    jeng._prepare_writes(writes)
    xs = jeng._stage_inputs(tokens, positions)
    jlogits, _, _ = jdec.executor._apply(
        jdec._params, jdec._state, jdec.executor._cast_compute(xs),
        training=False, rng=None)
    jlogits = np.asarray(jax.device_get(jlogits))

    ttokens, tpositions, _, pre, _, _, decoding = teng.next_feed()
    assert pre is None and len(decoding) == len(prompts)
    np.testing.assert_array_equal(ttokens, tokens)
    np.testing.assert_array_equal(tpositions, positions)
    tdec = teng.decode_model
    tlogits, _ = tdec.executor._apply(
        tdec._params, tdec._state, teng._stage_inputs(ttokens, tpositions))
    live = [s.index for s in decoding]
    np.testing.assert_allclose(tlogits.numpy()[live], jlogits[live],
                               rtol=0, atol=LOGIT_ATOL)


def _layer_signature(ff):
    return [(l.name, int(l.op_type), tuple(l.outputs[0].dims))
            for l in ff.layers]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_direct_decode_builder_matches_jax_and_engine(models, layout):
    """`build_transformer_lm_decode` lays out the JAX package's layers
    (names, operators, output shapes) and, with the tiny model's weights,
    computes what the engine's replay of the trained graph computes."""
    from flexflow_tpu import FFConfig as JConfig, FFModel as JModel
    from flexflow_tpu.models import (
        TransformerLMConfig as JLMConfig,
        build_transformer_lm_decode as jbuild,
    )
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel, load_params
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm_decode,
    )

    _, tff = models
    kw = dict(slots=3, kv_layout=layout, kv_block_size=4)
    sys.argv = ["test"]
    jcfg = JConfig()
    jcfg.mesh_axis_sizes = (1, 1, 1, 1)
    jdec = JModel(jcfg)
    jbuild(jdec, JLMConfig(**TINY), **kw)
    dec = FFModel(FFConfig(device="cpu"))
    build_transformer_lm_decode(dec, TransformerLMConfig(**TINY), **kw)
    assert _layer_signature(dec) == _layer_signature(jdec)

    dec.compile(comp_mode=CompMode.COMP_MODE_INFERENCE)
    load_params(dec, {n: {w: t.numpy() for w, t in ws.items()}
                      for n, ws in tff._params.items()})
    eng = tff.serve(**kw)
    max_seq = TINY["sequence_length"]
    xs = {"tokens": np.asarray([[5], [17], [0]], np.int32),
          "positions": np.asarray([[0], [1], [max_seq]], np.int32)}
    if layout == "paged":
        table = np.zeros((3, max_seq // 4), np.int32)
        table[0, 0], table[1, 0] = 1, 2
        xs["page_table"] = table
    outs = []
    for m in (dec, eng.decode_model):
        logits, _ = m.executor._apply(m._params, m._state,
                                      m.executor.stage_inputs(xs))
        outs.append(logits[:2].numpy())  # slot 2 is idle
    np.testing.assert_array_equal(outs[0], outs[1])


def test_param_count_matches_jax_and_the_built_model(models):
    from flexflow_tpu.models import (
        TRANSFORMER_LM_ZOO as JZOO,
        transformer_lm_param_count as jcount,
    )
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        TransformerLMConfig,
        transformer_lm_param_count,
    )

    fields = ("vocab_size", "hidden_size", "num_heads", "num_layers",
              "mlp_ratio", "sequence_length")
    for name, c in TRANSFORMER_LM_ZOO.items():
        assert ([getattr(c, f) for f in fields]
                == [getattr(JZOO[name], f) for f in fields]), name
        assert transformer_lm_param_count(c) == jcount(JZOO[name]), name
    _, tff = models
    assert (sum(w.numel() for ws in tff._params.values()
                for w in ws.values())
            == transformer_lm_param_count(TransformerLMConfig(**TINY)))


def test_load_params_rejects_unknown_names(models):
    from flexflow_tpu_torch import load_params

    _, tff = models
    with pytest.raises(KeyError, match="node"):
        load_params(tff, {"nope": {"kernel": np.zeros(1)}})
    with pytest.raises(KeyError, match="weight"):
        load_params(tff, {"lm_head": {"bias": np.zeros(64)}})
    with pytest.raises(ValueError, match="shape"):
        load_params(tff, {"lm_head": {"kernel": np.zeros((2, 2))}})


def test_no_source_imports_jax():
    """No module of the port, nor chip_smoke.py, bench_torch.py or
    search_torch.py,
    imports jax, the JAX package or ml_dtypes (a lazy import inside a
    function included): the checkpointer decodes bfloat16 leaves itself."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flexflow_tpu|ml_dtypes)(\.|\s|$)", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py"),
               os.path.join(REPO, "bench_torch.py"),
               os.path.join(REPO, "search_torch.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "flexflow_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = [p for p in sources if pattern.search(open(p).read())]
    assert len(sources) > 20 and not bad, bad


def test_import_pulls_in_no_jax():
    code = (
        "import sys, flexflow_tpu_torch, flexflow_tpu_torch.models, "
        "flexflow_tpu_torch.serving, flexflow_tpu_torch.kernels._build, "
        "flexflow_tpu_torch.kernels.flash_attention, "
        "flexflow_tpu_torch.kernels.layer_norm, "
        "flexflow_tpu_torch.search.machine_model, bench_torch, "
        "flexflow_tpu_torch.telemetry, flexflow_tpu_torch.scope.flightrec, "
        "flexflow_tpu_torch.models.resnet, flexflow_tpu_torch.machine, "
        "flexflow_tpu_torch.parallel, flexflow_tpu_torch.parallel.spmd, "
        "flexflow_tpu_torch.distributed, "
        "flexflow_tpu_torch.entry, flexflow_tpu_torch.search.unity, "
        "flexflow_tpu_torch.search.joint, "
        "flexflow_tpu_torch.search.mesh_search, "
        "flexflow_tpu_torch.search.substitution, "
        "flexflow_tpu_torch.native, search_torch, chip_smoke, "
        "flexflow_tpu_torch.resilience, flexflow_tpu_torch.warmstart, "
        "flexflow_tpu_torch.engine, flexflow_tpu_torch.checkpoint, "
        "flexflow_tpu_torch.diagnostics, flexflow_tpu_torch.recompile, "
        "flexflow_tpu_torch.sanitize, flexflow_tpu_torch.profiling, "
        "flexflow_tpu_torch.scope.watchdog, flexflow_tpu_torch.scope.profile, "
        "flexflow_tpu_torch.scope.attribution, "
        "flexflow_tpu_torch.scope.kineto, "
        "flexflow_tpu_torch.diagnostics.doctor\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flexflow_tpu' or "
        "m.startswith('flexflow_tpu.') or m == 'ml_dtypes']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_model_without_cuda_raises_unless_cpu_asked(monkeypatch):
    from flexflow_tpu_torch import FFConfig, FFModel

    monkeypatch.setattr(sys, "argv", ["test"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel(FFConfig())
    assert FFModel(FFConfig(device="cpu")).device.type == "cpu"
    monkeypatch.setattr(sys, "argv", ["test", "--device", "cpu"])
    assert FFModel(FFConfig()).device.type == "cpu"
