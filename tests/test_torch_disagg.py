"""The port's disaggregated prefill/decode serving against its unified
engine and the JAX package's (twins of tests/test_disagg.py:139-290).

The tiny LM of tests/test_disagg.py (vocab 64, hidden 32, 4 heads, 2
layers, seq 32), float32, the JAX model's weights copied into the port
with `load_params`. One spawn of 8 gloo ranks (`disagg_job`, the JAX
package's 8 virtual devices): prefill on ranks [0, 4), decode on [4, 8),
the KV rows handed from rank 0 to ranks 4-7 (gloo's `batch_isend_irecv`;
NCCL's on the card); the JAX package's engine splits its 8 devices the
same way.
Token streams are compared exactly (integers):

- streams equal the unified engine's and the JAX package's
  disaggregated ones, on every rank;
- each handoff's fftrans program equals the JAX package's JSON and
  re-verifies from it (`verify_transition_total`, to 1e-9 s); the
  later handoffs of a shared prefix land radix-cached;
- a prefix handed off, decoded and released is hit again after a full
  drain (zero blocks injected);
- a one-token budget and EOS on the first token finish at prefill with
  no handoff, the completion recorded on the decode side;
- the ratio trigger's declined record carries both payoff sides (the
  doctor's arithmetic), equal on every rank;
- an approved ratio shift (one side shrunk by a rank, the other grown
  into it) keeps the streams bit-equal;
- the sides' compiles leave the distributed helpers' scope as they
  found it (C6: a plain config built after them counts the world);

and in one process `extract_kv` -> `admit_prefilled` moves a prefilled
prompt between two engines with the stream unchanged.
"""

import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHARED = [1, 2, 3, 4, 5, 6, 7, 8, 9]
PROMPTS = [SHARED, SHARED + [40, 41], [20, 21, 22], SHARED]
TINY = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
            sequence_length=32, attention_impl="xla")
KW = dict(slots=4, max_new_tokens=6, prefill_chunk=4, kv_block_size=4)
SHIFT_PROMPTS = [[i, i + 1, i + 2] for i in range(1, 9)]


def _jax_lm(mesh=(1, 1, 1, 1), batch=1):
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


def _port_lm(params, mesh=(1, 1, 1, 1), batch=1):
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


def disagg_job(rank, params):
    """Every disaggregated case on one rank of a world of 8."""
    ff = _port_lm(params, mesh=(8, 1, 1, 1), batch=8)
    out = {}
    dis = ff.serve(disaggregate=True, **KW)
    from flexflow_tpu_torch import FFConfig

    # the sides' window compiles leave the caller's scope: a plain config
    # built now still counts the whole world
    out["plain_devices"] = FFConfig(device="cpu").num_devices
    out["split"] = (dis.prefill_chips, dis.decode_chips,
                    list(dis.prefill.decode_model.mesh.ranks),
                    list(dis.decode.decode_model.mesh.ranks),
                    dis.prefill.member, dis.decode.member,
                    dis.prefill.decode_model.config.serve_role,
                    dis.decode.decode_model.config.serve_role)
    out["streams"] = dis.generate(PROMPTS)
    sec = dis.disagg_section()
    out["section"] = {"handoffs": [
        {k: h[k] for k in ("prompt_blocks", "injected_blocks",
                           "predicted_s", "matched_prefix_len")}
        for h in sec["handoffs"]], "programs": sec["programs"],
        "count": sec["summary"]["count"]}
    out["clean"] = not dis._pending and not dis._kv_stash
    # the cross-time hit after a full drain
    first = dis.generate([SHARED])
    out["again"] = (first, dis.generate([SHARED]), dis.drained,
                    dis.decode.block_manager.stats.cross_time_hits,
                    dis.handoffs[-1]["injected_blocks"],
                    dis.handoffs[-1]["predicted_s"])
    # requests that finish at prefill
    dis = ff.serve(disaggregate=True, slots=2, prefill_chunk=4,
                   kv_block_size=4)
    req = dis.submit([5, 6, 7], max_new_tokens=1)
    dis.run_until_drained()
    eos = req.generated[0]
    req2 = dis.submit([5, 6, 7], max_new_tokens=8, eos_id=eos)
    dis.run_until_drained()
    out["at_prefill"] = (req.generated, req.finish_reason,
                         req in dis.decode.scheduler.completed,
                         req2.generated, req2.finish_reason,
                         len(dis.handoffs))
    # the ratio trigger: declined, then approved and executed
    dis = ff.serve(disaggregate=True, **KW)
    dis.generate(SHIFT_PROMPTS)
    dis.rebalance_min_samples = 1
    dis.rebalance_factor = 0.0001
    before = (dis.prefill_chips, dis.decode_chips)
    d = dis.maybe_rebalance(horizon_steps=0)
    out["declined"] = (d, before, (dis.prefill_chips, dis.decode_chips),
                       d in ff._elastic_decisions)
    d2 = dis.maybe_rebalance(horizon_steps=10 ** 6)
    out["shift"] = (d2["decision"], d2["new_prefill_chips"],
                    dis.prefill_chips, dis.decode_chips,
                    list(dis.decode.decode_model.mesh.ranks),
                    dis.generate([SHARED, [7, 8, 9]]))
    return out


@pytest.fixture(scope="module")
def runs():
    from flexflow_tpu_torch.distributed import spawn

    jff = _jax_lm()
    params = {n: {w: np.asarray(v) for w, v in ws.items()}
              for n, ws in jff._params.items()}
    one = _port_lm(params)
    want = {"streams": one.serve(**KW).generate(PROMPTS),
            "shift": one.serve(**KW).generate([SHARED, [7, 8, 9]]),
            "eos": one.serve(slots=2, prefill_chunk=4).generate(
                [[5, 6, 7]], max_new_tokens=1)}
    jm = _jax_lm(mesh=(8, 1, 1, 1), batch=8)
    for node, ws in params.items():
        for w, v in ws.items():
            jm.set_weight(node, w, v)
    jdis = jm.serve(disaggregate=True, **KW)
    jax_out = {"streams": jdis.generate(PROMPTS),
               "section": jdis.disagg_section(),
               "split": (jdis.prefill_chips, jdis.decode_chips)}
    return want, jax_out, spawn(disagg_job, 8, params, timeout=300)


def _program(prog: dict) -> dict:
    """A program's JSON without its verification's wall time."""
    out = dict(prog)
    out["analysis"] = {k: v for k, v in prog["analysis"].items()
                       if k != "elapsed_s"}
    return out


def test_disagg_streams_equal_unified_and_jax(runs):
    want, jax_out, outs = runs
    assert jax_out["streams"] == want["streams"]
    assert jax_out["split"] == (4, 4)
    for rank, out in enumerate(outs):
        assert out["split"] == (4, 4, [0, 1, 2, 3], [4, 5, 6, 7], rank < 4,
                                rank >= 4, "prefill", "decode")
        assert out["streams"] == want["streams"]
        assert out["clean"]


def test_side_compiles_leave_the_callers_scope(runs):
    """C6: a side's decode compile on a window of the world scoped the
    distributed helpers to that window, so a later plain config counted
    the window's ranks as its devices."""
    _, _, outs = runs
    assert [out["plain_devices"] for out in outs] == [8] * 8


def test_disagg_handoff_programs_equal_jax(runs):
    from flexflow_tpu_torch.analysis.transition import (
        verify_transition_total,
    )

    _, jax_out, outs = runs
    jsec = jax_out["section"]
    for out in outs:
        sec = out["section"]
        assert sec["count"] == len(PROMPTS)
        assert sorted(sec["programs"]) == sorted(jsec["programs"])
        for k, prog in sec["programs"].items():
            assert _program(prog) == _program(jsec["programs"][k]), k
        assert [(h["prompt_blocks"], h["injected_blocks"],
                 h["matched_prefix_len"]) for h in sec["handoffs"]] == [
            (h["prompt_blocks"], h["injected_blocks"],
             h["matched_prefix_len"]) for h in jsec["handoffs"]]
        for h in sec["handoffs"]:
            if h["injected_blocks"] == 0:
                assert h["predicted_s"] == 0.0
                continue
            prog = sec["programs"][str(h["injected_blocks"])]
            assert prog["analysis"]["errors"] == 0
            assert abs(verify_transition_total(prog)
                       - prog["predicted_s"]) < 1e-9
            assert abs(h["predicted_s"] - prog["predicted_s"]) < 1e-9
            assert {c["kind"] for t in prog["transfers"]
                    for c in t["collectives"]} == {"host_hop"}
        assert any(h["injected_blocks"] < h["prompt_blocks"]
                   for h in sec["handoffs"][1:])


def test_disagg_cross_time_prefix_hit_after_drain(runs):
    want, _, outs = runs
    for out in outs:
        first, second, drained, hits, injected, predicted = out["again"]
        assert first == second == [want["streams"][0]] and drained
        assert hits > 0 and injected == 0 and predicted == 0.0


def test_disagg_requests_finishing_at_prefill(runs):
    want, _, outs = runs
    for out in outs:
        gen, reason, recorded, gen2, reason2, handoffs = out["at_prefill"]
        assert [gen] == want["eos"] and reason == "max_tokens" and recorded
        assert gen2 == gen and reason2 == "eos" and handoffs == 0


def test_disagg_ratio_trigger_payoff_record(runs):
    import pytest as _pytest

    _, _, outs = runs
    first = outs[0]["declined"][0]
    for out in outs:
        d, before, after, recorded = out["declined"]
        assert d == first, "every rank must hold rank 0's decision"
        assert d["decision"] == "declined" and before == after == (4, 4)
        assert recorded and not d["would_migrate"]
        assert d["lhs_s"] == _pytest.approx(
            d["predicted_migration_s"] * d["fidelity_ratio"])
        assert d["rhs_s"] == _pytest.approx(
            d["benefit_s_per_step"] * d["horizon_steps"])
        assert d["new_prefill_chips"] != before[0]
        assert d["predicted_migration_s"] > 0


def test_disagg_rebalance_streams_bit_equal(runs):
    want, _, outs = runs
    for out in outs:
        decision, new_p, p, d, ranks, streams = out["shift"]
        assert decision == "migrated" and new_p == p
        assert p + d == 8 and p != 4 and ranks == list(range(p, 8))
        assert streams == want["shift"]


def test_extract_then_admit_prefilled_round_trip():
    """One process: a prompt prefilled by one engine (its KV lifted by
    the pre-release hook as device tensors) is admitted into a second
    engine, which decodes the same stream as an engine that did both."""
    from flexflow_tpu_torch.serving.scheduler import Request

    jff = _jax_lm()
    ff = _port_lm({n: {w: np.asarray(v) for w, v in ws.items()}
                   for n, ws in jff._params.items()})
    prompt = SHARED + [40, 41]
    kw = dict(slots=2, prefill_chunk=4, kv_block_size=4)
    want = ff.serve(max_new_tokens=6, **kw).generate([prompt])[0]
    pre = ff.serve(max_new_tokens=1, **kw)
    stash = {}

    def hook(slot, req):
        stash["kv"] = pre.extract_kv(slot.index, len(req.prompt))

    pre._pre_release_hook = hook
    first = pre.generate([prompt])[0][0]
    ks, vs = stash["kv"]
    assert ks.shape == (2, 3, 4, 32) and ks.device == ff.device
    assert pre.kv_pool_layers() == sorted(pre.kv_pool_layers())
    dec = ff.serve(max_new_tokens=6, **kw)
    req = Request(prompt=list(prompt), max_new_tokens=6)
    req.generated.append(first)
    assert dec.admit_prefilled(req, first, ks, vs) == 3
    dec.run_until_drained()
    assert req.generated == want
