"""The port's speculative decoding against its plain engine and the JAX
package's (twins of tests/test_speculative.py:90-339).

The tiny LM of tests/test_speculative.py (vocab 64, hidden 32, 4 heads,
2 layers, seq 32), float32; the JAX model's weights are copied into the
port with `load_params`, and a seed-clone drafter gets the same weights.
Token streams are compared exactly (integers); payoff records to the
float (the same arithmetic in the same order):

- both acceptance extremes (a seed-clone drafter that always agrees, a
  drafter forced to propose a token plain decode never samples) are
  bit-equal to the port's plain engine and to the JAX package's
  speculative streams, with the all-accept and all-reject accounting;
- slot reuse under continuous batching resets the drafter's cursor;
- verify rollback on the paged layout never touches a shared block (the
  BlockManager's invariants after every step) and a second pass's radix
  hits still give the same streams;
- `--serve-draft-chips 2` on 4 gloo ranks: the target on ranks [0, 2),
  the drafter on [2, 4), every rank's streams those of plain decode (the
  JAX package: its drafter on the last 4 of 8 virtual devices);
- the drafter's plan is role-keyed: a second speculative engine against
  one --warmstart-dir (2 gloo ranks, the search on) takes both plans
  from the cache;
- the acceptance EMA persisted by either package is read by the other
  (one calibration DB, the same pair key);
- the payoff records equal the JAX package's for the same costs;
- flag and argument validation names the flag.
"""

import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[3, 7, 11, 2, 5], [5, 2], [1, 9, 30, 30, 12, 4, 8], [60, 1, 2]]
BAD = 63  # a token no plain stream of these prompts emits


def _lm_kw(**kw):
    base = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
                sequence_length=32, attention_impl="xla")
    base.update(kw)
    return base


def _jax_lm(argv=(), mesh=(1, 1, 1, 1), batch=1, **lm_kw):
    sys.argv = ["test"] + list(argv)
    from flexflow_tpu import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu.models import TransformerLMConfig, build_transformer_lm

    cfg = FFConfig()
    if cfg.mesh_axis_sizes is None:
        cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**_lm_kw(**lm_kw)),
                         batch_size=batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _port_lm(params=None, argv=(), mesh=(1, 1, 1, 1), batch=1, **lm_kw):
    sys.argv = ["test"] + list(argv)
    from flexflow_tpu_torch import FFConfig, FFModel, load_params
    from flexflow_tpu_torch.models import (
        TransformerLMConfig,
        build_transformer_lm,
    )

    cfg = FFConfig(device="cpu")
    cfg.mesh_axis_sizes = mesh
    cfg.batch_size = batch
    ff = FFModel(cfg)
    build_transformer_lm(ff, TransformerLMConfig(**_lm_kw(**lm_kw)),
                         batch_size=batch)
    ff.compile()
    if params is not None:
        load_params(ff, params)
    return ff


def _params(ff) -> dict:
    return {n: {w: np.asarray(v) for w, v in ws.items()}
            for n, ws in ff._params.items()}


def _force_speculation(eng):
    """Bypass the payoff gate so every eligible round speculates (JAX
    tests/test_speculative.py:57-75): the honest gate declines on the
    CPU, where a drafter call costs as much as a target call."""
    def always(k_cap):
        d = {"k": min(eng.k_max, k_cap),
             "reason": "bootstrap",
             "chosen": "speculate" if k_cap >= 1 else "decode",
             "would_speculate": k_cap >= 1,
             "acceptance_ema": float(eng.acceptance_ema),
             "acceptance_samples": int(eng.acceptance_samples)}
        eng._decision_counts[d["chosen"]] += 1
        eng.decisions.append(d)
        return d

    eng._decide = always


def _reject_all(eng, tok):
    def propose(decoding, ks):
        return ({i: [tok] * k for i, k in ks.items()}, 1e-6)

    eng.drafter.propose = propose


@pytest.fixture(scope="module")
def pair():
    """The JAX target, its port twin and the JAX weights."""
    jff = _jax_lm()
    params = _params(jff)
    return jff, _port_lm(params), params


def _both(pair, **kw):
    """(port plain, JAX plain) streams of `kw`'s serve."""
    jff, tff, _ = pair
    prompts = kw.pop("prompts", PROMPTS)
    return (tff.serve(**kw).generate(prompts),
            jff.serve(**kw).generate(prompts))


def test_spec_all_accept_bit_identity(pair):
    jff, tff, params = pair
    kw = dict(slots=2, max_new_tokens=8, prefill_chunk=4)
    base, jbase = _both(pair, **kw)
    assert base == jbase
    eng = tff.serve(speculate=True, draft_model=_port_lm(params), **kw)
    jeng = jff.serve(speculate=True, draft_model=_jax_lm(), **kw)
    assert eng.generate(PROMPTS) == base == jeng.generate(PROMPTS)
    sp = eng.stats()["speculation"]
    assert sp["rounds"] >= 1, "the bootstrap round must have speculated"
    assert sp["draft_tokens"] > 0
    assert sp["accepted_tokens"] == sp["draft_tokens"]
    assert sp["acceptance_rate"] == 1.0 and eng.acceptance_ema == 1.0
    assert eng._c_spec_rounds.value == sp["rounds"]
    assert eng._h_spec_accept_rate.count > 0


def test_spec_all_reject_bit_identity(pair):
    jff, tff, params = pair
    kw = dict(slots=2, max_new_tokens=8, prefill_chunk=4)
    base, jbase = _both(pair, **kw)
    assert all(BAD not in g for g in base)
    out = {}
    for name, ff, draft in (("port", tff, _port_lm(params)),
                            ("jax", jff, _jax_lm())):
        eng = ff.serve(speculate=True, draft_model=draft, **kw)
        _force_speculation(eng)
        _reject_all(eng, BAD)
        out[name] = (eng.generate(PROMPTS), eng.stats()["speculation"],
                     eng.acceptance_ema)
    assert out["port"][0] == base == out["jax"][0] == jbase
    sp = out["port"][1]
    assert sp["rounds"] > 1 and sp["accepted_tokens"] == 0
    assert sp["rounds"] <= sp["emitted_tokens"] <= 2 * sp["rounds"]
    assert out["port"][2] < 0.5
    assert sp == out["jax"][1] and out["port"][2] == out["jax"][2]


def test_spec_slot_reuse_under_continuous_batching(pair):
    jff, tff, params = pair
    prompts = PROMPTS + [[2, 4, 6, 8], [33, 1]]
    kw = dict(slots=2, max_new_tokens=6, prefill_chunk=4)
    base, jbase = _both(pair, prompts=prompts, **kw)
    assert base == jbase
    eng = tff.serve(speculate=True, draft_model=_port_lm(params), **kw)
    _force_speculation(eng)
    assert eng.generate(prompts) == base
    assert eng.stats()["speculation"]["rounds"] > 1
    assert eng.scheduler.drained


def test_spec_paged_cow_radix_rollback_safety(pair):
    jff, tff, params = pair
    shared = [7, 7, 7, 7, 3, 3, 3, 3]
    prompts = [shared + [t] for t in (1, 2, 3)]
    kw = dict(slots=2, max_new_tokens=6, prefill_chunk=4,
              kv_block_size=4, kv_num_blocks=64)
    base, jbase = _both(pair, prompts=prompts, **kw)
    assert base == jbase and all(BAD not in g for g in base)
    eng = tff.serve(speculate=True, draft_model=_port_lm(params), **kw)
    assert eng.block_manager is not None
    _force_speculation(eng)
    _reject_all(eng, BAD)
    for ever in range(2):  # the second pass: cross-time radix hits
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        while not eng.scheduler.drained:
            eng.step()
            eng.block_manager.check_invariants()
        assert [r.generated for r in reqs] == base, f"pass {ever}"
    assert eng.block_manager.stats.cross_time_hits > 0
    assert eng.stats()["speculation"]["rounds"] > 1


def draft_chips_job(rank, params):
    """One rank of `--serve-draft-chips 2` on a world of 4."""
    ff = _port_lm(params, argv=["--serve-draft-chips", "2"],
                  mesh=(4, 1, 1, 1), batch=4)
    dff = _port_lm(params)
    eng = ff.serve(speculate=True, draft_model=dff, slots=4,
                   max_new_tokens=6, prefill_chunk=4)
    got = eng.generate(PROMPTS)
    _force_speculation(eng)
    forced = eng.generate(PROMPTS)
    sec = eng.speculation_section()
    return {"got": got, "forced": forced,
            "target": list(eng.decode_model.mesh.ranks),
            "drafter": list(eng.drafter.engine.decode_model.mesh.ranks),
            "member": (eng.member, eng.drafter.engine.member),
            "draft_chips": sec["draft_chips"], "colocated": sec["colocated"],
            "role": eng.drafter.engine.decode_model.config.serve_role,
            "rounds": eng.stats()["speculation"]["rounds"]}


def test_spec_draft_chips_disjoint_submesh(pair):
    from flexflow_tpu_torch.distributed import spawn

    jff, tff, params = pair
    kw = dict(slots=4, max_new_tokens=6, prefill_chunk=4)
    base, jbase = _both(pair, **kw)
    assert base == jbase
    jtarget = _jax_lm(mesh=(8, 1, 1, 1), batch=8)
    for node, ws in params.items():
        for w, v in ws.items():
            jtarget.set_weight(node, w, v)
    jeng = jtarget.serve(speculate=True, draft_model=_jax_lm(),
                         draft_chips=4, **kw)
    assert jeng.generate(PROMPTS) == base
    outs = spawn(draft_chips_job, 4, params, timeout=300)
    for rank, out in enumerate(outs):
        assert out["got"] == base and out["forced"] == base
        assert out["target"] == [0, 1] and out["drafter"] == [2, 3]
        assert out["member"] == (rank < 2, rank >= 2)
        assert out["draft_chips"] == 2 and not out["colocated"]
        assert out["role"] == "draft" and out["rounds"] >= 1


def warmstart_job(rank, params, ws):
    argv = ["--warmstart-dir", ws, "--search-budget", "4",
            "--enable-parameter-parallel"]
    ff = _port_lm(params, argv=argv, mesh=(1, 2, 1, 1), batch=2)
    dff = _port_lm(params, argv=argv, mesh=(1, 2, 1, 1), batch=2)
    kw = dict(slots=2, max_new_tokens=4, prefill_chunk=4)
    eng1 = ff.serve(speculate=True, draft_model=dff, **kw)
    src1 = (eng1.decode_model._plan_source,
            eng1.drafter.engine.decode_model._plan_source)
    out1 = eng1.generate(PROMPTS[:2])
    eng2 = ff.serve(speculate=True, draft_model=dff, **kw)
    src2 = (eng2.decode_model._plan_source,
            eng2.drafter.engine.decode_model._plan_source)
    return src1, src2, out1, eng2.generate(PROMPTS[:2])


def test_spec_warmstart_role_keyed_plan_cache(pair, tmp_path):
    """The first speculative engine searches both plans (rank 1 gets
    them by broadcast), the second takes both from the cache: the target
    at the plain serving address, the drafter at its role="draft" one."""
    from flexflow_tpu_torch.distributed import spawn

    _, _, params = pair
    outs = spawn(warmstart_job, 2, params, str(tmp_path / "ws"),
                 timeout=300)
    base = _both(pair, slots=2, max_new_tokens=4, prefill_chunk=4,
                 prompts=PROMPTS[:2])[0]
    for rank, (src1, src2, out1, out2) in enumerate(outs):
        assert src1 == (("search",) * 2 if rank == 0 else ("broadcast",) * 2)
        assert src2 == ("cache", "cache") if rank == 0 else \
            src2 == ("broadcast", "broadcast")
        assert out1 == out2 == base


def test_spec_acceptance_ema_shared_with_jax(tmp_path):
    """The EMA persisted at drain is read back by a fresh model of either
    package: one calibration DB, one pair key."""
    from flexflow_tpu.serving.speculative import load_acceptance as jload
    from flexflow_tpu_torch.serving.speculative import (
        DEFAULT_ACCEPTANCE,
        load_acceptance,
    )

    kw = dict(slots=2, max_new_tokens=8, prefill_chunk=4)
    ws_j, ws_t = str(tmp_path / "j"), str(tmp_path / "t")
    jff = _jax_lm(argv=["--warmstart-dir", ws_j])
    params = _params(jff)
    jeng = jff.serve(speculate=True,
                     draft_model=_jax_lm(argv=["--warmstart-dir", ws_j]),
                     **kw)
    jeng.generate(PROMPTS)
    tff = _port_lm(params, argv=["--warmstart-dir", ws_t])
    eng = tff.serve(speculate=True, draft_model=_port_lm(
        params, argv=["--warmstart-dir", ws_t]), **kw)
    eng.generate(PROMPTS)
    assert eng.pair_key == jeng.pair_key
    assert eng.acceptance_samples > 0
    assert eng.acceptance_ema != DEFAULT_ACCEPTANCE
    # the JAX package's entry read by a fresh port model, and back
    for ws, writer in ((ws_j, jeng), (ws_t, eng)):
        rate, n = load_acceptance(_port_lm(
            params, argv=["--warmstart-dir", ws]), writer.pair_key)
        assert (rate, n) == (pytest.approx(writer.acceptance_ema),
                             writer.acceptance_samples)
        rate, n = jload(_jax_lm(argv=["--warmstart-dir", ws]),
                        writer.pair_key)
        assert (rate, n) == (pytest.approx(writer.acceptance_ema),
                             writer.acceptance_samples)
    # a fresh port engine starts from the persisted EMA
    eng2 = _port_lm(params, argv=["--warmstart-dir", ws_t]).serve(
        speculate=True, draft_model=_port_lm(
            params, argv=["--warmstart-dir", ws_t]), **kw)
    assert eng2.acceptance_ema == pytest.approx(eng.acceptance_ema)


def test_spec_payoff_records_equal_jax(pair):
    from flexflow_tpu_torch.search.cost_model import price_verify_scale
    from flexflow_tpu_torch.serving.speculative import expected_accepted

    jff, tff, params = pair
    assert expected_accepted(0.8, 3) == pytest.approx(
        0.8 + 0.8 ** 2 + 0.8 ** 3)
    assert price_verify_scale(1) == 1.0
    assert price_verify_scale(5) == pytest.approx(2.0)
    kw = dict(slots=2, max_new_tokens=4, prefill_chunk=4)
    recs = {}
    for name, ff, draft in (("port", tff, _port_lm(params)),
                            ("jax", jff, _jax_lm())):
        eng = ff.serve(speculate=True, draft_model=draft, **kw)
        eng._decode_cost_s = 1.0
        eng._draft_cost_s = 0.1
        eng._verify_cost_s = {k + 1: 0.2 + 0.05 * k for k in range(1, 5)}
        eng.acceptance_ema, eng.acceptance_samples = 0.8, 10
        d = eng._decide(4)
        d0 = eng._decide(0)
        eng._verify_cost_s = {}
        d2 = eng._decide(2)
        recs[name] = (d, d0, d2, eng.decisions[-1] is d2)
    assert recs["port"] == recs["jax"]
    d = recs["port"][0]
    assert d["reason"] == "payoff"
    exp, x = 0.0, 1.0
    for _ in range(d["k"]):
        x *= d["acceptance_ema"]
        exp += x
    lhs = d["k"] * d["draft_cost_s"] + d["verify_cost_s"]
    assert d["lhs_s"] == pytest.approx(lhs, abs=1e-12)
    assert d["rhs_s"] == pytest.approx(exp * d["decode_cost_s"], abs=1e-12)
    assert d["chosen"] == ("speculate" if lhs < d["rhs_s"] else "decode")
    assert recs["port"][1]["reason"] == "no_headroom"
    assert recs["port"][2]["verify_cost_source"] == "assumed"


def test_spec_flag_and_argument_validation(pair):
    _, tff, params = pair
    ff = _port_lm(params, argv=["--serve-draft-chips", "1"])
    with pytest.raises(ValueError, match="--serve-draft-chips"):
        ff.serve(slots=2)
    ff = _port_lm(params, argv=["--serve-prefill-chips", "2"])
    with pytest.raises(ValueError, match="--serve-prefill-chips"):
        ff.serve(slots=2)
    with pytest.raises(ValueError, match="draft_model"):
        tff.serve(speculate=True, slots=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tff.serve(speculate=True, disaggregate=True, draft_model=tff,
                  slots=2)
    with pytest.raises(ValueError, match="--serve-spec-k"):
        tff.serve(speculate=True, draft_model=tff, spec_k=0, slots=2)
    with pytest.raises(ValueError, match="--serve-draft-chips"):
        tff.serve(speculate=True, draft_model=tff, draft_chips=1, slots=2)
    with pytest.raises(ValueError, match="positional table"):
        tff.serve(speculate=True, draft_model=_port_lm(sequence_length=16),
                  slots=2)
    with pytest.raises(ValueError, match="vocab"):
        tff.serve(speculate=True, draft_model=_port_lm(vocab_size=32),
                  slots=2)
    with pytest.raises(ValueError, match="1..0 prefill chips"):
        tff.serve(disaggregate=True, slots=2)
