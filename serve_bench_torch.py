"""Serving benchmark for the PyTorch port: requests/s/chip, decode
tokens/s/chip, and the paged-KV headline — slots-at-fixed-HBM under a
shared-prefix trace. Twin of `scripts/serve_bench.py`.

The standalone harness for the serving metrics, with tunable load, for
serving-focused profiling. On the card (the default) it serves lm-base at
full width (vocab 32000, hidden 1024, 16 heads of 64, 12 layers, seq 512,
flash attention: K1, K2 and K3 through `serve()`); with `--device cpu` a
tiny LM (vocab 256, hidden 64, 4 heads, 2 layers, its sequence length
following the trace). Activations in float32 unless a flexflow flag says
otherwise (`--dtype bf16`); on the card fp32 matmuls cast their inputs
to bf16 (the default tensor-op math) unless
`--no-tensor-op-math-conversion`. The paired runs compute a token in
device calls of different widths (a prefix hit skips chunks; a verify
call holds K+1 rows), so their completions are bit-identical in exact
float32, and the cast can round the float32 differences apart. Under `torchrun --nproc-per-node N` the
model's mesh is the world; `--disaggregate` needs a world of 2+ ranks
(prefill on the first half) and `--draft-chips D` puts the drafter on
the world's last D ranks. Rank 0 prints.

  python serve_bench_torch.py [--requests N] [--slots S]
      [--prompt-len P] [--max-new-tokens T] [--shared-prefix K]
      [--arrival-rate R] [--burst B] [--layout paged|contiguous|both]
      [--disaggregate] [--speculate [--draft-chips D]]
      [--telemetry-dir DIR] [--device cpu] [flexflow flags]

--shared-prefix K (default: prompt-len // 2) prepends one K-token system
prompt to every request — the N-users-one-system-prompt trace the paged
layout's copy-on-write prefix sharing exists for.

--arrival-rate R > 0 switches from closed-loop (all requests queued up
front, back-to-back stepping) to OPEN-loop load: requests arrive on a
seeded Poisson process at R req/s, so queue wait and tail latency come
from arrival pressure, not from the drain order — the load model tail
percentiles are honest under. --burst B >= 1 modulates it: alternating
windows of 8 arrivals have their inter-arrival gaps divided by B (a
bursty trace at the same average rate). The report then carries
TTFT/TBT/queue-wait p50/p95/p99 from the engine's mergeable histograms
(engine.metrics_summary).

--disaggregate replaces the layout ablation with the DISAGGREGATION
ablation: the identical trace runs through the unified paged engine and
through serve(disaggregate=True) (split prefill/decode pools at the same
total chip count, KV moved per request by verified fftrans handoffs),
completions asserted bit-identical, and the payload carries both sides'
TTFT/TBT/queue-wait percentiles plus the handoff measured-vs-predicted
seconds.

--speculate replaces the layout ablation with the SPECULATION ablation
(docs/serving.md "Speculative decoding"): the identical trace runs
through the plain paged engine and through serve(speculate=True,
draft_model=...) with a seed-clone drafter (--draft-chips D > 0 places
it on a disjoint sub-mesh), completions asserted bit-identical, and the
payload carries both sides' TBT percentiles plus the acceptance rate,
round count, and payoff-gate decision tally.

With --layout both (default) the same trace runs through both KV layouts
and the report carries, next to each layout's req/s/chip:

  - prefix_hit_rate / cow_copies (paged),
  - kv_hbm_bytes_per_layer resident per layout, and
  - slots_at_fixed_hbm: contiguous KV rows ÷ the paged PEAK working set
    — how many more concurrent max_seq slots the pool recovers at equal
    HBM (vLLM's capacity metric).

Prints one JSON line per metric, the full per-layout payload last.
Exits 1 when the paired runs' completions differ, 2 on a flag it
refuses.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _peek_str(argv, flag, default):
    """A flexflow flag's value, left in argv for FFConfig to parse."""
    if flag in argv:
        return argv[argv.index(flag) + 1]
    return default


def _pop_int(argv, flag, default):
    if flag in argv:
        i = argv.index(flag)
        val = int(argv[i + 1])
        del argv[i:i + 2]
        return val
    return default


def _pop_str(argv, flag, default):
    if flag in argv:
        i = argv.index(flag)
        val = argv[i + 1]
        del argv[i:i + 2]
        return val
    return default


def _pop_float(argv, flag, default):
    if flag in argv:
        i = argv.index(flag)
        val = float(argv[i + 1])
        del argv[i:i + 2]
        return val
    return default


def _pop_flag(argv, flag):
    if flag in argv:
        argv.remove(flag)
        return True
    return False


def _drained(engine):
    """Both engine shapes: the disaggregated coordinator exposes its own
    drained property (covers both schedulers + pending handoffs)."""
    if hasattr(engine, "prefill_chips"):
        return engine.drained
    return engine.scheduler.drained


def _completed(engine):
    if hasattr(engine, "prefill_chips"):
        return engine.completed
    return engine.scheduler.completed


def open_loop_offsets(n, rate, burst, rs):
    """Seeded bursty-Poisson arrival offsets (seconds from window start):
    exponential inter-arrival gaps at `rate` req/s, with every other
    window of 8 arrivals compressed by `burst` — bursts at the same
    long-run average rate, the trace shape TTFT p95 is judged under."""
    import numpy as np

    gaps = rs.exponential(1.0 / rate, size=n)
    if burst > 1.0:
        for i in range(n):
            if (i // 8) % 2 == 0:
                gaps[i] /= burst
    return np.cumsum(gaps)


def run_trace(ff, layout, prompts, slots, max_new, arrival_rate=0.0,
              burst=1.0, disaggregate=False, speculate=False,
              draft_model=None, draft_chips=0, warm="slots", **serve_kw):
    """Run `prompts` through a fresh engine of `layout`; returns
    (completions, metrics_summary) with the measured window warmed +
    reset. arrival_rate > 0 drives the trace open-loop (submission by
    wall clock on a seeded bursty-Poisson process); otherwise all
    requests queue up front and the engine drains closed-loop.
    disaggregate=True routes through serve(disaggregate=True) — split
    prefill/decode pools at the same total chip count."""
    import time

    import numpy as np

    kw = {"max_new_tokens": max_new, "kv_layout": layout, **serve_kw}
    if slots:
        kw["slots"] = slots
    if disaggregate:
        kw["disaggregate"] = True
    if speculate:
        kw["speculate"] = True
        kw["draft_model"] = draft_model
        if draft_chips:
            kw["draft_chips"] = draft_chips
    engine = ff.serve(**kw)
    # warm the bucket/decode/copy executables so the measured drain is
    # steady state: a full slot-width batch compiles every decode batch
    # bucket (and, disaggregated, both sides' buckets + the KV-inject
    # programs) — a 1-request warmup leaves those compiles inside the
    # measured window, where they read as multi-second TTFT/TBT spikes.
    # warm="trace" pre-runs the whole trace once instead (the
    # disaggregation comparison below measures the steady state, where
    # every radix-hit-shrunk inject extent has already compiled)
    nwarm = (len(prompts) if warm == "trace"
             else max(1, min(len(prompts), slots or 1)))
    engine.generate(prompts[:nwarm])
    engine.reset_stats()
    if arrival_rate > 0:
        from flexflow_tpu_torch.distributed import (
            broadcast_json,
            is_coordinator,
            world_size,
        )

        offsets = open_loop_offsets(
            len(prompts), arrival_rate, burst, np.random.RandomState(7))
        agree = world_size() > 1
        t0 = time.perf_counter()
        i = 0
        while i < len(prompts) or not _drained(engine):
            now = time.perf_counter() - t0
            due = i
            while due < len(prompts) and offsets[due] <= now:
                due += 1
            if agree:
                # on a mesh rank 0's clock decides the arrivals: every
                # rank submits the same requests before the same step
                due = broadcast_json(
                    {"due": due} if is_coordinator() else None)["due"]
            while i < due:
                engine.submit(prompts[i])
                i += 1
            if _drained(engine):
                # idle between bursts: sleep to the next arrival instead
                # of spinning (open loop — the clock, not the engine,
                # paces submissions)
                time.sleep(max(0.0, offsets[i]
                               - (time.perf_counter() - t0)))
                continue
            engine.step()
        engine.note_drain(time.perf_counter() - t0)
    else:
        for p in prompts:
            engine.submit(p)
        engine.run_until_drained()
    done = sorted(_completed(engine),
                  key=lambda r: r.request_id)  # submission order: the
    # cross-layout parity check must not depend on completion timing
    stats = engine.metrics_summary()
    if speculate:
        # the speculation accounting for the measured window: acceptance
        # rate, rounds, and how the payoff gate actually decided
        stats["speculation"] = engine.stats()["speculation"]
    if disaggregate:
        # lift the per-side request-grain percentiles to the flat keys
        # the payload loop below reads: TTFT + queue wait observe on the
        # prefill side, TBT on the decode side
        for short, side in (("ttft", "prefill"), ("queue_wait", "prefill"),
                            ("tbt", "decode")):
            for q in ("p50", "p95", "p99"):
                key = f"{short}_{q}_s"
                v = (stats.get(side) or {}).get(key)
                if v is not None and key not in stats:
                    stats[key] = v
    return [r.generated for r in done], stats


def lm_config(device: str, prompt_len: int, max_new: int):
    """lm-base at full width on the card, else the tiny CPU tier whose
    sequence length follows the requested trace (a 48-token prompt with a
    32-token budget must not silently truncate to "length" finishes at
    the model's 64-row KV ceiling)."""
    from flexflow_tpu_torch.models import TransformerLMConfig

    if device.startswith("cuda"):
        return TransformerLMConfig(vocab_size=32000, hidden_size=1024,
                                   num_heads=16, num_layers=12,
                                   sequence_length=512,
                                   attention_impl="flash")
    seq = 64
    while seq < prompt_len + max_new + 8:
        seq *= 2
    return TransformerLMConfig(vocab_size=256, hidden_size=64,
                               num_heads=4, num_layers=2,
                               sequence_length=seq, attention_impl="xla")


def _emit(obj):
    from flexflow_tpu_torch.distributed import world_rank

    if world_rank() == 0:
        print(json.dumps(obj), flush=True)


def _refuse(msg: str) -> int:
    print(f"serve_bench: {msg}", file=sys.stderr)
    return 2


def bench(argv) -> tuple:
    """The benchmark on `argv`: (exit code, payload); the payload holds
    every printed number and the trace's completions by run."""
    argv = list(argv)
    n_requests = _pop_int(argv, "--requests", 16)
    slots = _pop_int(argv, "--slots", 0)  # 0 → FFConfig default
    prompt_len = _pop_int(argv, "--prompt-len", 8)
    max_new = _pop_int(argv, "--max-new-tokens", 16)
    shared_prefix = _pop_int(argv, "--shared-prefix", prompt_len // 2)
    kv_block_size = _pop_int(argv, "--kv-block-size", 0)
    arrival_rate = _pop_float(argv, "--arrival-rate", 0.0)
    burst = _pop_float(argv, "--burst", 1.0)
    layout = _pop_str(argv, "--layout", "both")
    disaggregate = _pop_flag(argv, "--disaggregate")
    speculate = _pop_flag(argv, "--speculate")
    draft_chips = _pop_int(argv, "--draft-chips", 0)
    device = _peek_str(argv, "--device", "cuda")
    if disaggregate and speculate:
        return _refuse("--disaggregate and --speculate are mutually "
                       "exclusive"), {}
    sys.argv = [sys.argv[0]] + argv
    if not kv_block_size:
        # block granularity must divide INTO the shared prefix for the
        # sharing to be visible; half the prefix keeps at least one full
        # shared block plus a partial tail (the COW case). Disaggregated
        # runs pin radix prefixes across time, so they need FINE blocks
        # and the deep pool they imply — the half-prefix heuristic at
        # e.g. 21 shared tokens yields 10-token blocks and a ~29-block
        # pool that thrashes between pinned prefixes and live decodes
        if disaggregate:
            kv_block_size = 4 if shared_prefix >= 4 else 0
        else:
            kv_block_size = max(2, min(16, shared_prefix // 2)) \
                if shared_prefix >= 4 else 0

    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.distributed import (
        initialize_from_env,
        world_size,
    )
    from flexflow_tpu_torch.models import build_transformer_lm

    initialize_from_env(device)
    if disaggregate and world_size() < 2:
        return _refuse(f"--disaggregate splits prefill and decode over "
                       f"the ranks of a torchrun world of 2 or more; this "
                       f"world holds {world_size()} (torchrun "
                       f"--nproc-per-node N serve_bench_torch.py ...)"), {}
    lm = lm_config(device, prompt_len, max_new)
    config = FFConfig()
    config.batch_size = 8
    ff = FFModel(config)
    build_transformer_lm(ff, lm, batch_size=8)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)

    draft = None
    if speculate:
        # seed-clone drafter: the same seed and layer names draw the same
        # weights, which puts acceptance at its upper extreme, so the leg
        # measures the verify-path ceiling (the TRANSFORMER_LM_ZOO *-draft
        # tiers are the realistic drafters; untrained random weights
        # would reject ~all proposals and measure nothing)
        dconfig = FFConfig()
        dconfig.batch_size = 8
        draft = FFModel(dconfig)
        build_transformer_lm(draft, lm, batch_size=8)
        draft.compile(
            optimizer=SGDOptimizer(lr=0.01),
            loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)

    # the shared-prefix trace: one system prompt opens every request
    # (served alone first so the partial tail block registers and later
    # extensions exercise COW), distinct suffixes after it
    rs = np.random.RandomState(0)
    system = rs.randint(1, lm.vocab_size, shared_prefix).tolist()
    tail = max(1, prompt_len - shared_prefix)
    prompts = [
        system + rs.randint(1, lm.vocab_size, tail).tolist()
        if (i or not system) else list(system)
        for i in range(n_requests)]

    serve_kw = {"kv_block_size": kv_block_size} if kv_block_size else {}
    if disaggregate:
        # the acceptance comparison: unified paged vs disaggregated on
        # the IDENTICAL trace at equal total chips — TTFT/TBT/queue-wait
        # percentiles print side by side under the _paged/_disagg keys
        layouts = ("paged", "disagg")
    elif speculate:
        # plain decode vs drafter+verify on the IDENTICAL trace — TBT
        # percentiles print side by side under the _paged/_spec keys
        layouts = ("paged", "spec")
    else:
        layouts = (("paged", "contiguous") if layout == "both"
                   else (layout,))
    results = {}
    completions = {}
    for lay in layouts:
        extra = dict(serve_kw) if lay in ("paged", "disagg", "spec") else {}
        if disaggregate and lay == "paged":
            # the baseline is the unified engine with prefix sharing
            # over LIVE residents only (no cross-time radix cache)
            extra["prefix_cache"] = False
        completions[lay], results[lay] = run_trace(
            ff, "paged" if lay in ("disagg", "spec") else lay, prompts,
            slots, max_new, arrival_rate=arrival_rate, burst=burst,
            disaggregate=(lay == "disagg"), speculate=(lay == "spec"),
            draft_model=draft, draft_chips=draft_chips,
            warm="trace" if (disaggregate or speculate) else "slots",
            **extra)
        _emit({
            "metric": f"serving_requests_per_sec_per_chip_{lay}",
            "value": round(
                results[lay].get("requests_per_sec_per_chip", 0.0), 4),
            "unit": "req/s",
        })
        # request-grain latency percentiles from the engine's mergeable
        # histograms (present whenever the window saw the observation)
        for short in ("ttft", "tbt", "queue_wait"):
            for q in ("p50", "p95", "p99"):
                key = f"{short}_{q}_s"
                if key in results[lay]:
                    _emit({
                        "metric": f"serving_{short}_{q}_s_{lay}",
                        "value": round(results[lay][key], 6),
                        "unit": "s",
                    })
    hint = ("" if not (device.startswith("cuda")
                       and config.allow_tensor_op_math_conversion) else
            " (the bf16 tensor-op cast on the card: the runs compute a "
            "token in calls of different widths, whose float32 "
            "differences the cast can round apart; "
            "--no-tensor-op-math-conversion compares exact float32)")
    if ("contiguous" in completions
            and completions["paged"] != completions["contiguous"]):
        print("serve_bench: FAIL — paged completions diverge from "
              "contiguous" + hint, file=sys.stderr)
        return 1, {"completions": completions}
    if "disagg" in completions:
        if completions["disagg"] != completions["paged"]:
            print("serve_bench: FAIL — disaggregated completions diverge "
                  "from the unified paged engine" + hint, file=sys.stderr)
            return 1, {"completions": completions}
        _emit({
            "metric": "serving_disagg_ttft_p95_s",
            "value": results["disagg"].get("ttft_p95_s"),
            "unified_ttft_p95_s": results["paged"].get("ttft_p95_s"),
            "handoffs": results["disagg"].get("handoffs", 0),
            "handoff_predicted_s": round(
                results["disagg"].get("handoff_predicted_s", 0.0), 6),
            "handoff_measured_s": round(
                results["disagg"].get("handoff_measured_s", 0.0), 6),
            "unit": "s",
        })
    if "spec" in completions:
        if completions["spec"] != completions["paged"]:
            print("serve_bench: FAIL — speculative completions diverge "
                  "from plain decode" + hint, file=sys.stderr)
            return 1, {"completions": completions}
        sp = results["spec"].get("speculation", {})
        _emit({
            "metric": "serving_spec_tbt_p95_s",
            "value": results["spec"].get("tbt_p95_s"),
            "plain_tbt_p95_s": results["paged"].get("tbt_p95_s"),
            "acceptance_rate": round(sp.get("acceptance_rate", 0.0), 4),
            "rounds": sp.get("rounds", 0),
            "decision_counts": sp.get("decision_counts", {}),
            "draft_chips": draft_chips,
            "unit": "s",
        })

    payload = {"shared_prefix": shared_prefix, "requests": n_requests,
               "prompt_len": prompt_len, "max_new_tokens": max_new,
               "arrival_rate": arrival_rate, "burst": burst,
               "load_model": "open" if arrival_rate > 0 else "closed",
               **{lay: results[lay] for lay in layouts}}
    if "paged" in results:
        st = results["paged"]
        _emit({
            "metric": "serving_prefix_hit_rate",
            "value": round(st.get("prefix_hit_rate", 0.0), 4),
        })
        if "contiguous" in results:
            # the engine computes this under `kv_peak_vs_contiguous`
            # (serving/engine.py stats()) — one definition, read here
            payload["slots_at_fixed_hbm"] = round(
                st["kv_peak_vs_contiguous"], 4)
            _emit({
                "metric": "serving_slots_at_fixed_hbm",
                "value": payload["slots_at_fixed_hbm"],
                "unit": "x contiguous",
            })
    _emit(payload)
    # the trace's completions, for callers that hold them to a reference
    payload["completions"] = completions
    return 0, payload


def main(argv=None) -> int:
    return bench(sys.argv[1:] if argv is None else argv)[0]


if __name__ == "__main__":
    sys.exit(main())
