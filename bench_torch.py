#!/usr/bin/env python3
"""Benchmark: Transformer LM training throughput of the PyTorch/CUDA port
on one GPU, the twin of `bench.py`'s primary leg.

    python3 bench_torch.py                          # lm-base on the card
    python3 bench_torch.py --device cpu             # lm-smoke on the CPU

The step is `bench.py:_measure_lm`'s: lm-base (`TRANSFORMER_LM_ZOO`;
vocab 32000, hidden 1024, 16 heads of 64, 12 layers, seq 512), batch 8,
`SGDOptimizer(lr=0.01)`, sparse CE from logits, bf16 activations over f32
masters, random tokens from seed 0, built through `FFModel.compile` and
run through `executor.build_train_step()`: on the card a CUDA graph
replayed per step, the twin of the jitted step bench.py replays. The
timing is bench.py's two-point method: the step is replayed n and 3n
times with one synchronisation at each end (three times each, medians),
and the slope, (t(3n) - t(n)) / 2n, is the time of one step with every
constant cost cancelled.

The last line is
  {"metric": "transformer_lm_tokens_per_sec_per_chip", "value": N,
   "unit": "tokens/s", "vs_baseline": MFU / 0.35}
(vs_baseline: the fraction of the 35%-MFU target of BASELINE.json). The
line before it gives the step time, MFU over the chip's bf16 peak from
the port's machine model (`flexflow_tpu_torch/search/machine_model.py`),
the device's idle share over a window of steps (CUDA events around each
step: the stream's busy time over the host clock's), the peak of
`torch.cuda.max_memory_allocated`, and the card's name and power limit
as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them. The device fixes the tier and the batch, as bench.py's CPU mode
does: `--device cpu` runs the tiny lm-smoke tier at batch 4 (5 steps) so
the tests can run the script; its numbers are the host's, not a
device's. `--steps` and `--warmup` shorten a run. bench.py's other legs
(the fit loop, attention, grad sync, sharding, rules, warm start,
migration, elastic, serving) are not here yet: ROADMAP A14; serving's
standalone driver is serve_bench_torch.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MFU_TARGET = 0.35  # BASELINE.json's north star
SEED = 0
# device -> (zoo tier, batch, n of the n / 3n replays)
RUNS = {"cuda": ("lm-base", 8, 20), "cpu": ("lm-smoke", 4, 5)}


def build(tier: str, batch: int, device: str):
    """bench.py's model: the tier at `batch`, bf16 over f32 masters on
    the card (f32 on the CPU, as bench.py's CPU mode), SGD(lr=0.01),
    sparse CE. Returns (model, its config, one staged batch)."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    lm = TRANSFORMER_LM_ZOO[tier]
    cfg = FFConfig(device=device)
    cfg.parse_args(["--seed", str(SEED), "-b", str(batch)]
                   + (["--dtype", "bf16"] if device == "cuda" else []))
    ff = FFModel(cfg)
    build_transformer_lm(ff, lm, batch_size=batch)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rs = np.random.RandomState(SEED)
    seq = lm.sequence_length
    toks = rs.randint(0, lm.vocab_size, (batch, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    labels = rs.randint(0, lm.vocab_size, (batch, seq, 1)).astype(np.int32)
    return ff, lm, ff._make_batch({"tokens": toks, "positions": pos}, labels)


def measure(device: str = "cuda", steps: int | None = None,
            warmup: int = 3) -> dict:
    """bench.py's two-point measurement of one training step of the
    device's tier (`RUNS`), n = `steps`. Returns the numbers of the
    detail line and of the metric line."""
    import torch

    from flexflow_tpu_torch.models import transformer_lm_flops_per_token
    from flexflow_tpu_torch.search.machine_model import card_line, detect_chip

    tier, batch, default_steps = RUNS[device]
    steps = steps or default_steps
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ff, lm, data = build(tier, batch, device)
    dev = ff.device
    chip = detect_chip(dev)
    step_fn = ff.executor.build_train_step()
    st = (ff._params, ff._state, ff._opt_slots, ff._step, ff._counters)
    losses = []

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def run(n):
        nonlocal st
        for _ in range(n):
            out = step_fn(*st, data)
            st = out[:5]
        losses.append(out[5])

    # the first call warms up, the second captures: every later one is a
    # replay of the captured step
    run(max(warmup, 2))
    sync()

    def t_of(n):
        ts = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            run(n)
            sync()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    per_step = None
    for _ in range(3):  # a negative slope is noise: measure again
        t1, t2 = t_of(steps), t_of(3 * steps)
        if t2 > t1:
            per_step = (t2 - t1) / (2 * steps)
            break
    if per_step is None:
        raise RuntimeError(f"bench_torch: no positive slope in 3 tries "
                           f"({t1:.4f} s for {steps}, {t2:.4f} s for "
                           f"{3 * steps})")

    idle = None
    if on_card:
        # the stream's busy time over a window of steps: CUDA events around
        # each step count what the device ran, not the host's gaps
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(steps)]
        sync()
        t0 = time.perf_counter()
        for a, b in marks:
            a.record()
            run(1)
            b.record()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(a.elapsed_time(b) for a, b in marks)
        idle = max(0.0, 1.0 - busy_ms / wall_ms)

    loss = [float(v) for v in losses]
    if not all(np.isfinite(loss)):
        raise RuntimeError(f"bench_torch: non-finite loss {loss}")
    tokens = batch * lm.sequence_length
    tok_s = tokens / per_step
    flops_tok = transformer_lm_flops_per_token(lm)
    mfu = tok_s * flops_tok / chip.peak_flops
    return {
        "tier": tier, "batch": batch, "seq": lm.sequence_length,
        "steps": steps, "device": (torch.cuda.get_device_name(dev)
                                   if on_card else "cpu"),
        "card": card_line() if on_card else None,
        "captured": on_card,
        "step_ms": per_step * 1e3,
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "peak_flops": chip.peak_flops,
        "chip_spec": chip.name,
        "mfu": mfu,
        "device_idle_share": idle,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None),
        "loss_first_last": [loss[0], loss[-1]],
    }


def metric_line(m: dict) -> dict:
    return {"metric": "transformer_lm_tokens_per_sec_per_chip",
            "value": m["tokens_per_s"], "unit": "tokens/s",
            "vs_baseline": m["mfu"] / MFU_TARGET}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=None,
                        help="n of the n / 3n replays (default 20 on the "
                        "card, 5 on the CPU)")
    parser.add_argument("--warmup", type=int, default=3)
    args = parser.parse_args(argv)
    if (args.steps is not None and args.steps < 1) or args.warmup < 0:
        parser.error("--steps must be >= 1 and --warmup >= 0")
    sys.argv = [sys.argv[0]]  # FFConfig reads argv: give it none of ours
    sys.path.insert(0, REPO)
    m = measure(args.device, args.steps, args.warmup)
    print(json.dumps(m), flush=True)
    print(json.dumps(metric_line(m)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
