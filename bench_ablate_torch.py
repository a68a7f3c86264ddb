#!/usr/bin/env python3
"""Ablation harness around bench_torch.py's model, to find where a
training step's time goes (the twin of `scripts/bench_ablate.py`).

    python3 bench_ablate_torch.py                    # lm-base, on the card
    ABL_FWD_ONLY=1 python3 bench_ablate_torch.py     # forward + loss only
    python3 bench_ablate_torch.py --device cpu       # lm-smoke, the CPU

Switches, from the environment (the JAX script's):
  ABL_ATTN=flash|xla    attention implementation (default flash)
  ABL_BATCH=N           batch size (default 8)
  ABL_NO_METRICS=1      the executor's metrics pass returns the counters
                        unchanged
  ABL_NO_OPT=1          the optimizer update is a no-op (the gradients
                        are still computed and synced)
  ABL_FWD_ONLY=1        forward and loss only, no gradient

The model is bench_torch.py's (`build`): bench.py's lm-base (vocab
32000, hidden 1024, 16 heads of 64, 12 layers, seq 512), bf16 over f32
masters, SGD(lr=0.01), sparse CE, random tokens from seed 0. The step, ablated or not, is the executor's:
on the card a CUDA graph per batch signature (`CapturedStep`), the first
call a warm-up, the second the capture, the rest replays. 3 warm-up
steps, then 20 timed between two synchronisations. On the card the
card's name and power limit (`nvidia-smi`) come on a line before the
result; the last line is the JAX script's JSON object. `--device cpu`
runs lm-smoke (bench.py's CPU size) for 5 steps after 1 warm-up, so the
tests can run the script; its numbers are the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# device -> (tier, timed steps, warm-up steps)
RUNS = {"cuda": ("lm-base", 20, 3), "cpu": ("lm-smoke", 5, 1)}


def switches(env=os.environ) -> dict:
    return {"attn": env.get("ABL_ATTN", "flash"),
            "batch": int(env.get("ABL_BATCH", "8")),
            "no_metrics": bool(env.get("ABL_NO_METRICS")),
            "no_opt": bool(env.get("ABL_NO_OPT")),
            "fwd_only": bool(env.get("ABL_FWD_ONLY"))}


def ablated_step(ex, fwd_only: bool):
    """The step to time: the executor's train step, or forward and loss
    alone (no autograd), both built as the executor builds a step (a
    CUDA graph on the card)."""
    if not fwd_only:
        return ex.build_train_step()
    import torch

    @torch.no_grad()
    def fwd_step(params, state, opt_slots, step, counters, batch, rng=None):
        x_inputs, labels = batch
        loss_fn = ex.make_loss_fn(state, x_inputs, labels, rng, step=step)
        lval, _ = loss_fn(params)
        step.add_(1)
        return (params, state, opt_slots, step, counters,
                ex.global_loss(lval))

    return ex._compiled("fwd_step", fwd_step, held=(0, 1, 2, 3, 4, 6))


def run(device: str = "cuda", env=os.environ) -> dict:
    """One ablated measurement; returns the JAX script's JSON object."""
    import dataclasses

    import torch

    from bench_torch import build, lm_of

    sw = switches(env)
    if sw["attn"] not in ("flash", "xla"):
        raise ValueError(f"ABL_ATTN={sw['attn']!r}: expected flash or xla")
    tier, steps, warmup = RUNS[device]
    batch = sw["batch"]
    cfg = dataclasses.replace(lm_of(tier), attention_impl=sw["attn"])
    ff, _, data = build(cfg, batch, device)
    ex = ff.executor
    if sw["no_metrics"]:
        ex.metrics.compute = lambda counters, logits, labels, **kw: counters
    if sw["no_opt"]:
        ex.optimizer.update = lambda grads, params, slots, step: (params,
                                                                  slots)
    step_fn = ablated_step(ex, sw["fwd_only"])
    state = (ff._params, ff._state, ff._opt_slots, ff._step, ff._counters)
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(ff.device)

    def steps_of(n):
        nonlocal state
        for _ in range(n):
            out = step_fn(*state, data, ff._rng)
            state = out[:5]
        return out[5]

    steps_of(warmup)
    sync()
    t0 = time.perf_counter()
    loss = steps_of(steps)
    sync()
    dt = time.perf_counter() - t0
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"bench_ablate: non-finite loss {float(loss)}")
    return {**sw, "ms_per_step": round(dt / steps * 1e3, 3),
            "tokens_per_sec": round(steps * batch * cfg.sequence_length / dt,
                                    1)}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    sys.argv = [sys.argv[0]]  # FFConfig reads argv: give it none of ours
    sys.path.insert(0, REPO)
    out = run(args.device)
    if args.device == "cuda":
        from flexflow_tpu_torch.search.machine_model import card_line

        print(card_line(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
