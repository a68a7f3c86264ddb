#!/usr/bin/env python3
"""Async checkpointing overhead of the PyTorch/CUDA port (the twin of
`scripts/bench_checkpoint.py`; acceptance: steps/s with
--checkpoint-every within 10% of the run without checkpoints).

    python3 bench_checkpoint_torch.py                  # one card
    torchrun --nproc-per-node 4 bench_checkpoint_torch.py   # dp over 4
    python3 bench_checkpoint_torch.py --device cpu     # the CPU

Two numbers:

- **blocking cost**: what the step loop pays a save, the synchronous
  copy of the whole state tree `fit` checkpoints to the host
  (`resilience.checkpointer.snapshot_to_host`), min of 10;
- **wall-clock overhead**: the whole `fit`'s time with
  `--checkpoint-every` against the same fit without, at a dense cadence
  (every 8 steps) and a moderate one (every 32), interleaved (min of 5,
  so load drift hits both alike); the writer thread shares the host's
  cores with the step loop.

The model is the JAX script's MLP (64 -> 256 -> 256 -> 8, batch 8, SGD)
over 1024 random samples, dp over the world (the JAX script's 8-device
mesh; one card alone), each step the executor's (a CUDA graph on the
card). On the card the card's name and power limit (`nvidia-smi`) come
on a line before the results; the headline line (cadence 32) prints
last. Under torchrun only rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CADENCES = (8, 32)  # the headline, the documented acceptance cadence, last


def build(device: str, argv: list):
    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.distributed import world_size

    config = FFConfig(device=device)
    config.parse_args(argv)
    config.mesh_axis_sizes = (world_size(), 1, 1, 1)
    config.batch_size = 8
    ff = FFModel(config)
    x = ff.create_tensor((8, 64), name="x")
    t = ff.dense(x, 256, ActiMode.AC_MODE_RELU, name="fc1")
    t = ff.dense(t, 256, ActiMode.AC_MODE_RELU, name="fc2")
    ff.dense(t, 8, name="head")
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def timed_fit(ff, x, y, epochs: int) -> float:
    import torch

    t0 = time.perf_counter()
    ff.fit(x, y, epochs=epochs, batch_size=8, shuffle=False, verbose=False)
    if ff.device.type == "cuda":
        torch.cuda.synchronize(ff.device)
    return time.perf_counter() - t0


def run(device: str) -> list:
    """The lines to print: one per cadence, the headline last."""
    from flexflow_tpu_torch.distributed import (
        barrier,
        is_coordinator,
        shared_tempdir,
    )
    from flexflow_tpu_torch.resilience.checkpointer import snapshot_to_host
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    rs = np.random.RandomState(0)
    x = rs.randn(1024, 64).astype(np.float32)
    y = rs.randint(0, 8, (1024, 1)).astype(np.int32)

    probe = build(device, [])
    probe.fit(x[:64], y[:64], epochs=1, batch_size=8, shuffle=False,
              verbose=False)
    tree = model_state_tree(probe)
    snapshot_to_host(tree)  # warm
    t_snap = float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        snapshot_to_host(tree)
        t_snap = min(t_snap, time.perf_counter() - t0)
    del probe, tree

    root = shared_tempdir("bench_checkpoint_")
    results = []
    try:
        bare = build(device, [])
        timed_fit(bare, x, y, 1)  # warm-up and capture
        for every in CADENCES:
            ck = build(device, ["--checkpoint-dir",
                                os.path.join(root, str(every)),
                                "--checkpoint-every", str(every)])
            timed_fit(ck, x, y, 1)
            t_bare = t_ck = float("inf")
            for _ in range(5):
                t_bare = min(t_bare, timed_fit(bare, x, y, 2))
                t_ck = min(t_ck, timed_fit(ck, x, y, 2))
            results.append({
                "checkpoint_every": every,
                "overhead_frac": round(t_ck / t_bare - 1.0, 4),
                "baseline_s": round(t_bare, 4),
                "with_checkpoint_s": round(t_ck, 4),
            })
            del ck
    finally:
        barrier()
        if is_coordinator():
            shutil.rmtree(root, ignore_errors=True)
    where = ("host wall clock; the writer thread shares the host's cores "
             "with the step loop")
    lines = [{"metric": "async_checkpoint_overhead_frac", **r, "note": where}
             for r in results[:-1]]
    head = results[-1]
    lines.append({
        "metric": "async_checkpoint_overhead_frac", **head,
        "blocking_cost_ms_per_save": round(t_snap * 1e3, 2),
        "within_10pct": bool(head["overhead_frac"] < 0.10),
        "note": where + "; the step loop's blocking cost is "
                "blocking_cost_ms_per_save"})
    return lines


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    sys.argv = [sys.argv[0]]  # FFConfig reads argv: give it none of ours
    sys.path.insert(0, REPO)
    from flexflow_tpu_torch.distributed import (
        initialize_from_env,
        world_rank,
    )

    initialize_from_env(args.device)
    lines = run(args.device)
    if world_rank() == 0:
        if args.device == "cuda":
            from flexflow_tpu_torch.search.machine_model import card_line

            print(card_line(), flush=True)
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
