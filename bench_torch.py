#!/usr/bin/env python3
"""Benchmark: Transformer LM training throughput of the PyTorch/CUDA port,
the twin of `bench.py`: its primary leg and its secondary legs.

    python3 bench_torch.py                          # every leg, on the card
    python3 bench_torch.py --device cpu             # the primary leg, CPU
    python3 bench_torch.py --legs serving,rules     # some legs
    torchrun --nproc-per-node 4 bench_torch.py      # the legs on 4 cards

The primary leg is `bench.py:_measure_lm`'s step: lm-base
(`TRANSFORMER_LM_ZOO`; vocab 32000, hidden 1024, 16 heads of 64, 12
layers, seq 512), batch 8, `SGDOptimizer(lr=0.01)`, sparse CE from
logits, bf16 activations over f32 masters, random tokens from seed 0,
built through `FFModel.compile` and run through
`executor.build_train_step()`: on the card a CUDA graph replayed per
step, the twin of the jitted step bench.py replays. The timing is
bench.py's two-point method: the step is replayed n and 3n times with
one synchronisation at each end (three times each, medians), and the
slope, (t(3n) - t(n)) / 2n, is the time of one step with every constant
cost cancelled. A reading above 100% MFU raises: it is a timing fault.

The last line is
  {"metric": "transformer_lm_tokens_per_sec_per_chip", "value": N,
   "unit": "tokens/s", "vs_baseline": MFU / 0.35}
(vs_baseline: the fraction of the 35%-MFU target of BASELINE.json;
value and MFU per card of the mesh). The line before it gives the step
time, MFU over the chip's bf16 peak from the port's machine model
(`flexflow_tpu_torch/search/machine_model.py`), the device's idle share
over a window of steps (CUDA events around each step: the stream's busy
time over the host clock's), the peak of `torch.cuda.max_memory_allocated`,
and the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them.

`--legs` (a comma-separated list, or `all`) adds bench.py's secondary
legs, each printing bench.py's line(s) under bench.py's metric names and
keys, in bench.py's order; their payload fields (`seq4096`, `fit_loop`,
`grad_sync`, `param_sharding`, `serving`, `migration`, `elastic`,
`rules`, `warmstart`, with the primary leg's `peak_hbm_bytes_per_chip`)
go on one line before the primary line, which stays last. The legs:

  primary         the step above (`measure`);
  seq4096         lm-base at seq 4096, batch 1, 5 steps: packed flash vs
                  `--flash-transposed` (K5-K8 at that shape); with 2+
                  ranks also ring attention over `seq`
                  (`sequence_parallel_attention`);
  fit_loop        tokens/s of `fit` itself, per step vs
                  `pipeline_steps=4` (engine/);
  grad_sync       2+ ranks: dp over the world, replicated vs the stage-2
                  update, the resident bytes after warm-up, and
                  `parallel.ops.ring_reduce_scatter` on a (4096, 512)
                  fp32 buffer;
  param_sharding  2+ ranks: replicated vs stage 2 vs stage 3, parameter
                  bytes a card at rest, the peak, the step; and
                  `ring_all_gather` on the same buffer;
  serving         requests/s and decode tokens/s a card, the paged
                  shared-prefix trace against the contiguous layout (its
                  streams must agree), `slots_at_fixed_hbm`, the prefix
                  hit rate; speculation with a seed-clone drafter;
                  disaggregation with 2+ ranks;
  migration       4 ranks: dp 4 at stage 3 -> dp 2 x tp 2 through
                  `resilience.migrate_state`, measured vs predicted;
  elastic         4 ranks: an injected 50x drift, the trigger latency,
                  re-search seconds, the migration measured vs predicted,
                  the steps to recover;
  rules           `analysis.rules.verify_registry` at data 2 x model 4
                  (the oracle on this device): fingerprint, rule count,
                  wall time;
  warmstart       cold vs warm time to the first step against one fresh
                  `--warmstart-dir`.

The default is every leg on the card and the primary leg on the CPU.
bench.py's serial-schedule ablations (`ring_serial`, `sharded_serial`,
`stage3_serial`, the microbenches' `serial_s`) switch
`--no-overlap-collectives`, which is inert in the port (its rings have
one schedule): they print null with a `*_skipped` reason. A leg that
needs more ranks than the world holds prints `{"skipped": "<n> rank(s)
— ..."}`; every other leg runs or raises, and a raise ends the run with
a nonzero exit after the lines already printed. The serving leg runs in
exact float32 on the card (`--no-tensor-op-math-conversion`): under the
bf16 tensor-op cast a token computed in calls of different widths can
round apart (ROADMAP C9), and the leg holds the layouts' streams equal.

Sizes: on the card every leg runs at bench.py's TPU sizes (lm-base at
full width, 12 layers); `--device cpu` runs bench.py's CPU-mode sizes (lm-smoke, batch 4, 5 steps; the fit
and serving legs' smaller LM) so the tests can run the script, and the
seq4096 leg there runs lm-smoke at batch 1 with flash attention (the
plain versions). CPU numbers are the host's, not a device's. Under
torchrun (one process a card, its world the mesh) every rank runs every
leg and only rank 0 prints; on the card every line carries the card's
`nvidia-smi` name and power limit (`card`).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MFU_TARGET = 0.35  # BASELINE.json's north star
SEED = 0
# device -> (zoo tier, batch, n of the n / 3n replays)
RUNS = {"cuda": ("lm-base", 8, 20), "cpu": ("lm-smoke", 4, 5)}
LEGS = ("primary", "seq4096", "fit_loop", "grad_sync", "param_sharding",
        "serving", "migration", "elastic", "rules", "warmstart")
SERIAL_SKIPPED = ("--no-overlap-collectives is inert in the port: its "
                  "rings have one schedule, each hop posted before the "
                  "work on the block at hand")


def _on_card(device) -> bool:
    return str(device).startswith("cuda")


def _lm_data(lm, n: int):
    """`n` rows of random tokens, their positions and random labels, from
    the seed: bench.py's batches."""
    rs = np.random.RandomState(SEED)
    x = {"tokens": rs.randint(0, lm.vocab_size,
                              (n, lm.sequence_length)).astype(np.int32),
         "positions": np.tile(np.arange(lm.sequence_length, dtype=np.int32),
                              (n, 1))}
    y = rs.randint(0, lm.vocab_size,
                   (n, lm.sequence_length, 1)).astype(np.int32)
    return x, y


def build(tier, batch: int, device: str, tune=None, prepare=None, *,
          flags: tuple | None = None, momentum: float = 0.0):
    """bench.py's model: the tier (a zoo name or a TransformerLMConfig)
    at `batch`, SGD(lr=0.01, `momentum`), sparse CE. `flags` are the
    FFConfig's command-line flags, by default bf16 over f32 masters on
    the card (f32 on the CPU, as bench.py's CPU mode). `tune(config)`
    changes the FFConfig before the model is built (bench.py's hook);
    `prepare(ff)` runs before compile (a strategy). Returns (model, its
    config, one staged batch)."""
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

    lm = TRANSFORMER_LM_ZOO[tier] if isinstance(tier, str) else tier
    if flags is None:
        flags = ("--dtype", "bf16") if _on_card(device) else ()
    cfg = FFConfig(device=device)
    cfg.parse_args(["--seed", str(SEED), "-b", str(batch), *flags])
    if tune is not None:
        tune(cfg)
    ff = FFModel(cfg)
    build_transformer_lm(ff, lm, batch_size=batch)
    if prepare is not None:
        prepare(ff)
    ff.compile(optimizer=SGDOptimizer(lr=0.01, momentum=momentum),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff, lm, ff._make_batch(*_lm_data(lm, batch))


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors of a nested dict/list: this rank's share of
    the weights at rest (a stage-3 weight counts its slice)."""
    import torch

    total, stack = 0, [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif torch.is_tensor(t):
            total += t.numel() * t.element_size()
    return total


def _memory(ff, out: dict, on_card: bool):
    """bench.py's `out` forensics of a built and warmed model: the bytes
    in use after warm-up (card only, as XLA:CPU has no allocator stats),
    the update-sharding decision, this rank's parameter bytes at rest and
    the decision's predicted bytes a card."""
    import torch

    if on_card:
        out["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(ff.device))
    upd = getattr(ff, "_update_sharding", None) or {}
    out["update_sharding"] = bool(upd.get("enabled"))
    out["update_stage"] = int(upd.get("stage", 0))
    out["update_shards"] = int(upd.get("shards", 1))
    out["addressable_param_bytes_per_chip"] = _tensor_bytes(ff._params)
    pred = upd.get("predicted") or {}
    if pred:
        out["predicted_mem_bytes_per_chip"] = (
            pred["sharded_mem_bytes"] if upd.get("enabled")
            else pred["replicated_mem_bytes"])


def measure(device: str = "cuda", steps: int | None = None,
            warmup: int = 3, *, lm=None, batch: int | None = None,
            tune=None, prepare=None, out: dict | None = None) -> dict:
    """bench.py's two-point measurement of one training step, n =
    `steps`: of the device's tier (`RUNS`) or of `lm` at `batch`, with
    bench.py's `tune(config)` hook (and `prepare(ff)`, a strategy before
    compile); `out`, a dict, gets `_memory`'s forensics after warm-up
    and the run's peak allocation (`peak_hbm_bytes`, card only). Returns
    the numbers of the detail line and of the metric line. A reading
    above 100% MFU raises."""
    import torch

    from flexflow_tpu_torch.distributed import host_broadcast_object
    from flexflow_tpu_torch.models import transformer_lm_flops_per_token
    from flexflow_tpu_torch.search.machine_model import card_line, detect_chip

    tier, default_batch, default_steps = RUNS[
        "cuda" if _on_card(device) else "cpu"]
    steps = steps or default_steps
    batch = batch or default_batch
    on_card = _on_card(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ff, lm_cfg, data = build(lm or tier, batch, device, tune, prepare)
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
            res = step_fn(*st, data)
            st = res[:5]
        losses.append(res[5])

    # the first call warms up, the second captures: every later one is a
    # replay of the captured step
    run(max(warmup, 2))
    sync()
    if out is not None:
        _memory(ff, out, on_card)

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
        # rank 0's times decide for every rank of a torchrun world, so all
        # take the same number of steps
        t1, t2 = host_broadcast_object((t_of(steps), t_of(3 * steps)), 0)
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
    chips = ff.mesh.size
    tokens = batch * lm_cfg.sequence_length
    tok_s = tokens / per_step
    flops_tok = transformer_lm_flops_per_token(lm_cfg)
    mfu = tok_s * flops_tok / (chip.peak_flops * chips)
    if mfu > 1.0:
        raise RuntimeError(
            f"bench_torch: {mfu:.1%} MFU ({tok_s:.1f} tokens/s on "
            f"{chips} card(s) of {chip.name}) is above the peak: a timing "
            f"fault, not a result")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if out is not None and on_card:
        out["peak_hbm_bytes"] = int(peak)
    return {
        "tier": lm if isinstance(lm, str) else tier,
        "batch": batch, "seq": lm_cfg.sequence_length,
        "layers": lm_cfg.num_layers, "chips": chips,
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
        "max_memory_allocated": peak,
        "loss_first_last": [loss[0], loss[-1]],
    }


def metric_line(m: dict) -> dict:
    return {"metric": "transformer_lm_tokens_per_sec_per_chip",
            "value": m["tokens_per_s"] / m.get("chips", 1),
            "unit": "tokens/s",
            "vs_baseline": m["mfu"] / MFU_TARGET}


# ------------------------------------------------------------ the legs


class Bench:
    """One run's setting: the device, the lm-base depth (12, or
    `layers`: the torchrun bench leg of chip_smoke.py cuts it), the steps and warm-up of the legs' measurements, and the world
    (torchrun's, one process a card). `emit` prints a line on rank 0
    only, with the card line on the card."""

    def __init__(self, device: str, steps: int | None = None,
                 warmup: int | None = None, layers: int | None = None):
        from flexflow_tpu_torch.distributed import world_size

        self.device = device
        self.on_card = _on_card(device)
        tier, self.batch, default_steps = RUNS[
            "cuda" if self.on_card else "cpu"]
        self.steps = steps or default_steps
        # bench.py: 3 warm-up steps on the TPU, 1 in CPU mode
        self.warmup = warmup if warmup is not None else (
            3 if self.on_card else 1)
        self.cfg = lm_of(tier, layers if self.on_card else None)
        self.world = world_size()
        self._card = None

    def card(self) -> str | None:
        if self.on_card and self._card is None:
            from flexflow_tpu_torch.search.machine_model import card_line

            self._card = card_line()
        return self._card

    def emit(self, obj: dict):
        from flexflow_tpu_torch.distributed import world_rank

        if self.on_card:
            obj = dict(obj, card=self.card())
        if world_rank() == 0:
            print(json.dumps(obj), flush=True)

    def free(self):
        """What a leg's models left: the telemetry session a flag made,
        the collector's cycles, the allocator's cache."""
        import torch

        from flexflow_tpu_torch import telemetry

        telemetry.deactivate()
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def lm(self, tune=None, prepare=None, out=None, *, lm=None,
           batch=None, steps=None, warmup=None):
        """(tokens/s, MFU a card) of `_measure_lm`: bench.py's step of
        `lm` (default the run's LM) at `batch`, with its hooks."""
        m = measure(self.device, steps or self.steps,
                    self.warmup if warmup is None else warmup,
                    lm=lm or self.cfg, batch=batch or self.batch,
                    tune=tune, prepare=prepare, out=out)
        self.free()
        return m["tokens_per_s"], m["mfu"]


def lm_of(tier: str, layers: int | None = None):
    """A zoo tier's TransformerLMConfig, at `layers` when given."""
    from flexflow_tpu_torch.models import TRANSFORMER_LM_ZOO

    lm = TRANSFORMER_LM_ZOO[tier]
    return lm if layers is None else dataclasses.replace(lm,
                                                         num_layers=layers)


def _small_lm():
    """bench.py's CPU-mode LM of the fit-loop and serving legs: a
    dispatch-bound size."""
    from flexflow_tpu_torch.models import TransformerLMConfig

    return TransformerLMConfig(
        vocab_size=256, hidden_size=64, num_heads=2, num_layers=1,
        sequence_length=64, attention_impl="xla")


def seq4096_leg(b: Bench) -> dict:
    """bench.py's long-context leg (1229-1266) with
    `_attention_ablation_legs` (278): lm-base at seq 4096, batch 1, 5
    steps, 1 warm-up: packed flash (the number of record) vs
    `--flash-transposed`; on a world of 2+ ranks ring attention over
    `seq` (`sequence_parallel_attention`, the world on `seq`). The CPU
    runs lm-smoke at batch 1 with flash attention."""
    from flexflow_tpu_torch.parallel import sequence_parallel_attention

    if b.on_card:
        lcfg = dataclasses.replace(b.cfg, sequence_length=4096)
    else:
        lcfg = dataclasses.replace(b.cfg, attention_impl="flash")
    kw = dict(lm=lcfg, batch=1, steps=5, warmup=1)
    tps, mfu = b.lm(**kw)
    line = {
        "metric": "transformer_lm_tokens_per_sec_per_chip_seq4096",
        "value": round(tps, 2), "unit": "tokens/s",
        "vs_baseline": round(mfu / MFU_TARGET, 4),
    }
    legs = {"flash_packed_tokens_per_sec": round(tps, 2)}
    tps_t, _ = b.lm(tune=lambda c: setattr(c, "flash_packed_layout", False),
                    **kw)
    legs["flash_transposed_tokens_per_sec"] = round(tps_t, 2)
    legs["packed_vs_transposed"] = round(tps / tps_t, 4)
    n = b.world
    if n > 1:
        def ring_tune(c):
            c.mesh_axis_sizes = (1, 1, 1, n)  # data, model, pipe, seq

        tps_r, _ = b.lm(
            tune=ring_tune,
            prepare=lambda ff: ff.set_strategy(
                sequence_parallel_attention(ff)),
            **dict(kw, lm=dataclasses.replace(lcfg,
                                              attention_impl="ring")))
        legs["ring_overlap_tokens_per_sec"] = round(tps_r, 2)
        legs["ring_seq_shards"] = n
    else:
        legs["ring_overlap_tokens_per_sec"] = None
    legs["ring_serial_tokens_per_sec"] = None
    legs["ring_serial_skipped"] = SERIAL_SKIPPED
    line["ablation"] = legs
    b.emit(line)
    return line


def measure_fit_loop(b: Bench, lm, batch: int, batches_per_epoch: int,
                     epochs_timed: int, pipeline_steps: int) -> float:
    """bench.py's `_measure_fit_loop` (199): tokens/s of the real `fit`
    loop, per step (pipeline_steps 1) or through the chunked engine;
    one epoch warms up (and captures), `epochs_timed` are timed."""
    import torch

    ff, _, _ = build(lm, batch, b.device)
    x, labels = _lm_data(lm, batches_per_epoch * batch)
    kw = dict(batch_size=batch, shuffle=False, verbose=False,
              pipeline_steps=pipeline_steps)
    ff.fit(x, labels, epochs=1, **kw)  # warm-up and capture
    if b.on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ff.fit(x, labels, epochs=epochs_timed, **kw)
    if b.on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del ff
    b.free()
    return epochs_timed * batches_per_epoch * batch * lm.sequence_length / dt


def fit_loop_leg(b: Bench, pipeline_steps: int = 4) -> dict:
    """bench.py's `_fit_loop_legs` (248): the per-step fit vs
    `pipeline_steps` chunks (engine/). The card runs the run's LM, 16
    batches an epoch, 2 timed; the CPU bench.py's dispatch-bound LM, 32
    batches of 4."""
    if b.on_card:
        lm, batch, bpe, epochs = b.cfg, b.batch, 16, 2
    else:
        lm, batch, bpe, epochs = _small_lm(), 4, 32, 2
    eager = measure_fit_loop(b, lm, batch, bpe, epochs, 1)
    piped = measure_fit_loop(b, lm, batch, bpe, epochs, pipeline_steps)
    out = {
        "eager_tokens_per_sec": round(eager, 2),
        "pipelined_tokens_per_sec": round(piped, 2),
        "pipeline_steps": pipeline_steps,
        "speedup": round(piped / eager, 4),
    }
    b.emit({"metric": "transformer_lm_fit_tokens_per_sec_eager",
            "value": out["eager_tokens_per_sec"], "unit": "tokens/s"})
    b.emit({"metric": "transformer_lm_fit_tokens_per_sec_pipelined",
            "value": out["pipelined_tokens_per_sec"],
            "pipeline_steps": pipeline_steps,
            "speedup_vs_eager_fit": out["speedup"], "unit": "tokens/s"})
    return out


def _slope_s(fn, iters: int, sync) -> float:
    """bench.py's microbench slope: `fn(m)` runs m iterations; the
    seconds of one from m = iters and 3 iters, after a warm-up."""
    fn(iters)
    sync()
    t1 = time.perf_counter()
    fn(iters)
    sync()
    t1 = time.perf_counter() - t1
    t2 = time.perf_counter()
    fn(3 * iters)
    sync()
    t2 = time.perf_counter() - t2
    return max((t2 - t1) / (2 * iters), 0.0)


def _dp_mesh(b: Bench, n: int):
    """A dp-n mesh over the world, this rank's device, and a sync that
    waits for the device and for every rank."""
    import torch

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.config import resolve_device
    from flexflow_tpu_torch.distributed import barrier
    from flexflow_tpu_torch.machine import MeshShape, build_mesh

    dev = resolve_device(FFConfig(device=b.device))
    mesh = build_mesh(MeshShape((n, 1, 1, 1)), dev)

    def sync():
        if b.on_card:
            torch.cuda.synchronize(dev)
        barrier()

    return mesh, dev, sync


def ring_rs_microbench(b: Bench, n: int, rows: int = 4096, cols: int = 512,
                       iters: int = 8) -> dict:
    """bench.py's `_ring_rs_microbench` (408): seconds a reduce-scatter
    of a (rows, cols) fp32 buffer over dp n through
    `parallel.ops.ring_reduce_scatter`, the slope of `iters` and 3 x
    `iters` iterations (each result rescaled and tiled back, so the
    collective dominates and the carried value stays finite)."""
    import torch

    from flexflow_tpu_torch.parallel.ops import ring_reduce_scatter

    rows -= rows % (n * n)
    mesh, dev, sync = _dp_mesh(b, n)
    x = torch.arange(rows * cols, dtype=torch.float32,
                     device=dev).reshape(rows, cols)

    def loop(m):
        acc = x
        for _ in range(m):
            acc = (ring_reduce_scatter(acc, mesh=mesh, axis_name="data")
                   * 1e-3).repeat(n, 1)
        return acc

    return {"overlap_s": _slope_s(loop, iters, sync), "serial_s": None,
            "serial_skipped": SERIAL_SKIPPED, "bytes": rows * cols * 4}


def ring_ag_microbench(b: Bench, n: int, rows: int = 4096, cols: int = 512,
                       iters: int = 8) -> dict:
    """bench.py's `_ring_ag_microbench` (531): seconds an all-gather of a
    (rows, cols) fp32 buffer sharded over dp n through
    `parallel.ops.ring_all_gather`, each gathered copy rescaled and cut
    back to this rank's rows."""
    import torch

    from flexflow_tpu_torch.parallel.ops import ring_all_gather

    rows -= rows % n
    mesh, dev, sync = _dp_mesh(b, n)
    chunk = rows // n
    idx = mesh.group(("data",)).index
    x = torch.arange(rows * cols, dtype=torch.float32,
                     device=dev).reshape(rows, cols)[
                         idx * chunk:(idx + 1) * chunk].contiguous()

    def loop(m):
        acc = x
        for _ in range(m):
            full = ring_all_gather(acc, mesh=mesh, axis_name="data") * 1e-3
            acc = full[idx * chunk:(idx + 1) * chunk]
        return acc

    return {"overlap_s": _slope_s(loop, iters, sync), "serial_s": None,
            "serial_skipped": SERIAL_SKIPPED, "bytes": rows * cols * 4}


def grad_sync_leg(b: Bench) -> dict:
    """bench.py's `_grad_sync_legs` (342): the run's LM on dp over the
    world, replicated vs the stage-2 update, each with its bytes in use
    after warm-up (card) and the decision's predicted bytes a card; and
    the ring reduce-scatter microbench."""
    n = min(b.world, b.batch)
    legs = {"update_shards": n}
    if n <= 1:
        legs["skipped"] = f"{n} rank(s) — no grad sync to shard"
    else:
        def dp_tune(wus):
            def tune(c):
                c.mesh_axis_sizes = (n, 1, 1, 1)
                c.weight_update_sharding = wus
                c.weight_update_stage = 2 if wus else 0

            return tune

        for name, wus in (("replicated", False), ("sharded_overlap", True)):
            mem: dict = {}
            tps, _ = b.lm(tune=dp_tune(wus), out=mem)
            legs[f"{name}_tokens_per_sec"] = round(tps, 2)
            if "hbm_bytes_in_use" in mem:
                legs[f"{name}_hbm_bytes_in_use"] = mem["hbm_bytes_in_use"]
            if "predicted_mem_bytes_per_chip" in mem:
                legs[f"{name}_predicted_mem_bytes_per_chip"] = round(
                    mem["predicted_mem_bytes_per_chip"])
        legs["sharded_serial_tokens_per_sec"] = None
        legs["sharded_serial_skipped"] = SERIAL_SKIPPED
        legs["sharded_overlap_vs_replicated"] = round(
            legs["sharded_overlap_tokens_per_sec"]
            / legs["replicated_tokens_per_sec"], 4)
        legs["rs_microbench"] = ring_rs_microbench(b, n)
    b.emit({"metric": "grad_sync_ablation",
            **{k: v for k, v in legs.items() if k != "rs_microbench"}})
    return legs


def param_sharding_leg(b: Bench) -> dict:
    """bench.py's `_param_sharding_legs` (456): the run's LM on dp over
    the world, replicated vs stage 2 vs stage 3: tokens/s, the step,
    this rank's parameter bytes at rest, the run's peak allocation
    (card), the realized stage; and the ring all-gather microbench."""
    n = min(b.world, b.batch)
    legs = {"shards": n}
    if n <= 1:
        legs["skipped"] = f"{n} rank(s) — nothing to shard"
    else:
        def tune_of(stage):
            def tune(c):
                c.mesh_axis_sizes = (n, 1, 1, 1)
                c.weight_update_sharding = stage >= 2
                c.weight_update_stage = stage

            return tune

        for name, stage in (("replicated", 0), ("stage2", 2),
                            ("stage3", 3)):
            mem: dict = {}
            tps, _ = b.lm(tune=tune_of(stage), out=mem)
            legs[name] = {
                "tokens_per_sec": round(tps, 2),
                "step_time_s": round(b.batch * b.cfg.sequence_length / tps,
                                     6),
                "addressable_param_bytes_per_chip":
                    mem["addressable_param_bytes_per_chip"],
                "peak_hbm_bytes": mem.get("peak_hbm_bytes"),
                "update_stage": mem["update_stage"],
            }
        legs["stage3_serial"] = {
            "tokens_per_sec": None, "step_time_s": None,
            "addressable_param_bytes_per_chip": None,
            "peak_hbm_bytes": None, "update_stage": None,
            "skipped": SERIAL_SKIPPED}
        rep, s3 = legs["replicated"], legs["stage3"]
        legs["param_bytes_ratio"] = round(
            rep["addressable_param_bytes_per_chip"]
            / s3["addressable_param_bytes_per_chip"], 4)
        legs["stage3_vs_replicated"] = round(
            s3["tokens_per_sec"] / rep["tokens_per_sec"], 4)
        legs["ag_microbench"] = ring_ag_microbench(b, n)
    b.emit({"metric": "param_sharding_ablation",
            **{k: v for k, v in legs.items() if k != "ag_microbench"}})
    return legs


def _serve_lm(b: Bench, lm, batch: int):
    """The serving legs' model: f32 on the CPU; on the card f32 without
    the bf16 tensor-op cast (the layouts' streams are held equal)."""
    return build(lm, batch, b.device,
                 flags=(("--no-tensor-op-math-conversion",)
                        if b.on_card else ()))[0]


def serving_leg(b: Bench) -> dict:
    """bench.py's `_serving_legs` (866): requests/s and decode tokens/s a
    card through the continuous-batching engine, one request warming up;
    the paged shared-prefix trace against the contiguous layout (the
    completions must agree), its prefix hit rate, COW copies and
    `slots_at_fixed_hbm`; then the speculative engine (`spec_leg`) and,
    on 2+ ranks, the disaggregated one (`disagg_leg`)."""
    if b.on_card:
        lm = b.cfg
        n_requests, slots, prompt_len, max_new = 32, 8, 8, 16
        shared_prefix, block, sp_prompt_len = 64, 16, 96
    else:
        lm = _small_lm()
        n_requests, slots, prompt_len, max_new = 8, 4, 8, 8
        shared_prefix, block, sp_prompt_len = 9, 4, 12
    ff = _serve_lm(b, lm, slots)

    def drain(engine, prompts):
        engine.generate(prompts[:1])  # the buckets and the decode step
        engine.reset_stats()
        for p in prompts:
            engine.submit(p)
        engine.run_until_drained()
        return ([r.generated for r in engine.scheduler.completed],
                engine.metrics_summary())

    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, lm.vocab_size, prompt_len).tolist()
               for _ in range(n_requests)]
    _, stats = drain(ff.serve(slots=slots, max_new_tokens=max_new,
                              prefill_chunk=8), prompts)
    out = {
        "requests_per_sec_per_chip": round(
            stats.get("requests_per_sec_per_chip", 0.0), 4),
        "decode_tokens_per_sec_per_chip": round(
            stats.get("decode_tokens_per_sec_per_chip", 0.0), 2),
        "requests": stats["requests_completed"],
        "slots": slots,
        "max_new_tokens": max_new,
        "kv_layout": stats["kv_layout"],
        "ttft_p50_s": round(stats.get("ttft_p50_s", 0.0), 4),
        "no_token_requests": stats.get("no_token_requests", 0),
    }
    for short in ("queue_wait", "ttft", "tbt", "e2e"):
        for q in ("p50", "p95", "p99"):
            key = f"{short}_{q}_s"
            if key in stats:
                out[key] = round(stats[key], 6)

    system = rs.randint(1, lm.vocab_size, shared_prefix).tolist()
    tail = max(1, sp_prompt_len - shared_prefix)
    sp = [system + rs.randint(1, lm.vocab_size, tail).tolist()
          if i else list(system) for i in range(n_requests)]
    paged_eng = ff.serve(slots=slots, max_new_tokens=max_new,
                         prefill_chunk=8, kv_layout="paged",
                         kv_block_size=block)
    paged_out, pst = drain(paged_eng, sp)
    contig_out, cst = drain(ff.serve(slots=slots, max_new_tokens=max_new,
                                     prefill_chunk=8,
                                     kv_layout="contiguous"), sp)
    if paged_out != contig_out:
        raise AssertionError("paged completions diverge from contiguous on "
                             "the shared-prefix trace")
    out["paged"] = {
        "shared_prefix": shared_prefix,
        "kv_block_size": pst["kv_block_size"],
        "requests_per_sec_per_chip": round(
            pst.get("requests_per_sec_per_chip", 0.0), 4),
        "contiguous_requests_per_sec_per_chip": round(
            cst.get("requests_per_sec_per_chip", 0.0), 4),
        "prefix_hit_rate": round(pst.get("prefix_hit_rate", 0.0), 4),
        "cow_copies": pst.get("cow_copies", 0),
        "kv_blocks_in_use_peak": pst.get("kv_blocks_in_use_peak", 0),
        "kv_hbm_bytes_per_layer": pst.get("kv_hbm_bytes_per_layer", 0),
        "contiguous_kv_hbm_bytes_per_layer": cst.get(
            "kv_hbm_bytes_per_layer", 0),
        "slots_at_fixed_hbm": round(pst["kv_peak_vs_contiguous"], 4),
    }
    unified = sorted(paged_eng.scheduler.completed,
                     key=lambda r: r.request_id)
    if b.world >= 2:
        out["disagg"] = disagg_leg(ff, sp, slots, max_new, block, unified,
                                   pst)
    else:
        out["disagg"] = {"skipped": f"{b.world} rank(s) — no ranks to "
                                    f"split"}
    out["spec"] = spec_leg(b, ff, lm, sp, slots, max_new, block, unified,
                           pst)
    del ff, paged_eng
    b.free()

    b.emit({"metric": "serving_requests_per_sec_per_chip",
            "value": out["requests_per_sec_per_chip"], "unit": "req/s"})
    b.emit({"metric": "serving_decode_tokens_per_sec_per_chip",
            "value": out["decode_tokens_per_sec_per_chip"],
            "unit": "tokens/s"})
    b.emit({"metric": "serving_paged_slots_at_fixed_hbm",
            "value": out["paged"]["slots_at_fixed_hbm"],
            "prefix_hit_rate": out["paged"]["prefix_hit_rate"],
            "unit": "x contiguous"})
    dg = out["disagg"]
    if "prefill_chips" in dg:
        b.emit({"metric": "serving_disagg_ttft_p95_s",
                "value": dg.get("ttft_p95_s"),
                "unified_ttft_p95_s": dg.get("unified_ttft_p95_s"),
                "chips": f"{dg['prefill_chips']}p+{dg['decode_chips']}d",
                "unit": "s"})
        b.emit({"metric": "serving_disagg_prefix_hit_rate_cross_time",
                "value": dg.get("prefix_hit_rate_cross_time"),
                "no_cross_time": dg.get("prefix_hit_rate_no_cross_time")})
    sg = out["spec"]
    b.emit({"metric": "serving_spec_tbt_p95_s",
            "value": sg.get("tbt_p95_s"),
            "unified_tbt_p95_s": sg.get("unified_tbt_p95_s"),
            "acceptance_rate": sg.get("acceptance_rate"),
            "rounds": sg.get("rounds"), "unit": "s"})
    return out


def spec_leg(b: Bench, ff, lm, prompts, slots, max_new, block,
             unified_done, unified_stats) -> dict:
    """bench.py's `_spec_serving_leg` (1022): the shared-prefix trace
    through the speculative engine with a seed-clone drafter (the same
    seed and layer names: the same weights), colocated, its completions
    equal to the unified paged drain's."""
    draft = _serve_lm(b, lm, slots)
    eng = ff.serve(speculate=True, draft_model=draft, slots=slots,
                   max_new_tokens=max_new, prefill_chunk=8,
                   kv_block_size=block)
    eng.generate(prompts)  # buckets, drafter and verify steps, the EMA
    eng.reset_stats()
    for p in prompts:
        eng.submit(p)
    eng.run_until_drained()
    done = sorted(eng.scheduler.completed, key=lambda r: r.request_id)
    if [r.generated for r in done] != [r.generated for r in unified_done]:
        raise AssertionError("speculative completions diverge from the "
                             "unified paged engine on the shared-prefix "
                             "trace")
    st = eng.metrics_summary()
    sp = eng.stats()["speculation"]
    leg = {
        "draft_chips": eng.draft_chips,
        "k_max": eng.k_max,
        "rounds": sp["rounds"],
        "acceptance_rate": round(sp["acceptance_rate"], 4),
        "acceptance_ema": round(sp["acceptance_ema"], 4),
        "decision_counts": sp["decision_counts"],
        "requests": len(prompts),
        "decode_tokens_per_sec_per_chip": round(
            st.get("decode_tokens_per_sec_per_chip", 0.0), 2),
        "unified_decode_tokens_per_sec_per_chip": round(
            unified_stats.get("decode_tokens_per_sec_per_chip", 0.0), 2),
    }
    for q in ("p50", "p95"):
        key = f"tbt_{q}_s"
        if key in st:
            leg[key] = round(st[key], 6)
        if key in unified_stats:
            leg[f"unified_{key}"] = round(unified_stats[key], 6)
    return leg


def disagg_leg(ff, prompts, slots, max_new, block, unified_done,
               unified_stats) -> dict:
    """bench.py's `_disagg_serving_leg` (1083): the shared-prefix trace
    through `serve(disaggregate=True)` (prefill and decode on the two
    halves of the world, the KV over the ranks' links), its completions
    equal to the unified paged drain's; a second wave after the drain
    (the cross-time radix cache) against a `prefix_cache=False` engine."""

    def wave(engine):
        engine.reset_stats()
        for p in prompts:
            engine.submit(p)
        engine.run_until_drained()
        done = sorted(engine.completed, key=lambda r: r.request_id)
        return [r.generated for r in done], engine.metrics_summary()

    dis = ff.serve(disaggregate=True, slots=slots, max_new_tokens=max_new,
                   prefill_chunk=8, kv_block_size=block)
    dis.generate(prompts[:1])
    done, dst = wave(dis)
    if done != [r.generated for r in unified_done]:
        raise AssertionError("disaggregated completions diverge from the "
                             "unified paged engine on the shared-prefix "
                             "trace")
    fully_cached = sum(1 for h in dis.handoffs if h["injected_blocks"] == 0)
    _, dst2 = wave(dis)
    fully_cached += sum(1 for h in dis.handoffs
                        if h["injected_blocks"] == 0)
    nc = ff.serve(disaggregate=True, slots=slots, max_new_tokens=max_new,
                  prefill_chunk=8, kv_block_size=block, prefix_cache=False)
    nc.generate(prompts[:1])
    nc_done, _ = wave(nc)
    if nc_done != done:
        raise AssertionError("prefix_cache=False completions diverge — the "
                             "cross-time cache changed tokens")
    _, nst2 = wave(nc)
    leg = {
        "prefill_chips": dis.prefill_chips,
        "decode_chips": dis.decode_chips,
        "kv_block_size": block,
        "requests": len(prompts),
        "requests_per_sec_per_chip": round(
            dst.get("requests_per_sec_per_chip", 0.0), 4),
        "unified_requests_per_sec_per_chip":
            unified_stats.get("requests_per_sec_per_chip", 0.0),
        "handoffs": dst.get("handoffs", 0) + dst2.get("handoffs", 0),
        "fully_cached_handoffs": fully_cached,
        "handoff_predicted_s": round(dst2.get("handoff_predicted_s", 0.0)
                                     + dst.get("handoff_predicted_s", 0.0),
                                     6),
        "handoff_measured_s": round(dst2.get("handoff_measured_s", 0.0)
                                    + dst.get("handoff_measured_s", 0.0),
                                    6),
        "prefix_hit_rate_cross_time": round(
            (dst2.get("decode") or {}).get("prefix_hit_rate", 0.0), 4),
        "prefix_hit_rate_no_cross_time": round(
            (nst2.get("decode") or {}).get("prefix_hit_rate", 0.0), 4),
    }
    pre, dec = dst.get("prefill") or {}, dst.get("decode") or {}
    for short, side in (("ttft", pre), ("queue_wait", pre), ("tbt", dec)):
        for q in ("p50", "p95"):
            key = f"{short}_{q}_s"
            if key in side:
                leg[key] = round(side[key], 6)
            if key in unified_stats:
                leg[f"unified_{key}"] = round(unified_stats[key], 6)
    return leg


def _mesh_lm(b: Bench, mesh: tuple, batch: int, flags: tuple = ()):
    """bench.py's models of the migration and elastic legs: the run's LM
    on `mesh`, f32 (bench.py builds them without the bf16 policy),
    SGD(lr=0.01, momentum=0.9)."""
    return build(b.cfg, batch, b.device,
                 tune=lambda c: setattr(c, "mesh_axis_sizes", mesh),
                 flags=flags, momentum=0.9)[0]


def _need_four(b: Bench, what: str) -> dict | None:
    """The 4-rank legs' precondition: a skip below 4 ranks; a world of
    more is refused (bench.py's meshes are dp 4 and dp 2 x tp 2)."""
    if b.world < 4:
        return {"skipped": f"{b.world} rank(s) — {what}"}
    if b.world != 4:
        raise ValueError(f"bench_torch: the {what.split()[-1]} leg lays "
                         f"dp 4 over a world of exactly 4 ranks; this world "
                         f"holds {b.world}")
    return None


def migration_leg(b: Bench) -> dict:
    """bench.py's `_migration_legs` (696): the run's LM trained one epoch
    on dp 4 at stage 3, migrated live to dp 2 x tp 2 through
    `resilience.migrate_state`: the plan's transfers, bytes on the wire
    and predicted seconds against the measured."""
    from flexflow_tpu_torch.resilience import migrate_state

    skip = _need_four(b, "no cross-mesh migration")
    if skip is None:
        old = _mesh_lm(b, (4, 1, 1, 1), 4,
                       ("--weight-update-sharding=stage3",))
        x, y = _lm_data(b.cfg, 4)
        old.fit(x, y, epochs=1, batch_size=4, shuffle=False, verbose=False)
        new = _mesh_lm(b, (2, 2, 1, 1), 4)
        section = migrate_state(old, new)
        predicted, measured = section["predicted_s"], section["measured_s"]
        out = {
            "transfers": len(section["transfers"]),
            "bytes_on_wire": int(sum(section["bytes_on_wire"].values())),
            "predicted_s": round(predicted, 6),
            "measured_s": round(measured, 6),
            "measured_vs_predicted": (round(measured / predicted, 4)
                                      if predicted > 0 else None),
            "stage3_src": True,
            "errors": (section.get("analysis") or {}).get("errors"),
        }
        del old, new
        b.free()
    else:
        out = skip
    # bench.py's line: a skipped leg's reason is in the payload only
    b.emit({"metric": "migration_seconds",
            **{k: out[k] for k in ("predicted_s", "measured_s",
                                   "measured_vs_predicted", "transfers",
                                   "bytes_on_wire") if k in out},
            "unit": "s"})
    return out


def elastic_leg(b: Bench) -> dict:
    """bench.py's `_elastic_legs` (763): the run's LM on dp 4 fits one
    epoch, then takes an injected 50x drift (the drift monitor's
    prediction cut 50x) through an elastic fit of 2 epochs: the first
    drift decision's trigger latency, re-search seconds, migration
    measured vs predicted and the steps until a step's device time is
    back within 2x the pre-decision median. No drift decision raises."""
    from flexflow_tpu_torch.distributed import (
        barrier,
        is_coordinator,
        shared_tempdir,
    )

    skip = _need_four(b, "no dp=4 elastic leg")
    if skip is not None:
        out = skip
    else:
        tdir = shared_tempdir("bench_elastic_")
        try:
            ff = _mesh_lm(b, (4, 1, 1, 1), 4,
                          ("--telemetry-dir", tdir, "--diagnostics"))
            x, y = _lm_data(b.cfg, 24)  # 6 steps an epoch
            ff.fit(x, y, epochs=1, batch_size=4, shuffle=False,
                   verbose=False)
            ctrl = ff.enable_elastic(cooldown_steps=0, horizon_steps=1000,
                                     visible_devices_fn=lambda: [0, 1, 2, 3])
            diag = ff.get_diagnostics()
            diag.drift.set_prediction((ff._predicted_step_s or 1e-3) / 50)
            step_times = []
            orig_on_step = diag.on_step

            def probe(rec):
                orig_on_step(rec)
                if ctrl.decisions:
                    # after the first decision: no second re-plan in the
                    # recovery window
                    ctrl.cooldown_steps = 10_000
                dev = rec.get("device_time_s")
                if dev is not None:
                    step_times.append((int(rec.get("step", 0)), float(dev)))

            diag.on_step = probe
            ff.fit(x, y, epochs=2, batch_size=4, shuffle=False,
                   verbose=False)
            decisions = list(ctrl.decisions)
            del ff, ctrl, diag
            b.free()
        finally:
            barrier()
            if is_coordinator():
                shutil.rmtree(tdir, ignore_errors=True)
        drifts = [d for d in decisions if d.get("trigger") == "drift"]
        if not drifts:
            raise RuntimeError(f"bench_torch: the injected 50x drift fired "
                               f"no drift decision ({decisions})")
        d0 = drifts[0]
        dstep = int(d0["step"])
        pre = sorted(t for s, t in step_times if s <= dstep)
        norm = pre[len(pre) // 2] if pre else None
        rec_step = next((s for s, t in step_times
                         if s > dstep and norm and t <= 2 * norm), None)
        pred = d0.get("predicted_migration_s")
        meas = d0.get("migration_measured_s")
        out = {
            "decision": d0.get("decision"),
            "decisions": len(decisions),
            "trigger_latency_steps": dstep - int(d0["advisory"]["step"]),
            "research_s": round(d0.get("research_s") or 0.0, 6),
            "migration_predicted_s": (None if pred is None
                                      else round(pred, 6)),
            "migration_measured_s": (None if meas is None
                                     else round(meas, 6)),
            "migration_measured_vs_predicted": (
                round(meas / pred, 4) if pred and meas else None),
            "steps_to_recover": (rec_step - dstep
                                 if rec_step is not None else None),
            "lhs_s": d0.get("lhs_s"),
            "rhs_s": d0.get("rhs_s"),
        }
    b.emit({"metric": "elastic_replan",
            **{k: out[k] for k in (
                "decision", "trigger_latency_steps", "research_s",
                "migration_predicted_s", "migration_measured_s",
                "migration_measured_vs_predicted", "steps_to_recover",
                "skipped") if k in out},
            "unit": "s"})
    return out


def rules_leg(b: Bench) -> dict:
    """bench.py's `_rules_leg` (584): the static generated registry's
    content fingerprint and rule count, and the wall time of the whole
    verification sweep (the oracle on this device). A registry that
    fails verification raises."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.analysis import rules as ffrules

    cfg = FFConfig(device=b.device)
    mesh_sizes = {"data": 2, "model": 4, "dcn": 1, "seq": 1}
    cfg.mesh_axis_sizes = tuple(mesh_sizes.values())
    t0 = time.perf_counter()
    res = ffrules.verify_registry(mesh_sizes, cfg, device=b.device)
    wall = time.perf_counter() - t0
    errs = res.errors()
    if errs:
        raise RuntimeError(f"rule registry failed verification: "
                           f"{[str(f) for f in errs[:3]]}")
    clean = res.by_code("rules_clean")[0]
    out = {"fingerprint": clean.details["fingerprint"],
           "rules": clean.details["rules"], "scope": "static_registry",
           "verify_wall_s": round(wall, 3)}
    b.emit({"metric": "rules_verify_wall_s", "value": out["verify_wall_s"],
            "rules": out["rules"], "fingerprint": out["fingerprint"][:16],
            "unit": "s"})
    return out


def warmstart_leg(b: Bench) -> dict:
    """bench.py's `_warmstart_legs` (617): compile start to the first
    optimizer step done, cold then warm, against one fresh
    `--warmstart-dir`: an MLP of six 256-wide layers at batch 16 (named
    layers: the two compiles' fingerprints must match). On 2+ ranks the
    cold compile searches (budget 4, parameter parallelism, calibration
    of the top op) and the warm one takes the plan cache."""
    import torch

    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.distributed import (
        barrier,
        is_coordinator,
        shared_tempdir,
    )

    wdir = shared_tempdir("bench_warmstart_")
    multi = b.world > 1
    batch = 16

    def leg() -> float:
        config = FFConfig(device=b.device)
        config.batch_size = batch
        config.warmstart_dir = wdir
        if multi:
            config.search_budget = 4
            config.enable_parameter_parallel = True
            config.search_calibrate = 1
        ff = FFModel(config)
        x = ff.create_tensor((batch, 256), name="ws_x")
        t = x
        for i in range(6):
            t = ff.dense(t, 256, ActiMode.AC_MODE_RELU, name=f"ws_fc{i}")
        ff.dense(t, 32, name="ws_head")
        rs = np.random.RandomState(0)
        X = rs.randn(batch, 256).astype(np.float32)
        Y = rs.randint(0, 32, (batch, 1)).astype(np.int32)
        t0 = time.perf_counter()
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        ff.fit(X, Y, epochs=1, batch_size=batch, shuffle=False,
               verbose=False)
        if b.on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del ff
        b.free()
        return dt

    try:
        cold = leg()
        warm = leg()
    finally:
        barrier()
        if is_coordinator():
            shutil.rmtree(wdir, ignore_errors=True)
    out = {"cold_time_to_first_step_s": round(cold, 4),
           "warm_time_to_first_step_s": round(warm, 4),
           "speedup": round(cold / warm, 4)}
    b.emit({"metric": "warmstart_time_to_first_step_s",
            "cold": out["cold_time_to_first_step_s"],
            "warm": out["warm_time_to_first_step_s"],
            "speedup": out["speedup"], "unit": "s"})
    return out


LEG_FNS = {"seq4096": seq4096_leg, "fit_loop": fit_loop_leg,
           "grad_sync": grad_sync_leg, "param_sharding": param_sharding_leg,
           "serving": serving_leg, "migration": migration_leg,
           "elastic": elastic_leg, "rules": rules_leg,
           "warmstart": warmstart_leg}


def parse_legs(text: str | None, device: str) -> list:
    """`--legs`: a comma-separated list of LEGS, or `all`; by default
    every leg on the card and the primary leg on the CPU. Returned in
    bench.py's order."""
    if text is None:
        text = "all" if _on_card(device) else "primary"
    names = set(LEGS) if text == "all" else {
        t.strip() for t in text.split(",") if t.strip()}
    bad = sorted(names - set(LEGS))
    if bad or not names:
        raise ValueError(f"--legs {text!r}: unknown leg(s) {bad}; expected "
                         f"a comma-separated list of {', '.join(LEGS)} or "
                         f"'all'")
    return [leg for leg in LEGS if leg in names]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=None,
                        help="n of the n / 3n replays (default 20 on the "
                        "card, 5 on the CPU)")
    parser.add_argument("--warmup", type=int, default=None,
                        help="warm-up steps (default: the primary leg 3, "
                        "the others bench.py's: 3 on the card, 1 on the "
                        "CPU)")
    parser.add_argument("--legs", default=None,
                        help="comma-separated legs of " + ", ".join(LEGS)
                        + ", or all (default: all on the card, primary "
                        "on the CPU)")
    args = parser.parse_args(argv)
    if ((args.steps is not None and args.steps < 1)
            or (args.warmup is not None and args.warmup < 0)):
        parser.error("--steps must be >= 1, --warmup >= 0")
    try:
        legs = parse_legs(args.legs, args.device)
    except ValueError as e:
        parser.error(str(e))
    sys.argv = [sys.argv[0]]  # FFConfig reads argv: give it none of ours
    sys.path.insert(0, REPO)
    from flexflow_tpu_torch.distributed import initialize_from_env, world_rank

    initialize_from_env(args.device)  # the world under torchrun
    b = Bench(args.device, args.steps, args.warmup)
    payload: dict = {}
    primary = None
    if "primary" in legs:
        primary = measure(args.device, args.steps,
                          3 if args.warmup is None else args.warmup,
                          lm=b.cfg)
        b.free()
        if world_rank() == 0:
            print(json.dumps(primary), flush=True)
        payload["peak_hbm_bytes_per_chip"] = primary["max_memory_allocated"]
    for leg in legs[1 if primary else 0:]:
        payload[leg] = LEG_FNS[leg](b)
    if set(payload) - {"peak_hbm_bytes_per_chip"}:
        b.emit({"metric": "transformer_lm_bench_payload", **payload})
    if primary is not None and world_rank() == 0:
        print(json.dumps(metric_line(primary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
