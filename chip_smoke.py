#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                               # one card
    torchrun --nproc-per-node 4 chip_smoke.py           # the mesh, 4 cards

Run from the root of a checkout. It builds the port's kernels from the
sources in the checkout at first use (CUDA C++ with nvcc into
flexflow_tpu_torch/_build/, one nvcc per source, started together:
csrc/decode_attention.cu, csrc/flash_attention.cu,
csrc/flash_attention_sm90.cu and csrc/layer_norm.cu) and drives the main
paths of the lm-base Transformer LM (vocab 32000, hidden 1024, 16 heads
of dim 64, 12 layers, seq 512; random weights from seed 0; bf16
activations over fp32 master weights), serving and training, and the
per-head flash paths: lm-base under --flash-transposed, and lm-xxl-fsdp
(hidden 4096, 32 heads of dim 128, seq 2048, vocab 32000) at 4 of its 32
layers, in both layouts; then the layer API's path, ResNet-50 at full
width, lm-base's training under --telemetry-dir, and on a mesh: NCCL
with one rank, two gloo ranks sharing the card. The train and
decode steps are the executor's
captured ones (a CUDA graph per batch signature or q width: the first
call of each warms up, the second captures, the rest replay; the steps
that warm up or capture are left out of every median); phases 3/4, 6, 10
and 13 also run under `executor.eager()` (the steps op by op) and hold the
two to each other. The launch counts come from the kernels' wrappers,
which a replay cannot bump: a captured step adds what its capture
counted. So every serving and training run also profiles one step and
requires the port's kernels that the profiler saw on the device, by
name, to equal the counts of such a step, and a serving run may capture
each decode width at most once.
Phases, each fatal on failure:

  1. build and device: the card's name and power limit, the torch and
     CUDA versions, the nvcc builds of csrc/*.cu;
  2. kernel parity: every kernel (K1-K8) against its plain PyTorch version
     on the card, in float32 and bfloat16, at the main paths' shapes and
     ragged ones, the flash kernels on both layouts (K5-K7 in bfloat16 at
     lm-xxl-fsdp's (4, 32, 2048, 128) too) and the (out, lse) entry under
     an lse cotangent, and the decode kernels over a float32
     cache of values halfway between bfloat16 values (rounding on load);
     each K5-K8 launch of a case on the variant the shape takes: "sm90"
     (wgmma/TMA; K8 a thread-block cluster) for bf16 at head_dim 64 and
     128 (lm-base, lm-xxl, ragged s 130/300/1000, s_q < s_k causal,
     non-causal), "mma" for bf16 at head_dim 32 and 80 and on operands
     whose base TMA refuses, "simt" for float32; each sm90 K8 case twice,
     bitwise identical; K2 and K3 (split-K, merged in a fixed order) and
     K4 (at lm-base's rows, a ragged width and lm-xxl-fsdp's (8192,
     4096)) also bitwise identical on two launches; K1 also at the
     training rows, lm-base's (4096, 1024) and lm-xxl-fsdp's (8192, 4096);
  3. serving, paged KV layout: 16 requests of random tokens (4 share a
     64-token prefix), 64 new tokens each, through FFModel ->
     build_transformer_lm -> compile -> serve() -> engine.generate; the
     launch counts are set to 0 just before and read just after; then
     the same run under executor.eager(): the same greedy streams and
     launch counts, both medians and busy shares logged;
  4. serving, contiguous KV layout: the same requests, captured and
     eager; then both layouts again with the weights in float32,
     captured and eager (the same greedy streams), the layouts' streams
     compared (the first difference logged with each layout's top-2
     logits);
  5. first-step logits: the same weights in float32, one pure-decode step
     with the kernels against the same step with the plain versions;
  6. training: FFModel -> build_transformer_lm -> compile(SGD(lr=0.01),
     sparse CE, accuracy and CE metrics) -> fit over one repeated batch of
     8 x 512 random tokens, 3 warm-up and 10 timed steps; the launch
     counts are set to 0 just before and read just after: per step 12
     launches of K5, K6 and K7 and 25 of K1 and K4 (K5-K7 all of the
     "sm90" variant), no plain version, a
     finite loss that falls; tokens/s, the median step, MFU and the device
     busy share of one profiled step; then the same under
     executor.eager(): the same launches, and the masters after the same
     steps equal bit for bit (else within 1e-3 of each layer's largest
     entry), both medians and busy shares logged;
  7. training gradients: the same weights in float32, one step's
     gradients with the kernels against the same step with the plain
     versions;
  8. numbers: per kernel its time, the plain version's, one PyTorch
     call's for the same function (timed here only: the port never calls
     it; for the backward kernels the device time of the kernels of one
     SDPA backward, from the profiler) and the least time the card could
     take, at each path's shapes (K1 at the training rows and the
     pure-decode call, K4 also at lm-xxl-fsdp's (8192, 4096)); K5-K8 also
     on their "mma" variant at the same shapes;
  9. training lm-base under --flash-transposed, bf16, SGD(lr=0.01), fit
     over one batch of 8 x 512, 2 warm-up and 3 timed steps: per step 12
     launches of K5 and K8 ("sm90") on the transposed layout, none of K6
     or K7, 25 of K1 and K4, no plain version;
 10. training lm-xxl-fsdp at full width and 4 layers, bf16, SGD(lr=0.01),
     fit over one batch of 4 x 2048: packed, 2 warm-up and 3 timed steps,
     per step 4 launches each of K5, K6 and K7 (head_dim 128), none of
     K8; the packed run also under executor.eager() (masters compared as
     in phase 6, max_memory_allocated of both modes logged); then under
     --flash-transposed, as many steps, the same launches on the
     transposed layout; tokens/s, MFU, busy share;
 11. float32 gradients, kernels vs plain versions, as phase 7: lm-base
     under --flash-transposed at 2 layers, lm-xxl-fsdp at 1 layer (batch
     1 x 2048) in both layouts; then bfloat16 gradients of lm-xxl-fsdp at
     1 layer (batch 1 x 2048, packed: the sm90 K5-K7), kernels vs
     plain versions;
 12. bench_torch.py's measurement in this process (lm-base, 8 x 512,
     SGD, the captured step replayed n and 3n times, the slope per
     step): its detail line and its metric line;
 13. training ResNet-50 (the layer API's path: conv2d, pool2d, add, relu,
     flat, dense, softmax) at full width, FFModel -> build_resnet50 at
     batch 64, 224 x 224, 10 classes, bf16 over f32 masters ->
     compile(SGD(lr=0.01), sparse CE, accuracy) -> fit over one repeated
     batch of random images and labels, 3 warm-up and 10 timed steps,
     captured then under executor.eager(): a finite loss that falls, no
     launch of K1-K8, cuDNN or cuBLAS convolution kernels in a profiled
     step, the masters of both modes equal bit for bit (else within 1e-3
     of each layer's largest entry); images/s, median step, MFU (the
     convolutions' and the dense layer's FLOPs x 3), busy share, peak
     memory, NCHW<->NHWC transposes;
 14. phase 6's run under --telemetry-dir (a fresh temporary directory)
     and --metrics-interval 1, captured: trace.json a Chrome trace with
     compile, step and data_wait spans, metrics.jsonl with a manifest
     naming the card, a step record a step and a summary, metrics.prom;
     each step phase 6's launches; the recorded timed step times'
     median and the MFU gauge within 15% of phase 6's, the summary's
     p50 (a histogram estimate) within one bucket of phase 6's median;
 15. under an NCCL process group of one rank: phase 6's run (captured,
     14 steps) on a (1, 1, 1, 1) mesh, whose step has nothing to sum and
     runs no collective: it captures, launches phase 6's kernels, and its
     masters equal phase 6's bit for bit (else within GRAD_RTOL of each
     layer's largest entry); then the port's collectives (sync_grad's
     reduce-scatter, all-gather and all-reduce, ParamGather's all-gather
     and its backward's reduce-scatter) at lm-base's MLP shapes captured
     in one CUDA graph, replayed twice on new inputs, each output equal
     to its input (a sum over one rank);
 16. two gloo ranks spawned on the one card (each names cuda:0; NCCL
     takes no two ranks of one device), lm-base at full width and 2 of
     its 12 layers, eager (gloo cannot be captured), 3 steps of phase 6's
     global batch through fit: in float32 (tensor-op math off) and bf16,
     one rank alone, then dp 2 and tp 2 (megatron_transformer) held to it
     by each master's change and each step's loss (MESH_TOL), and in
     bf16 dp 2 under stage 2 (and stage 3 where gloo takes a ring hop of
     CUDA tensors: a probe pair tries batch_isend_irecv first) bit-equal
     to dp 2 replicated; every run launches K1, K4 and K5-K7 on each
     rank, tp's flash kernels on 8 of the 16 heads; per rank the median
     step, busy share of a profiled step and peak memory. Gloo moves
     every collective through host memory: its step times are not the
     port's speed on a mesh;
 17. the Unity search on lm-base at full width (12 layers, 8 x 512,
     bf16; search_torch.py): the launch counts set to 0, then
     `calibrate_graph(top_k=4)` measures the four most expensive distinct
     ops on the card (CUDA graphs of each op's forward and of its forward
     and backward, replayed between CUDA events): 4 ops, the attention
     node among them, K5, K6 and K7 launched on the "sm90" variant
     (counted per replay); each measured forward at least its roofline
     bound (its FLOPs at 989 TFLOP/s, or its inputs, weights and outputs
     moved once at 3.35 TB/s), the attention node's at least phase 8's K5
     time; then the joint search (budget 6, parameter parallelism) over
     the H100 model of one device, dp 4, dp 2 x tp 2 and tp 4: each a
     plan and a predicted step, logged with the unforced weight-update
     decision at dp 4 and the one-device prediction beside phase 6's
     measured step (the predictions' accuracy is logged, not gated);
 18. the pipelined lm-base (`build_transformer_lm_pipelined`: the 12
     blocks one PipelineBlocks op, fused qkv, tanh GELU, plain LayerNorm;
     flash; no pipe axis, so the stages run in order), bf16, SGD, fit
     over one batch of 8 x 512 as phase 6, captured then eager: per step
     24 launches of K5 (each block's forward and its recompute in the
     backward), 12 of K6 and K7 ("sm90"), 1 of K1 and K4 (the final
     LayerNorm), no plain version, a falling loss, the masters of both
     modes equal (as phase 6), tokens/s, MFU (the graph's FLOPs, the
     blocks' from `_pb_flops`), busy share and peak memory; its float32
     gradients at 2 layers, kernels vs plain versions (phase 7's bound);
     then the ring's block algebra at lm-base-seq4096's widths (1 x 16 x
     4096 x 64 in 4 shards of 1024): for each shard, the ring body with
     the hop replaced by that shard's arrival sequence of K/V blocks,
     out and the q, k, v gradients held to whole-sequence flash (K5-K7),
     causal, in float32 (1e-4) and bf16 (2e-2), counting the blocks' K5
     (with lse) and K6/K7 (lse cotangent in delta) launches; and K5-K7
     at the ring's block shape (diagonal and full), each held to its
     plain version and timed beside SDPA;
 19. lm-base at full width (12 layers, 8 x 512 a batch, bf16, SGD)
     through `fit` with checkpoints and chunks, over 2 shuffled epochs of
     8 distinct batches: (a) the per-step fit, then pipeline_steps 4 and
     3 (3+3+2: a ragged tail), each chunk one CUDA-graph replay over
     batches the prefetch thread staged: per-step losses and every
     master, slot, step, counter and the generator bit-equal to the
     per-step fit's, 16 steps' launches of K1, K4 and K5-K7 in each run
     and n steps' in each chunk replay, one capture per signature, the
     run's own peak memory at most 1.1x the per-step run's; (b) killed by
     a FaultInjector after step 10 with --checkpoint-dir (a fresh temp
     dir) and --checkpoint-every 4, per step and in chunks of 4 (the
     fault inside a chunk), and a SIGTERM the process sends itself from
     step 6's hook (drained at step 7 with a final snapshot); the
     per-step killed model resumes in this process (its captured step's
     captures unchanged across the restore), then a fresh process (this
     script with --resume-child) compiles with --auto-resume and
     finishes each run: every state tensor bit-equal to (a)'s per-step
     run; the checkpoint's bytes from its manifest, each save's
     blocking slice, the writer's serialize and commit times and each
     restore's time logged; (c) an async save between two replays, two
     more replays queued at once: the committed masters equal a host
     copy taken synchronously at that step; (d) two gloo ranks on the
     card compile lm-base (2 layers) under the search (--budget 6
     --enable-parameter-parallel --calibrate 4, rank 0 calibrating on the
     card) against one --warmstart-dir: the cold compile searches, the
     warm one takes the plan cache with 0 evaluations (and checkpoints
     its first step), a third with --auto-resume on that checkpoint
     directory restores the plan from the manifest; compile wall times
     and time to the first step logged;
 20. the observability half on lm-base at full width (12 layers, 8 x
     512, bf16, SGD, captured): (a) --telemetry-dir --diagnostics,
     health every step, --calibrate 4, 3 + 10 steps: no alert, the
     doctor's verdict "healthy", strategy_report.json naming the card
     and its per-op costs reproducing its total, the recorded median
     step within 15% of phase 6's; 12 more steps under
     --health-sample-every 4 fetch the loss on 1 step of 4; (b) the
     sanitizer off and on, 6 steps: the masters bit-equal, the replay
     time with probes on vs off; a NaN planted in the first LINEAR,
     MULTIHEAD_ATTENTION and LAYERNORM node and in the loss, forward and
     backward, per step (at step 2) and in chunks of 4 (at step 10): the
     device table names (op, phase, step) each time, one capture a
     signature; --health-abort-on nan_loss in chunks of 4: HealthAbort,
     the nan_loss alert naming the op, flight.json, the prefetch thread
     stopped; (c) --profile-every 4: the sampled steps run eagerly under
     torch.profiler, the report's profile section satisfies its
     attribution identity with at least 90% of the device time
     attributed, the five ops with the most measured time beside their
     predicted_s, the masters bit-equal to (a)'s; (d) the drift
     prediction planted at half phase 6's step with recalibration armed:
     one advisory, one recalibration on the card, one more capture, the
     masters bit-equal to (a)'s; (e) --watchdog-timeout 1 and a 3 s stall
     from the fault hook: the watchdog fires once, flight.json, the
     heartbeats name this rank; (f) phase 3's paged run with telemetry:
     the same streams, the median pure-decode step within 15% of phase
     3's, metrics_summary's TTFT / TBT / queue-wait / end-to-end
     percentiles, the engine's profile_step satisfying its identity; (g)
     --profiling: the per-op table of lm-base at 1 layer timed on the
     card, headed by it;
 22. elastic re-planning and in-process migration on lm-base at full
     width: (a) fit --elastic with 20(d)'s planted prediction: one drift
     decision with both payoff sides and the plan's origin, one more
     capture if it migrated, the masters bit-equal to the same run
     without --elastic, K1, K4 and K5-K7 a replay the same counts
     before and after; (b) migrate_state between two compiled models,
     with and without donation: predicted vs measured seconds, the peak
     allocated, the masters landed bit-equal, the fidelity entry where
     the move was priced; (c) --elastic-dry-run: a decision, the
     executor kept; (d) phase 3's paged serving re-planned with
     replan_mesh((1, 1, 1, 1)) after 8 steps: every stream equal to
     phase 3's, K3 from the rebuilt graphs, the wall time split into
     compile, migration, rebuild and recapture; 2 devices refused (past
     the one-rank world);
 23. the serving extras on lm-base at full width (8 slots, phase 3's 16
     prompts, 64 new tokens, paged): (a) speculative decoding with a
     seed-clone drafter (lm-base, the target's weights; its KV paged, a
     private run of blocks a slot), forced to speculate at k_max 4: in
     float32 every stream equal to phase 4's plain float32 paged stream,
     every proposal accepted; in bf16 the streams equal to phase 3's
     counted, the first divergence with the plain run's top-2 logit
     margin there; the verify step's ms at each q width, the draft and
     decode steps' ms, accepted tokens a round, tokens/s against plain,
     K3's launches from the drafter and from the target, the verify
     graphs captured; (b) lm-base-draft (its own random weights) under
     the honest payoff gate in float32: the decisions with both sides of
     the inequality and the acceptance EMA, every stream equal to plain;
     (c) the KV inject path on one card, float32: phase 3's prompts
     prefilled by one engine, their blocks lifted as device tensors
     (`extract_kv`) and admitted into a second (`admit_prefilled`):
     every stream equal to phase 4's plain float32 paged stream, the
     blocks injected, each inject's ms, and `kv_bytes_per_layer` equal
     to the pool tensors' bytes.

Under torchrun with more than one rank (one a card, NCCL) it runs only
the mesh (`mesh_main`): phase 16's checks, captured, lm-base at 4 layers,
4 steps, on dp N, dp N/2 x tp 2 and tp N, stages 2 and 3; then, in bf16,
dp N with no update flag (the update decision priced, as the JAX
package decides it) and the search's own plan (`--budget 6
--enable-parameter-parallel --calibrate 4 --search-mesh-shapes` on dp
N/2 x tp 2: rank 0 calibrates on its card, searches the mesh's
factorizations and broadcasts the mesh and plan), each held to one rank;
then, in float32 and bf16, 4 steps each: lm-base-seq4096 at 12 layers
(batch 1 x 4096) on sp N (`sequence_parallel_attention`, ring
attention) held to one rank of the same model with flash attention, and
the pipelined lm-base (12 layers, 8 x 512, 2 P microbatches) on pp N
and dp 2 x pp N/2 held to its one-rank run; then phase 19's leg
(`mesh_resume_check`): lm-base at 4 layers saved under dp N at stage 3
(the shards gathered by the save), restored under dp N/2 x tp 2 and on
one rank with the masters bit-equal to the saved ones, the next 2 steps
held to one rank's, and a SIGTERM sent to rank 0 alone stopping every
rank at the same step; then phase 20's leg (`mesh_diag_check`): lm-base at 4 layers at dp N
with --diagnostics, a NaN in rank 1's forward alone and a rule firing on
rank 1 alone (per step and in chunks of 2) stopping every rank at the
same step with HealthAbort, and a 3 s stall inside rank 2's step under
--watchdog-timeout 1 whose heartbeats name rank 2; then phase 21's leg
(`mesh_barrier_check`); then C5's (`mesh_c5_check`): a HealthAbort and
an SPMDDivergenceError out of a captured fit on every rank, each caught,
then no stream capturing, the aborted step freed, a fresh compile
replaying, an all-reduce returning; then phase 22's (`mesh_elastic_check`):
lm-base at 12 layers, dp N at stage 2, a forced shrink onto the first
N/2 ranks (the others parked) bit-equal to a checkpoint-restart there, a
regrow to dp N by the payoff, a count past the world declined, every rank
leaving at the same step; then the serving leg (`mesh_serve_check`,
lm-base at 12 layers, float32, paged, 8 slots, phase 3's 16 prompts,
every stream held to the rank's one-rank engine): (e) serving on a mesh
at tp N and dp 2 x tp N/2 (Megatron plans: heads and the KV pools'
features over `model`, the pools replicated over `data`), the per-rank
decode step and its NCCL ms, then dp 2 on ranks [0, 2) re-planned
mid-decode to dp 2 x tp N/2 over the world; (f) prefill on ranks
[0, N/2) and decode on [N/2, N), the KV rows handed device to device
over NCCL, each handoff's blocks, bytes and measured vs predicted
seconds, then one ratio shift; (g) speculation with lm-base-draft on the
last N/2 ranks (--serve-draft-chips), forced;
rank 0 prints every rank's runs (the chosen mesh
and plan among them), the card line and {"ok": ..., "world": N} last.

It exits non-zero, printing no result, without a CUDA device. The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON. `--json PATH` also writes every number of the run there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import sys
import time
from typing import NamedTuple
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): HBM3 rate, dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain version on the same inputs. float32: the kernels sum in
# another order (runs of keys merged, online softmax, warp-shuffle row
# reductions) over up to 512 keys or 4096 features. bfloat16: P and the
# outputs are rounded to 8 bits of mantissa at different points.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Phase 5: float32 logits of lm-base (12 layers) with the kernels vs with
# the plain versions; only the kernels' summation order differs.
LOGITS_ATOL = 1e-3
# Phase 7: float32 gradients of one lm-base train step with the kernels vs
# with the plain versions. The kernels sum in another order (64-key online
# softmax against one pass, tiled f32 products, warp row reductions), so
# a gradient may differ by a few f32 ulps of its layer's largest gradient
# entries, grown through 12 layers: the bound is relative to the largest
# entry over the layer's gradients (the key bias's exact gradient is 0, so
# its own entries are rounding noise and no scale).
GRAD_RTOL = 1e-3
# Phase 11's bfloat16 case: one lm-xxl-fsdp layer's bf16 gradients with the
# kernels vs with the plain versions. Both round P, dS and every output to
# bf16 (a relative step of 2^-8 = 3.9e-3), but at different points (the
# kernels' online softmax rounds P against a running row max) and after
# sums in another order, so an attention output or gradient differs by a
# few bf16 steps of its largest entries, and the layer's products carry
# that into every weight gradient: the bound is 5e-2 of the layer's
# largest gradient entry, about 13 such steps.
GRAD_RTOL_BF16 = 5e-2

SEED = 0
SLOTS, MAX_SEQ, CHUNK, BLOCK = 8, 512, 16, 16
HEADS, HEAD_DIM = 16, 64
EMBED = HEADS * HEAD_DIM
NEW_TOKENS = 64
# decode parity/timing lengths: an empty slot, one key, both sides of a
# block boundary, partial and full caches
LENGTHS = [0, 1, 15, 16, 17, 300, 512, 384]
# training: bench.py's batch and sequence, SGD(lr=0.01); one repeated batch
TRAIN_BATCH, TRAIN_SEQ = 8, 512
WARMUP_STEPS, TIMED_STEPS = 3, 10
# the head-dim-128 tier: full width; 4 of its 32 layers (32 layers of
# replicated SGD state, ~6.7 B parameters x 10 bytes, are more than one
# card holds with the activations of 2048-token rows); the attention
# kernels see the same shapes at every depth
XXL, XXL_LAYERS, XXL_BATCH = "lm-xxl-fsdp", 4, 4


def log(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    """A check of this run's results: fatal, and kept under `python -O`."""
    if not cond:
        raise AssertionError(msg)


CUDA_SOURCES = ("decode_attention", "flash_attention", "flash_attention_sm90",
                "layer_norm")


def build_kernels() -> dict:
    """nvcc every CUDA source of the port at once (one process each);
    returns {source: seconds}. Prints what ptxas says of registers and
    spills."""
    from concurrent.futures import ThreadPoolExecutor

    from flexflow_tpu_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        took = dict(pool.map(one, CUDA_SOURCES))
    for name in CUDA_SOURCES:
        log(f"nvcc sm_90a build of csrc/{name}.cu: {took[name]:.1f} s -> "
            f"{os.path.relpath(_build.library_path(name), REPO)}")
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
    return took


def check_close(name, got, want, dtype_name, errs):
    """Hold a kernel's output against its plain version; record the max
    abs error; raise on disagreement or a non-finite output."""
    import torch

    g, w = got.float().cpu(), want.float().cpu()
    require(bool(torch.isfinite(g).all()), f"{name}: kernel output is not "
            f"finite")
    err = float((g - w).abs().max())
    errs[name] = max(errs.get(name, 0.0), err)
    tol = TOL[dtype_name]
    if not torch.allclose(g, w, **tol):
        raise AssertionError(
            f"{name} [{dtype_name}]: max abs err {err:.3e} beyond {tol}")
    return err


# ------------------------------------------------------------ inputs


def decode_inputs(dev, q_dtype, seed):
    """Contiguous cache at the main path's shape (slots, max_seq + 1,
    embed), f32 at rest, NaN in every row past each slot's length."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n = len(LENGTHS)
    q = torch.randn(n, 1, EMBED, generator=g).to(dev, q_dtype)
    k = torch.randn(n, MAX_SEQ + 1, EMBED, generator=g)
    v = torch.randn(n, MAX_SEQ + 1, EMBED, generator=g)
    for s, length in enumerate(LENGTHS):
        k[s, length:] = float("nan")
        v[s, length:] = float("nan")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return q, k.to(dev), v.to(dev), lengths.to(dev)


def paged_inputs(dev, q_dtype, seed):
    """Pool of the main path's size (slots * W + 1 blocks), a scrambled
    page table, slot 5 sharing all of slot 6's blocks and slot 7 its first
    8, unmapped entries on the scratch block 0, and NaN in every pool row
    no slot reads."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n, W = len(LENGTHS), MAX_SEQ // BLOCK
    nb = n * W + 1
    perm = torch.randperm(nb - 1, generator=g) + 1
    table = torch.zeros(n, W, dtype=torch.int32)
    for s, length in enumerate(LENGTHS):
        used = -(-length // BLOCK)
        table[s, :used] = perm[s * W:s * W + used].to(torch.int32)
    table[5] = table[6]
    table[7, :8] = table[6, :8]
    pk = torch.randn(nb, BLOCK, EMBED, generator=g)
    pv = torch.randn(nb, BLOCK, EMBED, generator=g)
    live = torch.zeros(nb, BLOCK, dtype=torch.bool)
    for s, length in enumerate(LENGTHS):
        for r in range(length):
            live[table[s, r // BLOCK], r % BLOCK] = True
    pk[~live] = float("nan")
    pv[~live] = float("nan")
    q = torch.randn(n, 1, EMBED, generator=g).to(dev, q_dtype)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return q, pk.to(dev), pv.to(dev), table.to(dev), lengths.to(dev)


def halfway_inputs(lengths, seq, heads, head_dim, seed):
    """A float32 cache whose K and V values lie halfway between two
    bfloat16 values, on the CPU: (q, k, v, lengths), q's values exact in
    bfloat16. Under bfloat16 compute the kernels must round each K/V
    element on load (to nearest even: 257 -> 256), as the JAX op's cast of
    the whole cache does; a kernel that skips it is off by far more than
    the bfloat16 tolerance. Per head, only dim 0 of q is set (to 8), so:

      k[j, 0] = 257 for even j, 256 for odd j: rounded, every logit is
        equal; unrounded, even keys gain 8 * scale (1 at head_dim 64);
      v[j, 0] = 1 for even j, 0 for odd j reads those weights out
        (0.5 rounded, 0.73 unrounded over an even count of keys);
      v[j, 1] = 257 for even j, -256 for odd j: 0 rounded, 0.5 with V
        unrounded.

    Every other element is random and exact in bfloat16; rows past each
    slot's length hold NaN."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n, e = len(lengths), heads * head_dim

    def grid(*shape):  # random values exact in bfloat16
        return torch.randn(*shape, generator=g).bfloat16().float()

    q = torch.zeros(n, 1, heads, head_dim)
    q[..., 0] = 8.0
    k = grid(n, seq, heads, head_dim)
    v = grid(n, seq, heads, head_dim)
    even = (torch.arange(seq) % 2 == 0)[None, :, None]
    k[..., 0] = torch.where(even, 257.0, 256.0)
    v[..., 0] = torch.where(even, 1.0, 0.0)
    v[..., 1] = torch.where(even, 257.0, -256.0)
    for s, length in enumerate(lengths):
        k[s, length:] = float("nan")
        v[s, length:] = float("nan")
    return (q.reshape(n, 1, e), k.reshape(n, seq, e), v.reshape(n, seq, e),
            torch.tensor(lengths, dtype=torch.int32))


def pooled(k, v, lengths, block, seed):
    """The contiguous caches k, v (slots, S, E) laid out in a block pool
    through a scrambled page table; unmapped entries on the scratch block
    0, NaN in every row no slot reads. Returns (pool_k, pool_v, table)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n, seq, e = k.shape
    W = -(-seq // block)
    nb = n * W + 1
    perm = torch.randperm(nb - 1, generator=g) + 1
    table = torch.zeros(n, W, dtype=torch.int32)
    pk = torch.full((nb, block, e), float("nan"), dtype=k.dtype)
    pv = torch.full((nb, block, e), float("nan"), dtype=v.dtype)
    for s, length in enumerate(lengths):
        for j in range(-(-int(length) // block)):
            phys = int(perm[s * W + j])
            table[s, j] = phys
            rows = min(block, int(length) - j * block)
            pk[phys, :rows] = k[s, j * block:j * block + rows]
            pv[phys, :rows] = v[s, j * block:j * block + rows]
    return pk, pv, table


def ln_inputs(dev, dtype, rows, seed, width=EMBED):
    """K1's inputs (x, scale, bias): rows of `width` in `dtype`."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(dev, dtype)
    s = torch.randn(width, generator=g).to(dev, dtype)
    b = torch.randn(width, generator=g).to(dev, dtype)
    return x, s, b


def ln_bwd_inputs(dev, dtype, rows, width, seed):
    """K4's inputs (x, scale, dy): rows of `width` in `dtype`."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(rows, width, generator=g) * 3 + 1).to(dev, dtype)
    s = torch.randn(width, generator=g).to(dev, dtype)
    dy = torch.randn(rows, width, generator=g).to(dev, dtype)
    return x, s, dy


def same_bits(fn) -> bool:
    """Whether two calls of `fn()` give bitwise equal tensors (a tensor or
    a tuple of them): a kernel whose sums run in a fixed order must."""
    import torch

    def bits(t):  # the same bytes as integers: NaN-safe, -0 != +0
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


# ------------------------------------------------------------ phase 2


def kernel_parity(dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    abs error per kernel over every case."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    c = counters()
    errs: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for rows, width in LN_FWD_SHAPES:
            x, s, b = ln_inputs(dev, dtype, rows, SEED + rows, width)
            n0 = c["layer_norm_fwd"].launches
            got = ln.layer_norm(x, s, b, 1e-5)
            torch.cuda.synchronize()
            require(c["layer_norm_fwd"].launches == n0 + 1, "K1 not launched")
            err = check_close("layer_norm_fwd", got,
                              ln.layer_norm_plain(x, s, b, 1e-5), dn, errs)
            log(f"  K1 layer_norm_fwd ({rows}, {width}) {dn}: "
                f"max abs err {err:.3e}")
            del x, s, b, got

        q, k, v, lengths = decode_inputs(dev, dtype, SEED + 1)
        n0 = c["flash_decode_attention"].launches
        got = fa.flash_decode_attention(q, k, v, lengths, num_heads=HEADS)
        torch.cuda.synchronize()
        require(c["flash_decode_attention"].launches == n0 + 1,
                "K2 not launched")
        err = check_close(
            "flash_decode_attention", got,
            fa.decode_attention_plain(q, k, v, lengths, num_heads=HEADS),
            dn, errs)
        require(same_bits(lambda: fa.flash_decode_attention(
            q, k, v, lengths, num_heads=HEADS)),
            f"K2 [{dn}]: two launches differ in their bits")
        log(f"  K2 flash_decode_attention {tuple(k.shape)} {dn}: "
            f"max abs err {err:.3e}, the same bits on two launches")

        q, pk, pv, table, lengths = paged_inputs(dev, dtype, SEED + 2)
        n0 = c["paged_flash_decode_attention"].launches
        got = fa.paged_flash_decode_attention(q, pk, pv, table, lengths,
                                              num_heads=HEADS)
        torch.cuda.synchronize()
        require(c["paged_flash_decode_attention"].launches == n0 + 1,
                "K3 not launched")
        err = check_close(
            "paged_flash_decode_attention", got,
            fa.paged_decode_attention_plain(q, pk, pv, table, lengths,
                                            num_heads=HEADS),
            dn, errs)
        require(same_bits(lambda: fa.paged_flash_decode_attention(
            q, pk, pv, table, lengths, num_heads=HEADS)),
            f"K3 [{dn}]: two launches differ in their bits")
        log(f"  K3 paged_flash_decode_attention {tuple(pk.shape)} {dn}: "
            f"max abs err {err:.3e}, the same bits on two launches")
    halfway_parity(dev, errs)
    return errs


# K5-K7 parity cases: (batch, s_q, s_k, heads, head_dim, causal). The main
# path's shape both ways, ragged sequences (partial tiles, masked q rows, a
# causal offset s_k - s_q > 0, s 1000 over eight 128-row tiles), and the
# other head widths the kernels instantiate: in bfloat16 head_dim 64 and
# 128 take the sm90 K5-K7, 32 and 80 the mma.sync ones.
FLASH_CASES = [
    (8, 512, 512, HEADS, HEAD_DIM, True),
    (8, 512, 512, HEADS, HEAD_DIM, False),
    (2, 300, 300, 4, HEAD_DIM, True),
    (2, 130, 130, 4, HEAD_DIM, False),
    (2, 130, 300, 4, HEAD_DIM, True),
    (2, 1000, 1000, 4, 128, True),
    (2, 256, 256, 4, 32, True),
    (2, 200, 200, 3, 80, True),
    (2, 256, 256, 2, 128, True),
]
# K5-K7 on the transposed (b, h, s, d) layout: (batch, heads, s_q, s_k,
# head_dim, causal): lm-base's shape both ways, ragged (non-causal s 1000,
# head_dim 128 at s 130), a causal offset, head_dim 128 past one tile, and
# head_dim 80 (mma.sync in bfloat16)
FLASH_T_CASES = [
    (8, HEADS, 512, 512, HEAD_DIM, True),
    (8, HEADS, 512, 512, HEAD_DIM, False),
    (2, 4, 300, 300, HEAD_DIM, True),
    (2, 4, 130, 300, HEAD_DIM, True),
    (2, 4, 1000, 1000, HEAD_DIM, False),
    (2, 3, 130, 130, 128, True),
    (2, 8, 1024, 1024, 128, True),
    (2, 2, 200, 200, 80, False),
]
# K8: (layout, batch, heads, s_q, s_k, head_dim, causal): lm-base's
# transposed shape, the packed head-dim-128 single tile (row 11 of
# PERF.md's kernel table), ragged and offset shapes on both layouts (in
# bfloat16 the sm90 cluster kernel), and head_dim 80 and 32 (mma.sync)
FUSED_CASES = [
    ("transposed", 8, HEADS, 512, 512, HEAD_DIM, True),
    ("packed", 2, 8, 512, 512, 128, True),
    ("transposed", 2, 4, 300, 300, HEAD_DIM, True),
    ("packed", 2, 4, 300, 300, HEAD_DIM, True),
    ("transposed", 2, 4, 130, 300, HEAD_DIM, True),
    ("packed", 2, 4, 130, 300, HEAD_DIM, True),
    ("transposed", 2, 3, 200, 200, 80, True),
    ("packed", 2, 4, 256, 256, 32, True),
]
# Operands whose base lies one element past a 16-byte boundary, which TMA
# refuses: in bfloat16 they take the mma.sync K5-K8 at head_dims the sm90
# kernels instantiate, (layout, batch, heads, s_q, s_k, head_dim, causal)
UNALIGNED_CASES = [
    ("packed", 2, 4, 300, 300, HEAD_DIM, True),
    ("transposed", 2, 2, 256, 256, 128, True),
]
# K5-K7 at lm-xxl-fsdp's shape, in bfloat16 only (the path's type; float32
# takes other kernels, held at this shape by phase 11): the same cases on
# both layouts, (batch, heads, s_q, s_k, head_dim, causal)
def xxl_flash_case():
    c = lm_config(XXL)
    s = c.sequence_length
    return (XXL_BATCH, c.num_heads, s, s, c.hidden_size // c.num_heads, True)


# K4 parity shapes: lm-base's (tokens, hidden), a ragged one, and
# lm-xxl-fsdp's (4 x 2048 tokens, hidden 4096: four warps a row)
XXL_HIDDEN = 4096
LN_BWD_SHAPES = [(8 * 512, EMBED), (4095, 1000),
                 (XXL_BATCH * 2048, XXL_HIDDEN)]
# K1's parity rows: the pure-decode and prefill-chunk calls at lm-base's
# width, and the training rows of lm-base and lm-xxl-fsdp
LN_FWD_SHAPES = ((SLOTS, EMBED), (SLOTS * CHUNK, EMBED),
                 (TRAIN_BATCH * TRAIN_SEQ, EMBED),
                 (XXL_BATCH * 2048, XXL_HIDDEN))


def flash_inputs(dev, dtype, b, s_q, s_k, heads, head_dim, seed,
                 layout="packed", unaligned=False):
    """q, k, v, dO: (b, s, heads*head_dim) packed or (b, heads, s,
    head_dim) transposed; `unaligned`: each starting one element into its
    allocation (contiguous, the base not 16-byte aligned)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)

    def shape(s):
        return ((b, s, heads * head_dim) if layout == "packed"
                else (b, heads, s, head_dim))

    q = torch.randn(*shape(s_q), generator=g)
    k = torch.randn(*shape(s_k), generator=g)
    v = torch.randn(*shape(s_k), generator=g)
    do = torch.randn(*shape(s_q), generator=g)

    def place(t):
        if not unaligned:
            return t.to(dev, dtype)
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    return tuple(place(t) for t in (q, k, v, do))


def flash_row(name, layout, heads, head_dim):
    """The kernels line's row of a flash case: the per-head TPU kernels
    (transposed, or one head a packed block) or the grouped ones."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    if layout == "packed" and fa.packed_heads_per_block(head_dim, heads) > 1:
        return name
    return f"{name} (per-head)"


def launched(name, layout, fn, variant=None):
    """fn(), synchronised; fatal unless it launched kernel `name` once, on
    tensors of `layout` (and of kernel `variant`, when given)."""
    import torch

    from flexflow_tpu_torch.kernels import counters

    c = counters()[name]
    n0, l0 = c.launches, c.layouts.get(layout, 0)
    v0 = c.variants.get(variant, 0)
    out = fn()
    torch.cuda.synchronize()
    require(c.launches == n0 + 1 and c.layouts.get(layout, 0) == l0 + 1,
            f"{name} not launched on the {layout} layout")
    require(variant is None or c.variants.get(variant, 0) == v0 + 1,
            f"{name}: not the {variant} kernel ({c.variants})")
    return out


def want_variant(dtype, head_dim, aligned=True) -> str:
    """The K5-K8 kernel a case takes: the wgmma/TMA kernels for bf16 at
    head_dim 64 and 128 on 16-byte aligned operands (every case here keeps
    s_k within K8's cluster), else mma.sync (bf16) or SIMT (f32)."""
    import torch

    if dtype == torch.float32:
        return "simt"
    return "sm90" if head_dim in (64, 128) and aligned else "mma"


def check_flash_case(dev, dtype, layout, case, seed, errs, fused=False,
                     at=None, unaligned=False):
    """K5, K6 and K7 (or K8, `fused`) on one case against their plain
    versions, each launch on the variant the case takes; K6-K8 get the
    lse and delta the plain forward made, so each kernel is held on its
    own. The sm90 K8 runs twice and must give the same bits (its dq is
    summed across a cluster in a fixed order). `at` names the case of the
    kernels line whose shape this is: its errors are also kept as
    errs[f"{row} @ {at}"]."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, h, s_q, s_k, d, causal = case
    dn = str(dtype).split(".")[1]
    q, k, v, do = flash_inputs(dev, dtype, b, s_q, s_k, h, d, seed, layout,
                               unaligned)
    heads = h if layout == "packed" else None
    kw = dict(num_heads=heads, causal=causal)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, p_lse, fa.flash_delta(do, p_out, heads))
    var = want_variant(dtype, d, not unaligned)
    tag = (f"b{b} s{s_q}x{s_k} {h}x{d} {layout} "
           f"{'causal' if causal else 'full'} {dn}"
           f"{' unaligned' if unaligned else ''} ({var})")
    if fused:
        name = "flash_attention_bwd_fused"
        got = launched(name, layout,
                       lambda: fa.flash_attention_bwd_fused(*args, **kw),
                       var)
        want = fa.flash_attention_bwd_fused_plain(*args, **kw)
        e8 = max(check_close(name, a, w, dn, errs)
                 for a, w in zip(got, want))
        same = ""
        if var == "sm90":
            again = launched(
                name, layout,
                lambda: fa.flash_attention_bwd_fused(*args, **kw), var)
            require(all(torch.equal(a, a2) for a, a2 in zip(got, again)),
                    f"K8 {tag}: two launches differ")
            same = ", a second launch bitwise identical"
        log(f"  K8 {tag}: max abs err dq/dk/dv {e8:.3e}{same}")
        return
    def row(name):
        return flash_row(name, layout, h, d)

    out, lse = launched("flash_attention_fwd", layout,
                        lambda: fa.flash_attention_fwd(q, k, v, **kw), var)
    e5 = max(check_close(row("flash_attention_fwd"), out, p_out, dn, errs),
             check_close(row("flash_attention_fwd"), lse, p_lse, dn, errs))
    dq = launched("flash_attention_bwd_dq", layout,
                  lambda: fa.flash_attention_bwd_dq(*args, **kw), var)
    e6 = check_close(row("flash_attention_bwd_dq"), dq,
                     fa.flash_attention_bwd_dq_plain(*args, **kw), dn, errs)
    dk, dv = launched("flash_attention_bwd_dkv", layout,
                      lambda: fa.flash_attention_bwd_dkv(*args, **kw), var)
    p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(*args, **kw)
    e7 = max(check_close(row("flash_attention_bwd_dkv"), dk, p_dk, dn, errs),
             check_close(row("flash_attention_bwd_dkv"), dv, p_dv, dn, errs))
    log(f"  K5/K6/K7 {tag}: max abs err {e5:.3e} / {e6:.3e} / {e7:.3e}")
    if at:
        for name, e in (("flash_attention_fwd", e5),
                        ("flash_attention_bwd_dq", e6),
                        ("flash_attention_bwd_dkv", e7)):
            errs[f"{row(name)} @ {at}"] = e


def train_kernel_parity(dev, errs) -> dict:
    """K4-K8 against their plain versions on the card, in float32 and
    bfloat16, the flash kernels on both layouts, then the (out, lse) entry.
    Adds each kernel's max abs error to errs."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import layer_norm as ln

    c = counters()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n, d in LN_BWD_SHAPES:
            x, s, dy = ln_bwd_inputs(dev, dtype, n, d, SEED + n)
            n0 = c["layer_norm_bwd"].launches
            got = ln.layer_norm_bwd(x, s, dy, 1e-5)
            torch.cuda.synchronize()
            require(c["layer_norm_bwd"].launches == n0 + 1,
                    "layer_norm_bwd not launched")
            want = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
            row = "layer_norm_bwd (lm-xxl)" if d == XXL_HIDDEN else (
                "layer_norm_bwd")
            errs_here = [check_close(row, a, b, dn, errs)
                         for a, b in zip(got, want)]
            require(same_bits(lambda: ln.layer_norm_bwd(x, s, dy, 1e-5)),
                    f"K4 ({n}, {d}) [{dn}]: two launches differ in their "
                    f"bits")
            log(f"  K4 layer_norm_bwd ({n}, {d}) {dn}: max abs err "
                f"dx/dscale/dbias {max(errs_here):.3e}, the same bits on "
                f"two launches")
            del x, s, dy, got, want
        for i, (b, s_q, s_k, h, hd, causal) in enumerate(FLASH_CASES):
            check_flash_case(dev, dtype, "packed",
                             (b, h, s_q, s_k, hd, causal), SEED + 100 + i,
                             errs)
        for i, case in enumerate(FLASH_T_CASES):
            check_flash_case(dev, dtype, "transposed", case, SEED + 200 + i,
                             errs)
        for i, (layout, *case) in enumerate(FUSED_CASES):
            check_flash_case(dev, dtype, layout, case, SEED + 300 + i, errs,
                             fused=True)
        for i, (layout, *case) in enumerate(UNALIGNED_CASES):
            for fused in (False, True):
                check_flash_case(dev, dtype, layout, case, SEED + 500 + i,
                                 errs, fused=fused, unaligned=True)
        if dtype == torch.bfloat16:
            for i, layout in enumerate(("packed", "transposed")):
                check_flash_case(dev, dtype, layout, xxl_flash_case(),
                                 SEED + 400 + i, errs, at=f"lm-xxl {layout}")
                torch.cuda.empty_cache()
        lse_entry_parity(dev, dtype, errs)
        torch.cuda.empty_cache()
    return errs


def lse_entry_parity(dev, dtype, errs):
    """`flash_attention_with_lse` (b, 8 heads, s, 64) causal, on the card
    (K5, then K8 at s 512 or K6 and K7 at s 1024) against the same entry
    with the plain versions in the kernels' place: out, lse and the
    gradients under cotangents on both outputs."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa

    c = counters()
    dn = str(dtype).split(".")[1]
    names = ("flash_attention_fwd", "flash_attention_bwd_fused",
             "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for s in (512, 1024):
        q, k, v, do = flash_inputs(dev, dtype, 2, s, s, 8, HEAD_DIM,
                                   SEED + s, "transposed")
        g_lse = torch.randn(2, 8, s, generator=torch.Generator().manual_seed(
            s)).to(dev)

        def run(count):
            n0 = {n: getattr(c[n], count) for n in names}
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out, lse = fa.flash_attention_with_lse(*leaves, causal=True)
            torch.autograd.backward([out, lse], [do, g_lse])
            torch.cuda.synchronize()
            fused = int(s <= fa.SINGLE_TILE)
            ran = {n: getattr(c[n], count) - n0[n] for n in names}
            require(ran == dict(zip(names, (1, fused, 1 - fused, 1 - fused))),
                    f"lse entry at s {s}: {count} {ran}")
            return [out.detach(), lse.detach(), *(t.grad for t in leaves)]

        got = run("launches")
        with mock.patch.object(fa, "flash_attention_fwd",
                               fa.flash_attention_fwd_plain), \
                mock.patch.object(fa, "flash_attention_bwd_fused",
                                  fa.flash_attention_bwd_fused_plain), \
                mock.patch.object(fa, "flash_attention_bwd_dq",
                                  fa.flash_attention_bwd_dq_plain), \
                mock.patch.object(fa, "flash_attention_bwd_dkv",
                                  fa.flash_attention_bwd_dkv_plain):
            want = run("plain_calls")
        err = max(check_close("flash_attention_with_lse", a, w, dn, errs)
                  for a, w in zip(got, want))
        log(f"  (out, lse) entry b2 s{s} 8x{HEAD_DIM} causal {dn}, lse "
            f"cotangent: max abs err out/lse/dq/dk/dv {err:.3e}")


def halfway_parity(dev, errs):
    """K2 and K3 in bfloat16 over a float32 cache whose values lie halfway
    between bfloat16 values: the kernels must round K and V on load as the
    plain versions do. First shows that the case can see it: the plain
    arithmetic without that rounding lands beyond the tolerance."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa

    c = counters()
    q, k, v, lengths = halfway_inputs(LENGTHS, MAX_SEQ + 1, HEADS, HEAD_DIM,
                                      SEED + 3)
    pk, pv, table = pooled(k, v, lengths, BLOCK, SEED + 4)
    q = q.to(dev, torch.bfloat16)
    cases = (
        ("flash_decode_attention", "K2", fa.flash_decode_attention,
         fa.decode_attention_plain, (k, v, lengths)),
        ("paged_flash_decode_attention", "K3",
         fa.paged_flash_decode_attention, fa.paged_decode_attention_plain,
         (pk, pv, table, lengths)),
    )
    for name, tag, kernel, plain, args in cases:
        args = tuple(a.to(dev) for a in args)
        want = plain(q, *args, num_heads=HEADS)
        unrounded = plain(q.float(), *args, num_heads=HEADS)
        require(not torch.allclose(unrounded.float(), want.float(),
                                   **TOL["bfloat16"]),
                f"{name}: the halfway case cannot tell rounding on load")
        n0 = c[name].launches
        got = kernel(q, *args, num_heads=HEADS)
        torch.cuda.synchronize()
        require(c[name].launches == n0 + 1, f"{tag} not launched")
        err = check_close(name, got, want, "bfloat16", errs)
        log(f"  {tag} {name} halfway-rounding case bfloat16: max abs err "
            f"{err:.3e} (unrounded arithmetic is off by "
            f"{float((unrounded.float() - want.float()).abs().max()):.3e})")


# ------------------------------------------------------------ phases 3-5


def build_lm(flags: tuple = (), tier: str = "lm-base",
             device: str = "cuda", layers: int | None = None, lm=None):
    """lm-base for serving (phases 3-5; phase 20(f) with `flags`; phase
    23 and the serving leg also another tier, device, depth or config
    `lm`)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    cfg = FFConfig(device=device)
    cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED),
                    "--serve-slots", str(SLOTS),
                    "--serve-max-seq", str(MAX_SEQ),
                    "--serve-prefill-chunk", str(CHUNK),
                    "--serve-kv-block-size", str(BLOCK), *flags])
    ff = FFModel(cfg)
    lm = lm or TRANSFORMER_LM_ZOO[tier]
    if layers is not None:
        lm = dataclasses.replace(lm, num_layers=layers)
    build_transformer_lm(ff, lm)
    ff.compile()
    return ff


def make_prompts(vocab: int) -> list[list[int]]:
    rs = np.random.RandomState(SEED)
    lens = rs.randint(32, 385, size=16)
    prompts = [rs.randint(0, vocab, size=int(n)).tolist() for n in lens]
    prefix = rs.randint(0, vocab, size=64).tolist()
    # the first four are resident together: each later one's first chunk
    # comes after the first's prefill registered the prefix (radix hits);
    # decode writes into a registered tail block copy it (COW)
    for i in range(4):
        prompts[i][:64] = prefix
    return prompts


# the device kernels that each counter's wrapper launches once a count, by
# function name, every variant (K4's second kernel, ln_bwd_colsum, follows
# each ln_bwd launch and is not counted)
DEVICE_KERNELS = {
    "layer_norm_fwd": ("ln_fwd_rows", "ln_fwd_wide"),
    "layer_norm_bwd": ("ln_bwd_rows", "ln_bwd_wide"),
    "flash_decode_attention": ("decode_split_kernel",),
    "paged_flash_decode_attention": ("paged_decode_split_kernel",),
    **{f"flash_attention_{k}": tuple(f"flash_{k}_{v}"
                                      for v in ("sm90", "mma", "f32"))
       for k in ("fwd", "bwd_dq", "bwd_dkv", "bwd_fused")},
}
# a name not preceded by a letter or "_": decode_split_kernel is not
# paged_decode_split_kernel (a digit may precede it in a mangled name)
_KERNEL_NAME = {c: re.compile("|".join(rf"(?<![A-Za-z_]){n}" for n in ns))
                for c, ns in DEVICE_KERNELS.items()}


def counter_of(kernel: str):
    """The counter whose wrapper launched the device kernel the profiler
    names `kernel`, or None."""
    hits = [c for c, pat in _KERNEL_NAME.items() if pat.search(kernel)]
    require(len(hits) <= 1, f"{kernel!r} matches {hits}")
    return hits[0] if hits else None


def require_seen(prof: dict, counted: dict, what: str):
    """The launches the profiler saw on the device, by counter, equal to
    the counters' count of the same kind of call (fatal): inside a graph's
    replay the counters add what the capture recorded, so this is what
    shows that the replayed graph launched each kernel."""
    want = {c: counted.get(c, 0) for c in DEVICE_KERNELS}
    require(prof["kernel_launches"] == want,
            f"{what}: the profiler saw {prof['kernel_launches']} kernel "
            f"launches, the counters count {want}")


def profiled(fn, patterns=None):
    """`fn()` under torch.profiler: its wall time, the device time of its
    kernels (summed; one stream runs them in order; inside a CUDA graph's
    replay too, where the profiler reports them), their share of the
    wall time, the kernels that take the most, and the host-side ops that
    take the most host time of their own; beside it `stream_ms`, the
    stream's time between CUDA events recorded around `fn` (what the
    stream ran, gaps where it waited on the host included). `patterns`
    ({label: regex}) adds, per label, the launches and device time of the
    kernels whose names match (`matched`). Returns (those numbers, what
    fn returned)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the device side of the trace starts recording a moment after
        # the profiler enters: an eager lm-xxl-fsdp step launched at once
        # lost the records of its first four port kernels (3 K1, 1 K5).
        # A synchronised kernel and a short wait first, outside the
        # timed window, so fn's first kernels are recorded
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.005)
        t0 = time.perf_counter()
        start.record()
        done = fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        # device-side events only: an aten op also reports the time of
        # the kernels it launched, which would count them twice
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key))
        else:
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    seen = dict.fromkeys(DEVICE_KERNELS, 0)
    for _, n, k in rows:
        c = counter_of(k)
        if c is not None:
            seen[c] += n
    copies: dict[str, list] = {}  # by kernel family (names cut short)
    for us, n, k in rows:
        if "copy" in k:
            c = copies.setdefault(k[:90], [0, 0.0])
            c[0] += n
            c[1] += us / 1e3
    matched = {}
    for label, pat in (patterns or {}).items():
        hits = [(us, n, k) for us, n, k in rows if re.search(pat, k)]
        matched[label] = {"count": sum(n for _, n, _ in hits),
                          "ms": sum(us for us, _, _ in hits) / 1e3,
                          "top": [{"kernel": k[:90], "count": n,
                                   "ms": us / 1e3} for us, n, k in hits[:6]]}
    return {
        **({"matched": matched} if patterns else {}),
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "stream_ms": start.elapsed_time(end),
        "device_kernels": sum(r[1] for r in rows),
        # the port's kernels among them, by the counter of their wrapper
        "kernel_launches": seen,
        # the elementwise copies (dtype casts among them), and the host's
        # casts and copies that launch them
        "copy_kernels": {"count": sum(n for _, n, k in rows if "copy" in k),
                         "ms": sum(us for us, _, k in rows
                                   if "copy" in k) / 1e3,
                         "by_kernel": copies},
        "host_casts": {op: sum(n for _, n, k in host if k == op)
                       for op in ("aten::_to_copy", "aten::copy_")},
        "top": [{"kernel": k[:80], "count": n, "ms": us / 1e3}
                for us, n, k in rows[:8]],
        "top_host": [{"op": k[:80], "count": n, "ms": us / 1e3}
                     for us, n, k in host[:12]],
    }, done


def profile_step(eng, step):
    """One pure-decode step, `step()`, profiled (`profiled`), with the
    number of slots decoding in it."""
    active = sum(1 for s in eng.scheduler.slots if s.decoding)
    numbers, done = profiled(step)
    return dict(numbers, active_slots=active), done


def graph_ready(run, slots: int) -> bool:
    """Whether the captured decode step `run` holds a graph for the
    pure-decode width (tokens of (slots, 1))."""
    return any(g is not None and any(len(e) == 3 and e[1] == (slots, 1)
                                     for e in sig)
               for sig, g in run._graphs.items())


def serve_phase(ff, layout, prompts, vocab, mode="captured",
                telemetry: bool = False, profile: bool = True) -> dict:
    """Drive one serving run through `engine.generate(prompts)`, its
    decode step captured (one CUDA graph per q width) or, `mode` "eager",
    under `executor.eager()`: the launch counts are set to 0 just before
    and read just after. Each engine iteration that generate runs is
    timed through a wrapper on the engine's `step`; the first pure-decode
    one that replays a graph (eager: the first) is profiled instead, and
    its time and tokens are left out of the rate and the medians; so are
    the steps that warmed up or captured a width. A profiler's record one
    launch short of the counters' count over the same step (a record
    lost, as `train_phase` explains) is profiled once more on the next
    pure-decode step, which must agree. With `telemetry` (phase
    20(f)) no step is profiled by this script (phase 3 holds the same
    model's kernels to the profiler's record): the engine's
    `metrics_summary` after the run. `profile` False (phase 20(f)'s runs
    without telemetry, timed beside the runs with it) profiles no step
    either. Returns the run's numbers."""
    import contextlib

    import torch

    from flexflow_tpu_torch.executor import eager
    from flexflow_tpu_torch.kernels import counters, reset_counters

    eng = ff.serve(kv_layout=layout, max_new_tokens=NEW_TOKENS)
    run = eng._step_fn.captured
    sched = eng.scheduler
    c = counters()
    step = eng.step
    decode_ms, per_step, profiled = [], {}, {}
    decode_done = []  # requests each timed pure-decode step completed
    attempts = []  # each profiled step: what the profiler saw, counted
    steps = 0

    def graphs():
        return len(run._graphs), run.captures

    def timed_step():
        nonlocal steps
        steps += 1
        calls0, tokens0 = eng._prefill_calls, eng._decode_tokens
        before = {k: v.launches for k, v in c.items()}
        pure_decode = (not sched.pending
                       and not any(s.prefilling for s in sched.slots))
        g0 = graphs()
        t0 = time.perf_counter()
        if (profile and not telemetry and pure_decode
                and not profiled.get("final")
                and (mode == "eager" or graph_ready(run, SLOTS))):
            profiled["numbers"], done = profile_step(eng, step)
            profiled["s"] = (profiled.get("s", 0.0)
                             + time.perf_counter() - t0)
            profiled["tokens"] = (profiled.get("tokens", 0)
                                  + eng._decode_tokens - tokens0)
            seen = profiled["numbers"]["kernel_launches"]
            counted = {k: c[k].launches - before[k] for k in seen}
            attempts.append({"seen": seen, "counted": counted})
            lost = sum(counted[k] - seen[k] for k in seen)
            profiled["final"] = (len(attempts) > 1 or lost != 1 or any(
                seen[k] > counted[k] for k in seen))
            return done
        done = step()  # ends in the sampled tokens' copy to the host
        dt = (time.perf_counter() - t0) * 1e3
        if eng._prefill_calls == calls0 and graphs() == g0:
            decode_ms.append(dt)
            decode_done.append(len(done))
            per_step.update({k: v.launches - before[k]
                             for k, v in c.items()})
        return done

    eng.step = timed_step
    reset_counters()
    t_run = time.perf_counter()
    with eager() if mode == "eager" else contextlib.nullcontext():
        streams = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {k: v.launches for k, v in c.items()}
    plain = {k: v.plain_calls for k, v in c.items()}

    if profile and not telemetry:
        require(profiled.get("final", False),
                f"{layout}: no pure-decode step was profiled")
        require_seen(profiled["numbers"], per_step,
                     f"{layout} {mode} pure-decode step")
    # a width captures once: a graph that no longer holds its tensors
    # (a state not written back, say) would capture again every step
    require(run.captures <= len(run._graphs),
            f"{layout}: {run.captures} captures of {len(run._graphs)} "
            f"decode widths")
    for i, toks in enumerate(streams):
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(toks)} tokens")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {i}: token out of range")
    need = ["layer_norm_fwd", "paged_flash_decode_attention"
            if layout == "paged" else "flash_decode_attention"]
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{layout}: {name} never launched")
    if any(plain.values()):
        raise AssertionError(f"{layout}: plain versions ran: {plain}")
    st = eng.stats()
    out = {
        "layout": layout,
        "mode": mode,
        # widths called, and widths called twice or more (captured)
        "decode_widths": len(run._graphs),
        "decode_graphs": run.captures,
        "requests": len(streams),
        "steps": steps,
        "prefill_calls": st["prefill_calls"],
        "pure_decode_steps": len(decode_ms),
        "decode_tokens": st["decode_tokens"],
        "wall_s": wall,
        # every sampled token over the run's wall time, both without the
        # profiled step
        "decode_tokens_per_s": ((st["decode_tokens"]
                                 - profiled.get("tokens", 0))
                                / (wall - profiled.get("s", 0.0))),
        "median_decode_step_ms": statistics.median(decode_ms),
        "decode_step_ms": decode_ms,
        "decode_step_completions": decode_done,
        "launches": launches,
        "launches_per_decode_step": per_step,
        "profiled_decode_step": profiled.get("numbers"),
        "profiled_attempts": attempts,
        "streams": streams,
    }
    if layout == "paged":
        out.update({k: st[k] for k in ("prefix_hit_rate", "cow_copies",
                                       "kv_pool_blocks",
                                       "kv_blocks_in_use_peak")})
        if not (st["prefix_shared_tokens"] > 0 and st["cow_copies"] > 0):
            raise AssertionError(f"paged: no prefix hit or no COW copy: "
                                 f"{st}")
    if telemetry:
        out["metrics_summary"] = eng.metrics_summary()
    del eng
    torch.cuda.empty_cache()
    return out


def f32_engine(ff, layout):
    """A serving engine of ff's weights in float32 (no bf16 compute)."""
    cfg = ff.config
    saved = (cfg.computation_dtype, cfg.allow_tensor_op_math_conversion)
    cfg.computation_dtype, cfg.allow_tensor_op_math_conversion = None, False
    try:
        return ff.serve(kv_layout=layout, max_new_tokens=NEW_TOKENS)
    finally:
        cfg.computation_dtype, cfg.allow_tensor_op_math_conversion = saved


def top2_at(ff, layout, tokens, f32: bool = True) -> list:
    """The two largest float32 logits (value, token) after `tokens`, from
    one request of `tokens` as its prompt, in `layout` (`f32` False: the
    bf16 run's logits)."""
    import torch

    from flexflow_tpu_torch.executor import eager

    eng = (f32_engine(ff, layout) if f32
           else ff.serve(kv_layout=layout, max_new_tokens=NEW_TOKENS))
    ex = eng.decode_model.executor
    seen = {}
    apply, step_fn = ex._apply, eng._step_fn

    def keep_logits(*a, **kw):
        logits, state = apply(*a, **kw)
        seen["logits"] = logits
        return logits, state

    def keep_row(params, state, xs, read_idx, *rest):
        seen["row"] = read_idx
        return step_fn(params, state, xs, read_idx, *rest)

    ex._apply, eng._step_fn = keep_logits, keep_row
    with eager():  # a replay runs no Python: keep each call's logits
        eng.generate([tokens], max_new_tokens=1)
    slot = 0  # the only request takes the first slot
    row = seen["logits"][slot, int(seen["row"][slot])].float()
    top = torch.topk(row, 2)
    del eng
    torch.cuda.empty_cache()
    return [(float(v), int(i)) for v, i in zip(top.values, top.indices)]


def f32_stream_check(ff, prompts) -> dict:
    """The same requests served in float32 in both KV layouts, each with
    the captured decode step and under `executor.eager()`: the captured
    and eager greedy streams must be identical (fatal). Then how many
    streams agree across the layouts and, where one does not, the first
    differing request and step, the two tokens, and the top-2 float32
    logits after the common prefix in each layout (a re-prefill of
    prompt + prefix)."""
    import torch

    from flexflow_tpu_torch.executor import eager

    streams, rate = {}, {}
    for layout in ("paged", "contiguous"):
        for mode in ("captured", "eager"):
            eng = f32_engine(ff, layout)
            if mode == "eager":
                with eager():
                    streams[layout, mode] = eng.generate(prompts)
            else:
                t0 = time.perf_counter()
                streams[layout, mode] = eng.generate(prompts)
                rate[layout] = (eng.stats()["decode_tokens"]
                                / (time.perf_counter() - t0))
            del eng
            torch.cuda.empty_cache()
        require(streams[layout, "captured"] == streams[layout, "eager"],
                f"float32 {layout}: captured and eager greedy streams "
                f"differ")
    a, b = streams["paged", "captured"], streams["contiguous", "captured"]
    out = {"identical": sum(x == y for x, y in zip(a, b)),
           "requests": len(prompts), "captured_equals_eager": True,
           # phase 23 holds the speculative float32 streams to these
           "paged_streams": a, "decode_tokens_per_s": rate}
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            t = next(j for j, (u, w) in enumerate(zip(x, y)) if u != w)
            ctx = list(prompts[i]) + x[:t]
            out["first_difference"] = {
                "request": i, "step": t, "paged_token": x[t],
                "contiguous_token": y[t],
                "top2_paged": top2_at(ff, "paged", ctx),
                "top2_contiguous": top2_at(ff, "contiguous", ctx)}
            break
    return out


def logits_phase(ff, layout, prompts) -> float:
    """The same weights in float32: the logits of one pure-decode step
    with the kernels vs the same step with the plain versions called in
    their place. Returns the max abs difference over the live slots."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    eng = f32_engine(ff, layout)
    for p in prompts:  # no request may finish before the last prefill
        eng.submit(p[:48], max_new_tokens=MAX_SEQ - 48)
    while (eng.scheduler.pending
           or any(s.prefilling for s in eng.scheduler.slots)):
        eng.step()
    tokens, positions, _, pre, _, _, decoding = eng.next_feed()
    require(pre is None and len(decoding) == SLOTS,
            f"{layout}: not a pure-decode step over {SLOTS} slots")
    dec = eng.decode_model
    xs = eng._stage_inputs(tokens, positions)

    def clone(state):
        return {n: {k: v.clone() for k, v in ws.items()}
                for n, ws in state.items()}

    c = counters()
    k0 = {k: v.launches for k, v in c.items()}
    with_kernels, _ = dec.executor._apply(dec._params, clone(dec._state), xs)
    torch.cuda.synchronize()
    ran = {k: v.launches - k0[k] for k, v in c.items()}
    attn = ("paged_flash_decode_attention" if layout == "paged"
            else "flash_decode_attention")
    from flexflow_tpu_torch.models import TRANSFORMER_LM_ZOO

    layers = TRANSFORMER_LM_ZOO["lm-base"].num_layers
    require(ran["layer_norm_fwd"] == 2 * layers + 1 and ran[attn] == layers,
            f"{layout}: kernel launches in the step {ran}, want "
            f"{2 * layers + 1} LayerNorm and {layers} {attn}")
    p0 = {k: v.plain_calls for k, v in c.items()}
    with mock.patch.object(fa, "flash_decode_attention",
                           fa.decode_attention_plain), \
            mock.patch.object(fa, "paged_flash_decode_attention",
                              fa.paged_decode_attention_plain), \
            mock.patch.object(ln, "layer_norm", ln.layer_norm_plain):
        with_plain, _ = dec.executor._apply(dec._params, clone(dec._state),
                                            xs)
    torch.cuda.synchronize()
    plain = {k: v.plain_calls - p0[k] for k, v in c.items()}
    require(plain["layer_norm_fwd"] == 2 * layers + 1
            and plain[attn] == layers,
            f"{layout}: the plain versions did not replace the kernels: "
            f"{plain}")
    live = [s.index for s in decoding]
    a, b = with_kernels[live].float(), with_plain[live].float()
    require(a.shape == (SLOTS, 1, ff.layers[-1].params.out_channels),
            f"logits shape {tuple(a.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{layout}: non-finite logits")
    err = float((a - b).abs().max())
    if err > LOGITS_ATOL:
        raise AssertionError(f"{layout}: float32 logits differ by {err:.3e}"
                             f" (bound {LOGITS_ATOL})")
    del eng
    torch.cuda.empty_cache()
    return err


# ------------------------------------------------------------ phases 6-7


def lm_config(name: str = "lm-base", layers: int | None = None):
    """A tier of the port's zoo, its depth cut to `layers` if given."""
    from flexflow_tpu_torch.models import TRANSFORMER_LM_ZOO

    c = TRANSFORMER_LM_ZOO[name]
    return c if layers is None else dataclasses.replace(c, num_layers=layers)


class LMBuild(NamedTuple):
    """How an LM is built and what one training step of it launches a
    layer: `builder` names its builder in `flexflow_tpu_torch.models`;
    `k5_per_layer` flash forwards (the pipelined blocks recompute theirs
    in the backward), `ln_per_layer` K1 and K4 calls (the pipelined
    blocks normalise in plain float32), past the final LayerNorm's one;
    `graph_flops` counts its MFU by the graph's own FLOPs (the ops'
    `flops`, as `fit`'s MFU anchor does) in place of bench.py's formula."""
    builder: str
    k5_per_layer: int
    ln_per_layer: int
    graph_flops: bool

    def into(self, ff, lm):
        """Build `lm` into the model `ff`."""
        from flexflow_tpu_torch import models

        getattr(models, self.builder)(ff, lm)


STANDARD = LMBuild("build_transformer_lm", 1, 2, False)
PIPELINED = LMBuild("build_transformer_lm_pipelined", 2, 0, True)


def build_train_lm(dtype: str, tensor_op_math: bool = True, lm=None,
                   transposed: bool = False, batch: int = TRAIN_BATCH,
                   flags: tuple = (), build: LMBuild = STANDARD):
    """An LM (lm-base unless `lm` is given; built as `build` says)
    compiled for training as bench.py compiles lm-base: SGD(lr=0.01),
    sparse CE from logits, plus the accuracy and CE metrics; `transposed`
    passes --flash-transposed, `flags` any other FFConfig flags (phase
    14: --telemetry-dir)."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )

    cfg = FFConfig()
    cfg.parse_args(["--dtype", "fp32" if dtype == "f32" else dtype,
                    "--seed", str(SEED), "-b", str(batch)]
                   + (["--flash-transposed"] if transposed else [])
                   + list(flags))
    cfg.allow_tensor_op_math_conversion = tensor_op_math
    ff = FFModel(cfg)
    build.into(ff, lm or lm_config())
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY,
                        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def train_batch(vocab: int, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ):
    """One batch of random tokens and labels from the seed."""
    rs = np.random.RandomState(SEED)
    toks = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    labels = rs.randint(0, vocab, (batch, seq, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_fused")


def step_launches(layers: int, fused: bool,
                  build: LMBuild = STANDARD) -> dict:
    """Kernel launches of one training step of an LM with `layers`
    layers: `build`'s K5 per layer, K8 (`fused`) or K6 and K7 per layer,
    and K1 and K4 as many times a layer as `build` says and once for the
    final LayerNorm."""
    ln = build.ln_per_layer * layers + 1
    return {"flash_attention_fwd": build.k5_per_layer * layers,
            "flash_attention_bwd_dq": 0 if fused else layers,
            "flash_attention_bwd_dkv": 0 if fused else layers,
            "flash_attention_bwd_fused": layers if fused else 0,
            "layer_norm_fwd": ln,
            "layer_norm_bwd": ln}


def train_phase(lm=None, *, transposed=False, fused=False,
                batch=TRAIN_BATCH, warmup=WARMUP_STEPS,
                timed_steps=TIMED_STEPS, mode="captured",
                keep_masters=False, flags: tuple = (),
                build: LMBuild = STANDARD) -> dict:
    """An LM (lm-base unless `lm` is given), bf16, through `fit` over one
    repeated batch: `warmup` then `timed_steps` steps, the train step
    captured (the first call warms up, the second captures, the rest
    replay: `warmup` >= 2 leaves only replays to time) or, `mode`
    "eager", under `executor.eager()`. The launch counts are set to 0
    just before fit and read just after; each step is timed (host clock,
    synchronised on both sides) through a wrapper on the executor's
    train step, which fit calls, and must launch `step_launches(layers,
    fused)`, the flash kernels on the layout the flags ask for. Then one
    more step, profiled, whose kernels the profiler must see as the
    counters count them (one more where its record is one launch
    short). `keep_masters` returns a copy of the masters
    after fit's steps (`masters`); `flags` go to FFConfig (phase 15: the
    mesh); `build` how the LM is built (phase 18: PIPELINED, whose MFU
    counts the graph's own FLOPs: the PipelineBlocks op's `_pb_flops`,
    full s^2 attention, the head, x3)."""
    import contextlib

    import torch

    from flexflow_tpu_torch.executor import CapturedStep, eager
    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.models import transformer_lm_flops_per_token

    cfg = lm or lm_config()
    seq = cfg.sequence_length
    layout = "transposed" if transposed else "packed"
    require(warmup >= 2, "the timed steps must be replays: warm up twice")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the caller still holds (another run's masters) is not this run's
    held = torch.cuda.memory_allocated()
    ff = build_train_lm("bf16", lm=cfg, transposed=transposed, batch=batch,
                        flags=flags, build=build)
    x, y = train_batch(cfg.vocab_size, batch, seq)
    steps = warmup + timed_steps
    xs = {k: np.concatenate([v] * steps) for k, v in x.items()}
    ys = np.concatenate([y] * steps)
    c = counters()
    step_fn = ff.executor.build_train_step()
    losses, step_ms, per_step, per_layout, per_variant = [], [], [], [], []

    def timed_step(*args):
        before = {k: v.launches for k, v in c.items()}
        before_l = {k: dict(c[k].layouts) for k in FLASH_KERNELS}
        before_v = {k: dict(c[k].variants) for k in FLASH_KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[-1])
        per_step.append({k: v.launches - before[k] for k, v in c.items()})
        per_layout.append({k: {lay: n - before_l[k].get(lay, 0)
                               for lay, n in c[k].layouts.items()
                               if n - before_l[k].get(lay, 0)}
                           for k in FLASH_KERNELS})
        per_variant.append({k: {var: n - before_v[k].get(var, 0)
                                for var, n in c[k].variants.items()
                                if n - before_v[k].get(var, 0)}
                            for k in FLASH_KERNELS})
        return out

    ff.executor._train_step = timed_step
    mode_ctx = eager() if mode == "eager" else contextlib.nullcontext()
    reset_counters()
    t_fit = time.perf_counter()
    with mode_ctx:
        ff.fit(xs, ys, epochs=1, batch_size=batch, shuffle=False,
               verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    require(isinstance(step_fn, CapturedStep)
            and step_fn.captures == (0 if mode == "eager" else 1),
            f"{mode}: {getattr(step_fn, 'captures', None)} captures")
    launches = {k: v.launches for k, v in c.items()}
    by_layout = {k: dict(c[k].layouts) for k in FLASH_KERNELS}
    by_variant = {k: dict(c[k].variants) for k in FLASH_KERNELS}
    plain = {k: v.plain_calls for k, v in c.items()}

    layers = cfg.num_layers
    losses = [float(v) for v in losses]
    require(len(losses) == steps, f"fit ran {len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = step_launches(layers, fused, build)
    want_layout = {k: ({layout: n} if n else {}) for k, n in want.items()
                   if k in FLASH_KERNELS}
    # every flash kernel on the wgmma/TMA variant
    var = want_variant(torch.bfloat16, cfg.hidden_size // cfg.num_heads)
    want_var = {k: ({var: n} if n else {}) for k, n in want.items()
                if k in FLASH_KERNELS}
    for i, (n, lay, vs) in enumerate(zip(per_step, per_layout,
                                         per_variant)):
        got = {k: n[k] for k in want}
        require(got == want, f"step {i}: launches {got}, want {want}")
        require(lay == want_layout, f"step {i}: flash launches by layout "
                f"{lay}, want {want_layout}")
        require(vs == want_var, f"step {i}: flash launches by variant "
                f"{vs}, want {want_var}")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    timed = step_ms[warmup:]
    tokens = batch * seq
    tok_s = timed_steps * tokens / (sum(timed) / 1e3)
    flops_tok = (ff._goodput_anchor["flops_per_step"] / tokens
                 if build.graph_flops
                 else transformer_lm_flops_per_token(cfg))
    staged = ff._make_batch(x, y)
    masters = ({n: {k: t.detach().clone() for k, t in ws.items()}
                for n, ws in ff._params.items()} if keep_masters else None)
    metrics = ff.get_perf_metrics()
    # the profiler's record has come up one launch short of the counters
    # on an H100: 23 of 24 K5 in a replay of the pipelined LM's step, and
    # 8 of 9 K1 in an eager lm-xxl step, whose wrapper counts a launch
    # only once it has returned success: a record lost, not a launch. So
    # each profiled step is held to the counters' count over that same
    # step; a record one launch short is profiled once more (both kept in
    # `profiled_attempts`) and the second must agree; a record over the
    # count, or short by more, fails
    attempts = []
    for attempt in range(2):
        before = {k: c[k].launches for k in DEVICE_KERNELS}
        with eager() if mode == "eager" else contextlib.nullcontext():
            prof, _ = profiled(lambda: step_fn(
                ff._params, ff._state, ff._opt_slots, ff._step,
                ff._counters, staged, ff._rng))
        torch.cuda.synchronize()
        counted = {k: c[k].launches - before[k] for k in DEVICE_KERNELS}
        seen = prof["kernel_launches"]
        attempts.append({"seen": seen, "counted": counted})
        require({k: counted[k] for k in want} == want,
                f"{mode} {layout}: the profiled step launched {counted}, "
                f"want {want}")
        lost = sum(counted[k] - seen[k] for k in DEVICE_KERNELS)
        if attempt or lost != 1 or any(seen[k] > counted[k]
                                        for k in DEVICE_KERNELS):
            break  # agreed, or no lost record explains it: checked below
        log(f"  {mode} {layout}: profiled step {attempt}: the profiler saw "
            f"{seen}, the counters count {counted}")
    require_seen(prof, counted, f"{mode} {layout} train step")
    out = {
        "mode": mode,
        "model": (f"{cfg.hidden_size} hidden, {cfg.num_heads} heads of "
                  f"{cfg.hidden_size // cfg.num_heads}, {layers} layers, seq "
                  f"{seq}, vocab {cfg.vocab_size}"),
        "layout": layout,
        "builder": build.builder,
        "batch": batch,
        "steps": steps,
        "timed_steps": timed_steps,
        "losses": losses,
        "step_ms": step_ms,
        "median_step_ms": statistics.median(timed),
        "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "mfu": flops_tok * tok_s / PEAK_OPS_PER_S["bfloat16"],
        "fit_wall_s": fit_s,
        # kernel time of the profiled step over the (unprofiled) median
        # step: the profiler itself slows the host
        "device_busy_share": prof["device_busy_ms"] / statistics.median(
            timed),
        "stream_busy_share": prof["stream_ms"] / statistics.median(timed),
        # the run's own peak: model, state, activations, graph pool
        "max_memory_allocated": torch.cuda.max_memory_allocated() - held,
        "launches": launches,
        "launches_by_layout": by_layout,
        "launches_by_variant": by_variant,
        "launches_by_variant_per_step": per_variant[-1],
        "launches_per_step": per_step[-1],
        "profiled_step": prof,
        "profiled_attempts": attempts,
        "train_accuracy": metrics.get_accuracy(),
        "train_mean_loss": metrics.get_mean_loss(),
        "mesh_axes": dict(ff.mesh.shape),
        "update_sharding": dict(ff._update_sharding),
        # the compile gate's verdict and its predicted per-chip memory
        # (phase 21(b) holds it to this run's peak)
        "analysis": analysis_record(ff._analysis),
    }
    if keep_masters:
        out["masters"] = masters
    del ff, staged, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_masters(captured: dict, eager: dict) -> dict:
    """The masters after the same steps from the same weights, captured vs
    eager: equal bits, as every kernel of the step sums in a fixed order;
    failing that (a library call choosing another algorithm inside a
    graph), within GRAD_RTOL of each layer's largest entry. Fatal."""
    import torch

    bitwise, worst = True, (0.0, None, 0.0)
    for n, ws in eager.items():
        scale = max(float(t.abs().max()) for t in ws.values())
        for k, want in ws.items():
            got = captured[n][k]
            if torch.equal(got, want):
                continue
            bitwise = False
            err = float((got - want).abs().max())
            rel = err / max(scale, 1e-30)
            if rel > worst[0]:
                worst = (rel, f"{n}.{k}", err)
    rel, name, err = worst
    require(bitwise or rel <= GRAD_RTOL,
            f"captured and eager masters differ at {name} by {err:.3e} "
            f"({rel:.3e} of its layer's largest entry, bound {GRAD_RTOL})")
    return {"bitwise_equal": bitwise, "worst_tensor": name,
            "max_abs_diff": err, "relative_to_largest": rel,
            "tensors": sum(len(ws) for ws in eager.values())}


def captured_vs_eager(captured: dict, eager: dict) -> dict:
    """Launch counts of the two runs (equal: fatal; each run's per-step
    counts were held to the kernels the profiler saw on the device,
    `require_seen`) and the masters after them (`compare_masters`)."""
    require(captured["launches"] == eager["launches"]
            and captured["launches_by_variant"]
            == eager["launches_by_variant"],
            f"launches captured {captured['launches']} vs eager "
            f"{eager['launches']}")
    return compare_masters(captured.pop("masters"), eager.pop("masters"))


def log_modes(name: str, cap: dict, eag: dict, median_key: str):
    """The captured and eager medians and busy shares of one cell."""
    def busy(r):
        p = r.get("profiled_step") or r.get("profiled_decode_step")
        share = p["device_busy_ms"] / r[median_key]
        return (f"busy {100 * share:.1f}% ({p['device_busy_ms']:.2f} ms of "
                f"kernels, {p['device_kernels']} launches seen by the "
                f"profiler; stream {p['stream_ms']:.2f} ms)")

    log(f"  {name}: captured median {cap[median_key]:.3f} ms, {busy(cap)}; "
        f"eager median {eag[median_key]:.3f} ms, {busy(eag)}")


def grad_phase(lm=None, *, transposed=False, fused=False,
               batch=TRAIN_BATCH, dtype="fp32",
               build: LMBuild = STANDARD) -> dict:
    """The same weights in float32 (no tensor-op rounding; or `dtype`
    "bf16", the training path's bf16 activations): one train step's
    gradients of an LM (lm-base unless `lm` is given) with the kernels vs
    the same step with the plain versions called in their place. Returns
    the worst tensor's name and its max abs and relative differences."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    cfg = lm or lm_config()
    bound_rel = GRAD_RTOL if dtype == "fp32" else GRAD_RTOL_BF16
    ff = build_train_lm(dtype, tensor_op_math=dtype != "fp32", lm=cfg,
                        transposed=transposed, batch=batch, build=build)
    xs, labels = ff._make_batch(*train_batch(cfg.vocab_size, batch,
                                             cfg.sequence_length))
    ex = ff.executor
    c = counters()
    want = step_launches(cfg.num_layers, fused, build)
    names = tuple(want)

    def grads(count):
        n0 = {k: getattr(c[k], count) for k in names}
        _, _, g = ex.value_and_grad(
            ex.make_loss_fn(ff._state, xs, labels), ff._params)
        torch.cuda.synchronize()
        ran = {k: getattr(c[k], count) - n0[k] for k in names}
        require(ran == want, f"{count} in the step: {ran}, want {want}")
        return g

    with_kernels = grads("launches")
    with mock.patch.object(fa, "flash_attention_fwd",
                           fa.flash_attention_fwd_plain), \
            mock.patch.object(fa, "flash_attention_bwd_dq",
                              fa.flash_attention_bwd_dq_plain), \
            mock.patch.object(fa, "flash_attention_bwd_dkv",
                              fa.flash_attention_bwd_dkv_plain), \
            mock.patch.object(fa, "flash_attention_bwd_fused",
                              fa.flash_attention_bwd_fused_plain), \
            mock.patch.object(ln, "layer_norm", ln.layer_norm_plain), \
            mock.patch.object(ln, "layer_norm_bwd", ln.layer_norm_bwd_plain):
        with_plain = grads("plain_calls")
    worst = (-1.0, None, 0.0)
    for n, ws in with_plain.items():
        scale = max(float(g.abs().max()) for g in ws.values())
        for w, gp in ws.items():
            gk = with_kernels[n][w]
            require(bool(torch.isfinite(gk).all()), f"{n}.{w}: non-finite")
            err = float((gk - gp).abs().max())
            rel = err / max(scale, 1e-30)
            if rel > worst[0]:
                worst = (rel, f"{n}.{w}", err)
    rel, name, err = worst
    require(rel <= bound_rel, f"{dtype} gradient of {name} differs by "
            f"{err:.3e} ({rel:.3e} of its layer's largest gradient entry, "
            f"bound {bound_rel})")
    tensors = sum(len(ws) for ws in with_plain.values())
    del ff, with_kernels, with_plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "batch": batch, "dtype": dtype,
            "builder": build.builder,
            "layout": "transposed" if transposed else "packed",
            "worst_tensor": name, "max_abs_diff": err,
            "relative_to_largest": rel, "bound_relative": bound_rel,
            "tensors": tensors}


# ------------------------------------------------------------ phase 8


def time_ms(fn, arg_sets, iters=48, reps=5,
            graph=True) -> tuple[float, float]:
    """(device ms, eager ms) of one call, cycling over input sets whose
    total size exceeds the 50 MB L2 where the real caller finds its
    inputs cold. Device time: `iters` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events, so the host's launch cost
    is out. Eager time: the same calls launched one by one from Python,
    which is what the eager serving step pays per call."""
    import torch

    for args in arg_sets:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    if not graph:
        return eager, eager
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del g
    return device, eager


def timed(kernel, plain, library, arg_sets, library_sets, bound_ms,
          bound_by, **reps) -> dict:
    """Device times of the kernel, its plain version and (when given) the
    library call, with the bound."""
    ms, eager_ms = time_ms(kernel, arg_sets, **reps)
    return dict(ms=ms, eager_ms=eager_ms,
                plain_ms=time_ms(plain, arg_sets, **reps)[0],
                library_ms=(time_ms(library, library_sets, **reps)[0]
                            if library is not None else None),
                bound_ms=bound_ms, bound_by=bound_by)


def sdpa_backward_device_ms(lib_sets, calls=8) -> float:
    """The library yardstick of the backward kernels: the device time of
    one SDPA backward (dq, dk, dv together), the summed device time of the
    kernels that `calls` autograd backward calls launch (profiler) over
    their count. `lib_sets` hold (out, leaves, dO) of SDPA forwards."""
    import torch

    def backward(o, leaves, g):
        return torch.autograd.grad(o, leaves, g, retain_graph=True)

    for args in lib_sets:  # warm-up
        backward(*args)
    numbers, _ = profiled(lambda: [backward(*lib_sets[i % len(lib_sets)])
                                   for i in range(calls)])
    return numbers["device_busy_ms"] / calls


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K1's timed shapes, bf16: (case, rows, width, input sets). The training
# rows (lm-base's 8 x 512 tokens, lm-xxl-fsdp's 4 x 2048 at width 4096)
# cycle over sets past the 50 MB L2, as the caller finds them cold; the
# pure-decode call's (slots, 1024) rows are hot in L2 from the op before.
LN_FWD_CASES = (("train", TRAIN_BATCH * TRAIN_SEQ, EMBED, 8),
                ("lm-xxl packed", XXL_BATCH * 2048, XXL_HIDDEN, 2),
                ("contiguous", SLOTS, EMBED, 1))


def ln_fwd_numbers(dev) -> dict:
    """K1's times by case (`LN_FWD_CASES`), beside `F.layer_norm`'s and
    its bound: x read once, y written once, scale and bias read once, ~8
    f32 operations an element."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import layer_norm as ln

    out = {}
    for case, rows, width, n_sets in LN_FWD_CASES:
        sets = [ln_inputs(dev, torch.bfloat16, rows, SEED + 40 + i, width)
                for i in range(n_sets)]
        out[case] = dict(timed(
            lambda *a: ln.layer_norm(*a, 1e-5),
            lambda *a: ln.layer_norm_plain(*a, 1e-5),
            lambda x, s, b, width=width: F.layer_norm(x, (width,), s, b,
                                                      1e-5),
            sets, sets,
            *bound(2 * rows * width * 2 + 2 * width * 2, 8 * rows * width,
                   "bfloat16")), shape=f"({rows}, {width}) bf16")
        del sets
        torch.cuda.empty_cache()
    return out


def kernel_numbers(dev) -> dict:
    """Times at the main path's shapes and types: bf16 activations, f32
    KV state. Returns {kernel name: numbers}."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    bf16 = torch.bfloat16
    out = {}

    out["layer_norm_fwd"] = ln_fwd_numbers(dev)
    live = sum(LENGTHS)
    ops = 4.0 * live * EMBED  # q.k and p.v per live key and feature
    small = len(LENGTHS) * EMBED * (2 + 2) + len(LENGTHS) * 4  # q, out, len

    def sdpa_inputs(q, kc, vc, lengths):
        # the library yardstick: SDPA over the gathered cache in the
        # compute dtype with the length mask (gather and cast excluded)
        sk = kc.shape[1]
        heads = lambda t: t.reshape(t.shape[0], -1, HEADS,
                                    HEAD_DIM).transpose(1, 2).contiguous()
        mask = (torch.arange(sk, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        return (heads(q), heads(kc.to(bf16)), heads(vc.to(bf16)), mask)

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    sets = [decode_inputs(dev, bf16, SEED + 10 + i) for i in range(4)]
    out["flash_decode_attention"] = timed(
        lambda *a: fa.flash_decode_attention(*a, num_heads=HEADS),
        lambda *a: fa.decode_attention_plain(*a, num_heads=HEADS),
        sdpa, sets, [sdpa_inputs(*a) for a in sets],
        *bound(live * EMBED * 4 * 2 + small, ops, "bfloat16"))
    del sets

    sets = [paged_inputs(dev, bf16, SEED + 20 + i) for i in range(4)]
    table_bytes = sets[0][3].numel() * 4

    def gathered(q, pk, pv, table, lengths):
        idx = table.long()
        n = q.shape[0]
        return (q, pk[idx].reshape(n, -1, EMBED),
                pv[idx].reshape(n, -1, EMBED), lengths)

    out["paged_flash_decode_attention"] = timed(
        lambda *a: fa.paged_flash_decode_attention(*a, num_heads=HEADS),
        lambda *a: fa.paged_decode_attention_plain(*a, num_heads=HEADS),
        sdpa, sets, [sdpa_inputs(*gathered(*a)) for a in sets],
        *bound(live * EMBED * 4 * 2 + small + table_bytes, ops, "bfloat16"))
    del sets
    torch.cuda.empty_cache()
    return out


def train_kernel_numbers(dev) -> dict:
    """K4-K7 at the training path's shapes and types (bf16; (8, 512,
    16x64) causal; LayerNorm rows (4096, 1024), and lm-xxl-fsdp's (8192,
    4096) over two sets), each cycling over four input sets (more than
    the 50 MB L2); K5-K7 also on their mma.sync
    variant (`mma_ms`). Library yardsticks, timed only:
    `native_layer_norm_backward` for K4; `scaled_dot_product_attention`
    (causal) on the (b, h, s, d) view for K5, and the device time of its
    backward's kernels (`sdpa_backward_device_ms`) for K6 and K7
    together."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    bf16 = torch.bfloat16
    out = {}
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM
    n, e = b * s, h * d
    eps = 1e-5

    # K4 at lm-base's rows (4 input sets) and lm-xxl-fsdp's (8192, 4096)
    # (2 sets, 128 MB each)
    for row, rows, width, n_sets in (
            ("layer_norm_bwd", n, e, 4),
            ("layer_norm_bwd (lm-xxl)", XXL_BATCH * 2048, XXL_HIDDEN, 2)):
        sets = []
        for i in range(n_sets):
            x, w, dy = ln_bwd_inputs(dev, bf16, rows, width, SEED + 30 + i)
            bias = torch.zeros_like(w)
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [width], w, bias, eps)
            sets.append((x, w, dy, bias, mean, rstd))
        out[row] = timed(
            lambda x, w, dy, *_: ln.layer_norm_bwd(x, w, dy, eps),
            lambda x, w, dy, *_: ln.layer_norm_bwd_plain(x, w, dy, eps),
            lambda x, w, dy, bias, mean, rstd, width=width:
                torch.ops.aten.native_layer_norm_backward(
                    dy, x, [width], mean, rstd, w, bias, [True, True, True]),
            sets, sets,
            # x, dy, scale read; dx written, dscale and dbias (f32)
            # written; ~16 f32 operations an element
            *bound(3 * rows * width * 2 + width * 2 + 2 * width * 4,
                   16 * rows * width, "float32"))
        del sets
        torch.cuda.empty_cache()

    pairs = b * h * s * (s + 1) // 2  # live (query, key) pairs, causal
    rows = b * h * s * 4  # one f32 row statistic (lse or delta)
    act = b * s * e * 2  # one (b, s, e) bf16 tensor
    kw = dict(num_heads=h, causal=True)
    sets = []
    for i in range(4):
        q, k, v, do = flash_inputs(dev, bf16, b, s, s, h, d, SEED + 50 + i)
        o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
        sets.append((q, k, v, do, lse, fa.flash_delta(do, o, h)))

    def view(t):
        return t.view(b, s, h, d).transpose(1, 2)

    def sdpa(q, k, v, *_):
        return F.scaled_dot_product_attention(view(q), view(k), view(v),
                                              is_causal=True)

    out["flash_attention_fwd"] = timed(
        lambda q, k, v, *_: fa.flash_attention_fwd(q, k, v, **kw),
        lambda q, k, v, *_: fa.flash_attention_fwd_plain(q, k, v, **kw),
        sdpa, sets, sets,
        *bound(4 * act + rows, 4 * d * pairs, "bfloat16"))
    out["flash_attention_bwd_dq"] = timed(
        lambda *a: fa.flash_attention_bwd_dq(*a, **kw),
        lambda *a: fa.flash_attention_bwd_dq_plain(*a, **kw),
        None, sets, None, *bound(5 * act + 2 * rows, 6 * d * pairs,
                                 "bfloat16"))
    out["flash_attention_bwd_dkv"] = timed(
        lambda *a: fa.flash_attention_bwd_dkv(*a, **kw),
        lambda *a: fa.flash_attention_bwd_dkv_plain(*a, **kw),
        None, sets, None, *bound(6 * act + 2 * rows, 8 * d * pairs,
                                 "bfloat16"))
    sc = d ** -0.5
    out["flash_attention_fwd"]["mma_ms"] = time_ms(
        lambda q, k, v, *_: fa._launch_fwd(q, k, v, h, True, sc, "mma"),
        sets)[0]
    out["flash_attention_bwd_dq"]["mma_ms"] = time_ms(
        lambda *a: fa._launch_dq(*a, h, True, sc, "mma"), sets)[0]
    out["flash_attention_bwd_dkv"]["mma_ms"] = time_ms(
        lambda *a: fa._launch_dkv(*a, h, True, sc, "mma"), sets)[0]
    lib_sets = []
    for q, k, v, do, *_ in sets:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_sets.append((sdpa(*leaves), leaves, view(do)))
    lib_bwd = sdpa_backward_device_ms(lib_sets)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        out[name]["library_ms"] = lib_bwd
        out[name]["library_is"] = ("sdpa backward (dq, dk, dv together), "
                                   "device time of its kernels")
    del sets, lib_sets
    torch.cuda.empty_cache()
    return out


def per_head_kernel_numbers(dev) -> dict:
    """The flash kernels at the per-head paths' shapes, bf16, causal: K8
    and K5 at lm-base's transposed (8, 16, 512, 64), K8 at the packed
    head-dim-128 single tile (2, 512, 8 x 128), and K5, K6 and K7 at
    lm-xxl-fsdp's (4, 2048, 32 x 128) on both layouts; each also on its
    mma.sync variant (`mma_ms`). Library yardsticks, timed only:
    causal SDPA on (b, h, s, d) for K5, and the device time of its
    backward's kernels (dq, dk, dv together; `sdpa_backward_device_ms`)
    for K8 and for K6 + K7. Returns {row: {case: numbers}}."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa

    bf16 = torch.bfloat16
    out: dict = {}

    def case(b, h, s, d, layout, n_sets, kinds, **reps):
        heads = h if layout == "packed" else None
        kw = dict(num_heads=heads, causal=True)
        sets = []
        for i in range(n_sets):
            q, k, v, do = flash_inputs(dev, bf16, b, s, s, h, d,
                                       SEED + 60 + i, layout)
            o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            sets.append((q, k, v, do, lse, fa.flash_delta(do, o, heads)))
            del o

        def view(t):  # the (b, h, s, d) view SDPA takes
            return t.view(b, s, h, d).transpose(1, 2) if heads else t

        lib_sets = []
        for q, k, v, do, *_ in sets:
            leaves = [view(t).detach().requires_grad_(True)
                      for t in (q, k, v)]
            lib_sets.append((F.scaled_dot_product_attention(
                *leaves, is_causal=True), leaves, view(do)))
        lib_bwd = sdpa_backward_device_ms(lib_sets)
        lib_fwd = time_ms(
            lambda o, leaves, g: F.scaled_dot_product_attention(
                *leaves, is_causal=True), lib_sets, **reps)[0]
        pairs = b * h * s * (s + 1) // 2  # live (query, key) pairs
        rows = b * h * s * 4  # one f32 row statistic
        act = b * s * h * d * 2  # one bf16 activation
        fns = {
            # kernel: (wrapper, plain, bytes, operations)
            "fwd": (lambda q, k, v, *_: fa.flash_attention_fwd(q, k, v, **kw),
                    lambda q, k, v, *_: fa.flash_attention_fwd_plain(
                        q, k, v, **kw), 4 * act + rows, 4 * d * pairs),
            "dq": (lambda *a: fa.flash_attention_bwd_dq(*a, **kw),
                   lambda *a: fa.flash_attention_bwd_dq_plain(*a, **kw),
                   5 * act + 2 * rows, 6 * d * pairs),
            "dkv": (lambda *a: fa.flash_attention_bwd_dkv(*a, **kw),
                    lambda *a: fa.flash_attention_bwd_dkv_plain(*a, **kw),
                    6 * act + 2 * rows, 8 * d * pairs),
            "fused": (lambda *a: fa.flash_attention_bwd_fused(*a, **kw),
                      lambda *a: fa.flash_attention_bwd_fused_plain(*a, **kw),
                      7 * act + 2 * rows, 10 * d * pairs),
        }
        sc = d ** -0.5
        mma = {  # the mma.sync variants at the same shape
            "fwd": lambda q, k, v, *_: fa._launch_fwd(q, k, v, h, True, sc,
                                                      "mma"),
            "dq": lambda *a: fa._launch_dq(*a, h, True, sc, "mma"),
            "dkv": lambda *a: fa._launch_dkv(*a, h, True, sc, "mma"),
            "fused": lambda *a: fa._launch_fused(*a, h, True, sc, "mma"),
        }
        res = {}
        for name in kinds:
            kern, plain, nbytes, ops = fns[name]
            res[name] = timed(kern, plain, None, sets, None,
                              *bound(nbytes, ops, "bfloat16"), **reps)
            if name in mma:
                res[name]["mma_ms"] = time_ms(mma[name], sets, **reps)[0]
            res[name]["library_ms"] = lib_fwd if name == "fwd" else lib_bwd
            res[name]["library_is"] = (
                "causal sdpa" if name == "fwd"
                else "causal sdpa backward (dq, dk, dv together), device "
                     "time of its kernels")
            res[name]["shape"] = (f"({b}, {s}, {h}x{d}) {layout} causal "
                                  f"bf16")
        del sets, lib_sets
        torch.cuda.empty_cache()
        return res

    base_t = case(TRAIN_BATCH, HEADS, TRAIN_SEQ, HEAD_DIM, "transposed", 4,
                  ("fwd", "fused"))
    row11 = case(2, 8, 512, 128, "packed", 4, ("fused",))
    xxl = lm_config(XXL)
    xh, xd = xxl.num_heads, xxl.hidden_size // xxl.num_heads
    big = dict(iters=8, reps=3)  # one input set is past the L2 here
    xxl_p = case(XXL_BATCH, xh, xxl.sequence_length, xd, "packed", 2,
                 ("fwd", "dq", "dkv"), **big)
    xxl_t = case(XXL_BATCH, xh, xxl.sequence_length, xd, "transposed", 2,
                 ("fwd", "dq", "dkv"), **big)
    out["flash_attention_bwd_fused"] = {
        "lm-base transposed": base_t["fused"],
        "packed head_dim 128, one tile": row11["fused"]}
    for name, kind in (("flash_attention_fwd (per-head)", "fwd"),
                       ("flash_attention_bwd_dq (per-head)", "dq"),
                       ("flash_attention_bwd_dkv (per-head)", "dkv")):
        out[name] = {"lm-xxl packed": xxl_p[kind],
                     "lm-xxl transposed": xxl_t[kind]}
    out["flash_attention_fwd (per-head)"]["lm-base transposed"] = (
        base_t["fwd"])
    return out


LN_SRC = "flexflow_tpu_torch/csrc/layer_norm.cu"
DECODE_SRC = "flexflow_tpu_torch/csrc/decode_attention.cu"
FLASH_SRC = "flexflow_tpu_torch/csrc/flash_attention.cu"
SM90_SRC = "flexflow_tpu_torch/csrc/flash_attention_sm90.cu"
TPU_FA = "flexflow_tpu/kernels/flash_attention.py"
VARIANT_SOURCES = {"sm90": SM90_SRC, "mma": FLASH_SRC, "simt": FLASH_SRC}
# (row, kernel counter, route, source, TPU kernel it replaces, the run
# whose launches the row reports). The flash kernels have a row per TPU
# kernel they replace: the grouped narrow-head ones (lm-base packed) and
# the per-head ones (lm-xxl-fsdp; transposed lm-base for K8). K5-K8 run
# their sm90 variant on every path (phase 2 holds the mma.sync one at
# head_dim 32 and 80 and on unaligned operands; phase 8 times it beside,
# as `mma_ms`).
KERNELS = [
    ("layer_norm_fwd", "layer_norm_fwd", "cuda", LN_SRC,
     "flexflow_tpu/kernels/layer_norm.py:48", "train"),
    ("flash_decode_attention", "flash_decode_attention", "cuda", DECODE_SRC,
     f"{TPU_FA}:1261", "contiguous"),
    ("paged_flash_decode_attention", "paged_flash_decode_attention", "cuda",
     DECODE_SRC, f"{TPU_FA}:1446", "paged"),
    ("layer_norm_bwd", "layer_norm_bwd", "cuda", LN_SRC,
     "flexflow_tpu/kernels/layer_norm.py:59", "train"),
    ("layer_norm_bwd (lm-xxl)", "layer_norm_bwd", "cuda", LN_SRC,
     "flexflow_tpu/kernels/layer_norm.py:59", "lm-xxl packed"),
    ("flash_attention_fwd", "flash_attention_fwd", "cuda", SM90_SRC,
     f"{TPU_FA}:705", "train"),
    ("flash_attention_bwd_dq", "flash_attention_bwd_dq", "cuda", SM90_SRC,
     f"{TPU_FA}:808", "train"),
    ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv", "cuda", SM90_SRC,
     f"{TPU_FA}:854", "train"),
    ("flash_attention_bwd_fused", "flash_attention_bwd_fused", "cuda",
     SM90_SRC, f"{TPU_FA}:442", "lm-base transposed"),
    ("flash_attention_fwd (per-head)", "flash_attention_fwd", "cuda",
     SM90_SRC, f"{TPU_FA}:117", "lm-xxl packed"),
    ("flash_attention_bwd_dq (per-head)", "flash_attention_bwd_dq", "cuda",
     SM90_SRC, f"{TPU_FA}:351", "lm-xxl packed"),
    ("flash_attention_bwd_dkv (per-head)", "flash_attention_bwd_dkv", "cuda",
     SM90_SRC, f"{TPU_FA}:392", "lm-xxl packed"),
]


# ------------------------------------------------------------ phases 13-14

# phase 13: ResNet-50 at the zoo's defaults (224 x 224, 10 classes) and
# FFConfig's default batch
RESNET_BATCH = 64
# the layout transposes cuDNN adds around a convolution, and the kernels
# that compute one: cuDNN's (implicit-GEMM, Winograd, forward, data- and
# weight-gradient kernels) and the cuBLAS/CUTLASS GEMMs it lowers some to,
# by the names NVIDIA gives them, the transposes left out
LAYOUT_KERNELS = r"(?i)(nchwtonhwc|nhwctonchw)"
CONV_KERNELS = (r"(?i)^(?!.*(nchwtonhwc|nhwctonchw))"
                r".*(conv|xmma|fprop|dgrad|wgrad|implicit|winograd|cutlass"
                r"|gemm|nvjet)")
# phase 14: the telemetry's exact per-step times and its MFU gauge against
# phase 6's, and the bucket estimate of its summary p50 against one
# bucket of its histogram (telemetry/metrics.py: four a decade)
TELEMETRY_RTOL = 0.15
BUCKET_RATIO = 10.0 ** 0.25


def resnet_phase(mode: str = "captured", warmup: int = WARMUP_STEPS,
                 timed_steps: int = TIMED_STEPS,
                 keep_masters: bool = False) -> dict:
    """ResNet-50 (FFModel -> build_resnet50 at batch 64, 224 x 224, 10
    classes), bf16 over f32 masters, compile(SGD(lr=0.01), sparse CE,
    accuracy) -> fit over one repeated batch of random images and labels
    from the seed: `warmup` then `timed_steps` steps, captured or, `mode`
    "eager", under `executor.eager()`. Each step is timed as phase 6's
    (host clock, synchronised on both sides). Fatal: a finite loss that
    falls, no launch of the port's kernels (K1-K8), and convolution
    kernels of cuDNN or cuBLAS in one profiled step. MFU counts the
    convolutions' and the dense layer's FLOPs (the ops' counts) x 3."""
    import contextlib

    import torch

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.executor import CapturedStep, eager
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.models import build_resnet50

    require(warmup >= 2, "the timed steps must be replays: warm up twice")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = FFConfig()
    cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                    str(RESNET_BATCH)])
    ff = FFModel(cfg)
    inp, _ = build_resnet50(ff, batch_size=RESNET_BATCH)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    classes = ff.layers[-1].outputs[0].dims[-1]
    rs = np.random.RandomState(SEED)
    x = rs.randn(*inp.dims).astype(np.float32)
    y = rs.randint(0, classes, (RESNET_BATCH, 1)).astype(np.int32)
    steps = warmup + timed_steps
    c = counters()
    step_fn = ff.executor.build_train_step()
    losses, step_ms = [], []

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[-1])
        return out

    ff.executor._train_step = timed_step

    def mode_ctx():
        return eager() if mode == "eager" else contextlib.nullcontext()

    reset_counters()
    with mode_ctx():
        ff.fit(np.concatenate([x] * steps), np.concatenate([y] * steps),
               epochs=1, batch_size=RESNET_BATCH, shuffle=False,
               verbose=False)
    torch.cuda.synchronize()
    require(isinstance(step_fn, CapturedStep)
            and step_fn.captures == (0 if mode == "eager" else 1),
            f"resnet {mode}: {getattr(step_fn, 'captures', None)} captures")
    launches = {k: v.launches for k, v in c.items()}
    plain = {k: v.plain_calls for k, v in c.items()}
    require(not any(launches.values()) and not any(plain.values()),
            f"resnet {mode}: the port's kernels ran: {launches}, plain "
            f"{plain}")
    losses = [float(v) for v in losses]
    require(len(losses) == steps, f"fit ran {len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    staged = ff._make_batch({inp.name: x}, y)
    with mode_ctx():
        prof, _ = profiled(lambda: step_fn(
            ff._params, ff._state, ff._opt_slots, ff._step, ff._counters,
            staged, ff._rng), patterns={"conv": CONV_KERNELS,
                                        "layout": LAYOUT_KERNELS})
    torch.cuda.synchronize()
    require_seen(prof, {}, f"resnet {mode} train step")
    require(prof["matched"]["conv"]["count"] > 0,
            f"resnet {mode}: no cuDNN/cuBLAS convolution kernel in a "
            f"profiled step: {prof['top']}")
    fwd = {OT.OP_CONV2D: 0.0, OT.OP_LINEAR: 0.0}
    for node in ff.graph.topo_order():
        if node.op_type in fwd:
            fwd[node.op_type] += node.op_def.flops(
                node.params, node.input_shapes, node.output_shapes)
    flops_step = 3.0 * sum(fwd.values())
    timed = step_ms[warmup:]
    median = statistics.median(timed)
    out = {
        "mode": mode,
        "model": (f"ResNet-50, {inp.dims[2]} x {inp.dims[3]}, {classes} "
                  f"classes, {len(fwd)} op types counted"),
        "batch": RESNET_BATCH,
        "steps": steps,
        "timed_steps": timed_steps,
        "losses": losses,
        "step_ms": step_ms,
        "median_step_ms": median,
        "images_per_s": timed_steps * RESNET_BATCH / (sum(timed) / 1e3),
        "flops_per_step": flops_step,
        "conv_flops_per_step": 3.0 * fwd[OT.OP_CONV2D],
        "mfu": flops_step / (median / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "device_busy_share": prof["device_busy_ms"] / median,
        "stream_busy_share": prof["stream_ms"] / median,
        "max_memory_allocated": torch.cuda.max_memory_allocated() - held,
        "launches": launches,
        "conv_kernels": prof["matched"]["conv"],
        "layout_transposes": prof["matched"]["layout"],
        "profiled_step": prof,
    }
    if keep_masters:
        out["masters"] = {n: {k: t.detach().clone() for k, t in ws.items()}
                          for n, ws in ff._params.items()}
    del ff, staged, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def log_resnet(r: dict):
    p = r["profiled_step"]
    log(f"  {r['mode']}: losses {[round(v, 4) for v in r['losses']]}")
    log(f"  {r['images_per_s']:.1f} images/s, median step "
        f"{r['median_step_ms']:.2f} ms, MFU {100 * r['mfu']:.2f}% "
        f"({r['flops_per_step'] / 1e9:.1f} GFLOP a step, conv "
        f"{r['conv_flops_per_step'] / 1e9:.1f}), kernel time of a "
        f"profiled step {p['device_busy_ms']:.2f} ms ("
        f"{100 * r['device_busy_share']:.1f}% of the median; stream "
        f"{p['stream_ms']:.2f} ms), {p['device_kernels']} kernel launches; "
        f"convolution kernels {r['conv_kernels']['count']} launches "
        f"{r['conv_kernels']['ms']:.2f} ms (top {r['conv_kernels']['top']}), "
        f"NCHW<->NHWC transposes {r['layout_transposes']['count']} launches "
        f"{r['layout_transposes']['ms']:.2f} ms; max_memory_allocated "
        f"{r['max_memory_allocated']} B; top {p['top'][:4]}")


def telemetry_phase(base: dict) -> dict:
    """Phase 6's run (lm-base, bf16, captured, 3 warm-up and 10 timed
    steps through fit) with --telemetry-dir in a fresh temporary directory
    and --metrics-interval 1, its steps untimed by this script. Fatal:
    trace.json is a Chrome trace with compile, step and data_wait spans;
    metrics.jsonl holds the manifest naming the card (`card_line()`), one
    step record per step and a summary; metrics.prom exists; each step
    launches what phase 6's did (K1-K7, sm90); the median of the recorded
    timed step times and the final MFU gauge are within 15% of phase 6's
    (`base`), the summary's p50 (a histogram estimate) within one bucket
    of phase 6's median."""
    import shutil
    import tempfile

    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.search.machine_model import card_line
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = lm_config()
        ff = build_train_lm("bf16", flags=("--telemetry-dir", tdir,
                                           "--metrics-interval", "1"))
        x, y = train_batch(cfg.vocab_size)
        steps = WARMUP_STEPS + TIMED_STEPS
        c = counters()
        step_fn = ff.executor.build_train_step()
        per_step, per_variant = [], []

        def counted(*args):
            before = {k: v.launches for k, v in c.items()}
            before_v = {k: dict(c[k].variants) for k in FLASH_KERNELS}
            out = step_fn(*args)
            per_step.append({k: v.launches - before[k]
                             for k, v in c.items()})
            per_variant.append({k: {var: n - before_v[k].get(var, 0)
                                    for var, n in c[k].variants.items()
                                    if n - before_v[k].get(var, 0)}
                                for k in FLASH_KERNELS})
            return out

        ff.executor._train_step = counted
        reset_counters()
        t0 = time.perf_counter()
        ff.fit({k: np.concatenate([v] * steps) for k, v in x.items()},
               np.concatenate([y] * steps), epochs=1,
               batch_size=TRAIN_BATCH, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        ff.get_telemetry().close()  # the final snapshot; the exporter stops
        require(step_fn.captures == 1,
                f"telemetry: {step_fn.captures} captures")
        want = step_launches(cfg.num_layers, False)
        want_var = {k: ({"sm90": n} if n else {}) for k, n in want.items()
                    if k in FLASH_KERNELS}
        require(len(per_step) == steps, f"telemetry: {len(per_step)} steps")
        for i, (n, vs) in enumerate(zip(per_step, per_variant)):
            got = {k: n[k] for k in want}
            require(got == want and vs == want_var,
                    f"telemetry step {i}: launches {got} {vs}, want {want} "
                    f"{want_var}")
        require(per_step[-1] == base["launches_per_step"],
                f"telemetry: a step launches {per_step[-1]}, phase 6's "
                f"{base['launches_per_step']}")

        with open(os.path.join(tdir, "trace.json")) as f:
            trace = json.load(f)
        evs = trace["traceEvents"]
        require(isinstance(evs, list) and all("name" in e and "ph" in e
                                              for e in evs),
                "trace.json is not a Chrome trace")
        spans = [e for e in evs if e["ph"] == "X"]
        names = {e["name"] for e in spans}
        require({"compile", "step", "data_wait"} <= names,
                f"trace.json spans: {sorted(names)}")
        require(sum(e["name"] == "step" for e in spans) == steps,
                "trace.json: one step span a step")
        recs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
        man = recs[0]
        card = card_line()
        require(man["kind"] == "manifest" and man.get("card") == card
                and man.get("device_kind") == torch.cuda.get_device_name(0),
                f"manifest {man} does not name the card {card!r}")
        step_recs = [r for r in recs if r["kind"] == "step"]
        require([r["step"] for r in step_recs] == list(range(1, steps + 1)),
                f"step records {[r['step'] for r in step_recs]}")
        summaries = [r for r in recs if r["kind"] == "summary"]
        require(summaries and summaries[-1]["steps"] == steps,
                f"summary records {summaries}")
        summary = summaries[-1]
        require(os.path.exists(os.path.join(tdir, "metrics.prom")),
                "no metrics.prom")
        snaps = [r for r in recs if r["kind"] == "metrics_snapshot"]
        gauge_mfu = snaps[-1]["metrics"]["gauges"]["train_mfu"]

        timed = step_recs[WARMUP_STEPS:]
        median_s = statistics.median(r["step_time_s"] for r in timed)
        base_s = base["median_step_ms"] / 1e3
        p50 = summary["p50_step_time_s"]
        out = {
            "steps": steps,
            "fit_wall_s": fit_s,
            "recorded_median_step_ms": 1e3 * median_s,
            "recorded_step_ms": [1e3 * r["step_time_s"] for r in step_recs],
            "data_wait_ms": [1e3 * r["data_wait_s"] for r in step_recs],
            "device_time_ms": [1e3 * r["device_time_s"] for r in step_recs],
            "summary_p50_step_ms": 1e3 * p50,
            "summary_p95_step_ms": 1e3 * summary["p95_step_time_s"],
            "summary_mfu": summary.get("mfu"),
            "mfu_gauge": gauge_mfu,
            "phase6_median_step_ms": base["median_step_ms"],
            "phase6_mfu": base["mfu"],
            "recorded_vs_phase6": median_s / base_s,
            "p50_vs_phase6": p50 / base_s,
            "mfu_gauge_vs_phase6": gauge_mfu / base["mfu"],
            "p50_within_15pct": abs(p50 / base_s - 1) <= TELEMETRY_RTOL,
            "records": sorted({r["kind"] for r in recs}),
            "snapshots": len(snaps),
            "launches_per_step": per_step[-1],
        }
        require(abs(median_s / base_s - 1) <= TELEMETRY_RTOL,
                f"telemetry's median step {1e3 * median_s:.3f} ms vs phase "
                f"6's {base['median_step_ms']:.3f} ms")
        require(abs(gauge_mfu / base["mfu"] - 1) <= TELEMETRY_RTOL,
                f"telemetry's MFU gauge {gauge_mfu:.4f} vs phase 6's "
                f"{base['mfu']:.4f}")
        require(1 / BUCKET_RATIO <= p50 / base_s <= BUCKET_RATIO,
                f"telemetry's summary p50 {1e3 * p50:.3f} ms is more than "
                f"a histogram bucket from phase 6's median "
                f"{base['median_step_ms']:.3f} ms")
        del ff, step_fn
        return out
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def nccl_collectives() -> dict:
    """Phase 15's second half, under its NCCL group of one rank: the
    port's collectives at lm-base's MLP shapes, captured in one CUDA
    graph and replayed on new inputs: the weight-gradient reduction
    (`sync_grad`: a reduce-scatter then an all-gather along dim 0, and
    the all-reduce of a weight with no shardable dim) and stage 2's
    gather (`ParamGather`: an all-gather forward, the gradient's
    reduce-scatter backward). Over one rank each is the identity, so
    every replay's outputs must equal its inputs bit for bit."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.machine import _Group
    from flexflow_tpu_torch.parallel.spmd import ParamGather, sync_grad

    group = _Group(dist.group.WORLD, [0], 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grad = torch.empty(EMBED, 4 * EMBED, device="cuda")
    bias_grad = torch.empty(4 * EMBED, device="cuda")
    shard = torch.empty(EMBED, 4 * EMBED, device="cuda", requires_grad=True)
    cotangent = torch.empty(EMBED, 4 * EMBED, device="cuda")
    ins = (grad, bias_grad, shard, cotangent)

    def fill():
        with torch.no_grad():
            for t in ins:
                t.normal_(generator=gen)

    def body():
        full = ParamGather.apply(shard, group, 0, False)
        (dshard,) = torch.autograd.grad(full, shard, cotangent)
        return (sync_grad(grad, group, 0), sync_grad(bias_grad, group, None),
                full.detach(), dshard)

    fill()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # NCCL's first call sets its communicator up: not in a graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    equal = []
    for _ in range(2):
        fill()
        graph.replay()
        torch.cuda.synchronize()
        equal.append([bool(torch.equal(o, i)) for o, i in zip(outs, ins)])
    prof, _ = profiled(graph.replay, patterns={"nccl": "(?i)nccl"})
    require(all(all(e) for e in equal),
            f"captured collectives over one rank changed their inputs: "
            f"{equal}")
    return {"replays_equal": equal, "profiled_replay": {
        k: prof[k] for k in ("device_busy_ms", "device_kernels", "top",
                             "matched")}}


def nccl_phase(p6_masters: dict) -> dict:
    """Phase 15, under an NCCL process group of one rank: phase 6's
    lm-base run (bf16, SGD, one repeated batch of 8 x 512, captured) on a
    (1, 1, 1, 1) mesh, whose step runs no collective (one rank has
    nothing to sum): it captures, and its masters after the same 14 steps
    equal phase 6's bit for bit (else within GRAD_RTOL of each layer's
    largest entry: fatal); then the port's collectives captured in a
    CUDA graph (`nccl_collectives`), the only part of the mesh path one
    card can hold under NCCL."""
    import torch.distributed as dist

    from flexflow_tpu_torch.distributed import free_port

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        run = train_phase(keep_masters=True, flags=("--mesh", "1,1,1,1"))
        run["backend"] = dist.get_backend()
        run["collectives"] = nccl_collectives()
    finally:
        dist.destroy_process_group()
    require(run["mesh_axes"] == {"data": 1, "model": 1, "pipe": 1,
                                 "seq": 1}, f"mesh {run['mesh_axes']}")
    run["vs_phase6"] = compare_masters(run.pop("masters"), p6_masters)
    return run


# ------------------------------------------------------------ the mesh
# Phase 16 (two gloo ranks on the one card, eager: gloo collectives
# cannot be captured) and the mesh run (`torchrun --nproc-per-node N
# chip_smoke.py`: one rank a card over NCCL, captured) train lm-base at
# full width over phase 6's global batch, SGD(lr=0.01), through fit: each
# dtype first on one rank alone, then on meshes of the world's ranks.
# Every mesh starts from the one-rank run's masters (each rank draws the
# full tensor from the seed), so a mesh run is held to the one-rank run
# by what it changed: per master, ||dmesh - done|| / ||done|| with d the
# change from the initial masters (`delta_rel`; a master whose change is
# below DELTA_FLOOR of the run's largest, such as the key bias, whose
# exact gradient is 0, against that floor), and per step the loss's
# relative difference (`loss_rel`). A gradient summed twice, or an update
# skipped, moves a master's change by all of it: delta_rel 1. float32
# (tensor-op math off): only the order of sums differs (on 4 CPU ranks
# at 2 layers of width 256: delta_rel 2.3e-5, loss_rel 1.5e-7). bf16:
# each rank rounds its own activations and partial gradients to 8 bits
# of mantissa (there: delta_rel 8e-3, loss_rel 7.2e-5). Stages 2 and 3
# must equal the replicated dp run bit for bit.
MESH_TOL = {"f32": dict(delta_rel=1e-3, loss_rel=2e-6),
            "bf16": dict(delta_rel=1e-1, loss_rel=1e-3)}
DELTA_FLOOR = 1e-2
GLOO_LAYERS, GLOO_STEPS = 2, 3
# the torchrun run: lm-base at 4 layers for the dp / tp / stage runs; at
# its 12 layers for sp (lm-base-seq4096) and the pipelined pp runs
MESH_LAYERS, MESH_STEPS = 4, 4
MESH_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def gloo_p2p_probe(rank: int) -> str:
    """Whether gloo takes a point-to-point ring hop (batch_isend_irecv) of
    CUDA tensors: stage 3's ring all-gather needs it. A refusal raises or
    aborts the process (`gloo_phase` reads either as no)."""
    import torch
    import torch.distributed as dist

    x = torch.full((1024,), float(rank), device="cuda:0")
    y = torch.empty_like(x)
    try:
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            r.wait()
        torch.cuda.synchronize()
        return "ok" if float(y[0]) == 1 - rank else f"wrong value {y[0]}"
    except Exception as e:
        return f"{type(e).__name__}: {str(e)[:200]}"


def _full_masters(ff) -> dict:
    """Every master as a whole float32 tensor on the host (a collective
    on a sharded mesh: every rank calls it in the same order), copied:
    on the CPU `get_weight` may hand back the live master's memory."""
    import torch

    return {f"{n}.{k}": torch.from_numpy(
        np.array(ff.get_weight(n, k), dtype=np.float32, copy=True))
        for n, ws in ff._params.items() for k in ws}


def mesh_run(name: str, lm, device: str, dtype: str, mesh: tuple,
             flags: tuple = (), tp: bool = False, steps: int = GLOO_STEPS,
             captured: bool = False, sp: bool = False,
             build: LMBuild = STANDARD, batch: int = TRAIN_BATCH):
    """One training run of `lm` on this rank on `device`: the global batch
    of `train_batch` (`batch` rows; each data rank keeps its rows),
    `steps` SGD steps through fit, each timed, captured or under
    executor.eager(); on the card one more step profiled. `tp` sets
    megatron_transformer, `sp` sequence_parallel_attention; `build` how
    the LM is built (PIPELINED: 2 P microbatches). Returns
    (its numbers, its masters after the run, its initial masters)."""
    import contextlib
    import importlib

    import torch

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.executor import eager
    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.parallel import (
        megatron_transformer,
        sequence_parallel_attention,
    )

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = FFConfig(device=device)
    cfg.parse_args(["--dtype", "fp32" if dtype == "f32" else dtype,
                    "--seed", str(SEED), "-b", str(batch), "--mesh",
                    ",".join(map(str, mesh)), *flags])
    cfg.allow_tensor_op_math_conversion = dtype == "bf16"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ff = FFModel(cfg)
    build.into(ff, lm)
    if tp:
        ff.set_strategy(megatron_transformer(ff))
    if sp:
        ff.set_strategy(sequence_parallel_attention(ff))
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    initial = _full_masters(ff)
    x, y = train_batch(lm.vocab_size, batch, lm.sequence_length)
    xs = {k: np.concatenate([v] * steps) for k, v in x.items()}
    ys = np.concatenate([y] * steps)
    step = ff.executor.build_train_step()
    step_ms, losses = [], []

    def timed(*args):
        sync()
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[-1]))
        return out

    heads = []
    flash_attention = importlib.import_module(
        "flexflow_tpu_torch.kernels.flash_attention")
    packed = flash_attention.flash_attention_packed
    with_lse = flash_attention.flash_attention_with_lse

    def seen(q, k, v, *, num_heads, **kw):
        heads.append(num_heads)
        return packed(q, k, v, num_heads=num_heads, **kw)

    def seen_lse(q, k, v, **kw):  # ring attention's blocks
        heads.append(q.shape[1])
        return with_lse(q, k, v, **kw)

    ff.executor._train_step = timed
    reset_counters()
    with (contextlib.nullcontext() if captured else eager()), \
            mock.patch.object(flash_attention, "flash_attention_packed",
                              seen), \
            mock.patch.object(flash_attention, "flash_attention_with_lse",
                              seen_lse):
        ff.fit(xs, ys, epochs=1, batch_size=batch, shuffle=False,
               verbose=False)
        launches = {k: counters()[k].launches for k in MESH_KERNELS}
        variants = {k: dict(counters()[k].variants) for k in FLASH_KERNELS}
        prof = None
        if on_card:
            staged = ff._make_batch(x, y)
            prof, _ = profiled(lambda: step(
                ff._params, ff._state, ff._opt_slots, ff._step,
                ff._counters, staged, ff._rng), patterns={"nccl": "(?i)nccl"})
    sync()
    # eager: the first step warms up; captured: the second captures too
    med = statistics.median(step_ms[2 if captured else 1:])
    numbers = {
        "name": name, "dtype": dtype, "mesh": list(ff.mesh.shape.values()),
        "device": device,
        "captures": getattr(step, "captures", 0), "losses": losses,
        "step_ms": step_ms, "median_step_ms": med,
        "tokens_per_s_per_chip": (batch * lm.sequence_length
                                  / (med / 1e3) / ff.mesh.size),
        "batch": batch, "seq": lm.sequence_length,
        "layers": lm.num_layers, "heads": lm.num_heads,
        "rules": sorted({r["kind"] for r in getattr(
            ff.executor, "_rules", {}).values()}),
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
        "launches": launches, "flash_variants": variants,
        "flash_heads": sorted(set(heads)),
        "attn_tp": attn_tp(ff),
        "plan_source": ff._plan_source,
        "plan": {n: {w: str(spec) for w, spec in ov["weights"].items()}
                 for n, ov in (ff._strategy or {}).items()
                 if ov["weights"]},
        "update_sharding": {k: ff._update_sharding.get(k)
                            for k in ("enabled", "stage", "shards",
                                      "reason")}}
    if prof is not None:
        numbers.update(
            device_busy_ms=prof["device_busy_ms"],
            device_busy_share=prof["device_busy_ms"] / med,
            nccl_ms=prof["matched"]["nccl"]["ms"], top_kernels=prof["top"])
    masters = _full_masters(ff)
    del ff, step
    return numbers, masters, initial


def attn_tp(ff) -> int:
    """How many ways the plan splits the attention heads: the model axis's
    size where an attention node's query weight rides it, else 1."""
    from flexflow_tpu_torch.fftype import OperatorType

    for node in ff.graph.topo_order():
        if (node.op_type == OperatorType.OP_MULTIHEAD_ATTENTION
                and "model" in str(node.weight_axes.get("wq"))):
            return int(ff.mesh.shape["model"])
    return 1


# the search's runs of the mesh: its budget (search_torch.BUDGET) and, on
# the card, how many ops rank 0 calibrates first
SEARCH_FLAGS = ("--budget", "6", "--enable-parameter-parallel")
SEARCH_CALIBRATE = 4


def mesh_agree(got: dict, want: dict, initial: dict, got_losses: list,
               want_losses: list, tol: dict) -> dict:
    """A mesh run against the one-rank run (see MESH_TOL): the largest
    delta_rel over the masters and the three masters that reach the
    most, the largest max-abs difference of a master, the largest
    loss_rel, and whether both are within `tol`."""
    done = {k: want[k].double() - w0.double() for k, w0 in initial.items()}
    floor = DELTA_FLOOR * max(float(d.norm()) for d in done.values())
    rels, max_abs = [], 0.0
    for k, d in done.items():
        diff = got[k].double() - initial[k].double() - d
        rels.append((float(diff.norm()) / max(float(d.norm()), floor), k))
        max_abs = max(max_abs, float((got[k] - want[k]).abs().max()))
    rels.sort(reverse=True)
    worst = rels[0][0]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got_losses, want_losses))
    return {"within_tolerance": (worst <= tol["delta_rel"]
                                 and loss_rel <= tol["loss_rel"]
                                 and len(got_losses) == len(want_losses)),
            "delta_rel": worst, "worst_tensors": rels[:3],
            "max_abs_diff": max_abs, "loss_rel": loss_rel, "tolerance": tol}


def mesh_check(device: str, lm, steps: int, captured: bool,
               stage3: bool = True, search: bool = False, seq_lm=None,
               pipe_lm=None) -> dict:
    """Every run of this rank under the process group already started:
    per dtype one rank alone, then dp over the world, dp / 2 x tp 2 (a
    world of 4 or more), tp over the world (where it divides the heads),
    each held to one rank by `mesh_agree`; in bf16 dp under stage 2 (and
    stage 3 when `stage3`) bit-equal to replicated dp. With `search`, in
    bf16 also dp over the world with no update flag (the decision
    priced) and the Unity search's plan (SEARCH_FLAGS with
    --search-mesh-shapes, from dp / 2 x tp 2 on a world of 4 or more; on
    the card rank 0 calibrates SEARCH_CALIBRATE ops first), each held to
    one rank. With `seq_lm` (lm-base at a long sequence, batch 1), per
    dtype: sp over the world (`sequence_parallel_attention`, ring
    attention) held to one rank of the same model with flash attention;
    with `pipe_lm`, per dtype: the pipelined LM on pp over the world and
    dp 2 x pp world / 2 held to its one-rank run (2 P microbatches).
    On the card every run must launch K1, K4 and K5-K7 (and, captured,
    capture once); the flash kernels must see heads / (the plan's
    attention split) heads. Returns the runs, the
    checks and the failed ones (`failures`)."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    on_card = torch.device(device).type == "cuda"
    off = ("--weight-update-sharding=off",)
    plans = [(f"dp {world}", (world, 1, 1, 1), off, False)]
    if world % 2 == 0 and world > 2:
        plans.append((f"dp {world // 2} x tp 2", (world // 2, 2, 1, 1), off,
                      True))
    if lm.num_heads % world == 0:
        plans.append((f"tp {world}", (1, world, 1, 1), off, True))
    failures, runs, checks = [], [], {}

    def attempt(name, dtype, mesh, flags=(), tp=False, model=None, **kw):
        # a run that raises does so on every rank alike (the same program
        # on the same shapes), so the ranks stay in step past it
        try:
            return mesh_run(name, model or lm, device, dtype, mesh, flags,
                            tp, steps, captured, **kw)
        except Exception as e:
            failures.append(f"{name} {dtype}: {type(e).__name__}: "
                            f"{str(e)[:300]}")
            return None, None, None

    t0 = time.perf_counter()
    dp_masters = None
    for dtype in ("f32", "bf16"):
        one, ref, initial = attempt("one rank", dtype, (1, 1, 1, 1))
        if one is None:
            continue
        runs.append(one)
        extra = []
        if search and dtype == "bf16":
            start = ((world // 2, 2, 1, 1) if world % 2 == 0 and world > 2
                     else (world, 1, 1, 1))
            calib = ("--calibrate", str(SEARCH_CALIBRATE)) if on_card else ()
            extra = [(f"dp {world} priced", (world, 1, 1, 1), (), False),
                     ("searched", start,
                      SEARCH_FLAGS + calib + ("--search-mesh-shapes",),
                      False)]
        for name, mesh, flags, tp in plans + extra:
            r, masters, _ = attempt(name, dtype, mesh, flags, tp)
            if r is None:
                continue
            key = f"{name} {dtype}"
            checks[key] = mesh_agree(masters, ref, initial, r["losses"],
                                     one["losses"], MESH_TOL[dtype])
            if not checks[key]["within_tolerance"]:
                failures.append(f"{key} vs one rank: {checks[key]}")
            runs.append(r)
            if name == plans[0][0] and dtype == "bf16":
                dp_masters = masters
        del ref, initial
        gc.collect()
    for stage in (2, 3) if stage3 else (2,):
        name = f"dp {world} stage {stage}"
        r, masters, _ = attempt(name, "bf16", (world, 1, 1, 1),
                                (f"--weight-update-sharding=stage{stage}",))
        if r is None or dp_masters is None:
            continue
        same = all(torch.equal(masters[k], v) for k, v in dp_masters.items())
        checks[f"{name} bf16"] = {"bitwise_equal_to_dp": same}
        if not same:
            failures.append(f"{name}: masters differ from dp {world}'s")
        runs.append(r)
    families = []
    if seq_lm is not None and seq_lm.sequence_length % world == 0:
        # one rank with exact (flash) attention, then sp over the world
        one = dataclasses.replace(seq_lm, attention_impl="flash")
        ring = dataclasses.replace(seq_lm, attention_impl="ring")
        families.append((f"seq {seq_lm.sequence_length}", one, dict(
            batch=1), [(f"sp {world}", (1, 1, 1, world), ring, dict(
                batch=1, sp=True))]))
    if pipe_lm is not None and pipe_lm.num_layers % world == 0:
        kw = dict(build=PIPELINED)
        plans_pp = [(f"pp {world}", (1, 1, world, 1), pipe_lm, kw)]
        if world % 2 == 0 and world > 2:
            plans_pp.append((f"dp 2 x pp {world // 2}",
                             (2, 1, world // 2, 1), pipe_lm, kw))
        families.append(("pipelined", pipe_lm, kw, plans_pp))
    for label, one_lm, one_kw, fam_plans in families:
        for dtype in ("f32", "bf16"):
            one, ref, initial = attempt(f"one rank ({label})", dtype,
                                        (1, 1, 1, 1), off, model=one_lm,
                                        **one_kw)
            if one is None:
                continue
            runs.append(one)
            for name, mesh, model, kw in fam_plans:
                r, masters, _ = attempt(name, dtype, mesh, off, model=model,
                                        **kw)
                if r is None:
                    continue
                key = f"{name} {dtype}"
                checks[key] = mesh_agree(masters, ref, initial, r["losses"],
                                         one["losses"], MESH_TOL[dtype])
                if not checks[key]["within_tolerance"]:
                    failures.append(f"{key} vs one rank: {checks[key]}")
                runs.append(r)
            del ref, initial
            gc.collect()
    for r in runs:
        tp = r["attn_tp"]
        if r["flash_heads"] != [r["heads"] // tp]:
            failures.append(f"{r['name']} {r['dtype']}: flash kernels on "
                            f"{r['flash_heads']} heads, want "
                            f"{[r['heads'] // tp]}")
        if on_card and not all(r["launches"].values()):
            failures.append(f"{r['name']} {r['dtype']}: launches "
                            f"{r['launches']}")
        if on_card and captured and r["captures"] != 1:
            failures.append(f"{r['name']} {r['dtype']}: {r['captures']} "
                            f"captures")
    return {"rank": dist.get_rank(), "world": world, "device": device,
            "backend": dist.get_backend(), "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "runs": runs,
            "checks": checks, "failures": failures}


def mesh_resume_check(device: str, lm, steps: int, captured: bool) -> dict:
    """Phase 19's torchrun leg on this rank of the process group already
    started: `lm` in bf16 trains `steps` steps at dp world under stage 3
    (the masters sharded at rest) and saves (the save gathers the shards
    in this thread, rank 0 writes); dp world/2 x tp 2 restores it, its
    whole masters bit-equal to the saved ones, and takes 2 more steps,
    held by `mesh_agree` to one rank that restores the same checkpoint
    and takes the same steps. Then a SIGTERM sent to rank 0 alone (from
    its step-2 hook): every rank stops at step 3 (the flag is agreed over
    the group) with one final snapshot. Returns the numbers, the checks
    and the failed ones."""
    import contextlib
    import signal
    import tempfile

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.distributed import broadcast_json, gather_json
    from flexflow_tpu_torch.executor import eager
    from flexflow_tpu_torch.parallel import megatron_transformer
    from flexflow_tpu_torch.resilience import latest_checkpoint

    world, rank = dist.get_world_size(), dist.get_rank()
    root = broadcast_json({"root": tempfile.mkdtemp(prefix="mesh_ck_")}
                          if rank == 0 else None)["root"]
    x, y = train_batch(lm.vocab_size, TRAIN_BATCH, lm.sequence_length)
    failures, checks, numbers = [], {}, {}
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def model(mesh, flags, tp=False):
        cfg = FFConfig(device=device)
        cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                        str(TRAIN_BATCH), "--mesh",
                        ",".join(map(str, mesh)), *flags])
        ff = FFModel(cfg)
        STANDARD.into(ff, lm)
        if tp:
            ff.set_strategy(megatron_transformer(ff))
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[MetricsType.METRICS_ACCURACY])
        return ff

    def fit(ff, n):
        step = ff.executor.build_train_step()
        losses = []

        def record(*args):
            out = step(*args)
            losses.append(float(out[-1]))
            return out

        ff.executor._train_step = record
        with contextlib.nullcontext() if captured else eager():
            ff.fit({k: np.concatenate([v] * n) for k, v in x.items()},
                   np.concatenate([y] * n), epochs=1,
                   batch_size=TRAIN_BATCH, shuffle=False, verbose=False)
        ff.executor._train_step = step
        return losses

    t0 = time.perf_counter()
    off = "--weight-update-sharding=off"
    try:
        saved = model((world, 1, 1, 1), ("--weight-update-sharding=stage3",))
        fit(saved, steps)
        ck = os.path.join(root, "stage3")
        sync()
        t_s = time.perf_counter()
        saved.save_checkpoint(ck)
        numbers["save_s"] = time.perf_counter() - t_s
        whole = _full_masters(saved)
        numbers["saved_stage"] = saved._update_sharding.get("stage")
        numbers["local_of_whole"] = (
            saved._params["l0_ffn1"]["kernel"].numel(),
            int(whole["l0_ffn1.kernel"].numel()))
        del saved
        gc.collect()
        ref_losses = None
        for name, mesh, tp in (("one rank", (1, 1, 1, 1), False),
                               (f"dp {world // 2} x tp 2",
                                (world // 2, 2, 1, 1), True)):
            ff = model(mesh, (off,), tp)
            t_r = time.perf_counter()
            ff.load_checkpoint(ck)
            numbers[f"restore_s {name}"] = time.perf_counter() - t_r
            # the fftrans gate verified the restore before it wrote a
            # tensor: its plan on the model, priced, with no error
            tr = ff._transition or {}
            an = tr.get("analysis") or {}
            checks[f"transition {name}"] = {
                "set": bool(tr), "errors": an.get("errors"),
                "predicted_s": tr.get("predicted_s"),
                "transfers": len(tr.get("transfers") or ())}
            if not tr or an.get("errors"):
                failures.append(f"restored {name}: transition "
                                f"{checks[f'transition {name}']}")
            got = _full_masters(ff)
            same = [k for k, v in whole.items() if not torch.equal(got[k], v)]
            checks[f"restored {name}"] = {"bitwise_equal": not same,
                                          "differ": same[:4]}
            if same:
                failures.append(f"restored {name}: masters differ from the "
                                f"saved ones at {same[:4]}")
            losses = fit(ff, 2)
            masters = _full_masters(ff)
            if ref_losses is None:
                ref_losses, ref = losses, masters
            else:
                c = checks[f"{name} after restore"] = mesh_agree(
                    masters, ref, whole, losses, ref_losses, MESH_TOL["bf16"])
                if not c["within_tolerance"]:
                    failures.append(f"{name} after restore vs one rank: {c}")
            del ff
            gc.collect()
        del ref, whole
        # SIGTERM to rank 0 alone
        ff = model((world, 1, 1, 1), (off, "--checkpoint-dir",
                                      os.path.join(root, "sigterm")))
        if rank == 0:
            ff.set_fault_hook(lambda s: os.kill(os.getpid(), signal.SIGTERM)
                              if s == 2 else None)
        fit(ff, 6)
        stopped = [o["step"] for o in gather_json({"step": ff._py_step()})]
        last = latest_checkpoint(os.path.join(root, "sigterm"))
        checks["sigterm to rank 0"] = {"stopped": stopped, "latest": last}
        if stopped != [3] * world or not (last or "").endswith("00000003"):
            failures.append(f"sigterm to rank 0: ranks stopped at {stopped},"
                            f" latest {last}")
        del ff
    except Exception as e:  # every rank fails alike: the same program
        failures.append(f"resume leg: {type(e).__name__}: {str(e)[:300]}")
    dist.barrier()
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {"rank": rank, "world": world, "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "numbers": numbers,
            "checks": checks, "failures": failures}


def mesh_barrier_check(device: str, lm) -> dict:
    """Phase 21(e) on this rank of the process group already started:
    `lm` in bf16 at dp world/2 x tp 2 (Megatron) compiled with
    --spmd-barrier: every rank's step fingerprint agrees with rank 0's
    (status "ok", one fingerprint over the ranks); then the same compile
    with rank 2 (else the last rank) alone on another numerics policy
    (no tensor-op math): SPMDDivergenceError on every rank, rank 2 naming
    the component, the others aborting in lockstep, and a barrier after
    it returns (no rank hangs). Returns the numbers, the checks and the
    failed ones."""
    import torch.distributed as dist

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.analysis.spmd import SPMDDivergenceError
    from flexflow_tpu_torch.distributed import gather_json
    from flexflow_tpu_torch.parallel import megatron_transformer

    world, rank = dist.get_world_size(), dist.get_rank()
    planted_rank = min(2, world - 1)
    failures, checks, numbers = [], {}, {}

    def compile_lm(plant: bool):
        cfg = FFConfig(device=device)
        cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                        str(TRAIN_BATCH), "--mesh",
                        f"{world // 2},2,1,1", "--spmd-barrier"])
        if plant and rank == planted_rank:
            cfg.allow_tensor_op_math_conversion = False
        ff = FFModel(cfg)
        STANDARD.into(ff, lm)
        ff.set_strategy(megatron_transformer(ff))
        t0 = time.perf_counter()
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        return ff, time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        ff, numbers["compile_s"] = compile_lm(False)
        v = ff._spmd_barrier or {}
        fps = [o["fp"] for o in gather_json(
            {"fp": v.get("fingerprint"), "status": v.get("status")})]
        checks["lockstep"] = {"status": v.get("status"),
                              "one_fingerprint": len(set(fps)) == 1}
        if v.get("status") != "ok" or len(set(fps)) != 1:
            failures.append(f"--spmd-barrier lockstep: {v}, {fps}")
        del ff
        gc.collect()
        raised = None
        try:
            compile_lm(True)
        except SPMDDivergenceError as e:
            raised = {"peer_mismatch": e.peer_mismatch,
                      "names_numerics": "numerics" in str(e)}
        dist.barrier()  # every rank got here: no hang
        checks["planted"] = {"planted_rank": planted_rank,
                             "raised": raised}
        want_peer = rank != planted_rank
        if raised is None or raised["peer_mismatch"] != want_peer or (
                not want_peer and not raised["names_numerics"]):
            failures.append(f"planted mismatch on rank {planted_rank}: "
                            f"rank {rank} {raised}")
    except Exception as e:  # every rank fails alike: the same program
        failures.append(f"barrier leg: {type(e).__name__}: {str(e)[:300]}")
    return {"rank": rank, "world": world, "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "numbers": numbers,
            "checks": checks, "failures": failures}


def mesh_diag_check(device: str, lm, captured: bool) -> dict:
    """Phase 20's torchrun leg on this rank of the process group already
    started: `lm` in bf16 at dp world through fit with --diagnostics
    (each rank its own telemetry dir), 6 steps of phase 6's batch:
    (a) a NaN planted in rank 1's forward alone (its executor's fault on
    the first LINEAR from device step 2) under --health-abort-on
    nan_loss: every rank raises HealthAbort at step 3 (the loss is the
    batch's, summed over the ranks) and none hangs; (b) a rule that
    fires on rank 1 alone at step 3, per step and in chunks of 2: every
    rank raises HealthAbort at that step edge, the others by the abort
    flag agreed in the step edge's all-reduce (`peer_abort`); (c) a 3 s
    stall inside rank 2's step 4 (its graph warmed up, captured and
    replayed before) under --watchdog-timeout 1 (--watchdog-multiplier
    2), one telemetry dir for all ranks: the watchdogs that fire in the
    stall (their last step 3 or 4) name rank 2 from the heartbeats.
    Returns the numbers, the checks and the failed ones."""
    import contextlib
    import tempfile

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.diagnostics import HealthAbort
    from flexflow_tpu_torch.diagnostics.health import (
        Alert, Rule, default_rules)
    from flexflow_tpu_torch.distributed import broadcast_json, gather_json
    from flexflow_tpu_torch.executor import eager
    from flexflow_tpu_torch.telemetry import deactivate, read_jsonl

    world, rank = dist.get_world_size(), dist.get_rank()
    root = broadcast_json({"root": tempfile.mkdtemp(prefix="mesh_diag_")}
                          if rank == 0 else None)["root"]
    x, y = train_batch(lm.vocab_size, TRAIN_BATCH, lm.sequence_length)
    xs = {k: np.concatenate([v] * 6) for k, v in x.items()}
    ys = np.concatenate([y] * 6)
    failures, checks, numbers = [], {}, {}

    class RankRule(Rule):
        """Fires at step 3 on rank 1 alone."""
        name = "rank_local"

        def _check(self, rec):
            if rank == 1 and rec["step"] == 3:
                return Alert(rule=self.name, level="error", step=3,
                             message="a rank-local rule")
            return None

    def model(flags, tdir):
        cfg = FFConfig(device=device)
        cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                        str(TRAIN_BATCH), "--mesh", f"{world},1,1,1",
                        "--weight-update-sharding=off", "--telemetry-dir",
                        tdir, *flags])
        ff = FFModel(cfg)
        STANDARD.into(ff, lm)
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[MetricsType.METRICS_ACCURACY])
        return ff

    def fit(ff, pipeline_steps=1):
        t0 = time.perf_counter()
        with contextlib.nullcontext() if captured else eager():
            try:
                ff.fit(xs, ys, epochs=1, batch_size=TRAIN_BATCH,
                       shuffle=False, verbose=False,
                       pipeline_steps=pipeline_steps)
                out = {"raised": None}
            except HealthAbort as e:
                out = {"raised": e.alert.rule, "alert_step": e.alert.step}
        deactivate()
        out.update(step=ff._py_step(), s=time.perf_counter() - t0)
        return gather_json(out)

    t0 = time.perf_counter()
    try:
        # (a) NaN in rank 1's forward alone
        ff = model(("--diagnostics", "--health-abort-on", "nan_loss"),
                   os.path.join(root, f"nan_{rank}"))
        first_linear = next(n.name for n in ff.graph.topo_order()
                            if n.op_type.name == "OP_LINEAR")
        if rank == 1:
            ff.executor.set_numeric_fault(first_linear, "fwd", 2)
        got = fit(ff)
        checks["nan on rank 1"] = got
        if [(g["raised"], g["alert_step"], g["step"]) for g in got] != [
                ("nan_loss", 3, 3)] * world:
            failures.append(f"nan on rank 1: {got}")
        del ff
        # (b) a rule of rank 1 alone, per step and in chunks of 2
        for n, stop in ((1, 3), (2, 4)):
            ff = model((), os.path.join(root, f"rule{n}_{rank}"))
            ff.enable_diagnostics(rules=default_rules(ff.config)
                                  + [RankRule()], abort_on=("rank_local",))
            got = fit(ff, n)
            checks[f"rank-local rule, chunks of {n}"] = got
            want = [("rank_local" if r == 1 else "peer_abort", stop)
                    for r in range(world)]
            if [(g["raised"], g["step"]) for g in got] != want:
                failures.append(f"rank-local rule, chunks of {n}: {got}")
            del ff
        # (c) a 3 s stall inside rank 2's step 4
        wd_dir = os.path.join(root, "wd")
        ff = model(("--diagnostics", "--watchdog-timeout", "1",
                    "--watchdog-multiplier", "2"), wd_dir)
        step = ff.executor.build_train_step()
        calls, woke = [0], [None]

        def stalled(*args):
            out = step(*args)
            calls[0] += 1
            if rank == 2 and calls[0] == 4:
                time.sleep(3.0)
                woke[0] = time.time()
            return out

        ff.executor._train_step = stalled
        got = fit(ff)
        ff.executor._train_step = step
        woke_t = gather_json({"woke": woke[0]})[2]["woke"]
        # a firing in the stall, before rank 2 woke: rank 2's (its last
        # step 3) or another's (its last step 4); a watchdog whose
        # deadline outlasts the stall (slow steps) fires after it, when
        # every heartbeat says step 4, and is no sample
        alerts = [a for a in read_jsonl(os.path.join(wd_dir, "alerts.jsonl"))
                  if a.get("rule") == "hang_watchdog"
                  and (a.get("step") or 0) >= 3 and a["t"] < woke_t]
        flight = json.load(open(os.path.join(wd_dir, "flight.json")))
        named = sorted({a.get("lagging_host") for a in alerts})
        checks["stall on rank 2"] = {
            "runs": got, "watchdog_alerts": len(alerts),
            "lagging_named": named,
            "fired_after_s": [a["t"] - woke_t + 3.0 for a in alerts],
            "flight": {k: flight["watchdog"][k] for k in (
                "lagging_host", "last_step", "stalled_s", "deadline_s")}}
        numbers["stall_fit_s"] = [g["s"] for g in got]
        if (not alerts or named != [2]
                or any(g["step"] != 6 for g in got)):
            failures.append(f"stall on rank 2: {checks['stall on rank 2']}")
        del ff
    except Exception as e:  # every rank fails alike: the same program
        failures.append(f"diag leg: {type(e).__name__}: {str(e)[:300]}")
    dist.barrier()
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {"rank": rank, "world": world, "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "numbers": numbers,
            "checks": checks, "failures": failures}


def gloo_rank(rank: int, stage3: bool) -> dict:
    """Phase 16 on one of the two ranks: `mesh_check` on cuda:0, eager,
    lm-base at GLOO_LAYERS layers."""
    import torch

    del rank
    torch.cuda.set_device(0)
    return mesh_check("cuda:0", lm_config(layers=GLOO_LAYERS), GLOO_STEPS,
                      captured=False, stage3=stage3)


def gloo_phase() -> dict:
    """Phase 16: spawn two gloo ranks on the card (cuda:0 named for each:
    NCCL refuses two ranks of one communicator on one device), probe
    gloo's ring hop of CUDA tensors, then run `gloo_rank` on both (stage
    3 only where the probe passed). Fatal: any failure on either rank."""
    from flexflow_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    try:
        probe = spawn(gloo_p2p_probe, 2, timeout=120)
    except RuntimeError as e:
        # gloo may abort the process on a refused hop of CUDA tensors
        # (std::terminate on a gloo::IoException) instead of raising
        probe = [f"a probe rank died: {e}"]
    stage3 = all(p == "ok" for p in probe)
    ranks = spawn(gloo_rank, 2, stage3, timeout=900)
    failures = [f"rank {r}: {f}" for r, out in enumerate(ranks)
                for f in out["failures"]]
    require(not failures, f"phase 16: {failures}")
    return {"p2p_probe": probe, "stage3_ran": stage3, "ranks": ranks,
            "wall_s": time.perf_counter() - t0}


# ------------------------------------------------------------ phase 17

SEARCH_TOP_K = 4
CALIB_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def op_bound_ms(node, harness):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one op's forward as the calibration harness runs it: its FLOPs
    at the bf16 peak, or each input, weight and output moved once (float
    tensors at the harness's compute dtype, state at its own)."""
    from flexflow_tpu_torch.fftype import dtype_to_torch

    def nbytes(shape, dtype, compute=True):
        dt = dtype_to_torch(dtype)
        if compute and dt.is_floating_point and harness.compute_dtype:
            dt = harness.compute_dtype
        return float(np.prod(shape)) * dt.itemsize

    moved = sum(nbytes(pt.shape.logical_shape, pt.dtype)
                for pt in node.inputs + node.outputs)
    moved += sum(nbytes(ws.shape, ws.dtype, ws.trainable)
                 for ws in node.weight_specs)
    flops = node.op_def.flops(
        node.params, [pt.shape.logical_shape for pt in node.inputs],
        [pt.shape.logical_shape for pt in node.outputs])
    return bound(moved, flops, "bfloat16")


def search_phase(train: dict, k5_ms: float) -> dict:
    """Phase 17 (see the module note): calibration on the card, then the
    joint search over the H100 model of four meshes."""
    import search_torch
    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.search.cost_model import _params_key

    t0 = time.perf_counter()
    ff = search_torch.build("cuda", lm_config().num_layers)
    reset_counters()
    cm, calib_s = search_torch.calibrate(ff, SEARCH_TOP_K)
    launches = {k: counters()[k].launches for k in MESH_KERNELS}
    variants = {k: dict(counters()[k].variants) for k in CALIB_KERNELS}
    stats = dict(cm.calib_stats)
    require(stats["measured"] == SEARCH_TOP_K,
            f"phase 17: measured {stats}, want {SEARCH_TOP_K} ops")
    for k in CALIB_KERNELS:
        require(variants[k].get("sm90", 0) > 0 and launches[k] > 0,
                f"phase 17: calibration launched {k} {launches[k]} times, "
                f"variants {variants[k]}")
    nodes: dict = {}
    for n in ff.graph.topo_order():
        nodes.setdefault(_params_key(n), n)
    ops = []
    for key, (fwd, bwd) in cm._calibration.items():
        node = nodes[key]
        b_ms, by = op_bound_ms(node, cm.harness)
        ops.append({"op": key[0].name, "node": node.name,
                    "in_shapes": [list(x) for x in key[2]],
                    "fwd_ms": fwd * 1e3, "bwd_ms": bwd * 1e3,
                    "fwd_bound_ms": b_ms, "bound_by": by})
        require(fwd * 1e3 >= b_ms,
                f"phase 17: {node.name}'s measured forward {fwd * 1e3:.5f} "
                f"ms is under its bound {b_ms:.5f} ms")
    mha = [o for o in ops if o["op"] == "OP_MULTIHEAD_ATTENTION"]
    require(len(mha) == 1, f"phase 17: no attention node measured: {ops}")
    require(mha[0]["fwd_ms"] >= k5_ms,
            f"phase 17: the attention node's forward {mha[0]['fwd_ms']:.4f}"
            f" ms is under phase 8's K5 alone ({k5_ms:.4f} ms)")
    rows = search_torch.predict(ff, search_torch.BUDGET, cm._calibration)
    for r in rows:
        require(r["configs"] and r["predicted_ms"] > 0,
                f"phase 17: the search on {r['mesh']} returned no plan")
    del ff
    gc.collect()
    one = rows[0]["predicted_ms"]
    return {"calibration": ops, "calibrate_s": calib_s, "stats": stats,
            "launches": launches, "variants": variants, "meshes": rows,
            "budget": search_torch.BUDGET,
            "one_device_predicted_ms": one,
            "phase6_median_step_ms": train["median_step_ms"],
            "predicted_vs_phase6": one / train["median_step_ms"],
            "wall_s": time.perf_counter() - t0}


def log_search(sr: dict):
    for o in sr["calibration"]:
        log(f"  measured {o['node']} ({o['op']}, in {o['in_shapes']}): "
            f"forward {o['fwd_ms']:.4f} ms (bound {o['fwd_bound_ms']:.4f} "
            f"by {o['bound_by']}), backward {o['bwd_ms']:.4f} ms")
    log(f"  calibration {sr['calibrate_s']:.1f} s, {sr['stats']}; launches "
        f"{sr['launches']}, variants {sr['variants']}")
    for r in sr["meshes"]:
        dec = r.get("update_sharding")
        note = (f"; unforced update: stage {dec['stage']} "
                f"({dec['reason']}, priced overlapped, runs serial)"
                if dec else "")
        log(f"  {r['mesh']}: predicted step {r['predicted_ms']:.3f} ms "
            f"(dp plan {r['dp_plan_ms']:.3f}), plan {r['configs']}, "
            f"search {r['search_s']:.1f} s, {r['evals']} evaluations, "
            f"{r['cache_hits']} cache hits{note}")
    log(f"  one device: predicted {sr['one_device_predicted_ms']:.3f} ms "
        f"vs phase 6's measured {sr['phase6_median_step_ms']:.3f} ms "
        f"({sr['predicted_vs_phase6']:.3f}x)")


# ------------------------------------------------------------ phase 18
# lm-base-seq4096 (JAX bench.py's long-context leg, 1237-1240): lm-base's
# widths at seq 4096, batch 1; the ring's block on sp 4 is (1, 16, 1024,
# 64) a shard
RING_SHARDS, RING_SEQ = 4, 4096
RING_CASES = ("ring diagonal", "ring off-diagonal")


def ring_phase(dev) -> dict:
    """Phase 18(b): the ring's block algebra at lm-base-seq4096's widths
    on one card. For each of the 4 shard indices, `_ring_local`'s body
    (`_block_attention`, `_merge_block`, the causal skip `_live`) with the
    hop replaced by that shard's arrival sequence (at step k the block of
    shard (idx - k) mod 4); autograd through the blocks sums each K/V
    block's gradient over the shards that held it, which the reverse hops
    do on a mesh. Out and the q, k, v gradients under a random cotangent
    against whole-sequence `flash_attention` (K5, K6, K7), causal, in
    float32 (TOL 1e-4) and bf16 (2e-2). Each live block launches K5 with
    its lse and, in the backward, K6 and K7 with the lse's cotangent from
    the merge folded into delta: 10 blocks a dtype (4 diagonal, 6 below
    it). Each case's launches are read from the counters as they happen,
    around each block's forward call and around its flash node's backward
    (hooks before and after the node), and must be one K5, K6 and K7 a
    block."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import ring_attention as ra

    c = counters()
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "flash_attention_bwd_fused")
    n, s_loc = RING_SHARDS, RING_SEQ // RING_SHARDS
    errs, worst = {}, {}
    launches = {case: dict.fromkeys(names, 0) for case in RING_CASES}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        q, k, v, do = flash_inputs(dev, dtype, 1, RING_SEQ, RING_SEQ, HEADS,
                                   HEAD_DIM, SEED + 70, "transposed")
        scale = HEAD_DIM ** -0.5
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ref = fa.flash_attention(*leaves, causal=True, scale=scale)
        torch.autograd.backward(ref, do)
        want = [ref.detach()] + [t.grad for t in leaves]
        torch.cuda.synchronize()

        def rows(t, i):
            return t[:, :, i * s_loc:(i + 1) * s_loc]

        def snap():
            return {m: c[m].launches for m in names}

        def since(before):
            return {m: c[m].launches - before[m] for m in names}

        def tally(case, delta):
            for m, k in delta.items():
                ran[case][m] += k

        # each case's launches as they happen: around each block's
        # forward, and around its flash node's backward (pre- and post-
        # hooks on the node; the engine runs one node at a time)
        ran = {case: dict.fromkeys(names, 0) for case in RING_CASES}
        bwd_nodes = {case: 0 for case in RING_CASES}

        def watch(node, case):
            held = {}

            def pre(grad_outputs):
                held["before"] = snap()

            def post(grad_inputs, grad_outputs):
                tally(case, since(held.pop("before")))
                bwd_nodes[case] += 1

            node.register_prehook(pre)
            node.register_hook(post)

        n0 = snap()
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        blocks = {case: 0 for case in RING_CASES}
        outs = []
        for idx in range(n):
            o = torch.zeros((1, HEADS, s_loc, HEAD_DIM), dtype=torch.float32,
                            device=dev)
            lse = torch.full((1, HEADS, s_loc), float("-inf"),
                             dtype=torch.float32, device=dev)
            for step in range(n):
                if not ra._live(step, idx, True):
                    continue
                src = (idx - step) % n
                case = RING_CASES[step > 0]
                blocks[case] += 1
                before = snap()
                o_blk, lse_blk = ra._block_attention(
                    rows(leaves[0], idx), rows(leaves[1], src),
                    rows(leaves[2], src), causal=step == 0, scale=scale)
                tally(case, since(before))
                watch(lse_blk.grad_fn, case)
                o, lse = ra._merge_block(o, lse, o_blk, lse_blk)
            outs.append(o.to(dtype))
        got_out = torch.cat(outs, dim=2)
        torch.autograd.backward(got_out, do)
        torch.cuda.synchronize()
        total = since(n0)
        # K6 + K7 a block past one tile (every block of seq 4096 / 4)
        fused = int(s_loc <= fa.SINGLE_TILE)
        per_block = dict(zip(names, (1, 1 - fused, 1 - fused, fused)))
        require(sum(blocks.values()) == n * (n + 1) // 2
                and bwd_nodes == blocks and total == {
                    m: sum(r[m] for r in ran.values()) for m in names},
                f"ring blocks {dn}: {blocks}, backward nodes {bwd_nodes}, "
                f"launches {total}, by case {ran}")
        for case, nb in blocks.items():
            require(ran[case] == {m: nb * k for m, k in per_block.items()},
                    f"ring {case} {dn}: {nb} blocks launched {ran[case]}")
            for m in names:
                launches[case][m] += ran[case][m]
        got = [got_out.detach()] + [t.grad for t in leaves]
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            errs[f"{name} {dn}"] = check_close(
                "ring block algebra", a, w, dn, worst)
        del q, k, v, do, leaves, ref, want, got, got_out, outs
        torch.cuda.empty_cache()
    return {"max_abs_err": errs, "launches": launches,
            "shape": f"(1, {HEADS}, {RING_SEQ}, {HEAD_DIM}) in {n} shards "
                     f"of {s_loc}"}


def ring_kernel_numbers(dev, errs) -> dict:
    """K5, K6 and K7 at the ring's block shape, (1, 16, 1024, 64) bf16 on
    the transposed layout: the diagonal block (causal) and a block below
    it (every key live), the backward's delta carrying an lse cotangent;
    each held to its plain version on the first input set (TOL; the error
    into `errs` as "<row> @ <case>"), then timed cycling over four input
    sets. Library yardsticks, timed only:
    SDPA on the same block and the device time of its backward's kernels
    (dq, dk, dv together). Returns {row: {case: numbers}}."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa

    bf16 = torch.bfloat16
    b, h, s, d = 1, HEADS, RING_SEQ // RING_SHARDS, HEAD_DIM
    rows = b * h * s * 4
    act = b * h * s * d * 2
    out: dict = {}
    for case, causal in zip(RING_CASES, (True, False)):
        kw = dict(num_heads=None, causal=causal)
        g = torch.Generator().manual_seed(SEED + 80)
        sets, lib_sets = [], []
        for i in range(4):
            q, k, v, do = flash_inputs(dev, bf16, b, s, s, h, d,
                                       SEED + 80 + i, "transposed")
            o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            g_lse = torch.randn(b, h, s, generator=g).to(dev)
            sets.append((q, k, v, do, lse,
                         fa.flash_delta(do, o, None) - g_lse))
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            lib_sets.append((F.scaled_dot_product_attention(
                *leaves, is_causal=causal), leaves, do))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        lib_fwd = time_ms(lambda o, leaves, g: F.scaled_dot_product_attention(
            *leaves, is_causal=causal), lib_sets)[0]
        lib_bwd = sdpa_backward_device_ms(lib_sets)
        for row, kern, plain, nbytes, ops, lib in (
                ("flash_attention_fwd (per-head)",
                 lambda q, k, v, *_: fa.flash_attention_fwd(q, k, v, **kw),
                 lambda q, k, v, *_: fa.flash_attention_fwd_plain(
                     q, k, v, **kw), 4 * act + rows, 4 * d * pairs, lib_fwd),
                ("flash_attention_bwd_dq (per-head)",
                 lambda *a: fa.flash_attention_bwd_dq(*a, **kw),
                 lambda *a: fa.flash_attention_bwd_dq_plain(*a, **kw),
                 5 * act + 2 * rows, 6 * d * pairs, lib_bwd),
                ("flash_attention_bwd_dkv (per-head)",
                 lambda *a: fa.flash_attention_bwd_dkv(*a, **kw),
                 lambda *a: fa.flash_attention_bwd_dkv_plain(*a, **kw),
                 6 * act + 2 * rows, 8 * d * pairs, lib_bwd)):
            for a, w in zip(_tensors(kern(*sets[0])),
                            _tensors(plain(*sets[0]))):
                check_close(f"{row} @ {case}", a, w, "bfloat16", errs)
            numbers = timed(kern, plain, None, sets, None,
                            *bound(nbytes, ops, "bfloat16"))
            numbers.update(
                library_ms=lib,
                library_is=(("" if causal else "non-") + "causal sdpa"
                            + ("" if row.startswith("flash_attention_fwd")
                               else " backward (dq, dk, dv together), "
                                    "device time of its kernels")),
                shape=(f"({b}, {h}, {s}, {d}) transposed "
                       f"{'causal' if causal else 'full'} bf16"
                       + ("" if row.startswith("flash_attention_fwd")
                          else ", lse cotangent in delta")))
            out.setdefault(row, {})[case] = numbers
        del sets, lib_sets
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 19

# 2 epochs of 8 distinct batches (16 steps); checkpoints every 4 steps; a
# fault after step 10, a SIGTERM sent from step 6's hook
P19_EPOCHS, P19_BATCHES = 2, 8
P19_EVERY, P19_KILL, P19_SIGTERM = 4, 10, 6
P19_CHUNKS = (4, 3)
# the chunked step's peak memory against the per-step one's: the graph
# pool gives what one step frees to the next inside the capture, so the
# peak must not grow with the chunk length (the staged (n, batch, ...)
# inputs are kilobytes)
P19_PEAK_RATIO = 1.1
# phase 19(d): lm-base at full width, 2 layers, on two gloo ranks of the
# one card: the Unity search runs on rank 0 (calibrating 4 ops there)
WARM_LAYERS = 2
WARM_FLAGS = ("--mesh", "2,1,1,1", "--budget", "6",
              "--enable-parameter-parallel", "--calibrate", "4",
              "--weight-update-sharding=off")


def p19_data(lm, batch: int):
    """P19_BATCHES distinct batches of random tokens and labels."""
    rs = np.random.RandomState(SEED + 19)
    n, seq = P19_BATCHES * batch, lm.sequence_length
    toks = rs.randint(0, lm.vocab_size, (n, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (n, 1))
    labels = rs.randint(0, lm.vocab_size, (n, seq, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def state_of(ff) -> dict:
    """Every trajectory-defining tensor of a one-rank model (masters,
    optimizer slots, step, metric counters, the generator's state), by
    its checkpoint path, copied."""
    from flexflow_tpu_torch.resilience.checkpointer import flatten_tree
    from flexflow_tpu_torch.resilience.reshard import model_state_tree

    return {k: v.detach().clone() for k, v in
            flatten_tree(model_state_tree(ff)).items()}


def state_diff(got: dict, want: dict) -> list:
    """The paths whose tensors are not bit-equal (or are missing)."""
    import torch

    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or got[k].shape != want[k].shape
                  or not torch.equal(got[k].to(want[k].device), want[k]))


def checkpoint_bytes(path: str) -> int:
    """The bytes of a checkpoint's leaves, from its manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    size = {"bfloat16": 2}
    return sum(int(np.prod(m["shape"])) * size.get(
        m["dtype"], np.dtype(m["dtype"]).itemsize) for m in leaves.values())


class P19Run(NamedTuple):
    ff: object
    numbers: dict
    steps: dict  # chunk length -> the step fit ran (1: the train step)


def p19_fit(device: str, lm, batch: int, pipeline_steps: int,
            flags: tuple = (), hook=None, ff=None,
            dtype: str = "bf16") -> P19Run:
    """One phase-19 fit of `lm` (bf16, SGD, `batch` rows): P19_EPOCHS
    shuffled epochs of P19_BATCHES batches, `pipeline_steps` at a time.
    Each call of the step fit runs (the train step, or a chunk) is
    wrapped: its loss(es), its device time (CUDA events) and the launches
    it added are kept. A fault `hook` may stop the fit (SimulatedPreemption
    is caught: `killed`). Given `ff`, fits that model again (a resume).
    `dtype`: "bf16" (over f32 masters) or "f32"."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.resilience import (
        ResilienceManager, SimulatedPreemption)

    on_card = torch.device(device).type == "cuda"
    held = 0
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the caller still holds (an earlier run's model and state)
        # is not this run's
        held = torch.cuda.memory_allocated()
    if ff is None:
        ff = build_train_lm(dtype, lm=lm, batch=batch,
                            flags=("--device", device, *flags))
    x, y = p19_data(lm, batch)
    ex, c = ff.executor, counters()
    losses, events, launches, steps = [], [], [], {}

    def watched(n, fn):
        def call(*args):
            before = {k: c[k].launches for k in MESH_KERNELS}
            ev = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  if on_card else None)
            if ev:
                ev[0].record()
            out = fn(*args)
            if ev:
                ev[1].record()
            events.append((n, ev))
            losses.append(out[-1].reshape(-1))
            launches.append({k: c[k].launches - before[k]
                             for k in MESH_KERNELS})
            return out
        return call

    if pipeline_steps == 1:
        steps[1] = ex._train_step or ex.build_train_step()
        ex._train_step = watched(1, steps[1])
    else:
        build = ex.build_chunked_train_step
        wrapped = {}

        def chunked(n):
            if n not in wrapped:
                steps[n] = build(n)
                wrapped[n] = watched(n, steps[n])
            return wrapped[n]

        ex.build_chunked_train_step = chunked
    saves, commits = [], []
    if any(f == "--checkpoint-dir" for f in flags) and ff._resilience is None:
        ff._resilience = ResilienceManager.from_config(ff)
    if ff._resilience is not None:
        mgr, ck = ff._resilience, ff._resilience.checkpointer
        mgr_save, ck_write = mgr.save, ck._write

        def save(step, cursor=None, blocking=False):
            t0 = time.perf_counter()
            mgr_save(step, cursor, blocking)
            saves.append({"step": step, "blocking": blocking,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "snapshot_ms": ck._snapshot_s * 1e3})

        def write(*args, **kw):
            before = ck.last_write
            ck_write(*args, **kw)
            if ck.last_write is not before:  # committed (not aborted)
                commits.append(dict(ck.last_write))

        mgr.save, ck._write = save, write
    ff.set_fault_hook(hook)
    reset_counters()
    killed = False
    t0 = time.perf_counter()
    try:
        ff.fit(x, y, epochs=P19_EPOCHS, batch_size=batch, shuffle=True,
               verbose=False, pipeline_steps=pipeline_steps)
    except SimulatedPreemption:
        killed = True
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ex.__dict__.pop("build_chunked_train_step", None)
    if ex._train_step is not None and 1 in steps:
        ex._train_step = steps[1]
    # a signature's first call warms up and its second captures: only
    # later calls are replays
    seen: dict = {}
    replay_ms = []
    for n, ev in events:
        seen[n] = seen.get(n, 0) + 1
        if ev and seen[n] > 2:
            replay_ms.append(ev[0].elapsed_time(ev[1]) / n)
    numbers = {
        "pipeline_steps": pipeline_steps, "killed": killed,
        "steps_run": sum(int(v.numel()) for v in losses),
        "py_step": ff._py_step(), "wall_s": wall_s,
        "losses": [float(v) for t in losses for v in t.tolist()],
        "replay_ms_per_step": replay_ms,
        "median_replay_ms_per_step": (statistics.median(replay_ms)
                                      if replay_ms else None),
        "captures": {n: getattr(s, "captures", 0) for n, s in steps.items()},
        "launches": {k: c[k].launches for k in MESH_KERNELS},
        "launches_per_call": {n: launches[i] for i, (n, _) in
                              enumerate(events)},
        "max_memory_allocated": (torch.cuda.max_memory_allocated() - held
                                 if on_card else None),
        "saves": saves, "commits": commits}
    return P19Run(ff, numbers, steps)


def chunk_check(device: str, lm, batch: int, dtype: str = "bf16"):
    """Phase 19(a): the per-step fit, then pipeline_steps 4 and 3 (the
    ragged tail), bit for bit: per-step losses and every state tensor.
    Each run launches 16 steps' kernels, each chunk replay n steps'
    worth; a signature captures once; the chunked peak memory at most
    P19_PEAK_RATIO of the per-step one's. Returns the numbers and the
    per-step run (its model, its steps) and its final state: the later
    parts compare with them."""
    plain = p19_fit(device, lm, batch, 1, dtype=dtype)
    want = state_of(plain.ff)
    step = step_launches(lm.num_layers, False)
    total = P19_EPOCHS * P19_BATCHES
    out = {"plain": plain.numbers}
    require(plain.numbers["steps_run"] == total,
            f"phase 19(a): the per-step fit ran {plain.numbers['steps_run']}"
            f" steps")
    on_card = plain.numbers["max_memory_allocated"] is not None
    for n in P19_CHUNKS:
        run = p19_fit(device, lm, batch, n, dtype=dtype)
        r = out[f"chunks of {n}"] = run.numbers
        diff = state_diff(state_of(run.ff), want)
        require(r["losses"] == plain.numbers["losses"],
                f"phase 19(a): chunks of {n}: losses {r['losses']} vs "
                f"per-step {plain.numbers['losses']}")
        require(not diff, f"phase 19(a): chunks of {n}: not bit-equal to "
                f"the per-step fit at {diff[:8]} (a kernel or library "
                f"call summing in a varying order breaks this)")
        if on_card:
            want_total = {k: total * step[k] for k in MESH_KERNELS}
            require(r["launches"] == want_total,
                    f"phase 19(a): chunks of {n}: launches "
                    f"{r['launches']}, want {want_total}")
            for m, per in r["launches_per_call"].items():
                require(per == {k: m * step[k] for k in MESH_KERNELS},
                        f"phase 19(a): a chunk of {m} launched {per}")
            require(all(v == 1 for v in r["captures"].values()),
                    f"phase 19(a): chunks of {n}: captures {r['captures']}")
            ratio = (r["max_memory_allocated"]
                     / plain.numbers["max_memory_allocated"])
            r["peak_vs_per_step"] = ratio
            require(ratio <= P19_PEAK_RATIO,
                    f"phase 19(a): chunks of {n}: peak memory "
                    f"{r['max_memory_allocated']} B, {ratio:.3f}x the "
                    f"per-step fit's")
        del run
        gc.collect()
    return out, plain, want


def resume_child(job: dict) -> dict:
    """Phase 19(b)'s fresh process: each resume of `job["resumes"]`
    compiles the LM with --checkpoint-dir DIR --auto-resume, fits to the
    end (its pipeline_steps) and compares every state tensor with the
    reference (`torch.save`d by the parent from its per-step run)."""
    import torch

    from flexflow_tpu_torch.models import TransformerLMConfig

    lm = TransformerLMConfig(**job["lm"])
    want = torch.load(job["reference"])
    results = []
    for r in job["resumes"]:
        t0 = time.perf_counter()
        run = p19_fit(job["device"], lm, job["batch"], r["pipeline_steps"],
                      flags=("--checkpoint-dir", r["dir"], "--auto-resume"),
                      dtype=job["dtype"])
        ff = run.ff
        diff = state_diff({k: v.cpu() for k, v in state_of(ff).items()},
                          want)
        results.append({
            "name": r["name"], "diff": diff[:8], "py_step": ff._py_step(),
            "steps_run": run.numbers["steps_run"],
            "restore_s": ff._resilience.last_restore_s,
            "captures": run.numbers["captures"],
            "wall_s": time.perf_counter() - t0})
        del ff, run
        gc.collect()
    return {"resumes": results}


def resume_check(device: str, lm, batch: int, plain, want: dict,
                 dtype: str = "bf16") -> dict:
    """Phase 19(b): killed runs, then resumed in a fresh process. Per
    step: a FaultInjector after step P19_KILL (checkpoints every
    P19_EVERY); chunks of 4, the fault inside a chunk; a SIGTERM sent to
    the process from step P19_SIGTERM's hook, drained at the next
    boundary with a final snapshot. The per-step killed model also
    resumes in this process: its captured step's captures do not move
    across the restore, and it ends equal to the per-step run. Then a
    fresh process (this script with `--resume-child`) resumes each
    directory to the end, every state tensor bit-equal to the per-step
    run's."""
    import signal
    import subprocess
    import tempfile

    import torch

    from flexflow_tpu_torch.resilience import (
        CheckpointPolicy, FaultInjector, latest_checkpoint, list_checkpoints)

    root = tempfile.mkdtemp(prefix="p19b_")
    flags = ("--checkpoint-every", str(P19_EVERY))
    out = {}

    def sigterm(step):
        if step == P19_SIGTERM:
            os.kill(os.getpid(), signal.SIGTERM)

    cases = (("per-step kill", 1, FaultInjector(P19_KILL)),
             ("chunks of 4, kill", 4, FaultInjector(P19_KILL)),
             ("per-step SIGTERM", 1, sigterm))
    dirs = {}
    for name, n, hook in cases:
        d = dirs[name] = os.path.join(root, name.replace(" ", "_"))
        run = p19_fit(device, lm, batch, n, ("--checkpoint-dir", d, *flags),
                      hook=hook, dtype=dtype)
        r = out[name] = run.numbers
        last = latest_checkpoint(d)
        require(last is not None, f"phase 19(b): {name}: no checkpoint")
        with open(os.path.join(last, "manifest.json")) as f:
            cursor = json.load(f)["extras"]["cursor"]
        r.update(checkpoints=[os.path.basename(p)
                              for p in list_checkpoints(d)],
                 cursor=cursor, bytes=checkpoint_bytes(last))
        if hook is sigterm:
            require(not r["killed"] and r["py_step"] == P19_SIGTERM + n
                    and last.endswith(f"{P19_SIGTERM + n:08d}")
                    and r["saves"] and r["saves"][-1]["blocking"],
                    f"phase 19(b): {name}: stopped at {r['py_step']}, "
                    f"latest {last}")
        else:
            require(r["killed"] and hook.fired,
                    f"phase 19(b): {name}: the fault did not fire")
            require(cursor["batch"] % n == 0,
                    f"phase 19(b): {name}: cursor {cursor} off a chunk edge")
        if name == "per-step kill":
            # in this process: restore in place and finish the run
            step = run.steps[1]
            before = getattr(step, "captures", 0)
            ff = run.ff
            ff.config.auto_resume, ff._auto_resumed = True, False
            # no more saves: the fresh process resumes this directory
            ff._resilience.policy = CheckpointPolicy()
            again = p19_fit(device, lm, batch, 1, ff=ff, dtype=dtype)
            diff = state_diff(state_of(ff), want)
            r["in_process"] = {
                "captures_before": before,
                "captures_after": getattr(step, "captures", 0),
                "restore_s": ff._resilience.last_restore_s,
                "steps_run": again.numbers["steps_run"], "diff": diff[:8]}
            require(not diff, f"phase 19(b): in-process resume not "
                    f"bit-equal at {diff[:8]}")
            require(r["in_process"]["captures_after"] == before,
                    f"phase 19(b): captures moved across the restore: "
                    f"{r['in_process']}")
            del again
        del run
        gc.collect()
    ref_path = os.path.join(root, "reference.pt")
    torch.save({k: v.cpu() for k, v in want.items()}, ref_path)
    job = {"device": device, "lm": dataclasses.asdict(lm), "batch": batch,
           "dtype": dtype, "reference": ref_path,
           "resumes": [{"name": name, "dir": dirs[name], "pipeline_steps": n}
                       for name, n, _ in cases]}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--resume-child", json.dumps(job)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    require(proc.returncode == 0, f"phase 19(b): the fresh process "
            f"failed ({proc.returncode}): {proc.stderr[-3000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    fresh["process_s"] = time.perf_counter() - t0
    out["fresh_process"] = fresh
    total = P19_EPOCHS * P19_BATCHES
    for r in fresh["resumes"]:
        require(not r["diff"] and r["py_step"] == total,
                f"phase 19(b): {r['name']}: the fresh process ended at "
                f"step {r['py_step']}, not bit-equal at {r['diff']}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return out


def torn_check(device: str, plain, lm, batch: int) -> dict:
    """Phase 19(c): right after a replay, an async save (its copy queued
    behind the replay, an event marking its end), then two more replays
    at once, which write the masters in place while the writer thread
    serializes; the committed masters equal a host copy taken
    synchronously after the first replay, bit for bit, and the later
    replays did change them."""
    import tempfile

    import torch

    from flexflow_tpu_torch.resilience import (
        AsyncCheckpointer, latest_checkpoint, load_checkpoint)
    from flexflow_tpu_torch.resilience.reshard import logical_state_tree

    ff = plain.ff
    step = plain.steps[1]
    x, y = p19_data(lm, batch)
    staged = ff._make_batch({k: v[:batch] for k, v in x.items()}, y[:batch])

    def replay():
        (ff._params, ff._state, ff._opt_slots, ff._step, ff._counters,
         _) = step(ff._params, ff._state, ff._opt_slots, ff._step,
                   ff._counters, staged, ff._rng)

    replay()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    host = {f"['params'][{n!r}][{k!r}]": t.detach().cpu().clone()
            for n, ws in ff._params.items() for k, t in ws.items()}
    root = tempfile.mkdtemp(prefix="p19c_")
    ck = AsyncCheckpointer(root)
    t0 = time.perf_counter()
    ck.save(ff._py_step(), logical_state_tree(ff),
            extras={"rng_kind": "torch"})
    issue_ms = (time.perf_counter() - t0) * 1e3
    replay()
    replay()  # queued while the writer serializes
    ck.wait()
    flat, _ = load_checkpoint(latest_checkpoint(root))
    torn = [k for k, v in host.items() if not torch.equal(
        v, torch.as_tensor(np.asarray(flat[k])))]
    moved = sum(not torch.equal(ff._params[n][k].cpu(),
                                host[f"['params'][{n!r}][{k!r}]"])
                for n, ws in ff._params.items() for k in ws)
    require(not torn, f"phase 19(c): the snapshot is torn at {torn[:8]}")
    require(moved > 0, "phase 19(c): the later replays changed no master")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return {"masters": len(host), "torn": torn, "masters_moved": moved,
            "issue_ms": issue_ms, "write": ck.last_write}


class count_evals:
    """Counts the Unity search's evaluations and joint searches in this
    process (rank 0's)."""

    def __enter__(self):
        import flexflow_tpu_torch.search.joint as joint
        import flexflow_tpu_torch.search.unity as unity

        self.evals = self.searches = 0
        self._undo = [(unity.UnitySearch, "evaluate",
                       unity.UnitySearch.evaluate),
                      (joint, "joint_graph_optimize",
                       joint.joint_graph_optimize)]
        ev, opt = self._undo[0][2], self._undo[1][2]

        def evaluate(us, *a, **kw):
            self.evals += 1
            return ev(us, *a, **kw)

        def search(*a, **kw):
            self.searches += 1
            return opt(*a, **kw)

        unity.UnitySearch.evaluate = evaluate
        joint.joint_graph_optimize = search
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)
        return False


def warm_rank(rank: int, root: str, device: str, lm_kw: dict) -> dict:
    """Phase 19(d) on one of two gloo ranks: lm-base compiled three times
    under the search (WARM_FLAGS): cold and warm against one
    --warmstart-dir (each then fits one step, eager: gloo is not
    captured; the warm one checkpoints it), then with --auto-resume on
    that checkpoint directory. Per compile: the wall time, the plan's
    source, rank 0's search evaluations, and time to the first step from
    the telemetry summary."""
    import torch

    from flexflow_tpu_torch.executor import eager
    from flexflow_tpu_torch.models import TransformerLMConfig
    from flexflow_tpu_torch.telemetry import deactivate, read_jsonl

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    sys.argv = sys.argv[:1]  # FFConfig reads the command line
    lm = TransformerLMConfig(**lm_kw)
    ws, ck = os.path.join(root, "ws"), os.path.join(root, "ck")
    x, y = train_batch(lm.vocab_size, TRAIN_BATCH, lm.sequence_length)
    out = {}
    for tag, extra in (("cold", ("--warmstart-dir", ws)),
                       ("warm", ("--warmstart-dir", ws, "--checkpoint-dir",
                                 ck, "--checkpoint-every", "1")),
                       ("resume", ("--warmstart-dir", ws, "--checkpoint-dir",
                                   ck, "--auto-resume"))):
        tdir = os.path.join(root, f"tel_{tag}_{rank}")
        t0 = time.perf_counter()
        with count_evals() as spy:
            ff = build_train_lm("bf16", lm=lm, flags=(
                "--device", device, "--telemetry-dir", tdir, *WARM_FLAGS,
                *extra))
        compile_s = time.perf_counter() - t0
        with eager():
            ff.fit(x, y, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
                   verbose=False)
        deactivate()
        recs = read_jsonl(os.path.join(tdir, "metrics.jsonl"))
        summary = next((r for r in reversed(recs)
                        if r["kind"] == "summary"), {})
        out[tag] = {"plan_source": ff._plan_source, "evals": spy.evals,
                    "searches": spy.searches, "compile_s": compile_s,
                    "time_to_first_step_s": summary.get(
                        "time_to_first_step_s"),
                    "fingerprint": ff._plan_fingerprint,
                    "py_step": ff._py_step()}
        del ff
        gc.collect()
    return out


def warm_check(device: str, lm) -> dict:
    """Phase 19(d): `warm_rank` on two gloo ranks; rank 0's second
    compile comes from the plan cache with 0 search evaluations, the
    third from the checkpoint's plan record."""
    import tempfile

    from flexflow_tpu_torch.distributed import spawn

    root = tempfile.mkdtemp(prefix="p19d_")
    t0 = time.perf_counter()
    ranks = spawn(warm_rank, 2, root, device, dataclasses.asdict(lm),
                  timeout=900)
    r0 = ranks[0]
    require(r0["cold"]["plan_source"] == "search"
            and r0["cold"]["evals"] > 0,
            f"phase 19(d): the cold compile: {r0['cold']}")
    require(r0["warm"]["plan_source"] == "cache"
            and r0["warm"]["evals"] == 0 and r0["warm"]["searches"] == 0,
            f"phase 19(d): the warm compile: {r0['warm']}")
    require(r0["resume"]["plan_source"] == "checkpoint"
            and r0["resume"]["evals"] == 0,
            f"phase 19(d): the --auto-resume compile: {r0['resume']}")
    require(all(r["warm"]["plan_source"] == "broadcast" for r in ranks[1:]),
            f"phase 19(d): rank 1: {ranks[1]['warm']}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return {"ranks": ranks, "wall_s": time.perf_counter() - t0}


def phase19(device: str, lm, batch: int, warm_lm,
            dtype: str = "bf16") -> dict:
    """Phase 19 (a)-(d) of `lm` on `device` (the card: lm-base at full
    width in bf16; the CPU test: a tiny LM), `warm_lm` for (d)."""
    t0 = time.perf_counter()
    chunks, plain, want = chunk_check(device, lm, batch, dtype)
    resume = resume_check(device, lm, batch, plain, want, dtype)
    torn = torn_check(device, plain, lm, batch)
    del plain, want
    gc.collect()
    # two gloo ranks share the card, each naming it (phase 16's way)
    warm = warm_check("cuda:0" if device.startswith("cuda") else device,
                      warm_lm)
    return {"chunks": chunks, "resume": resume, "torn": torn, "warm": warm,
            "wall_s": time.perf_counter() - t0}


# ------------------------------------------------------------ phase 20

# 20(a) and 20(d): the drift threshold. The H100 model's calibrated price
# of lm-base's one-card step reads ~0.685x the card's (phase 17), an
# error EMA of ~0.46 that the JAX default of 0.5 leaves no margin above
P20_DRIFT = "0.75"
# 20(b): the planted fault's device step: the third step of a per-step
# fit (a replay), and inside the third chunk of 4 (a chunk graph's replay)
P20_FAULT = {1: 2, 4: 10}
P20_STEPS = {1: 4, 4: 12}
# 20(c): the attributed share of the sampled step's device time
P20_ATTRIBUTED = 0.90
P20_LAYERS_PROFILING = 1  # 20(g): lm-base at 1 layer, every op timed


def p20_data(lm, steps: int):
    """Phase 6's batch, `steps` times."""
    x, y = train_batch(lm.vocab_size)
    return ({k: np.concatenate([v] * steps) for k, v in x.items()},
            np.concatenate([y] * steps))


def p20_masters(ff) -> dict:
    return {f"{n}.{k}": t.detach().clone()
            for n, ws in ff._params.items() for k, t in ws.items()}


def p20_differ(a: dict, b: dict) -> list:
    import torch

    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def p20_fit(ff, steps: int, pipeline_steps: int = 1, timed=None):
    """`steps` steps of phase 6's batch through fit (bf16, captured);
    `timed`, a list, gets each per-step call's device ms (CUDA events)."""
    import torch

    if timed is not None:
        step = ff.executor._train_step or ff.executor.build_train_step()

        def watched(*args):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(*args)
            ev[1].record()
            timed.append(ev)
            return out

        ff.executor._train_step = watched
    x, y = p20_data(lm_config(), steps)
    try:
        ff.fit(x, y, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
               verbose=False, pipeline_steps=pipeline_steps)
    finally:
        torch.cuda.synchronize()
        if timed is not None:
            ff.executor._train_step = step


def p20_reset(ff):
    """Fresh training state from the seed, no fault (the steps are
    dropped: the next fit captures anew)."""
    import torch

    ex = ff.executor
    ex.set_numeric_fault(None)
    ff._params, ff._state = ex.init_variables(ff.config.seed)
    ff._opt_slots = ff.optimizer.init(ff._params)
    ff._step = torch.zeros((), dtype=torch.int32, device=ff.device)
    ff._counters = ff.metrics.zero_counters(ff.device)
    ff._rng = torch.Generator(ff.device).manual_seed(ff.config.seed)


def p20_free():
    import torch

    from flexflow_tpu_torch import telemetry

    telemetry.deactivate()
    gc.collect()
    torch.cuda.empty_cache()


def diag_phase(base: dict, root: str) -> dict:
    """20(a): lm-base, bf16, captured, 3 warm-up and 10 timed steps with
    --telemetry-dir, --diagnostics, health every step, --calibrate 4 (the
    report prices the adopted plan with the card's measurements) and
    --drift-threshold P20_DRIFT. Fatal: no alert or advisory, the doctor's
    verdict "healthy"; the report names the card and its per-op costs
    reproduce its total; the recorded median step within 15% of phase
    6's; then 12 more steps under --health-sample-every 4: the rules see
    one record of 4 steps, the loss fetched on 1 step of 4."""
    from flexflow_tpu_torch.diagnostics import verify_report_total
    from flexflow_tpu_torch.diagnostics.doctor import diagnose
    from flexflow_tpu_torch.search.machine_model import card_line
    from flexflow_tpu_torch.telemetry import read_jsonl

    from flexflow_tpu_torch.kernels import counters, reset_counters

    tdir = os.path.join(root, "a")
    steps = WARMUP_STEPS + TIMED_STEPS
    t0 = time.perf_counter()
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--calibrate", "4",
        "--drift-threshold", P20_DRIFT))
    compile_s = time.perf_counter() - t0
    # the watched fit's launches, counted from 0 just before it: K1, K4
    # and K5-K7 a step, as phase 6's
    reset_counters()
    p20_fit(ff, steps)
    want = {k: n * steps for k, n in
            step_launches(lm_config().num_layers, False).items()}
    launches = {k: counters()[k].launches for k in want}
    require(launches == want,
            f"20(a): the watched fit launched {launches}, want {want}")
    masters = p20_masters(ff)
    diag = ff.get_diagnostics()
    natural_ema = diag.drift.error_ema
    alerts = read_jsonl(os.path.join(tdir, "alerts.jsonl"))
    require(alerts == [], f"20(a): a clean run's alerts {alerts}")
    d = diagnose(tdir)
    require(d["verdict"] == "healthy", f"20(a): verdict {d['verdict']}")
    rep = json.load(open(os.path.join(tdir, "strategy_report.json")))
    card = card_line()
    require(rep.get("card") == card,
            f"20(a): the report names {rep.get('card')!r}, not {card!r}")
    total = verify_report_total(rep)
    require(abs(total / rep["total_predicted_s"] - 1) <= 1e-9,
            f"20(a): report total {rep['total_predicted_s']} != "
            f"{total} from its ops")
    recs = [r for r in read_jsonl(os.path.join(tdir, "metrics.jsonl"))
            if r["kind"] == "step"]
    median_s = statistics.median(r["step_time_s"]
                                 for r in recs[WARMUP_STEPS:steps])
    rel = median_s / (base["median_step_ms"] / 1e3)
    require(abs(rel - 1) <= TELEMETRY_RTOL,
            f"20(a): median step {1e3 * median_s:.3f} ms vs phase 6's "
            f"{base['median_step_ms']:.3f}")

    class Spy:
        name = "spy"

        def __init__(self):
            self.records = []

        def check(self, rec):
            self.records.append((rec["step"], rec["loss"]))

    spy = Spy()
    diag.health.rules.append(spy)
    ff.config.health_sample_every = 4
    # the loss fetches (host reads of a device scalar) fit's health path
    # makes: one a sampled step
    fetched = [0]

    import torch

    real_float = torch.Tensor.__float__

    def counted_float(t):
        if sys._getframe(1).f_code.co_name == "_health_step":
            fetched[0] += 1
        return real_float(t)

    with mock.patch.object(torch.Tensor, "__float__", counted_float):
        p20_fit(ff, 12)
    sampled = [s for s in range(steps + 1, steps + 13) if s % 4 == 0]
    require([s for s, _ in spy.records] == sampled
            and all(loss is not None for _, loss in spy.records)
            and fetched[0] == len(sampled),
            f"20(a): --health-sample-every 4 gave records {spy.records} "
            f"and {fetched[0]} loss fetches over 12 steps")
    out = {"compile_s": compile_s, "verdict": d["verdict"],
           "launches": launches,
           "mode": rep["mode"], "card": rep.get("card"),
           "predicted_ms": 1e3 * rep["total_predicted_s"],
           "recorded_median_step_ms": 1e3 * median_s,
           "vs_phase6": rel, "natural_drift_ema": natural_ema,
           "sample_every_4": {"records": len(spy.records),
                              "loss_fetches": fetched[0], "steps": 12}}
    del ff, diag
    p20_free()
    return out, masters


def sanitize_phase(root: str) -> dict:
    """20(b): lm-base, bf16, captured, 6 steps with the sanitizer off and
    on: the masters bit-equal (the probes are identities), the median
    replay with probes on against off. Then on the sanitized model, a NaN
    planted in the first LINEAR, MULTIHEAD_ATTENTION and LAYERNORM node
    and in the loss, forward and backward, per step (at step 2, a
    replay) and in chunks of 4 (at step 10, inside the third chunk's
    replay): the device table names (op, phase, step) each time. Then
    --telemetry-dir --diagnostics --health-abort-on nan_loss in chunks of
    4, the LINEAR's forward poisoned at step 10: HealthAbort, the
    nan_loss alert names the op, phase and step, flight.json says
    HealthAbort, and the prefetch thread has stopped."""
    import threading

    import torch

    from flexflow_tpu_torch import sanitize
    from flexflow_tpu_torch.diagnostics import HealthAbort
    from flexflow_tpu_torch.telemetry import read_jsonl

    out = {"replay_ms": {}}
    masters = {}
    for on in (False, True):
        ff = build_train_lm("bf16", flags=(
            ("--sanitize-numerics",) if on else ()))
        timed = []
        p20_fit(ff, 6, timed=timed)
        masters[on] = p20_masters(ff)
        key = "on" if on else "off"
        out["replay_ms"][key] = statistics.median(
            a.elapsed_time(b) for a, b in timed[2:])
        # one more replay profiled: what the probes' kernels take
        prof, _ = profiled(lambda: p20_fit(ff, 1))
        out.setdefault("kernels", {})[key] = {
            "device_ms": prof["device_busy_ms"],
            "launches": prof["device_kernels"], "top": prof["top"][:6]}
        if not on:
            del ff
            p20_free()
    differ = p20_differ(masters[False], masters[True])
    require(not differ, f"20(b): masters with the sanitizer on differ at "
                        f"{differ[:4]}")
    out["probe_overhead"] = out["replay_ms"]["on"] / out["replay_ms"]["off"]
    del masters
    op_types = {"LINEAR": "OP_LINEAR", "MULTIHEAD_ATTENTION":
                "OP_MULTIHEAD_ATTENTION", "LAYERNORM": "OP_LAYERNORM"}
    targets = {c: next(n.name for n in ff.graph.topo_order()
                       if n.op_type.name == t) for c, t in op_types.items()}
    targets["loss"] = "loss"
    matrix = {}
    for cls, target in targets.items():
        for phase in ("fwd", "bwd"):
            for n in (1, 4):
                p20_reset(ff)
                ff.executor.set_numeric_fault(target, phase, P20_FAULT[n])
                sanitize.get_monitor().reset()
                p20_fit(ff, P20_STEPS[n], pipeline_steps=n)
                info = sanitize.get_monitor().first_nonfinite()
                got = (info or {}).get("op"), (info or {}).get(
                    "phase"), (info or {}).get("step")
                matrix[f"{cls} {phase} chunks of {n}"] = got
                require(got == (target, phase, P20_FAULT[n]),
                        f"20(b): {cls} {phase} chunks of {n}: localized "
                        f"{got}, planted ({target}, {phase}, "
                        f"{P20_FAULT[n]})")
                steps = ff.executor._chunk_steps if n > 1 else {
                    1: ff.executor._train_step}
                captures = [getattr(s, "captures", None)
                            for s in steps.values()]
                require(captures == [1],
                        f"20(b): {cls} {phase} chunks of {n}: captures "
                        f"{captures}")
    out["matrix"] = matrix
    del ff
    p20_free()
    tdir = os.path.join(root, "b")
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--sanitize-numerics",
        "--health-abort-on", "nan_loss"))
    ff.executor.set_numeric_fault(targets["LINEAR"], "fwd", P20_FAULT[4])
    raised = None
    try:
        p20_fit(ff, P20_STEPS[4], pipeline_steps=4)
    except HealthAbort as e:
        raised = e.alert.to_record()
    p20_free()
    require(raised is not None, "20(b): no HealthAbort")
    nan = [a for a in read_jsonl(os.path.join(tdir, "alerts.jsonl"))
           if a.get("rule") == "nan_loss"]
    want = {"op": targets["LINEAR"], "phase": "fwd",
            "at_step": P20_FAULT[4]}
    require(len(nan) == 1 and nan[0].get("details") == want,
            f"20(b): nan_loss alerts {nan}, want details {want}")
    flight = json.load(open(os.path.join(tdir, "flight.json")))
    require(flight["reason"] == "HealthAbort",
            f"20(b): flight.json reason {flight['reason']}")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("ff-prefetch") and t.is_alive()]
    require(not alive, f"20(b): prefetch threads alive: {alive}")
    out["abort"] = {"alert": raised, "stopped_at": ff._py_step(),
                    "flight_events": len(flight["events"])}
    del ff
    p20_free()
    return out


def scope_phase(root: str, masters: dict) -> dict:
    """20(c): phase 20(a)'s run (13 steps) with --profile-every 4: steps
    4, 8 and 12 run eagerly under torch.profiler; the report's profile
    section (the last) satisfies the attribution identity within its
    slop, P20_ATTRIBUTED of its device time or more is attributed to the
    ops and runtime scopes; the five ops with the most measured time
    against their predicted_s; the masters bit-equal to 20(a)'s."""
    from flexflow_tpu_torch.scope.attribution import verify_profile_section

    tdir = os.path.join(root, "c")
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--calibrate", "4",
        "--drift-threshold", P20_DRIFT, "--profile-every", "4"))
    t0 = time.perf_counter()
    p20_fit(ff, WARMUP_STEPS + TIMED_STEPS)
    fit_s = time.perf_counter() - t0
    differ = p20_differ(masters, p20_masters(ff))
    require(not differ, f"20(c): masters with --profile-every differ from "
                        f"20(a)'s at {differ[:4]}")
    rep = json.load(open(os.path.join(tdir, "strategy_report.json")))
    prof = rep.get("profile") or {}
    problems = verify_profile_section(prof) if prof else ["no section"]
    require(prof.get("step") == 12 and prof.get("mode") == "eager_sampled"
            and not problems, f"20(c): profile section {problems} "
                              f"(step {prof.get('step')})")
    attributed = prof["attributed_s"]
    share = attributed / (attributed + prof["unattributed_s"])
    loss_s = prof["extras"].get("loss", 0.0)
    top = sorted(prof["ops"], key=lambda r: -r["measured_s"])[:5]
    out = {"fit_s": fit_s, "step": prof["step"],
           "device_time_ms": 1e3 * prof["device_time_s"],
           "attributed_ms": 1e3 * attributed,
           "unattributed_ms": 1e3 * prof["unattributed_s"],
           "attributed_share": share,
           "share_without_the_loss_scope": (attributed - loss_s) / (
               attributed + prof["unattributed_s"]),
           "parallelism": prof["parallelism"],
           "extras_ms": {k: 1e3 * v for k, v in prof["extras"].items()},
           "top5": [{"op": r["name"], "measured_ms": 1e3 * r["measured_s"],
                     "fwd_ms": 1e3 * r["fwd_s"], "bwd_ms": 1e3 * r["bwd_s"],
                     "predicted_ms": 1e3 * r.get("predicted_s", 0.0)}
                    for r in top],
           "train_step_captures": getattr(ff.executor._train_step,
                                          "captures", None),
           "unattributed_top": ff._scope_prof.last_attr[
               "unattributed_top"]}
    log(f"  20(c) unattributed: {out['unattributed_top']}")
    require(share >= P20_ATTRIBUTED,
            f"20(c): {100 * share:.1f}% of the sampled step's device time "
            f"attributed (< {100 * P20_ATTRIBUTED:.0f}%)")
    require(out["train_step_captures"] == 1,
            f"20(c): {out['train_step_captures']} captures")
    del ff
    p20_free()
    return out


def drift_phase(root: str, masters: dict, base: dict) -> dict:
    """20(d): phase 20(a)'s run with the drift monitor's prediction
    planted at half phase 6's measured step and its recalibration armed:
    exactly one advisory, one recalibration on the card (the 4 dominant
    ops timed again), one more capture of the train step, no advisory
    after it; the masters bit-equal to 20(a)'s."""
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = os.path.join(root, "d")
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--calibrate", "4",
        "--drift-threshold", P20_DRIFT))
    diag = ff.enable_diagnostics(recalibrate=True)
    planted = base["median_step_ms"] / 2e3
    diag.drift.set_prediction(planted)
    us = ff._replay_search[0]
    calls, real = [], us.cm.calibrate_graph

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    us.cm.calibrate_graph = counted
    first = ff.executor.build_train_step()
    p20_fit(ff, WARMUP_STEPS + TIMED_STEPS)
    second = ff.executor._train_step
    advisories = [a for a in read_jsonl(os.path.join(tdir, "alerts.jsonl"))
                  if a.get("rule") == "costmodel_drift"]
    differ = p20_differ(masters, p20_masters(ff))
    out = {"planted_ms": 1e3 * planted, "advisories": len(advisories),
           "advisory_step": [a["step"] for a in advisories],
           "recalibrations": len(calls),
           "recalibrated_ms": 1e3 * diag.drift.predicted_s,
           "error_ema_after": diag.drift.error_ema,
           "captures": [getattr(first, "captures", None),
                        None if second is first
                        else getattr(second, "captures", None)]}
    require(len(advisories) == 1 and calls == [
        {"top_k": 4, "remeasure": True}] and out["captures"] == [1, 1],
        f"20(d): {out}")
    require(not differ, f"20(d): masters after the recalibration differ "
                        f"from 20(a)'s at {differ[:4]}")
    del ff, diag, us
    p20_free()
    return out


def watchdog_phase(root: str) -> dict:
    """20(e): lm-base, 6 steps with --telemetry-dir and --watchdog-timeout
    1, a 3 s stall from the fault hook after step 3: the watchdog fires
    once, flight.json says why, and its heartbeats name this rank. The
    deadline is max(timeout, multiplier x the inter-beat EMA), and the
    EMA holds the interval of the step that captured the graph (0.15 to
    over 0.37 s on an H100's host): at the default multiplier of 10 it
    passed 3 s on a slow host and the stall went unseen, so this run
    takes --watchdog-multiplier 1 and its deadline is the timeout."""
    from flexflow_tpu_torch.telemetry import read_jsonl

    tdir = os.path.join(root, "e")
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--watchdog-timeout",
        "1", "--watchdog-multiplier", "1"))
    ff.set_fault_hook(lambda s: time.sleep(3.0) if s == 3 else None)
    p20_fit(ff, 6)
    flight = json.load(open(os.path.join(tdir, "flight.json")))
    wd = flight.get("watchdog") or {}
    hang = [a for a in read_jsonl(os.path.join(tdir, "alerts.jsonl"))
            if a.get("rule") == "hang_watchdog"]
    out = {"fired": len(hang), "reason": flight["reason"],
           "stalled_s": wd.get("stalled_s"), "deadline_s":
           wd.get("deadline_s"), "last_step": wd.get("last_step"),
           "lagging_host": wd.get("lagging_host"),
           "heartbeats": wd.get("hosts")}
    require(len(hang) == 1 and flight["reason"] == "watchdog"
            and wd.get("lagging_host") == 0 and wd.get("last_step") == 3
            and os.path.exists(os.path.join(tdir, "heartbeats",
                                            "host-0.json")),
            f"20(e): {out}")
    del ff
    p20_free()
    return out


def profiling_phase() -> dict:
    """20(g): --profiling's per-op table of lm-base at 1 layer, timed on
    the card by the cost model's harness: headed by the card's line, a
    row for every compute op, each with a forward time."""
    import io

    from flexflow_tpu_torch.profiling import (print_operator_profile,
                                              profile_operators_json)
    from flexflow_tpu_torch.search.cost_model import OpHarness
    from flexflow_tpu_torch.search.machine_model import card_line

    ff = build_train_lm("bf16", lm=lm_config(layers=P20_LAYERS_PROFILING))
    buf = io.StringIO()
    t0 = time.perf_counter()
    rows = print_operator_profile(ff.graph, file=buf, harness=OpHarness.of(
        ff.config, ff.device))
    took = time.perf_counter() - t0
    text = buf.getvalue()
    compute = [n.name for n in ff.graph.topo_order()
               if n.inputs and n.op_type.name != "OP_INPUT"]
    require(text.startswith(f"per-operator profile on {card_line()}")
            and [r[0] for r in rows] == compute
            and all(r[2] > 0 for r in rows),
            f"20(g): table {text[:200]!r}, rows {[r[0] for r in rows]} "
            f"vs ops {compute}")
    out = {"s": took, "ops": len(rows),
           "top": profile_operators_json(ff.graph, rows=rows)[:5]}
    del ff
    p20_free()
    return out


def phase20(train: dict, paged: dict, ff_serve_flags=()) -> dict:
    """Phase 20: the observability half of the port on lm-base at full
    width (12 layers, 8 x 512, bf16 over f32 masters, SGD, captured):
    20(a) diagnostics, (b) the sanitizer, (c) sampled op profiles, (d)
    drift and its recalibration, (e) the hang watchdog, (f) serving's
    telemetry on phase 3's paged run, (g) --profiling. Each check fatal."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_p20_")
    t0 = time.perf_counter()
    try:
        out, took = {}, {}

        def run(key, fn, *args):
            t = time.perf_counter()
            r = fn(*args)
            took[key] = time.perf_counter() - t
            return r

        out["a"], masters = run("a", diag_phase, train, root)
        out["b"] = run("b", sanitize_phase, root)
        out["c"] = run("c", scope_phase, root, masters)
        out["d"] = run("d", drift_phase, root, masters, train)
        del masters
        p20_free()
        out["e"] = run("e", watchdog_phase, root)
        out["f"] = run("f", serving_telemetry_phase, root, paged)
        out["g"] = run("g", profiling_phase)
        out["took_s"] = took
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        p20_free()


def serving_profile_step(ff, prompt: list[int]) -> dict:
    """The serving engine's own profile_step of one request's first
    iteration (eager), on an engine that has served it once, its
    attribution identity fatal."""
    from flexflow_tpu_torch.scope.attribution import verify_profile_section

    eng = ff.serve(kv_layout="paged", max_new_tokens=NEW_TOKENS)
    eng.generate([prompt])  # warm: the profiled step is not a first one
    eng.submit(prompt)
    section = eng.profile_step()
    eng.run_until_drained()
    problems = verify_profile_section(section)
    require(section["source"] == "serving" and not problems,
            f"serving profile_step: {problems}")
    attributed = section["attributed_s"]
    return {"device_time_ms": 1e3 * section["device_time_s"],
            "attributed_ms": 1e3 * attributed,
            "attributed_share": attributed / max(
                1e-12, attributed + section["unattributed_s"]),
            "ops_measured": sum(r["measured_s"] > 0 for r in section["ops"])}


def serving_telemetry_phase(root: str, paged: dict) -> dict:
    """20(f): phase 3's paged run (captured) with --telemetry-dir: the
    same token streams as phase 3; metrics_summary's p50/p95/p99 of TTFT,
    TBT, queue wait and end to end. The step's cost: phase 3's run is
    repeated here without telemetry, on a model built the same way, in
    the order without, with, with, without, twice, after one untimed
    run of each, no step profiled, and the median pure-decode step of
    the runs with telemetry must lie within 15% of that of the runs
    without. The step is host-bound and
    its host time moves 5-20% between phases of one call (phase 3's own
    median is printed beside it), so the runs it is held to are timed
    in the same minute. Then the engine's profile_step (one iteration,
    eagerly) satisfies the attribution identity."""
    ff_on = build_lm(flags=("--telemetry-dir", os.path.join(root, "f")))
    ff_off = build_lm()
    vocab = ff_on.layers[-1].params.out_channels
    prompts = make_prompts(vocab)
    arms = {"off": [], "on": []}
    # a first run of each model is not timed: every timed run comes
    # after its model has served once
    for i, arm in enumerate(("on", "off") + ("off", "on", "on", "off") * 2):
        r = (serve_phase(ff_on, "paged", prompts, vocab, telemetry=True)
             if arm == "on" else
             serve_phase(ff_off, "paged", prompts, vocab, profile=False))
        require(r["streams"] == paged["streams"],
                f"20(f): the streams of a run {arm} telemetry differ "
                f"from phase 3's")
        if i >= 2:
            arms[arm].append(r)
        gc.collect()  # each run starts with the last one's engine gone
    summ = arms["on"][0]["metrics_summary"]
    med = {arm: statistics.median(
        [t for r in runs for t in r["decode_step_ms"]])
        for arm, runs in arms.items()}
    rel = med["on"] / med["off"]
    # the same over the steps that completed no request (with telemetry
    # a completion also writes and flushes a serve.done record)
    quiet = {arm: statistics.median(
        [t for r in runs for t, d in zip(r["decode_step_ms"],
                                         r["decode_step_completions"])
         if not d])
        for arm, runs in arms.items()}
    lat = {f"{s}_{q}_s": summ.get(f"{s}_{q}_s")
           for s in ("ttft", "tbt", "queue_wait", "e2e")
           for q in ("p50", "p95", "p99")}
    out = {"median_decode_step_ms": med["on"],
           "median_decode_step_ms_off": med["off"],
           "runs_ms": {arm: [r["median_decode_step_ms"] for r in runs]
                       for arm, runs in arms.items()},
           "vs_off": rel,
           "quiet_steps_vs_off": quiet["on"] / quiet["off"],
           "vs_phase3": med["on"] / paged["median_decode_step_ms"],
           "off_vs_phase3": med["off"] / paged["median_decode_step_ms"],
           "latency_s": lat,
           "requests_completed": summ["requests_completed"]}
    require(all(v is not None and v >= 0 for v in lat.values()),
            f"20(f): metrics_summary percentiles {lat}")
    require(abs(rel - 1) <= TELEMETRY_RTOL,
            f"20(f): median pure-decode step {med['on']:.3f} ms with "
            f"telemetry vs {med['off']:.3f} without (runs {out['runs_ms']})")
    out["profile_step"] = serving_profile_step(ff_on, prompts[0])
    del ff_on, ff_off
    p20_free()
    return out


def log_phase20(p: dict):
    a, b, c, d, e, f, g = (p[k] for k in "abcdefg")
    log(f"  (a) diagnostics: verdict {a['verdict']}, report {a['mode']} "
        f"naming {a['card']!r}, predicted {a['predicted_ms']:.3f} ms; "
        f"recorded median step {a['recorded_median_step_ms']:.3f} ms "
        f"({a['vs_phase6']:.4f} of phase 6's); natural drift EMA "
        f"{a['natural_drift_ema']:.4f}; --health-sample-every 4: "
        f"{a['sample_every_4']}")
    log(f"  (b) sanitizer: median replay off {b['replay_ms']['off']:.3f} "
        f"ms, on {b['replay_ms']['on']:.3f} ms ({b['probe_overhead']:.4f}"
        f"x); masters bit-equal; a profiled replay's kernels "
        f"{b['kernels']}; localized {b['matrix']}; abort {b['abort']}")
    log(f"  (c) scope: step {c['step']} device window "
        f"{c['device_time_ms']:.3f} ms, attributed {c['attributed_ms']:.3f}"
        f" ms ({100 * c['attributed_share']:.2f}%), unattributed "
        f"{c['unattributed_ms']:.3f}; extras {c['extras_ms']}; top five "
        f"{c['top5']}")
    log(f"  (d) drift: {d}")
    log(f"  (e) watchdog: {e}")
    log(f"  (f) serving: median pure-decode step "
        f"{f['median_decode_step_ms']:.3f} ms with telemetry, "
        f"{f['median_decode_step_ms_off']:.3f} without ({f['vs_off']:.4f}"
        f"x, {f['quiet_steps_vs_off']:.4f}x over steps that complete "
        f"no request; runs off, on, on, off, twice {f['runs_ms']}); "
        f"phase 3's x "
        f"{f['vs_phase3']:.4f} / {f['off_vs_phase3']:.4f}; latency "
        f"{f['latency_s']}; profile_step {f['profile_step']}")
    log(f"  (g) --profiling: {g['ops']} ops in {g['s']:.1f} s; top "
        f"{g['top']}")
    log(f"  phase 20's parts took {p['took_s']} s")


# ------------------------------------------------------------- phase 21

# phase 21(c): the deepest stack of lm-xxl-fsdp the bisection may admit,
# and how many depths past the gate's line it steps up under
# --no-verify-plan looking for the card's
P21_MAX_LAYERS = 64
P21_STEP_UP = 4
# phase 21(d): the mesh the generated registry is verified on (the JAX
# package's CI mesh)
P21_RULE_MESH = {"data": 2, "model": 4, "dcn": 1, "seq": 1}


class _GateOnly(Exception):
    """Raised in place of the compile's step after its gate: admitted."""


def gate_only(lm, batch: int, flags: tuple = ()):
    """`lm` compiled for training as `build_train_lm` compiles it, stopped
    right after the compile gate (`analysis.verify_plan`), before
    `init_variables` allocates a weight: (admitted, the gate's
    AnalysisResult). Nothing reaches the card either way."""
    import flexflow_tpu_torch.analysis as A

    seen = {}
    real = A.verify_plan

    def gate(model, cost_model=None):
        try:
            seen["result"] = real(model, cost_model=cost_model)
        except A.PlanVerificationError as e:
            seen["result"] = e.result
            raise
        raise _GateOnly

    with mock.patch.object(A, "verify_plan", gate):
        try:
            build_train_lm("bf16", lm=lm, batch=batch, flags=flags)
        except _GateOnly:
            return True, seen["result"]
        except A.PlanVerificationError:
            return False, seen["result"]
    raise RuntimeError("the compile never reached its gate")


def memory_terms(result) -> dict:
    """The memory pass's per-chip terms, by name: JAX's (persistent:
    masters, gradients, slots; activations retained for the backward;
    the liveness peak), the port's own buffers, their sum (the peak the
    gate holds to the cap) and the cost model's figure."""
    d = result.by_code("memory_timeline")[0].details
    out = {k: d.get(k) for k in (
        "persistent_bytes", "activation_bytes", "gather_peak_bytes",
        "peak_bytes", "peak_at", "cost_model_bytes", "hbm_cap_bytes",
        "port_peak_bytes")}
    out.update(d["port_terms"])
    return out


def analysis_record(result) -> dict:
    """What a phase keeps of a compile gate's result."""
    return {"summary": result.summary(), "elapsed_s": result.elapsed_s,
            "errors": [str(f) for f in result.errors()],
            "memory": memory_terms(result)}


def device_draws():
    """Phase 21(c)'s memory probes draw every weight on the card from one
    generator seeded from SEED: the same tensors, shapes and dtypes as
    the initializers' (which draw on the CPU and move, ~30 s for a
    20-layer stack of lm-xxl-fsdp), so the same bytes are held."""
    import contextlib

    import torch

    from flexflow_tpu_torch import initializer

    gen = torch.Generator("cuda").manual_seed(SEED)

    def uniform(_gen, shape, dtype, device, lo, hi):
        return torch.empty(tuple(shape), dtype=dtype, device=device
                           ).uniform_(lo, hi, generator=gen)

    def normal(self, _gen, shape, dtype, device):
        return torch.empty(tuple(shape), dtype=dtype, device=device
                           ).normal_(self.mean, self.stddev, generator=gen)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(initializer, "_uniform", uniform))
    stack.enter_context(mock.patch.object(initializer.NormInitializer,
                                          "__call__", normal))
    return stack


def gate_child(job: dict) -> dict:
    """Phase 21(c)'s fresh process (the parent's allocations out of the
    way): lm-xxl-fsdp at full width, 4 x 2048, bf16, SGD(lr=0.01) as
    phase 10 runs it. Bisect the depth on the gate alone (`gate_only`):
    `d_ok` the deepest stack it admits. `d_ok` compiles and trains one
    step; `d_ok + 1` compiles to a PlanVerificationError naming
    oom_predicted with `torch.cuda.memory_allocated()` unchanged. Then,
    under --no-verify-plan, at most P21_STEP_UP more depths compile and
    train a step each: `d_ok + 1` gives the measured bytes a layer, which
    place the card's line (the free memory at the start over that rate);
    the depths beside it find the deepest stack that trains and the first
    that raises OutOfMemoryError."""
    import torch

    from flexflow_tpu_torch.analysis import PlanVerificationError

    torch.cuda.init()
    free0, total = torch.cuda.mem_get_info()
    base = lm_config(XXL)
    batch = XXL_BATCH
    x, y = train_batch(base.vocab_size, batch, base.sequence_length)
    gates = {}

    def admits(d: int) -> bool:
        ok, res = gate_only(dataclasses.replace(base, num_layers=d), batch)
        gates[d] = {"admitted": ok, "elapsed_s": res.elapsed_s,
                    "errors": sorted({f.code for f in res.errors()}),
                    "memory": memory_terms(res)}
        return ok

    t0 = time.perf_counter()
    lo, hi = XXL_LAYERS, base.num_layers
    require(admits(lo), f"phase 21(c): the gate refuses {lo} layers, "
            f"which phase 10 trains")
    while admits(hi):
        require(hi < P21_MAX_LAYERS, f"phase 21(c): the gate admits "
                f"{hi} layers")
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if admits(mid):
            lo = mid
        else:
            hi = mid
    d_ok = lo
    bisect_s = time.perf_counter() - t0

    def one_step(d: int, flags=()):
        """Compile `d` layers (the gate per `flags`) and fit one step:
        (peak bytes allocated, None) or (None, the OOM's text)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ff = None
        try:
            with device_draws():
                ff = build_train_lm("bf16", lm=dataclasses.replace(
                    base, num_layers=d), batch=batch, flags=flags)
            ff.fit(x, y, epochs=1, batch_size=batch, shuffle=False,
                   verbose=False)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated(), None
        except torch.cuda.OutOfMemoryError as e:
            return None, str(e).splitlines()[0][:200]
        finally:
            del ff
            gc.collect()
            torch.cuda.empty_cache()

    t1 = time.perf_counter()
    peak_ok, oom_ok = one_step(d_ok)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    refused = None
    try:
        build_train_lm("bf16", lm=dataclasses.replace(
            base, num_layers=d_ok + 1), batch=batch)
    except PlanVerificationError as e:
        refused = sorted({f.code for f in e.result.errors()})
    gc.collect()
    after = torch.cuda.memory_allocated()
    runs = {}

    def run(d: int):
        peak, oom = one_step(d, ("--no-verify-plan",))
        runs[d] = {"layers": d, "peak": peak, "oom": oom}
        return oom is None

    per_layer = None
    if peak_ok is not None and run(d_ok + 1):
        per_layer = runs[d_ok + 1]["peak"] - peak_ok
        d = max(d_ok + 2, d_ok + 1 + int(
            (free0 - runs[d_ok + 1]["peak"]) // max(per_layer, 1)))
        # walk from the extrapolated line to where a stack that trains
        # and one that runs out of memory sit side by side
        while len(runs) < P21_STEP_UP:
            if run(d):
                if d + 1 in runs:
                    break
                d += 1
            else:
                if d - 1 in runs:
                    break
                d -= 1
    fits = [d_ok] + [k for k, r in runs.items() if r["oom"] is None]
    card_ok = max(fits)
    card_oom = min((k for k, r in runs.items()
                    if r["oom"] and k > card_ok), default=None)
    peaks = {k: r["peak"] for k, r in runs.items() if r["peak"]}
    return {"free_at_start": free0, "total": total, "gates": gates,
            "d_ok": d_ok, "bisect_s": bisect_s,
            "d_ok_peak": peak_ok, "d_ok_oom": oom_ok,
            "refused_codes": refused, "allocated_before": before,
            "allocated_after": after,
            "step_up": [runs[k] for k in sorted(runs)],
            "measured_bytes_per_layer": per_layer,
            "card_ok_layers": card_ok, "card_oom_layers": card_oom,
            "margin_layers": card_ok - d_ok,
            "margin_bytes": (peaks.get(card_ok, peak_ok) - peak_ok
                             if peak_ok is not None else None),
            "steps_s": time.perf_counter() - t1}


def rule_verdicts(result) -> dict:
    """{rule: sorted (severity, code)} of an ffrules result."""
    out: dict = {}
    for f in result.findings:
        out.setdefault(f.where, []).append((f.severity, f.code))
    return {k: sorted(v) for k, v in out.items()}


def phase21(train: dict, train_x: dict, first_verify_s: float) -> dict:
    """Phase 21, the static analysis on the card: (a) lm-base at full
    width compiled through the gate (no error; the report's `analysis`),
    a second verify of it timed; (b) the memory pass's predicted peak
    term by term beside phases 6's and 10's measured peaks; (c) where the
    pass draws the line for lm-xxl-fsdp and where the card does
    (`gate_child`, a fresh process); (d) the generated registry's ffrules
    oracle on `cuda` (f32, TF32 off) against the same port's on the CPU,
    rule by rule."""
    import subprocess

    import torch

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.analysis import verify_plan
    from flexflow_tpu_torch.analysis.rules import verify_registry
    from flexflow_tpu_torch.diagnostics.explain import build_strategy_report
    from flexflow_tpu_torch.kernels import counters, reset_counters

    t0 = time.perf_counter()
    out = {}
    # (a)
    gc.collect()
    torch.cuda.empty_cache()
    ff = build_train_lm("bf16")
    res = ff._analysis
    require(res is not None and res.ok, f"phase 21(a): lm-base's gate: "
            f"{res.render() if res is not None else 'did not run'}")
    again = verify_plan(ff)
    report = build_strategy_report(ff)
    require("analysis" in report and report["analysis"]["errors"] == 0,
            "phase 21(a): the report carries no clean analysis section")
    out["a"] = {"summary": res.summary(),
                "by_code": sorted({f.code for f in res.findings}),
                "first_verify_s": first_verify_s,
                "compile_verify_s": res.elapsed_s,
                "second_verify_s": again.elapsed_s,
                "memory": memory_terms(res)}
    del ff, again, report
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    out["b"] = {name: dict(run["analysis"]["memory"],
                           measured=run["max_memory_allocated"],
                           predicted_over_measured=(
                               run["analysis"]["memory"]["port_peak_bytes"]
                               / run["max_memory_allocated"]))
                for name, run in (("lm-base", train), (XXL, train_x))}
    # (c)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--gate-child", "{}"],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    require(proc.returncode == 0, f"phase 21(c): the child failed "
            f"({proc.returncode}): {proc.stderr[-3000:]}")
    c = json.loads(proc.stdout.strip().splitlines()[-1])
    require(c["d_ok_oom"] is None, f"phase 21(c): the pass admits "
            f"{c['d_ok']} layers, which ran out of memory on the card: "
            f"{c['d_ok_oom']} (the pass under-counts)")
    require(c["refused_codes"] is not None
            and "oom_predicted" in c["refused_codes"],
            f"phase 21(c): {c['d_ok'] + 1} layers: {c['refused_codes']}")
    require(c["allocated_after"] == c["allocated_before"],
            f"phase 21(c): the refused compile allocated "
            f"{c['allocated_after'] - c['allocated_before']} bytes")
    out["c"] = c
    # (d)
    cfg = FFConfig(device="cuda")
    cfg.parse_args(["-b", "8"])
    c_before = {k: v.launches for k, v in counters().items()}
    reset_counters()
    t_d = time.perf_counter()
    on_card = verify_registry(P21_RULE_MESH, cfg, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t_d
    moved = {k: v.launches for k, v in counters().items() if v.launches}
    t_d = time.perf_counter()
    on_cpu = verify_registry(P21_RULE_MESH, cfg, device="cpu")
    cpu_s = time.perf_counter() - t_d
    vc, vh = rule_verdicts(on_card), rule_verdicts(on_cpu)
    differ = sorted(k for k in set(vc) | set(vh) if vc.get(k) != vh.get(k))
    require(not differ, f"phase 21(d): verdicts on cuda and the CPU "
            f"differ at {[(k, vc.get(k), vh.get(k)) for k in differ[:4]]}")
    clean = on_card.by_code("rules_clean")
    out["d"] = {"rules": clean[0].details["rules"] if clean else None,
                "summary": on_card.summary(), "card_s": card_s,
                "cpu_s": cpu_s, "launches": moved,
                "launches_before": {k: n for k, n in c_before.items()
                                    if n}}
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_phase21(p: dict):
    a, b, c, d = p["a"], p["b"], p["c"], p["d"]
    s = a["summary"]
    log(f"  (a) lm-base: {s['errors']} errors, {s['warnings']} warnings, "
        f"{s['info']} info over {s['passes_run']}; codes {a['by_code']}; "
        f"verify {a['compile_verify_s']:.4f} s in the compile, "
        f"{a['second_verify_s']:.4f} s again, the process's first "
        f"{a['first_verify_s']:.4f} s")

    def gb(v):
        return "-" if v is None else f"{v / 1e9:.3f}"

    for name, m in b.items():
        log(f"  (b) {name}: predicted port peak {gb(m['port_peak_bytes'])} "
            f"GB = liveness peak {gb(m['peak_bytes'])} (at {m['peak_at']}; "
            f"persistent {gb(m['persistent_bytes'])}, activations "
            f"{gb(m['activation_bytes'])}) + bf16 weight copies "
            f"{gb(m['bf16_weight_copies'])} + serving cache "
            f"{gb(m['serving_weight_cache'])} + graph inputs "
            f"{gb(m['graph_static_inputs'])}; cost model "
            f"{gb(m['cost_model_bytes'])}; measured max_memory_allocated "
            f"{gb(m['measured'])} GB ({m['predicted_over_measured']:.3f}x)")
    log(f"  (c) {XXL}, 4 x 2048: the gate admits {c['d_ok']} layers "
        f"(bisected in {c['bisect_s']:.1f} s over {sorted(c['gates'])}); "
        f"{c['d_ok']} layers trained a step at {gb(c['d_ok_peak'])} GB; "
        f"{c['d_ok'] + 1} refused with {c['refused_codes']}, allocated "
        f"{c['allocated_before']} -> {c['allocated_after']} B; "
        f"--no-verify-plan: "
        + ", ".join(f"{s['layers']} layers " + (
            "OOM" if s["oom"] else f"{gb(s['peak'])} GB")
            for s in c["step_up"])
        + f"; measured {gb(c['measured_bytes_per_layer'])} GB a layer; "
        f"the card trains {c['card_ok_layers']} layers, runs out at "
        f"{c['card_oom_layers']}: margin {c['margin_layers']} layers, "
        f"{gb(c['margin_bytes'])} GB; card free at start "
        f"{gb(c['free_at_start'])} of {gb(c['total'])} GB "
        f"({c['steps_s']:.1f} s of steps)")
    for dd in (c["d_ok"], c["d_ok"] + 1):
        g = c["gates"].get(str(dd), c["gates"].get(dd))
        if g:
            log(f"      gate at {dd} layers: port peak "
                f"{gb(g['memory']['port_peak_bytes'])} GB, cost model "
                f"{gb(g['memory']['cost_model_bytes'])}, cap "
                f"{gb(g['memory']['hbm_cap_bytes'])}: {g['errors']}")
    log(f"  (d) ffrules oracle over {d['rules']} rules on cuda in "
        f"{d['card_s']:.2f} s (CPU {d['cpu_s']:.2f} s), verdicts equal; "
        f"launches {d['launches']}")
    log(f"  phase 21 took {p['wall_s']:.1f} s")


# ------------------------------------------------------------ phase 22

P22_HORIZON = "1000"  # --replan-horizon-steps of 22(a)
# --replan-cooldown-steps of 22(a) and (c): the monitor's first advisory
# can come at step 8 (steps 1-2 warm up and capture, 5 timed samples of
# warm-up), which this admits; a second one needs 5 timed steps of the
# re-planned step, more than the run has left
P22_COOLDOWN = "6"


def p22_counts(run) -> list:
    """The kernel launches a replay of each graph of a captured step
    adds, by graph."""
    return [{k: d[0] for k, d in g.counts.items()}
            for g in run._graphs.values() if g is not None]


def elastic_drift_phase(root: str, base: dict) -> dict:
    """22(a): lm-base through fit with --elastic and phase 20(d)'s
    planted prediction (half phase 6's step): exactly one re-plan
    decision, drift-triggered, carrying both payoff sides and the plan's
    origin; if it migrated, the new executor's train step captured once
    (one more capture), else the same step object; the masters after the
    run bit-equal to the same run without --elastic (the plan re-searched
    on one card is the running one); K1, K4 and K5-K7 a replay of the
    step before and after the re-plan the same counts, each launched."""
    from flexflow_tpu_torch.kernels import counters, reset_counters

    steps = WARMUP_STEPS + TIMED_STEPS
    ctl = build_train_lm("bf16")
    p20_fit(ctl, steps)
    want = p20_masters(ctl)
    del ctl
    p20_free()
    tdir = os.path.join(root, "a")
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", tdir, "--diagnostics", "--calibrate", "4",
        "--drift-threshold", P20_DRIFT, "--elastic",
        "--replan-cooldown-steps", P22_COOLDOWN, "--replan-horizon-steps",
        P22_HORIZON))
    ff.get_diagnostics().drift.set_prediction(base["median_step_ms"] / 2e3)
    first, old_ex = ff.executor.build_train_step(), ff.executor
    # a replay's launches of each train step the run used, read at each
    # step edge (a migration releases the old step's graphs)
    replays = {}

    def hook(step):
        run = ff.executor._train_step
        replays.setdefault(id(run), []).append(p22_counts(run))
    ff.set_fault_hook(hook)
    reset_counters()
    p20_fit(ff, steps)
    ff.set_fault_hook(None)
    launches = {k: v.launches for k, v in counters().items() if v.launches}
    decs = ff._elastic_decisions
    require(len(decs) == 1, f"22(a): {len(decs)} decisions: {decs}")
    d = decs[0]
    require(d["trigger"] == "drift" and "lhs_s" in d and "rhs_s" in d
            and "plan_origin" in d, f"22(a): decision {d}")
    second = ff.executor._train_step
    migrated = d["decision"] == "migrated"
    if migrated:
        require(ff.executor is not old_ex and second is not first
                and (first.captures, second.captures) == (1, 1),
                f"22(a): migrated, captures {first.captures} / "
                f"{second.captures}")
    else:
        require(ff.executor is old_ex and second is first
                and first.captures == 1, f"22(a): {d['decision']} but the "
                f"step changed or captured {first.captures} times")
    differ = p20_differ(want, p20_masters(ff))
    require(not differ, f"22(a): masters differ from the run without "
                        f"--elastic at {differ[:4]}")
    per_replay = [replays[id(first)][-1], replays[id(second)][-1]]
    require(all(len(c) == 1 for c in per_replay)
            and per_replay[0] == per_replay[1],
            f"22(a): a replay's launches before / after: {per_replay}")
    need = step_launches(lm_config().num_layers, fused=False)
    got = {k: per_replay[1][0].get(k, 0) for k in need}
    require(all(launches.get(k, 0) > 0 for k, n in need.items() if n)
            and got == need,
            f"22(a): launches {launches}, a replay {got} (want {need})")
    out = {"decision": {k: d.get(k) for k in (
               "step", "trigger", "decision", "lhs_s", "rhs_s",
               "predicted_migration_s", "fidelity_ratio",
               "benefit_s_per_step", "horizon_steps", "plan_origin",
               "research_s", "migration_measured_s", "migration_wall_s",
               "measured_ema_s", "old_predicted_step_s",
               "new_predicted_step_s", "total_s")},
           "captures": [first.captures, second.captures],
           "launches": launches, "per_replay": per_replay[1][0]}
    del ff, first, second, old_ex
    p20_free()
    return out


def migrate_phase(root: str) -> dict:
    """22(b): `migrate_state` between two compiled lm-base models (the
    source after 2 steps), without and with donation: fftrans's
    predicted seconds beside the measured, the peak
    max_memory_allocated during each, the masters landed bit-equal. The
    warm-start DB holds a fidelity entry under the card's device kind
    exactly where the move was priced (a move on one card is local
    slices, priced 0 s, as the JAX package prices it: its measured /
    predicted ratio has no value, so none is recorded; the torchrun
    elastic leg's stage-2 shrink is priced and records one)."""
    import torch

    from flexflow_tpu_torch.elastic.payoff import _fidelity_key
    from flexflow_tpu_torch.resilience import migrate_state
    from flexflow_tpu_torch.warmstart.calibration_db import (
        CalibrationDB, device_key, serialize_key)

    wdir = os.path.join(root, "warm")
    src = build_train_lm("bf16")
    p20_fit(src, 2)
    want = p20_masters(src)
    out = {}
    for donate in (False, True):
        dst = build_train_lm("bf16", flags=("--warmstart-dir", wdir))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sec = migrate_state(src, dst, donate=donate)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        differ = p20_differ(want, p20_masters(dst))
        require(not differ and sec["analysis"]["errors"] == 0,
                f"22(b) donate={donate}: {sec['analysis']} differ "
                f"{differ[:4]}")
        out["donate" if donate else "copy"] = {
            "predicted_s": sec["predicted_s"],
            "measured_s": sec["measured_s"], "wall_s": wall,
            "transfers": len(sec["transfers"]),
            "allocated_before": before, "peak": peak,
            "peak_over_before": peak - before,
            "allocated_after": torch.cuda.memory_allocated()}
        del dst
    require(src._compiled is False, "22(b): the donated source still "
                                    "counts as compiled")
    db = CalibrationDB(wdir, torch.device("cuda"))
    entry = (db._read().get("devices", {}).get(device_key(db.device), {})
             .get(serialize_key(_fidelity_key())))
    priced = [out[k]["predicted_s"] > 0 for k in ("copy", "donate")]
    require(entry == (None if not any(priced)
                      else [entry[0], float(sum(priced))]),
            f"22(b): priced {priced}, fidelity entry in the warm-start "
            f"DB {entry}")
    out["fidelity_entry"] = {"device": device_key(db.device),
                             "priced": priced, "entry": entry}
    del src
    p20_free()
    return out


def elastic_dry_run_phase(root: str, base: dict) -> dict:
    """22(c): --elastic --elastic-dry-run with the planted prediction:
    the decision recorded as a dry run, the executor object and its
    captured step unchanged."""
    ff = build_train_lm("bf16", flags=(
        "--telemetry-dir", os.path.join(root, "c"), "--diagnostics",
        "--drift-threshold", P20_DRIFT, "--elastic", "--elastic-dry-run",
        "--replan-cooldown-steps", P22_COOLDOWN))
    ff.get_diagnostics().drift.set_prediction(base["median_step_ms"] / 2e3)
    first, ex = ff.executor.build_train_step(), ff.executor
    p20_fit(ff, 9)
    decs = ff._elastic_decisions
    require(len(decs) == 1 and decs[0]["decision"] == "dry_run"
            and ff.executor is ex and ex._train_step is first
            and first.captures == 1,
            f"22(c): {decs}, executor kept {ff.executor is ex}, captures "
            f"{first.captures}")
    out = {k: decs[0].get(k) for k in ("step", "would_migrate", "lhs_s",
                                        "rhs_s", "total_s")}
    del ff, first, ex
    p20_free()
    return out


def elastic_serve_phase(prompts: list, want: list) -> dict:
    """22(d): phase 3's paged lm-base serving (8 slots, 16 prompts):
    `replan_mesh((1, 1, 1, 1))` after 8 steps with requests in flight;
    every token stream equal to phase 3's undisturbed run, K3 launching
    from the rebuilt step's graphs; the re-plan's wall time split into
    the decode compile, the migration, the rebuild and the recapture (the
    steps after it that warmed up or captured a width); a re-plan to a
    decode mesh of 2 devices refused naming A11."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters

    ff = build_lm()
    eng = ff.serve(kv_layout="paged", max_new_tokens=NEW_TOKENS)
    reqs = [eng.submit(p) for p in prompts]
    c = counters()
    reset_counters()
    for _ in range(8):
        eng.step()
    flight = sum(not r.finished for r in reqs)
    k3 = c["paged_flash_decode_attention"].launches
    old = eng._step_fn.captured
    dec = eng.replan_mesh((1, 1, 1, 1))
    run = eng._step_fn.captured
    recapture_s, steps = 0.0, 0
    while not all(r.finished for r in reqs):
        t0 = time.perf_counter()
        eng.step()
        steps += 1
        if run.last_call in ("warm-up", "capture"):
            recapture_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in c.items() if v.launches}
    streams = [list(r.generated) for r in reqs]
    require(flight > 0 and dec["decision"] == "migrated",
            f"22(d): {flight} in flight, {dec}")
    require(streams == want, "22(d): token streams after the re-plan "
                             "differ from phase 3's")
    require(run is not old and run.captures > 0
            and launches.get("paged_flash_decode_attention", 0) > k3
            and launches.get("layer_norm_fwd", 0) > 0,
            f"22(d): rebuilt step captures {run.captures}, K3 {k3} -> "
            f"{launches}")
    refused = None
    try:
        eng.replan_mesh((2, 1, 1, 1))
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "only 1 available" in refused
            and eng.replan_decisions[-1]["decision"] == "failed",
            f"22(d): a decode mesh of 2 devices past the one-rank world: "
            f"{refused}")
    out = {"in_flight": flight, "steps_after": steps,
           "captures_after": run.captures, "launches": launches,
           "refused": refused,
           "split_s": {"compile": dec["compile_s"],
                       "migration": dec["migrate_s"],
                       "rebuild": dec["rebuild_s"],
                       "recapture": recapture_s},
           "total_s": dec["total_s"],
           "migration": {k: dec.get(k) for k in (
               "predicted_migration_s", "migration_measured_s")}}
    del eng, ff, run, old
    p20_free()
    return out


def phase22(train: dict, prompts: list, paged_streams: list) -> dict:
    """Phase 22: elastic re-planning and in-process migration on lm-base
    at full width: (a) a drift re-plan through fit --elastic, (b)
    migrate_state directly, (c) --elastic-dry-run, (d) the serving
    engine's decode re-plan mid-decode. Each check fatal."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_p22_")
    t0 = time.perf_counter()
    try:
        out, took = {}, {}
        for key, fn, args in (("a", elastic_drift_phase, (root, train)),
                              ("b", migrate_phase, (root,)),
                              ("c", elastic_dry_run_phase, (root, train)),
                              ("d", elastic_serve_phase,
                               (prompts, paged_streams))):
            t = time.perf_counter()
            out[key] = fn(*args)
            took[key] = time.perf_counter() - t
        out["took_s"] = took
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        p20_free()


def log_phase22(p: dict):
    a, b, c, d = p["a"], p["b"], p["c"], p["d"]
    ad = a["decision"]
    log(f"  (a) one {ad['trigger']} decision at step {ad['step']}: "
        f"{ad['decision']} (lhs {ad['lhs_s']:.6g} s = predicted migration "
        f"{ad['predicted_migration_s']:.6g} s x fidelity "
        f"{ad['fidelity_ratio']:.4g}; rhs {ad['rhs_s']:.6g} s = benefit "
        f"{ad['benefit_s_per_step']:.6g} s/step x {ad['horizon_steps']}), "
        f"plan origin {ad['plan_origin']}, re-search {ad['research_s']:.3f} "
        f"s, migration {ad['migration_measured_s']} s measured, total "
        f"{ad['total_s']:.3f} s; captures {a['captures']}; a replay's "
        f"launches before = after {a['per_replay']}; masters bit-equal to "
        f"the run without --elastic")
    for k in ("copy", "donate"):
        m = b[k]
        log(f"  (b) migrate_state ({k}): {m['transfers']} transfers, "
            f"predicted {m['predicted_s']:.6g} s, measured "
            f"{m['measured_s']:.6g} s (wall {m['wall_s']:.4f} s); "
            f"allocated {m['allocated_before']} B before, peak "
            f"{m['peak']} B (+{m['peak_over_before']}), after "
            f"{m['allocated_after']} B")
    log(f"  (b) fidelity in the warm-start DB: {b['fidelity_entry']}")
    log(f"  (c) dry run at step {c['step']}: would migrate "
        f"{c['would_migrate']} (lhs {c['lhs_s']:.6g} s, rhs "
        f"{c['rhs_s']:.6g} s), executor and step kept")
    s = d["split_s"]
    log(f"  (d) replan_mesh((1,1,1,1)) with {d['in_flight']} requests in "
        f"flight: {d['total_s']:.3f} s = compile {s['compile']:.3f} + "
        f"migration {s['migration']:.3f} + rebuild {s['rebuild']:.4f}, "
        f"then recapture {s['recapture']:.3f} s over the next steps; "
        f"migration {d['migration']}; streams equal to phase 3's; K3 from "
        f"the rebuilt graphs ({d['captures_after']} captures, launches "
        f"{d['launches']}); 2 devices refused past the one-rank world: "
        f"{d['refused'][:80]}")
    log(f"  phase 22 took {p['wall_s']:.1f} s ({p['took_s']})")


# ------------------------------------------------------------ phase 23

SPEC_K = 4


@contextlib.contextmanager
def float32(*models):
    """The models' serving compiles in float32 (no bf16 compute, no
    tensor-op math) inside the block."""
    saved = [(m.config.computation_dtype,
              m.config.allow_tensor_op_math_conversion) for m in models]
    for m in models:
        m.config.computation_dtype = None
        m.config.allow_tensor_op_math_conversion = False
    try:
        yield
    finally:
        for m, (cd, tm) in zip(models, saved):
            m.config.computation_dtype = cd
            m.config.allow_tensor_op_math_conversion = tm


def force_speculation(eng):
    """Every eligible round speculates at the cap (the JAX package's test
    harness `_force_speculation`) once the gate's first round has run
    plain decode to measure it (`calibrate_decode`): the all-accept
    extreme needs sustained speculation whatever the payoff gate would
    decide, and the target's own q = 1 decode runs K3 in that round."""
    honest = eng._decide

    def always(k_cap):
        if eng._decode_cost_s is None:
            return honest(k_cap)
        d = {"k": min(eng.k_max, k_cap), "reason": "bootstrap",
             "chosen": "speculate" if k_cap >= 1 else "decode",
             "would_speculate": k_cap >= 1,
             "acceptance_ema": float(eng.acceptance_ema),
             "acceptance_samples": int(eng.acceptance_samples)}
        eng._decision_counts[d["chosen"]] += 1
        eng.decisions.append(d)
        return d

    eng._decide = always


def first_divergence(got: list, want: list) -> dict | None:
    """The first request whose stream differs, and where."""
    for i, (x, y) in enumerate(zip(got, want)):
        if x != y:
            t = next(j for j, (u, w) in enumerate(zip(x, y)) if u != w)
            return {"request": i, "step": t, "got": x[t], "want": y[t]}
    return None


def spec_run(ff, draft, prompts, force: bool, f32: bool) -> dict:
    """One speculative serve of `prompts` (paged, 8 slots, k_max 4),
    its launch counts set to 0 just before generate and read just after,
    the drafter's counted apart (each drafter call's delta); the verify,
    draft and target decode calls' times by width, the calls that warmed
    up or captured a graph left out."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters

    ctx = float32(ff, draft) if f32 else contextlib.nullcontext()
    with ctx:
        eng = ff.serve(kv_layout="paged", max_new_tokens=NEW_TOKENS,
                       speculate=True, draft_model=draft, spec_k=SPEC_K)
    if force:
        force_speculation(eng)
    c = counters()
    drafter = eng.drafter.engine
    times = {"verify": {}, "draft": {}, "decode": {}}
    drafted: dict = {}

    def timed(fn, kind, run_of):
        def call(*a):
            t0 = time.perf_counter()
            before = ({k: v.launches for k, v in c.items()}
                      if kind == "draft" else None)
            out = fn(*a)
            dt = (time.perf_counter() - t0) * 1e3
            run = run_of()
            q = int(np.asarray(a[0]).shape[1])
            if run is None or run.last_call == "replay":
                times[kind].setdefault(q, []).append(dt)
            if before is not None:
                for k, v in c.items():
                    drafted[k] = drafted.get(k, 0) + v.launches - before[k]
            return out
        return call

    drafter._device_step = timed(drafter._device_step, "draft",
                                 lambda: drafter._step_fn.captured)
    eng._device_step = timed(eng._device_step, "decode",
                             lambda: eng._step_fn.captured)
    run_verify = eng._run_verify
    eng._run_verify = timed(run_verify, "verify",
                            lambda: eng._verify_fn.captured)
    reset_counters()
    t0 = time.perf_counter()
    streams = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in c.items() if v.launches}
    plain = {k: v.plain_calls for k, v in c.items() if v.plain_calls}
    st = eng.stats()
    sp = st["speculation"]
    require(not plain, f"23: plain versions ran: {plain}")
    target = {k: n - drafted.get(k, 0) for k, n in launches.items()}
    out = {
        "streams": streams, "wall_s": wall,
        "decode_tokens_per_s": st["decode_tokens"] / wall,
        "launches": launches,
        "drafter_launches": {k: n for k, n in drafted.items() if n},
        "target_launches": {k: n for k, n in target.items() if n},
        "verify_graphs": getattr(eng._verify_fn.captured, "captures", 0),
        "verify_widths": sorted(times["verify"]),
        "ms": {kind: {str(q): statistics.median(v)
                      for q, v in sorted(by.items())}
               for kind, by in times.items()},
        "rounds": sp["rounds"], "draft_tokens": sp["draft_tokens"],
        "accepted_tokens": sp["accepted_tokens"],
        "emitted_tokens": sp["emitted_tokens"],
        "accepted_per_round": sp["accepted_tokens"] / max(1, sp["rounds"]),
        "acceptance_ema": sp["acceptance_ema"],
        "decision_counts": sp["decision_counts"],
        "payoff": [d for d in eng.decisions if d["reason"] == "payoff"][:6],
        "pair_key": eng.pair_key,
    }
    eng.release_drafter()
    eng._release_graphs()
    del eng, drafter
    torch.cuda.empty_cache()
    return out


def inject_phase(ff, prompts, want) -> dict:
    """23(c), float32: every prompt prefilled by one engine (one token
    each), its prompt-extent blocks lifted by the pre-release hook as
    device tensors (`extract_kv`), then admitted into a second engine
    (`admit_prefilled`, FCFS as slots free) that decodes the rest: every
    stream equal to the plain float32 engine's (phase 4). The injects
    timed on the card."""
    import torch

    from flexflow_tpu_torch.serving.scheduler import Request

    with float32(ff):
        pre = ff.serve(kv_layout="paged", max_new_tokens=1)
        dec = ff.serve(kv_layout="paged", max_new_tokens=NEW_TOKENS)
    stash = {}

    def hook(slot, req):
        stash[req.request_id] = pre.extract_kv(slot.index, len(req.prompt))

    pre._pre_release_hook = hook
    first = [pre.submit(p) for p in prompts]
    pre.run_until_drained()
    inject_ms, blocks = [], []
    rows = dec._inject_rows

    def timed_inject(b, k, v):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows(b, k, v)
        torch.cuda.synchronize()
        # a bucket's first two calls warm up and capture its graph
        inject_ms.append(((time.perf_counter() - t0) * 1e3,
                          getattr(dec._inject_fn.captured, "last_call",
                                  "replay")))

    dec._inject_rows = timed_inject
    reqs = []
    for r in first:
        req = Request(prompt=list(r.prompt), max_new_tokens=NEW_TOKENS)
        req.generated.append(r.generated[0])
        reqs.append(req)
    queue = list(zip(reqs, first))
    while queue or not dec.scheduler.drained:
        while queue:
            req, done = queue[0]
            k, v = stash[done.request_id]
            got = dec.admit_prefilled(req, req.generated[-1], k, v)
            if got is None:
                break
            blocks.append(got)
            queue.pop(0)
        dec.step()
    streams = [r.generated for r in reqs]
    require(streams == want, "23(c): the injected float32 streams differ "
                             "from plain decode's: "
            f"{first_divergence(streams, want)}")
    name = dec.kv_pool_layers()[0]
    pool = dec.decode_model._state[name]["pool_k"]
    replays = [ms for ms, call in inject_ms if call == "replay"]
    out = {"requests": len(reqs), "blocks_injected": blocks,
           "inject_ms": [ms for ms, _ in inject_ms],
           "inject_calls": [call for _, call in inject_ms],
           "median_inject_replay_ms": (statistics.median(replays)
                                       if replays else None),
           "inject_graphs": getattr(dec._inject_fn.captured, "captures",
                                    0),
           "kv_bytes_per_layer": dec.kv_bytes_per_layer(),
           "pool_bytes_per_layer": 2 * pool.numel() * pool.element_size()}
    require(out["kv_bytes_per_layer"] == out["pool_bytes_per_layer"],
            f"23(c): kv_bytes_per_layer {out['kv_bytes_per_layer']} vs the "
            f"pools' {out['pool_bytes_per_layer']} B")
    del pre, dec
    torch.cuda.empty_cache()
    return out


def phase23(prompts: list, plain: dict, f32_plain: list,
            f32_rate: float) -> dict:
    """Phase 23: the serving extras on lm-base at full width (8 slots,
    phase 3's 16 prompts, paged): (a) speculation with a seed-clone
    drafter (lm-base, the target's weights) forced at k_max 4, float32
    streams equal to plain decode's (fatal), bf16 streams counted; (b)
    lm-base-draft (its own random weights) under the honest payoff gate,
    float32 streams equal to plain (fatal), every decision recorded; (c)
    the KV inject path between two engines, float32. Each check
    fatal."""
    import torch

    t0 = time.perf_counter()
    ff = build_lm()
    clone = build_lm()  # the same seed and names: the same weights
    out = {"a": {}}
    out["a"]["f32"] = a32 = spec_run(ff, clone, prompts, force=True,
                                     f32=True)
    require(a32["streams"] == f32_plain,
            f"23(a) float32: speculative streams differ from plain decode: "
            f"{first_divergence(a32['streams'], f32_plain)}")
    require(a32["accepted_tokens"] == a32["draft_tokens"] > 0,
            f"23(a): a seed clone rejected a proposal: {a32}")
    out["a"]["bf16"] = a16 = spec_run(ff, clone, prompts, force=True,
                                      f32=False)
    a16["equal_streams"] = sum(x == y for x, y in
                               zip(a16["streams"], plain["streams"]))
    div = first_divergence(a16["streams"], plain["streams"])
    if div is not None:
        i, t = div["request"], div["step"]
        top = top2_at(ff, "paged", list(prompts[i])
                      + plain["streams"][i][:t], f32=False)
        div["plain_top2"] = top
        div["plain_margin"] = top[0][0] - top[1][0]
    a16["first_divergence"] = div
    a32["plain_decode_tokens_per_s"] = f32_rate
    a16["plain_decode_tokens_per_s"] = plain["decode_tokens_per_s"]
    for r in (a32, a16):
        require(r["drafter_launches"].get("paged_flash_decode_attention",
                                          0) > 0
                and r["target_launches"].get(
                    "paged_flash_decode_attention", 0) > 0
                and r["verify_graphs"] > 0,
                f"23(a): K3 from the drafter and the target, verify graphs: "
                f"{r['drafter_launches']}, {r['target_launches']}, "
                f"{r['verify_graphs']}")
    del clone
    draft = build_lm(tier="lm-base-draft")
    out["b"] = b = spec_run(ff, draft, prompts, force=False, f32=True)
    b["plain_decode_tokens_per_s"] = f32_rate
    require(b["streams"] == f32_plain,
            f"23(b) float32: speculative streams differ from plain decode: "
            f"{first_divergence(b['streams'], f32_plain)}")
    del draft
    out["c"] = inject_phase(ff, prompts, f32_plain)
    for r in (a32, a16, b):
        r.pop("streams")
    del ff
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_phase23(p: dict):
    for name, r in (("(a) float32", p["a"]["f32"]),
                    ("(a) bf16", p["a"]["bf16"]), ("(b) float32", p["b"])):
        log(f"  {name}: {r['rounds']} speculative rounds, "
            f"{r['accepted_tokens']} of {r['draft_tokens']} drafted tokens "
            f"accepted ({r['accepted_per_round']:.2f} a round), emitted "
            f"{r['emitted_tokens']}, acceptance EMA "
            f"{r['acceptance_ema']:.3f}, decisions {r['decision_counts']}; "
            f"{r['decode_tokens_per_s']:.1f} decode tokens/s vs plain "
            f"{r['plain_decode_tokens_per_s']:.1f}; ms by width: verify "
            f"{r['ms']['verify']}, draft {r['ms']['draft']}, decode "
            f"{r['ms']['decode']}; K3 drafter "
            f"{r['drafter_launches'].get('paged_flash_decode_attention')}, "
            f"target {r['target_launches'].get('paged_flash_decode_attention')}; "
            f"verify graphs {r['verify_graphs']} (widths "
            f"{r['verify_widths']})")
        if r.get("payoff"):
            log(f"    payoff decisions: " + "; ".join(
                f"k {d['k']}: lhs {d['lhs_s']:.6g} s vs rhs "
                f"{d['rhs_s']:.6g} s (a {d['acceptance_ema']:.3f}) -> "
                f"{d['chosen']}" for d in r["payoff"]))
    a16 = p["a"]["bf16"]
    log(f"  (a) bf16 streams equal to plain: {a16['equal_streams']} of 16; "
        f"first divergence {a16['first_divergence']}")
    c = p["c"]
    log(f"  (c) {c['requests']} prompts injected: blocks "
        f"{c['blocks_injected']}, inject ms "
        f"{[round(x, 3) for x in c['inject_ms']]} (calls "
        f"{c['inject_calls']}; median replay "
        f"{c['median_inject_replay_ms']} ms; {c['inject_graphs']} "
        f"graphs); kv_bytes_per_layer "
        f"{c['kv_bytes_per_layer']} B = the pools' "
        f"{c['pool_bytes_per_layer']} B")
    log(f"  phase 23 took {p['wall_s']:.1f} s")


# ------------------------------------------------------- the mesh: serving

def serve_timed(eng, prompts, profile: bool) -> dict:
    """`eng.generate(prompts)` with each pure-decode step that replayed
    timed (the median), and on the card the 8th pure-decode step
    profiled: its NCCL kernels' device ms."""
    sched = eng.scheduler
    step = eng.step
    ms, prof, seen = [], {}, [0]
    run = eng._step_fn.captured if eng.member else None

    def timed():
        pure = (not sched.pending
                and not any(s.prefilling for s in sched.slots))
        if pure:
            seen[0] += 1
        if pure and profile and seen[0] == 8:
            numbers, done = profiled(step, {"nccl": "nccl"})
            prof.update(nccl_ms=numbers["matched"]["nccl"]["ms"],
                        nccl_kernels=numbers["matched"]["nccl"]["count"],
                        step_ms=numbers["wall_ms_profiled"],
                        busy=numbers["device_busy_share"])
            return done
        t0 = time.perf_counter()
        done = step()
        if pure and (run is None or run.last_call == "replay"):
            ms.append((time.perf_counter() - t0) * 1e3)
        return done

    eng.step = timed
    t0 = time.perf_counter()
    streams = eng.generate(prompts)
    wall = time.perf_counter() - t0
    eng.step = step
    return {"streams": streams, "wall_s": wall,
            "median_decode_step_ms": (statistics.median(ms) if ms
                                      else None),
            "decode_tokens_per_s": eng.stats()["decode_tokens"] / wall,
            **prof}


def mesh_serve_check(device: str, lm=None, draft_lm=None,
                     tokens: int = NEW_TOKENS) -> dict:
    """The serving leg of the torchrun run on this rank, float32 (lm-base
    at full width and 12 layers by default, paged, 8 slots, phase 3's 16
    prompts): (e) served at tp N and at dp 2 x tp N/2 (Megatron plans,
    the KV pools' features over `model`), then at dp 2 on ranks [0, 2)
    re-planned mid-decode to dp 2 x tp N/2 over the world; (f) prefill
    on ranks [0, N/2) and decode on [N/2, N), the KV rows handed over
    NCCL, then one ratio shift; (g) speculation with lm-base-draft on
    the last N/2 ranks (--serve-draft-chips), forced. Every stream equal
    to this rank's one-rank engine's. Returns the rank's numbers and
    failures; no check stops the leg (the ranks stay in step)."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel import megatron_transformer

    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = str(device).startswith("cuda")
    failures, numbers = [], {}
    t_leg = time.perf_counter()

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    one_card = ("--mesh", "1,1,1,1")  # each rank's own trained model
    ff = build_lm(one_card, device=device, lm=lm)
    vocab = ff.layers[-1].params.out_channels
    prompts = make_prompts(vocab)
    kw = dict(kv_layout="paged", max_new_tokens=tokens)
    with float32(ff):
        one = ff.serve(**kw)
    numbers["one"] = r = serve_timed(one, prompts, cuda)
    want = r.pop("streams")
    del one
    megatron = megatron_transformer(ff)
    # (e) serving on a mesh
    for name, axes in (("tp", (1, world, 1, 1)),
                       ("dp2_tp", (2, world // 2, 1, 1))):
        with float32(ff):
            eng = ff.serve(strategy=megatron,
                           config_overrides={"mesh_axis_sizes": axes}, **kw)
        numbers[name] = r = serve_timed(eng, prompts, cuda)
        r["mesh"] = {k: int(v) for k, v in eng.decode_model.mesh.shape
                     .items()}
        name0 = eng.kv_pool_layers()[0]
        r["pool_local"] = list(eng.decode_model._state[name0]["pool_k"]
                               .shape)
        check(r.pop("streams") == want, f"(e) {name}: streams differ from "
                                        f"one rank's")
        eng._release_graphs()
        del eng
    with float32(ff):
        eng = ff.serve(strategy=megatron, config_overrides={
            "mesh_axis_sizes": (2, 1, 1, 1), "mesh_device_offset": 0}, **kw)
        reqs = [eng.submit(p) for p in prompts]
        for _ in range(8):
            eng.step()
        flight = sum(not q.finished for q in reqs)
        dec = eng.replan_mesh((2, world // 2, 1, 1))
    eng.run_until_drained()
    check(flight > 0 and [q.generated for q in reqs] == want,
          f"(e) replan dp 2 -> dp 2 x tp {world // 2}: {flight} in flight, "
          f"streams equal {[q.generated for q in reqs] == want}")
    numbers["replan"] = {k: dec.get(k) for k in (
        "decision", "compile_s", "migrate_s", "rebuild_s", "total_s",
        "predicted_migration_s", "migration_measured_s", "new_mesh_axes")}
    numbers["replan"]["in_flight"] = flight
    eng._release_graphs()
    del eng
    # (f) disaggregated prefill/decode
    with float32(ff):
        dis = ff.serve(disaggregate=True, prefill_chips=world // 2, **kw)
    t0 = time.perf_counter()
    got = dis.generate(prompts)
    wall = time.perf_counter() - t0
    check(got == want, "(f) disaggregated streams differ from one rank's")
    node = next(n for n in dis.decode.decode_model.graph.topo_order()
                if n.op_type.name == "OP_PAGED_INC_MULTIHEAD_ATTENTION")
    block_bytes = (2 * 4 * node.params.block_size * node.params.embed_dim
                   * len(dis.decode.kv_pool_layers()))
    numbers["disagg"] = {
        "wall_s": wall, "split": [dis.prefill_chips, dis.decode_chips],
        "handoffs": [{"blocks": h["injected_blocks"],
                      "prompt_blocks": h["prompt_blocks"],
                      "bytes": h["injected_blocks"] * block_bytes,
                      "measured_s": h["measured_s"],
                      "predicted_s": h["predicted_s"]}
                     for h in dis.handoffs]}
    dis.rebalance_min_samples = 1
    dis.rebalance_factor = 1e-4
    with float32(ff):
        shift = dis.maybe_rebalance(horizon_steps=10 ** 6)
    again = dis.generate(prompts)
    check(shift is not None and shift["decision"] == "migrated"
          and again == want,
          f"(f) ratio shift: {shift and shift['decision']}, streams equal "
          f"{again == want}")
    numbers["disagg"]["shift"] = shift and {k: shift.get(k) for k in (
        "decision", "old_prefill_chips", "new_prefill_chips",
        "predicted_migration_s", "migration_measured_s", "lhs_s", "rhs_s")}
    numbers["disagg"]["split_after"] = [dis.prefill_chips, dis.decode_chips]
    for side in (dis.prefill, dis.decode):
        side._release_graphs()
    del dis
    # (g) speculation, the drafter on its own ranks
    draft = build_lm(one_card, device=device, lm=draft_lm,
                     tier="lm-base-draft")
    with float32(ff, draft):
        eng = ff.serve(speculate=True, draft_model=draft,
                       draft_chips=world // 2, **kw)
    force_speculation(eng)
    t0 = time.perf_counter()
    got = eng.generate(prompts)
    sp = eng.stats()["speculation"]
    numbers["speculate"] = {
        "wall_s": time.perf_counter() - t0,
        "target_ranks": list(eng.decode_model.mesh.ranks),
        "drafter_ranks": list(eng.drafter.engine.decode_model.mesh.ranks),
        **{k: sp[k] for k in ("rounds", "draft_tokens", "accepted_tokens",
                              "emitted_tokens")}}
    check(got == want and sp["rounds"] > 0,
          f"(g) speculative streams equal {got == want}, rounds "
          f"{sp['rounds']}")
    eng.release_drafter()
    eng._release_graphs()
    del eng, draft, ff
    if cuda:
        torch.cuda.empty_cache()
    return {"rank": rank, "world": world, "failures": failures,
            "numbers": numbers, "wall_s": time.perf_counter() - t_leg}


def log_mesh_serve(r: dict):
    n = r["numbers"]

    def step(k):
        v = n[k]
        return (f"{v['median_decode_step_ms']} ms a decode step, NCCL "
                f"{v.get('nccl_ms')} ms ({v.get('nccl_kernels')} kernels) "
                f"of a profiled step, {v['decode_tokens_per_s']:.1f} "
                f"tokens/s")

    d = n["disagg"]
    log(f"  rank {r['rank']} serving leg: one rank {step('one')}; tp "
        f"{step('tp')} (pool {n['tp']['pool_local']}); dp2 x tp "
        f"{step('dp2_tp')}; replan {n['replan']}; disagg "
        f"{d['split']} -> {d['split_after']} in {d['wall_s']:.2f} s, "
        f"handoffs {d['handoffs'][:4]}, shift {d['shift']}; speculate "
        f"{n['speculate']}; {r['wall_s']:.1f} s; failures {r['failures']}")


# ------------------------------------------------------ the mesh: C5

def mesh_model(device: str, lm, mesh: int, flags: tuple = (),
               ranks=None, update: str = "off"):
    """`lm` in bf16 at dp `mesh` on this rank's `device` (on `ranks` of
    the world: a sub-mesh, the others parked), SGD, the update
    replicated or sharded (`update`: --weight-update-sharding)."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )

    cfg = FFConfig(device=device)
    cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED), "-b",
                    str(TRAIN_BATCH), "--mesh", f"{mesh},1,1,1",
                    f"--weight-update-sharding={update}", *flags])
    ff = FFModel(cfg)
    if ranks is not None:
        ff._mesh_ranks = list(ranks)
    STANDARD.into(ff, lm)
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY])
    return ff


def mesh_data(lm, steps: int):
    x, y = train_batch(lm.vocab_size, TRAIN_BATCH, lm.sequence_length)
    return ({k: np.concatenate([v] * steps) for k, v in x.items()},
            np.concatenate([y] * steps))


def mesh_c5_check(device: str, lm) -> dict:
    """C5 on this rank (torchrun): a HealthAbort (a rule firing at step 3
    on every rank, --health-abort-on) and an SPMDDivergenceError (raised
    by every rank's fault hook after step 3) out of a captured fit at dp
    world, each caught; then, in this process: no stream left capturing,
    the aborted model's captured step (and with it its CUDA graphs)
    freed by a collection, a fresh compile capturing and replaying its
    step, and an all-reduce over the world returning the world size."""
    import tempfile
    import weakref

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.analysis.spmd import SPMDDivergenceError
    from flexflow_tpu_torch.diagnostics import HealthAbort
    from flexflow_tpu_torch.diagnostics.health import (
        Alert, Rule, default_rules)
    from flexflow_tpu_torch.distributed import broadcast_json, gather_json
    from flexflow_tpu_torch.telemetry import deactivate

    world, rank = dist.get_world_size(), dist.get_rank()
    on_card = torch.device(device).type == "cuda"
    root = broadcast_json({"root": tempfile.mkdtemp(prefix="mesh_c5_")}
                          if rank == 0 else None)["root"]
    xs, ys = mesh_data(lm, 6)
    failures, checks = [], {}
    t0 = time.perf_counter()

    class AtStep3(Rule):
        name = "at_step_3"

        def _check(self, rec):
            if rec["step"] == 3:
                return Alert(rule=self.name, level="error", step=3,
                             message="planted on every rank")
            return None

    def spmd_hook(step):
        if step == 3:
            raise SPMDDivergenceError({"step": step}, {"step": -1})

    for kind in ("HealthAbort", "SPMDDivergenceError"):
        ff = mesh_model(device, lm, world)
        if kind == "HealthAbort":
            ff.enable_diagnostics(os.path.join(root, f"{kind}_{rank}"),
                                  rules=default_rules(ff.config)
                                  + [AtStep3()], abort_on=("at_step_3",))
        else:
            ff.set_fault_hook(spmd_hook)
        raised = None
        try:
            ff.fit(xs, ys, epochs=1, batch_size=TRAIN_BATCH,
                   shuffle=False, verbose=False)
        except (HealthAbort, SPMDDivergenceError) as e:
            raised = type(e).__name__
        deactivate()
        step = ff.executor._train_step
        capturing = False
        if on_card:
            with torch.cuda.stream(step.stream):
                capturing = torch.cuda.is_current_stream_capturing()
            capturing = capturing or torch.cuda.is_current_stream_capturing()
        held = weakref.ref(step)
        stopped_at = ff._py_step()
        del ff, step
        gc.collect()
        fresh = mesh_model(device, lm, world)
        fresh.fit(*mesh_data(lm, 3), epochs=1, batch_size=TRAIN_BATCH,
                  shuffle=False, verbose=False)
        replayed = getattr(fresh.executor._train_step, "last_call", "")
        t = torch.ones(1, device=device)
        dist.all_reduce(t)
        got = {"raised": raised, "stopped_at": stopped_at,
               "capturing": capturing, "graphs_freed": held() is None,
               "fresh_last_call": replayed, "all_reduce": float(t.item())}
        checks[kind] = got
        want_call = "replay" if on_card else ""
        if got != {"raised": kind, "stopped_at": 3, "capturing": False,
                   "graphs_freed": True, "fresh_last_call": want_call,
                   "all_reduce": float(world)}:
            failures.append(f"C5 {kind}: {got}")
        del fresh
        gc.collect()
    everyone = gather_json({"failures": failures})
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {"rank": rank, "world": world, "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "numbers": {},
            "checks": checks, "failures": failures,
            "all_ranks_ok": all(not e["failures"] for e in everyone)}


# ------------------------------------------------- the mesh: elastic

def mesh_elastic_check(device: str, lm, steps: int = 4) -> dict:
    """The elastic leg on this rank (torchrun, N ranks): `lm` at dp N,
    the update sharded at rest (stage 2: a move between two meshes
    gathers, and fftrans prices it), captured, `steps` steps; then the
    visible set drops to the first N/2 ranks: the count agreed over the world, a forced shrink at the next
    fit's entry onto a sub-mesh of those ranks (the others parked), and
    `steps` more steps there, the masters bit-equal to a
    checkpoint-restart at dp N/2 on the same sub-mesh; then every rank
    visible again: the payoff (horizon 10^6 steps, the strategy reports'
    predicted step times) regrows to dp N and `steps` more steps run on
    every rank; then a visible count of 2N, past the torchrun world:
    declined with no search. Every rank leaves together (the same step,
    the same decisions). Each phase's step time (the median of its
    replayed steps, synchronised at each step edge), each migration's
    measured and predicted seconds and its bytes on the wire
    (predicted, and received by this rank); the fidelity entry the
    priced shrink left in the warm-start DB (--warmstart-dir)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.distributed import broadcast_json, gather_json
    from flexflow_tpu_torch.telemetry import deactivate

    world, rank = dist.get_world_size(), dist.get_rank()
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = broadcast_json({"root": tempfile.mkdtemp(prefix="mesh_el_")}
                          if rank == 0 else None)["root"]
    half = list(range(world // 2))
    vis = {"ranks": list(range(world))}
    failures, numbers = [], {}
    t0 = time.perf_counter()
    warm = ("--warmstart-dir", os.path.join(root, "warm"))
    ff = mesh_model(device, lm, world, warm, update="stage2")
    ctrl = ff.enable_elastic(cooldown_steps=0, horizon_steps=10 ** 6,
                             visible_devices_fn=lambda: vis["ranks"],
                             capacity_check_every=1)

    def fit(model, n, key):
        """n steps through fit; the median step of those that replayed,
        each timed between two synchronised step edges."""
        marks = []

        def hook(step):
            sync()
            marks.append((time.perf_counter(), getattr(
                model.executor._train_step, "last_call", "eager")
                if model.executor is not None else ""))
        model.set_fault_hook(hook)
        sync()
        start = time.perf_counter()
        model.fit(*mesh_data(lm, n), epochs=1, batch_size=TRAIN_BATCH,
                  shuffle=False, verbose=False)
        deactivate()
        model.set_fault_hook(None)
        prev, times = start, []
        for t, call in marks:
            if call in ("replay", "eager"):
                times.append(1e3 * (t - prev))
            prev = t
        numbers[key] = {"steps_run": len(marks), "step_ms": times,
                        "median_step_ms": (statistics.median(times)
                                           if times else None)}

    def migrations(since: int) -> list:
        return [{k: d.get(k) for k in (
                    "step", "decision", "forced", "new_mesh_axes",
                    "lhs_s", "rhs_s", "predicted_migration_s",
                    "migration_measured_s", "migration_wall_s",
                    "moved_bytes", "research_s", "total_s", "reason")}
                for d in ctrl.decisions[since:]]

    fit(ff, steps, "dp_before")
    ck = os.path.join(root, "ck")
    ff.save_checkpoint(ck)
    # the shrink
    vis["ranks"] = half
    n0 = len(ctrl.decisions)
    fit(ff, steps, "shrunk")
    shrink = migrations(n0)
    numbers["shrink"] = shrink
    parked = not ff.mesh.member
    numbers["parked"] = parked
    numbers["parked_polls"] = ctrl.parked_polls
    if (len(shrink) != 1 or shrink[0]["decision"] != "migrated"
            or not shrink[0]["forced"]
            or parked != (rank not in half)):
        failures.append(f"shrink: {shrink}, parked {parked}")
    if rank == 0:
        import types

        from flexflow_tpu_torch.elastic.payoff import load_fidelity

        # what a fresh process reads: the DB entry, no in-process EMA
        reader = types.SimpleNamespace(
            _warmstart=None, device=torch.device(device),
            config=types.SimpleNamespace(warmstart_dir=warm[1]))
        numbers["fidelity"] = list(load_fidelity(reader))
        priced = (shrink[0]["predicted_migration_s"] or 0) > 0
        if priced != (numbers["fidelity"][1] == 1):
            failures.append(f"the priced shrink's fidelity entry in the "
                            f"warm-start DB: {numbers['fidelity']}")
    ctl = mesh_model(device, lm, len(half), ranks=half, update="stage2")
    if ctl.mesh.member:
        ctl.load_checkpoint(ck)
        fit(ctl, steps, "restart")
        differ = p20_differ(p20_masters(ctl), p20_masters(ff))
        numbers["restart_differ"] = differ[:4]
        if differ:
            failures.append(f"shrink vs checkpoint-restart at dp "
                            f"{len(half)}: differ at {differ[:4]}")
    del ctl
    gc.collect()
    # the regrow
    ff.enable_diagnostics(os.path.join(root, f"tel{rank}"),
                          drift_threshold=1e9)
    vis["ranks"] = list(range(world))
    n0 = len(ctrl.decisions)
    fit(ff, steps, "regrown")
    grow = migrations(n0)
    numbers["regrow"] = grow
    if (not grow or grow[0]["decision"] != "migrated"
            or grow[0]["forced"] or not ff.mesh.member
            or dict(ff.mesh.shape)["data"] != world):
        failures.append(f"regrow: {grow}")
    # past the world
    vis["ranks"] = list(range(2 * world))
    n0, ex = len(ctrl.decisions), ff.executor
    fit(ff, 1, "past")
    past = migrations(n0)
    numbers["past"] = past
    if (not past or any(d["decision"] != "declined"
                        or "past the torchrun world" not in d["reason"]
                        or d["lhs_s"] is not None for d in past)
            or ff.executor is not ex):
        failures.append(f"past the world: {past}")
    numbers["final_step"] = ff._py_step()
    everyone = gather_json({"step": numbers["final_step"],
                            "decisions": [d["decision"]
                                          for d in ctrl.decisions]})
    if len({json.dumps(e) for e in everyone}) != 1:
        failures.append(f"the ranks left apart: {everyone}")
    if numbers["final_step"] != 3 * steps + 1:
        failures.append(f"final step {numbers['final_step']}")
    del ff
    gc.collect()
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {"rank": rank, "world": world, "layers": lm.num_layers,
            "wall_s": time.perf_counter() - t0, "numbers": numbers,
            "checks": {}, "failures": failures}


def _tensors(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def log_ring(r: dict):
    log(f"  ring block algebra {r['shape']} vs whole-sequence flash, "
        f"causal: max abs err {r['max_abs_err']}; block launches "
        f"{r['launches']}")


def log_mesh_runs(out: dict):
    rank = out["rank"]
    for r in out["runs"]:
        busy = (f"kernels {r['device_busy_ms']:.2f} ms (busy "
                f"{100 * r['device_busy_share']:.1f}%, NCCL "
                f"{r['nccl_ms']:.2f} ms), " if "device_busy_ms" in r else "")
        log(f"  rank {rank} {r['name']} {r['dtype']} mesh {r['mesh']}: "
            f"median step {r['median_step_ms']:.2f} ms (steps "
            f"{[round(v, 2) for v in r['step_ms']]}), {busy}peak "
            f"{r['max_memory_allocated']} B, losses "
            f"{[round(v, 7) for v in r['losses']]}, flash heads "
            f"{r['flash_heads']}, variants {r['flash_variants']}, update "
            f"{r['update_sharding']}, plan ({r['plan_source']}) "
            f"{r['plan']}")
    for key, c in out["checks"].items():
        log(f"  rank {rank} {key}: {c}")


def log_gloo(g: dict):
    log(f"  gloo ring hop of CUDA tensors (batch_isend_irecv), per rank: "
        f"{g['p2p_probe']}; stage 3 "
        f"{'ran' if g['stage3_ran'] else 'not run: gloo refused its ring hop'}")
    for out in g["ranks"]:
        log_mesh_runs(out)


def mesh_main(json_path: str) -> int:
    """The mesh run, under `torchrun --nproc-per-node N` (N > 1 cards of
    one host): one rank a card over NCCL, `mesh_check` captured, lm-base
    at MESH_LAYERS layers. Rank 0 prints every rank's runs and checks,
    the card line, then {"ok": ..., "failures": [...], "world": N}
    last; `--json PATH` writes each rank's numbers to PATH with
    `_rank<r>` before its suffix. Any failed check exits non-zero."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.distributed import initialize
    from flexflow_tpu_torch.search.machine_model import card_line

    initialize(device="cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        log(f"== the mesh: {world} ranks over NCCL, lm-base at full width "
            f"({MESH_LAYERS} layers; sp: seq {RING_SEQ}, pp: the pipelined "
            f"LM, 12 layers), captured")
        build_kernels()  # once, before the ranks' first use
    dist.barrier()
    out = mesh_check(f"cuda:{torch.cuda.current_device()}",
                     lm_config(layers=MESH_LAYERS), MESH_STEPS,
                     captured=True, search=True,
                     seq_lm=dataclasses.replace(
                         lm_config(), sequence_length=RING_SEQ),
                     pipe_lm=lm_config())
    dev = f"cuda:{torch.cuda.current_device()}"
    out["resume"] = mesh_resume_check(
        dev, lm_config(layers=MESH_LAYERS), MESH_STEPS, captured=True)
    # the legs in the order they had before C5 (a captured step's graph
    # freed by a collection inside a later capture; held off since)
    out["diag"] = mesh_diag_check(dev, lm_config(layers=MESH_LAYERS),
                                  captured=True)
    out["barrier"] = mesh_barrier_check(dev, lm_config(layers=MESH_LAYERS))
    out["c5"] = mesh_c5_check(dev, lm_config(layers=MESH_LAYERS))
    out["elastic"] = mesh_elastic_check(dev, lm_config())
    out["serve"] = mesh_serve_check(dev)
    out["failures"] = (out["failures"] + out["resume"]["failures"]
                       + out["diag"]["failures"]
                       + out["barrier"]["failures"]
                       + out["c5"]["failures"]
                       + out["elastic"]["failures"]
                       + out["serve"]["failures"])
    if json_path:
        root, ext = os.path.splitext(os.path.abspath(json_path))
        os.makedirs(os.path.dirname(root), exist_ok=True)
        with open(f"{root}_rank{rank}{ext}", "w") as f:
            json.dump(out, f, indent=1)
    outs = [None] * world
    dist.all_gather_object(outs, out)
    bad = [f"rank {r}: {f}" for r, o in enumerate(outs)
           for f in o["failures"]]
    if rank == 0:
        for o in outs:
            log_mesh_runs(o)
            log_mesh_resume(o["resume"])
            log_mesh_resume(o["diag"])
            log_mesh_resume(o["barrier"])
            log_mesh_resume(o["c5"])
            log_mesh_elastic(o["elastic"])
            log_mesh_serve(o["serve"])
        log(card_line())
        print(json.dumps({"ok": not bad, "failures": bad[:8],
                          "world": world, "backend": dist.get_backend()}),
              flush=True)
    return 1 if bad else 0


def log_mesh_elastic(r: dict):
    n = r["numbers"]

    def ms(key):
        v = n.get(key, {}).get("median_step_ms")
        return "-" if v is None else f"{v:.2f}"

    def moves(key):
        return "; ".join(
            f"{d['decision']} at step {d['step']}"
            + (f" to {d['new_mesh_axes']} (forced {d['forced']}): "
               f"measured {d['migration_measured_s']} s (wall "
               f"{d['migration_wall_s']} s) vs predicted "
               f"{d['predicted_migration_s']} s, received "
               f"{d['moved_bytes']} B, lhs {d['lhs_s']} rhs {d['rhs_s']}"
               if d["decision"] == "migrated" else
               f" ({d.get('reason')})")
            for d in n.get(key, []))
    log(f"  rank {r['rank']} elastic leg ({r['layers']} layers, bf16): "
        f"step {ms('dp_before')} ms at dp {r['world']}, "
        f"{ms('shrunk')} ms shrunk ({'parked, ' + str(n.get('parked_polls')) + ' agreements' if n.get('parked') else 'active'}), "
        f"{ms('restart')} ms the restart, {ms('regrown')} ms regrown; "
        f"shrink: {moves('shrink')}; regrow: {moves('regrow')}; past the "
        f"world: {moves('past')}; final step {n.get('final_step')}; "
        f"{r['wall_s']:.1f} s; failures {r['failures']}")


def log_mesh_resume(r: dict):
    log(f"  rank {r['rank']} resume leg ({r['layers']} layers, bf16): "
        f"{r['numbers']}; checks {r['checks']}")


def log_phase19(p: dict, phase6_ms: float):
    """Phase 19's figures, each run on its own line."""
    ch = p["chunks"]
    for name, r in ch.items():
        med = r["median_replay_ms_per_step"]
        peak = r["max_memory_allocated"]
        if "peak_vs_per_step" in r:
            peak = f"{peak} B ({r['peak_vs_per_step']:.4f}x per-step)"
        log(f"  19(a) {name}: {r['steps_run']} steps in {r['wall_s']:.2f} "
            f"s, replay device time a step {med} ms (phase 6 median step "
            f"{phase6_ms:.3f}), captures {r['captures']}, launches per "
            f"call {r['launches_per_call']}, peak {peak}")
    for name, r in p["resume"].items():
        if name == "fresh_process":
            continue
        blocking = [round(v["ms"], 3) for v in r["saves"]]
        snap = [round(v["snapshot_ms"], 3) for v in r["saves"]]
        writes = [(round(c["serialize_s"], 3), round(c["commit_s"], 4))
                  for c in r["commits"]]
        log(f"  19(b) {name}: stopped at step {r['py_step']} (killed "
            f"{r['killed']}), committed {r['checkpoints']}, cursor "
            f"{r['cursor']}, {r['bytes']} bytes a checkpoint; blocking "
            f"slice of each save {blocking} ms (snapshot {snap} ms) vs "
            f"phase 6's step {phase6_ms:.3f} ms; writer serialize / commit "
            f"{writes} s" + (f"; in-process restore {r['in_process']}"
                             if "in_process" in r else ""))
    fresh = p["resume"]["fresh_process"]
    log(f"  19(b) fresh process ({fresh['process_s']:.1f} s): "
        + "; ".join(f"{r['name']}: restore {r['restore_s']:.3f} s, ran "
                    f"{r['steps_run']} steps to {r['py_step']}, captures "
                    f"{r['captures']}, bit-equal {not r['diff']}"
                    for r in fresh["resumes"]))
    t = p["torn"]
    log(f"  19(c) async save issued in {t['issue_ms']:.3f} ms between "
        f"replays, 2 replays queued behind it moved {t['masters_moved']} "
        f"of {t['masters']} masters, the committed ones equal the "
        f"synchronous copy; write {t['write']}")
    for rank, r in enumerate(p["warm"]["ranks"]):
        log(f"  19(d) rank {rank}: " + "; ".join(
            f"{tag}: plan {v['plan_source']}, {v['evals']} evals, compile "
            f"{v['compile_s']:.2f} s, time to first step "
            f"{v['time_to_first_step_s']}" for tag, v in r.items()))


def log_train(t: dict):
    log(f"  {t['model']}, {t['layout']}, batch {t['batch']}: losses "
        f"{[round(x, 4) for x in t['losses']]}")
    timed = t["step_ms"][t["steps"] - t["timed_steps"]:]
    log(f"  {t['tokens_per_s']:.0f} tokens/s, median step "
        f"{t['median_step_ms']:.2f} ms (timed steps "
        f"{[round(x, 2) for x in timed]} ms), MFU {100 * t['mfu']:.2f}% of "
        f"{PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s, kernel time of a "
        f"profiled step {t['profiled_step']['device_busy_ms']:.2f} ms "
        f"({100 * t['device_busy_share']:.1f}% of the median step; "
        f"stream {t['profiled_step']['stream_ms']:.2f} ms; copy kernels "
        f"{t['profiled_step']['copy_kernels']}, host casts "
        f"{t['profiled_step']['host_casts']}; max_memory_allocated "
        f"{t['max_memory_allocated']} B); "
        f"launches per step {t['launches_per_step']}, flash launches by "
        f"layout {t['launches_by_layout']}, by variant per step "
        f"{t['launches_by_variant_per_step']}")


def mma_note(numbers: dict) -> str:
    """The mma.sync variant's time, where a flash row has one."""
    if "mma_ms" not in numbers:
        return ""
    return f", mma.sync {numbers['mma_ms']:.4f}"


def log_grads(g: dict):
    log(f"  {g['layers']} layers, batch {g['batch']}, {g['layout']}, "
        f"{g['dtype']}: worst of {g['tensors']} gradients: "
        f"{g['worst_tensor']}, max abs diff {g['max_abs_diff']:.3e} "
        f"({g['relative_to_largest']:.3e} of its layer's largest gradient "
        f"entry, bound {g['bound_relative']})")


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", default="", help="also write every "
                        "number of the run, as JSON, to this file")
    parser.add_argument("--resume-child", default="",
                        help=argparse.SUPPRESS)  # phase 19(b)'s process
    parser.add_argument("--gate-child", default="",
                        help=argparse.SUPPRESS)  # phase 21(c)'s process
    args = parser.parse_args(argv)
    json_path = args.json
    if args.resume_child:
        sys.path.insert(0, REPO)
        print(json.dumps(resume_child(json.loads(args.resume_child))),
              flush=True)
        return 0
    if args.gate_child:
        sys.path.insert(0, REPO)
        print(json.dumps(gate_child(json.loads(args.gate_child))),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return mesh_main(json_path)
    from flexflow_tpu_torch.executor import set_float_policy
    from flexflow_tpu_torch.search.machine_model import card_line

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: build and device")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    set_float_policy()  # full float32 matmuls (no TF32), stated
    build_s = build_kernels()

    log("== phase 2: kernel parity on the card")
    errs = kernel_parity(dev)
    train_kernel_parity(dev, errs)

    log("== phase 3/4: serving lm-base, bf16, paged then contiguous")
    ff = build_lm()
    # the process's first compile gate: it parses the runtime sources
    # its source-level checks read (cached for every later compile)
    first_verify_s = ff._analysis.elapsed_s
    vocab = ff.layers[-1].params.out_channels
    prompts = make_prompts(vocab)
    runs, eager_runs = {}, {}
    for layout in ("paged", "contiguous"):
        runs[layout] = serve_phase(ff, layout, prompts, vocab)
        eager_runs[layout] = e = serve_phase(ff, layout, prompts, vocab,
                                             mode="eager")
        r = runs[layout]
        log(f"  {layout}: {r['requests']} requests x {NEW_TOKENS} tokens, "
            f"{r['decode_tokens_per_s']:.1f} decode tokens/s (eager "
            f"{e['decode_tokens_per_s']:.1f}), median pure-decode step "
            f"{r['median_decode_step_ms']:.2f} ms, {r['decode_graphs']} "
            f"decode graphs of {r['decode_widths']} widths, launches "
            f"{r['launches']}, per pure-decode step "
            f"{r['launches_per_decode_step']}")
        log_modes(layout, r, e, "median_decode_step_ms")
        require(r["streams"] == e["streams"],
                f"{layout}: captured and eager bf16 streams differ")
        require(r["launches"] == e["launches"],
                f"{layout}: launches captured {r['launches']} vs eager "
                f"{e['launches']}")
        e.pop("streams")
    same = sum(a == b for a, b in zip(runs["paged"]["streams"],
                                      runs["contiguous"]["streams"]))
    log(f"  paged and contiguous streams identical for {same} of "
        f"{len(prompts)} requests (bf16)")
    f32_streams = f32_stream_check(ff, prompts)
    f32_paged = f32_streams.pop("paged_streams")
    log(f"  float32: paged and contiguous streams identical for "
        f"{f32_streams['identical']} of {len(prompts)} requests; first "
        f"difference: {f32_streams.get('first_difference')}")

    log("== phase 5: first-step logits, float32, kernels vs plain")
    logit_err = {layout: logits_phase(ff, layout, prompts[:SLOTS])
                 for layout in ("paged", "contiguous")}
    log(f"  max abs logits difference {logit_err} (bound {LOGITS_ATOL})")
    del ff
    torch.cuda.empty_cache()

    log("== phase 6: training lm-base, bf16, SGD, fit over one batch, "
        "captured then eager")
    train = train_phase(keep_masters=True)
    p6_masters = train["masters"]  # phase 15 holds its run to these
    log_train(train)
    train_e = train_phase(mode="eager", keep_masters=True)
    log_train(train_e)
    train["captured_vs_eager"] = captured_vs_eager(train, train_e)
    log_modes("lm-base train", train, train_e, "median_step_ms")
    log(f"  masters after {train['steps']} steps, captured vs eager: "
        f"{train['captured_vs_eager']}")

    log("== phase 7: training gradients, float32, kernels vs plain")
    grads = grad_phase()
    log_grads(grads)

    log("== phase 8: kernel times at the main paths' shapes")
    nums = kernel_numbers(dev)
    nums.update(train_kernel_numbers(dev))
    nums.update(per_head_kernel_numbers(dev))

    log("== phase 9: training lm-base under --flash-transposed, bf16, SGD")
    train_t = train_phase(transposed=True, fused=True, warmup=2,
                          timed_steps=3)
    log_train(train_t)

    log(f"== phase 10: training {XXL} ({XXL_LAYERS} layers), bf16, SGD, "
        f"packed then --flash-transposed")
    xxl = lm_config(XXL, XXL_LAYERS)
    train_x = train_phase(xxl, batch=XXL_BATCH, warmup=2, timed_steps=3,
                          keep_masters=True)
    log_train(train_x)
    train_xe = train_phase(xxl, batch=XXL_BATCH, warmup=2, timed_steps=3,
                           mode="eager", keep_masters=True)
    log_train(train_xe)
    train_x["captured_vs_eager"] = captured_vs_eager(train_x, train_xe)
    log_modes(f"{XXL} packed", train_x, train_xe, "median_step_ms")
    log(f"  masters, captured vs eager: {train_x['captured_vs_eager']}; "
        f"max_memory_allocated captured {train_x['max_memory_allocated']} "
        f"B, eager {train_xe['max_memory_allocated']} B")
    train_xt = train_phase(xxl, transposed=True, batch=XXL_BATCH, warmup=2,
                           timed_steps=3)
    log_train(train_xt)

    log("== phase 11: per-head training gradients, float32 and bfloat16, "
        "kernels vs plain")
    grads_ph = {
        "lm-base transposed": grad_phase(lm_config(layers=2),
                                         transposed=True, fused=True),
        "lm-xxl packed": grad_phase(lm_config(XXL, 1), batch=1),
        "lm-xxl transposed": grad_phase(lm_config(XXL, 1), transposed=True,
                                        batch=1),
        "lm-xxl packed bf16": grad_phase(lm_config(XXL, 1), batch=1,
                                         dtype="bf16"),
    }
    for g in grads_ph.values():
        log_grads(g)

    log("== phase 12: bench_torch.py's measurement (lm-base, 8 x 512, "
        "SGD, the captured step replayed n and 3n times)")
    import bench_torch

    bench = bench_torch.measure()
    log(json.dumps(bench))
    log(json.dumps(bench_torch.metric_line(bench)))

    log(f"== phase 13: training ResNet-50 ({RESNET_BATCH} x 3 x 224 x "
        f"224, 10 classes), bf16, SGD, fit over one batch, captured then "
        f"eager")
    rn = resnet_phase(keep_masters=True)
    log_resnet(rn)
    rn_e = resnet_phase(mode="eager", keep_masters=True)
    log_resnet(rn_e)
    rn["captured_vs_eager"] = compare_masters(rn.pop("masters"),
                                              rn_e.pop("masters"))
    log_modes("resnet-50 train", rn, rn_e, "median_step_ms")
    log(f"  masters after {rn['steps'] + 1} steps, captured vs eager: "
        f"{rn['captured_vs_eager']}")

    log("== phase 14: training lm-base under --telemetry-dir "
        "(--metrics-interval 1), captured")
    tel = telemetry_phase(train)
    log(f"  recorded median step {tel['recorded_median_step_ms']:.3f} ms "
        f"({tel['recorded_vs_phase6']:.4f} of phase 6's "
        f"{tel['phase6_median_step_ms']:.3f}), summary p50 "
        f"{tel['summary_p50_step_ms']:.3f} ms ({tel['p50_vs_phase6']:.4f}; "
        f"within 15%: {tel['p50_within_15pct']}), MFU gauge "
        f"{100 * tel['mfu_gauge']:.2f}% ({tel['mfu_gauge_vs_phase6']:.4f} "
        f"of phase 6's {100 * tel['phase6_mfu']:.2f}%); data wait "
        f"{[round(v, 3) for v in tel['data_wait_ms']]} ms, device "
        f"{[round(v, 3) for v in tel['device_time_ms']]} ms; records "
        f"{tel['records']}")

    log("== phase 15: phase 6's lm-base run on a (1, 1, 1, 1) mesh under "
        "an NCCL process group of one rank, captured")
    nccl = nccl_phase(p6_masters)
    del p6_masters
    log_train(nccl)
    log(f"  backend {nccl['backend']}, mesh {nccl['mesh_axes']}, update "
        f"{nccl['update_sharding']}; masters after {nccl['steps']} "
        f"steps vs phase 6's: {nccl['vs_phase6']}")
    coll = nccl["collectives"]
    log(f"  collectives captured in a CUDA graph over one rank (sync_grad's "
        f"reduce-scatter + all-gather and all-reduce, ParamGather's "
        f"all-gather and its backward's reduce-scatter): replays equal to "
        f"their inputs {coll['replays_equal']}; a replay's kernels "
        f"{coll['profiled_replay']}")

    log(f"== phase 16: two gloo ranks on the one card, lm-base at full "
        f"width ({GLOO_LAYERS} layers), eager: one rank vs dp 2 and tp 2, "
        f"float32 and bf16; stages 2/3 vs replicated")
    gloo = gloo_phase()
    log_gloo(gloo)

    log("== phase 17: the Unity search on lm-base at full width (12 "
        "layers, 8 x 512, bf16): calibration on the card, then the joint "
        "search over the H100 model of four meshes")
    search = search_phase(train, nums["flash_attention_fwd"]["ms"])
    log_search(search)

    log("== phase 18: the pipelined lm-base (12 layers, 8 x 512, bf16, "
        "SGD, no pipe axis: the stages in order), captured then eager; its "
        "float32 gradients at 2 layers; the ring's block algebra at "
        f"lm-base-seq{RING_SEQ} widths")
    train_pp = train_phase(keep_masters=True, build=PIPELINED)
    log_train(train_pp)
    train_ppe = train_phase(mode="eager", keep_masters=True,
                            build=PIPELINED)
    log_train(train_ppe)
    train_pp["captured_vs_eager"] = captured_vs_eager(train_pp, train_ppe)
    log_modes("pipelined lm-base train", train_pp, train_ppe,
              "median_step_ms")
    log(f"  masters after {train_pp['steps']} steps, captured vs "
        f"eager: {train_pp['captured_vs_eager']}")
    grads_pp = grad_phase(lm_config(layers=2), build=PIPELINED)
    log_grads(grads_pp)
    ring = ring_phase(dev)
    log_ring(ring)
    for row, cases in ring_kernel_numbers(dev, errs).items():
        nums[row].update(cases)
    log("== phase 19: lm-base at full width (12 layers, 8 x 512, bf16, "
        "SGD) through fit with checkpoints and chunks: chunked vs "
        "per-step, preempted and resumed, the snapshot's ordering, the "
        "warm start")
    p19 = phase19("cuda", lm_config(), TRAIN_BATCH,
                  lm_config(layers=WARM_LAYERS))
    log_phase19(p19, train["median_step_ms"])
    log("== phase 20: the observability half on lm-base at full width (12 "
        "layers, 8 x 512, bf16, SGD, captured): diagnostics, the sanitizer, "
        "sampled op profiles, drift, the hang watchdog, serving's "
        "telemetry, --profiling")
    p20 = phase20(train, runs["paged"])
    log_phase20(p20)
    log("== phase 21: the static analysis on the card: lm-base through the "
        "compile gate; the memory pass's peak vs phases 6 and 10; where "
        f"the pass and the card draw the line for {XXL} (4 x 2048); the "
        "ffrules oracle on cuda vs the CPU")
    p21 = phase21(train, train_x, first_verify_s)
    log_phase21(p21)
    log("== phase 22: elastic re-planning and in-process migration on "
        "lm-base at full width (12 layers, 8 x 512, bf16, SGD, captured): "
        "a drift re-plan through fit --elastic, migrate_state, "
        "--elastic-dry-run, the serving engine's decode re-plan "
        "mid-decode")
    p22 = phase22(train, prompts, runs["paged"]["streams"])
    log_phase22(p22)
    log("== phase 23: the serving extras on lm-base at full width (8 "
        "slots, phase 3's 16 prompts, paged): speculation with a "
        "seed-clone drafter forced (float32, bf16), lm-base-draft under "
        "the honest payoff gate (float32), the KV inject path")
    p23 = phase23(prompts, runs["paged"], f32_paged,
                  f32_streams["decode_tokens_per_s"]["paged"])
    log_phase23(p23)

    # the pipelined LM's flash calls are phase 8's packed (8, 512, 16 x
    # 64) case: its launches reported beside phase 6's under rows 7, 9, 10
    for row in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        nums[row] = {"train": nums[row], "pipelined lm-base": nums[row]}

    # the run whose launches each row (and each case of a row) reports
    counted = {"train": train, "paged": runs["paged"],
               "contiguous": runs["contiguous"],
               "lm-base transposed": train_t, "lm-xxl packed": train_x,
               "lm-xxl transposed": train_xt, "pipelined lm-base": train_pp,
               **{case: {"launches": n} for case, n in
                  ring["launches"].items()}}
    rows = []
    for row, counter, route, source, replaces, run_key in KERNELS:
        run = counted[run_key]
        per_step = run.get("launches_per_step",
                           run.get("launches_per_decode_step"))
        n = dict(nums[row])
        cases = {}
        if run_key in n:  # numbers by case: the row's own first
            main_case = n.pop(run_key)
            for case, numbers in n.items():
                cr = counted.get(case)
                cases[case] = dict(numbers, launches=(
                    cr["launches"][counter] if cr else 0))
                if f"{row} @ {case}" in errs:
                    cases[case]["max_abs_err_at_shape"] = errs[
                        f"{row} @ {case}"]
            n = main_case
            if f"{row} @ {run_key}" in errs:
                n["max_abs_err_at_shape"] = errs[f"{row} @ {run_key}"]
        # the flash rows: launches by variant, and each variant's source
        by_variant = run.get("launches_by_variant", {}).get(counter)
        if by_variant is not None:
            n = dict(n, launches_by_variant=by_variant,
                     variant_sources=VARIANT_SOURCES)
        chunked = p19["chunks"]["chunks of 4"]["launches"]
        if counter in chunked:
            n = dict(n, phase19_chunked_launches=chunked[counter])
        # phase 22's paths: the elastic fit (a) and the serving re-plan
        # (d), each counted from 0
        elastic = {k: p22[k]["launches"][counter] for k in ("a", "d")
                   if counter in p22[k]["launches"]}
        if elastic:
            n = dict(n, phase22_launches=elastic)
        # phase 23's paths: the speculative runs' drafter and target, and
        # the inject path's decode
        spec = {f"{name} {side}": r[f"{side}_launches"][counter]
                for name, r in (("23(a) f32", p23["a"]["f32"]),
                                ("23(a) bf16", p23["a"]["bf16"]),
                                ("23(b) f32", p23["b"]))
                for side in ("drafter", "target")
                if counter in r[f"{side}_launches"]}
        if spec:
            n = dict(n, phase23_launches=spec)
        rows.append(dict(
            name=row, route=route, source=source, replaces=replaces,
            launches=run["launches"][counter], max_abs_err=errs[row],
            launches_per_step=per_step[counter], **n,
            **({"cases": cases} if cases else {})))
        log(f"  {row}: {n['ms']:.4f} ms (bound {n['bound_ms']:.4f} by "
            f"{n['bound_by']}, plain {n['plain_ms']:.4f}, library "
            f"{n['library_ms']}{mma_note(n)}); "
            + "; ".join(f"{c}: {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                        f"plain {v['plain_ms']:.4f}, library "
                        f"{v['library_ms']:.4f}{mma_note(v)})"
                        for c, v in cases.items()))
    serving = {
        layout: {k: v for k, v in r.items() if k != "streams"}
        for layout, r in runs.items()}
    serving_eager = eager_runs
    per_head = {"lm-base transposed": train_t, "lm-xxl packed": train_x,
                "lm-xxl transposed": train_xt}
    detail = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda,
                  build_s=build_s, kernels=rows, serving=serving,
                  logits_max_abs=logit_err, streams_identical=same,
                  f32_streams=f32_streams,
                  serving_eager=serving_eager,
                  training=train, training_eager=train_e,
                  training_xxl_eager=train_xe, bench_torch=bench,
                  training_gradients=grads,
                  per_head_training=per_head,
                  per_head_gradients=grads_ph,
                  lse_entry_max_abs_err=errs["flash_attention_with_lse"],
                  resnet50=rn, resnet50_eager=rn_e, telemetry=tel,
                  nccl_world1=nccl, gloo_two_ranks=gloo, search=search,
                  pipelined=train_pp, pipelined_eager=train_ppe,
                  pipelined_gradients=grads_pp, ring_blocks=ring,
                  phase19=p19, phase20=p20, phase21=p21, phase22=p22,
                  phase23=p23,
                  total_s=time.perf_counter() - t_start)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(detail, f, indent=1)

    def summary(t):
        return {k: t[k] for k in (
            "tokens_per_s", "median_step_ms", "mfu", "device_busy_share",
            "stream_busy_share", "max_memory_allocated",
            "launches_per_step")}

    log(json.dumps({"serving": serving, "logits_max_abs": logit_err,
                    "f32_streams": f32_streams,
                    "serving_eager": {
                        k: {m: v[m] for m in ("median_decode_step_ms",
                                              "decode_tokens_per_s")}
                        for k, v in serving_eager.items()},
                    "training": summary(train),
                    "training_eager": summary(train_e),
                    "captured_vs_eager": {
                        "lm-base": train["captured_vs_eager"],
                        XXL: train_x["captured_vs_eager"]},
                    "bench_torch": bench_torch.metric_line(bench),
                    "training_gradients": grads,
                    "per_head_training": {k: summary(t)
                                          for k, t in per_head.items()},
                    "per_head_gradients": grads_ph,
                    "resnet50": {m: {k: r[k] for k in (
                        "images_per_s", "median_step_ms", "mfu",
                        "device_busy_share", "max_memory_allocated",
                        "conv_kernels", "layout_transposes")}
                        for m, r in (("captured", rn), ("eager", rn_e))},
                    "resnet50_captured_vs_eager": rn["captured_vs_eager"],
                    "telemetry": {k: v for k, v in tel.items() if k not in (
                        "recorded_step_ms", "data_wait_ms",
                        "device_time_ms")},
                    "nccl_world1": dict(
                        summary(nccl), vs_phase6=nccl["vs_phase6"],
                        collectives_replays_equal=nccl["collectives"][
                            "replays_equal"]),
                    "gloo_two_ranks": {
                        "stage3_ran": gloo["stage3_ran"],
                        "checks": {r: o["checks"] for r, o in
                                   enumerate(gloo["ranks"])},
                        "runs": [{k: r[k] for k in (
                            "name", "dtype", "median_step_ms",
                            "device_busy_share", "max_memory_allocated")}
                            for r in gloo["ranks"][0]["runs"]]},
                    "search": {
                        "calibration": search["calibration"],
                        "meshes": {r["mesh"]: {k: r[k] for k in (
                            "predicted_ms", "dp_plan_ms", "configs",
                            "search_s")} for r in search["meshes"]},
                        "predicted_vs_phase6": search[
                            "predicted_vs_phase6"]},
                    "pipelined": {m: summary(t) for m, t in (
                        ("captured", train_pp), ("eager", train_ppe))},
                    "pipelined_captured_vs_eager": train_pp[
                        "captured_vs_eager"],
                    "pipelined_gradients": grads_pp,
                    "ring_blocks": ring,
                    "phase19": {
                        "median_replay_ms_per_step": {
                            k: v["median_replay_ms_per_step"]
                            for k, v in p19["chunks"].items()},
                        "peak": {k: v["max_memory_allocated"]
                                 for k, v in p19["chunks"].items()},
                        "checkpoint_bytes": p19["resume"][
                            "per-step kill"]["bytes"],
                        "warm_start": p19["warm"]["ranks"][0],
                        "wall_s": p19["wall_s"]},
                    "phase20": {
                        "natural_drift_ema": p20["a"]["natural_drift_ema"],
                        "recorded_vs_phase6": p20["a"]["vs_phase6"],
                        "sanitizer_replay_ms": p20["b"]["replay_ms"],
                        "attributed_share": p20["c"]["attributed_share"],
                        "drift": {k: p20["d"][k] for k in (
                            "advisories", "recalibrations", "captures")},
                        "serving_telemetry_vs_off": p20["f"]["vs_off"],
                        "serving_vs_phase3": p20["f"]["vs_phase3"],
                        "wall_s": p20["wall_s"]},
                    "phase21": {
                        "verify_s": {k: p21["a"][k] for k in (
                            "first_verify_s", "compile_verify_s",
                            "second_verify_s")},
                        "predicted_over_measured": {
                            k: v["predicted_over_measured"]
                            for k, v in p21["b"].items()},
                        "d_ok": p21["c"]["d_ok"],
                        "card_oom_layers": p21["c"]["card_oom_layers"],
                        "margin_layers": p21["c"]["margin_layers"],
                        "rules_on_cuda": p21["d"]["rules"],
                        "wall_s": p21["wall_s"]},
                    "phase22": {
                        "drift_decision": p22["a"]["decision"]["decision"],
                        "migrate_s": {k: [p22["b"][k]["predicted_s"],
                                          p22["b"][k]["measured_s"]]
                                      for k in ("copy", "donate")},
                        "serving_replan_split_s": p22["d"]["split_s"],
                        "wall_s": p22["wall_s"]},
                    "phase23": {
                        "decode_tokens_per_s": {
                            k: [r["decode_tokens_per_s"],
                                r["plain_decode_tokens_per_s"]]
                            for k, r in (("a f32", p23["a"]["f32"]),
                                         ("a bf16", p23["a"]["bf16"]),
                                         ("b f32", p23["b"]))},
                        "bf16_equal_streams": p23["a"]["bf16"][
                            "equal_streams"],
                        "b_decisions": p23["b"]["decision_counts"],
                        "inject_ms": p23["c"]["inject_ms"][:4],
                        "wall_s": p23["wall_s"]},
                    "total_s": detail["total_s"]}))
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main(sys.argv[1:])
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        sys.stdout.flush()
        sys.stderr.flush()
        # leave without tearing the NCCL communicators down: on 4 H100s
        # the teardown of a group whose collectives CUDA graphs captured
        # hung past the run's end (every result was written by then)
        os._exit(code)
    sys.exit(code)
