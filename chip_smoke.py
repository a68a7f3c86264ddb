#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's kernels from the
sources in the checkout at first use (CUDA C++ with nvcc into
flexflow_tpu_torch/_build/, one nvcc per source, started together:
csrc/decode_attention.cu, csrc/flash_attention.cu and
csrc/flash_attention_sm90.cu; Triton at its first launch) and drives the main paths of the lm-base
Transformer LM (vocab 32000, hidden 1024, 16 heads of dim 64, 12 layers,
seq 512; random weights from seed 0; bf16 activations over fp32 master
weights), serving and training, and the per-head flash paths: lm-base
under --flash-transposed, and lm-xxl-fsdp (hidden 4096, 32 heads of dim
128, seq 2048, vocab 32000) at 4 of its 32 layers, in both layouts.
Phases, each fatal on failure:

  1. build and device: the card's name and power limit, the torch, CUDA
     and Triton versions, the nvcc builds of csrc/*.cu;
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
     bitwise identical;
  3. serving, paged KV layout: 16 requests of random tokens (4 share a
     64-token prefix), 64 new tokens each, through FFModel ->
     build_transformer_lm -> compile -> serve() -> engine.generate; the
     launch counts are set to 0 just before and read just after;
  4. serving, contiguous KV layout: the same requests;
  5. first-step logits: the same weights in float32, one pure-decode step
     with the kernels against the same step with the plain versions;
  6. training: FFModel -> build_transformer_lm -> compile(SGD(lr=0.01),
     sparse CE, accuracy and CE metrics) -> fit over one repeated batch of
     8 x 512 random tokens, 3 warm-up and 10 timed steps; the launch
     counts are set to 0 just before and read just after: per step 12
     launches of K5, K6 and K7 and 25 of K1 and K4 (K5-K7 all of the
     "sm90" variant), no plain version, a
     finite loss that falls; tokens/s, the median step, MFU and the device
     busy share of one profiled step;
  7. training gradients: the same weights in float32, one step's
     gradients with the kernels against the same step with the plain
     versions;
  8. numbers: per kernel its time, the plain version's, one PyTorch
     call's for the same function (timed here only: the port never calls
     it; for the backward kernels the device time of the kernels of one
     SDPA backward, from the profiler) and the least time the card could
     take, at each path's shapes; K5-K8 also on their "mma" variant at
     the same shapes;
  9. training lm-base under --flash-transposed, bf16, SGD(lr=0.01), fit
     over one batch of 8 x 512, 2 warm-up and 3 timed steps: per step 12
     launches of K5 and K8 ("sm90") on the transposed layout, none of K6
     or K7, 25 of K1 and K4, no plain version;
 10. training lm-xxl-fsdp at full width and 4 layers, bf16, SGD(lr=0.01),
     fit over one batch of 4 x 2048: packed, 2 warm-up and 3 timed steps,
     per step 4 launches each of K5, K6 and K7 (head_dim 128), none of
     K8; then under --flash-transposed, as many steps, the same launches
     on the transposed layout; tokens/s, MFU, busy share;
 11. float32 gradients, kernels vs plain versions, as phase 7: lm-base
     under --flash-transposed at 2 layers, lm-xxl-fsdp at 1 layer (batch
     1 x 2048) in both layouts; then bfloat16 gradients of lm-xxl-fsdp at
     1 layer (batch 1 x 2048, packed: the sm90 K5-K7), kernels vs
     plain versions.

It exits non-zero, printing no result, without a CUDA device. The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON. `--json PATH` also writes every number of the run there.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): HBM3 rate, dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain version on the same inputs. float32: the kernels sum in
# another order (warp-interleaved keys, online softmax, Triton's row
# reduction) over up to 512 keys or 1024 features. bfloat16: P and the
# outputs are rounded to 8 bits of mantissa at different points.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Phase 5: float32 logits of lm-base (12 layers) with the kernels vs with
# the plain versions; only the kernels' summation order differs.
LOGITS_ATOL = 1e-3
# Phase 7: float32 gradients of one lm-base train step with the kernels vs
# with the plain versions. The kernels sum in another order (64-key online
# softmax against one pass, tiled f32 products, Triton row reductions), so
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
LN_ROWS = (SLOTS, SLOTS * CHUNK)  # pure-decode and prefill-chunk calls
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


CUDA_SOURCES = ("decode_attention", "flash_attention", "flash_attention_sm90")


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


def ln_inputs(dev, dtype, rows, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(rows, EMBED, generator=g) * 3 + 1).to(dev, dtype)
    s = torch.randn(EMBED, generator=g).to(dev, dtype)
    b = torch.randn(EMBED, generator=g).to(dev, dtype)
    return x, s, b


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
        for rows in LN_ROWS:
            x, s, b = ln_inputs(dev, dtype, rows, SEED + rows)
            n0 = c["layer_norm_fwd"].launches
            got = ln.layer_norm(x, s, b, 1e-5)
            torch.cuda.synchronize()
            require(c["layer_norm_fwd"].launches == n0 + 1, "K1 not launched")
            err = check_close("layer_norm_fwd", got,
                              ln.layer_norm_plain(x, s, b, 1e-5), dn, errs)
            log(f"  K1 layer_norm_fwd ({rows}, {EMBED}) {dn}: "
                f"max abs err {err:.3e}")

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
        log(f"  K2 flash_decode_attention {tuple(k.shape)} {dn}: "
            f"max abs err {err:.3e}")

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
        log(f"  K3 paged_flash_decode_attention {tuple(pk.shape)} {dn}: "
            f"max abs err {err:.3e}")
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


# K4 parity shapes: the main path's (tokens, hidden) and a ragged one
LN_BWD_SHAPES = [(8 * 512, EMBED), (4095, 1000)]


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
            x, s, _ = ln_inputs(dev, dtype, n, SEED + n)
            x = (x[:, :d] if d < EMBED else x).contiguous()
            s = s[:d].contiguous()
            dy = torch.randn(n, d, generator=torch.Generator().manual_seed(
                n)).to(dev, dtype)
            n0 = c["layer_norm_bwd"].launches
            got = ln.layer_norm_bwd(x, s, dy, 1e-5)
            torch.cuda.synchronize()
            require(c["layer_norm_bwd"].launches == n0 + 1,
                    "layer_norm_bwd not launched")
            want = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
            errs_here = [check_close("layer_norm_bwd", a, b, dn, errs)
                         for a, b in zip(got, want)]
            log(f"  K4 layer_norm_bwd ({n}, {d}) {dn}: max abs err "
                f"dx/dscale/dbias {max(errs_here):.3e}")
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


def build_lm():
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    cfg = FFConfig()
    cfg.parse_args(["--dtype", "bf16", "--seed", str(SEED),
                    "--serve-slots", str(SLOTS),
                    "--serve-max-seq", str(MAX_SEQ),
                    "--serve-prefill-chunk", str(CHUNK),
                    "--serve-kv-block-size", str(BLOCK)])
    ff = FFModel(cfg)
    build_transformer_lm(ff, TRANSFORMER_LM_ZOO["lm-base"])
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


def profiled(fn):
    """`fn()` under torch.profiler: its wall time, the device time of its
    kernels (summed; one stream runs them in order), their share of the
    wall time, the kernels that take the most, and the host-side ops that
    take the most host time of their own. Returns (those numbers, what fn
    returned)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = fn()
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
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_kernels": sum(r[1] for r in rows),
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


def serve_phase(ff, layout, prompts, vocab) -> dict:
    """Drive one serving run through `engine.generate(prompts)`: the
    launch counts are set to 0 just before and read just after. Each
    engine iteration that generate runs is timed through a wrapper on the
    engine's `step`; the first pure-decode one is profiled instead, and
    its time and tokens are left out of the rate and the medians. Returns
    the run's numbers."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters

    eng = ff.serve(kv_layout=layout, max_new_tokens=NEW_TOKENS)
    sched = eng.scheduler
    c = counters()
    step = eng.step
    decode_ms, per_step, profiled = [], {}, {}
    steps = 0

    def timed_step():
        nonlocal steps
        steps += 1
        calls0, tokens0 = eng._prefill_calls, eng._decode_tokens
        before = {k: v.launches for k, v in c.items()}
        pure_decode = (not sched.pending
                       and not any(s.prefilling for s in sched.slots))
        t0 = time.perf_counter()
        if pure_decode and not profiled:
            profiled["numbers"], done = profile_step(eng, step)
            profiled["s"] = time.perf_counter() - t0
            profiled["tokens"] = eng._decode_tokens - tokens0
            return done
        done = step()  # ends in the sampled tokens' copy to the host
        dt = (time.perf_counter() - t0) * 1e3
        if eng._prefill_calls == calls0:
            decode_ms.append(dt)
            per_step.update({k: v.launches - before[k]
                             for k, v in c.items()})
        return done

    eng.step = timed_step
    reset_counters()
    t_run = time.perf_counter()
    streams = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {k: v.launches for k, v in c.items()}
    plain = {k: v.plain_calls for k, v in c.items()}

    require(bool(profiled), f"{layout}: no pure-decode step was profiled")
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
        "requests": len(streams),
        "steps": steps,
        "prefill_calls": st["prefill_calls"],
        "pure_decode_steps": len(decode_ms),
        "decode_tokens": st["decode_tokens"],
        "wall_s": wall,
        # every sampled token over the run's wall time, both without the
        # profiled step
        "decode_tokens_per_s": ((st["decode_tokens"] - profiled["tokens"])
                                / (wall - profiled["s"])),
        "median_decode_step_ms": statistics.median(decode_ms),
        "launches": launches,
        "launches_per_decode_step": per_step,
        "profiled_decode_step": profiled["numbers"],
        "streams": streams,
    }
    if layout == "paged":
        out.update({k: st[k] for k in ("prefix_hit_rate", "cow_copies",
                                       "kv_pool_blocks",
                                       "kv_blocks_in_use_peak")})
        if not (st["prefix_shared_tokens"] > 0 and st["cow_copies"] > 0):
            raise AssertionError(f"paged: no prefix hit or no COW copy: "
                                 f"{st}")
    del eng
    torch.cuda.empty_cache()
    return out


def logits_phase(ff, layout, prompts) -> float:
    """The same weights in float32: the logits of one pure-decode step
    with the kernels vs the same step with the plain versions called in
    their place. Returns the max abs difference over the live slots."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    cfg = ff.config
    saved = (cfg.computation_dtype, cfg.allow_tensor_op_math_conversion)
    cfg.computation_dtype, cfg.allow_tensor_op_math_conversion = None, False
    try:
        eng = ff.serve(kv_layout=layout, max_new_tokens=NEW_TOKENS)
    finally:
        cfg.computation_dtype, cfg.allow_tensor_op_math_conversion = saved
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


def build_train_lm(dtype: str, tensor_op_math: bool = True, lm=None,
                   transposed: bool = False, batch: int = TRAIN_BATCH):
    """An LM (lm-base unless `lm` is given) compiled for training as
    bench.py compiles lm-base: SGD(lr=0.01), sparse CE from logits, plus
    the accuracy and CE metrics; `transposed` passes --flash-transposed."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.models import build_transformer_lm

    cfg = FFConfig()
    cfg.parse_args(["--dtype", dtype, "--seed", str(SEED), "-b", str(batch)]
                   + (["--flash-transposed"] if transposed else []))
    cfg.allow_tensor_op_math_conversion = tensor_op_math
    ff = FFModel(cfg)
    build_transformer_lm(ff, lm or lm_config())
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


def step_launches(layers: int, fused: bool) -> dict:
    """Kernel launches of one training step of an LM with `layers`
    layers: K5 per layer, K8 (`fused`) or K6 and K7 per layer, and K1 and
    K4 for the two LayerNorms of each layer and the final one."""
    return {"flash_attention_fwd": layers,
            "flash_attention_bwd_dq": 0 if fused else layers,
            "flash_attention_bwd_dkv": 0 if fused else layers,
            "flash_attention_bwd_fused": layers if fused else 0,
            "layer_norm_fwd": 2 * layers + 1,
            "layer_norm_bwd": 2 * layers + 1}


def train_phase(lm=None, *, transposed=False, fused=False,
                batch=TRAIN_BATCH, warmup=WARMUP_STEPS,
                timed_steps=TIMED_STEPS) -> dict:
    """An LM (lm-base unless `lm` is given), bf16, through `fit` over one
    repeated batch: `warmup` then `timed_steps` steps. The launch counts
    are set to 0 just before fit and read just after; each step is timed
    (host clock, synchronised on both sides) through a wrapper on the
    executor's train step, which fit calls, and must launch
    `step_launches(layers, fused)`, the flash kernels on the layout the
    flags ask for. Then one more step, profiled."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.models import transformer_lm_flops_per_token

    cfg = lm or lm_config()
    seq = cfg.sequence_length
    layout = "transposed" if transposed else "packed"
    ff = build_train_lm("bf16", lm=cfg, transposed=transposed, batch=batch)
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
    reset_counters()
    t_fit = time.perf_counter()
    ff.fit(xs, ys, epochs=1, batch_size=batch, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = {k: v.launches for k, v in c.items()}
    by_layout = {k: dict(c[k].layouts) for k in FLASH_KERNELS}
    by_variant = {k: dict(c[k].variants) for k in FLASH_KERNELS}
    plain = {k: v.plain_calls for k, v in c.items()}

    layers = cfg.num_layers
    losses = [float(v) for v in losses]
    require(len(losses) == steps, f"fit ran {len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = step_launches(layers, fused)
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
    flops_tok = transformer_lm_flops_per_token(cfg)
    staged = ff._make_batch(x, y)
    prof, _ = profiled(lambda: ff.executor.train_step(
        ff._params, ff._state, ff._opt_slots, ff._step, ff._counters,
        staged))
    metrics = ff.get_perf_metrics()
    out = {
        "model": (f"{cfg.hidden_size} hidden, {cfg.num_heads} heads of "
                  f"{cfg.hidden_size // cfg.num_heads}, {layers} layers, seq "
                  f"{seq}, vocab {cfg.vocab_size}"),
        "layout": layout,
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
        "launches": launches,
        "launches_by_layout": by_layout,
        "launches_by_variant": by_variant,
        "launches_by_variant_per_step": per_variant[-1],
        "launches_per_step": per_step[-1],
        "profiled_step": prof,
        "train_accuracy": metrics.get_accuracy(),
        "train_mean_loss": metrics.get_mean_loss(),
    }
    del ff, staged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grad_phase(lm=None, *, transposed=False, fused=False,
               batch=TRAIN_BATCH, dtype="fp32") -> dict:
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
                        transposed=transposed, batch=batch)
    xs, labels = ff._make_batch(*train_batch(cfg.vocab_size, batch,
                                             cfg.sequence_length))
    ex = ff.executor
    c = counters()
    want = step_launches(cfg.num_layers, fused)
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

    for args in arg_sets:  # warm-up: Triton compiles at its first launch
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


def kernel_numbers(dev) -> dict:
    """Times at the main path's shapes and types: bf16 activations, f32
    KV state. Returns {kernel name: numbers}."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    bf16 = torch.bfloat16
    out = {}

    # K1 at the pure-decode call: (slots, 1024) rows, the input hot in L2
    # as it comes from the op before
    x, s, b = ln_inputs(dev, bf16, SLOTS, SEED)
    n, d = x.shape
    out["layer_norm_fwd"] = timed(
        lambda *a: ln.layer_norm(*a, 1e-5),
        lambda *a: ln.layer_norm_plain(*a, 1e-5),
        lambda x, s, b: F.layer_norm(x, (d,), s, b, 1e-5),
        [(x, s, b)], [(x, s, b)],
        *bound(2 * n * d * 2 + 2 * d * 2, 8 * n * d, "bfloat16"))

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
    16x64) causal; LayerNorm rows (4096, 1024)), each cycling over four
    input sets (more than the 50 MB L2); K5-K7 also on their mma.sync
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

    sets = []
    for i in range(4):
        x, w, bias = ln_inputs(dev, bf16, n, SEED + 30 + i)
        dy = torch.randn(n, e, generator=torch.Generator().manual_seed(
            40 + i)).to(dev, bf16)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [e], w, bias, eps)
        sets.append((x, w, dy, bias, mean, rstd))
    out["layer_norm_bwd"] = timed(
        lambda x, w, dy, *_: ln.layer_norm_bwd(x, w, dy, eps),
        lambda x, w, dy, *_: ln.layer_norm_bwd_plain(x, w, dy, eps),
        lambda x, w, dy, bias, mean, rstd:
            torch.ops.aten.native_layer_norm_backward(
                dy, x, [e], mean, rstd, w, bias, [True, True, True]),
        sets, sets,
        # x, dy, scale read; dx written, dscale and dbias (f32) written;
        # ~16 f32 operations an element
        *bound(3 * n * e * 2 + e * 2 + 2 * e * 4, 16 * n * e, "float32"))
    del sets

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


LN_SRC = "flexflow_tpu_torch/kernels/_layer_norm_triton.py"
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
    ("layer_norm_fwd", "layer_norm_fwd", "triton", LN_SRC,
     "flexflow_tpu/kernels/layer_norm.py:48", "train"),
    ("flash_decode_attention", "flash_decode_attention", "cuda", DECODE_SRC,
     f"{TPU_FA}:1261", "contiguous"),
    ("paged_flash_decode_attention", "paged_flash_decode_attention", "cuda",
     DECODE_SRC, f"{TPU_FA}:1446", "paged"),
    ("layer_norm_bwd", "layer_norm_bwd", "triton", LN_SRC,
     "flexflow_tpu/kernels/layer_norm.py:59", "train"),
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


def log_train(t: dict):
    log(f"  {t['model']}, {t['layout']}, batch {t['batch']}: losses "
        f"{[round(x, 4) for x in t['losses']]}")
    timed = t["step_ms"][t["steps"] - t["timed_steps"]:]
    log(f"  {t['tokens_per_s']:.0f} tokens/s, median step "
        f"{t['median_step_ms']:.2f} ms (timed steps "
        f"{[round(x, 2) for x in timed]} ms), MFU {100 * t['mfu']:.2f}% of "
        f"{PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s, kernel time of a "
        f"profiled step {t['profiled_step']['device_busy_ms']:.2f} ms "
        f"({100 * t['device_busy_share']:.1f}% of the median step); "
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
    json_path = parser.parse_args(argv).json
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import triton

    from flexflow_tpu_torch.executor import set_float_policy

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: build and device")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"triton {triton.__version__}, python {sys.version.split()[0]}")
    set_float_policy()  # full float32 matmuls (no TF32), stated
    build_s = build_kernels()

    log("== phase 2: kernel parity on the card")
    errs = kernel_parity(dev)
    train_kernel_parity(dev, errs)

    log("== phase 3/4: serving lm-base, bf16, paged then contiguous")
    ff = build_lm()
    vocab = ff.layers[-1].params.out_channels
    prompts = make_prompts(vocab)
    runs = {}
    for layout in ("paged", "contiguous"):
        runs[layout] = serve_phase(ff, layout, prompts, vocab)
        r = runs[layout]
        log(f"  {layout}: {r['requests']} requests x {NEW_TOKENS} tokens, "
            f"{r['decode_tokens_per_s']:.1f} decode tokens/s, median "
            f"pure-decode step {r['median_decode_step_ms']:.2f} ms, "
            f"launches {r['launches']}, per pure-decode step "
            f"{r['launches_per_decode_step']}")
    same = sum(a == b for a, b in zip(runs["paged"]["streams"],
                                      runs["contiguous"]["streams"]))
    log(f"  paged and contiguous streams identical for {same} of "
        f"{len(prompts)} requests (bf16)")

    log("== phase 5: first-step logits, float32, kernels vs plain")
    logit_err = {layout: logits_phase(ff, layout, prompts[:SLOTS])
                 for layout in ("paged", "contiguous")}
    log(f"  max abs logits difference {logit_err} (bound {LOGITS_ATOL})")
    del ff
    torch.cuda.empty_cache()

    log("== phase 6: training lm-base, bf16, SGD, fit over one batch")
    train = train_phase()
    log_train(train)

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
    train_x = train_phase(xxl, batch=XXL_BATCH, warmup=2, timed_steps=3)
    log_train(train_x)
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

    # the run whose launches each row (and each case of a row) reports
    counted = {"train": train, "paged": runs["paged"],
               "contiguous": runs["contiguous"],
               "lm-base transposed": train_t, "lm-xxl packed": train_x,
               "lm-xxl transposed": train_xt}
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
    per_head = {"lm-base transposed": train_t, "lm-xxl packed": train_x,
                "lm-xxl transposed": train_xt}
    detail = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, triton=triton.__version__,
                  build_s=build_s, kernels=rows, serving=serving,
                  logits_max_abs=logit_err, streams_identical=same,
                  training=train, training_gradients=grads,
                  per_head_training=per_head,
                  per_head_gradients=grads_ph,
                  lse_entry_max_abs_err=errs["flash_attention_with_lse"],
                  total_s=time.perf_counter() - t_start)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(detail, f, indent=1)

    def summary(t):
        return {k: t[k] for k in (
            "tokens_per_s", "median_step_ms", "mfu", "device_busy_share",
            "launches_per_step")}

    log(json.dumps({"serving": serving, "logits_max_abs": logit_err,
                    "training": summary(train), "training_gradients": grads,
                    "per_head_training": {k: summary(t)
                                          for k, t in per_head.items()},
                    "per_head_gradients": grads_ph,
                    "total_s": detail["total_s"]}))
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
