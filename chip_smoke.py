#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's kernels from the
sources in the checkout at first use (CUDA C++ with nvcc into
flexflow_tpu_torch/_build/, one nvcc per source, started together; Triton
at its first launch) and drives both main paths of the lm-base
Transformer LM (vocab 32000, hidden 1024, 16 heads of dim 64, 12 layers,
seq 512; random weights from seed 0; bf16 activations over fp32 master
weights): serving and training. Phases, each fatal on failure:

  1. build and device: the card's name and power limit, the torch, CUDA
     and Triton versions, the nvcc builds of csrc/*.cu;
  2. kernel parity: every kernel (K1-K7) against its plain PyTorch version
     on the card, in float32 and bfloat16, at the main paths' shapes and
     ragged ones, and the decode kernels over a float32 cache of values
     halfway between bfloat16 values (rounding on load);
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
     launches of K5, K6 and K7 and 25 of K1 and K4, no plain version, a
     finite loss that falls; tokens/s, the median step, MFU and the device
     busy share of one profiled step;
  7. training gradients: the same weights in float32, one step's
     gradients with the kernels against the same step with the plain
     versions;
  8. numbers: per kernel its time, the plain version's, one PyTorch
     call's for the same function (timed here only: the port never calls
     it) and the least time the card could take.

It exits non-zero, printing no result, without a CUDA device. The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON. `--json PATH` also writes every number of the run there.
"""

from __future__ import annotations

import argparse
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


CUDA_SOURCES = ("decode_attention", "flash_attention")


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
# causal offset s_k - s_q > 0), and the other head widths the kernels
# instantiate.
FLASH_CASES = [
    (8, 512, 512, HEADS, HEAD_DIM, True),
    (8, 512, 512, HEADS, HEAD_DIM, False),
    (2, 300, 300, 4, HEAD_DIM, True),
    (2, 130, 130, 4, HEAD_DIM, False),
    (2, 130, 300, 4, HEAD_DIM, True),
    (2, 256, 256, 4, 32, True),
    (2, 256, 256, 2, 128, True),
]
# K4 parity shapes: the main path's (tokens, hidden) and a ragged one
LN_BWD_SHAPES = [(8 * 512, EMBED), (4095, 1000)]


def flash_inputs(dev, dtype, b, s_q, s_k, heads, head_dim, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    e = heads * head_dim
    q = torch.randn(b, s_q, e, generator=g)
    k = torch.randn(b, s_k, e, generator=g)
    v = torch.randn(b, s_k, e, generator=g)
    do = torch.randn(b, s_q, e, generator=g)
    return tuple(t.to(dev, dtype) for t in (q, k, v, do))


def train_kernel_parity(dev, errs) -> dict:
    """K4-K7 against their plain versions on the card, in float32 and
    bfloat16. K6/K7 get the lse and delta the plain forward made, so each
    kernel is held on its own. Adds each kernel's max abs error to errs."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    c = counters()

    def launched(name, fn):
        n0 = c[name].launches
        out = fn()
        torch.cuda.synchronize()
        require(c[name].launches == n0 + 1, f"{name} not launched")
        return out

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n, d in LN_BWD_SHAPES:
            x, s, _ = ln_inputs(dev, dtype, n, SEED + n)
            x = (x[:, :d] if d < EMBED else x).contiguous()
            s = s[:d].contiguous()
            dy = torch.randn(n, d, generator=torch.Generator().manual_seed(
                n)).to(dev, dtype)
            got = launched("layer_norm_bwd",
                           lambda: ln.layer_norm_bwd(x, s, dy, 1e-5))
            want = ln.layer_norm_bwd_plain(x, s, dy, 1e-5)
            errs_here = [check_close("layer_norm_bwd", a, b, dn, errs)
                         for a, b in zip(got, want)]
            log(f"  K4 layer_norm_bwd ({n}, {d}) {dn}: max abs err "
                f"dx/dscale/dbias {max(errs_here):.3e}")
        for i, (b, s_q, s_k, h, hd, causal) in enumerate(FLASH_CASES):
            q, k, v, do = flash_inputs(dev, dtype, b, s_q, s_k, h, hd,
                                       SEED + 100 + i)
            kw = dict(num_heads=h, causal=causal)
            out, lse = launched("flash_attention_fwd",
                                lambda: fa.flash_attention_fwd(q, k, v, **kw))
            p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            e5 = max(check_close("flash_attention_fwd", out, p_out, dn, errs),
                     check_close("flash_attention_fwd", lse, p_lse, dn, errs))
            delta = fa.flash_delta(do, p_out, h)
            dq = launched("flash_attention_bwd_dq",
                          lambda: fa.flash_attention_bwd_dq(
                              q, k, v, do, p_lse, delta, **kw))
            e6 = check_close("flash_attention_bwd_dq", dq,
                             fa.flash_attention_bwd_dq_plain(
                                 q, k, v, do, p_lse, delta, **kw), dn, errs)
            dk, dv = launched("flash_attention_bwd_dkv",
                              lambda: fa.flash_attention_bwd_dkv(
                                  q, k, v, do, p_lse, delta, **kw))
            p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(
                q, k, v, do, p_lse, delta, **kw)
            e7 = max(check_close("flash_attention_bwd_dkv", dk, p_dk, dn,
                                 errs),
                     check_close("flash_attention_bwd_dkv", dv, p_dv, dn,
                                 errs))
            log(f"  K5/K6/K7 b{b} s{s_q}x{s_k} {h}x{hd} "
                f"{'causal' if causal else 'full'} {dn}: max abs err "
                f"{e5:.3e} / {e6:.3e} / {e7:.3e}")
            del q, k, v, do, out, lse, p_out, p_lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return errs


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


def build_train_lm(dtype: str, tensor_op_math: bool = True):
    """lm-base compiled for training as bench.py compiles it: SGD(lr=0.01),
    sparse CE from logits, plus the accuracy and CE metrics."""
    from flexflow_tpu_torch import (
        FFConfig,
        FFModel,
        LossType,
        MetricsType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        build_transformer_lm,
    )

    cfg = FFConfig()
    cfg.parse_args(["--dtype", dtype, "--seed", str(SEED),
                    "-b", str(TRAIN_BATCH)])
    cfg.allow_tensor_op_math_conversion = tensor_op_math
    ff = FFModel(cfg)
    build_transformer_lm(ff, TRANSFORMER_LM_ZOO["lm-base"])
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY,
                        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def train_batch(vocab: int):
    """One batch of random tokens and labels from the seed."""
    rs = np.random.RandomState(SEED)
    toks = rs.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    pos = np.tile(np.arange(TRAIN_SEQ, dtype=np.int32), (TRAIN_BATCH, 1))
    labels = rs.randint(0, vocab,
                        (TRAIN_BATCH, TRAIN_SEQ, 1)).astype(np.int32)
    return {"tokens": toks, "positions": pos}, labels


def train_phase() -> dict:
    """lm-base, bf16, through `fit` over one repeated batch: WARMUP_STEPS
    then TIMED_STEPS steps. The launch counts are set to 0 just before fit
    and read just after; each step is timed (host clock, synchronised on
    both sides) through a wrapper on the executor's train step, which fit
    calls. Then one more step, profiled."""
    import torch

    from flexflow_tpu_torch.kernels import counters, reset_counters
    from flexflow_tpu_torch.models import (
        TRANSFORMER_LM_ZOO,
        transformer_lm_flops_per_token,
    )

    cfg = TRANSFORMER_LM_ZOO["lm-base"]
    ff = build_train_lm("bf16")
    x, y = train_batch(cfg.vocab_size)
    steps = WARMUP_STEPS + TIMED_STEPS
    xs = {k: np.concatenate([v] * steps) for k, v in x.items()}
    ys = np.concatenate([y] * steps)
    c = counters()
    step_fn = ff.executor.build_train_step()
    losses, step_ms, per_step = [], [], []

    def timed_step(*args):
        before = {k: v.launches for k, v in c.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[-1])
        per_step.append({k: v.launches - before[k] for k, v in c.items()})
        return out

    ff.executor._train_step = timed_step
    reset_counters()
    t_fit = time.perf_counter()
    ff.fit(xs, ys, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
           verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = {k: v.launches for k, v in c.items()}
    plain = {k: v.plain_calls for k, v in c.items()}

    layers = cfg.num_layers
    losses = [float(v) for v in losses]
    require(len(losses) == steps, f"fit ran {len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "layer_norm_fwd": 2 * layers + 1,
            "layer_norm_bwd": 2 * layers + 1}
    for i, n in enumerate(per_step):
        got = {k: n[k] for k in want}
        require(got == want, f"step {i}: launches {got}, want {want}")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    timed = step_ms[WARMUP_STEPS:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = TIMED_STEPS * tokens / (sum(timed) / 1e3)
    flops_tok = transformer_lm_flops_per_token(cfg)
    batch = ff._make_batch(x, y)
    prof, _ = profiled(lambda: ff.executor.train_step(
        ff._params, ff._state, ff._opt_slots, ff._step, ff._counters,
        batch))
    metrics = ff.get_perf_metrics()
    out = {
        "steps": steps,
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
        "launches_per_step": per_step[-1],
        "profiled_step": prof,
        "train_accuracy": metrics.get_accuracy(),
        "train_mean_loss": metrics.get_mean_loss(),
    }
    del ff, batch
    torch.cuda.empty_cache()
    return out


def grad_phase() -> dict:
    """The same weights in float32 (no tensor-op rounding): one train
    step's gradients with the kernels vs the same step with the plain
    versions called in their place. Returns the worst tensor's name and
    its max abs and relative differences."""
    import torch

    from flexflow_tpu_torch.kernels import counters
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln
    from flexflow_tpu_torch.models import TRANSFORMER_LM_ZOO

    cfg = TRANSFORMER_LM_ZOO["lm-base"]
    layers = cfg.num_layers
    ff = build_train_lm("fp32", tensor_op_math=False)
    xs, labels = ff._make_batch(*train_batch(cfg.vocab_size))
    ex = ff.executor
    c = counters()
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "layer_norm_fwd", "layer_norm_bwd")
    want = dict(zip(names, [layers] * 3 + [2 * layers + 1] * 2))

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
    require(rel <= GRAD_RTOL, f"float32 gradient of {name} differs by "
            f"{err:.3e} ({rel:.3e} of its layer's largest gradient entry, "
            f"bound {GRAD_RTOL})")
    tensors = sum(len(ws) for ws in with_plain.values())
    del ff, with_kernels, with_plain
    torch.cuda.empty_cache()
    return {"worst_tensor": name, "max_abs_diff": err,
            "relative_to_largest": rel, "bound_relative": GRAD_RTOL,
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
          bound_by) -> dict:
    """Device times of the kernel, its plain version and (when given) the
    library call, with the bound."""
    ms, eager_ms = time_ms(kernel, arg_sets)
    return dict(ms=ms, eager_ms=eager_ms,
                plain_ms=time_ms(plain, arg_sets)[0],
                library_ms=(time_ms(library, library_sets)[0]
                            if library is not None else None),
                bound_ms=bound_ms, bound_by=bound_by)


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
    input sets (more than the 50 MB L2). Library yardsticks, timed only:
    `native_layer_norm_backward` for K4; `scaled_dot_product_attention`
    (causal) on the (b, h, s, d) view for K5, and its backward through
    autograd for K6 and K7 together (timed eagerly between CUDA events:
    autograd is not captured in a graph here)."""
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
    lib_sets = []
    for q, k, v, do, *_ in sets:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_sets.append((sdpa(*leaves), leaves, view(do)))
    lib_bwd = time_ms(
        lambda o, leaves, g: torch.autograd.grad(o, leaves, g,
                                                 retain_graph=True),
        lib_sets, graph=False)[0]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        out[name]["library_ms"] = lib_bwd
        out[name]["library_is"] = "sdpa backward (dq, dk, dv together)"
    del sets, lib_sets
    torch.cuda.empty_cache()
    return out


KERNELS = [
    ("layer_norm_fwd", "triton", "flexflow_tpu_torch/kernels/_layer_norm_triton.py",
     "flexflow_tpu/kernels/layer_norm.py:48"),
    ("flash_decode_attention", "cuda", "flexflow_tpu_torch/csrc/decode_attention.cu",
     "flexflow_tpu/kernels/flash_attention.py:1261"),
    ("paged_flash_decode_attention", "cuda",
     "flexflow_tpu_torch/csrc/decode_attention.cu",
     "flexflow_tpu/kernels/flash_attention.py:1446"),
    ("layer_norm_bwd", "triton", "flexflow_tpu_torch/kernels/_layer_norm_triton.py",
     "flexflow_tpu/kernels/layer_norm.py:59"),
    ("flash_attention_fwd", "cuda", "flexflow_tpu_torch/csrc/flash_attention.cu",
     "flexflow_tpu/kernels/flash_attention.py:705"),
    ("flash_attention_bwd_dq", "cuda",
     "flexflow_tpu_torch/csrc/flash_attention.cu",
     "flexflow_tpu/kernels/flash_attention.py:808"),
    ("flash_attention_bwd_dkv", "cuda",
     "flexflow_tpu_torch/csrc/flash_attention.cu",
     "flexflow_tpu/kernels/flash_attention.py:854"),
]


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
    log(f"  losses {[round(x, 4) for x in train['losses']]}")
    log(f"  {train['tokens_per_s']:.0f} tokens/s, median step "
        f"{train['median_step_ms']:.2f} ms, MFU {100 * train['mfu']:.2f}% "
        f"of {PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s, kernel time "
        f"of a profiled step {train['profiled_step']['device_busy_ms']:.2f} "
        f"ms ({100 * train['device_busy_share']:.1f}% of the median step); "
        f"launches per step {train['launches_per_step']}")

    log("== phase 7: training gradients, float32, kernels vs plain")
    grads = grad_phase()
    log(f"  worst of {grads['tensors']} gradients: {grads['worst_tensor']}, "
        f"max abs diff {grads['max_abs_diff']:.3e} "
        f"({grads['relative_to_largest']:.3e} of its layer's largest "
        f"gradient entry, bound {GRAD_RTOL})")

    log("== phase 8: kernel times at the main paths' shapes")
    nums = kernel_numbers(dev)
    nums.update(train_kernel_numbers(dev))
    # the run whose launches each kernel's row reports
    counted = {"layer_norm_fwd": train,
               "paged_flash_decode_attention": runs["paged"],
               "flash_decode_attention": runs["contiguous"]}
    rows = []
    for name, route, source, replaces in KERNELS:
        run = counted.get(name, train)
        per_step = run.get("launches_per_step",
                           run.get("launches_per_decode_step"))
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=run["launches"][name], max_abs_err=errs[name],
            launches_per_step=per_step[name], **nums[name]))
        log(f"  {name}: {nums[name]['ms']:.4f} ms (bound "
            f"{nums[name]['bound_ms']:.4f} by {nums[name]['bound_by']}, "
            f"plain {nums[name]['plain_ms']:.4f}, library "
            f"{nums[name]['library_ms']})")
    serving = {
        layout: {k: v for k, v in r.items() if k != "streams"}
        for layout, r in runs.items()}
    detail = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, triton=triton.__version__,
                  build_s=build_s, kernels=rows, serving=serving,
                  logits_max_abs=logit_err, streams_identical=same,
                  training=train, training_gradients=grads,
                  total_s=time.perf_counter() - t_start)
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(detail, f, indent=1)
    train_summary = {k: train[k] for k in (
        "tokens_per_s", "median_step_ms", "mfu", "device_busy_share",
        "launches_per_step")}
    log(json.dumps({"serving": serving, "logits_max_abs": logit_err,
                    "training": train_summary, "training_gradients": grads,
                    "total_s": detail["total_s"]}))
    log(card)
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
