"""Decode attention: kernels K2 (contiguous) and K3 (paged) in CUDA C++,
their plain PyTorch versions, and the multi-query reference.

The twin of the decode half of `flexflow_tpu/kernels/flash_attention.py`:

  decode_attention_reference (1332)        -> decode_attention_reference
  paged_decode_attention_reference (1520)  -> paged_decode_attention_reference
  flash_decode_attention (1371)            -> flash_decode_attention   (K2)
  paged_flash_decode_attention (1539)      -> paged_flash_decode_attention (K3)

The references are the multi-query path (prefill chunks, q_len > 1), in
plain torch on every device, as the JAX package runs them on every backend.
K2 and K3 are single-query; their kernel body is `csrc/decode_attention.cu`
(one templated body for both layouts; its header note gives the bound and
the design). Each has a plain version here that repeats the TPU kernel's
arithmetic in one pass: f32 logits from compute-dtype operands, `-1e30`
masking, V rows past the cursor zeroed, P rounded to V's dtype before P.V,
`acc / max(l, 1e-30)`. The Mosaic gates of the TPU wrappers (s_k < 128,
d % 128, bs % 8) are dropped: on CUDA every shape launches the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import KernelCounter

NEG_INF = -1e30

DECODE_COUNTER = KernelCounter("flash_decode_attention")
PAGED_DECODE_COUNTER = KernelCounter("paged_flash_decode_attention")

# q (compute) dtypes the CUDA body is instantiated for; the KV state it
# reads is f32 at rest (the ops' WeightSpec, the executor's state dtypes)
_Q_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_TABLE_WIDTH = 12288  # int32 entries in 48 KB of shared memory


def _split(t: torch.Tensor, s: int, h: int, d: int) -> torch.Tensor:
    return t.reshape(t.shape[0], s, h, d).transpose(1, 2)


def decode_attention_reference(q, k, v, positions, *, num_heads: int,
                               scale: float | None = None):
    """Reference attention over a KV cache: the multi-query serving path.
    q: (slots, q_len, H*hd), k/v: (slots, S, H*hd) in q's dtype,
    positions: (slots, q_len) int, query row i attends cache rows
    [0, positions[s, i]] (negative = attends nothing). Logits in f32 from
    the operands, `-1e30` masking, f32 softmax cast to q's dtype, then P.V
    with f32 accumulation and one cast."""
    slots, q_len, e = q.shape
    s_k = k.shape[1]
    h = num_heads
    d = e // h
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh, kh, vh = _split(q, q_len, h, d), _split(k, s_k, h, d), _split(v, s_k, h, d)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    key_pos = torch.arange(s_k, device=q.device)
    mask = key_pos[None, None, None, :] <= positions.long()[:, None, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(slots, q_len, e)


def paged_decode_attention_reference(q, pool_k, pool_v, page_table,
                                     positions, *, num_heads: int,
                                     scale: float | None = None):
    """Gather each slot's logical cache view from the pool through its page
    table, then the contiguous reference."""
    slots = q.shape[0]
    W = page_table.shape[1]
    bs, e = pool_k.shape[1], pool_k.shape[-1]
    tbl = page_table.long()
    kc = pool_k[tbl].reshape(slots, W * bs, e).to(q.dtype)
    vc = pool_v[tbl].reshape(slots, W * bs, e).to(q.dtype)
    return decode_attention_reference(q, kc, vc, positions,
                                      num_heads=num_heads, scale=scale)


def _single_query_plain(q, kc, vc, lengths, num_heads, scale):
    """The decode kernels' arithmetic on a logical cache view kc/vc
    (slots, S, E) of any float dtype, rounded to q's dtype on use."""
    slots, _, e = q.shape
    s_k = kc.shape[1]
    h = num_heads
    d = e // h
    kh = kc.to(q.dtype).float().reshape(slots, s_k, h, d)
    vh = vc.to(q.dtype).float().reshape(slots, s_k, h, d)
    qh = q.float().reshape(slots, h, d)
    logits = torch.einsum("bhd,bshd->bhs", qh, kh) * scale
    live = (torch.arange(s_k, device=q.device)[None, :]
            < lengths.long()[:, None])  # (slots, S)
    logits = torch.where(live[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    # zero dead V rows: stale rows may hold anything, 0*NaN would poison P.V
    vh = torch.where(live[:, :, None, None], vh, torch.zeros_like(vh))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhs,bshd->bhd", p.to(q.dtype).float(), vh)
    # an empty slot: every logit is -1e30, so p = 1 and l = S while acc = 0
    # (its V rows are zeroed), giving 0 as the kernel does; the clamp
    # mirrors the TPU kernel's
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(slots, 1, e).to(q.dtype)


def decode_attention_plain(q, k, v, lengths, *, num_heads: int,
                           scale: float | None = None):
    """Plain PyTorch version of K2. q: (slots, 1, H*hd); k/v: (slots, S,
    H*hd) cache of any float dtype; lengths: (slots,) live-key counts."""
    DECODE_COUNTER.plain_calls += 1
    scale = _check_args(q, num_heads, scale)
    return _single_query_plain(q, k, v, lengths, num_heads, scale)


def paged_decode_attention_plain(q, pool_k, pool_v, page_table, lengths, *,
                                 num_heads: int, scale: float | None = None):
    """Plain PyTorch version of K3: the page-table gather, then K2's math."""
    PAGED_DECODE_COUNTER.plain_calls += 1
    scale = _check_args(q, num_heads, scale)
    slots = q.shape[0]
    W = page_table.shape[1]
    bs, e = pool_k.shape[1], pool_k.shape[-1]
    tbl = page_table.long()
    kc = pool_k[tbl].reshape(slots, W * bs, e)
    vc = pool_v[tbl].reshape(slots, W * bs, e)
    return _single_query_plain(q, kc, vc, lengths, num_heads, scale)


def _check_args(q, num_heads, scale):
    slots, q_len, e = q.shape
    if q_len != 1:
        raise ValueError(f"decode kernel is single-query (got q_len={q_len})")
    if e % num_heads != 0:
        raise ValueError(f"embed dim {e} % heads {num_heads} != 0")
    if scale is None:
        scale = 1.0 / math.sqrt(e // num_heads)
    return float(scale)


def _library():
    from . import _build

    lib = _build.load("decode_attention")
    fn = lib.ff_decode_attention
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 6 + [ci] * 4 + [cll] * 3 + [ci] * 4
                       + [ctypes.c_float, ci, vp])
        fn.restype = ci
    return fn


def _launch(counter, q, k, v, lengths, table, *, num_heads, scale,
            stride_outer, stride_row, block_size, table_width, max_len,
            num_blocks):
    """Validate, allocate the output, launch, count. Raises on anything the
    kernel does not take; there is no fallback."""
    slots, _, e = q.shape
    hd = e // num_heads
    dev = q.device
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"decode attention: {name} on {t.device}, q on {dev}")
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"decode attention: head_dim {hd} > {_MAX_HEAD_DIM}")
    q_code = _Q_DTYPE_CODE.get(q.dtype)
    if (q_code is None or k.dtype != torch.float32
            or v.dtype != torch.float32):
        raise TypeError(f"decode attention: unsupported dtypes q={q.dtype} "
                        f"k={k.dtype} v={v.dtype} (q float32 or bfloat16 "
                        f"over a float32 cache)")
    if (q.stride(-1) != 1 or k.stride(-1) != 1
            or k.stride() != v.stride()):
        raise ValueError("decode attention: q, k, v need unit stride on the "
                         "feature axis and k, v equal strides")
    lengths = lengths.to(torch.int32).contiguous()
    if table is not None:
        if table.device != dev:
            raise ValueError(f"paged decode: table on {table.device}")
        table = table.to(torch.int32).contiguous()
    out = torch.empty((slots, 1, e), dtype=q.dtype, device=dev)
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                table.data_ptr() if table is not None else None,
                out.data_ptr(), slots, num_heads, hd, e, q.stride(0),
                stride_outer, stride_row, block_size, table_width, max_len,
                num_blocks, scale, q_code, stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: code {rc}")
    counter.launches += 1
    return out


def flash_decode_attention(q, k, v, lengths, *, num_heads: int,
                           scale: float | None = None):
    """Single-query decode attention over a contiguous cache (K2). q:
    (slots, 1, H*hd); k/v: (slots, S, H*hd), f32 at rest;
    lengths: (slots,) int live-key counts (query at position p attends p+1
    keys). CPU tensors take the plain version; CUDA tensors launch K2."""
    scale = _check_args(q, num_heads, scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, num_heads=num_heads,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_decode_attention: cache {tuple(k.shape)} "
                         f"does not match q {tuple(q.shape)}")
    return _launch(DECODE_COUNTER, q, k, v, lengths, None,
                   num_heads=num_heads, scale=scale,
                   stride_outer=k.stride(0), stride_row=k.stride(1),
                   block_size=1, table_width=0, max_len=k.shape[1],
                   num_blocks=0)


def paged_flash_decode_attention(q, pool_k, pool_v, page_table, lengths, *,
                                 num_heads: int, scale: float | None = None):
    """Single-query decode attention over a paged block pool (K3). q:
    (slots, 1, H*hd); pool_k/v: (num_blocks, bs, H*hd); page_table:
    (slots, W) int logical->physical block map; lengths: (slots,) int.
    CPU tensors take the plain version; CUDA tensors launch K3."""
    scale = _check_args(q, num_heads, scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, page_table, lengths, num_heads=num_heads,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_flash_decode_attention: unsupported device {q.device}")
    nb, bs, e = pool_k.shape
    if (pool_v.shape != pool_k.shape or e != q.shape[2]
            or page_table.shape[0] != q.shape[0]):
        raise ValueError(
            f"paged_flash_decode_attention: pool {tuple(pool_k.shape)} / "
            f"table {tuple(page_table.shape)} do not match q {tuple(q.shape)}")
    W = page_table.shape[1]
    if W > _MAX_TABLE_WIDTH:
        raise ValueError(f"paged_flash_decode_attention: page table width "
                         f"{W} > {_MAX_TABLE_WIDTH} (staged in 48 KB of "
                         f"shared memory)")
    return _launch(PAGED_DECODE_COUNTER, q, pool_k, pool_v, lengths,
                   page_table, num_heads=num_heads, scale=scale,
                   stride_outer=pool_k.stride(0),
                   stride_row=pool_k.stride(1), block_size=bs,
                   table_width=W, max_len=W * bs, num_blocks=nb)
