"""Flash attention: the training kernels K5 (forward), K6 (backward dq),
K7 (backward dk/dv) and K8 (fused backward) on both layouts, and the
decode kernels K2 (contiguous) and K3 (paged), all CUDA C++, each beside
its plain PyTorch version; plus the multi-query decode reference.

The twin of `flexflow_tpu/kernels/flash_attention.py`:

  flash_attention_packed (1212), the _flash_packed custom VJP (1189)
                                           -> flash_attention_packed
  flash_attention (1608), the _flash custom VJP (590)
                                           -> flash_attention
  flash_attention_with_lse (657), the _flash_lse custom VJP (619)
                                           -> flash_attention_with_lse
  _flash_kernel_grouped (705) via _flash_fwd_packed (965), _flash_kernel
  (117) via _flash_fwd (222) and _flash_fwd_packed
                                           -> flash_attention_fwd      (K5)
  _bwd_dq_kernel_grouped (808), _bwd_dq_kernel (351) via _flash_bwd (505)
  and _flash_bwd_packed (1087)             -> flash_attention_bwd_dq   (K6)
  _bwd_dkv_kernel_grouped (854), _bwd_dkv_kernel (392), the same callers
                                           -> flash_attention_bwd_dkv  (K7)
  _bwd_single_tile_kernel (442) via _flash_bwd_single_tile (478) and
  _flash_bwd_packed                        -> flash_attention_bwd_fused (K8)
  decode_attention_reference (1332)        -> decode_attention_reference
  paged_decode_attention_reference (1520)  -> paged_decode_attention_reference
  flash_decode_attention (1371)            -> flash_decode_attention   (K2)
  paged_flash_decode_attention (1539)      -> paged_flash_decode_attention (K3)

Training: the three entries are one `torch.autograd.Function`, on the
(b, s, h*d) projection layout ("packed", with `num_heads`) or on
(b, h, s, d) ("transposed"). Every kernel function takes either layout:
the kernels address heads through element strides, so neither layout is
copied into the other. The forward calls K5 (out and the f32 row
log-sum-exp lse, kept as (b, h, s)); the backward computes
delta = rowsum(dO*O) in plain torch, as the JAX package does outside
Pallas (521-526, 1097-1102), less the lse cotangent for the lse entry,
then `flash_attention_bwd` picks the kernels the JAX package's backward
runs at that shape: the fused single-tile K8 where the sequence fits one
512-row block and a block holds one head (every transposed shape; packed
head_dim % 128 == 0), else K6 and K7. The kernel body is
`csrc/flash_attention.cu` (its header note gives the bounds and the
design). The plain versions repeat the TPU kernels' arithmetic in one pass
over all keys, as the JAX kernel runs a sequence of one block: f32 logits
from the operands times scale, `-1e30` masking with the causal offset
s_k - s_q, p rounded to V's dtype before P.V, out = acc / l cast once,
lse = m + log(l); backward p = exp(s - lse) (0 where masked),
ds = p * (dp - delta) * scale, dq = round(ds).k, dk = round(ds)^T.q,
dv = round(p)^T.dO, each accumulated in f32 and cast once. The Mosaic
gates of the TPU wrappers (s < 128, d % 8, the packed entry's transposed
fallback; 668, 1236-1243, 1628) are dropped: on CUDA every shape with
head_dim <= 128 launches the kernels. Causal attention with s_q > s_k is
refused on every device: the JAX package sends that shape to sdpa_xla,
whose rows with no live key average V over all keys, and self-attention
never produces it.

Decode: the references are the multi-query path (prefill chunks, q_len > 1), in
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
FLASH_FWD_COUNTER = KernelCounter("flash_attention_fwd")
FLASH_BWD_DQ_COUNTER = KernelCounter("flash_attention_bwd_dq")
FLASH_BWD_DKV_COUNTER = KernelCounter("flash_attention_bwd_dkv")
FLASH_BWD_FUSED_COUNTER = KernelCounter("flash_attention_bwd_fused")

# dtypes the training kernels are instantiated for (q, k, v alike)
_FLASH_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_MAX_HEAD_DIM = 128

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


# ------------------------------------------------------------------ training

# The JAX package's default flash blocks (`flash_attention` 1610, 1214): a
# sequence that fits one block takes its fused single-tile backward.
SINGLE_TILE = 512


def _causal_live(s_q: int, s_k: int, device) -> torch.Tensor:
    """(s_q, s_k) bool: query i sees key j iff i + (s_k - s_q) >= j."""
    return torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril(
        s_k - s_q)


def _check(q, k, v, num_heads, causal, scale) -> tuple[float, int]:
    """Shapes and dtypes every device takes, on either layout: packed
    (b, s, h*d) with `num_heads`, or transposed (b, h, s, d). Returns
    (scale, heads)."""
    if q.dim() == 3:
        if num_heads is None:
            raise ValueError("packed flash attention needs num_heads")
        b, _, e = q.shape
        if (k.dim() != 3 or k.shape != v.shape or k.shape[0] != b
                or k.shape[2] != e):
            raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                             f"{tuple(v.shape)} do not match q "
                             f"{tuple(q.shape)}")
        if e % num_heads != 0:
            raise ValueError(f"embed dim {e} % heads {num_heads} != 0")
        h, d = num_heads, e // num_heads
    elif q.dim() == 4:
        b, h, _, d = q.shape
        if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
                or k.shape[1] != h or k.shape[3] != d):
            raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                             f"{tuple(v.shape)} do not match q "
                             f"{tuple(q.shape)}")
        if num_heads not in (None, h):
            raise ValueError(f"num_heads {num_heads} but q has {h} heads")
    else:
        raise ValueError("flash attention takes (batch, seq, heads*head_dim)"
                         " or (batch, heads, seq, head_dim) tensors, got "
                         f"{tuple(q.shape)}")
    s_q, s_k = q.shape[-2], k.shape[-2]
    if causal and s_q > s_k:
        raise ValueError(
            f"causal flash attention needs s_q <= s_k (got {s_q} > {s_k}): "
            f"rows with no live key follow sdpa_xla's uniform-over-all-keys "
            f"convention in the JAX package; use impl='xla' for that shape")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return float(scale), h


def _layout(t: torch.Tensor) -> str:
    return "packed" if t.dim() == 3 else "transposed"


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """A (b, h, s, d) f32 view of either layout's values."""
    if t.dim() == 4:
        return t.float()
    b, s, e = t.shape
    return t.float().reshape(b, s, h, e // h).transpose(1, 2)


def _merge(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) values back to `like`'s layout and dtype."""
    if like.dim() == 3:
        b, h, s, d = t.shape
        t = t.transpose(1, 2).reshape(b, s, h * d)
    return t.to(like.dtype)


def packed_heads_per_block(head_dim: int, num_heads: int) -> int:
    """The JAX package's `_packed_heads_per_block` (693): 1 is its
    one-head-per-block path (which has the fused single-tile backward), >1
    its grouped narrow-head path (which does not)."""
    if head_dim % 128 == 0:
        return 1
    if 128 % head_dim == 0 and num_heads % (128 // head_dim) == 0:
        return 128 // head_dim
    return num_heads


def fused_backward_applies(q, k, num_heads: int | None = None) -> bool:
    """Whether the JAX package runs its fused single-tile backward at this
    shape (`_flash_bwd` 531, `_flash_bwd_packed` 1115): the sequence fits
    one default block and, on the packed layout, a block holds one head."""
    if q.shape[-2] > SINGLE_TILE or k.shape[-2] > SINGLE_TILE:
        return False
    if q.dim() == 4:
        return True
    return packed_heads_per_block(q.shape[2] // num_heads, num_heads) == 1


def flash_attention_fwd_plain(q, k, v, *, num_heads: int | None = None,
                              causal: bool = False,
                              scale: float | None = None):
    """Plain PyTorch version of K5: (out in q's layout and dtype, lse (b,
    h, s_q) f32), the one-pass softmax of the TPU kernel."""
    FLASH_FWD_COUNTER.plain_calls += 1
    scale, h = _check(q, k, v, num_heads, causal, scale)
    logits = torch.matmul(_heads(q, h), _heads(k, h).transpose(-1, -2))
    logits = logits * scale
    if causal:
        logits = torch.where(
            _causal_live(q.shape[-2], k.shape[-2], q.device), logits,
            torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _heads(v, h))
    lse = (m + torch.log(l)).squeeze(-1)
    return _merge(acc / l, q), lse


def _bwd_plain_tiles(q, k, v, dout, lse, delta, h, causal, scale):
    """The backward recompute (`_bwd_tile_math`) over all keys at once:
    p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) * scale."""
    s = torch.matmul(_heads(q, h), _heads(k, h).transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_live(q.shape[-2], k.shape[-2], q.device), p,
                        torch.zeros_like(p))
    dp = torch.matmul(_heads(dout, h), _heads(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _dq_plain(ds, q, k, h):
    """dq = round(ds) . k, accumulated in f32, cast once."""
    return _merge(torch.matmul(ds.to(k.dtype).float(), _heads(k, h)), q)


def _dkv_plain(p, ds, q, k, v, dout, h):
    """dk = round(ds)^T . q and dv = round(p)^T . dO, each cast once."""
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _heads(q, h))
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      _heads(dout, h))
    return _merge(dk, k), _merge(dv, v)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, *,
                                 num_heads: int | None = None,
                                 causal: bool = False,
                                 scale: float | None = None):
    """Plain PyTorch version of K6: dq in q's layout and dtype."""
    FLASH_BWD_DQ_COUNTER.plain_calls += 1
    scale, h = _check(q, k, v, num_heads, causal, scale)
    _, ds = _bwd_plain_tiles(q, k, v, dout, lse, delta, h, causal, scale)
    return _dq_plain(ds, q, k, h)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, *,
                                  num_heads: int | None = None,
                                  causal: bool = False,
                                  scale: float | None = None):
    """Plain PyTorch version of K7: (dk, dv) in k's and v's layout and
    dtypes."""
    FLASH_BWD_DKV_COUNTER.plain_calls += 1
    scale, h = _check(q, k, v, num_heads, causal, scale)
    p, ds = _bwd_plain_tiles(q, k, v, dout, lse, delta, h, causal, scale)
    return _dkv_plain(p, ds, q, k, v, dout, h)


def flash_attention_bwd_fused_plain(q, k, v, dout, lse, delta, *,
                                    num_heads: int | None = None,
                                    causal: bool = False,
                                    scale: float | None = None):
    """Plain PyTorch version of K8 (`_bwd_single_tile_kernel`): p and ds
    formed once over all keys, then (dq, dk, dv) as K6 and K7 form them."""
    FLASH_BWD_FUSED_COUNTER.plain_calls += 1
    scale, h = _check(q, k, v, num_heads, causal, scale)
    p, ds = _bwd_plain_tiles(q, k, v, dout, lse, delta, h, causal, scale)
    return (_dq_plain(ds, q, k, h), *_dkv_plain(p, ds, q, k, v, dout, h))


def flash_delta(dout: torch.Tensor, out: torch.Tensor,
                num_heads: int | None = None) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, (b, h, s) f32, from the stored
    output on either layout (`flash_attention.py:521-524`, 1097-1102)."""
    prod = dout.float() * out.float()
    if out.dim() == 4:
        return prod.sum(-1).contiguous()
    b, s, e = out.shape
    return prod.reshape(b, s, num_heads, e // num_heads).sum(-1).transpose(
        1, 2).contiguous()


# pointer arguments of each C entry point
_FLASH_FNS = {
    "ff_flash_attention_fwd": 5,
    "ff_flash_attention_bwd_dq": 7,
    "ff_flash_attention_bwd_dkv": 8,
    "ff_flash_attention_bwd_fused": 10,
}


def _flash_library(name: str):
    from . import _build

    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * _FLASH_FNS[name] + [ci] * 5 + [cll] * 6
                       + [ctypes.c_float, ci, ci, vp])
        fn.restype = ci
    return fn


def _strides(t: torch.Tensor, h: int) -> tuple[int, int, int]:
    """Element strides of (batch, head, row) on either layout."""
    if t.dim() == 3:
        return t.stride(0), t.shape[2] // h, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _check_rows(q, h, *rows):
    want = (q.shape[0], h, q.shape[-2])
    for t in rows:
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"flash attention: lse and delta must be "
                             f"contiguous {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _flash_launch(name, counter, args, q_group, k_group, h, causal, scale):
    """Validate, launch one training kernel on its pointer `args` (outputs
    allocated by the caller), count the launch by layout. q_group (q, dO,
    out, dq) and k_group (k, v, dk, dv) each share one set of strides with
    unit stride on the head dim. Raises on anything the kernel does not
    take."""
    q, k = q_group[0], k_group[0]
    dev = q.device
    for t in args:
        if t.device != dev:
            raise ValueError(f"flash attention: a tensor is on {t.device}, "
                             f"q on {dev}")
    for group in (q_group, k_group):
        for t in group:
            if t.stride(-1) != 1 or t.stride() != group[0].stride():
                raise ValueError(
                    "flash attention: q, dO, out, dq (and k, v, dk, dv) "
                    "must share their strides, with unit stride on the "
                    "head dim")
    code = _FLASH_DTYPE_CODE.get(q.dtype)
    if code is None:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    hd = q.shape[-1] if q.dim() == 4 else q.shape[2] // h
    if hd > _FLASH_MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head_dim <= "
                         f"{_FLASH_MAX_HEAD_DIM}, got {hd}")
    fn = _flash_library(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*[t.data_ptr() for t in args], q.shape[0], h, q.shape[-2],
                k.shape[-2], hd, *_strides(q, h), *_strides(k, h), scale,
                int(causal), code, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: code {rc}")
    counter.launched(_layout(q))


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return q.device.type


def flash_attention_fwd(q, k, v, *, num_heads: int | None = None,
                        causal: bool = False, scale: float | None = None):
    """Flash attention forward on either layout: (out, lse (b, h, s_q)
    f32). CPU tensors take the plain version; CUDA tensors launch K5."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, num_heads=num_heads,
                                         causal=causal, scale=scale)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], h, q.shape[-2]), dtype=torch.float32,
                      device=q.device)
    _flash_launch("ff_flash_attention_fwd", FLASH_FWD_COUNTER,
                  [q, k, v, out, lse], [q, out], [k, v], h, causal, scale)
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *,
                           num_heads: int | None = None,
                           causal: bool = False,
                           scale: float | None = None):
    """dq of flash attention on either layout. CPU tensors take the plain
    version; CUDA tensors launch K6."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dq_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    _check_rows(q, h, lse, delta)
    dq = torch.empty_like(q)
    _flash_launch("ff_flash_attention_bwd_dq", FLASH_BWD_DQ_COUNTER,
                  [q, k, v, dout, lse, delta, dq], [q, dout, dq], [k, v], h,
                  causal, scale)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *,
                            num_heads: int | None = None,
                            causal: bool = False,
                            scale: float | None = None):
    """(dk, dv) of flash attention on either layout. CPU tensors take the
    plain version; CUDA tensors launch K7."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dkv_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    _check_rows(q, h, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("ff_flash_attention_bwd_dkv", FLASH_BWD_DKV_COUNTER,
                  [q, k, v, dout, lse, delta, dk, dv], [q, dout],
                  [k, v, dk, dv], h, causal, scale)
    return dk, dv


def flash_attention_bwd_fused(q, k, v, dout, lse, delta, *,
                              num_heads: int | None = None,
                              causal: bool = False,
                              scale: float | None = None):
    """(dq, dk, dv) of flash attention in one kernel on either layout.
    CPU tensors take the plain version; CUDA tensors launch K8, which
    sums dq in an f32 (b, h, s_q, d) scratch allocated here."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_fused_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    _check_rows(q, h, lse, delta)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    hd = q.shape[-1] if q.dim() == 4 else q.shape[2] // h
    scratch = torch.empty((q.shape[0], h, q.shape[-2], hd),
                          dtype=torch.float32, device=q.device)
    _flash_launch("ff_flash_attention_bwd_fused", FLASH_BWD_FUSED_COUNTER,
                  [q, k, v, dout, lse, delta, dq, dk, dv, scratch],
                  [q, dout, dq], [k, v, dk, dv], h, causal, scale)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, dout, lse, delta, *,
                        num_heads: int | None = None, causal: bool = False,
                        scale: float | None = None):
    """(dq, dk, dv), through the kernels the JAX package's backward would
    run at this shape: K8 where it runs `_bwd_single_tile_kernel`
    (`fused_backward_applies`), else K6 and K7."""
    kw = dict(num_heads=num_heads, causal=causal, scale=scale)
    if fused_backward_applies(q, k, num_heads):
        return flash_attention_bwd_fused(q, k, v, dout, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw))


class _Flash(torch.autograd.Function):
    """The JAX package's `_flash` (590), `_flash_lse` (619) and
    `_flash_packed` (1189) custom VJPs in one: forward K5; backward delta
    = rowsum(dO*O), less the lse cotangent when lse is an output
    (`delta_adj`, 505-511), then `flash_attention_bwd`. `num_heads` is None
    on the transposed layout."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal, scale, with_lse):
        # the kernels' stride contract: q, dO, out and dq share strides, and
        # the backward's dO is made contiguous; a (b, h, s, d) view of
        # packed activations becomes a (b, h, s, d) copy here
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, num_heads=num_heads,
                                       causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (num_heads, causal, scale)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, g, g_lse=None):
        q, k, v, out, lse = ctx.saved_tensors
        num_heads, causal, scale = ctx.meta
        g = g.contiguous()
        delta = flash_delta(g, out, num_heads)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq, dk, dv = flash_attention_bwd(q, k, v, g, lse, delta,
                                         num_heads=num_heads, causal=causal,
                                         scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q, k, v, *, num_heads: int, causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """Fused attention on (batch, seq, heads*head_dim) activations, the
    qkv projections' own layout, differentiable in q, k and v."""
    if q.dim() != 3:
        raise ValueError(f"flash_attention_packed takes (batch, seq, "
                         f"heads*head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check(q, k, v, num_heads, causal, scale)
    return _Flash.apply(q, k, v, num_heads, causal, scale, False)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention on (batch, heads, seq, head_dim) tensors,
    differentiable in q, k and v."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes (batch, heads, seq, "
                         f"head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check(q, k, v, None, causal, scale)
    return _Flash.apply(q, k, v, None, causal, scale, False)


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: float | None = None):
    """Fused attention on (batch, heads, seq, head_dim) tensors returning
    (out, lse), lse the (b, h, s_q) f32 row log-sum-exp of the scaled,
    masked logits; differentiable in both outputs (ring attention merges
    blocks by their lse)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention_with_lse takes (batch, heads, "
                         f"seq, head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check(q, k, v, None, causal, scale)
    return _Flash.apply(q, k, v, None, causal, scale, True)
