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
head_dim % 128 == 0), else K6 and K7. On CUDA, K5-K8 each take one of
three hand-written variants by shape (`flash_variant`): "sm90" (wgmma, TMA
and warp-specialised warpgroups, `csrc/flash_attention_sm90.cu`; K8 as a
thread-block cluster per (b, h)) for bf16 at head_dim 64 or 128 whose
strides and pointers TMA takes, else "mma" (bf16, mma.sync) or "simt"
(f32) in `csrc/flash_attention.cu`; each source's header note gives the
bounds and the design. The plain versions repeat the TPU kernels'
arithmetic in one pass over all keys, as the JAX kernel runs a sequence
of one block: f32 logits from the operands times scale, `-1e30` masking
with the causal offset s_k - s_q, p rounded to V's dtype before P.V,
out = acc / l cast once, lse = m + log(l); backward p = exp(s - lse) (0
where masked), ds = p * (dp - delta) * scale, dq = round(ds).k, dk =
round(ds)^T.q, dv = round(p)^T.dO, each accumulated in f32 and cast
once. The Mosaic
gates of the TPU wrappers (s < 128, d % 8, the packed entry's transposed
fallback; 668, 1236-1243, 1628) are dropped: on CUDA every shape with
head_dim <= 128 launches the kernels. Causal attention with s_q > s_k is
semantics the JAX entries route to their XLA path on every backend, and
so do the three entries here, on every device: `sdpa_xla` (the packed
entry splits the heads first) and, for the (out, lse) entry,
`attn_reference_lse`, whose rows with no live key average V over all
keys; autograd gives their gradients and no kernel runs. The kernel
functions themselves refuse that shape.

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


def _check_shapes(q, k, v, num_heads, scale) -> tuple[float, int]:
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
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return float(scale), h


def _rows_without_keys(q, k, causal) -> bool:
    """Causal with s_q > s_k: the first rows see no key."""
    return causal and q.shape[-2] > k.shape[-2]


def _check(q, k, v, num_heads, causal, scale) -> tuple[float, int]:
    """`_check_shapes`, and the kernel functions' own contract: no causal
    rows without a live key (the entries route that shape to the XLA
    path, as the JAX package does)."""
    if _rows_without_keys(q, k, causal):
        raise ValueError(
            f"causal flash kernels need s_q <= s_k (got {q.shape[-2]} > "
            f"{k.shape[-2]}): the entries route that shape to sdpa_xla, as "
            f"the JAX package does")
    return _check_shapes(q, k, v, num_heads, scale)


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


# pointer arguments of each C entry point of csrc/flash_attention.cu
_FLASH_FNS = {
    "ff_flash_attention_fwd": 5,
    "ff_flash_attention_bwd_dq": 7,
    "ff_flash_attention_bwd_dkv": 8,
    "ff_flash_attention_bwd_fused": 10,
}
# The sm90 twins in csrc/flash_attention_sm90.cu: their entry point, and
# the rows of one TMA box of each operand they load (the leading pointer
# arguments): K5 q, k, v; K6, K7 and K8 q, k, v, dO
_SM90_FNS = {
    "ff_flash_attention_fwd": ("ff_flash_attention_fwd_sm90",
                               (128, 128, 128)),
    "ff_flash_attention_bwd_dq": ("ff_flash_attention_bwd_dq_sm90",
                                  (128, 64, 64, 128)),
    "ff_flash_attention_bwd_dkv": ("ff_flash_attention_bwd_dkv_sm90",
                                   (64, 128, 128, 64)),
    "ff_flash_attention_bwd_fused": ("ff_flash_attention_bwd_fused_sm90",
                                     (64, 128, 128, 64)),
}
# The sm90 K8 runs one thread-block cluster per (b, h), a block for each
# 128 keys; it takes clusters of at most 4 blocks (s_k <= 512, every
# shape the single-tile backward serves)
SM90_KEYS_PER_BLOCK = 128
SM90_MAX_CLUSTER = 4
_SM90_HEAD_DIMS = (64, 128)
_TMA_BOX = 64  # bf16 columns of one 128-byte swizzled box


def _flash_library(name: str):
    from . import _build

    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * _FLASH_FNS[name] + [ci] * 5 + [cll] * 6
                       + [ctypes.c_float, ci, ci, vp])
        fn.restype = ci
    return fn


def _sm90_library(name: str, pointers: int):
    from . import _build

    fn = getattr(_build.load("flash_attention_sm90"), name)
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * (pointers + 1)  # the tensors, then geo
                       + [ci] * 5 + [cll] * 6 + [ctypes.c_float, ci, vp])
        fn.restype = ci
    return fn


def _strides(t: torch.Tensor, h: int) -> tuple[int, int, int]:
    """Element strides of (batch, head, row) on either layout."""
    if t.dim() == 3:
        return t.stride(0), t.shape[2] // h, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _head_dim(t: torch.Tensor, h: int) -> int:
    return t.shape[-1] if t.dim() == 4 else t.shape[2] // h


def tma_geometry(t: torch.Tensor, num_heads: int, rows: int):
    """The TMA tensor map of one bf16 operand of the sm90 kernels, on
    either layout: (dims, byte strides, box), innermost first. The dims
    are the head dim, then head and row in the order of their strides,
    then batch: (d, h, s, b) for the packed (b, s, h*d), (d, s, h, b) for
    (b, h, s, d). The strides are those of the three outer dims; the box
    is 64 columns (128 bytes, the swizzle's width) of `rows` rows of one
    head."""
    h = num_heads if t.dim() == 3 else t.shape[1]
    sb, sh, sr = _strides(t, h)
    b, s, d = t.shape[0], t.shape[-2], _head_dim(t, h)
    size = t.element_size()
    if sh <= sr:
        return ((d, h, s, b), (sh * size, sr * size, sb * size),
                (_TMA_BOX, 1, rows, 1))
    return ((d, s, h, b), (sr * size, sh * size, sb * size),
            (_TMA_BOX, rows, 1, 1))


def _tma_takes(t: torch.Tensor, h: int) -> bool:
    """16-byte aligned base, and outer strides that are positive multiples
    of 16 bytes, non-decreasing innermost first."""
    _, strides, _ = tma_geometry(t, h, 1)
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(x > 0 and x % 16 == 0 for x in strides)
            and list(strides) == sorted(strides))


def flash_variant(tensors, num_heads: int | None = None) -> str:
    """The kernel a CUDA launch of K5-K8 takes for these operands (the
    ones it loads: q, k, v and, for K6-K8, dO): "sm90" (wgmma and TMA) for
    bf16 at head_dim 64 or 128 whose layout TMA takes, else "mma" (bf16)
    or "simt" (float32). K8 also needs its cluster to fit
    (`fused_variant`)."""
    q = tensors[0]
    if q.dtype == torch.float32:
        return "simt"
    h = num_heads if q.dim() == 3 else q.shape[1]
    if (q.dtype == torch.bfloat16 and _head_dim(q, h) in _SM90_HEAD_DIMS
            and all(_tma_takes(t, h) for t in tensors)):
        return "sm90"
    return "mma"


def fused_cluster_size(s_k: int) -> int:
    """Blocks of the sm90 K8's cluster: one per 128 keys."""
    return -(-s_k // SM90_KEYS_PER_BLOCK)


def fused_variant(tensors, num_heads: int | None = None) -> str:
    """The kernel a CUDA launch of K8 takes: `flash_variant`'s, except that
    keys past one cluster (s_k > 512, which no single-tile backward
    reaches) take the mma.sync kernel."""
    variant = flash_variant(tensors, num_heads)
    if (variant == "sm90" and fused_cluster_size(tensors[1].shape[-2])
            > SM90_MAX_CLUSTER):
        return "mma"
    return variant


def _check_rows(q, h, *rows):
    want = (q.shape[0], h, q.shape[-2])
    for t in rows:
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"flash attention: lse and delta must be "
                             f"contiguous {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _flash_launch(name, counter, args, q_group, k_group, h, causal, scale,
                  variant):
    """Validate, launch one training kernel `variant` on its pointer
    `args` (outputs allocated by the caller), count the launch by layout
    and variant. q_group (q, dO, out, dq) and k_group (k, v, dk, dv) each
    share one set of strides with unit stride on the head dim. Raises on
    anything the kernel does not take."""
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
    hd = _head_dim(q, h)
    if hd > _FLASH_MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head_dim <= "
                         f"{_FLASH_MAX_HEAD_DIM}, got {hd}")
    ptrs = [t.data_ptr() for t in args]
    shape = (q.shape[0], h, q.shape[-2], k.shape[-2], hd, *_strides(q, h),
             *_strides(k, h), scale, int(causal))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant == "sm90":
        entry, rows = _SM90_FNS[name]
        geo = [x for t, r in zip(args, rows)
               for part in tma_geometry(t, h, r) for x in part]
        with torch.cuda.device(dev):
            rc = _sm90_library(entry, len(ptrs))(
                *ptrs, (ctypes.c_longlong * len(geo))(*geo), *shape, stream)
        name = entry
    else:
        with torch.cuda.device(dev):
            rc = _flash_library(name)(*ptrs, *shape, code, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: code {rc}")
    counter.launched(_layout(q), variant)


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return q.device.type


def _launch_fwd(q, k, v, h, causal, scale, variant):
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], h, q.shape[-2]), dtype=torch.float32,
                      device=q.device)
    _flash_launch("ff_flash_attention_fwd", FLASH_FWD_COUNTER,
                  [q, k, v, out, lse], [q, out], [k, v], h, causal, scale,
                  variant)
    return out, lse


def flash_attention_fwd(q, k, v, *, num_heads: int | None = None,
                        causal: bool = False, scale: float | None = None):
    """Flash attention forward on either layout: (out, lse (b, h, s_q)
    f32). CPU tensors take the plain version; CUDA tensors launch K5 (the
    variant `flash_variant` names)."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, num_heads=num_heads,
                                         causal=causal, scale=scale)
    return _launch_fwd(q, k, v, h, causal, scale,
                       flash_variant([q, k, v], h))


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *,
                           num_heads: int | None = None,
                           causal: bool = False,
                           scale: float | None = None):
    """dq of flash attention on either layout. CPU tensors take the plain
    version; CUDA tensors launch K6 (the variant `flash_variant`
    names)."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dq_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    return _launch_dq(q, k, v, dout, lse, delta, h, causal, scale,
                      flash_variant([q, k, v, dout], h))


def _launch_dq(q, k, v, dout, lse, delta, h, causal, scale, variant):
    _check_rows(q, h, lse, delta)
    dq = torch.empty_like(q)
    _flash_launch("ff_flash_attention_bwd_dq", FLASH_BWD_DQ_COUNTER,
                  [q, k, v, dout, lse, delta, dq], [q, dout, dq], [k, v], h,
                  causal, scale, variant)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *,
                            num_heads: int | None = None,
                            causal: bool = False,
                            scale: float | None = None):
    """(dk, dv) of flash attention on either layout. CPU tensors take the
    plain version; CUDA tensors launch K7 (the variant `flash_variant`
    names)."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dkv_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    return _launch_dkv(q, k, v, dout, lse, delta, h, causal, scale,
                       flash_variant([q, k, v, dout], h))


def _launch_dkv(q, k, v, dout, lse, delta, h, causal, scale, variant):
    _check_rows(q, h, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("ff_flash_attention_bwd_dkv", FLASH_BWD_DKV_COUNTER,
                  [q, k, v, dout, lse, delta, dk, dv], [q, dout],
                  [k, v, dk, dv], h, causal, scale, variant)
    return dk, dv


def flash_attention_bwd_fused(q, k, v, dout, lse, delta, *,
                              num_heads: int | None = None,
                              causal: bool = False,
                              scale: float | None = None):
    """(dq, dk, dv) of flash attention in one kernel on either layout.
    CPU tensors take the plain version; CUDA tensors launch K8 (the
    variant `fused_variant` names). The sm90 kernel sums each dq row
    across its cluster's blocks in shared memory; the others sum dq in an
    f32 (b, h, s_q, d) scratch allocated here."""
    scale, h = _check(q, k, v, num_heads, causal, scale)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_fused_plain(
            q, k, v, dout, lse, delta, num_heads=num_heads, causal=causal,
            scale=scale)
    return _launch_fused(q, k, v, dout, lse, delta, h, causal, scale,
                         fused_variant([q, k, v, dout], h))


def _launch_fused(q, k, v, dout, lse, delta, h, causal, scale, variant):
    _check_rows(q, h, lse, delta)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = [q, k, v, dout, lse, delta, dq, dk, dv]
    if variant != "sm90":
        args.append(torch.empty((q.shape[0], h, q.shape[-2],
                                 _head_dim(q, h)), dtype=torch.float32,
                                device=q.device))
    _flash_launch("ff_flash_attention_bwd_fused", FLASH_BWD_FUSED_COUNTER,
                  args, [q, dout, dq], [k, v, dk, dv], h, causal, scale,
                  variant)
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


def attn_reference_lse(q, k, v, *, causal: bool, scale: float):
    """The XLA-path (out, lse) of the JAX package (`_attn_reference_lse`,
    642), on (b, h, s, d): sdpa_xla's masking (f32 logits, `-1e30` with
    `tril(s_k - s_q)`), lse the f32 log-sum-exp of those logits, the
    softmax cast to q's dtype before P.V. Plain torch, autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = torch.where(
            _causal_live(q.shape[-2], k.shape[-2], q.device), logits,
            torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


def _sdpa_xla(q, k, v, causal, scale):
    from ..ops.attention import sdpa_xla

    return sdpa_xla(q, k, v, causal=causal, scale=scale)


def flash_attention_packed(q, k, v, *, num_heads: int, causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """Fused attention on (batch, seq, heads*head_dim) activations, the
    qkv projections' own layout, differentiable in q, k and v. Causal
    attention with s_q > s_k takes `sdpa_xla` on split heads, as the JAX
    entry does (1236-1243)."""
    if q.dim() != 3:
        raise ValueError(f"flash_attention_packed takes (batch, seq, "
                         f"heads*head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check_shapes(q, k, v, num_heads, scale)
    if _rows_without_keys(q, k, causal):
        b, s_q, e = q.shape

        def split(t):
            return t.reshape(b, t.shape[1], num_heads,
                             e // num_heads).transpose(1, 2)

        out = _sdpa_xla(split(q), split(k), split(v), causal, scale)
        return out.transpose(1, 2).reshape(b, s_q, e)
    return _Flash.apply(q, k, v, num_heads, causal, scale, False)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention on (batch, heads, seq, head_dim) tensors,
    differentiable in q, k and v. Causal attention with s_q > s_k takes
    `sdpa_xla`, as the JAX entry does (1628)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes (batch, heads, seq, "
                         f"head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check_shapes(q, k, v, None, scale)
    if _rows_without_keys(q, k, causal):
        return _sdpa_xla(q, k, v, causal, scale)
    return _Flash.apply(q, k, v, None, causal, scale, False)


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: float | None = None):
    """Fused attention on (batch, heads, seq, head_dim) tensors returning
    (out, lse), lse the (b, h, s_q) f32 row log-sum-exp of the scaled,
    masked logits; differentiable in both outputs (ring attention merges
    blocks by their lse). Causal attention with s_q > s_k takes
    `attn_reference_lse`, as the JAX entry does (668)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention_with_lse takes (batch, heads, "
                         f"seq, head_dim) tensors, got {tuple(q.shape)}")
    scale, _ = _check_shapes(q, k, v, None, scale)
    if _rows_without_keys(q, k, causal):
        return attn_reference_lse(q, k, v, causal=causal, scale=scale)
    return _Flash.apply(q, k, v, None, causal, scale, True)
