"""Incremental (decode-phase) multi-head self-attention over a KV cache:
the contiguous and paged serving ops (twins of
`flexflow_tpu/ops/inc_attention.py`, 96-164 and 240-320).

One forward call processes q_len tokens per slot at per-element positions:
the new K/V rows are written at `positions` (elements clipped out of
[0, max_seq_len) write ZEROS into the scratch row / scratch block 0, so a
NaN'd pad element never reaches the cache), then query row i of slot s
attends cache rows [0, positions[s, i]].

The KV state rests in f32 (`WeightSpec(..., DT_FLOAT)`) while activations
may be bf16. Where the JAX op threads the cache functionally and relies on
buffer donation (`executor.py:827-828`) to update it in place, the port
writes the new rows with an in-place `index_put_` on the state tensors and
returns the same tensors as the op's new state.

On a mesh (the executor's `_kv_rule`) the op runs on this rank's slots
and heads. The paged pool keeps its block dim whole (blocks are shared
across slots by prefix reuse), so it is replicated over the slots' axes:
the new rows of every slot are gathered over them before the write, the
semantics of GSPMD's scatter into a replicated operand, and every replica
stays equal. A contiguous cache whose slot dim is whole does the same and
reads its rows of this rank's slots (`_slot_rows`).

q_len == 1 (a pure decode iteration) goes through the decode kernels K2/K3
(`kernels/flash_attention.py`), which read the f32 cache and round each
element to the compute dtype as they load it; q_len > 1 (a prefill chunk)
runs the plain multi-query reference, exactly as the JAX package does on
every backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..fftype import DataType, OperatorType as OT
from .base import OpDef, WeightSpec, register_op
from .core import dense_dot


@dataclass(frozen=True)
class IncMultiHeadAttentionParams:
    embed_dim: int
    num_heads: int
    max_seq_len: int  # real cache rows; row max_seq_len is the scratch row
    use_bias: bool = True
    # the JAX package's decode-attention choice, kept so the params (and
    # the plan and pair fingerprints hashing their repr) are its; the
    # port's q_len == 1 path is the kernel on every device
    impl: str = "auto"


def _proj_weights(in_dim: int, embed_dim: int, use_bias: bool):
    ws = [
        WeightSpec("wq", (in_dim, embed_dim), DataType.DT_FLOAT),
        WeightSpec("wk", (in_dim, embed_dim), DataType.DT_FLOAT),
        WeightSpec("wv", (in_dim, embed_dim), DataType.DT_FLOAT),
        WeightSpec("wo", (embed_dim, embed_dim), DataType.DT_FLOAT),
    ]
    if use_bias:
        ws += [
            WeightSpec("bq", (embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bk", (embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bv", (embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bo", (embed_dim,), DataType.DT_FLOAT, "zeros"),
        ]
    return ws


def _proj(ctx, t, w, b):
    y = dense_dot(ctx, t, w.to(t.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _qkv(ctx, x, weights):
    return (_proj(ctx, x, weights["wq"], weights.get("bq")),
            _proj(ctx, x, weights["wk"], weights.get("bk")),
            _proj(ctx, x, weights["wv"], weights.get("bv")))


def _gather_writes(ctx, *xs):
    """The write's per-slot tensors of every slot (gathered over the
    slots' axes) where the KV state is replicated over them; else as
    given."""
    kv = getattr(ctx, "kv", None)
    group = kv.get("gather") if kv else None
    if group is None:
        return xs
    from ..parallel.spmd import all_gather

    return tuple(all_gather(x, group, 0) for x in xs)


def _slot_rows(ctx, cache):
    """This rank's slot rows of a contiguous cache that holds every
    slot (a view: rows along dim 0 stay contiguous)."""
    kv = getattr(ctx, "kv", None)
    group = kv.get("take") if kv else None
    if group is None:
        return cache
    n = cache.shape[0] // group.size
    return cache.narrow(0, group.index * n, n)


def _inc_mha_infer(p: IncMultiHeadAttentionParams, in_shapes):
    x, positions = in_shapes
    return [(x[0], x[1], p.embed_dim)]


def _inc_mha_weights(p: IncMultiHeadAttentionParams, in_shapes):
    x = in_shapes[0]
    slots = x[0]
    # the KV cache: stateful (non-trainable), zero-initialized
    return _proj_weights(x[-1], p.embed_dim, p.use_bias) + [
        WeightSpec("cache_k", (slots, p.max_seq_len + 1, p.embed_dim),
                   DataType.DT_FLOAT, "zeros", trainable=False),
        WeightSpec("cache_v", (slots, p.max_seq_len + 1, p.embed_dim),
                   DataType.DT_FLOAT, "zeros", trainable=False),
    ]


def _inc_mha_forward(p: IncMultiHeadAttentionParams, inputs, weights,
                     state, ctx):
    x, positions = inputs
    slots, q_len, _ = x.shape
    H, E = p.num_heads, p.embed_dim
    scale = 1.0 / math.sqrt(E // H)
    q, k, v = _qkv(ctx, x, weights)

    ck, cv = weights["cache_k"], weights["cache_v"]
    positions = positions.long()
    # position-indexed write; >= max_seq_len clips to the scratch row
    write_pos = positions.clamp(0, p.max_seq_len)
    # scratch-bound elements write ZEROS: a pad element's hidden state can be
    # NaN (out-of-range position embedding) and the cache must stay finite
    live = (positions >= 0) & (positions < p.max_seq_len)
    kw = torch.where(live[..., None], k, torch.zeros_like(k))
    vw = torch.where(live[..., None], v, torch.zeros_like(v))
    # in place, where the JAX op's functional .at[].set rides a donated buffer
    wpos, kw, vw = _gather_writes(ctx, write_pos, kw, vw)
    slot_idx = torch.arange(wpos.shape[0], device=x.device)[:, None] \
        .expand_as(wpos)
    ck.index_put_((slot_idx, wpos), kw.to(ck.dtype))
    cv.index_put_((slot_idx, wpos), vw.to(cv.dtype))
    ck_read, cv_read = _slot_rows(ctx, ck), _slot_rows(ctx, cv)

    if q_len == 1:
        from ..kernels.flash_attention import flash_decode_attention

        out = flash_decode_attention(q, ck_read, cv_read,
                                     write_pos[:, 0] + 1, num_heads=H,
                                     scale=scale)
    else:
        from ..kernels.flash_attention import decode_attention_reference

        out = decode_attention_reference(
            q, ck_read.to(q.dtype), cv_read.to(q.dtype), write_pos,
            num_heads=H, scale=scale)
    y = _proj(ctx, out, weights["wo"], weights.get("bo"))
    return [y], {"cache_k": ck, "cache_v": cv}


def _inc_mha_flops(p: IncMultiHeadAttentionParams, in_shapes, out_shapes):
    x = in_shapes[0]
    slots, q_len = x[0], x[1]
    E = p.embed_dim
    # four projections of the q_len new tokens + attention of each query
    # against the full cache (the worst-case full-cache read)
    proj = 2.0 * slots * q_len * (3 * x[-1] * E + E * E)
    attn = 2.0 * slots * p.num_heads * q_len * (p.max_seq_len + 1) * (
        E // p.num_heads) * 2
    return proj + attn


register_op(OpDef(OT.OP_INC_MULTIHEAD_ATTENTION, _inc_mha_infer,
                  _inc_mha_forward, _inc_mha_weights, _inc_mha_flops))


# ===================================================================== paged
# The per-layer KV cache is a shared block pool `pool_k`/`pool_v`
# (num_blocks, block_size, embed) plus a per-slot page table input (slots,
# blocks_per_slot) int32 mapping a slot's logical block to a physical one.
# Physical block 0 is the reserved scratch block. The host's BlockManager
# guarantees (COW) that a block mapped by more than one table is never the
# target of a write.


@dataclass(frozen=True)
class PagedIncMultiHeadAttentionParams:
    embed_dim: int
    num_heads: int
    max_seq_len: int    # logical cache rows per slot (capacity)
    block_size: int     # pool rows per block
    num_blocks: int     # physical pool blocks, block 0 = reserved scratch
    use_bias: bool = True
    impl: str = "auto"  # the JAX package's field (see above)

    @property
    def blocks_per_slot(self) -> int:
        """Page-table width: logical blocks covering max_seq_len rows."""
        return -(-self.max_seq_len // self.block_size)


def _paged_mha_infer(p: PagedIncMultiHeadAttentionParams, in_shapes):
    x, positions, page_table = in_shapes
    if page_table[-1] != p.blocks_per_slot:
        raise ValueError(
            f"page_table width {page_table[-1]} != blocks_per_slot "
            f"{p.blocks_per_slot} (= ceil({p.max_seq_len}/{p.block_size}))")
    return [(x[0], x[1], p.embed_dim)]


def _paged_mha_weights(p: PagedIncMultiHeadAttentionParams, in_shapes):
    x = in_shapes[0]
    # ONE pool per layer shared by every slot
    return _proj_weights(x[-1], p.embed_dim, p.use_bias) + [
        WeightSpec("pool_k", (p.num_blocks, p.block_size, p.embed_dim),
                   DataType.DT_FLOAT, "zeros", trainable=False),
        WeightSpec("pool_v", (p.num_blocks, p.block_size, p.embed_dim),
                   DataType.DT_FLOAT, "zeros", trainable=False),
    ]


def _paged_mha_forward(p: PagedIncMultiHeadAttentionParams, inputs, weights,
                       state, ctx):
    x, positions, page_table = inputs
    slots, q_len, _ = x.shape
    H, E = p.num_heads, p.embed_dim
    bs = p.block_size
    scale = 1.0 / math.sqrt(E // H)
    q, k, v = _qkv(ctx, x, weights)

    pk, pv = weights["pool_k"], weights["pool_v"]
    positions = positions.long()
    page_table = page_table.long()
    live = (positions >= 0) & (positions < p.max_seq_len)
    # position -> (physical block, in-block offset) through the page table;
    # dead elements route to the scratch block and write zeros
    pos_c = positions.clamp(0, p.max_seq_len - 1)
    logical = pos_c // bs
    offset = pos_c % bs
    phys = torch.gather(page_table, 1, logical)
    phys = torch.where(live, phys, torch.zeros_like(phys))
    kw = torch.where(live[..., None], k, torch.zeros_like(k))
    vw = torch.where(live[..., None], v, torch.zeros_like(v))
    # in place, where the JAX op's functional .at[].set rides a donated buffer
    wphys, woff, kw, vw = _gather_writes(ctx, phys, offset, kw, vw)
    pk.index_put_((wphys, woff), kw.to(pk.dtype))
    pv.index_put_((wphys, woff), vw.to(pv.dtype))

    if q_len == 1:
        from ..kernels.flash_attention import paged_flash_decode_attention

        lengths = torch.where(live[:, 0], pos_c[:, 0] + 1,
                              torch.zeros_like(pos_c[:, 0]))
        out = paged_flash_decode_attention(q, pk, pv, page_table, lengths,
                                           num_heads=H, scale=scale)
    else:
        from ..kernels.flash_attention import paged_decode_attention_reference

        read_pos = torch.where(live, pos_c, torch.full_like(pos_c, -1))
        out = paged_decode_attention_reference(
            q, pk, pv, page_table, read_pos, num_heads=H, scale=scale)
    y = _proj(ctx, out, weights["wo"], weights.get("bo"))
    return [y], {"pool_k": pk, "pool_v": pv}


def _paged_mha_flops(p: PagedIncMultiHeadAttentionParams, in_shapes,
                     out_shapes):
    x = in_shapes[0]
    slots, q_len = x[0], x[1]
    E = p.embed_dim
    # as the contiguous op's count: projections of the new tokens +
    # worst-case full-capacity cache read per query
    proj = 2.0 * slots * q_len * (3 * x[-1] * E + E * E)
    attn = 2.0 * slots * p.num_heads * q_len * (
        p.blocks_per_slot * p.block_size) * (E // p.num_heads) * 2
    return proj + attn


register_op(OpDef(OT.OP_PAGED_INC_MULTIHEAD_ATTENTION, _paged_mha_infer,
                  _paged_mha_forward, _paged_mha_weights, _paged_mha_flops))
