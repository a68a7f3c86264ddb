"""Multi-head attention (twin of `flexflow_tpu/ops/attention.py`).

The q, k, v projections feed a scaled dot-product core, then the output
projection. The core is chosen by `impl`, as in the JAX package:

  - "flash": `kernels/flash_attention.flash_attention_packed`, the
    `autograd.Function` over kernels K5 (forward) and K8 or K6 and K7
    (backward), on the projections' (b, s, h*d) layout with no head
    transpose; with `ctx.flash_packed` False (`--flash-transposed`) the
    heads are split into materialized (b, h, s, d) tensors for
    `flash_attention`, the same kernels on the transposed layout, and
    merged back: the relayout copies that flag measures;
  - "xla": `sdpa_xla`, the einsum softmax(QK^T)V in plain torch (the JAX
    package runs no Pallas kernel there either), autograd for the
    backward;
  - "ring": `parallel/ring_attention.ring_attention` on split heads over
    `ctx.mesh`'s `seq` axis: the q, k, v blocks are this rank's rows of
    the sequence, which the executor's ring rule gives it
    (`executor._mha_rule`); with no mesh, or a seq axis of 1, it is
    `sdpa_xla`, as in JAX.

On a mesh whose plan shards the projections by heads
(`megatron_transformer`), the executor calls this op with this rank's
weights and params of its heads only (`num_heads` and `embed_dim` cut by
the model axis) and no output bias: the output projection's partial sum
is all-reduced, then the bias added (`executor._mha_rule`).

The serving decode graph replays each causal layer of this op as
incremental attention over a KV cache (`serving/decode_graph.py`); the
weights transfer by name. `dropout` is ignored, as the JAX op ignores it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..fftype import DataType, OperatorType as OT
from .base import OpDef, WeightSpec, register_op
from .core import dense_dot


@dataclass(frozen=True)
class MultiHeadAttentionParams:
    embed_dim: int
    num_heads: int
    kdim: int = 0  # 0 -> embed_dim
    vdim: int = 0
    dropout: float = 0.0
    use_bias: bool = True
    add_bias_kv: bool = False
    add_zero_attn: bool = False
    causal: bool = False
    impl: str = "xla"  # xla | flash | ring


def _mha_infer(p: MultiHeadAttentionParams, in_shapes):
    q, k, v = in_shapes
    return [(q[0], q[1], p.embed_dim)]


def _mha_weights(p: MultiHeadAttentionParams, in_shapes):
    q, k, v = in_shapes
    ws = [
        WeightSpec("wq", (q[-1], p.embed_dim), DataType.DT_FLOAT),
        WeightSpec("wk", (k[-1], p.embed_dim), DataType.DT_FLOAT),
        WeightSpec("wv", (v[-1], p.embed_dim), DataType.DT_FLOAT),
        WeightSpec("wo", (p.embed_dim, p.embed_dim), DataType.DT_FLOAT),
    ]
    if p.use_bias:
        ws += [
            WeightSpec("bq", (p.embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bk", (p.embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bv", (p.embed_dim,), DataType.DT_FLOAT, "zeros"),
            WeightSpec("bo", (p.embed_dim,), DataType.DT_FLOAT, "zeros"),
        ]
    return ws


def sdpa_xla(q, k, v, *, causal: bool, scale: float):
    """Reference-semantics scaled dot-product attention, einsum form, on
    (batch, heads, seq, head_dim): f32 logits from the operands, `-1e30`
    masking with `tril(k=s_k - s_q)`, an f32 softmax cast to q's dtype,
    then P.V in the operands' dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _mha_forward(p: MultiHeadAttentionParams, inputs, weights, state, ctx):
    q_in, k_in, v_in = inputs
    H = p.num_heads
    E = p.embed_dim
    hd = E // H

    def proj(x, w, b):
        y = dense_dot(ctx, x, w.to(x.dtype))
        if b is not None:
            y = y + b.to(y.dtype)
        return y

    q = proj(q_in, weights["wq"], weights.get("bq"))
    k = proj(k_in, weights["wk"], weights.get("bk"))
    v = proj(v_in, weights["wv"], weights.get("bv"))
    scale = 1.0 / math.sqrt(hd)

    if p.impl == "flash" and ctx.flash_packed:
        from ..kernels.flash_attention import flash_attention_packed

        out = flash_attention_packed(q, k, v, num_heads=H, causal=p.causal,
                                     scale=scale)
        return [proj(out, weights["wo"], weights.get("bo"))], state

    def split_heads(x):
        b, s, _ = x.shape
        return x.reshape(b, s, H, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if p.impl == "ring":
        from ..parallel.ring_attention import ring_attention

        out = ring_attention(q, k, v, causal=p.causal, scale=scale,
                             mesh=ctx.mesh)
    elif p.impl == "flash":
        from ..kernels.flash_attention import flash_attention

        # the entry materializes these views as (b, h, s, d) copies: the
        # relayouts the flag measures
        out = flash_attention(q, k, v, causal=p.causal, scale=scale)
    else:
        out = sdpa_xla(q, k, v, causal=p.causal, scale=scale)
    b, _, s, _ = out.shape
    out = out.transpose(1, 2).reshape(b, s, E)
    return [proj(out, weights["wo"], weights.get("bo"))], state


def _mha_flops(p: MultiHeadAttentionParams, in_shapes, out_shapes):
    q, k, v = in_shapes
    b, sq, dq = q
    sk = k[1]
    E = p.embed_dim
    proj = 2.0 * b * (sq * dq * E + sk * k[2] * E + sk * v[2] * E + sq * E * E)
    attn = 2.0 * b * p.num_heads * sq * sk * (E // p.num_heads) * 2
    return proj + attn


register_op(OpDef(OT.OP_MULTIHEAD_ATTENTION, _mha_infer, _mha_forward,
                  _mha_weights, _mha_flops))
