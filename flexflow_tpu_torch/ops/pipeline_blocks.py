"""PipelineBlocks: L stacked pre-LN transformer blocks as one op (twin of
`flexflow_tpu/ops/pipeline_blocks.py`).

The blocks' weights are stacked on a leading layer dim, so pipeline
parallelism is a sharding of that dim over the `pipe` mesh axis: the
op's forward runs `parallel/pipeline.py`'s fill/drain schedule when the
mesh has a pipe axis and the sequential stack otherwise, one function
either way. The block is its own function, not the standard trunk's
layers: one fused `wqkv` projection and an output projection, neither
with a bias; a plain float32 LayerNorm (eps 1e-5), not kernel K1; the
tanh GELU (`jax.nn.gelu`'s default), where the trunk's is exact. Its
attention: "flash" the packed flash kernels (K5; K6 and K7, or K8),
"xla" `sdpa_xla`; "ring" raises, as in JAX (the pipe schedule does not
thread the seq axis). Each block is recomputed in the backward from its
input (JAX: `jax.checkpoint`; here `torch.utils.checkpoint`, and the
pipeline schedule recomputes through the block's `raw` function itself).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..fftype import DataType, OperatorType as OT
from .base import OpDef, WeightSpec, register_op


@dataclass(frozen=True)
class PipelineBlocksParams:
    num_layers: int
    num_heads: int
    mlp_ratio: int = 4
    num_microbatches: int = 0  # 0 -> 2 x pipe-axis size
    causal: bool = True
    attention_impl: str = "xla"  # xla | flash (ring needs the seq axis)


def _pb_infer(p: PipelineBlocksParams, in_shapes):
    return [in_shapes[0]]


def _pb_weights(p: PipelineBlocksParams, in_shapes):
    d = in_shapes[0][-1]
    h = p.mlp_ratio * d
    L = p.num_layers
    Fl = DataType.DT_FLOAT
    return [
        WeightSpec("ln1_scale", (L, d), Fl, "ones"),
        WeightSpec("ln1_bias", (L, d), Fl, "zeros"),
        WeightSpec("wqkv", (L, d, 3 * d), Fl),
        WeightSpec("wo", (L, d, d), Fl),
        WeightSpec("ln2_scale", (L, d), Fl, "ones"),
        WeightSpec("ln2_bias", (L, d), Fl, "zeros"),
        WeightSpec("w1", (L, d, h), Fl),
        WeightSpec("b1", (L, h), Fl, "zeros"),
        WeightSpec("w2", (L, h, d), Fl),
        WeightSpec("b2", (L, d), Fl, "zeros"),
    ]


def _ln(x, scale, bias):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(x.dtype)


def _make_block_fn(num_heads: int, causal: bool, attention_impl: str):
    if attention_impl == "flash":
        from ..kernels.flash_attention import flash_attention_packed
    elif attention_impl == "xla":
        from .attention import sdpa_xla
    else:
        raise ValueError(
            f"PipelineBlocks supports attention_impl 'xla' or 'flash', "
            f"got {attention_impl!r} (ring attention needs the seq axis, "
            f"which the pipe schedule does not thread)")

    def block(w, x):  # w: one layer's weights; x: (mb, s, d)
        d = x.shape[-1]
        hd = d // num_heads

        a = _ln(x, w["ln1_scale"], w["ln1_bias"])
        qkv = torch.matmul(a, w["wqkv"].to(a.dtype))
        q, k, v = torch.split(qkv, d, dim=-1)

        if attention_impl == "flash":
            o = flash_attention_packed(q, k, v, num_heads=num_heads,
                                       causal=causal,
                                       scale=1.0 / math.sqrt(hd))
        else:
            def heads(t):
                b, s, _ = t.shape
                return t.reshape(b, s, num_heads, hd).transpose(1, 2)

            o = sdpa_xla(heads(q), heads(k), heads(v), causal=causal,
                         scale=1.0 / math.sqrt(hd))
            b, _, s, _ = o.shape
            o = o.transpose(1, 2).reshape(b, s, d)
        x = x + torch.matmul(o, w["wo"].to(o.dtype))

        m = _ln(x, w["ln2_scale"], w["ln2_bias"])
        m = F.gelu(torch.matmul(m, w["w1"].to(m.dtype))
                   + w["b1"].to(m.dtype), approximate="tanh")
        m = torch.matmul(m, w["w2"].to(m.dtype)) + w["b2"].to(m.dtype)
        return x + m

    def checkpointed(w, x):
        # O(1) activations per in-flight microbatch: recompute in bwd
        if not torch.is_grad_enabled():
            return block(w, x)
        from torch.utils.checkpoint import checkpoint

        return checkpoint(block, w, x, use_reentrant=False,
                          preserve_rng_state=False)

    checkpointed.raw = block
    return checkpointed


def _pb_forward(p: PipelineBlocksParams, inputs, weights, state, ctx):
    from ..parallel.pipeline import pipeline_apply

    (x,) = inputs
    out = pipeline_apply(
        weights, x,
        _make_block_fn(p.num_heads, p.causal, p.attention_impl),
        mesh=ctx.mesh, num_microbatches=p.num_microbatches,
        num_layers=p.num_layers,
    )
    return [out], state


def _pb_flops(p: PipelineBlocksParams, in_shapes, out_shapes):
    b, s, d = in_shapes[0]
    per_layer = 2.0 * b * s * (4 * d * d + 2 * p.mlp_ratio * d * d)
    attn = 4.0 * b * p.num_heads * s * s * (d // p.num_heads)
    return p.num_layers * (per_layer + attn)


register_op(
    OpDef(OT.OP_PIPE_BLOCKS, _pb_infer, _pb_forward, _pb_weights, _pb_flops)
)
