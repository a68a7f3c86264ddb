"""Multi-head attention: builder-side half (twin of
`flexflow_tpu/ops/attention.py`).

The serving slice needs the training op's params, shape inference and
weight specs only: `serving/decode_graph.build_decode_model` replays each
causal `OP_MULTIHEAD_ATTENTION` layer as incremental attention, and the
trained weights transfer by name. The training forward (flash fwd/bwd) is
the port's training slice, ROADMAP queue A3 with kernels B1/B2; until it
lands, running this op raises.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fftype import DataType, OperatorType as OT
from .base import OpDef, WeightSpec, register_op


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


def _mha_forward(p: MultiHeadAttentionParams, inputs, weights, state, ctx):
    raise NotImplementedError(
        "OP_MULTIHEAD_ATTENTION forward (training) is not ported yet: it is "
        "ROADMAP queue A3 with the flash-attention kernels B1/B2 (training "
        "slice). Serve the model instead: model.serve() replays this layer "
        "as incremental attention over a KV cache")


register_op(OpDef(OT.OP_MULTIHEAD_ATTENTION, _mha_infer, _mha_forward,
                  _mha_weights))
