"""Dense-compute operators of the serving slice: Linear, LayerNorm,
Embedding (twins of `flexflow_tpu/ops/core.py` 69-84, 291-317, 429-445).

Matmuls accumulate in f32 and cast once to the activation dtype, as the
JAX package's `jnp.dot(..., preferred_element_type=f32).astype(x.dtype)`.
LayerNorm goes through the fused kernel K1 (`kernels/layer_norm.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..fftype import ActiMode, AggrMode, DataType, OperatorType as OT
from .base import OpDef, WeightSpec, matmul_cast, register_op


def apply_activation(x, activation: ActiMode):
    if activation == ActiMode.AC_MODE_NONE:
        return x
    if activation == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if activation == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if activation == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if activation == ActiMode.AC_MODE_GELU:
        return F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {activation}")


def dense_dot(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, returned in x's dtype. Operands of one
    dtype go straight to the matmul (bf16 products accumulate in f32 inside
    it); when the tensor-op policy rounded fp32 operands to bf16, the
    rounded values are multiplied in f32 so the output keeps f32 precision,
    as the JAX package's preferred_element_type=f32 does."""
    xm, wm = matmul_cast(ctx, x, w)
    if xm.dtype == x.dtype and wm.dtype == x.dtype:
        return torch.matmul(xm, wm)
    return torch.matmul(xm.float(), wm.float()).to(x.dtype)


# ---------------------------------------------------------------- Linear

@dataclass(frozen=True)
class LinearParams:
    out_channels: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.AC_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT


def _linear_infer(p: LinearParams, in_shapes):
    (x,) = in_shapes
    return [tuple(x[:-1]) + (p.out_channels,)]


def _linear_weights(p: LinearParams, in_shapes):
    in_dim = in_shapes[0][-1]
    ws = [WeightSpec("kernel", (in_dim, p.out_channels), p.data_type, "glorot_uniform")]
    if p.use_bias:
        ws.append(WeightSpec("bias", (p.out_channels,), p.data_type, "zeros"))
    return ws


def _linear_forward(p: LinearParams, inputs, weights, state, ctx):
    (x,) = inputs
    y = dense_dot(ctx, x, weights["kernel"])
    if p.use_bias:
        y = y + weights["bias"].to(y.dtype)
    return [apply_activation(y, p.activation)], state


register_op(OpDef(OT.OP_LINEAR, _linear_infer, _linear_forward, _linear_weights))


# ---------------------------------------------------------------- LayerNorm

@dataclass(frozen=True)
class LayerNormParams:
    axes: tuple[int, ...]
    elementwise_affine: bool = True
    eps: float = 1e-5


def _ln_infer(p, in_shapes):
    return [in_shapes[0]]


def _ln_weights(p: LayerNormParams, in_shapes):
    if not p.elementwise_affine:
        return []
    shape = tuple(in_shapes[0][a] for a in p.axes)
    return [
        WeightSpec("scale", shape, DataType.DT_FLOAT, "ones"),
        WeightSpec("bias", shape, DataType.DT_FLOAT, "zeros"),
    ]


def _ln_forward(p: LayerNormParams, inputs, weights, state, ctx):
    (x,) = inputs
    axes = tuple(a % x.ndim for a in p.axes)
    if p.elementwise_affine and axes == (x.ndim - 1,):
        # fused kernel K1 on CUDA, its plain version on the CPU
        from ..kernels.layer_norm import layer_norm

        return [layer_norm(x, weights["scale"], weights["bias"], p.eps)], state
    if x.device.type != "cpu":
        raise NotImplementedError(
            "LayerNorm on CUDA runs the fused last-axis affine kernel only; "
            f"axes={p.axes}, elementwise_affine={p.elementwise_affine} is "
            "not on the serving slice's path")
    xf = x.float()  # fp32 statistics under mixed precision
    mean = xf.mean(dim=axes, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=axes, keepdim=True)
    y = xc * torch.rsqrt(var + p.eps)
    if p.elementwise_affine:
        bshape = [x.shape[a] if a in axes else 1 for a in range(x.ndim)]
        y = (y * weights["scale"].float().reshape(bshape)
             + weights["bias"].float().reshape(bshape))
    return [y.to(x.dtype)], state


register_op(OpDef(OT.OP_LAYERNORM, _ln_infer, _ln_forward, _ln_weights))


# ---------------------------------------------------------------- Embedding

@dataclass(frozen=True)
class EmbeddingParams:
    num_entries: int
    out_channels: int
    aggr: AggrMode = AggrMode.AGGR_MODE_NONE
    data_type: DataType = DataType.DT_FLOAT


def _embedding_infer(p: EmbeddingParams, in_shapes):
    x = in_shapes[0]
    if p.aggr == AggrMode.AGGR_MODE_NONE:
        return [tuple(x) + (p.out_channels,)]
    return [tuple(x[:-1]) + (p.out_channels,)]


def _embedding_weights(p: EmbeddingParams, in_shapes):
    return [
        WeightSpec(
            "kernel", (p.num_entries, p.out_channels), p.data_type, "glorot_uniform"
        )
    ]


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`jnp.take(table, ids, axis=0)` semantics: negative ids wrap once,
    ids still outside [0, n) read a row of NaN. The serving engine pads
    idle elements with position max_seq_len, one past a position table of
    that length; `F.embedding` would raise (a device assert on CUDA), so
    the index is clamped and the fill written after the gather."""
    n = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    emb = table[idx.clamp(0, n - 1)]
    return torch.where(oob[..., None],
                       torch.full((), float("nan"), dtype=emb.dtype,
                                  device=emb.device), emb)


def _embedding_forward(p: EmbeddingParams, inputs, weights, state, ctx):
    (ids,) = inputs
    emb = embedding_lookup(weights["kernel"], ids)
    if p.aggr == AggrMode.AGGR_MODE_SUM:
        emb = emb.sum(dim=-2)
    elif p.aggr == AggrMode.AGGR_MODE_AVG:
        emb = emb.mean(dim=-2)
    return [emb], state


register_op(
    OpDef(OT.OP_EMBEDDING, _embedding_infer, _embedding_forward, _embedding_weights)
)
