"""Dense-compute operators: Linear, Conv2D, Pool2D, Flat, BatchNorm,
LayerNorm, Softmax, Dropout, BatchMatmul, Embedding (twins of
`flexflow_tpu/ops/core.py`, with its flop counts).

Matmuls accumulate in f32 and cast once to the activation dtype, as the
JAX package's `jnp.dot(..., preferred_element_type=f32).astype(x.dtype)`.
Convolutions and pooling are cuDNN's (`F.conv2d`, `F.max_pool2d`,
`F.avg_pool2d`) on the JAX package's NCHW/OIHW layout: the JAX package
runs them through XLA (`lax.conv_general_dilated`, `lax.reduce_window`),
no Pallas kernel.
Gradients come from autograd, except LayerNorm's: the last-axis affine
LayerNorm goes through `kernels/layer_norm.fused_layer_norm`, the
`autograd.Function` of the fused kernels K1 (forward) and K4 (backward).
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import torch
import torch.nn.functional as F

from ..fftype import (
    ActiMode,
    AggrMode,
    DataType,
    OperatorType as OT,
    PoolType,
    RegularizerMode,
)
from .base import OpDef, WeightSpec, matmul_cast, register_op, weak_scalar


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
    # the JAX package's fields, at their defaults there too (its dense
    # drops the regularizer): they keep repr(params), the search's
    # calibration key, the same in both packages
    kernel_reg_type: RegularizerMode = RegularizerMode.REG_MODE_NONE
    kernel_reg_lambda: float = 0.0


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


def _linear_flops(p: LinearParams, in_shapes, out_shapes):
    x = in_shapes[0]
    return 2.0 * math.prod(x) * p.out_channels


register_op(OpDef(OT.OP_LINEAR, _linear_infer, _linear_forward, _linear_weights,
                  _linear_flops))


# ---------------------------------------------------------------- Conv2D

@dataclass(frozen=True)
class Conv2DParams:
    out_channels: int
    kernel_h: int
    kernel_w: int
    stride_h: int
    stride_w: int
    padding_h: int
    padding_w: int
    groups: int = 1
    use_bias: bool = True
    activation: ActiMode = ActiMode.AC_MODE_NONE


def _conv2d_out_hw(p: Conv2DParams, h, w):
    oh = (h + 2 * p.padding_h - p.kernel_h) // p.stride_h + 1
    ow = (w + 2 * p.padding_w - p.kernel_w) // p.stride_w + 1
    return oh, ow


def _conv2d_infer(p: Conv2DParams, in_shapes):
    n, c, h, w = in_shapes[0]
    oh, ow = _conv2d_out_hw(p, h, w)
    return [(n, p.out_channels, oh, ow)]


def _conv2d_weights(p: Conv2DParams, in_shapes):
    c = in_shapes[0][1]
    ws = [
        WeightSpec(
            "kernel",
            (p.out_channels, c // p.groups, p.kernel_h, p.kernel_w),
            DataType.DT_FLOAT,
            "glorot_uniform",
        )
    ]
    if p.use_bias:
        ws.append(WeightSpec("bias", (p.out_channels,), DataType.DT_FLOAT, "zeros"))
    return ws


def _conv2d_forward(p: Conv2DParams, inputs, weights, state, ctx):
    (x,) = inputs
    xm = matmul_cast(ctx, x)
    # one dtype for input and kernel, no separate accumulator type, cast
    # back to the activation dtype: the JAX op's conv_general_dilated
    # (cuDNN accumulates bf16 convolutions in f32 as the MXU does)
    y = F.conv2d(xm, weights["kernel"].to(xm.dtype),
                 stride=(p.stride_h, p.stride_w),
                 padding=(p.padding_h, p.padding_w),
                 groups=p.groups).to(x.dtype)
    if p.use_bias:
        y = y + weights["bias"][None, :, None, None].to(y.dtype)
    return [apply_activation(y, p.activation)], state


def _conv2d_flops(p: Conv2DParams, in_shapes, out_shapes):
    n, c, h, w = in_shapes[0]
    _, oc, oh, ow = out_shapes[0]
    return 2.0 * n * oc * oh * ow * (c // p.groups) * p.kernel_h * p.kernel_w


register_op(OpDef(OT.OP_CONV2D, _conv2d_infer, _conv2d_forward, _conv2d_weights,
                  _conv2d_flops))


# ---------------------------------------------------------------- Pool2D

@dataclass(frozen=True)
class Pool2DParams:
    kernel_h: int
    kernel_w: int
    stride_h: int
    stride_w: int
    padding_h: int
    padding_w: int
    pool_type: PoolType = PoolType.POOL_MAX
    activation: ActiMode = ActiMode.AC_MODE_NONE


def _pool2d_infer(p: Pool2DParams, in_shapes):
    n, c, h, w = in_shapes[0]
    oh = (h + 2 * p.padding_h - p.kernel_h) // p.stride_h + 1
    ow = (w + 2 * p.padding_w - p.kernel_w) // p.stride_w + 1
    return [(n, c, oh, ow)]


def _pool_pad(x, p: Pool2DParams, value: float):
    """x padded by the pool's padding with `value`, as a separate op: the
    torch pools take at most half the window as padding, the JAX op's
    reduce_window any amount."""
    return F.pad(x, (p.padding_w, p.padding_w, p.padding_h, p.padding_h),
                 value=value)


def _pool2d_forward(p: Pool2DParams, inputs, weights, state, ctx):
    (x,) = inputs
    window = (p.kernel_h, p.kernel_w)
    stride = (p.stride_h, p.stride_w)
    in_window = (2 * p.padding_h <= p.kernel_h
                 and 2 * p.padding_w <= p.kernel_w)
    if p.pool_type == PoolType.POOL_MAX:
        # reduce_window's init is -inf (the integer minimum for ints)
        if in_window:
            y = F.max_pool2d(x, window, stride, (p.padding_h, p.padding_w))
        else:
            low = (float("-inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            y = F.max_pool2d(_pool_pad(x, p, low), window, stride)
    else:
        # cuDNN CUDNN_POOLING_AVERAGE_COUNT_INCLUDE_PADDING semantics: the
        # window's sum over kernel_h * kernel_w, padding counted
        if in_window:
            y = F.avg_pool2d(x, window, stride, (p.padding_h, p.padding_w),
                             count_include_pad=True)
        else:
            y = F.avg_pool2d(_pool_pad(x, p, 0.0), window, stride)
    return [apply_activation(y, p.activation)], state


register_op(OpDef(OT.OP_POOL2D, _pool2d_infer, _pool2d_forward))


# ---------------------------------------------------------------- Flat

def _flat_infer(p, in_shapes):
    n = in_shapes[0][0]
    return [(n, math.prod(in_shapes[0][1:]))]


def _flat_forward(p, inputs, weights, state, ctx):
    (x,) = inputs
    return [x.reshape(x.shape[0], -1)], state


register_op(OpDef(OT.OP_FLAT, _flat_infer, _flat_forward))


# ---------------------------------------------------------------- BatchNorm

@dataclass(frozen=True)
class BatchNormParams:
    relu: bool = True
    momentum: float = 0.1
    eps: float = 1e-5


def _bn_infer(p, in_shapes):
    return [in_shapes[0]]


def _bn_weights(p: BatchNormParams, in_shapes):
    c = in_shapes[0][1]
    return [
        WeightSpec("scale", (c,), DataType.DT_FLOAT, "ones"),
        WeightSpec("bias", (c,), DataType.DT_FLOAT, "zeros"),
        WeightSpec("running_mean", (c,), DataType.DT_FLOAT, "zeros", trainable=False),
        WeightSpec("running_var", (c,), DataType.DT_FLOAT, "ones", trainable=False),
    ]


def _bn_forward(p: BatchNormParams, inputs, weights, state, ctx):
    (x,) = inputs
    axes = (0, 2, 3)
    # statistics in f32 under mixed precision; a biased variance in
    # training (jnp.var); the running statistics are returned as state
    # (the executor writes them back in place) and read at eval
    xf = x.float()
    if ctx.training:
        var, mean = torch.var_mean(xf, axes, correction=0)
        state = dict(state or {})
        with torch.no_grad():
            state["running_mean"] = (
                (1 - p.momentum) * weights["running_mean"].float()
                + p.momentum * mean)
            state["running_var"] = (
                (1 - p.momentum) * weights["running_var"].float()
                + p.momentum * var)
    else:
        mean = weights["running_mean"].float()
        var = weights["running_var"].float()
    inv = torch.rsqrt(var + p.eps)
    y = (xf - mean[None, :, None, None]) * inv[None, :, None, None]
    # normalised in f32, cast to the activation dtype before the affine
    y = y.to(x.dtype)
    y = (y * weights["scale"][None, :, None, None]
         + weights["bias"][None, :, None, None])
    if p.relu:
        y = torch.relu(y)
    return [y], state


register_op(OpDef(OT.OP_BATCHNORM, _bn_infer, _bn_forward, _bn_weights))


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
        # fused kernels K1/K4 on CUDA, their plain versions on the CPU
        from ..kernels.layer_norm import fused_layer_norm

        return [fused_layer_norm(x, weights["scale"], weights["bias"],
                                 p.eps)], state
    # the other forms (several axes, no affine) are plain torch on every
    # device, as the JAX package computes them in plain jnp with no
    # kernel (flexflow_tpu/ops/core.py, kernels/layer_norm.py returns
    # None for them)
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


# ---------------------------------------------------------------- Softmax

@dataclass(frozen=True)
class SoftmaxParams:
    dim: int = -1


def _softmax_infer(p, in_shapes):
    return [in_shapes[0]]


def _softmax_forward(p: SoftmaxParams, inputs, weights, state, ctx):
    (x,) = inputs
    # f32 exponentials and normalisation, output in the activation dtype
    return [torch.softmax(x.float(), dim=p.dim).to(x.dtype)], state


register_op(OpDef(OT.OP_SOFTMAX, _softmax_infer, _softmax_forward))


# ---------------------------------------------------------------- Dropout

@dataclass(frozen=True)
class DropoutParams:
    rate: float
    seed: int = 0


def _dropout_infer(p, in_shapes):
    return [in_shapes[0]]


def _dropout_forward(p: DropoutParams, inputs, weights, state, ctx):
    (x,) = inputs
    if not ctx.training or p.rate <= 0.0:
        return [x], state
    if ctx.rng is None:
        raise ValueError("dropout in training needs the model's generator "
                         "(OpContext.rng)")
    keep = 1.0 - p.rate
    # a Bernoulli(keep) mask from the model's generator: the JAX op draws
    # jax.random.bernoulli from its key, whose bits no torch generator
    # gives, so the masks of the two packages differ
    mask = torch.rand(x.shape, generator=ctx.rng, device=x.device) < keep
    # x / keep with keep in x's dtype, as JAX's weak-typed division
    return [torch.where(mask, x / weak_scalar(keep, x),
                        torch.zeros((), dtype=x.dtype, device=x.device))
            .to(x.dtype)], state


register_op(OpDef(OT.OP_DROPOUT, _dropout_infer, _dropout_forward))


# ---------------------------------------------------------------- BatchMatmul

@dataclass(frozen=True)
class BatchMatmulParams:
    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1


def _bmm_infer(p, in_shapes):
    a, b = in_shapes
    if a[:-2] != b[:-2]:
        raise ValueError(f"batch dims mismatch: {a} vs {b}")
    if a[-1] != b[-2]:
        raise ValueError(f"contraction mismatch: {a} vs {b}")
    return [tuple(a[:-2]) + (a[-2], b[-1])]


def _bmm_forward(p: BatchMatmulParams, inputs, weights, state, ctx):
    a, b = inputs
    if ctx.seq_length >= 0:
        # truncated-sequence batches (FFIterationConfig::seq_length,
        # reference include/flexflow/config.h:162-167)
        if p.a_seq_length_dim >= 0:
            a = a.narrow(p.a_seq_length_dim, 0, ctx.seq_length)
        if p.b_seq_length_dim >= 0:
            b = b.narrow(p.b_seq_length_dim, 0, ctx.seq_length)
    return [dense_dot(ctx, a, b)], state


def _bmm_flops(p, in_shapes, out_shapes):
    a, b = in_shapes
    return 2.0 * math.prod(out_shapes[0]) * a[-1]


register_op(OpDef(OT.OP_BATCHMATMUL, _bmm_infer, _bmm_forward, flops=_bmm_flops))


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
