"""Shape and data-movement operators (twins of
`flexflow_tpu/ops/shape_ops.py`): concat, split, reshape, transpose,
reverse, cast, gather, the reductions (sum, mean, max, min, prod) and
top_k.

Semantics follow the JAX ops: NumPy dim order, `keepdims`, torch.gather
indexing (`take_along_axis`). Two points need care in torch:
- max/min reductions go through `torch.amax`/`torch.amin`, whose
  gradient splits equally between tied entries, as `jnp.max`'s does
  (`torch.max(dim=)` would send it all to one index);
- `top_k` breaks ties by the lower index, as `jax.lax.top_k` does:
  `torch.topk` promises no order among equal values, so the op sorts the
  whole last axis with a stable descending sort and keeps the first k.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..fftype import DataType, OperatorType as OT, dtype_to_torch
from .base import OpDef, register_op


# ---------------------------------------------------------------- Concat

@dataclass(frozen=True)
class ConcatParams:
    axis: int
    n: int = 2


def _concat_infer(p: ConcatParams, in_shapes):
    base = list(in_shapes[0])
    ax = p.axis % len(base)
    base[ax] = sum(s[ax] for s in in_shapes)
    return [tuple(base)]


def _concat_forward(p, inputs, weights, state, ctx):
    return [torch.cat(list(inputs), dim=p.axis)], state


register_op(OpDef(OT.OP_CONCAT, _concat_infer, _concat_forward))


# ---------------------------------------------------------------- Split

@dataclass(frozen=True)
class SplitParams:
    sizes: tuple[int, ...]
    axis: int


def _split_infer(p: SplitParams, in_shapes):
    base = in_shapes[0]
    ax = p.axis % len(base)
    outs = []
    for sz in p.sizes:
        s = list(base)
        s[ax] = sz
        outs.append(tuple(s))
    return outs


def _split_forward(p: SplitParams, inputs, weights, state, ctx):
    (x,) = inputs
    return list(torch.split(x, list(p.sizes), dim=p.axis % x.ndim)), state


register_op(
    OpDef(OT.OP_SPLIT, _split_infer, _split_forward, num_outputs=-1)
)


# ---------------------------------------------------------------- Reshape

@dataclass(frozen=True)
class ReshapeParams:
    shape: tuple[int, ...]


def _reshape_infer(p: ReshapeParams, in_shapes):
    n_in = math.prod(in_shapes[0])
    if math.prod(p.shape) != n_in:
        raise ValueError(f"cannot reshape {in_shapes[0]} to {p.shape}")
    return [tuple(p.shape)]


def _reshape_forward(p, inputs, weights, state, ctx):
    return [inputs[0].reshape(p.shape)], state


register_op(OpDef(OT.OP_RESHAPE, _reshape_infer, _reshape_forward))


# ---------------------------------------------------------------- Transpose

@dataclass(frozen=True)
class TransposeParams:
    perm: tuple[int, ...]


def _transpose_infer(p: TransposeParams, in_shapes):
    x = in_shapes[0]
    return [tuple(x[i] for i in p.perm)]


def _transpose_forward(p, inputs, weights, state, ctx):
    return [inputs[0].permute(p.perm)], state


register_op(OpDef(OT.OP_TRANSPOSE, _transpose_infer, _transpose_forward))


# ---------------------------------------------------------------- Reverse

@dataclass(frozen=True)
class ReverseParams:
    axis: int


def _reverse_infer(p, in_shapes):
    return [in_shapes[0]]


def _reverse_forward(p, inputs, weights, state, ctx):
    return [torch.flip(inputs[0], dims=(p.axis,))], state


register_op(OpDef(OT.OP_REVERSE, _reverse_infer, _reverse_forward))


# ---------------------------------------------------------------- Cast

@dataclass(frozen=True)
class CastParams:
    dtype: DataType


def _cast_infer(p, in_shapes):
    return [in_shapes[0]]


def _cast_forward(p: CastParams, inputs, weights, state, ctx):
    return [inputs[0].to(dtype_to_torch(p.dtype))], state


register_op(OpDef(OT.OP_CAST, _cast_infer, _cast_forward))


# ---------------------------------------------------------------- Gather

@dataclass(frozen=True)
class GatherParams:
    dim: int


def _gather_infer(p: GatherParams, in_shapes):
    return [in_shapes[1]]  # index shape (torch.gather semantics)


def _gather_forward(p: GatherParams, inputs, weights, state, ctx):
    x, index = inputs
    return [torch.take_along_dim(x, index.long(), dim=p.dim)], state


register_op(OpDef(OT.OP_GATHER, _gather_infer, _gather_forward))


# ---------------------------------------------------------------- Reduce / Mean

@dataclass(frozen=True)
class ReduceParams:
    op_type: OT
    axes: tuple[int, ...]
    keepdims: bool = False


def _prod(x, dim, keepdim):
    # torch.prod reduces one dim at a time
    for d in sorted((a % x.ndim for a in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCE_FNS = {
    OT.OP_REDUCE_SUM: torch.sum,
    OT.OP_REDUCE_MEAN: torch.mean,
    OT.OP_REDUCE_MAX: torch.amax,
    OT.OP_REDUCE_MIN: torch.amin,
    OT.OP_REDUCE_PROD: _prod,
    OT.OP_MEAN: torch.mean,
}


def _reduce_infer(p: ReduceParams, in_shapes):
    x = list(in_shapes[0])
    axes = sorted(a % len(x) for a in p.axes)
    if p.keepdims:
        for a in axes:
            x[a] = 1
        return [tuple(x)]
    return [tuple(s for i, s in enumerate(x) if i not in axes)]


def _reduce_forward(p: ReduceParams, inputs, weights, state, ctx):
    fn = _REDUCE_FNS[p.op_type]
    return [fn(inputs[0], dim=tuple(p.axes), keepdim=p.keepdims)], state


for _ot in _REDUCE_FNS:
    register_op(OpDef(_ot, _reduce_infer, _reduce_forward))


# ---------------------------------------------------------------- TopK

@dataclass(frozen=True)
class TopKParams:
    k: int
    sorted: bool = True


def _topk_infer(p: TopKParams, in_shapes):
    x = list(in_shapes[0])
    x[-1] = p.k
    return [tuple(x), tuple(x)]


def _topk_forward(p: TopKParams, inputs, weights, state, ctx):
    # a stable descending sort: equal values keep their index order, so
    # ties go to the lower index (jax.lax.top_k); indices int32 as JAX's
    values, indices = torch.sort(inputs[0], dim=-1, descending=True,
                                 stable=True)
    return [values[..., :p.k], indices[..., :p.k].to(torch.int32)], state


register_op(OpDef(OT.OP_TOPK, _topk_infer, _topk_forward, num_outputs=2))
