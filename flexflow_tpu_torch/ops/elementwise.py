"""Elementwise operators (twins of `flexflow_tpu/ops/elementwise.py`
36-104): the unary ops, the scalar ops (a constant from the params) and
the binary ops with NumPy broadcasting. Each is the torch function of the
`jnp`/`jax.nn` one; GELU is the erf form, leaky ReLU jax.nn's slope 0.01,
`round` rounds half to even as `jnp.round` does, the comparisons return
bool tensors, and a scalar op's constant is rounded to a floating
input's dtype first (JAX's weak typing, `weak_scalar`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..fftype import OperatorType as OT
from .base import OpDef, register_op, weak_scalar


@dataclass(frozen=True)
class ElementUnaryParams:
    op_type: OT
    inplace: bool = True  # kept for parity; the port allocates outputs
    scalar: float = 0.0


@dataclass(frozen=True)
class ElementBinaryParams:
    op_type: OT
    inplace_a: bool = False


_UNARY_FNS = {
    OT.OP_EXP: torch.exp,
    OT.OP_LOG: torch.log,
    OT.OP_SIN: torch.sin,
    OT.OP_COS: torch.cos,
    OT.OP_RELU: torch.relu,
    OT.OP_IDENTITY: lambda x: x,
    OT.OP_GELU: lambda x: F.gelu(x, approximate="none"),
    OT.OP_SIGMOID: torch.sigmoid,
    OT.OP_TANH: torch.tanh,
    OT.OP_ELU: F.elu,
    OT.OP_RSQRT: torch.rsqrt,
    OT.OP_SQRT: torch.sqrt,
    OT.OP_CEIL: torch.ceil,
    OT.OP_ROUND: torch.round,
    OT.OP_LOGICAL_NOT: torch.logical_not,
    OT.OP_LEAKYRELU: lambda x: F.leaky_relu(x, 0.01),
}

_SCALAR_FNS = {
    OT.OP_SCALAR_MULTIPLY: lambda x, c: x * c,
    OT.OP_SCALAR_ADD: lambda x, c: x + c,
    OT.OP_SCALAR_SUB: lambda x, c: x - c,
    OT.OP_SCALAR_TRUE_DIV: lambda x, c: x / c,
    OT.OP_SCALAR_FLOOR_DIV: lambda x, c: torch.floor_divide(x, c),
    OT.OP_POW: lambda x, c: torch.pow(x, c),
}

_BINARY_FNS = {
    OT.OP_EW_ADD: torch.add,
    OT.OP_EW_SUB: torch.subtract,
    OT.OP_EW_MUL: torch.multiply,
    OT.OP_EW_DIV: torch.divide,
    OT.OP_EW_MAX: torch.maximum,
    OT.OP_EW_MIN: torch.minimum,
    OT.OP_EW_EQUAL: torch.eq,
    OT.OP_EW_GREATER: torch.gt,
    OT.OP_EW_LESS: torch.lt,
}


def _unary_infer(params, in_shapes):
    return [in_shapes[0]]


def _unary_forward(params, inputs, weights, state, ctx):
    (x,) = inputs
    if params.op_type in _SCALAR_FNS:
        y = _SCALAR_FNS[params.op_type](x, weak_scalar(params.scalar, x))
    else:
        y = _UNARY_FNS[params.op_type](x)
    return [y], state


def _binary_infer(params, in_shapes):
    a, b = in_shapes
    return [tuple(torch.broadcast_shapes(tuple(a), tuple(b)))]


def _binary_forward(params, inputs, weights, state, ctx):
    a, b = inputs
    return [_BINARY_FNS[params.op_type](a, b)], state


for _ot in list(_UNARY_FNS) + list(_SCALAR_FNS):
    register_op(OpDef(_ot, _unary_infer, _unary_forward))

for _ot in _BINARY_FNS:
    register_op(OpDef(_ot, _binary_infer, _binary_forward))
