"""Elementwise operators of the main path: add and exact GELU (twins
of `flexflow_tpu/ops/elementwise.py`; GELU is the erf form of line 43).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..fftype import OperatorType as OT
from .base import OpDef, register_op


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
    OT.OP_GELU: lambda x: F.gelu(x, approximate="none"),
}

_BINARY_FNS = {
    OT.OP_EW_ADD: torch.add,
}


def _unary_infer(params, in_shapes):
    return [in_shapes[0]]


def _unary_forward(params, inputs, weights, state, ctx):
    (x,) = inputs
    return [_UNARY_FNS[params.op_type](x)], state


def _binary_infer(params, in_shapes):
    a, b = in_shapes
    return [tuple(torch.broadcast_shapes(tuple(a), tuple(b)))]


def _binary_forward(params, inputs, weights, state, ctx):
    a, b = inputs
    return [_BINARY_FNS[params.op_type](a, b)], state


for _ot in _UNARY_FNS:
    register_op(OpDef(_ot, _unary_infer, _unary_forward))

for _ot in _BINARY_FNS:
    register_op(OpDef(_ot, _binary_infer, _binary_forward))
