"""Operator definition framework (twin of `flexflow_tpu/ops/base.py`).

An operator is a frozen Params dataclass, shape and weight inference, and
a `forward(params, inputs, weights, state, ctx) -> (outputs, state)` on
torch tensors. Stateful ops (the KV caches) return their updated state
tensors; the port updates them in place where the JAX package relies on
buffer donation, and returns the same tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..fftype import DataType, OperatorType


@dataclass(frozen=True)
class WeightSpec:
    """Declares one trainable (or stateful) tensor of an operator."""

    name: str
    shape: tuple[int, ...]
    dtype: DataType
    initializer: str = "glorot_uniform"  # glorot_uniform|zeros|ones|normal|uniform
    trainable: bool = True


@dataclass
class OpContext:
    """Per-call execution context."""

    training: bool = True
    # matmul input dtype for fp32 activations — the reference's tensor-op
    # math mode (allow_tensor_op_math_conversion): inputs are cast to this
    # dtype, accumulation stays fp32
    matmul_dtype: Any = None


def matmul_cast(ctx: OpContext, *tensors):
    """Cast fp32 matmul operands to the tensor-op input dtype (no-op when
    the policy is off or activations are already low-precision)."""
    import torch

    md = getattr(ctx, "matmul_dtype", None)
    if md is None:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(md) if t.dtype == torch.float32 else t for t in tensors)
    return out if len(out) > 1 else out[0]


class OpDef:
    """Registry entry for one OperatorType."""

    def __init__(
        self,
        op_type: OperatorType,
        infer_shapes: Callable,  # (params, in_shapes) -> list[tuple]
        forward: Callable,  # (params, inputs, weights, state, ctx) -> (outputs, state)
        weights: Optional[Callable] = None,  # (params, in_shapes) -> list[WeightSpec]
    ):
        self.op_type = op_type
        self.infer_shapes = infer_shapes
        self.forward = forward
        self.weights = weights or (lambda params, in_shapes: [])


_REGISTRY: dict[OperatorType, OpDef] = {}


def register_op(op_def: OpDef):
    _REGISTRY[op_def.op_type] = op_def
    return op_def


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise KeyError(f"no OpDef registered for {op_type!r}")
    return _REGISTRY[op_type]
