"""Operator definition framework (twin of `flexflow_tpu/ops/base.py`).

An operator is a frozen Params dataclass, shape and weight inference, and
a `forward(params, inputs, weights, state, ctx) -> (outputs, state)` on
torch tensors, and an analytic flop count (the MFU anchor of telemetry).
Stateful ops (the KV caches, BatchNorm's running statistics) return
their updated state tensors; the executor writes them back into the
model's state in place, where the JAX package relies on buffer
donation.
"""

from __future__ import annotations

import math
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
    # the model's torch.Generator on its device (dropout's draws); None
    # outside training, where no op draws
    rng: Any = None
    # FFIterationConfig::seq_length (reference config.h:162-167): >= 0
    # truncates batch_matmul's sequence dims (forward/backward(seq_length))
    seq_length: int = -1
    # matmul input dtype for fp32 activations — the reference's tensor-op
    # math mode (allow_tensor_op_math_conversion): inputs are cast to this
    # dtype, accumulation stays fp32
    matmul_dtype: Any = None
    # False routes impl="flash" attention through the head-transposed
    # (b, h, s, d) entry instead of the packed relayout-free one — the
    # kernel-layout ablation baseline (FFConfig.flash_packed_layout)
    flash_packed: bool = True
    # the mesh of a rank of the executor's sharded half (None alone): the
    # ops that move data themselves (ring attention over `seq`, the
    # pipeline over `pipe`) take their groups from it
    mesh: Any = None
    # incremental attention on a mesh (`Executor._kv_rule`): where the KV
    # state holds every slot while this rank computes some of them, the
    # group over the slots' axes (the new rows are gathered over it
    # before the write, so every replica stays equal) and, for the
    # contiguous cache, the group whose index picks this rank's slot rows
    # to read; None alone or where the state's slots are this rank's
    kv: Any = None


def matmul_cast(ctx: OpContext, *tensors):
    """Cast fp32 matmul operands to the tensor-op input dtype (no-op when
    the policy is off or activations are already low-precision)."""
    import torch

    md = getattr(ctx, "matmul_dtype", None)
    if md is None:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(md) if t.dtype == torch.float32 else t for t in tensors)
    return out if len(out) > 1 else out[0]


def weak_scalar(c: float, x):
    """A Python scalar as the JAX ops see it next to `x`: JAX's weak
    typing rounds it to a floating `x`'s dtype before the arithmetic
    (0.7 next to bf16 is 0.69921875), where torch would keep it in f32.
    Rounded on the host, so a captured step copies nothing."""
    import torch

    if torch.is_tensor(x) and x.is_floating_point():
        return float(torch.tensor(float(c), dtype=x.dtype))
    return c


class OpDef:
    """Registry entry for one OperatorType."""

    def __init__(
        self,
        op_type: OperatorType,
        infer_shapes: Callable,  # (params, in_shapes) -> list[tuple]
        forward: Callable,  # (params, inputs, weights, state, ctx) -> (outputs, state)
        weights: Optional[Callable] = None,  # (params, in_shapes) -> list[WeightSpec]
        flops: Optional[Callable] = None,  # (params, in_shapes, out_shapes) -> float
        num_outputs: int = 1,
    ):
        self.op_type = op_type
        self.infer_shapes = infer_shapes
        self.forward = forward
        self.weights = weights or (lambda params, in_shapes: [])
        self.flops = flops or _default_flops
        self.num_outputs = num_outputs


def _default_flops(params, in_shapes, out_shapes) -> float:
    # elementwise-ish default: one flop per output element
    total = 0
    for s in out_shapes:
        total += math.prod(s) if s else 1
    return float(total)


_REGISTRY: dict[OperatorType, OpDef] = {}


def register_op(op_def: OpDef):
    _REGISTRY[op_def.op_type] = op_def
    return op_def


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise KeyError(f"no OpDef registered for {op_type!r}")
    return _REGISTRY[op_type]


def registered_ops() -> dict[OperatorType, OpDef]:
    return dict(_REGISTRY)
