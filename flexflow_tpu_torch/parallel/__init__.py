"""Parallel ops, strategies, ring collectives, placement transitions, ring
attention and the pipeline (twin of `flexflow_tpu/parallel/`)."""

from .ops import (
    CombineParams,
    FusedParallelOpParams,
    ParallelOpInfo,
    PipelineParams,
    ReductionParams,
    RepartitionParams,
    ReplicateParams,
    allgather_matmul,
    apply_parallel_op_shape,
    choose_update_dim,
    derive_parallel_assignment,
    grad_sync_axes,
    ring_all_gather,
    ring_permutation,
    ring_reduce_scatter,
    weight_update_spec,
)
from .strategies import (
    Strategy,
    expert_parallel_moe,
    megatron_transformer,
    sequence_parallel_attention,
)

__all__ = [
    "CombineParams",
    "FusedParallelOpParams",
    "ParallelOpInfo",
    "PipelineParams",
    "ReductionParams",
    "RepartitionParams",
    "ReplicateParams",
    "Strategy",
    "allgather_matmul",
    "apply_parallel_op_shape",
    "choose_update_dim",
    "derive_parallel_assignment",
    "expert_parallel_moe",
    "grad_sync_axes",
    "megatron_transformer",
    "ring_all_gather",
    "ring_permutation",
    "ring_reduce_scatter",
    "sequence_parallel_attention",
    "weight_update_spec",
]
