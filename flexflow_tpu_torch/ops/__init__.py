"""Operators of the port (importing this package registers every OpDef)."""

from .attention import MultiHeadAttentionParams
from .base import (
    OpContext,
    OpDef,
    WeightSpec,
    get_op_def,
    matmul_cast,
    register_op,
    registered_ops,
)
from .core import (
    BatchMatmulParams,
    BatchNormParams,
    Conv2DParams,
    DropoutParams,
    EmbeddingParams,
    LayerNormParams,
    LinearParams,
    Pool2DParams,
    SoftmaxParams,
)
from .elementwise import ElementBinaryParams, ElementUnaryParams
from .moe import (
    AggregateParams,
    AggregateSpecParams,
    CacheParams,
    ExpertsParams,
    GroupByParams,
)
from .pipeline_blocks import PipelineBlocksParams
from .inc_attention import (
    IncMultiHeadAttentionParams,
    PagedIncMultiHeadAttentionParams,
)
from .shape_ops import (
    CastParams,
    ConcatParams,
    GatherParams,
    ReduceParams,
    ReshapeParams,
    ReverseParams,
    SplitParams,
    TopKParams,
    TransposeParams,
)

__all__ = [
    "AggregateParams",
    "AggregateSpecParams",
    "BatchMatmulParams",
    "BatchNormParams",
    "CacheParams",
    "CastParams",
    "ConcatParams",
    "Conv2DParams",
    "DropoutParams",
    "ElementBinaryParams",
    "ElementUnaryParams",
    "EmbeddingParams",
    "ExpertsParams",
    "GatherParams",
    "GroupByParams",
    "IncMultiHeadAttentionParams",
    "LayerNormParams",
    "LinearParams",
    "MultiHeadAttentionParams",
    "OpContext",
    "OpDef",
    "PagedIncMultiHeadAttentionParams",
    "PipelineBlocksParams",
    "Pool2DParams",
    "ReduceParams",
    "ReshapeParams",
    "ReverseParams",
    "SoftmaxParams",
    "SplitParams",
    "TopKParams",
    "TransposeParams",
    "WeightSpec",
    "get_op_def",
    "matmul_cast",
    "register_op",
    "registered_ops",
]
