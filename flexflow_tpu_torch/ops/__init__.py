"""Operators of the port (importing this package registers every OpDef)."""

from .attention import MultiHeadAttentionParams
from .base import OpContext, OpDef, WeightSpec, get_op_def, matmul_cast, register_op
from .core import EmbeddingParams, LayerNormParams, LinearParams
from .elementwise import ElementBinaryParams, ElementUnaryParams
from .inc_attention import (
    IncMultiHeadAttentionParams,
    PagedIncMultiHeadAttentionParams,
)

__all__ = [
    "ElementBinaryParams",
    "ElementUnaryParams",
    "EmbeddingParams",
    "IncMultiHeadAttentionParams",
    "LayerNormParams",
    "LinearParams",
    "MultiHeadAttentionParams",
    "OpContext",
    "OpDef",
    "PagedIncMultiHeadAttentionParams",
    "WeightSpec",
    "get_op_def",
    "matmul_cast",
    "register_op",
]
