"""Core enums and type constants of the PyTorch port.

The twin of `flexflow_tpu/fftype.py`: the same enum names and values, so
user code and layer params carry over one-to-one; the dtype table maps to
`torch.dtype` instead of `jnp`.
"""

from __future__ import annotations

import enum

import torch


class ActiMode(enum.IntEnum):
    AC_MODE_NONE = 10
    AC_MODE_RELU = 11
    AC_MODE_SIGMOID = 12
    AC_MODE_TANH = 13
    AC_MODE_GELU = 14


class RegularizerMode(enum.IntEnum):
    REG_MODE_NONE = 17
    REG_MODE_L1 = 18
    REG_MODE_L2 = 19


class AggrMode(enum.IntEnum):
    AGGR_MODE_NONE = 20
    AGGR_MODE_SUM = 21
    AGGR_MODE_AVG = 22


class PoolType(enum.IntEnum):
    POOL_MAX = 30
    POOL_AVG = 31


class DataType(enum.IntEnum):
    DT_BOOLEAN = 40
    DT_INT32 = 41
    DT_INT64 = 42
    DT_HALF = 43
    DT_BFLOAT16 = 46
    DT_FLOAT = 44
    DT_DOUBLE = 45
    DT_NONE = 49


_DTYPE_TO_TORCH = {
    DataType.DT_BOOLEAN: torch.bool,
    DataType.DT_INT32: torch.int32,
    DataType.DT_INT64: torch.int64,
    DataType.DT_HALF: torch.float16,
    DataType.DT_BFLOAT16: torch.bfloat16,
    DataType.DT_FLOAT: torch.float32,
    DataType.DT_DOUBLE: torch.float64,
}


_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}


def dtype_to_torch(dt: DataType) -> torch.dtype:
    return _DTYPE_TO_TORCH[DataType(dt)]


def torch_to_dtype(dt: torch.dtype) -> DataType:
    return _TORCH_TO_DTYPE[dt]


def size_of_datatype(dt: DataType) -> int:
    return dtype_to_torch(dt).itemsize


class LossType(enum.IntEnum):
    LOSS_CATEGORICAL_CROSSENTROPY = 50
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 51
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    LOSS_IDENTITY = 54


class ParameterSyncType(enum.IntEnum):
    """Kept for API parity with the JAX package (which keeps it for the
    reference's ffconst.h). On one device there is nothing to sync."""

    NONE = 80
    PS = 81
    NCCL = 82


class MetricsType(enum.IntEnum):
    METRICS_ACCURACY = 1001
    METRICS_CATEGORICAL_CROSSENTROPY = 1002
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = 1004
    METRICS_MEAN_SQUARED_ERROR = 1008
    METRICS_ROOT_MEAN_SQUARED_ERROR = 1016
    METRICS_MEAN_ABSOLUTE_ERROR = 1032


class CompMode(enum.IntEnum):
    COMP_MODE_TRAINING = 70
    COMP_MODE_INFERENCE = 71


class OperatorType(enum.IntEnum):
    """The operators the port registers, with the values the JAX package's
    enum gives the same names (it numbers them with `enum.auto()` in
    declaration order)."""

    OP_INPUT = 1
    OP_CONV2D = 4
    OP_DROPOUT = 5
    OP_LINEAR = 6
    OP_BATCHMATMUL = 7
    OP_POOL2D = 8
    OP_SCALAR_MULTIPLY = 9
    OP_SCALAR_ADD = 10
    OP_SCALAR_FLOOR_DIV = 11
    OP_SCALAR_TRUE_DIV = 12
    OP_SCALAR_SUB = 13
    OP_RELU = 14
    OP_IDENTITY = 15
    OP_SIGMOID = 16
    OP_TANH = 17
    OP_ELU = 18
    OP_FLAT = 19
    OP_SOFTMAX = 20
    OP_BATCHNORM = 21
    OP_CONCAT = 22
    OP_SPLIT = 23
    OP_EMBEDDING = 24
    OP_PIPE_BLOCKS = 30
    OP_RESHAPE = 31
    OP_REVERSE = 32
    OP_TRANSPOSE = 33
    OP_EW_ADD = 34
    OP_EW_MUL = 35
    OP_EW_SUB = 41
    OP_EW_DIV = 42
    OP_EW_EQUAL = 43
    OP_EW_GREATER = 44
    OP_EW_LESS = 45
    OP_EW_MAX = 46
    OP_EW_MIN = 47
    OP_REDUCE_MAX = 50
    OP_REDUCE_MEAN = 51
    OP_REDUCE_MIN = 52
    OP_REDUCE_PROD = 53
    OP_REDUCE_SUM = 54
    OP_TOPK = 58
    OP_CEIL = 60
    OP_CAST = 61
    OP_EXP = 62
    OP_ROUND = 63
    OP_LOG = 64
    OP_LOGICAL_NOT = 65
    OP_SQRT = 66
    OP_SIN = 67
    OP_COS = 68
    OP_LEAKYRELU = 69
    OP_GELU = 73
    OP_MULTIHEAD_ATTENTION = 74
    OP_INC_MULTIHEAD_ATTENTION = 75
    OP_PAGED_INC_MULTIHEAD_ATTENTION = 76
    OP_RSQRT = 78
    OP_POW = 79
    OP_MEAN = 80
    OP_LAYERNORM = 81
    OP_GATHER = 82
    OP_REPARTITION = 83
    OP_COMBINE = 84
    OP_REPLICATE = 85
    OP_REDUCTION = 86
    OP_PIPELINE = 87
    OP_FUSED_PARALLEL = 88


class UnportedOperatorType(enum.IntEnum):
    """Operator types of the JAX package that the port has no op for yet,
    with the JAX package's values. The Unity search names them (the MoE
    fusion rewrite, the non-compute kinds),
    but no graph of the port holds one."""

    OP_WEIGHT = 2
    OP_NOOP = 3
    OP_GROUP_BY = 25  # ROADMAP A12 (ops/moe.py)
    OP_AGGREGATE = 27  # A12
    OP_EXPERTS = 29  # A12


# the parallel ops: PCG nodes that change a tensor's placement, not its
# values (runtime identity; the executor moves the data)
PARALLEL_OP_TYPES = frozenset(
    {
        OperatorType.OP_REPARTITION,
        OperatorType.OP_COMBINE,
        OperatorType.OP_REPLICATE,
        OperatorType.OP_REDUCTION,
        OperatorType.OP_PIPELINE,
        OperatorType.OP_FUSED_PARALLEL,
    }
)
