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


class AggrMode(enum.IntEnum):
    AGGR_MODE_NONE = 20
    AGGR_MODE_SUM = 21
    AGGR_MODE_AVG = 22


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


def dtype_to_torch(dt: DataType) -> torch.dtype:
    return _DTYPE_TO_TORCH[DataType(dt)]


class LossType(enum.IntEnum):
    LOSS_CATEGORICAL_CROSSENTROPY = 50
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 51
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    LOSS_IDENTITY = 54


class CompMode(enum.IntEnum):
    COMP_MODE_TRAINING = 70
    COMP_MODE_INFERENCE = 71


class OperatorType(enum.IntEnum):
    """The operator vocabulary of this slice, with the values the JAX
    package's enum gives the same names (it numbers them with
    `enum.auto()` in declaration order)."""

    OP_INPUT = 1
    OP_LINEAR = 6
    OP_EMBEDDING = 24
    OP_EW_ADD = 34
    OP_GELU = 73
    OP_MULTIHEAD_ATTENTION = 74
    OP_INC_MULTIHEAD_ATTENTION = 75
    OP_PAGED_INC_MULTIHEAD_ATTENTION = 76
    OP_LAYERNORM = 81
