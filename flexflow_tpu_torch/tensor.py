"""Tensor IR: lazy frontend tensors.

The twin of `flexflow_tpu/tensor.py`. On one device every plan is the
replicated one, so the parallel-tensor half (ParallelDim, PartitionSpec,
MachineView) is dropped: a compiled node's outputs are plain shapes.
"""

from __future__ import annotations

import itertools

from .fftype import DataType

_tensor_guid = itertools.count(3000000)  # TENSOR_GUID_FIRST_VALID


class Tensor:
    """Lazy frontend tensor handle: shape + dtype, no data. `dims` are
    outer-to-inner (NumPy order)."""

    def __init__(
        self,
        dims: tuple[int, ...],
        dtype: DataType,
        owner_layer=None,
        owner_idx: int = 0,
        name: str = "",
        create_gradients: bool = True,
    ):
        self.tensor_guid = next(_tensor_guid)
        self.dims = tuple(int(d) for d in dims)
        self.dtype = DataType(dtype)
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.name = name or f"tensor_{self.tensor_guid}"
        self.create_gradients = create_gradients

    def __repr__(self):
        return f"Tensor({self.name}, dims={self.dims}, dtype={self.dtype.name})"
