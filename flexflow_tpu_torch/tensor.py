"""Tensor IR: lazy frontend tensors and their parallel annotations.

The twin of `flexflow_tpu/tensor.py`: `Tensor` (the builder's lazy
handle), `ParallelDim` and `ParallelTensorShape` (the per-dim degrees the
parallel ops transform), and `ParallelTensor` (a compiled node's output:
its shape and its per-dim mesh-axis assignment). `PartitionSpec` is a
JAX-free twin of `jax.sharding.PartitionSpec`: a tuple with one entry
per leading dim, each None, an axis name or a tuple of axis names.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Optional

from .fftype import DataType, ParameterSyncType

_tensor_guid = itertools.count(3000000)  # TENSOR_GUID_FIRST_VALID
_parallel_tensor_guid = itertools.count(4000000)


class PartitionSpec(tuple):
    """Per-dim mesh axes of a placement, as `jax.sharding.PartitionSpec`
    spells them: `PartitionSpec("data", None, ("model", "seq"))`. Dims
    past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


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

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def get_shape(self) -> tuple[int, ...]:
        return self.dims

    def __repr__(self):
        return f"Tensor({self.name}, dims={self.dims}, dtype={self.dtype.name})"


@dataclass(frozen=True)
class ParallelDim:
    """Per-dim parallelization state (parallel_tensor.h:36-71): the
    logical `size`, the number of shards `degree`, whether the dim only
    counts replicas, and the mesh `axes` the degree rides when the op
    that introduced it named them."""

    size: int
    degree: int = 1
    parallel_idx: int = -1
    is_replica_dim: bool = False
    axes: tuple = ()

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if not self.is_replica_dim and self.size % self.degree != 0:
            raise ValueError(
                f"dim size {self.size} not divisible by degree {self.degree}"
            )


@dataclass(frozen=True)
class ParallelTensorShape:
    """Shape + parallelization annotation (parallel_tensor.h:96-135)."""

    dims: tuple[ParallelDim, ...]
    dtype: DataType

    @staticmethod
    def from_shape(shape: tuple[int, ...], dtype: DataType) -> "ParallelTensorShape":
        return ParallelTensorShape(tuple(ParallelDim(int(s)) for s in shape), dtype)

    @property
    def logical_shape(self) -> tuple[int, ...]:
        """Shape without replica dims: the global tensor's shape."""
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    @property
    def num_replica_dims(self) -> int:
        return sum(1 for d in self.dims if d.is_replica_dim)

    @property
    def total_degree(self) -> int:
        deg = 1
        for d in self.dims:
            deg *= d.degree
        return deg

    def piece_shape(self) -> tuple[int, ...]:
        """Per-device shard shape (logical dims only)."""
        return tuple(
            d.size // d.degree for d in self.dims if not d.is_replica_dim
        )

    def num_elements(self) -> int:
        n = 1
        for s in self.logical_shape:
            n *= s
        return n

    def piece_elements(self) -> int:
        n = 1
        for s in self.piece_shape():
            n *= s
        return n

    def with_degree(self, dim: int, degree: int) -> "ParallelTensorShape":
        dims = list(self.dims)
        dims[dim] = replace(dims[dim], degree=degree)
        return ParallelTensorShape(tuple(dims), self.dtype)

    def __repr__(self):
        parts = []
        for d in self.dims:
            tag = "R" if d.is_replica_dim else ""
            if d.degree > 1 or d.is_replica_dim:
                s = f"{d.size}{tag}/{d.degree}"
                if d.axes:
                    s += f"@{','.join(d.axes)}"
                parts.append(s)
            else:
                parts.append(str(d.size))
        return f"PTShape[{' x '.join(parts)}, {self.dtype.name}]"


class ParallelTensor:
    """A compiled node's output: parallel shape + mesh-axis assignment
    (parallel_tensor.h:139-198). `axis_assignment[i]` is the tuple of mesh
    axes sharding dim i (empty: replicated along it); the executor keeps
    the tensor in that layout on every rank."""

    def __init__(
        self,
        shape: ParallelTensorShape,
        name: str = "",
        sync_type: ParameterSyncType = ParameterSyncType.NONE,
        create_gradients: bool = True,
    ):
        self.parallel_tensor_guid = next(_parallel_tensor_guid)
        self.shape = shape
        self.name = name or f"ptensor_{self.parallel_tensor_guid}"
        if sync_type == ParameterSyncType.PS:
            # the reference's parameter-server sync is not implemented, as
            # in the JAX package: gradients are reduced over the mesh's
            # data axes by collectives
            raise NotImplementedError(
                "ParameterSyncType.PS is not supported: gradient "
                "synchronization is a collective over the data mesh axes "
                "(the NCCL-mode equivalent); use ParameterSyncType.NCCL "
                "or NONE")
        self.sync_type = sync_type
        self.create_gradients = create_gradients
        self.axis_assignment: tuple[tuple[str, ...], ...] = tuple(
            () for _ in shape.dims
        )
        self.owner_op = None
        self.owner_idx: int = 0

    @property
    def dtype(self) -> DataType:
        return self.shape.dtype

    def assign_axes(self, assignment: tuple[tuple[str, ...], ...]):
        if len(assignment) != len(self.shape.dims):
            raise ValueError(
                f"assignment rank {len(assignment)} != tensor rank "
                f"{len(self.shape.dims)}"
            )
        self.axis_assignment = tuple(tuple(a) for a in assignment)

    def partition_spec(self) -> PartitionSpec:
        """PartitionSpec over logical dims only (replica dims replicate by
        omission), trailing replicated dims dropped, as in JAX."""
        entries = []
        for d, axes in zip(self.shape.dims, self.axis_assignment):
            if d.is_replica_dim:
                continue
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def __repr__(self):
        return (f"ParallelTensor({self.name}, {self.shape}, "
                f"spec={self.partition_spec()})")


def spec_assignment(spec: Optional[tuple], ndim: int) -> tuple:
    """PartitionSpec (or None) -> per-dim axis tuples (JAX
    `parallel/ops._spec_assignment`)."""
    entries = []
    for i in range(ndim):
        e = spec[i] if spec is not None and i < len(spec) else None
        if e is None:
            entries.append(())
        elif isinstance(e, (tuple, list)):
            entries.append(tuple(e))
        else:
            entries.append((e,))
    return tuple(entries)

