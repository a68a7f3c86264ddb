"""Machine abstraction: machine views, resources and mesh axis names.

The twin of the JAX-free half of `flexflow_tpu/machine.py` (26-128):
`MachineView` (the reference's strided view of a flat device grid, the
cost model's placement key), `MachineResource`, the canonical mesh axis
names, `batch_axes_for` and `MeshShape`. The mesh itself
(`build_mesh`, `spec_num_shards`, `named_sharding`) becomes a
`torch.distributed` DeviceMesh with ROADMAP A6; until then those names
raise, naming it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .config import not_ported


@dataclass(frozen=True)
class MachineView:
    """Strided view over a flat device id space; parity with
    machine_view.h:14-96. `dims[i]` = number of devices along view dim i."""

    ndims: int
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    start_device_id: int = 0
    device_type: str = "GPU"

    @staticmethod
    def make_1d(num_devices: int, start: int = 0, stride: int = 1) -> "MachineView":
        return MachineView(1, (num_devices,), (stride,), start)

    @property
    def num_parts(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1

    def device_ids(self) -> list[int]:
        ids = []
        for idx in np.ndindex(*self.dims) if self.dims else [()]:
            off = sum(i * s for i, s in zip(idx, self.strides))
            ids.append(self.start_device_id + off)
        return ids

    def hash(self) -> int:
        h = 17
        for v in (self.ndims, self.start_device_id, *self.dims, *self.strides):
            h = (h * 31 + v) & 0xFFFFFFFFFFFFFFFF
        return h

    def __repr__(self) -> str:
        return (
            f"MachineView(start={self.start_device_id}, dims={self.dims}, "
            f"strides={self.strides})"
        )


@dataclass(frozen=True)
class MachineResource:
    """Resource slice the DP search splits (reference machine_view.h: the
    MachineResource carried through graph_cost)."""

    num_nodes: int
    all_devices_per_node: int
    available_devices_per_node: int
    start_device_id: int = 0

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.available_devices_per_node


# Canonical mesh axis names, as in the JAX package. Degree-1 axes are
# harmless.
AXIS_DCN = "dcn"        # cross-host data parallel
AXIS_DATA = "data"      # batch / sample parallel
AXIS_MODEL = "model"    # tensor/attribute/parameter parallel
AXIS_PIPE = "pipe"      # pipeline stages
AXIS_SEQ = "seq"        # sequence/context parallel (ring attention)
AXIS_EXPERT = "expert"  # expert parallel (alias of model by default)

DEFAULT_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ)
MULTIHOST_AXES = (AXIS_DCN,) + DEFAULT_AXES


def batch_axes_for(axis_sizes: dict) -> tuple[str, ...]:
    """Mesh axes the batch dim rides under the data-parallel default: the
    DCN axis (outer, when present) composed with `data`."""
    axes = []
    if axis_sizes.get(AXIS_DCN, 1) > 1:
        axes.append(AXIS_DCN)
    if axis_sizes.get(AXIS_DATA, 1) > 1 or not axes:
        axes.append(AXIS_DATA)
    return tuple(axes)


@dataclass(frozen=True)
class MeshShape:
    """Declarative description of the global device mesh."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...] = DEFAULT_AXES

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(
                f"axis_sizes {self.axis_sizes} and axis_names {self.axis_names} "
                "must have equal rank"
            )

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes)

    @staticmethod
    def data_parallel(num_devices: int) -> "MeshShape":
        return MeshShape((num_devices, 1, 1, 1))


def build_mesh(*args, **kwargs):
    raise not_ported("machine.build_mesh (a torch.distributed DeviceMesh)",
                     "A6 (multi-GPU execution)")


def spec_num_shards(*args, **kwargs):
    raise not_ported("machine.spec_num_shards", "A6 (multi-GPU execution)")


def named_sharding(*args, **kwargs):
    raise not_ported("machine.named_sharding", "A6 (multi-GPU execution)")
