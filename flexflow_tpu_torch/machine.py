"""Machine abstraction: machine views, resources and the device mesh.

The twin of `flexflow_tpu/machine.py`: `MachineView` (the reference's
strided view of a flat device grid, the cost model's placement key),
`MachineResource`, the canonical mesh axis names, `batch_axes_for`,
`MeshShape`, and the mesh itself (130-156). `build_mesh` returns a `Mesh`
over the ranks of the `torch.distributed` world: one rank a device, rank
r at row-major position r of the axis grid, as JAX lays
`jax.devices()[:n]` over it. A `Mesh` has the surface of JAX's (`shape`,
`axis_names`, `size`, `devices`) plus what the executor needs: this
rank's coordinates and a process group over any tuple of its axes.
The executor keeps each rank's local blocks and moves them itself
(`parallel/spmd.py`), so no DTensor placement stands in for JAX's
`NamedSharding`. A mesh of one device needs no process group and runs
no collective.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np


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


class _Group:
    """The process group over some mesh axes that holds this rank: its
    torch group, its size, this rank's index in it (the chunk it owns
    when a dim is split over those axes) and its global ranks in
    index order."""

    def __init__(self, pg, ranks: list[int], rank: int):
        self.pg = pg
        self.ranks = ranks
        self.size = len(ranks)
        self.index = ranks.index(rank)
        # torch orders a group's ranks by global rank: its collectives'
        # position j holds chunk `order[j]` of ours (None: the same order)
        order = [ranks.index(r) for r in sorted(ranks)]
        self.order = None if order == list(range(self.size)) else order
        self.opened = False

    def global_rank(self, index: int) -> int:
        return self.ranks[index % self.size]

    def open(self, device):
        """A collective of every rank of the group, once, before its first
        one-sided send: NCCL makes a group's communicator at its first
        operation, which must then hold every rank (a first batched send
        of some of them hangs). Call it where every rank of the group
        does, outside a CUDA graph's capture."""
        if not self.opened:
            import torch
            import torch.distributed as dist

            dist.all_reduce(torch.zeros(1, device=device), group=self.pg)
            self.opened = True


class Mesh:
    """The global device mesh over the `torch.distributed` world (or one
    device with no process group). `shape` maps axis name -> size, in
    order, as a JAX mesh's does."""

    def __init__(self, mesh_shape: MeshShape, device, rank: int = 0):
        self.mesh_shape = mesh_shape
        self.shape = OrderedDict(zip(mesh_shape.axis_names,
                                     mesh_shape.axis_sizes))
        self.axis_names = tuple(mesh_shape.axis_names)
        self.device = device
        self.rank = rank
        grid = np.arange(mesh_shape.num_devices).reshape(
            mesh_shape.axis_sizes)
        self.rank_grid = grid
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(grid == rank)[0])))
        self._groups: dict[tuple, Optional[_Group]] = {}

    @property
    def size(self) -> int:
        return self.mesh_shape.num_devices

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid over the axis grid (JAX: the device grid)."""
        return self.rank_grid

    def axes_size(self, axes) -> int:
        return math.prod(self.shape.get(ax, 1) for ax in axes)

    def group(self, axes) -> Optional[_Group]:
        """The group over `axes` (in that order: the first axis major)
        that holds this rank, or None when they span one device. Making
        a group is collective: every rank makes every group over the same
        axes, in one order, so the first call for a tuple of axes must
        come on every rank in the same sequence (the executor makes its
        groups when it is built)."""
        axes = tuple(ax for ax in axes if self.shape.get(ax, 1) > 1)
        if not axes:
            return None
        if axes not in self._groups:
            import torch.distributed as dist

            order = list(axes) + [a for a in self.axis_names
                                  if a not in axes]
            perm = [self.axis_names.index(a) for a in order]
            g = self.rank_grid.transpose(perm).reshape(
                self.axes_size(axes), -1)
            mine = None
            for col in range(g.shape[1]):
                ranks = [int(r) for r in g[:, col]]
                pg = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = _Group(pg, ranks, self.rank)
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, rank={self.rank})"


def build_mesh(shape: MeshShape, device=None) -> Mesh:
    """The global mesh of `shape` over the process group's ranks (JAX
    `build_mesh`). It raises when the world holds fewer ranks than the
    mesh needs, and when a mesh of more than one device is asked for
    with no process group: the port never runs such a mesh on one
    device. A mesh of one device in a larger world is each rank's own
    (the one-rank reference of a multi-rank run)."""
    import torch
    import torch.distributed as dist

    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    n = shape.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return Mesh(shape, device)
    if not dist.is_initialized():
        raise ValueError(
            f"mesh needs {n} devices but only 1 available: no "
            f"torch.distributed process group (start the ranks with "
            f"torchrun, or call flexflow_tpu_torch.distributed.initialize)")
    if n > world:
        raise ValueError(
            f"mesh needs {n} devices but only {world} available")
    if n < world:
        raise ValueError(
            f"mesh of {n} devices in a world of {world} ranks: every rank "
            f"must hold one device of the mesh")
    return Mesh(shape, device, dist.get_rank())


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_num_shards(mesh: Mesh, spec) -> int:
    """How many shards a PartitionSpec cuts a tensor into on `mesh`."""
    n = 1
    for entry in spec:
        for ax in _spec_axes(entry):
            n *= mesh.shape[ax]
    return n
