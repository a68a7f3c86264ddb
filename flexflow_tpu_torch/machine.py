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

A sub-mesh lays the axis grid over an explicit list of world ranks
(`build_mesh(..., ranks=...)`), the world's other ranks parked: only an
elastic re-plan (elastic/), or a control run beside one, asks for it; a
plain compile keeps the whole world. Making a group is collective over
the world, so a sub-mesh makes every group it can need (one per set of
its axes, and a host group for flags) in its constructor, which every
world rank runs at the same point, parked ranks included.
The executor keeps each rank's local blocks and moves them itself
(`parallel/spmd.py`), so no DTensor placement stands in for JAX's
`NamedSharding`. A mesh of one device needs no process group and runs
no collective.
"""

from __future__ import annotations

import itertools
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
    order, as a JAX mesh's does. `ranks` (a sub-mesh) are the world ranks
    laid row-major over the axis grid; `member` says whether this rank
    holds a device of it (`coords` is None on a parked rank)."""

    def __init__(self, mesh_shape: MeshShape, device, rank: int = 0,
                 ranks: Optional[list] = None):
        self.mesh_shape = mesh_shape
        self.shape = OrderedDict(zip(mesh_shape.axis_names,
                                     mesh_shape.axis_sizes))
        self.axis_names = tuple(mesh_shape.axis_names)
        self.device = device
        self.rank = rank
        self.sub = ranks is not None
        self.ranks = ([int(r) for r in ranks] if self.sub
                      else list(range(mesh_shape.num_devices)))
        grid = np.asarray(self.ranks).reshape(mesh_shape.axis_sizes)
        self.rank_grid = grid
        self.member = rank in self.ranks
        self.coords = (dict(zip(self.axis_names,
                                (int(c) for c in
                                 np.argwhere(grid == rank)[0])))
                       if self.member else None)
        self._groups: dict[tuple, Optional[_Group]] = {}
        # a sub-mesh's torch groups, by their sorted ranks, and the gloo
        # group its members agree host flags over (None: one member)
        self._pgs: dict[tuple, object] = {}
        self.host_group = None
        if self.sub and self.size > 1:
            self._make_groups()

    def _make_groups(self):
        """Every torch group a sub-mesh can need, made on every world rank
        in one order (collective): one per column of each set of its
        axes of size > 1, then the members' gloo host group."""
        import torch.distributed as dist

        axes = [a for a in self.axis_names if self.shape[a] > 1]
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                for col in self._columns(sub):
                    key = tuple(sorted(col))
                    if key not in self._pgs:
                        self._pgs[key] = dist.new_group(list(key))
        self.host_group = (self._pgs[tuple(sorted(self.ranks))]
                           if dist.get_backend() == "gloo"
                           else dist.new_group(sorted(self.ranks),
                                               backend="gloo"))

    def _columns(self, axes) -> list[list[int]]:
        """The rank lists of the groups over `axes` (the first major)."""
        order = list(axes) + [a for a in self.axis_names if a not in axes]
        perm = [self.axis_names.index(a) for a in order]
        g = self.rank_grid.transpose(perm).reshape(self.axes_size(axes), -1)
        return [[int(r) for r in g[:, col]] for col in range(g.shape[1])]

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
        groups when it is built). A sub-mesh made its groups already."""
        axes = tuple(ax for ax in axes if self.shape.get(ax, 1) > 1)
        if not axes:
            return None
        if axes not in self._groups:
            import torch.distributed as dist

            mine = None
            for ranks in self._columns(axes):
                pg = (self._pgs[tuple(sorted(ranks))] if self.sub
                      else dist.new_group(ranks))
                if self.rank in ranks:
                    mine = _Group(pg, ranks, self.rank)
            self._groups[axes] = mine
        return self._groups[axes]

    def all_group(self) -> Optional[_Group]:
        """The group of every device of the mesh (None: one device)."""
        return self.group(self.axis_names)

    def __repr__(self):
        extra = f", ranks={self.ranks}" if self.sub else ""
        return f"Mesh({dict(self.shape)}, rank={self.rank}{extra})"


# sub-meshes made in this process, by (sizes, names, ranks, device): a
# re-plan onto a sub-mesh it ran on before makes no group again
_SUB_MESHES: dict[tuple, Mesh] = {}


def build_mesh(shape: MeshShape, device=None,
               ranks: Optional[list] = None) -> Mesh:
    """The global mesh of `shape` over the process group's ranks (JAX
    `build_mesh`). It raises when the world holds fewer ranks than the
    mesh needs, and when a mesh of more than one device is asked for
    with no process group: the port never runs such a mesh on one
    device. A mesh of one device in a larger world is each rank's own
    (the one-rank reference of a multi-rank run).

    `ranks` lays the mesh over those world ranks, the others parked (an
    elastic re-plan's sub-mesh; every world rank calls it at the same
    point). A rank past the world is refused: a `torchrun` world cannot
    grow inside its process group. Without `ranks` a mesh smaller than
    the world is refused: every rank of a plain compile holds a
    device."""
    import torch
    import torch.distributed as dist

    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    n = shape.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if len(ranks) != n or len(set(ranks)) != n:
            raise ValueError(
                f"a mesh of {n} devices needs {n} distinct ranks, got "
                f"{ranks}")
        if min(ranks) < 0 or max(ranks) >= world:
            raise ValueError(
                f"mesh ranks {ranks} reach past the torchrun world of "
                f"{world} ranks: a world cannot grow inside its process "
                f"group (restart torchrun with more ranks)")
        if ranks == list(range(world)):
            ranks = None  # the whole world: the plain mesh
        elif world > 1:
            key = (tuple(shape.axis_sizes), tuple(shape.axis_names),
                   tuple(ranks), str(device))
            mesh = _SUB_MESHES.get(key)
            if mesh is None:
                mesh = _SUB_MESHES[key] = Mesh(shape, device,
                                               dist.get_rank(), ranks)
            return mesh
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
