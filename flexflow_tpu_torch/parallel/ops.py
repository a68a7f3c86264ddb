"""Parallelization operators, ring collectives and the weight-update
sharding rules (twin of `flexflow_tpu/parallel/ops.py`).

Repartition, Combine, Replicate, Reduction, Pipeline and FusedParallelOp
are PCG nodes that change a tensor's placement (per-dim degree, replica
dims): their runtime body is the identity, and the executor moves the
data where a node's output placement differs from its input's, as the
JAX executor's sharding constraints make XLA do. `apply_parallel_op_shape`
is their IR shape transform and `derive_parallel_assignment` the mesh
axes a node's output takes.

The ring collectives run on this rank's local block over one mesh axis,
point to point (`torch.distributed.batch_isend_irecv`) in
`ring_permutation`'s order: shard i sends to i + 1. Each posts the next
hop before the work on the block already here, as the JAX bodies'
double-buffered schedule does.

`choose_update_dim`, `grad_sync_axes` and `weight_update_spec` are the one
definition of which dim of a weight shards over which axes under
weight-update sharding (ZeRO stages 2 and 3): the executor places the
masters, slots and gradients with them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..fftype import OperatorType as OT
from ..ops.base import OpDef, register_op
from ..tensor import (
    ParallelDim,
    ParallelTensorShape,
    PartitionSpec,
    spec_assignment,
)


@dataclass(frozen=True)
class RepartitionParams:
    """Increase the partition degree along `dim` by `degree`x; `axes`
    optionally names the mesh axes the new degree rides."""

    dim: int
    degree: int
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CombineParams:
    """Decrease the partition degree along `dim` by `degree`x; `axes`
    optionally names the mesh axes being freed."""

    dim: int
    degree: int
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ReplicateParams:
    """Add a replica dim of extent `degree`."""

    degree: int
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ReductionParams:
    """Sum-reduce a replica dim of extent `degree`."""

    degree: int
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class PipelineParams:
    """Stage boundary marker (OP_PIPELINE is enum-only in the reference)."""

    stage: int = 0


@dataclass(frozen=True)
class ParallelOpInfo:
    op_type: OT
    dim: int
    degree: int
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class FusedParallelOpParams:
    """Parallel transforms fused into one resharding."""

    ops: Tuple[ParallelOpInfo, ...]


def apply_parallel_op_shape(
    shape: ParallelTensorShape, op_type: OT, params
) -> ParallelTensorShape:
    """IR shape transform for one parallel op."""
    dims = list(shape.dims)
    axes = getattr(params, "axes", ())
    if op_type == OT.OP_REPARTITION:
        d = dims[params.dim]
        dims[params.dim] = replace(d, degree=d.degree * params.degree,
                                   axes=d.axes + tuple(axes))
    elif op_type == OT.OP_COMBINE:
        d = dims[params.dim]
        if d.degree % params.degree != 0:
            raise ValueError(
                f"combine degree {params.degree} does not divide {d.degree}"
            )
        new_axes = d.axes
        if axes and new_axes[-len(axes):] == tuple(axes):
            new_axes = new_axes[:-len(axes)]
        elif d.degree // params.degree == 1:
            new_axes = ()
        dims[params.dim] = replace(d, degree=d.degree // params.degree,
                                   axes=new_axes)
    elif op_type == OT.OP_REPLICATE:
        dims.append(
            ParallelDim(
                size=params.degree, degree=params.degree,
                is_replica_dim=True, axes=tuple(axes)
            )
        )
    elif op_type == OT.OP_REDUCTION:
        for i in range(len(dims) - 1, -1, -1):
            if dims[i].is_replica_dim:
                if dims[i].degree != params.degree:
                    raise ValueError(
                        f"reduction degree {params.degree} != replica degree "
                        f"{dims[i].degree}"
                    )
                dims.pop(i)
                break
        else:
            raise ValueError("reduction with no replica dim")
    elif op_type == OT.OP_FUSED_PARALLEL:
        s = shape
        for info in params.ops:
            sub = _INFO_PARAMS[info.op_type](info)
            s = apply_parallel_op_shape(s, info.op_type, sub)
        return s
    elif op_type == OT.OP_PIPELINE:
        pass
    else:
        raise ValueError(f"not a parallel op: {op_type}")
    return ParallelTensorShape(tuple(dims), shape.dtype)


_INFO_PARAMS = {
    OT.OP_REPARTITION: lambda i: RepartitionParams(i.dim, i.degree, i.axes),
    OT.OP_COMBINE: lambda i: CombineParams(i.dim, i.degree, i.axes),
    OT.OP_REPLICATE: lambda i: ReplicateParams(i.degree, i.axes),
    OT.OP_REDUCTION: lambda i: ReductionParams(i.degree, i.axes),
}


def _identity_infer(params, in_shapes):
    return [in_shapes[0]]


def _identity_forward(params, inputs, weights, state, ctx):
    # the executor moves the data to the node's output placement
    return [inputs[0]], state


def _zero_flops(params, in_shapes, out_shapes):
    return 0.0


for _ot in (
    OT.OP_REPARTITION,
    OT.OP_COMBINE,
    OT.OP_REPLICATE,
    OT.OP_REDUCTION,
    OT.OP_PIPELINE,
    OT.OP_FUSED_PARALLEL,
):
    register_op(
        OpDef(_ot, _identity_infer, _identity_forward, flops=_zero_flops)
    )


# ------------------------------------------------------------ rings


def ring_permutation(n: int) -> list:
    """THE ring-rotation schedule: shard i sends to (i + 1) mod n. Every
    ring body hops through `_ring_peers`, which refuses a permutation
    that is not a bijection on range(n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_peers(perm: list, n: int, index: int) -> tuple[int, int]:
    """(destination, source) of shard `index` under `perm`. A partial or
    duplicated permutation raises: a hop with no sender would leave a
    block unwritten."""
    srcs = sorted(s for s, _ in perm)
    dsts = sorted(d for _, d in perm)
    if srcs != list(range(n)) or dsts != list(range(n)):
        raise ValueError(
            f"ring permutation {perm} is not a bijection on range({n})")
    dst = next(d for s, d in perm if s == index)
    src = next(s for s, d in perm if d == index)
    return dst, src


class _Hop:
    """One ring hop of `x`, a tensor or a tuple of tensors moved together
    (one batch of sends, then one of receives, in the same order on every
    shard): posted at construction, the received block (or tuple)
    returned by `wait()`."""

    def __init__(self, x, group, perm: list):
        import torch.distributed as dist

        dst, src = _ring_peers(perm, group.size, group.index)
        self.many = isinstance(x, (tuple, list))
        xs = [t.contiguous() for t in (x if self.many else (x,))]
        self.out = [torch.empty_like(t) for t in xs]
        self.reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, group.global_rank(dst), group.pg)
             for t in xs]
            + [dist.P2POp(dist.irecv, o, group.global_rank(src), group.pg)
               for o in self.out])

    def wait(self):
        for r in self.reqs:
            r.wait()
        return tuple(self.out) if self.many else self.out[0]


def _axis_group(mesh, axis_name: str):
    return mesh.group((axis_name,)) if mesh is not None else None


def allgather_matmul(x, w, *, mesh=None, axis_name: Optional[str] = None):
    """Decomposed all_gather -> matmul: `x` (..., k/n) is this shard's
    block of the contraction dim over `axis_name` (n shards), `w` (k, m)
    holds every row; returns the full `all_gather(x) @ w` on every shard,
    scheduled as n block products, each x block rotating to the next
    shard while the product of the block already here runs. The products
    are f32 (JAX: preferred_element_type=f32), cast to x's dtype once. A
    plain product when there is no mesh or the axis has size 1."""
    from ..machine import AXIS_MODEL

    group = _axis_group(mesh, axis_name or AXIS_MODEL)
    if group is None:
        return torch.matmul(x.float(), w.to(x.dtype).float()).to(x.dtype)
    n, idx = group.size, group.index
    k_loc = x.shape[-1]
    if w.shape[0] != n * k_loc:
        raise ValueError(
            f"allgather_matmul: w has {w.shape[0]} rows, x's blocks "
            f"{n} x {k_loc}")
    perm = ring_permutation(n)
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=torch.float32,
                      device=x.device)
    blk = x
    for step in range(n):
        hop = _Hop(blk, group, perm) if step < n - 1 else None
        # the block held at `step` came from shard (idx - step) mod n
        src = (idx - step) % n
        rows = w[src * k_loc:(src + 1) * k_loc].to(x.dtype)
        acc = acc + torch.matmul(blk.float(), rows.float())
        if hop is not None:
            blk = hop.wait()
    return acc.to(x.dtype)


def ring_reduce_scatter(x, *, mesh=None, axis_name: Optional[str] = None):
    """Decomposed reduce-scatter over `axis_name`: `x` (m, ...) is this
    shard's full contribution; returns its (m/n, ...) chunk of the sum
    over the n shards, chunk `index`. The packet for chunk c starts on
    shard c + 1 and travels n - 1 hops, each shard adding its own chunk
    c (JAX `_rs_local`). The identity when there is no mesh or the axis
    has size 1."""
    from ..machine import AXIS_DATA

    group = _axis_group(mesh, axis_name or AXIS_DATA)
    if group is None:
        return x
    n, idx = group.size, group.index
    if x.shape[0] % n != 0:
        raise ValueError(
            f"ring_reduce_scatter: dim 0 of {tuple(x.shape)} must divide "
            f"by {axis_name!r} size {n}")
    chunk = x.shape[0] // n
    perm = ring_permutation(n)

    def take(c):
        c %= n
        return x[c * chunk:(c + 1) * chunk]

    acc = take(idx - 1).contiguous()
    for t in range(1, n):
        hop = _Hop(acc, group, perm)
        mine = take(idx - 1 - t)  # read while the hop is in flight
        acc = hop.wait() + mine
    return acc


def ring_all_gather(x, *, mesh=None, axis_name: Optional[str] = None,
                    dim: int = 0):
    """Decomposed all-gather over `axis_name`: `x` is this shard's chunk
    along `dim`; returns every shard's chunk concatenated in shard order
    (JAX `_ag_local`), n - 1 hops, each posted before the received block
    is written. The identity when there is no mesh or the axis has size
    1."""
    from ..machine import AXIS_DATA

    group = _axis_group(mesh, axis_name or AXIS_DATA)
    if group is None:
        return x
    return _ring_all_gather_group(x, group, dim)


def _ring_all_gather_group(x, group, dim: int):
    n, idx = group.size, group.index
    perm = ring_permutation(n)
    chunk = x.shape[dim]
    shape = x.shape[:dim] + (n * chunk,) + x.shape[dim + 1:]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, idx * chunk, chunk).copy_(x)
    hop = _Hop(x, group, perm)
    for t in range(1, n):
        moved = hop.wait()
        if t < n - 1:
            hop = _Hop(moved, group, perm)  # in flight during the write
        out.narrow(dim, ((idx - t) % n) * chunk, chunk).copy_(moved)
    return out


# ------------------------------------------------- weight-update sharding


def choose_update_dim(shape, assignment, axes, axis_sizes) -> Optional[int]:
    """The dim of a weight `shape` to shard for the ZeRO-style update, or
    None: the FIRST dim whose size divides by (its existing degree x the
    update degree). A weight already sharded over an update axis is
    skipped."""
    deg = 1
    for ax in axes:
        deg *= axis_sizes.get(ax, 1)
    if deg <= 1:
        return None
    used = {ax for entry in (assignment or ()) for ax in entry}
    if used.intersection(axes):
        return None
    for i, size in enumerate(shape):
        have = 1
        if assignment and i < len(assignment):
            for ax in assignment[i]:
                have *= axis_sizes.get(ax, 1)
        if size % (have * deg) == 0:
            return i
    return None


def grad_sync_axes(out_axes, weight_axes) -> Tuple[str, ...]:
    """The mesh axes a trainable weight's gradient is reduced over: every
    axis its node's output shards that the weight itself does not,
    sorted."""
    return tuple(sorted(set(out_axes) - set(weight_axes)))


def weight_update_spec(shape, base_spec, axes, axis_sizes):
    """PartitionSpec of a weight's master, gradient and optimizer slots
    under weight-update sharding: `base_spec` (the plan's compute
    placement) with the update `axes` appended onto the dim
    `choose_update_dim` picks; None when no dim is shardable (the weight
    stays replicated)."""
    assignment = spec_assignment(base_spec, len(shape))
    dim = choose_update_dim(shape, assignment, axes, axis_sizes)
    if dim is None:
        return None
    entries = []
    for i, entry in enumerate(assignment):
        merged = entry + tuple(axes) if i == dim else entry
        if not merged:
            entries.append(None)
        elif len(merged) == 1:
            entries.append(merged[0])
        else:
            entries.append(tuple(merged))
    return PartitionSpec(*entries)


def derive_parallel_assignment(op_type: OT, params, in_assignment, mesh):
    """Mesh-axis assignment of an explicit parallel-op node's output,
    from its input's. Repartition takes the first mesh axis of the
    requested size that the tensor does not use yet (or the axes the op
    names); Combine frees the innermost axes of the dim; Replicate and
    Reduction pass the assignment through."""
    a = [list(x) for x in in_assignment]
    shape = dict(mesh.shape)
    declared = tuple(getattr(params, "axes", ()))
    if op_type == OT.OP_REPARTITION:
        used = {ax for entry in a for ax in entry}
        if declared:
            dup = used.intersection(declared)
            if dup or len(set(declared)) != len(declared):
                raise ValueError(
                    f"repartition(axes={declared}): axes already sharding "
                    f"this tensor ({sorted(used)})")
            a[params.dim].extend(declared)
        else:
            for name, size in shape.items():
                if size == params.degree and name not in used:
                    a[params.dim].append(name)
                    break
            else:
                raise ValueError(
                    f"repartition(degree={params.degree}): no unused mesh "
                    f"axis of that size in {shape}"
                )
    elif op_type == OT.OP_COMBINE:
        if declared and a[params.dim][-len(declared):] == list(declared):
            del a[params.dim][-len(declared):]
        else:
            removed = 1
            while removed < params.degree and a[params.dim]:
                removed *= shape[a[params.dim].pop()]
            if removed != params.degree:
                raise ValueError(
                    f"combine(degree={params.degree}) cannot unshard "
                    f"assignment {in_assignment[params.dim]} over {shape}"
                )
    elif op_type == OT.OP_FUSED_PARALLEL:
        cur = tuple(tuple(x) for x in a)
        for info in params.ops:
            sub = _INFO_PARAMS.get(info.op_type)
            if sub is not None:
                cur = derive_parallel_assignment(
                    info.op_type, sub(info), cur, mesh
                )
        return cur
    return tuple(tuple(x) for x in a)
