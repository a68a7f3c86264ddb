"""The data movement between placements: the port's twin of the
collectives GSPMD inserts for the JAX executor's sharding constraints.

Every rank holds the local block of each tensor. A tensor's layout is its
per-dim tuple of mesh axes (only axes of size > 1 count: `normalize`).
`redistribute` moves a local block from one layout to another by
all-gathers and slices, each an `autograd.Function` whose backward is
its adjoint under one rule: the gradient of a tensor has the tensor's
layout and holds the full gradient of the local block (a replicated
tensor's gradient is the same on every rank of the axis). So:

  - gather (a dim's shards -> the whole dim): backward takes the rank's
    chunk of the gradient;
  - slice (the whole dim -> this rank's chunk): backward all-gathers the
    gradient's chunks;
  - `reduce_forward` (a partial sum -> its total, the "g" of Megatron):
    all-reduce forward, identity backward;
  - `reduce_backward` (a replicated tensor entering compute split over
    axes, the "f"): identity forward, all-reduce backward.

Weight gradients are the exception: each rank keeps the sum over its own
rows, and the executor reduces them once after the backward, over the
axes `parallel.ops.grad_sync_axes` names. `mask_grad` keeps that sum
right for an op run whole on every rank (its weight gradient is then
full on each): only the rank at coordinate 0 of the masked axes passes
it on. `ParamGather` is the stage-2/3 gather of a weight sharded at rest:
forward the all-gather (stage 2) or the ring all-gather (stage 3),
backward the gradient's reduce-scatter onto the shard, the same
reduction the replicated update runs (`sync_grad`), so every stage sums
the same elements in the same order.
"""

from __future__ import annotations

import torch


def normalize(assignment, mesh) -> tuple:
    """An assignment with the mesh's size-1 axes dropped."""
    return tuple(tuple(ax for ax in entry if mesh.shape.get(ax, 1) > 1)
                 for entry in assignment)


def layout_axes(layout) -> set:
    return {ax for entry in layout for ax in entry}


def local_shape(shape, layout, mesh) -> tuple:
    return tuple(s // mesh.axes_size(e) for s, e in zip(shape, layout))


def take_local(x: torch.Tensor, layout, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor `x` under `layout` (no
    autograd: staging and initialisation)."""
    for dim, entry in enumerate(layout):
        group = mesh.group(entry)
        if group is not None:
            chunk = x.shape[dim] // group.size
            x = x.narrow(dim, group.index * chunk, chunk)
    return x.contiguous()


# ------------------------------------------------------------ collectives


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's chunks of `x` along `dim`, concatenated in group
    order."""
    import torch.distributed as dist

    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((group.size * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    # all_gather_single where torch has it (all_gather_into_tensor is
    # deprecated there), the same collective
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, xs, group=group.pg)
    if group.order is not None:
        # torch's position j holds our chunk order[j]
        inv = [group.order.index(e) for e in range(group.size)]
        out = _rows(out.view(group.size, *xs.shape), inv).reshape(out.shape)
    return out.movedim(0, dim)


def _rows(v: torch.Tensor, order: list) -> torch.Tensor:
    """`v[order]` for a Python list of row indices, by one stack of its
    rows: a list index would be copied from the host, which a CUDA
    graph's capture refuses (ROADMAP C12)."""
    return torch.stack([v[j] for j in order])


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `x` over the group."""
    import torch.distributed as dist

    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // group.size,) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    if group.order is not None:
        # torch hands its position j the input's chunk j: put ours there
        xs = _rows(xs.view(group.size, -1), group.order).reshape(xs.shape)
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, xs, group=group.pg)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group.pg)
    return out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n).contiguous()


# ------------------------------------------------------------ transitions


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _MaskGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def reduce_forward(x, group):
    return x if group is None else _ReduceForward.apply(x, group)


def reduce_backward(x, group):
    return x if group is None else _ReduceBackward.apply(x, group)


def mask_grad(x, axes, mesh):
    """`x`, its gradient kept only at coordinate 0 of `axes`."""
    if not axes:
        return x
    keep = all(mesh.coords[ax] == 0 for ax in axes)
    return _MaskGrad.apply(x, keep)


def redistribute(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """`x`, this rank's block under layout `src`, as its block under
    `dst`: per dim, the axes past the common prefix are gathered (every
    dim first), then the new ones sliced."""
    if tuple(src) == tuple(dst):
        return x
    mid = []
    for dim, (a, b) in enumerate(zip(src, dst)):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        group = mesh.group(a[k:])
        if group is not None:
            x = _Gather.apply(x, group, dim)
        mid.append(k)
    for dim, (b, k) in enumerate(zip(dst, mid)):
        group = mesh.group(b[k:])
        if group is not None:
            x = _Slice.apply(x, group, dim)
    return x


# ------------------------------------------------------------ weights


class ParamGather(torch.autograd.Function):
    """A weight's compute-layout block from its at-rest shard (stages 2
    and 3): forward gathers dim `dim` over the update group, by one
    all-gather or (`ring`) by `ring_all_gather`'s hops; backward
    reduce-scatters the gradient, a partial sum over the group's ranks,
    onto the shard (`sync_grad`'s reduction)."""

    @staticmethod
    def forward(ctx, shard, group, dim, ring):
        ctx.group, ctx.dim = group, dim
        return gather_param(shard, group, dim, ring)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None, None


def gather_param(shard, group, dim: int, ring: bool) -> torch.Tensor:
    if ring:
        from .ops import _ring_all_gather_group

        return _ring_all_gather_group(shard, group, dim)
    return all_gather(shard, group, dim)


def sync_grad(g: torch.Tensor, group, dim) -> torch.Tensor:
    """A replicated weight's gradient summed over `group`: reduce-scatter
    along `dim` then all-gather (the reduction stage 2 and 3 run, so every
    stage sums alike), or, for a weight with no shardable dim (`dim`
    None), one all-reduce."""
    if group is None:
        return g
    if dim is None:
        return all_reduce(g, group)
    return all_gather(reduce_scatter(g, group, dim), group, dim)
