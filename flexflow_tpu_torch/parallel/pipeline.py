"""Pipeline parallelism over the `pipe` mesh axis (twin of
`flexflow_tpu/parallel/pipeline.py`).

L homogeneous blocks (stacked weights, leading dim L) split into P =
|pipe| stages of L/P blocks each. The batch splits into M microbatches
(default 2 P); stage p runs its blocks on microbatch m once stage p - 1
has sent it (stage 0 takes it from the input), then sends the result on
to p + 1: the GPipe fill/drain order of JAX's tick loop. Unlike SPMD
JAX, a stage runs no placeholder ticks: each rank runs its L/P blocks on
the M valid microbatches only, so a step launches each block's kernels
M times forward and M times again in the recompute, on every stage (L/P
x M x 2 forwards and L/P x M backwards a stage; JAX's stages run M + P -
1 ticks each).

Stage p -> p + 1 is a one-sided neighbour send (`_send`, `_recv`): JAX's
permutation [(i, i + 1)] is no bijection, and the ring hop
(`parallel.ops._Hop`) rightly refuses one. The backward is the reverse
of the forward (JAX: the transposed scan): the microbatches in reverse,
each stage taking the output's cotangent from p + 1 (the last stage from
the loss), running its blocks' backward and sending the input's
cotangent back to p - 1. Each block is recomputed in the backward from
its input, which the forward keeps (JAX: `jax.checkpoint` around each
block, as `ops/pipeline_blocks.py` wraps it), so gradients are exact with
respect to the sequential stack. The forward and backward are one
`autograd.Function` (`_Pipeline`), so every stage posts its sends and
receives in the schedule's order whatever the autograd engine would
order.

The last stage's output reaches every pipe rank (JAX: the masked psum),
a broadcast; the input's gradient, computed on stage 0, reaches every
pipe rank the same way, as the executor's rule for a tensor replicated
over an axis wants (`parallel/spmd.py`). 1F1B is not this module's.
"""

from __future__ import annotations

import torch

from ..machine import AXIS_PIPE

def _layer(stacked: dict, i: int) -> dict:
    return {k: w[i] for k, w in stacked.items()}


def _sequential(stacked, x, block_fn):
    """Reference semantics: apply the L stacked blocks in order. The
    stack is unbound once, so the backward stacks the L blocks' gradients
    in one op a weight (indexing block i alone would add a whole-stack
    gradient per block)."""
    keys = tuple(stacked)
    for ws in zip(*(stacked[k].unbind(0) for k in keys)):
        x = block_fn(dict(zip(keys, ws)), x)
    return x


def _send(x: torch.Tensor, group, index: int):
    """Post the send of `x` to the group's rank `index`; returns the
    requests (wait before `x` is freed or written)."""
    import torch.distributed as dist

    return dist.batch_isend_irecv([dist.P2POp(
        dist.isend, x.contiguous(), group.global_rank(index), group.pg)])


def _recv(like: torch.Tensor, group, index: int) -> torch.Tensor:
    """A tensor shaped like `like`, received from the group's rank
    `index`."""
    import torch.distributed as dist

    out = torch.empty_like(like)
    for r in dist.batch_isend_irecv([dist.P2POp(
            dist.irecv, out, group.global_rank(index), group.pg)]):
        r.wait()
    return out


def _broadcast(x: torch.Tensor, group, index: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    dist.broadcast(x, group.global_rank(index), group=group.pg)
    return x


class _Pipeline(torch.autograd.Function):
    """The fill/drain schedule of one stage and its reverse. Inputs: x
    (this rank's batch rows, whole on every pipe rank), then the stage's
    stacked weights in `keys` order."""

    @staticmethod
    def forward(ctx, x, block_fn, group, num_micro, keys, *weights):
        p, P = group.index, group.size
        stacked = dict(zip(keys, weights))
        local = weights[0].shape[0]
        mbs = x.reshape((num_micro, x.shape[0] // num_micro) + x.shape[1:])
        saved, outs, pending = [], [], []
        keep = any(ctx.needs_input_grad)
        for m in range(num_micro):
            a = mbs[m] if p == 0 else _recv(mbs[m], group, p - 1)
            ins = []
            for i in range(local):
                ins.append(a)
                a = block_fn(_layer(stacked, i), a)
            saved.append(ins if keep else None)
            if p < P - 1:
                pending += _send(a, group, p + 1)
            outs.append(a)  # a send's tensor is held until it is done
        for r in pending:
            r.wait()
        y = (torch.cat(outs) if p == P - 1
             else torch.empty(x.shape, dtype=outs[0].dtype,
                              device=x.device))
        ctx.saved, ctx.block_fn, ctx.group = saved, block_fn, group
        ctx.num_micro, ctx.keys = num_micro, keys
        ctx.save_for_backward(*weights)
        return _broadcast(y.reshape(x.shape), group, P - 1)

    @staticmethod
    def backward(ctx, g):
        group, M = ctx.group, ctx.num_micro
        p, P = group.index, group.size
        weights = ctx.saved_tensors
        local = weights[0].shape[0]
        gw = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              for w in weights]
        gms = g.reshape((M, g.shape[0] // M) + g.shape[1:])
        gx, pending = [None] * M, []
        for m in reversed(range(M)):
            gm = gms[m] if p == P - 1 else _recv(gms[m], group, p + 1)
            for i in reversed(range(local)):
                a = ctx.saved[m][i].detach().requires_grad_(True)
                w_i = [w[i].detach().requires_grad_(True) for w in weights]
                with torch.enable_grad():
                    out = ctx.block_fn(dict(zip(ctx.keys, w_i)), a)
                grads = torch.autograd.grad(out, [a] + w_i, gm,
                                            allow_unused=True)
                gm = grads[0]
                for acc, gi in zip(gw, grads[1:]):
                    if gi is not None:
                        acc[i] += gi.float()
            gx[m] = gm
            if p > 0:
                pending += _send(gm, group, p - 1)
        for r in pending:
            r.wait()
        dx = (torch.cat(gx) if p == 0 else torch.empty(
            g.shape, dtype=gx[0].dtype, device=g.device))
        dx = _broadcast(dx.reshape(g.shape), group, 0)
        ctx.saved = None
        return (dx, None, None, None, None,
                *(a.to(w.dtype) for a, w in zip(gw, weights)))


def _pipelined_local(stacked_shard, x, *, block_fn, group, num_micro: int):
    """Per-stage body: `stacked_shard` this stage's (L/P, ...) weights, `x`
    this rank's batch rows (whole over the pipe axis)."""
    b = x.shape[0]
    m = num_micro
    if b % m != 0:
        raise ValueError(
            f"pipeline: local batch {b} does not divide into "
            f"{m} microbatches (global batch must be a multiple of "
            f"data-axis size × num_microbatches)")
    # the step's first call, which is eager (`executor.CapturedStep`'s
    # warm-up), opens the group for the one-sided sends
    group.open(x.device)
    keys = tuple(stacked_shard)
    return _Pipeline.apply(x, getattr(block_fn, "raw", block_fn), group, m,
                           keys, *(stacked_shard[k] for k in keys))


def pipeline_apply(stacked, x, block_fn, *, mesh=None,
                   num_microbatches: int = 0, num_layers: int = 0,
                   axis_name: str = AXIS_PIPE):
    """Apply L stacked homogeneous blocks to x, pipelined over `axis_name`
    when the mesh has one (the sequential stack otherwise; the two are
    numerically the same function).

    stacked: {name: tensor with leading dim L/P}, this stage's blocks in
    layer order (the executor's layout: the weights sharded over `pipe`
    on dim 0; with no pipe axis, the whole stack); `num_layers` the
    stack's L (default: the blocks held times P); x: this rank's (batch,
    ...) rows; block_fn(one block's weights, x) -> x'. A block_fn with a
    `raw` attribute (the checkpointed block of `ops/pipeline_blocks.py`)
    is recomputed through `raw`: the schedule keeps each block's input
    itself. num_microbatches 0 -> 2 P; the local batch must divide by
    it."""
    group = mesh.group((axis_name,)) if mesh is not None else None
    if group is None:
        return _sequential(stacked, x, block_fn)
    p = group.size
    held = next(iter(stacked.values())).shape[0]
    num_layers = num_layers or held * p
    if num_layers % p != 0:
        raise ValueError(
            f"pipeline: {num_layers} blocks do not divide over "
            f"{p} pipeline stages")
    if held * p != num_layers:
        raise ValueError(
            f"pipeline: a stage holds {held} blocks, not {num_layers} / {p}")
    m = num_microbatches or 2 * p
    return _pipelined_local(stacked, x, block_fn=block_fn, group=group,
                            num_micro=m)
