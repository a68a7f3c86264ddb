"""Ring attention over the `seq` mesh axis (twin of
`flexflow_tpu/parallel/ring_attention.py`).

Queries stay on their sequence shard while the K/V blocks rotate around
the seq group, point to point (`parallel.ops._Hop`, shard i sends to
i + 1). The body runs on this rank's local (b, h, s_loc, d) blocks, as
the executor's sharded half does everywhere (`parallel/spmd.py`); the
rank's index in the seq group stands in for JAX's `axis_index`. JAX's
schedule, kept:

  - the hop delivering block k+1 is posted before block k's attention,
    so the transfer runs while the block computes;
  - each block's attention is the flash entry returning (out, lse)
    (`kernels.flash_attention.flash_attention_with_lse`: K5; its backward
    K6 and K7, or K8 where the block fits one tile, with the lse
    cotangent folded into delta), merged into the running pair by
    lse = logaddexp(lse, lse_blk), out = sum out_blk exp(lse_blk - lse);
  - under a causal mask step 0 is the resident block (the diagonal, the
    only one masked inside), and a block from a later shard (step > idx)
    is skipped: a plain branch on the rank's index, as there is no
    `lax.cond`. The hop still runs every step but the last, whose
    rotation no shard would read and which is never issued.

The backward is the transpose of that schedule, written out
(`_RingAttention`): the steps in reverse, each block's gradient taken by
autograd through its flash call and its merge, the gradient of the K/V
block a rank received at step k+1 sent back to the shard it came from
(the reverse hop) while block k's backward runs, and added there to that
shard's own gradient of the block. So every rank posts the same hops in
the same order whatever it skips, and no hop waits on a peer that has
moved on. The port has one schedule: `--no-overlap-collectives` is inert
here, as everywhere in the port.

With no mesh, or a seq axis of 1, `ring_attention` is `sdpa_xla`, as in
JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..machine import AXIS_SEQ


def _block_attention(q, k_blk, v_blk, *, causal: bool, scale: float):
    """One ring block's attention: (out f32, lse f32) through the flash
    (out, lse) entry."""
    from ..kernels.flash_attention import flash_attention_with_lse

    out, lse = flash_attention_with_lse(q, k_blk, v_blk, causal=causal,
                                        scale=scale)
    return out.float(), lse


def _merge_block(o, lse, o_blk, lse_blk):
    """Online merge of a new block's (out, lse) into the running pair.
    With lse initialised to -inf the first merge gives (o_blk, lse_blk)
    exactly (exp(-inf - finite) == 0)."""
    lse_new = torch.logaddexp(lse, lse_blk)
    o_new = (o * torch.exp(lse - lse_new)[..., None]
             + o_blk * torch.exp(lse_blk - lse_new)[..., None])
    return o_new, lse_new


def _live(step: int, idx: int, causal: bool) -> bool:
    """Whether the block held at `step` (from shard (idx - step) mod n)
    has a live key for this shard's queries: every block without a mask,
    else the diagonal and the blocks of earlier shards (step <= idx)."""
    return not causal or step <= idx


class _RingAttention(torch.autograd.Function):
    """`_ring_local`'s forward and its transposed schedule. The forward
    keeps, per live step, the autograd graph of that block's attention
    and merge over detached leaves (the residuals JAX's autodiff keeps);
    the backward walks the steps in reverse through them."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        from .ops import _Hop, ring_permutation

        n, idx = group.size, group.index
        b, h, s_loc, d = q.shape
        want = any(ctx.needs_input_grad[:3])
        perm = ring_permutation(n)
        o = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, h, s_loc), -math.inf, dtype=torch.float32,
                         device=q.device)
        k_blk, v_blk = k, v
        steps = []

        def leaf(t):
            return t.detach().requires_grad_(True) if want else t

        with torch.enable_grad() if want else contextlib.nullcontext():
            for step in range(n):
                # the hop for block step+1, posted before block step's
                # compute; the final rotation is never issued
                hop = (_Hop((k_blk, v_blk), group, perm)
                       if step < n - 1 else None)
                rec = None
                if _live(step, idx, causal):
                    rec = [leaf(q), leaf(k_blk), leaf(v_blk), leaf(o),
                           leaf(lse)]
                    o_new, lse_new = _merge_block(
                        rec[3], rec[4], *_block_attention(
                            rec[0], rec[1], rec[2],
                            causal=causal and step == 0, scale=scale))
                    rec += [o_new, lse_new]
                    o, lse = o_new.detach(), lse_new.detach()
                steps.append(rec if want else None)
                if hop is not None:
                    k_blk, v_blk = hop.wait()
        ctx.steps, ctx.group = steps, group
        ctx.shapes = (k.shape, k.dtype, v.shape, v.dtype)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        from .ops import _Hop, ring_permutation

        group = ctx.group
        n = group.size
        reverse = [(dst, src) for src, dst in ring_permutation(n)]
        k_shape, k_dtype, v_shape, v_dtype = ctx.shapes
        g_o = g.float()
        g_lse = None
        gq = None
        # the full gradient of the K/V block held at step + 1
        gk_next = gv_next = None
        for step in reversed(range(n)):
            hop = (_Hop((gk_next, gv_next), group, reverse)
                   if step < n - 1 else None)
            rec = ctx.steps[step]
            gk = gv = None
            if rec is not None:
                leaves, (o_new, lse_new) = rec[:5], rec[5:]
                outs, grads_out = [o_new], [g_o]
                if g_lse is not None:
                    outs.append(lse_new)
                    grads_out.append(g_lse)
                dq, gk, gv, g_o, g_lse = torch.autograd.grad(
                    outs, leaves, grads_out, allow_unused=True)
                gq = dq if gq is None else gq + dq
            if hop is not None:
                rk, rv = hop.wait()
                gk = rk if gk is None else gk + rk
                gv = rv if gv is None else gv + rv
            if gk is None:
                gk = g.new_zeros(k_shape, dtype=k_dtype)
                gv = g.new_zeros(v_shape, dtype=v_dtype)
            gk_next, gv_next = gk, gv
        ctx.steps = None
        return gq, gk_next, gv_next, None, None, None


def _ring_local(q, k, v, *, group, causal: bool, scale: float):
    """Per-shard body: q, k, v this rank's (b, h, s_loc, d) blocks of the
    sequence split over `group` (the seq axis), in shard order. Returns
    this rank's block of the attention output, in q's dtype."""
    return _RingAttention.apply(q, k, v, group, causal, scale)


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: float | None = None, mesh=None,
                   axis_name: str = AXIS_SEQ):
    """Exact attention with the seq dim split over `axis_name`: q, k, v
    are this rank's (batch, heads, seq / n, head_dim) blocks (its batch
    and head blocks too, where other axes split those). Falls back to
    `sdpa_xla` when there is no mesh or the axis has size 1."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.group((axis_name,)) if mesh is not None else None
    if group is None:
        from ..ops.attention import sdpa_xla

        return sdpa_xla(q, k, v, causal=causal, scale=scale)

    from .. import telemetry

    n = group.size
    telemetry.event("ring.attention", steps=n, overlap=True,
                    causal=bool(causal), seq=int(q.shape[2]) * n)
    return _ring_local(q, k, v, group=group, causal=causal, scale=scale)
