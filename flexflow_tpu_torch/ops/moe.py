"""Mixture-of-Experts operators: Group_by, Aggregate, AggregateSpec, Cache
and the fused stacked Experts (twins of `flexflow_tpu/ops/moe.py`).

Routing is the JAX package's: expert buffers hold `capacity = ceil(alpha
* k * batch / n)` rows, a token's slot is its rank among the tokens
routed to the same expert in sample-major order (a cumsum over a one-hot
routing matrix), and tokens at or past capacity are dropped (group_by.cu
semantics): they fill no buffer row and read back as zeros.

The rows move between the token order and the (expert, slot) buffers by
`_PermuteRows`, a gather whose backward is the gather of the inverse map:
each valid (expert, slot) pair holds exactly one token and each token row
fills at most one pair, so neither direction adds two rows into one and
the backward is deterministic without float atomics (the captured and
eager steps are bit-equal on the card). The stacked expert product is one
batched matmul, as the JAX package computes it outside any Pallas kernel.

The load-balance term the reference injects in aggregate's backward
(lambda_bal) is an auxiliary loss in the op's state (`aux_loss`); the
executor pops it and the loss adds it, so autograd gives the same gate
gradients.

Expert parallelism (the executor's `_experts_rule`): the Experts op runs
on this rank's token rows (its batch block) and its block of the stacked
experts, `ctx.experts` naming the groups. The routing is ranked over the
global batch (the assignment gathered over the batch's axes), so a mesh
drops the tokens one device drops; each rank computes its local tokens
through its local experts, and the rule all-reduces the partial outputs
over the experts' axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..fftype import DataType, OperatorType as OT
from .base import OpDef, WeightSpec, register_op


def expert_capacity(n: int, k: int, batch: int, alpha: float) -> int:
    return max(1, int(math.ceil(alpha * k * batch / n)))


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.int32) -> torch.Tensor:
    # a comparison, not F.one_hot: no range check that reads the device
    # back (a captured step may not sync)
    return (idx.unsqueeze(-1) == torch.arange(
        n, device=idx.device, dtype=idx.dtype)).to(dtype)


def _exclusive_ranks(onehot: torch.Tensor) -> torch.Tensor:
    """Per column, the count of ones in the rows before each row: the
    rank of a row among its column's rows. Scanned along the inner dim of
    the transposed (n, rows) matrix (a column scan over few columns is
    the slow case of the device's scan)."""
    return (torch.cumsum(onehot.t(), dim=1, dtype=torch.int32).t()
            - onehot)


def routing_slots(assign: torch.Tensor, n: int, capacity: int):
    """assign: (batch, k) expert ids -> (slot, valid), each (batch, k):
    slot[i, j] is the rank of token (i, j) among the tokens routed to
    assign[i, j], in sample-major order; valid = slot < capacity."""
    b, k = assign.shape
    flat = assign.reshape(-1).long()
    ranks = _exclusive_ranks(_one_hot(flat, n))
    slot = ranks.gather(1, flat.unsqueeze(1)).squeeze(1)
    valid = slot < capacity
    return slot.reshape(b, k), valid.reshape(b, k)


class _PermuteRows(torch.autograd.Function):
    """out[i] = x[idx[i]], reading zeros where idx[i] == len(x); `inv`
    maps each row of x to the output row that reads it (len(out) where
    none does). Every row of x is read at most once, so the backward is
    the gather grad_x[j] = grad_out[inv[j]]."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return pad.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return pad.index_select(0, inv), None, None


def _slot_maps(assign, slot, valid, n: int, cap: int):
    """The two index maps between token copies (b * k rows, sample-major)
    and buffer rows (n * cap, expert-major): `to_buffer[p]` is the token
    copy in buffer row p (b * k where the row is empty), `to_token[j]`
    the buffer row of token copy j (n * cap where it was dropped)."""
    rows = assign.numel()
    flat_valid = valid.reshape(-1)
    pos = assign.reshape(-1).long() * cap + slot.reshape(-1).long()
    to_token = torch.where(flat_valid, pos, torch.full_like(pos, n * cap))
    # dropped copies all write the spare last entry, which is cut off
    to_buffer = torch.full((n * cap + 1,), rows, dtype=torch.long,
                           device=assign.device)
    to_buffer = to_buffer.scatter(
        0, to_token, torch.arange(rows, device=assign.device))[:n * cap]
    return to_buffer, to_token


def _scatter_to_buffers(data, assign, n: int, cap: int, slot, valid):
    """Token rows into stacked (n, cap, dim) expert buffers; dropped
    tokens fill no row (group_by.cu semantics). Shared by Group_by and the
    fused Experts op, so routing can never desynchronize."""
    b, d = data.shape
    k = assign.shape[1]
    to_buffer, to_token = _slot_maps(assign, slot, valid, n, cap)
    copies = data.unsqueeze(1).expand(b, k, d).reshape(b * k, d)
    return _PermuteRows.apply(copies, to_buffer, to_token).reshape(n, cap, d)


def _gather_expert_rows(stacked, assign, slot, valid):
    """Each token's expert output row from stacked (n, cap, dim); dropped
    tokens read as zeros (aggregate.cu semantics). Returns rows (b, k,
    dim)."""
    n, cap, d = stacked.shape
    b, k = assign.shape
    to_buffer, to_token = _slot_maps(assign, slot, valid, n, cap)
    rows = _PermuteRows.apply(stacked.reshape(n * cap, d), to_token,
                              to_buffer)
    return rows.reshape(b, k, d)


def _balance_term(n: int, e_idx, gate_probs, total_rows: int, tokens: int):
    """The Shazeer-style load-balance objective: n x sum over experts of
    (the share of token copies routed there) x (the mean gate probability
    there). `gate_probs` (rows, n) may be this rank's rows of the batch:
    their sum over `total_rows` is then this rank's share of the mean."""
    counts = _one_hot(e_idx.reshape(-1), n, torch.float32).sum(dim=0)
    frac_tokens = counts / tokens
    frac_probs = gate_probs.float().sum(dim=0) / total_rows
    return n * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------- Group_by

@dataclass(frozen=True)
class GroupByParams:
    n: int
    alpha: float


def _group_by_infer(p: GroupByParams, in_shapes):
    data, assign = in_shapes
    batch, dim = data
    k = assign[1]
    cap = expert_capacity(p.n, k, batch, p.alpha)
    return [(cap, dim) for _ in range(p.n)]


def _group_by_forward(p: GroupByParams, inputs, weights, state, ctx):
    data, assign = inputs
    batch = data.shape[0]
    k = assign.shape[1]
    cap = expert_capacity(p.n, k, batch, p.alpha)
    slot, valid = routing_slots(assign, p.n, cap)
    buffers = _scatter_to_buffers(data, assign, p.n, cap, slot, valid)
    return list(buffers.unbind(0)), state


register_op(
    OpDef(OT.OP_GROUP_BY, _group_by_infer, _group_by_forward, num_outputs=-1)
)


# ---------------------------------------------------------------- Aggregate

@dataclass(frozen=True)
class AggregateParams:
    n: int
    lambda_bal: float = 0.0


def _aggregate_infer(p: AggregateParams, in_shapes):
    # inputs: gate_preds (b,k), gate_assign (b,k), true_gate_assign (b,k),
    #         full_gate_grads (b,n), exp_pred_1..n (cap, out_dim)
    return [(in_shapes[0][0], in_shapes[4][1])]


def _aggregate_forward(p: AggregateParams, inputs, weights, state, ctx):
    gate_preds, gate_assign = inputs[0], inputs[1]
    exp_preds = torch.stack(inputs[4:4 + p.n])  # (n, cap, dim)
    b, k = gate_assign.shape
    slot, valid = routing_slots(gate_assign, p.n, exp_preds.shape[1])
    rows = _gather_expert_rows(exp_preds, gate_assign, slot, valid)
    out = torch.einsum("bk,bkd->bd", gate_preds.to(rows.dtype), rows)
    if p.lambda_bal > 0.0:
        # full_gate: the softmax over all experts (b, n)
        aux = _balance_term(p.n, gate_assign, inputs[3], b, b * k)
        state = dict(state or {})
        state["aux_loss"] = p.lambda_bal * aux
    return [out], state


register_op(OpDef(OT.OP_AGGREGATE, _aggregate_infer, _aggregate_forward))


# ---------------------------------------------------------------- AggregateSpec

@dataclass(frozen=True)
class AggregateSpecParams:
    n: int
    lambda_bal: float = 0.0


def _agg_spec_infer(p: AggregateSpecParams, in_shapes):
    # one row per token copy (k * b, dim), copy-major, scored against
    # labels replicated k times (the executor's `label_replication`,
    # the reference's model.cc:2875)
    b, k = in_shapes[0]
    return [(k * b, in_shapes[4][1])]


def _agg_spec_forward(p: AggregateSpecParams, inputs, weights, state, ctx):
    gate_assign = inputs[1]
    exp_preds = torch.stack(inputs[4:4 + p.n])
    b, k = gate_assign.shape
    slot, valid = routing_slots(gate_assign, p.n, exp_preds.shape[1])
    rows = _gather_expert_rows(exp_preds, gate_assign, slot, valid)
    return [rows.transpose(0, 1).reshape(k * b, -1)], state


register_op(OpDef(OT.OP_AGG_SPEC, _agg_spec_infer, _agg_spec_forward))


# ---------------------------------------------------------------- Cache

@dataclass(frozen=True)
class CacheParams:
    num_batches: int
    data_type: DataType = DataType.DT_FLOAT


def _cache_infer(p: CacheParams, in_shapes):
    return [in_shapes[0]]


def _cache_weights(p: CacheParams, in_shapes):
    return [
        WeightSpec("cached", in_shapes[0], p.data_type, "zeros",
                   trainable=False),
        # staleness score of the cached activation (cache.h:14-65's score
        # function), a non-trainable stat on the device
        WeightSpec("score", (), DataType.DT_FLOAT, "zeros", trainable=False),
    ]


def cache_score(x: torch.Tensor, cached: torch.Tensor) -> torch.Tensor:
    """Staleness of `cached` against the live activation `x` (the
    reference's CacheScore, cache.h:14-65): the relative moving
    difference, 0 identical, 1 fully drifted."""
    xf = x.float()
    cf = cached.float()
    num = torch.sum(torch.abs(xf - cf))
    den = torch.sum(torch.abs(xf)) + 1e-8
    return torch.clamp(num / den, max=1.0)


def _cache_forward(p: CacheParams, inputs, weights, state, ctx):
    (x,) = inputs
    state = dict(state or {})
    if ctx.training:
        # score the previous cache against the live batch, then pass
        # through and refresh it (the reference's cache_update task)
        xd = x.detach()
        state["score"] = cache_score(xd, weights["cached"])
        state["cached"] = xd.to(weights["cached"].dtype)
        return [x], state
    return [weights["cached"].to(x.dtype)], state


register_op(OpDef(OT.OP_CACHE, _cache_infer, _cache_forward, _cache_weights))


# ---------------------------------------------------------------- Experts
# The group_by -> per-expert dense -> aggregate trio as ONE op over a
# stacked (n, in, hidden) expert weight, so expert parallelism is a
# sharding of its dim 0 (the JAX package's TPU-native addition).

@dataclass(frozen=True)
class ExpertsParams:
    n: int
    hidden_size: int
    alpha: float = 1.0
    lambda_bal: float = 0.0
    use_bias: bool = True
    activation: str = "relu"  # relu | gelu | none


def _experts_infer(p: ExpertsParams, in_shapes):
    return [(in_shapes[0][0], p.hidden_size)]


def _experts_weights(p: ExpertsParams, in_shapes):
    d = in_shapes[0][1]
    ws = [WeightSpec("kernel", (p.n, d, p.hidden_size), DataType.DT_FLOAT)]
    if p.use_bias:
        ws.append(
            WeightSpec("bias", (p.n, p.hidden_size), DataType.DT_FLOAT,
                       "zeros"))
    return ws


def experts_routing(p: ExpertsParams, assign: torch.Tensor):
    """(capacity, slot, valid) of the Experts op over a whole batch's
    (b, k) assignment."""
    b, k = assign.shape
    cap = expert_capacity(p.n, k, b, p.alpha)
    slot, valid = routing_slots(assign, p.n, cap)
    return cap, slot, valid


def _experts_forward(p: ExpertsParams, inputs, weights, state, ctx):
    from ..parallel.spmd import all_gather

    data, gate_values, gate_assign = inputs  # (b,d), (b,k), (b,k)
    b_loc, d = data.shape
    k = gate_assign.shape[1]
    kern = weights["kernel"]
    n_loc = kern.shape[0]
    mine = getattr(ctx, "experts", None) or {}
    # the routing over the whole batch: on a mesh, every rank's block of
    # the assignment, in the batch's order
    tokens_g, experts_g = mine.get("tokens"), mine.get("experts")
    assign = gate_assign
    row0 = e0 = 0
    if tokens_g is not None:
        assign = all_gather(gate_assign.contiguous(), tokens_g, 0)
        row0 = tokens_g.index * b_loc
    if experts_g is not None:
        e0 = experts_g.index * n_loc
    b = assign.shape[0]
    cap, slot, valid = experts_routing(p, assign)
    slot = slot[row0:row0 + b_loc]
    valid = valid[row0:row0 + b_loc]
    # this rank's token copies that its experts keep, ranked among
    # themselves (a token's row depends on no other token's)
    e_loc = gate_assign.long() - e0
    keep = valid & (e_loc >= 0) & (e_loc < n_loc)
    e_loc = torch.where(keep, e_loc, torch.zeros_like(e_loc))
    cap_loc = min(cap, b_loc * k)
    if tokens_g is not None or experts_g is not None:
        ranks = _exclusive_ranks(_one_hot(e_loc.reshape(-1), n_loc)
                                 * keep.reshape(-1, 1).to(torch.int32))
        slot = ranks.gather(1, e_loc.reshape(-1, 1)).reshape(b_loc, k)
    buffers = _scatter_to_buffers(data, e_loc, n_loc, cap_loc, slot, keep)

    # the stacked expert dense: one batched matmul over this rank's
    # experts
    h = torch.bmm(buffers, kern.to(buffers.dtype))
    if p.use_bias:
        h = h + weights["bias"].to(h.dtype)[:, None, :]
    if p.activation == "relu":
        h = torch.relu(h)
    elif p.activation == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default

    # gather back and the gate-weighted combine (aggregate's semantics);
    # on a mesh a partial sum over this rank's experts
    rows = _gather_expert_rows(h, e_loc, slot, keep)
    out = torch.einsum("bk,bkh->bh", gate_values.to(rows.dtype), rows)

    if p.lambda_bal > 0.0:
        # gate_values are the top-k probabilities: scattered into (b, n)
        # as the proxy of the full gate
        probs = torch.zeros((b_loc, p.n), dtype=torch.float32,
                            device=data.device).scatter(
            1, gate_assign.long(), gate_values.float())
        state = dict(state or {})
        state["aux_loss"] = p.lambda_bal * _balance_term(
            p.n, assign, probs, b, b * k)
    return [out], state


def _experts_flops(p: ExpertsParams, in_shapes, out_shapes):
    b, d = in_shapes[0]
    k = in_shapes[2][1]
    cap = expert_capacity(p.n, k, b, p.alpha)
    return 2.0 * p.n * cap * d * p.hidden_size


register_op(
    OpDef(OT.OP_EXPERTS, _experts_infer, _experts_forward, _experts_weights,
          _experts_flops)
)
