"""Cost model of the Unity search (twin of `flexflow_tpu/search/cost_model.py`):
per-op compute cost plus inter-op resharding cost.

Reference: Simulator::measure_operator_cost (real kernel timing cached by
(OperatorParameters, MachineView), simulator.h:691-783) and the task-graph
makespan simulation with communication edges. Here:

- compute: a roofline on the per-shard tensor shapes (the shapes a device
  sees under the candidate assignment), optionally calibrated by timing
  each dominant op on the model's device (`calibrate`, the
  inner_measure_operator_cost analog, model.cu:38-75): on a card, CUDA
  graphs of the op's forward and of its forward and backward, replayed
  between CUDA events;
- communication: the collective a (producer spec -> consumer spec)
  transition needs, priced by the machine model;
- weight sync: a weight replicated across `data` with its op's inputs
  sharded over `data` pays a gradient all_reduce per step (the NCCL
  optimizer allreduce, optimizer_kernel.cu:78-110), or under
  weight-update sharding its reduce-scatter + all-gather pair;
- memory: per-device bytes of weights + activations under the assignment
  (MemoryUsage analog, memory_optimization.h:44-105).

Every price is the JAX package's, to the bit, on the same graph, machine
and calibration table. CostMetrics mirrors the reference struct
(simulator.h:54-88).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..fftype import DataType, OperatorType as OT
from ..fftype import UnportedOperatorType as UOT
from ..tensor import spec_assignment as _spec_to_assignment
from .machine_model import TPUMachineModel

_DTYPE_BYTES = {
    DataType.DT_FLOAT: 4, DataType.DT_DOUBLE: 8, DataType.DT_HALF: 2,
    DataType.DT_INT32: 4, DataType.DT_INT64: 8, DataType.DT_BOOLEAN: 1,
}


def dtype_bytes(dt) -> int:
    return _DTYPE_BYTES.get(dt, 4)


@dataclass
class CostMetrics:
    """Parity with simulator.h:54-88."""

    forward_time: float = 0.0
    backward_time: float = 0.0
    sync_time: float = 0.0       # serial gradient allreduce (incl., under
    #                              a sharded update, any co-located weight
    #                              choose_update_dim could NOT shard)
    comm_time: float = 0.0       # input resharding
    memory: float = 0.0          # per-chip bytes
    # weight-update sharding: the sharded weights' RS+AG pair (the
    # allreduce's exact ring bytes, separated so the evaluators can route
    # it onto the overlappable channel while sync_time stays serial), the
    # pair's ring-hop count, the summed per-hop issue latency priced at
    # each axis's own latency (DCN hops cost ~10× ICI), and the 1/dp
    # optimizer-state shards — all zero under the replicated update
    update_sync_time: float = 0.0
    update_hops: float = 0.0
    update_hop_s: float = 0.0
    update_shards: int = 1
    # ZeRO-3 / FSDP (stage 3, param_gather): the just-in-time all-gather
    # of this node's sharded-at-rest weights — one AG on the forward, one
    # re-gather on the backward (the gathered copy is dropped after last
    # use) — plus its summed per-hop issue latency, and the FULL gathered
    # bytes of the node's stage-3 weights (the evaluators charge at most
    # two gathered layers in flight, not one per weight). All zero below
    # stage 3.
    param_gather_time: float = 0.0
    param_gather_hop_s: float = 0.0
    gather_bytes: float = 0.0

    @property
    def total(self) -> float:
        return (self.forward_time + self.backward_time + self.sync_time
                + self.update_sync_time + self.param_gather_time
                + self.comm_time)


def price_grad_sync(cm: "CostMetrics", update_sharding: bool,
                    overlap_update: bool
                    ) -> tuple[float, float, float, float]:
    """(serial_sync_s, overlappable_comm_s, overlap_overhead_s,
    grad_sync_s) of one node's gradient sync under the given update mode
    — the ONE pricing rule both evaluators (UnitySearch.evaluate and
    substitution.evaluate_assigned_graph) apply, so the update-sharding
    decision can never disagree with the reported makespan. Replicated:
    the allreduce rides sync serially. Sharded: the sharded weights'
    RS+AG pair (update_sync_time — the allreduce's exact ring bytes)
    plus the pair's fixed per-hop issue latency (update_hop_s, priced at
    each axis's own latency) ride the overlappable channel when
    overlapped (the RS hides behind the backward producing each
    layer-order bucket, the deferred AG behind the next step's first
    consumer), or sync serially under --no-overlap-collectives — so
    serial-sharded prices strictly above replicated (the auto decision's
    tie-breaker). Any co-located weight choose_update_dim could not
    shard stays in sync_time and always prices serial, matching the
    runtime. grad_sync_s names the sharded pair's share for the strategy
    report."""
    pair = cm.update_sync_time
    if not (update_sharding and pair > 0.0):
        return cm.sync_time + pair, 0.0, 0.0, 0.0
    if overlap_update:
        return cm.sync_time, pair, cm.update_hop_s, pair
    return cm.sync_time + pair + cm.update_hop_s, 0.0, 0.0, pair


def price_param_gather(cm: "CostMetrics", overlap_update: bool
                       ) -> tuple[float, float, float, float]:
    """(serial_s, overlappable_comm_s, overlap_overhead_s, param_gather_s)
    of one node's stage-3 just-in-time weight gathers — the
    `price_grad_sync` sibling, applied by BOTH evaluators so the stage-3
    decision can never disagree with the reported makespan. The fwd
    gather is issued one layer ahead on the overlappable channel (it
    hides behind the previous layer's compute) and the bwd re-gather
    behind the next layer's backward; only the fixed per-hop issue
    latency never hides. Under --no-overlap-collectives the pair
    serializes on the node's critical path — so serial stage 3 prices
    strictly above stage 2 (the auto decision's tie-breaker).
    param_gather_time is only populated when the cost model prices
    stage 3 (CostModel.param_gather), so no flag argument is needed."""
    pg = cm.param_gather_time
    if pg <= 0.0:
        return 0.0, 0.0, 0.0, 0.0
    if overlap_update:
        return 0.0, pg, cm.param_gather_hop_s, pg
    return pg + cm.param_gather_hop_s, 0.0, 0.0, pg


def price_transfer_collective(kind: str, wire_bytes: float,
                              out_bytes: float, axis: str,
                              machine: "TPUMachineModel | None") -> float:
    """Seconds of ONE migration transfer collective (fftrans,
    analysis/transition.py) — the pricing rule the TransitionPlan's
    predicted_s is built from, kept here so migration is priced by the
    same machine-model oracle as every other collective the search
    prices. Kinds: all_gather / all_to_all (the GSPMD-derived unwinds,
    priced per axis), host_hop (a full logical array through the host
    NIC at DCN bandwidth), slice (free local dynamic-slice). With no
    machine model (pricing a checkpoint side standalone), falls back to
    the conservative dcn figure of the detected chip."""
    if kind == "slice" or wire_bytes <= 0:
        return 0.0
    if machine is None:
        from .machine_model import _local_device, detect_chip

        chip = detect_chip(_local_device())
        return wire_bytes / chip.dcn_bandwidth + chip.dcn_latency
    if kind == "host_hop":
        return (wire_bytes / machine.chip.dcn_bandwidth
                + machine.chip.dcn_latency)
    if kind == "all_gather":
        return machine.all_gather(out_bytes, axis)
    if kind == "all_to_all":
        # out_bytes is the per-chip send size; the oracle applies the
        # (n-1)/n wire fraction itself
        return machine.all_to_all(out_bytes, axis)
    return wire_bytes / machine.chip.dcn_bandwidth


def price_verify_scale(q: int) -> float:
    """Relative cost of a q-token speculative VERIFY call vs the q=1
    decode step (serving/speculative.py) — the assumed prior the payoff
    gate uses for a verify bucket it has never run. Decode-grain calls
    are launch/weight-read dominated, not FLOP dominated, so widening
    the query dim from 1 to q costs far less than qx: a conservative
    linear tail (quarter-slope) over the fixed launch cost. The first
    real call replaces this with the measured per-bucket EMA; decisions
    record which source priced them (`verify_cost_source`)."""
    return 1.0 + 0.25 * (max(1, int(q)) - 1)


def _shard_elems(shape: tuple[int, ...], assignment, axis_sizes) -> float:
    """Per-chip element count of a tensor under an axis assignment."""
    n = 1.0
    for i, dim in enumerate(shape):
        deg = 1
        if assignment and i < len(assignment):
            for ax in assignment[i]:
                deg *= axis_sizes.get(ax, 1)
        n *= max(1, math.ceil(dim / deg))
    return n


def _axes_of(assignment) -> set:
    out = set()
    for entry in assignment or ():
        out.update(entry)
    return out


def classify_reshard(shape, from_assign, to_assign, dtype, machine:
                     TPUMachineModel) -> float:
    """Price the collective GSPMD inserts for producer spec → consumer spec.

    Per-dim transitions:
      axis removed from a dim          → all_gather over that axis
      axis added to a dim              → local slice (free)
      axis moved between dims          → all_to_all
    (the Combine / Repartition / FusedParallelOp runtime costs, SURVEY §2.3)
    """
    if from_assign == to_assign:
        return 0.0
    bytes_el = dtype_bytes(dtype)
    cost = 0.0
    ndim = len(shape)
    from_assign = tuple(from_assign or ((),) * ndim)
    to_assign = tuple(to_assign or ((),) * ndim)
    removed, added = [], []
    for i in range(ndim):
        f = set(from_assign[i]) if i < len(from_assign) else set()
        t = set(to_assign[i]) if i < len(to_assign) else set()
        removed += [(i, ax) for ax in f - t]
        added += [(i, ax) for ax in t - f]
    moved = {ax for _, ax in removed} & {ax for _, ax in added}
    # bytes of the local shard *before* the transition
    local_bytes = _shard_elems(shape, from_assign, machine.axis_sizes) * bytes_el
    for _, ax in removed:
        if ax in moved:
            cost += machine.all_to_all(local_bytes, ax)
        else:
            n = machine.axis_size(ax)
            cost += machine.all_gather(local_bytes * n, ax)
    # additions alone are local dynamic-slices: free
    return cost


def price_parallel_node(node, machine) -> tuple[float, tuple]:
    """(comm seconds, ICI axes) of one explicit parallel-op node — the
    collective its Repartition/Combine/Replicate/Reduction semantics lower
    to (the reference prices these as partition-copy tasks via the
    simulator; SURVEY §2.3 maps them to all_to_all/all_gather/psum). A
    FusedParallelOp pays for each member transform so fused rewrites don't
    look artificially free."""
    pt = node.inputs[0]
    local_bytes = pt.shape.piece_elements() * dtype_bytes(pt.dtype)
    if node.op_type == OT.OP_FUSED_PARALLEL:
        subs = [(i.op_type, i) for i in node.params.ops]
    else:
        subs = [(node.op_type, node.params)]
    comm = 0.0
    comm_axes = []

    def _degree_axis(degree: int) -> str:
        from ..machine import AXIS_MODEL

        # several mesh axes can share a size (dcn=2, model=2 on a 2-host
        # mesh); an explicit parallel op's collective rides ICI, so prefer
        # non-DCN axes — matching on the leading `dcn` axis would price a
        # tensor-parallel Combine at DCN bandwidth (~10× slow) and make the
        # search systematically reject model-parallel rewrites multi-host
        fallback = None
        for ax, size in machine.axis_sizes.items():
            if size == degree:
                if ax not in machine.axis_over_dcn:
                    return ax
                fallback = fallback or ax
        return fallback or AXIS_MODEL

    for st, sp in subs:
        # rewrites thread the mesh axes they bind onto the params (the
        # durable fix for degree→axis ambiguity: a declared axis is priced
        # as itself, DCN or not); legacy degree-only params fall back to
        # _degree_axis inference
        declared = tuple(getattr(sp, "axes", ()))
        if st == OT.OP_COMBINE:
            axes = declared or (_degree_axis(sp.degree),)
            # multi-axis combine gathers axis by axis; the gathered shard
            # grows by each axis's size before the next gather
            grown = local_bytes
            for ax in axes:
                grown *= machine.axis_size(ax)
                comm += machine.all_gather(grown, ax)
                comm_axes.append(ax)
        elif st == OT.OP_REPARTITION:
            if pt.shape.total_degree > 1:
                axes = declared or (_degree_axis(sp.degree),)
                # each split shrinks the shard the next all_to_all moves
                # (mirror of the combine path, which grows it per gather)
                shrink = local_bytes
                for ax in axes:
                    comm += machine.all_to_all(shrink, ax)
                    comm_axes.append(ax)
                    shrink /= max(1, machine.axis_size(ax))
            # from fully-replicated: local slice, free
        elif st == OT.OP_REDUCTION:
            axes = declared or (_degree_axis(sp.degree),)
            for ax in axes:
                comm += machine.all_reduce(local_bytes, ax)
                comm_axes.append(ax)
        # Replicate: broadcast of an already-replicated tensor and Pipeline
        # stage markers are free
    return comm, tuple(comm_axes)


def graph_makespan(compute, comm, src, dst, axis=None) -> float:
    """Makespan of a strategy's task graph: max(sum of compute, critical
    path of compute+comm) — concurrent branches (DLRM towers, Inception)
    cost max(paths), not sum (the simulate_runtime analog,
    simulator.h:691-783). When `axis` is given (int id per node, -1 =
    none), adds per-ICI-axis link-occupancy bounds — comm on the same mesh
    axis serializes while disjoint axes overlap, the TPU recast of the
    reference's horizontal machine-resource splits (graph.cc:267-321).
    Native ff_eval_makespan[_axes] when the toolchain is available;
    identical pure-Python fallback otherwise. Raises ValueError on a
    cyclic graph."""
    from .. import native

    if axis is not None:
        res = native.eval_makespan_axes(compute, comm, axis, src, dst)
    else:
        res = native.eval_makespan(compute, comm, src, dst)
    if res is not None:
        return res
    n = len(compute)
    preds: list[list[int]] = [[] for _ in range(n)]
    succs: list[list[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for s, d in zip(src, dst):
        preds[d].append(s)
        succs[s].append(d)
        indeg[d] += 1
    ready = [v for v in range(n) if indeg[v] == 0]
    finish = [0.0] * n
    critical = 0.0
    done = 0
    while ready:
        v = ready.pop()
        done += 1
        start = max((finish[p] for p in preds[v]), default=0.0)
        finish[v] = start + compute[v] + comm[v]
        critical = max(critical, finish[v])
        for w in succs[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(w)
    if done != n:
        raise ValueError("graph_makespan: graph has a cycle")
    out = max(float(sum(compute)), critical)
    if axis is not None:
        per_axis: dict[int, float] = {}
        for v in range(n):
            if axis[v] >= 0:
                per_axis[axis[v]] = per_axis.get(axis[v], 0.0) + comm[v]
        for c in per_axis.values():
            out = max(out, c)
    return out


class _MakespanAccum:
    """Collects per-node (compute, comm) costs + dependency edges during a
    strategy evaluation, then evaluates the makespan. Shared by both search
    evaluators so neither prices a branchy graph as a serial sum. Each
    node's comm is tagged with the ICI axis it occupies so same-axis comm
    serializes (see graph_makespan).

    `overlap_sync` implements --search-overlap-backward-update (reference
    config.h:search_overlap_backward_update): gradient-allreduce time
    (passed via `sync=`) then overlaps other nodes' compute instead of
    serializing on its own node's critical path — it still occupies its ICI
    axis, so the per-axis link-occupancy bound keeps it honest.

    `overlappable_comm` is the round-7 channel for ops whose OWN collective
    runs concurrently with their own compute (ring attention's
    double-buffered ppermute pipeline, the decomposed collective matmul):
    the node's critical-path contribution becomes
    max(compute, overlappable_comm) + overlap_overhead instead of
    compute + comm — the roofline of a perfectly pipelined schedule, plus
    the fixed per-hop issue cost that never hides. The overlapped traffic
    still occupies its ICI axis, so the per-axis link-occupancy bound in
    `makespan` keeps concurrent same-axis collectives honest."""

    def __init__(self, overlap_sync: bool = False):
        self.compute: list[float] = []
        self.comm: list[float] = []
        self.axis: list[int] = []
        self.idx: dict[int, int] = {}  # node guid -> task index
        self._axis_ids: dict[str, int] = {}
        self.overlap_sync = overlap_sync
        self._sync_by_axis: dict[int, float] = {}
        self._overlap_by_axis: dict[int, float] = {}

    def add(self, guid: int, compute: float, comm: float, comm_axes=(),
            sync: float = 0.0, overlappable_comm: float = 0.0,
            overlap_overhead: float = 0.0):
        self.idx[guid] = len(self.compute)
        ax = -1
        for name in comm_axes:
            ax = self._axis_ids.setdefault(name, len(self._axis_ids))
            break  # attribute to the first (dominant) axis
        self.axis.append(ax)
        if overlappable_comm > 0.0:
            # overlap-capable op: comm hides behind (or extends past) the
            # op's own compute; only the fixed issue overhead serializes
            self._overlap_by_axis[ax] = (
                self._overlap_by_axis.get(ax, 0.0) + overlappable_comm)
            compute = max(compute, overlappable_comm) + overlap_overhead
        self.compute.append(compute)
        if self.overlap_sync and sync > 0.0:
            self._sync_by_axis[ax] = self._sync_by_axis.get(ax, 0.0) + sync
            self.comm.append(comm)
        else:
            self.comm.append(comm + sync)

    def makespan(self, in_edges) -> float:
        src, dst = [], []
        for guid, i in self.idx.items():
            for e in in_edges[guid]:
                j = self.idx.get(e.src)
                if j is not None:
                    src.append(j)
                    dst.append(i)
        if not self.compute:
            return 0.0
        out = graph_makespan(self.compute, self.comm, src, dst,
                             axis=self.axis)
        if self._sync_by_axis or self._overlap_by_axis:
            # per-axis link occupancy including the OVERLAPPED traffic:
            # hiding comm behind compute does not add link capacity, so
            # same-axis serial + overlapped + sync bytes still serialize
            # against each other
            per_axis_comm: dict[int, float] = {}
            for ax, c in zip(self.axis, self.comm):
                if ax >= 0:
                    per_axis_comm[ax] = per_axis_comm.get(ax, 0.0) + c
            for ax, c in self._overlap_by_axis.items():
                if ax >= 0:
                    per_axis_comm[ax] = per_axis_comm.get(ax, 0.0) + c
            if self._overlap_by_axis:
                # the plain per-axis occupancy bound only exists to keep
                # OVERLAPPED bytes honest; sync-only plans keep the
                # pre-overlap pricing (and diagnostics/explain.py
                # verify_report_total applies the same gate)
                for ax, c in per_axis_comm.items():
                    out = max(out, c)
            for ax, s in self._sync_by_axis.items():
                out = max(out, s + per_axis_comm.get(ax, 0.0))
        return out


class CostModel:
    """Costs one node / one whole strategy; memoized like the reference's
    (params, view) cache (simulator.h strict/relaxed hash caches)."""

    def __init__(self, machine: TPUMachineModel, mfu: float = 0.4,
                 opt_slots: int = 1):
        self.machine = machine
        # achievable fraction of peak (calibration refines per-op)
        self.mfu = mfu
        # optimizer state entries per weight (SGD momentum 1, Adam 2) for
        # the memory model
        self.opt_slots = opt_slots
        # weight-update sharding (ZeRO / Xu et al.): price the gradient
        # sync as a reduce-scatter + all-gather pair (same ring bytes as
        # the allreduce) and the masters/grads/slots at 1/shards per chip
        # plus one gathered compute copy. overlap_update additionally
        # routes the pair onto the overlappable channel in the evaluators
        # (max(compute, comm) + hop latency). Toggled by
        # unity.choose_update_sharding / --weight-update-sharding.
        self.update_sharding = False
        self.overlap_update = False
        # ZeRO-3 / FSDP (stage 3): additionally price the trainable
        # weights SHARDED AT REST — per-chip memory drops the always-live
        # gathered compute copy (the evaluators charge at most two
        # gathered layers in flight instead), the grad sync becomes the
        # RS alone, and the fwd gather + bwd re-gather pair is priced by
        # price_param_gather on the overlappable channel. Implies
        # update_sharding.
        self.param_gather = False
        self._cache: dict = {}
        self._calibration: dict = {}
        # where calibrate_graph runs the ops (compile sets the model's)
        self.harness = OpHarness()

    # -------------------------------------------------------------- op cost

    def op_cost(self, node, out_assigns, weight_specs_assigns,
                in_shapes, in_assigns) -> CostMetrics:
        key = (node.guid,
               tuple(tuple(a) for a in out_assigns or ()),
               tuple(sorted((k, str(v)) for k, v in
                            (weight_specs_assigns or {}).items())),
               tuple(tuple(tuple(e) for e in (a or ())) for a in in_assigns),
               self.update_sharding, self.param_gather)
        if key in self._cache:
            return self._cache[key]

        axis_sizes = self.machine.axis_sizes
        op_def = node.op_def
        # shard the op: flops scale by the product of degrees over sharded
        # dims of the OUTPUT (each chip computes its shard)
        out_shapes = [tuple(d.size for d in pt.shape.dims
                            if not d.is_replica_dim) for pt in node.outputs]
        full_flops = op_def.flops(node.params, list(in_shapes), out_shapes)
        # per-chip flops shrink by every axis the computation is split over:
        # output sharding AND reduction-dim (weight) sharding — a tp_row
        # Linear with its kernel sharded over `model` does 1/model_deg of
        # the contraction per chip even though its output is replicated
        parallel_axes = set()
        if out_assigns:
            parallel_axes |= _axes_of(out_assigns[0])
        for spec in (weight_specs_assigns or {}).values():
            if spec is not None:
                for entry in spec:
                    if entry is None:
                        continue
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    parallel_axes.update(axes)
        degree = 1
        for ax in parallel_axes:
            degree *= axis_sizes.get(ax, 1)
        shard_flops = full_flops / max(1, degree)

        # bytes touched: inputs + outputs + weights per chip (the output
        # bytes double as the activation-memory term below)
        bytes_touched = 0.0
        for shape, assign in zip(in_shapes, in_assigns):
            bytes_touched += _shard_elems(shape, assign, axis_sizes) * 4
        act_bytes = 0.0
        for i, pt in enumerate(node.outputs):
            a = out_assigns[i] if out_assigns and i < len(out_assigns) else ()
            act_bytes += _shard_elems(
                tuple(d.size for d in pt.shape.dims if not d.is_replica_dim),
                a, axis_sizes) * dtype_bytes(pt.dtype)
        bytes_touched += act_bytes

        # tied-weight nodes (shared_op) read another node's parameters: the
        # bytes are still touched each step, but the weight/grad/optimizer
        # memory and the gradient allreduce are owned (and already counted)
        # by the source node
        from ..parallel.ops import choose_update_dim, grad_sync_axes

        tied = bool(getattr(node, "weight_source", None))
        weight_mem = 0.0
        sync = 0.0
        update_sync = 0.0
        update_hops = 0.0
        update_hop_s = 0.0
        update_shards = 1
        param_gather_t = 0.0
        param_gather_hop_s = 0.0
        gather_bytes = 0.0
        for ws in node.weight_specs:
            spec = (weight_specs_assigns or {}).get(ws.name)
            w_assign = _spec_to_assignment(spec, len(ws.shape))
            wb = _shard_elems(ws.shape, w_assign, axis_sizes) * dtype_bytes(ws.dtype)
            bytes_touched += wb
            if tied:
                continue
            # gradient sync over every data-ish axis the weight is NOT
            # sharded over but its consumers' activations are; resolved
            # through the SAME helpers the executor places with
            # (parallel/ops), so runtime and pricing cannot disagree
            sync_axes = ()
            if ws.trainable:
                w_axes = _axes_of(w_assign)
                act_axes = _axes_of(out_assigns[0] if out_assigns else ())
                sync_axes = grad_sync_axes(act_axes, w_axes)
            sharded = (
                self.update_sharding and sync_axes
                and choose_update_dim(ws.shape, w_assign, sync_axes,
                                      axis_sizes) is not None)
            if sharded:
                shards = 1
                for ax in sync_axes:
                    # RS + AG together move the allreduce's exact ring
                    # bytes; the win is the overlappable channel (the
                    # evaluators route update_sync there — a co-located
                    # non-shardable weight's allreduce stays in `sync`
                    # and keeps pricing serial, matching the runtime) +
                    # the 1/dp state below. Hop issue latency priced at
                    # the axis's own latency (DCN hops cost ~10× ICI)
                    rs_t = self.machine.reduce_scatter(wb, ax)
                    ag_t = self.machine.all_gather(wb, ax)
                    n = self.machine.axis_size(ax)
                    lat = (n - 1) * self.machine._lat(ax)
                    if self.param_gather:
                        # stage 3: the grad sync is the RS alone (the
                        # cotangent of the gathered copy scatters to the
                        # owner shard); the deferred AG moves into the
                        # explicit gather pair — fwd just-in-time + bwd
                        # re-gather — priced by price_param_gather
                        update_sync += rs_t
                        update_hops += n - 1
                        update_hop_s += lat
                        param_gather_t += 2.0 * ag_t
                        param_gather_hop_s += 2.0 * lat
                    else:
                        update_sync += rs_t + ag_t
                        update_hops += 2.0 * (n - 1)
                        update_hop_s += 2.0 * lat
                    shards *= n
                update_shards = max(update_shards, shards)
                if self.param_gather:
                    # stage 3 per-chip memory: master/grad/slots sharded
                    # 1/shards with NO resident gathered copy — the
                    # transient two-layers-in-flight gather working set
                    # is charged once per plan by the evaluators
                    # (gather_bytes below), not once per weight
                    weight_mem += wb * (2 + self.opt_slots) / shards
                    gather_bytes += wb
                else:
                    # per-chip memory: one gathered compute copy +
                    # master/grad/slots sharded 1/shards (the ZeRO
                    # stage-2 saving)
                    weight_mem += wb + wb * (2 + self.opt_slots) / shards
            else:
                for ax in sync_axes:
                    sync += self.machine.all_reduce(wb, ax)
                weight_mem += wb * (2 + self.opt_slots)

        eff_peak_t = self.machine.compute_time(shard_flops / self.mfu,
                                               bytes_touched)
        # measured full-op (fwd, bwd) times (calibrate_graph) override the
        # fixed-mfu roofline; scale by the shard fraction since the
        # measurement is of the unsharded op on one chip
        calib = self._calibration.get(
            _params_key(node, tuple(tuple(s) for s in in_shapes)))
        if calib is not None:
            cal_fwd, cal_bwd = calib
            ratio = shard_flops / max(full_flops, 1.0)
            fwd = cal_fwd * ratio
            bwd = cal_bwd * ratio
        else:
            fwd = eff_peak_t
            # rule of thumb (also the reference simulator's default) when
            # unmeasured: bwd ≈ 2× fwd
            bwd = 2.0 * fwd
        # per-chip memory (MemoryUsage analog, memory_optimization.h:44-105):
        # master weight + gradient + optimizer slots (opt_slots: 1 for SGD
        # momentum, 2 for Adam) + every output activation at its dtype;
        # under weight-update sharding the master/grad/slot term shrank to
        # 1/shards per weight above (plus one gathered compute copy)
        cm = CostMetrics(
            forward_time=fwd,
            backward_time=bwd,
            sync_time=sync,
            update_sync_time=update_sync,
            memory=weight_mem + act_bytes,
            update_hops=update_hops,
            update_hop_s=update_hop_s,
            update_shards=update_shards,
            param_gather_time=param_gather_t,
            param_gather_hop_s=param_gather_hop_s,
            gather_bytes=gather_bytes,
        )
        self._cache[key] = cm
        return cm

    # -------------------------------------------------------- calibration

    # the two repetition counts of a timing (the slope between them
    # cancels every constant cost of a timing)
    _REPS = (16, 272)

    def calibrate(self, node, fn, example_args) -> tuple[float, float]:
        """Measure one op on the harness's device and pin its (forward,
        backward) costs: the Op::inner_measure_operator_cost analog
        (warm-up, then timed repeats, model.cu:38-75). backward = (time of
        the forward and the gradient of sum(out^2) with respect to every
        float operand, the trainable weights included) - forward - the
        loss's own time, floored at a quarter of the forward; a squared
        loss keeps the cotangent dense, as a training backward's is. The
        loss (a cast, square and sum of the output, and their backward)
        runs as kernels of its own here, where XLA fuses it into the
        op's epilogue in the JAX package: it is timed alone on the
        output and taken off. An op with nothing to differentiate takes
        2 x forward.

        `_timed` gives each the slope of n2 against n1 repetitions. An
        error of the op, its kernels or the device propagates."""
        tw, *ins = example_args
        leaves = [t.requires_grad_() for t in tw.values()]
        leaves += [x.requires_grad_() for x in ins
                   if torch.is_tensor(x) and x.is_floating_point()]

        def forward():
            with torch.no_grad():
                return fn(*example_args)

        def loss_grad(out, wrt):
            # an operand the output does not depend on differentiably (an
            # expert assignment) has no gradient, as under jax.grad
            return torch.autograd.grad(out.float().square().sum(), wrt,
                                       allow_unused=True)

        fwd_t = self._timed(forward)
        out = fn(*example_args)
        if leaves and out.requires_grad:
            alone = out.detach().requires_grad_()
            loss_t = self._timed(lambda: loss_grad(alone, alone))
            del out, alone
            both_t = self._timed(
                lambda: loss_grad(fn(*example_args), leaves))
            bwd_t = max(both_t - fwd_t - loss_t, 0.25 * fwd_t)
        else:
            del out
            bwd_t = 2.0 * fwd_t  # non-differentiable op: rule of thumb
        self._calibration[_params_key(node)] = (fwd_t, bwd_t)
        self._cache.clear()  # cached roofline entries are stale now
        return fwd_t, bwd_t

    def _timed(self, step) -> float:
        """Seconds of one `step()`: (t(n2) - t(n1)) / (n2 - n1), each t the
        median of 3. On a card a repetition is one replay of a CUDA graph
        of `step`, timed between CUDA events (`_GraphTimer`); on the CPU
        an eager call, timed by time.perf_counter."""
        n1, n2 = self._REPS
        device = torch.device(self.harness.device)
        if device.type == "cuda":
            t_of = _GraphTimer(step, device)
        else:
            step()  # warm-up

            def t_of(n):
                t0 = time.perf_counter()
                for _ in range(n):
                    step()
                return time.perf_counter() - t0

        def med(n):
            return statistics.median(t_of(n) for _ in range(3))

        dt = (med(n2) - med(n1)) / (n2 - n1)
        return max(dt, 1e-7)

    def calibrate_graph(self, graph, top_k: int = 4,
                        remeasure: bool = False) -> int:
        """Measure the top-K most expensive distinct ops of a PCG on the
        harness's device and pin their costs: the reference measures
        every candidate op on GPU0 (simulator.h:691-783); this measures
        the K that dominate the roofline estimate. Returns the number of
        ops measured.

        The top-K set is ranked over ALL distinct compute ops; entries
        already calibrated count as cache hits and are skipped, NOT
        replaced by the next op down the ranking, so the measured set is
        a deterministic function of (graph, top_k). `remeasure=True`
        re-measures the top-K even when cached. An op whose harness
        cannot be built (no forward for it, say) keeps its roofline
        estimate; a failure while it runs raises."""
        candidates: dict = {}
        for node in graph.topo_order():
            if (node.op_type in _NON_COMPUTE or not node.outputs
                    or not node.inputs):
                continue
            key = _params_key(node)
            if key in candidates:
                continue
            try:
                in_shapes = [pt.shape.logical_shape for pt in node.inputs]
                out_shapes = [pt.shape.logical_shape for pt in node.outputs]
                est = node.op_def.flops(node.params, in_shapes, out_shapes)
            except Exception:
                continue
            candidates[key] = (est, node)
        measured = 0
        hits = 0
        ranked = sorted(candidates.items(),
                        key=lambda kv: -kv[1][0])[:top_k]
        for key, (_, node) in ranked:
            if key in self._calibration and not remeasure:
                hits += 1
                continue
            try:
                fn, args = _op_harness(node, self.harness)
            except _HARNESS_ERRORS:
                continue
            self.calibrate(node, fn, args)
            measured += 1
        # measured-vs-cache-hit counts for this pass (telemetry reads them
        # right after)
        self.calib_stats = {
            "measured": measured,
            "cache_hits": hits,
            "candidates": len(candidates),
        }
        return measured

    def calibrate_nodes(self, graph, names, remeasure: bool = True
                        ) -> list:
        """Re-measure exactly the named PCG ops. Returns the
        `_params_key`s refreshed."""
        wanted = set(names)
        refreshed: list = []
        done: set = set()
        for node in graph.topo_order():
            if node.name not in wanted or node.op_type in _NON_COMPUTE:
                continue
            key = _params_key(node)
            if key in done or (key in self._calibration
                               and not remeasure):
                continue
            done.add(key)
            try:
                fn, args = _op_harness(node, self.harness)
            except _HARNESS_ERRORS:
                continue
            self.calibrate(node, fn, args)
            refreshed.append(key)
        self.calib_stats = {
            "measured": len(refreshed),
            "cache_hits": 0,
            "candidates": len(done),
            "targeted": sorted(wanted),
        }
        return refreshed

    # ------------------------------------------- collective calibration
    # The ring schedules are priced per hop; the machine model guesses
    # the hop from datasheet link rates. The real hop is measurable: a
    # loop of ring hops (parallel/ops._Hop, batch_isend_irecv) over the
    # axis's process group, timed at two trip counts (slope = seconds a
    # hop) and at two payload sizes (slope over bytes = 1/bandwidth,
    # intercept = per-hop latency). Entries live in `_calibration` under
    # a reserved OP_NOOP key, as the JAX package keeps them.

    _HOP_BYTES = (1 << 16, 1 << 22)  # 64 KiB / 4 MiB per-device payloads

    def _collective_key(self, axis: str):
        return (UOT.OP_NOOP, f"__collective_ppermute__:{axis}",
                ((self._HOP_BYTES[0],), (self._HOP_BYTES[1],)))

    def collective_rotate(self, bytes_per_chip: float, axis: str) -> float:
        """One ring-rotation hop for `bytes_per_chip`: the calibrated
        two-point fit when a measurement exists, else the machine model's
        analytic `rotate`."""
        cal = self._calibration.get(self._collective_key(axis))
        if cal is None:
            return self.machine.rotate(bytes_per_chip, axis)
        t_small, t_big = cal
        b0, b1 = self._HOP_BYTES
        slope = max((t_big - t_small) / (b1 - b0), 0.0)
        lat = max(t_small - slope * b0, 0.0)
        return lat + bytes_per_chip * slope

    def calibrate_collectives(self, mesh, axes) -> int:
        """Measure the ring hop on each of `axes` (mesh axes of size > 1)
        and pin it for `collective_rotate`; collective: every rank of the
        mesh calls it. Cached entries are kept. Returns the number of axes
        measured."""
        measured = 0
        for axis in axes:
            key = self._collective_key(axis)
            if key in self._calibration:
                continue
            self._calibration[key] = tuple(
                self._measure_hop(mesh, axis, nb) for nb in self._HOP_BYTES)
            measured += 1
        if measured:
            self._cache.clear()
        return measured

    def _measure_hop(self, mesh, axis: str, nbytes: int) -> float:
        """Median seconds of one ring hop of `nbytes` a device over
        `axis`'s group (two trip counts; the slope cancels the constant
        costs). An axis of one device raises."""
        from ..parallel.ops import _Hop, ring_permutation

        n = dict(mesh.shape).get(axis, 1)
        if n <= 1:
            raise ValueError(f"axis {axis!r} has size {n}")
        group = mesh.group((axis,))
        perm = ring_permutation(n)
        device = torch.device(mesh.device)
        x = torch.zeros(max(128, nbytes // 4), dtype=torch.float32,
                        device=device)

        def run(reps):
            y = x
            for _ in range(reps):
                y = _Hop(y, group, perm).wait()
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        n1, n2 = 8, 40
        run(n1)  # warm-up: the communicator's set-up

        def t_of(reps):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(reps)
                ts.append(time.perf_counter() - t0)
            return statistics.median(ts)

        dt = (t_of(n2) - t_of(n1)) / (n2 - n1)
        return max(dt, 1e-9)


class _GraphTimer:
    """`t_of(n)`: seconds of n replays of a CUDA graph of `step`, between
    CUDA events on a side stream. `step` runs twice eagerly on that
    stream first (the lazy set-up: cuBLAS handles, kernel libraries),
    then is captured. A kernel wrapper counts its launch on the host,
    once during the capture with nothing launched, so the capture's
    counts are taken back and every replay adds them: the counters count
    device launches."""

    def __init__(self, step, device: torch.device):
        from ..kernels import counters

        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            step()
            step()
        self.counters = counters()
        before = {n: c.state() for n, c in self.counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                step()
        finally:
            self.deltas = {}
            for n, c in self.counters.items():
                self.deltas[n] = c.since(before[n])
                c.restore(before[n])

    def __call__(self, n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            for _ in range(n):
                self.graph.replay()
            end.record(self.stream)
        end.synchronize()
        for name, delta in self.deltas.items():
            for _ in range(n):
                self.counters[name].add(delta)
        return start.elapsed_time(end) / 1e3


_NON_COMPUTE = frozenset({
    OT.OP_INPUT, UOT.OP_WEIGHT, UOT.OP_NOOP, OT.OP_REPARTITION, OT.OP_COMBINE,
    OT.OP_REPLICATE, OT.OP_REDUCTION, OT.OP_FUSED_PARALLEL, OT.OP_PIPELINE,
})

# what building an op's harness may raise for an op it cannot measure (no
# forward, a shape it cannot make): that op keeps its roofline estimate
_HARNESS_ERRORS = (NotImplementedError, ValueError, KeyError, TypeError)


@dataclass(frozen=True)
class OpHarness:
    """Where and how `calibrate_graph` runs an op: the model's device and
    the executor's dtype policy (float inputs and trainable weights at
    the compute dtype, state at its own; fp32 matmul inputs cast to the
    tensor-op dtype; the flash layout)."""

    device: str = "cpu"
    compute_dtype: Optional[torch.dtype] = None
    matmul_dtype: Optional[torch.dtype] = None
    flash_packed: bool = True

    @staticmethod
    def of(config, device) -> "OpHarness":
        """The harness of a model's config on `device`: its Executor's
        dtype policy."""
        from ..executor import dtype_policy

        compute, matmul = dtype_policy(config, device)
        return OpHarness(str(torch.device(device)), compute, matmul,
                         config.flash_packed_layout)


# the inputs of the MoE ops that hold expert assignments (params.n
# experts): the group_by's, the fused Experts op's, the aggregates'
_ASSIGN_INPUTS = {OT.OP_GROUP_BY: (1,), OT.OP_EXPERTS: (2,),
                  OT.OP_AGGREGATE: (1, 2), OT.OP_AGG_SPEC: (1, 2)}


def _op_harness(node, harness: OpHarness):
    """(fn, example_args) running one op's unsharded forward on the
    harness's device (the sub-tensor construction of
    measure_operator_cost, linear.cc:792-925, without the MachineView:
    sharding is applied as a flops ratio by op_cost). The trainable
    weights are the FIRST argument, so `calibrate` differentiates the op
    with respect to them."""
    import numpy as np

    from ..fftype import dtype_to_torch
    from ..ops.base import OpContext

    rs = np.random.RandomState(0)
    device = torch.device(harness.device)

    def _make(shape, dtype, compute=True):
        dt = dtype_to_torch(dtype)
        if not dt.is_floating_point:
            return torch.zeros(shape, dtype=dt, device=device)
        if compute and harness.compute_dtype is not None:
            dt = harness.compute_dtype
        return torch.as_tensor(rs.randn(*shape), dtype=dt, device=device)

    ins = [_make(pt.shape.logical_shape, pt.dtype) for pt in node.inputs]
    # an expert assignment input holds expert indices (in [0, n), at the
    # tensor's own dtype): drawn as such, or the op reads out of bounds
    for i in _ASSIGN_INPUTS.get(node.op_type, ()):
        pt = node.inputs[i]
        ins[i] = torch.as_tensor(
            rs.randint(0, node.params.n, pt.shape.logical_shape),
            dtype=dtype_to_torch(pt.dtype), device=device)
    trainable = {ws.name: _make(ws.shape, ws.dtype)
                 for ws in node.weight_specs if ws.trainable}
    state = {ws.name: _make(ws.shape, ws.dtype, compute=False)
             for ws in node.weight_specs if not ws.trainable}
    ctx = OpContext(training=False, matmul_dtype=harness.matmul_dtype,
                    flash_packed=harness.flash_packed)
    params, op_def = node.params, node.op_def

    def fn(tw, *arrs):
        outs, _ = op_def.forward(params, list(arrs), {**tw, **state},
                                 dict(state) if state else None, ctx)
        return outs[0]

    return fn, (trainable,) + tuple(ins)


def _params_key(node, in_shapes=None):
    """Calibration cache key: op params alone don't pin the cost (a
    64→4096 Linear and a 4096→4096 Linear share LinearParams fields), so
    the key includes the unsharded input shapes — the analog of the
    reference caching by (OperatorParameters, MachineView) where the view
    implies the sub-tensor shapes."""
    if in_shapes is None:
        in_shapes = (tuple(pt.shape.logical_shape for pt in node.inputs)
                     if node.inputs else ())
    return (node.op_type, repr(node.params),
            tuple(tuple(s) for s in in_shapes))
