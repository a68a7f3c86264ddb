"""Unity search (twin of `flexflow_tpu/search/unity.py`): choose a mesh-axis
assignment per PCG node.

Algorithm parity with the reference (SURVEY §3.2):

- `graph_cost` DP over sequence splits at bottleneck nodes
  (SearchHelper::find_optimal_sequence_graph_time, graph.cc:115-180): a
  bottleneck is a node every source→sink path crosses; the DP state is the
  candidate config of the bottleneck tensor, and segment costs are memoized
  per (in_config, out_config) — exactly the reference's memoized
  sequence-split recursion with MachineViews replaced by axis assignments.
- inside a segment, configs are enumerated jointly when the segment is small
  (the reference's nonsequence exhaustive split, graph.cc:267-321) and
  greedily otherwise.
- the candidate configs per node are the reference's parallelization
  substitution families (substitution.cc:1726-1868): data-parallel,
  partition-linear-combine (column TP), replicate-linear-reduce (row TP),
  partition-attention (head TP), expert partition; gated by the same flags
  (--enable-parameter-parallel etc., config.h:133-137).
- `base_optimize`-style refinement: best-first over single-segment config
  changes with a search budget and alpha pruning (substitution.cc:2229-2311).
- memory-aware search: per-chip memory validity (graph.cc:1983-2032) and the
  λ runtime/memory blend binary search (graph_optimize_task, 2056-2131).

Output is a `parallel.Strategy` consumed by FFModel.compile. The code is
the JAX package's, container for container and loop for loop: the search
breaks ties by iteration order, so the two packages pick the identical
Strategy on the same graph, machine and calibration table.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Optional

from ..fftype import OperatorType as OT, PARALLEL_OP_TYPES as _PARALLEL_OPS
from ..fftype import UnportedOperatorType as UOT
from ..machine import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, batch_axes_for
from ..parallel.strategies import Strategy
from ..tensor import PartitionSpec
from .cost_model import (
    CostModel,
    _MakespanAccum,
    _axes_of,
    _shard_elems,
    _spec_to_assignment,
    classify_reshard,
    dtype_bytes,
    price_grad_sync,
    price_param_gather,
    price_parallel_node,
)
from .machine_model import TPUMachineModel


@dataclass(frozen=True)
class NodeConfig:
    """One parallelization choice for a node (the MachineView analog)."""

    name: str  # dp | tp_col | tp_row | tp_attn | ep | feat | xfer | xfer_comm
    out_assign: tuple        # output axis assignment
    weight_specs: tuple = () # ((weight_name, PartitionSpec), ...)
    # extra collective cost this config implies (e.g. row-parallel psum)
    psum_axes: tuple = ()
    # rewrite-pinned configs (joint search) carry the degree-derived input
    # assignments the rewritten node consumes, so reshard at the boundary
    # between searched and pinned regions is priced correctly
    in_assigns: Optional[tuple] = None


def _dp_assign(ndim, batch_ok=True, last_axes=(), batch_axes=(AXIS_DATA,)):
    a = [()] * ndim
    if ndim > 0 and batch_ok:
        a[0] = tuple(batch_axes)
    if last_axes and ndim > 1:
        a[-1] = tuple(last_axes)
    return tuple(a)


class UnitySearch:
    def __init__(self, graph, mesh, config, cost_model: CostModel,
                 segment_cache: Optional[dict] = None,
                 pinned: Optional[dict] = None, refine: bool = True):
        self.graph = graph
        self.mesh = mesh
        self.config = config
        self.cm = cost_model
        self.axis_sizes = dict(mesh.shape)
        self.model_deg = self.axis_sizes.get(AXIS_MODEL, 1)
        self.data_deg = self.axis_sizes.get(AXIS_DATA, 1)
        self.seq_deg = self.axis_sizes.get(AXIS_SEQ, 1)
        # multi-host meshes compose (dcn, data) on the batch dim; DCN-axis
        # collectives are priced at DCN bandwidth by the machine model
        self.batch_axes = batch_axes_for(self.axis_sizes)
        self.batch_deg = 1
        for ax in self.batch_axes:
            self.batch_deg *= self.axis_sizes.get(ax, 1)
        self.order = graph.topo_order()
        # {guid -> NodeConfig} fixed by a substitution rewrite (joint
        # search): the placement DP searches only the remaining free nodes
        self.pinned = pinned or {}
        # refinement can be disabled for inner joint-search evaluations
        # (only the winning candidate is refined)
        self.refine = refine
        # memoized segment costs keyed by (segment structure hash, boundary
        # configs, λ) — the SearchHelper::graph_cost memo (graph.cc:1586).
        # Shareable across UnitySearch instances (the joint search reuses
        # one cache across rewritten candidate graphs, so unchanged
        # segments cost nothing to re-evaluate).
        self._segment_cache: dict = (segment_cache if segment_cache
                                     is not None else {})
        self.cache_hits = 0
        self.evals = 0  # evaluate() calls — the search-effort telemetry

    # ---------------------------------------------------- candidate configs

    def _batch_entry(self):
        """The batch axes as one PartitionSpec entry (an axis name, or a
        tuple when dcn composes with data)."""
        return (self.batch_axes[0] if len(self.batch_axes) == 1
                else tuple(self.batch_axes))

    def node_configs(self, node) -> list[NodeConfig]:
        """Candidate parallelizations (substitution families)."""
        pin = self.pinned.get(node.guid)
        if pin is not None:
            return [pin]
        ndim = len(node.outputs[0].shape.dims) if node.outputs else 0
        batch_ok = (ndim > 0 and node.outputs and
                    node.outputs[0].shape.dims[0].size % max(1, self.batch_deg) == 0
                    and node.op_type != OT.OP_GROUP_BY)
        dp = NodeConfig("dp", _dp_assign(ndim, batch_ok,
                                          batch_axes=self.batch_axes))
        if node.op_type == OT.OP_INC_MULTIHEAD_ATTENTION and batch_ok:
            # cache-aware dp: the KV cache's slot dim rides the batch axes
            # (matching model._assign_strategy's serving default), so the
            # dp candidate is priced with the cache memory/IO per chip the
            # executor will actually place — a replicated-cache price here
            # would make dp look max_seq·slots-bytes heavier than it runs
            dp = NodeConfig("dp", dp.out_assign, tuple(
                (w.name, PartitionSpec(self._batch_entry(),
                                       *([None] * (len(w.shape) - 1))))
                for w in node.weight_specs if not w.trainable))
        # (the PAGED op's pool deliberately gets NO slot-dim entry: its
        # leading dim is physical blocks shared across slots — prefix
        # sharing means any slot may read any block, so the pool stays
        # whole on the batch axes and the dp price correctly charges the
        # full pool per chip; the feature dim is the searched dim below)
        out = [dp]
        if node.op_type == OT.OP_PIPE_BLOCKS:
            from ..machine import AXIS_PIPE

            pipe_deg = self.axis_sizes.get(AXIS_PIPE, 1)
            if pipe_deg > 1 and node.params.num_layers % pipe_deg != 0:
                # the runtime pipelines whenever the mesh has a pipe axis
                # (parallel/pipeline.py) and would reject this division at
                # dispatch — fail the candidate at costing so the mesh
                # factorization search prunes it instead of picking an
                # unexecutable shape
                raise ValueError(
                    f"{node.name}: {node.params.num_layers} blocks do not "
                    f"divide over pipe axis of size {pipe_deg}")
            if pipe_deg > 1:
                # pipeline parallelism over the pipe axis (EXCEEDS the
                # reference, whose OP_PIPELINE is enum-only): stacked block
                # weights shard their layer dim, the runtime executes the
                # ppermute fill/drain schedule (parallel/pipeline.py). This
                # is the ONLY config on a pipe-carrying mesh because the
                # runtime pipelines exactly when the mesh has a pipe axis —
                # costing anything else would diverge from execution. The
                # dp-vs-pp decision is made where it is executable: across
                # mesh factorizations (search/mesh_search.py).
                ws = tuple((w.name, PartitionSpec(AXIS_PIPE))
                           for w in node.weight_specs)
                return [NodeConfig("pp", dp.out_assign, ws)]
            return out
        if self.config.only_data_parallel or (
                self.model_deg <= 1 and self.seq_deg <= 1):
            return out
        allow_param = (self.model_deg > 1
                       and (self.config.enable_parameter_parallel
                            or self.config.search_budget > 0))
        allow_attr = (self.model_deg > 1
                      and (self.config.enable_attribute_parallel
                           or self.config.search_budget > 0))
        # seq/sample-dim families gate on the reference's sample-parallel
        # flag (config.h:134), like param/attr families gate on theirs
        allow_seq = (self.seq_deg > 1
                     and (self.config.enable_sample_parallel
                          or self.config.search_budget > 0))
        if node.op_type == OT.OP_LINEAR and allow_param:
            p = node.params
            if p.out_channels % self.model_deg == 0:
                out.append(NodeConfig(
                    "tp_col",
                    _dp_assign(ndim, batch_ok, last_axes=(AXIS_MODEL,),
                               batch_axes=self.batch_axes),
                    (("kernel", PartitionSpec(None, AXIS_MODEL)),
                     ("bias", PartitionSpec(AXIS_MODEL))),
                ))
            out.append(NodeConfig(
                "tp_row", _dp_assign(ndim, batch_ok,
                                      batch_axes=self.batch_axes),
                (("kernel", PartitionSpec(AXIS_MODEL, None)),
                 ("bias", PartitionSpec())),
                psum_axes=(AXIS_MODEL,),
            ))
        elif node.op_type == OT.OP_MULTIHEAD_ATTENTION:
            p = node.params
            if allow_attr and p.num_heads % self.model_deg == 0:
                ws = [(w, PartitionSpec(None, AXIS_MODEL))
                      for w in ("wq", "wk", "wv")]
                ws += [(b, PartitionSpec(AXIS_MODEL))
                       for b in ("bq", "bk", "bv")]
                ws += [("wo", PartitionSpec(AXIS_MODEL, None)),
                       ("bo", PartitionSpec())]
                out.append(NodeConfig(
                    "tp_attn",
                    _dp_assign(ndim, batch_ok, batch_axes=self.batch_axes),
                    tuple(ws),
                    psum_axes=(AXIS_MODEL,),
                ))
            if (getattr(p, "impl", "") == "ring" and ndim == 3
                    and allow_seq
                    and node.outputs[0].shape.dims[1].size
                    % self.seq_deg == 0):
                # sequence-parallel config (AXIS_SEQ): ring attention keeps
                # queries resident while K/V rotate over the seq axis, so
                # the (b, s, d) activation stays seq-sharded through the op
                # — the long-context capability the reference lacks
                # (SURVEY §5); paired with the "sp" pass-through below
                assign = list(_dp_assign(ndim, batch_ok,
                                         batch_axes=self.batch_axes))
                assign[1] = (AXIS_SEQ,)
                out.append(NodeConfig("sp", tuple(assign)))
        elif node.op_type in (OT.OP_INC_MULTIHEAD_ATTENTION,
                              OT.OP_PAGED_INC_MULTIHEAD_ATTENTION):
            p = node.params
            if (allow_attr and p.num_heads % self.model_deg == 0
                    and p.embed_dim % self.model_deg == 0):
                # head-parallel decode attention: QKV column-parallel, O
                # row-parallel (psum), and — the serving-specific dim —
                # the KV cache's feature axis sharded over `model` so each
                # chip stores and scans only its own heads' cache rows.
                # The KV-cache placement is thereby a searched parallel
                # dim priced by the same cost model as the projections.
                # Contiguous caches additionally ride the batch axes on
                # their slot dim; the paged POOL's leading dim is
                # slot-agnostic physical blocks (shared by prefix reuse),
                # so only its feature dim shards.
                paged = node.op_type == OT.OP_PAGED_INC_MULTIHEAD_ATTENTION
                ws = [(w, PartitionSpec(None, AXIS_MODEL))
                      for w in ("wq", "wk", "wv")]
                ws += [(b, PartitionSpec(AXIS_MODEL))
                       for b in ("bq", "bk", "bv")]
                ws += [("wo", PartitionSpec(AXIS_MODEL, None)),
                       ("bo", PartitionSpec())]
                ws += [(w.name, PartitionSpec(
                            None if paged else
                            (self._batch_entry() if batch_ok else None),
                            None, AXIS_MODEL))
                       for w in node.weight_specs if not w.trainable]
                out.append(NodeConfig(
                    "tp_attn",
                    _dp_assign(ndim, batch_ok, batch_axes=self.batch_axes),
                    tuple(ws),
                    psum_axes=(AXIS_MODEL,),
                ))
        elif node.op_type == OT.OP_CONV2D and allow_attr and ndim == 4:
            # channel/attribute-parallel conv (NCHW dim 1 over `model`,
            # OIHW kernel dim 0 sharded) — the conv sibling of tp_attn
            p = node.params
            if p.out_channels % self.model_deg == 0:
                assign = list(_dp_assign(ndim, batch_ok,
                                         batch_axes=self.batch_axes))
                assign[1] = (AXIS_MODEL,)
                ws = [("kernel", PartitionSpec(AXIS_MODEL, None, None, None))]
                if p.use_bias:
                    ws.append(("bias", PartitionSpec(AXIS_MODEL)))
                out.append(NodeConfig("tp_conv", tuple(assign), tuple(ws)))
        elif node.op_type == OT.OP_EXPERTS and allow_attr:
            p = node.params
            if p.n % self.model_deg == 0:
                ws = [("kernel", PartitionSpec(AXIS_MODEL, None, None))]
                if p.use_bias:
                    ws.append(("bias", PartitionSpec(AXIS_MODEL, None)))
                out.append(NodeConfig("ep",
                                      _dp_assign(ndim, batch_ok,
                                                 batch_axes=self.batch_axes),
                                      tuple(ws)))
        elif node.op_type == OT.OP_EMBEDDING and allow_param:
            p = node.params
            if p.out_channels % self.model_deg == 0:
                out.append(NodeConfig(
                    "tp_col",
                    _dp_assign(ndim, batch_ok, last_axes=(AXIS_MODEL,),
                               batch_axes=self.batch_axes),
                    (("kernel", PartitionSpec(None, AXIS_MODEL)),),
                ))
        elif node.op_type in (OT.OP_POOL2D, OT.OP_BATCHNORM) and ndim == 4:
            # channel passthrough so a tp_conv chain can stay sharded on
            # NCHW dim 1 between conv pairs
            dims = node.outputs[0].shape.dims
            if self.model_deg > 1 and dims[1].size % self.model_deg == 0:
                assign = list(_dp_assign(ndim, batch_ok,
                                         batch_axes=self.batch_axes))
                assign[1] = (AXIS_MODEL,)
                out.append(NodeConfig("chan", tuple(assign)))
        elif node.op_type in _FEATURE_ELEMENTWISE and ndim > 1:
            # pass-through configs so TP activations can stay sharded
            # across elementwise/norm ops between a col/row pair
            dims = node.outputs[0].shape.dims
            if self.model_deg > 1 and dims[-1].size % self.model_deg == 0:
                out.append(NodeConfig(
                    "feat", _dp_assign(ndim, batch_ok,
                                       batch_axes=self.batch_axes,
                                       last_axes=(AXIS_MODEL,)),
                ))
            if (ndim == 3 and allow_seq
                    and dims[1].size % self.seq_deg == 0):
                # seq-sharded pass-through between ring-attention ops
                assign = list(_dp_assign(ndim, batch_ok,
                                         batch_axes=self.batch_axes))
                assign[1] = (AXIS_SEQ,)
                out.append(NodeConfig("sp", tuple(assign)))
        return out

    # ---------------------------------------------------- strategy evaluation

    def evaluate(self, choice: dict, only=None,
                 collect=None) -> tuple[float, float]:
        """(makespan seconds, peak per-chip memory bytes) of a full
        assignment {guid -> NodeConfig} — the simulate_runtime analog:
        per-node compute serializes across the chip set while communication
        overlaps other ops' compute, so the result is
        max(sum compute, critical path of compute+comm) via graph_makespan
        (native ff_eval_makespan), not an additive sum — concurrent
        branches (DLRM towers) are priced at max(paths). `only` restricts
        accumulation to a guid subset (segment costing): configs outside it
        still feed reshard classification but don't contribute cost.

        `collect`, when an EMPTY list, receives one dict per accumulated
        node with the full cost attribution (forward/backward/sync/reshard/
        collective seconds, per-chip memory bytes, comm axes) in
        accumulation order — the substrate of the strategy explain report
        (diagnostics/explain). Each entry also carries the accumulator's
        actual per-task (compute_s, comm_s, comm_axis_id) so the report
        reproduces the evaluator's makespan by construction, not by
        re-deriving the accumulation rules."""
        self.evals += 1
        acc = _MakespanAccum(
            overlap_sync=self.config.search_overlap_backward_update)
        mem = 0.0
        # stage-3 transient gather working set: at most two gathered
        # layers in flight (the current layer + the one-ahead prefetch),
        # charged once per plan at the LARGEST node's gathered bytes
        gather_peak = 0.0
        for node in self.order:
            if node.op_type in (OT.OP_INPUT, UOT.OP_WEIGHT, UOT.OP_NOOP):
                continue
            cfg = choice.get(node.guid)
            if cfg is None:
                continue
            if only is not None and node.guid not in only:
                continue
            if node.op_type in _PARALLEL_OPS:
                # explicit parallel-op node (joint search over rewritten
                # graphs): zero compute, collective comm (SURVEY §2.3);
                # a mismatched free producer additionally pays the reshard
                # into the degree-derived input placement
                comm, comm_axes = price_parallel_node(node, self.cm.machine)
                if cfg.in_assigns:
                    for e in sorted(self.graph.in_edges[node.guid],
                                    key=lambda e: e.dst_idx):
                        src = self.graph.nodes[e.src]
                        src_cfg = choice.get(src.guid)
                        if src_cfg is None or e.dst_idx >= len(cfg.in_assigns):
                            continue
                        pt = src.outputs[e.src_idx]
                        shape = tuple(d.size for d in pt.shape.dims
                                      if not d.is_replica_dim)
                        comm += classify_reshard(
                            shape, src_cfg.out_assign,
                            cfg.in_assigns[e.dst_idx], pt.dtype,
                            self.cm.machine)
                acc.add(node.guid, 0.0, comm, comm_axes=comm_axes)
                if collect is not None:
                    collect.append({
                        "guid": node.guid, "name": node.name,
                        "op_type": node.op_type.name, "config": cfg.name,
                        "forward_s": 0.0, "backward_s": 0.0, "sync_s": 0.0,
                        "reshard_s": 0.0, "collective_s": comm,
                        "memory_bytes": 0.0, "comm_axes": list(comm_axes)})
                continue
            in_shapes, in_assigns, reshard = [], [], 0.0
            for e in sorted(self.graph.in_edges[node.guid],
                            key=lambda e: e.dst_idx):
                src = self.graph.nodes[e.src]
                src_cfg = choice.get(src.guid)
                src_assign = (src_cfg.out_assign if src_cfg
                              else _dp_assign(
                                  len(src.outputs[e.src_idx].shape.dims),
                                  batch_axes=self.batch_axes))
                shape = tuple(d.size for d in
                              src.outputs[e.src_idx].shape.dims
                              if not d.is_replica_dim)
                in_shapes.append(shape)
                in_assigns.append(src_assign)
                # consumer's expected input spec: tp_row expects the feature
                # dim sharded (no reshard after tp_col); dp expects batch
                expected = self._expected_input(node, cfg, e.dst_idx,
                                                len(shape))
                if expected is not None:
                    reshard += classify_reshard(
                        shape, src_assign, expected,
                        src.outputs[e.src_idx].dtype, self.cm.machine)
            cm = self.cm.op_cost(node, [cfg.out_assign] * len(node.outputs),
                                 dict(cfg.weight_specs), in_shapes,
                                 in_assigns)
            psum = 0.0
            for ax in cfg.psum_axes:
                out_pt = node.outputs[0]
                shard_bytes = _shard_elems(
                    tuple(d.size for d in out_pt.shape.dims
                          if not d.is_replica_dim),
                    cfg.out_assign, self.axis_sizes) * dtype_bytes(out_pt.dtype)
                psum += self.cm.machine.all_reduce(shard_bytes, ax)
            comm_axes = tuple(cfg.psum_axes)
            overlap_comm = 0.0
            overlap_overhead = 0.0
            if (cfg.name == "sp"
                    and node.op_type == OT.OP_MULTIHEAD_ATTENTION):
                # ring attention's defining cost: K and V blocks rotate
                # (seq_deg − 1) neighbor hops per forward, and the backward
                # re-rotates them (≈2× fwd) — priced as ppermute traffic of
                # the local activation block (parallel/ring_attention.py).
                # rotate, not ppermute: the K/V shift includes the wrap
                # pair, which a non-wraparound (open) seq axis pays as a
                # full line traversal (TorusMachineModel.rotate); the
                # calibrated hop (collective_rotate) overrides the analytic
                # guess when the warm-start DB carries a measurement.
                out_pt = node.outputs[0]
                local_bytes = _shard_elems(
                    tuple(d.size for d in out_pt.shape.dims
                          if not d.is_replica_dim),
                    cfg.out_assign, self.axis_sizes) * dtype_bytes(out_pt.dtype)
                hops = 2 * (self.seq_deg - 1)  # K and V, fwd
                ring_comm = 3.0 * hops * self.cm.collective_rotate(
                    local_bytes, AXIS_SEQ)
                comm_axes = comm_axes + (AXIS_SEQ,)
                if getattr(self.config, "overlap_collectives", True):
                    # the runtime issues each hop before the block compute
                    # it overlaps (double-buffered ppermute pipeline), so
                    # the honest price is max(compute, comm) plus the
                    # fixed per-hop issue latency that never hides
                    overlap_comm = ring_comm
                    overlap_overhead = (
                        3.0 * hops * self.cm.machine._lat(AXIS_SEQ))
                else:
                    psum += ring_comm
            grad_sync = cm.sync_time + cm.update_sync_time
            # the shared update-mode pricing rules (cost_model.
            # price_grad_sync / price_param_gather — also what
            # choose_update_sharding decides through, via
            # evaluate_assigned_graph)
            sync_arg, gs_overlap, gs_overhead, grad_sync_sharded = (
                price_grad_sync(cm, self.cm.update_sharding,
                                self.cm.overlap_update))
            pg_serial, pg_overlap, pg_overhead, param_gather_s = (
                price_param_gather(cm, self.cm.overlap_update))
            overlap_comm += gs_overlap + pg_overlap
            overlap_overhead += gs_overhead + pg_overhead
            compute_t = cm.forward_time + cm.backward_time
            if (cfg.name == "pp"
                    and node.op_type == OT.OP_PIPE_BLOCKS):
                # fill/drain bubble + stage hand-off pricing for the
                # ppermute pipeline (parallel/pipeline.py): the ideal
                # per-chip compute T/(data·P) (already reflected in
                # op_cost's sharded flops) stretches by (M+P−1)/M — this
                # INCLUDES the placeholder compute every stage burns
                # during fill/drain ticks (SPMD executes everywhere) —
                # and each of the ~3·(M+P−1) fwd+bwd ticks hands one
                # microbatch activation to the next stage over a neighbor
                # ICI link.
                from ..machine import AXIS_PIPE

                p = node.params
                P = self.axis_sizes.get(AXIS_PIPE, 1)
                M = p.num_microbatches or 2 * P
                compute_t *= (M + P - 1) / M
                out_pt = node.outputs[0]
                mb_bytes = (_shard_elems(
                    tuple(d.size for d in out_pt.shape.dims
                          if not d.is_replica_dim),
                    cfg.out_assign, self.axis_sizes)
                    * dtype_bytes(out_pt.dtype) / M)
                psum += 3.0 * (M + P - 1) * self.cm.machine.ppermute(
                    mb_bytes, AXIS_PIPE)
                comm_axes = comm_axes + (AXIS_PIPE,)
            if not comm_axes and (grad_sync > 0
                                  or cm.param_gather_time > 0):
                comm_axes = (AXIS_DATA,)  # gradient sync rides `data`
            acc.add(node.guid,
                    compute_t,
                    cm.comm_time + reshard + psum + pg_serial,
                    comm_axes=comm_axes, sync=sync_arg,
                    overlappable_comm=overlap_comm,
                    overlap_overhead=overlap_overhead)
            mem += cm.memory
            gather_peak = max(gather_peak, cm.gather_bytes)
            if collect is not None:
                # compute_t may carry the pipeline bubble stretch; report
                # the stretched split so entries still sum to compute_t
                stretch = (compute_t
                           / max(cm.forward_time + cm.backward_time, 1e-30))
                collect.append({
                    "guid": node.guid, "name": node.name,
                    "op_type": node.op_type.name, "config": cfg.name,
                    "forward_s": cm.forward_time * stretch,
                    "backward_s": cm.backward_time * stretch,
                    "sync_s": sync_arg,
                    "reshard_s": reshard,
                    "collective_s": cm.comm_time + psum + pg_serial,
                    # overlap-capable collective traffic (hidden behind
                    # this op's compute; still occupies its ICI axis) —
                    # ring hops plus, under weight-update sharding, the
                    # grad RS+AG (grad_sync_s names that share)
                    "overlap_s": overlap_comm,
                    "overlap_overhead_s": overlap_overhead,
                    "grad_sync_s": grad_sync_sharded,
                    # stage-3 just-in-time weight gathers (fwd + bwd
                    # re-gather): inside overlap_s when overlapped,
                    # inside this node's comm when serial
                    "param_gather_s": param_gather_s,
                    "update_shards": cm.update_shards,
                    "memory_bytes": cm.memory,
                    "comm_axes": list(comm_axes)})
        if collect is not None:
            # entries align 1:1 with the accumulator's task arrays (both
            # append once per accumulated node, in self.order)
            for d, c, q, ax in zip(collect, acc.compute, acc.comm,
                                   acc.axis):
                d["compute_s"] = c
                d["comm_s"] = q
                d["comm_axis_id"] = ax
        # stage 3: the per-node memory dropped the resident gathered
        # copies; charge the double-buffered gather working set once
        mem += 2.0 * gather_peak
        return acc.makespan(self.graph.in_edges), mem

    def _expected_input(self, node, cfg, dst_idx, ndim):
        """The input spec a config consumes (None = producer's choice OK).

        Applies to EVERY input edge, not just input 0 — multi-input ops
        (aggregate's expert outputs, element-binary towers, concat) must
        pay the reshard their secondary operands need, otherwise e.g. a
        feature-sharded expert output flows into a dp aggregate for free
        and the search underprices unfused plans."""
        if cfg.in_assigns is not None:  # rewrite-pinned: degree-derived
            if dst_idx < len(cfg.in_assigns):
                return cfg.in_assigns[dst_idx]
            return None
        if cfg.name == "tp_row":
            if dst_idx == 0:
                return _dp_assign(ndim, True, last_axes=(AXIS_MODEL,),
                                  batch_axes=self.batch_axes)
            return _dp_assign(ndim, True, batch_axes=self.batch_axes)
        if cfg.name in ("dp", "tp_col", "tp_attn", "tp_conv", "ep", "pp"):
            # tp_conv included: an O-sharded kernel consumes the FULL input
            # channels, so a chan-sharded producer pays a real all-gather;
            # pp consumes the plain batch-sharded activation (stage weights
            # ride pipe, activations ride data)
            return _dp_assign(ndim, True, batch_axes=self.batch_axes)
        if cfg.name in ("feat", "chan", "sp") and len(cfg.out_assign) == ndim:
            # pass-through configs consume their own (sharded) layout
            return cfg.out_assign
        return None

    # ---------------------------------------------------- bottleneck DP

    def bottlenecks(self) -> list:
        """Nodes every source→sink path crosses (the sequence-split points,
        graph.cc find_bottleneck_node)."""
        from ..pcg.graph import find_bottlenecks

        return find_bottlenecks(self.graph, self.order)

    def run(self) -> dict:
        """Memoized sequence DP over bottleneck-node configs — the
        find_optimal_sequence_graph_time recursion flattened
        (graph.cc:115-180, 1586-1843): the graph is cut at bottleneck
        nodes; the DP state is the config of the cut node's tensor; each
        segment's interior is optimized once per (in-config, out-config)
        boundary pair and memoized by segment *structure*, so repeated
        transformer blocks (and unchanged segments across rewritten
        candidate graphs) hit the cache. Best-first refinement afterwards
        (base_optimize analog). Returns {guid -> NodeConfig}."""
        from .. import telemetry

        with telemetry.span("unity.dp", nodes=len(self.order)):
            choice = self._run_dp()
        telemetry.counter("unity.search_effort", {
            "evals": self.evals, "cache_hits": self.cache_hits})
        return choice

    def _run_dp(self) -> dict:
        segments = self._split_segments()
        if len(segments) <= 1:
            choice: dict = {}
            for seg in segments:
                choice.update(self._optimize_segment(seg, choice))
            return self._refine(choice) if self.refine else choice
        # dp: {boundary NodeConfig -> (cumulative cost, full choice)}
        dp: dict = {None: (0.0, {})}
        prev_bn = None
        for k, seg in enumerate(segments):
            bn = seg[-1]
            last = k == len(segments) - 1
            # the sink segment's boundary is unconstrained (its configs are
            # chosen by the interior optimization)
            out_cfgs = [None] if last else self.node_configs(bn)
            ndp: dict = {}
            for in_cfg, (prev_cost, prev_choice) in dp.items():
                for out_cfg in out_cfgs:
                    seg_choice, seg_cost = self._segment_cost(
                        seg, in_cfg, out_cfg, prev_bn)
                    tot = prev_cost + seg_cost
                    cur = ndp.get(out_cfg)
                    if cur is None or tot < cur[0]:
                        full = dict(prev_choice)
                        full.update(seg_choice)
                        ndp[out_cfg] = (tot, full)
            dp = ndp
            prev_bn = bn
        _, best_choice = min(dp.values(), key=lambda t: t[0])
        return self._refine(best_choice) if self.refine else best_choice

    def _split_segments(self):
        cuts = {n.guid for n in self.bottlenecks()}
        segments, cur = [], []
        for n in self.order:
            cur.append(n)
            if n.guid in cuts and len(cur) >= self.config.base_optimize_threshold:
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)
        return segments

    def _segment_key(self, seg):
        """Structural hash of a segment: op types/params/output shapes +
        internal wiring + external input shapes. Two segments with equal
        keys have identical cost surfaces, so (key, boundary configs) fully
        determines the memoized optimum — the reference memoizes graph_cost
        by (subgraph hash, source/sink MachineViews)."""
        idx = {n.guid: i for i, n in enumerate(seg)}
        parts = []
        for n in seg:
            edges = []
            for e in sorted(self.graph.in_edges[n.guid],
                            key=lambda e: e.dst_idx):
                src = self.graph.nodes[e.src]
                if e.src in idx:
                    edges.append((idx[e.src], e.src_idx, e.dst_idx))
                else:  # external producer: its full PARALLEL shape (degrees
                    # + replica dims, not just logical sizes) drives both
                    # reshard cost and any rewrite-pinned configs inside the
                    # segment, so it must be part of the key — two joint-
                    # search candidates can agree on logical shapes but
                    # differ in boundary parallel state
                    pt = src.outputs[e.src_idx]
                    edges.append((-1, repr(pt.shape), e.dst_idx))
            parts.append((n.op_type, repr(n.params),
                          tuple(repr(pt.shape) for pt in n.outputs),
                          tuple(edges)))
        return hash(tuple(parts))

    def _segment_cost(self, seg, in_cfg, out_cfg, prev_bn):
        """Memoized optimal (choice, cost) of one segment under fixed
        boundary configs. Bottleneck cuts guarantee every edge crossing the
        cut leaves the bottleneck node itself, so (in_cfg, out_cfg) is the
        complete external context."""
        lam = getattr(self, "_lambda", 0.0)
        key = (self._segment_key(seg), in_cfg, out_cfg, lam)
        hit = self._segment_cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            cfgs, cost = hit
            return {n.guid: c for n, c in zip(seg, cfgs)}, cost
        context = ({prev_bn.guid: in_cfg}
                   if prev_bn is not None and in_cfg is not None else {})
        pinned = {seg[-1].guid: out_cfg} if out_cfg is not None else {}
        choice = self._optimize_segment(seg, context, pinned)
        only = {n.guid for n in seg}
        full = dict(context)
        full.update(choice)
        cost, mem = self.evaluate(full, only=only)
        cost = self._memory_penalized(cost, mem)
        self._segment_cache[key] = (tuple(choice[n.guid] for n in seg), cost)
        return choice, cost

    def _optimize_segment(self, seg, context: dict,
                          pinned: Optional[dict] = None) -> dict:
        """Jointly enumerate configs for interesting nodes in the segment
        (the nonsequence exhaustive split); pass-through nodes follow.
        `pinned` fixes boundary-node configs chosen by the outer DP."""
        pinned = pinned or {}
        interesting = [n for n in seg
                       if n.guid not in pinned
                       and len(self.node_configs(n)) > 1]
        base = {n.guid: self.node_configs(n)[0] for n in seg}
        base.update(pinned)
        if not interesting:
            return base
        only = {n.guid for n in seg}
        # cap the joint enumeration (reference caps via threshold + DP)
        cap = 6
        heads, tail = interesting[:cap], interesting[cap:]
        best, best_cost = base, None
        for combo in itertools.product(
                *(self.node_configs(n) for n in heads)):
            cand = dict(base)
            for n, cfg in zip(heads, combo):
                cand[n.guid] = cfg
            self._propagate_feature_chains(seg, cand)
            cand.update(pinned)
            full = dict(context)
            full.update(cand)
            cost, mem = self.evaluate(full, only=only)
            cost = self._memory_penalized(cost, mem)
            if best_cost is None or cost < best_cost:
                best, best_cost = cand, cost
        for n in tail:  # greedy for the rest
            cands = self.node_configs(n)
            cur_best, cur_cost = None, None
            for cfg in cands:
                cand = dict(best)
                cand[n.guid] = cfg
                full = dict(context)
                full.update(cand)
                cost, mem = self.evaluate(full, only=only)
                cost = self._memory_penalized(cost, mem)
                if cur_cost is None or cost < cur_cost:
                    cur_best, cur_cost = cand, cost
            best = cur_best
        return best

    def _propagate_feature_chains(self, seg, cand):
        """Between a tp_col producer and a tp_row consumer, flip elementwise
        nodes to their 'feat' config so the sharded activation survives."""
        by_guid = {n.guid: n for n in seg}
        for n in seg:
            cfg = cand.get(n.guid)
            if cfg is None or cfg.name != "tp_row":
                continue
            # walk the first-input chain upward while elementwise
            cur = n
            while True:
                edges = self.graph.in_edges[cur.guid]
                if not edges:
                    break
                src = self.graph.nodes[sorted(edges,
                                              key=lambda e: e.dst_idx)[0].src]
                if src.guid not in by_guid:
                    break
                scfg = cand.get(src.guid)
                if scfg and scfg.name in ("tp_col", "tp_attn"):
                    break
                feats = [c for c in self.node_configs(src)
                         if c.name == "feat"]
                if not feats:
                    break
                cand[src.guid] = feats[0]
                cur = src

    def _memory_penalized(self, cost, mem):
        cap = self.cm.machine.chip.hbm_bytes
        if mem > cap:
            # invalid strategy: harsh penalty (is_valid_strategy analog)
            return cost * (1.0 + 10.0 * (mem - cap) / cap)
        if self.config.perform_memory_search:
            lam = getattr(self, "_lambda", 0.0)
            return cost * (1 - lam) + lam * cost * (mem / cap)
        return cost

    def _refine(self, choice: dict) -> dict:
        """Budgeted best-first single-node moves (base_optimize analog)."""
        from .. import telemetry

        budget = self.config.search_budget or 8
        alpha = self.config.search_alpha
        best = dict(choice)
        cost0, mem0 = self.evaluate(best)
        best_cost = self._memory_penalized(cost0, mem0)
        frontier = [best]
        seen = set()
        for _ in range(budget):
            if not frontier:
                break
            cur = frontier.pop(0)
            for node in self.order:
                for cfg in self.node_configs(node)[1:]:
                    if cur.get(node.guid) is cfg:
                        continue
                    cand = dict(cur)
                    cand[node.guid] = cfg
                    key = tuple(sorted((g, c.name) for g, c in cand.items()))
                    if key in seen:
                        continue
                    seen.add(key)
                    cost, mem = self.evaluate(cand)
                    cost = self._memory_penalized(cost, mem)
                    if cost < best_cost:
                        best, best_cost = cand, cost
                        frontier.append(cand)
                        # best-cost-so-far curve: one counter sample per
                        # improvement, visible as a descending staircase
                        telemetry.counter(
                            "unity.best_cost_ms",
                            {"cost": best_cost * 1e3})
                    elif cost < best_cost * alpha:
                        frontier.append(cand)
        return best

    # ---------------------------------------------------- emission

    def to_strategy(self, choice: dict) -> Strategy:
        """Choice → exportable Strategy. Rewrite-pinned compute configs
        ("xfer") are included in their logical-rank form: as in the JAX package the
        same placements expressed as plain per-node specs on the ORIGINAL
        graph execute identically (the inserted Replicate/Reduction nodes
        become implicit collectives), so an exported plan replays without
        the rewritten graph. Parallel-op nodes ("xfer_comm") are therefore
        skipped — their effect is carried by their neighbors' specs."""
        s = Strategy()
        for node in self.order:
            cfg = choice.get(node.guid)
            if cfg is None or cfg.name in ("dp", "xfer_comm"):
                continue
            for i in range(len(node.outputs)):
                s.set_output(node.name, i, cfg.out_assign)
            declared = {ws.name for ws in node.weight_specs}
            for wname, spec in cfg.weight_specs:
                if wname in declared:
                    s.set_weight(node.name, wname, spec)
        return s


_FEATURE_ELEMENTWISE = frozenset({
    OT.OP_RELU, OT.OP_GELU, OT.OP_SIGMOID, OT.OP_TANH, OT.OP_ELU,
    OT.OP_IDENTITY, OT.OP_DROPOUT, OT.OP_SCALAR_MULTIPLY, OT.OP_SCALAR_ADD,
    OT.OP_SCALAR_SUB, OT.OP_SCALAR_TRUE_DIV, OT.OP_LAYERNORM, OT.OP_SOFTMAX,
    OT.OP_EW_ADD, OT.OP_EW_MUL,
})


def mcmc_optimize(search: UnitySearch, budget: int = 1000,
                  alpha: float = 0.05, seed: int = 0) -> dict:
    """Legacy pre-Unity MCMC strategy search (FFModel::mcmc_optimize,
    model.cc:3285-3357, exposed via STRATEGY_SEARCH_TASK_ID): simulated
    annealing over per-node configs starting from data parallel — a random
    single-node rewrite per iteration, accepted when cheaper or with
    probability exp(-alpha·Δµs) (Δ is in seconds here where the reference
    simulator works in ~µs-scale units, hence the 1e6 factor below), with a
    periodic reset to the incumbent (reset_span = clamp(budget/100, 1,
    1000)). Returns {guid -> NodeConfig}; superseded by the joint Unity
    search but kept for parity."""
    import random

    rng = random.Random(seed)
    mutable = [n for n in search.order if len(search.node_configs(n)) > 1]

    def cost_of(choice):
        t, mem = search.evaluate(choice)
        return search._memory_penalized(t, mem)

    best = {n.guid: search.node_configs(n)[0] for n in search.order
            if search.node_configs(n)}
    best_cost = cost_of(best)
    current, current_cost = dict(best), best_cost
    if not mutable:
        return best
    reset_span = min(max(budget // 100, 1), 1000)
    last_reset = 0
    for it in range(budget + 1):
        if it - last_reset >= reset_span:
            current, current_cost = dict(best), best_cost
            last_reset = it
        node = rng.choice(mutable)
        cfgs = search.node_configs(node)
        nxt = dict(current)
        nxt[node.guid] = rng.choice(cfgs)
        nxt_cost = cost_of(nxt)
        if nxt_cost < best_cost:
            best, best_cost = dict(nxt), nxt_cost
        if nxt_cost < current_cost or (
                rng.random() < math.exp(
                    -alpha * max(0.0, nxt_cost - current_cost) * 1e6)):
            current, current_cost = nxt, nxt_cost
    return best


def mcmc_search_strategy(graph, mesh, config,
                         cost_model: Optional[CostModel] = None,
                         alpha: float = 0.05) -> Strategy:
    """MCMC entry returning a Strategy (the STRATEGY_SEARCH_TASK_ID
    surface). `alpha` is the annealing temperature coefficient (reference
    default 0.05) — deliberately NOT config.search_alpha, which is the
    best-first pruning slack with a completely different scale."""
    from .machine_model import machine_model_for_mesh

    cm = cost_model or CostModel(machine_model_for_mesh(mesh))
    search = UnitySearch(graph, mesh, config, cm)
    budget = config.search_budget or 1000
    choice = mcmc_optimize(search, budget=budget, alpha=alpha,
                           seed=config.seed)
    return search.to_strategy(choice)


def lambda_memory_search(make_search, hbm_bytes: float, iters: int = 5):
    """λ binary search between pure-runtime and memory-lean strategies
    (graph_optimize_task, graph.cc:2056-2131). `make_search()` supplies the
    UnitySearch for each probe (callers reuse one instance or rebuild a
    pinned one); λ is part of the segment-cache key, so every probe
    re-optimizes under its own blended objective. Returns (choice, search)
    of the lightest feasible probe — or of the last probe when none fits,
    matching the reference's fall-through when even λ=1 exceeds memory."""
    lo, hi = 0.0, 1.0
    best = None
    last = None
    for _ in range(iters):
        mid = (lo + hi) / 2
        s = make_search()
        s._lambda = mid
        choice = s.run()
        _, mem = s.evaluate(choice)
        last = (choice, s)
        if mem > hbm_bytes:
            lo = mid
        else:
            best = (choice, s)
            hi = mid
    return best or last


def choose_update_sharding(graph, mesh, config,
                           cost_model: Optional[CostModel] = None,
                           opt_slots: int = 1, overlap: bool = True) -> dict:
    """Decide how the weight update runs — replicated, ZeRO stage 2
    (masters/grads/optimizer slots at 1/dp, Xu et al. 2020), or ZeRO-3 /
    FSDP stage 3 (the trainable weights themselves sharded at rest with
    just-in-time per-layer gathers, Rajbhandari et al. SC'20; Zhao et
    al. VLDB'23) — the update-dimension half of the Unity search, priced
    by the same evaluator after the per-node placements are materialized
    on the graph.

    All three candidates move comparable ring bytes (allreduce ≡ RS+AG;
    stage 3 re-gathers on the backward), so the decision is exactly the
    papers' tradeoff: stage 2 wins when the plan is GRAD-SYNC-BOUND (the
    overlappable channel hides the pair behind backward compute while
    the replicated allreduce serializes) or MEMORY-BOUND (masters +
    slots at 1/dp bring the plan under the per-chip HBM cap); stage 3
    wins exactly when the plan is memory-bound past stage 2 — the
    RESIDENT GATHERED COPIES (per-chip model bytes flat in dp) are
    themselves over the cap, and 1/shards-at-rest weights plus at most
    two gathered layers in flight are what fits; replicated wins when
    the model is so small that the pair's fixed per-hop issue latency
    exceeds the sync it hides (the 2% margin keeps tiny CI models on
    the replicated baseline rather than flip-flopping on pricing
    noise). `--weight-update-sharding[=stage3|stage2|off]` /
    `--no-weight-update-sharding` force the outcome; every trajectory
    is bit-identical, so forcing is always safe.

    `overlap` prices the sharded pair on the overlappable channel, as the
    JAX package does by default (`overlap_collectives`); the port's
    runtime syncs after the whole backward, neither bucketed nor
    overlapped (ROADMAP G1), and the record says so (`overlap_priced`,
    `overlap_runtime`).

    Returns the decision record the model stashes (`_update_sharding`),
    checkpoint manifests embed, and strategy_report.json surfaces —
    including `stage` (0 | 2 | 3). As a side effect the cost model is
    left pricing the CHOSEN update mode, so the explain report / drift
    monitor describe the running config."""
    from ..fftype import CompMode
    from ..machine import batch_axes_for
    from .machine_model import machine_model_for_mesh
    from .substitution import evaluate_assigned_graph

    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    axes = batch_axes_for(axis_sizes)
    shards = 1
    for ax in axes:
        shards *= axis_sizes.get(ax, 1)
    decision = {
        "enabled": False,
        "stage": 0,
        "shards": shards,
        "axes": list(axes),
        "forced": config.weight_update_sharding,
        "forced_stage": config.weight_update_stage,
        "overlap_priced": bool(overlap),
        "overlap_runtime": False,
    }
    trainable = any(
        ws.trainable
        for n in graph.topo_order()
        if not getattr(n, "weight_source", None)
        for ws in n.weight_specs)
    if (shards <= 1 or not trainable
            or config.computation_mode != CompMode.COMP_MODE_TRAINING):
        decision["reason"] = ("no_grad_sync" if shards <= 1 or not trainable
                              else "inference")
        return decision
    cm = cost_model or CostModel(
        machine_model_for_mesh(mesh, num_hosts=config.num_nodes),
        opt_slots=opt_slots)
    cap = (config.device_mem if config.device_mem > 0
           else cm.machine.chip.hbm_bytes)

    def _priced(stage: int, totals=None):
        cm.update_sharding = stage >= 2
        cm.param_gather = stage >= 3
        cm.overlap_update = stage >= 2 and bool(overlap)
        # same overlap_sync the real evaluator prices with — the decision
        # and the strategy report must read the same makespan rule
        t, mem = evaluate_assigned_graph(
            graph, mesh, cm,
            overlap_sync=bool(config.search_overlap_backward_update),
            totals=totals)
        pen = t * (1.0 + 10.0 * (mem - cap) / cap) if mem > cap else t
        return t, mem, pen

    rep_totals: dict = {}
    t_rep, mem_rep, c_rep = _priced(0, totals=rep_totals)
    t_s2, mem_s2, c_s2 = _priced(2)
    s3_totals: dict = {}
    t_s3, mem_s3, c_s3 = _priced(3, totals=s3_totals)
    sync_frac = (rep_totals.get("sync_s", 0.0) / t_rep if t_rep > 0
                 else 0.0)
    # the ONE stage-3 trigger, shared by auto and the bare force-on: the
    # resident gathered copies of stage 2 are over the per-chip cap and
    # the 1/shards-at-rest pricing is actually cheaper under the penalty
    stage3_memory_bound = mem_s2 > cap and c_s3 < c_s2
    if config.weight_update_sharding is not None:
        # forced (every trajectory is bit-identical, so forcing is
        # always safe); the candidates are still all priced so the
        # decision record / bench ablation carry the comparison
        enabled = config.weight_update_sharding
        if not enabled:
            stage = 0
        elif config.weight_update_stage in (2, 3):
            stage = config.weight_update_stage
        else:
            # bare legacy --weight-update-sharding: sharded forced on,
            # the stage still priced
            stage = 3 if stage3_memory_bound else 2
        decision["reason"] = "flag"
    elif config.weight_update_stage == 0:
        # stage forced to replicated (programmatic weight_update_stage=0
        # without the boolean flag): honored exactly like =off
        enabled = False
        stage = 0
        decision["reason"] = "flag"
    else:
        # grad-sync-bound: the replicated allreduce is a material slice
        # (≥10%) of the predicted step AND the overlappable pricing is
        # ≥2% cheaper — tiny models whose sync the hop latency would
        # dominate stay replicated rather than flip-flop on noise
        memory_bound = mem_rep > cap and min(c_s2, c_s3) < c_rep
        overlap_bound = c_s2 < 0.98 * c_rep and sync_frac >= 0.1
        enabled = memory_bound or overlap_bound
        if not enabled:
            stage = 0
            decision["reason"] = "replicated_cheaper"
        elif config.weight_update_stage in (2, 3):
            # enablement stayed auto, but a set weight_update_stage PINS
            # the stage used when sharding wins (the documented 2/3 =
            # forced contract — e.g. cap at stage 2 programmatically)
            stage = config.weight_update_stage
            decision["reason"] = ("memory_bound" if memory_bound
                                  else "overlap_bound")
        elif stage3_memory_bound:
            stage = 3
            decision["reason"] = "memory_bound"
        else:
            stage = 2
            decision["reason"] = ("memory_bound" if memory_bound
                                  else "overlap_bound")
    decision["enabled"] = bool(enabled) and stage >= 2
    decision["stage"] = stage if decision["enabled"] else 0
    t_sh, mem_sh, c_sh = ((t_s3, mem_s3, c_s3) if stage == 3
                          else (t_s2, mem_s2, c_s2))
    decision["predicted"] = {
        "replicated_s": t_rep, "sharded_s": t_sh,
        "replicated_cost_s": c_rep, "sharded_cost_s": c_sh,
        "replicated_mem_bytes": mem_rep, "sharded_mem_bytes": mem_sh,
        "stage2_s": t_s2, "stage3_s": t_s3,
        "stage2_cost_s": c_s2, "stage3_cost_s": c_s3,
        "stage2_mem_bytes": mem_s2, "stage3_mem_bytes": mem_s3,
        "param_gather_s": s3_totals.get("param_gather_s", 0.0),
        "grad_sync_fraction": sync_frac,
        "hbm_cap_bytes": cap,
    }
    # leave the cost model pricing the chosen mode (the strategy report
    # and the drift monitor's predicted makespan must describe what runs)
    cm.update_sharding = decision["enabled"]
    cm.param_gather = decision["stage"] == 3
    cm.overlap_update = decision["enabled"] and bool(overlap)
    return decision


def search_strategy(graph, mesh, config,
                    machine: Optional[TPUMachineModel] = None,
                    cost_model: Optional[CostModel] = None) -> Strategy:
    """Entry point: GRAPH_OPTIMIZE_TASK analog (graph.cc:2046). Runs the DP
    + refinement, with the λ memory binary search when requested."""
    from .machine_model import machine_model_for_mesh

    machine = machine or machine_model_for_mesh(mesh)
    cm = cost_model or CostModel(machine)
    search = UnitySearch(graph, mesh, config, cm)
    if config.perform_memory_search:
        choice, search = lambda_memory_search(
            lambda: search, machine.chip.hbm_bytes)
    else:
        choice = search.run()
    return search.to_strategy(choice)
