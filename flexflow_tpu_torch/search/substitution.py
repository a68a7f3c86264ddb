"""GraphXfer substitution engine (twin of `flexflow_tpu/search/substitution.py`):
PCG rewrites that insert or remove parallel ops.

Reference: src/runtime/substitution.cc — TASO-style rewrite rules where a
source pattern of `OpX` nodes (with `TensorX` symbolic tensors) is replaced by
a target pattern, discovered by a backtracking matcher (`find_matches`, :510)
and applied by graph reconstruction (`create_new_graph`, :782); ~30 hand-coded
generators build the rule set (generate_all_pcg_xfers, :1726-1868) and a JSON
loader adds external rules (substitution_loader.cc); `base_optimize`
(:2229-2311) explores rewritten graphs best-first under a budget with alpha
pruning and graph-hash dedup.

As in the JAX package, rewrites operate on the PCG (pcg/graph.py) and insert
explicit Repartition/Combine/Replicate/Reduction nodes
(parallel/ops.apply_parallel_op_shape is the per-node shape transform). One
deliberate divergence from the reference's mechanics: compute-op params stay
GLOBAL after a rewrite (the reference rewrites attention to num_heads/k per
device; here the op keeps global heads and the sharding lives in the
tensors' ParallelDim degrees + weight PartitionSpecs, which the executor
places). `propagate_parallel_state` is the
solve_parallel_dim_mappings analog: it re-derives every tensor's degrees and
every op's implied weight shardings from the inserted parallel ops.
"""

from __future__ import annotations

import heapq
import itertools
import json
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

from ..fftype import ActiMode, OperatorType as OT, PARALLEL_OP_TYPES
from ..fftype import UnportedOperatorType as UOT
from ..machine import AXIS_DATA, AXIS_MODEL
from ..parallel.ops import (
    CombineParams,
    ReductionParams,
    RepartitionParams,
    ReplicateParams,
    apply_parallel_op_shape,
)
from ..pcg.graph import Graph, OpNode, is_expert_buffer
from ..tensor import (
    ParallelDim,
    ParallelTensor,
    ParallelTensorShape,
    PartitionSpec,
)
from .cost_model import CostModel, price_parallel_node

# --------------------------------------------------------------------- pattern


@dataclass(frozen=True)
class TensorX:
    """Symbolic tensor: output `idx` of pattern op `op`, or (op=None) the
    xfer's free input slot `idx` (reference TensorX, substitution.h)."""

    op: Optional["OpX"] = None
    idx: int = 0


class OpX:
    """One pattern/replacement operator (reference OpX).

    Source-side: `op_type` + `constraints` (predicates on the matched
    OpNode) define what matches. Dest-side: `match_src` names the source OpX
    whose params/name/weights the new node inherits (the reference's
    matchOpX), or `make_params` builds fresh params (parallel ops)."""

    def __init__(
        self,
        op_type: OT,
        inputs: tuple[TensorX, ...] = (),
        num_outputs: int = 1,
        constraints: tuple[Callable[[OpNode], bool], ...] = (),
        match_src: Optional["OpX"] = None,
        make_params: Optional[Callable[[dict], Any]] = None,
    ):
        self.op_type = op_type
        self.inputs = tuple(inputs)
        self.outputs = tuple(TensorX(self, i) for i in range(num_outputs))
        self.constraints = tuple(constraints)
        self.match_src = match_src
        self.make_params = make_params


@dataclass
class Match:
    """One pattern occurrence: pattern op → graph node, free input slot →
    (producer guid, out idx) — or (None, input-node guid) for graph sources."""

    ops: dict  # OpX -> OpNode
    inputs: dict  # slot idx -> (guid, out_idx)


class GraphXfer:
    """A rewrite rule: src pattern → dst pattern (reference GraphXfer)."""

    def __init__(self, name: str):
        self.name = name
        self.src_ops: list[OpX] = []
        self.dst_ops: list[OpX] = []
        # (src TensorX, dst TensorX): external consumers of the src tensor
        # re-point to the dst tensor after the rewrite (map_output)
        self.mapped_outputs: list[tuple[TensorX, TensorX]] = []

    def new_input(self, idx: int) -> TensorX:
        return TensorX(None, idx)

    def map_output(self, src_tx: TensorX, dst_tx: TensorX):
        self.mapped_outputs.append((src_tx, dst_tx))

    # ------------------------------------------------------------- matching

    def find_matches(self, graph: Graph) -> list[Match]:
        """Backtracking pattern match (reference find_matches,
        substitution.cc:510)."""
        matches: list[Match] = []
        order = graph.topo_order()
        self._match_rec(graph, order, 0, Match({}, {}), matches)
        return matches

    def _match_rec(self, graph, order, depth, cur: Match, out: list[Match]):
        if depth == len(self.src_ops):
            if self._check_internal_consumers(graph, cur):
                out.append(Match(dict(cur.ops), dict(cur.inputs)))
            return
        px = self.src_ops[depth]
        for node in order:
            if node.op_type != px.op_type or node in cur.ops.values():
                continue
            if not all(c(node) for c in px.constraints):
                continue
            edges = sorted(graph.in_edges[node.guid], key=lambda e: e.dst_idx)
            if len(edges) < len(px.inputs):
                continue
            binding_inputs = dict(cur.inputs)
            ok = True
            for i, tx in enumerate(px.inputs):
                e = edges[i]
                src = (e.src, e.src_idx)
                if tx.op is not None:  # must come from an earlier matched op
                    want = cur.ops.get(tx.op)
                    if want is None or want.guid != e.src or tx.idx != e.src_idx:
                        ok = False
                        break
                else:  # free input slot: bind or check consistency
                    bound = binding_inputs.get(tx.idx)
                    if bound is None:
                        binding_inputs[tx.idx] = src
                    elif bound != src:
                        ok = False
                        break
            if not ok:
                continue
            cur.ops[px] = node
            saved = cur.inputs
            cur.inputs = binding_inputs
            self._match_rec(graph, order, depth + 1, cur, out)
            cur.inputs = saved
            del cur.ops[px]

    def _check_internal_consumers(self, graph, m: Match) -> bool:
        """Non-mapped outputs of matched ops must have no consumers outside
        the match (else the rewrite would orphan them)."""
        matched = {n.guid for n in m.ops.values()}
        mapped = set()
        for src_tx, _ in self.mapped_outputs:
            node = m.ops[src_tx.op]
            mapped.add((node.guid, src_tx.idx))
        for px, node in m.ops.items():
            for e in graph.out_edges[node.guid]:
                if (node.guid, e.src_idx) in mapped:
                    continue
                if e.dst not in matched:
                    return False
        return True

    # -------------------------------------------------------------- rewrite

    def apply(self, graph: Graph, m: Match) -> Graph:
        """Build the rewritten graph (reference create_new_graph,
        substitution.cc:782). Raises ValueError when the rewritten parallel
        state is inconsistent (invalid candidate — caller discards)."""
        new_g = Graph()
        matched = {n.guid for n in m.ops.values()}
        clone: dict[int, OpNode] = {}
        for node in graph.topo_order():
            if node.guid in matched:
                continue
            clone[node.guid] = _clone_node(new_g, node)
        # instantiate dst ops
        dst_node: dict[OpX, OpNode] = {}
        for dx in self.dst_ops:
            if dx.match_src is not None:
                src_node = m.ops[dx.match_src]
                params = (dx.make_params(m.ops) if dx.make_params
                          else src_node.params)
                n = OpNode(dx.op_type, params, name=src_node.name,
                           layer_guid=src_node.layer_guid,
                           initializers=src_node.initializers)
                n.weight_specs = list(src_node.weight_specs)
                wsrc = getattr(src_node, "weight_source", None)
                if wsrc:
                    n.weight_source = wsrc  # tied weights survive rewrites
            else:
                params = dx.make_params(m.ops) if dx.make_params else None
                n = OpNode(dx.op_type, params)
            new_g.add_node(n)
            dst_node[dx] = n

        def resolve(tx: TensorX) -> tuple[OpNode, int]:
            if tx.op is None:
                guid, idx = m.inputs[tx.idx]
                return clone[guid], idx
            if tx.op in dst_node:
                return dst_node[tx.op], tx.idx
            raise ValueError(f"dangling TensorX in xfer {self.name}")

        # wire dst-op inputs
        for dx in self.dst_ops:
            n = dst_node[dx]
            for dst_idx, tx in enumerate(dx.inputs):
                src_n, src_idx = resolve(tx)
                new_g.add_edge(src_n, n, src_idx, dst_idx)
        # wire edges among unmatched nodes + re-point mapped outputs
        mapped = {}
        for src_tx, dst_tx in self.mapped_outputs:
            node = m.ops[src_tx.op]
            mapped[(node.guid, src_tx.idx)] = resolve(dst_tx)
        for node in graph.topo_order():
            for e in graph.out_edges[node.guid]:
                if e.dst in matched:
                    continue
                if node.guid in matched:
                    src_n, src_idx = mapped[(e.src, e.src_idx)]
                else:
                    src_n, src_idx = clone[e.src], e.src_idx
                new_g.add_edge(src_n, clone[e.dst], src_idx, e.dst_idx)
        # carry node markers through the rewrite so compile (logits) and the
        # joint search's sequence splitter (boundary tokens) can find their
        # nodes after arbitrary rewrites
        for node in graph.topo_order():
            logits = getattr(node, "_is_logits", False)
            marks = getattr(node, "_markers", None)
            if not logits and not marks:
                continue
            if node.guid in matched:
                nn = mapped.get((node.guid, 0), (None, 0))[0]
            else:
                nn = clone[node.guid]
            if nn is None:
                continue
            if logits:
                nn._is_logits = True
            if marks:
                nn._markers = getattr(nn, "_markers", frozenset()) | marks
        propagate_parallel_state(new_g)
        # dst compute ops built fresh (no match_src, e.g. the fused Experts
        # node) declare their weights from the propagated input shapes; the
        # reference rebuilds operators from the rewritten PCG the same way
        # (model.cc:2830-2872)
        for dx, n in dst_node.items():
            if n.weight_specs or n.op_type in _PARALLEL:
                continue
            try:
                in_shapes = [pt.shape.logical_shape for pt in n.inputs]
                n.weight_specs = n.op_def.weights(n.params, in_shapes)
            except NotImplementedError:
                pass
        return new_g


def _clone_node(g: Graph, node: OpNode) -> OpNode:
    n = OpNode(node.op_type, node.params, name=node.name,
               layer_guid=node.layer_guid, initializers=node.initializers)
    n.weight_specs = list(node.weight_specs)
    n.weight_axes = dict(node.weight_axes)
    src = getattr(node, "weight_source", None)
    if src:
        n.weight_source = src  # tied weights survive rewrites by name
    if node.op_type == OT.OP_INPUT:
        # input nodes keep their ParallelTensor shape (degree-1 source)
        n.outputs = [ParallelTensor(pt.shape, name=pt.name)
                     for pt in node.outputs]
    g.add_node(n)
    return n


# ------------------------------------------------- parallel-state propagation

_PASSTHROUGH = frozenset({
    OT.OP_RELU, OT.OP_GELU, OT.OP_SIGMOID, OT.OP_TANH, OT.OP_ELU,
    OT.OP_IDENTITY, OT.OP_DROPOUT, OT.OP_SCALAR_MULTIPLY, OT.OP_SCALAR_ADD,
    OT.OP_SCALAR_SUB, OT.OP_SCALAR_TRUE_DIV, OT.OP_EXP, OT.OP_SIN, OT.OP_COS,
    OT.OP_RSQRT, OT.OP_POW, OT.OP_LAYERNORM, OT.OP_SOFTMAX, OT.OP_CAST,
})

# single source of truth for the parallel-op type set (also used by
# OpNode.is_parallel_op and UnitySearch.evaluate)
_PARALLEL = PARALLEL_OP_TYPES

# Ops that commute with summation: f(sum_i x_i) == sum_i f(x_i). Only these
# may pass a partial-sum replica dim (row-parallel Linear/MHA output)
# through unchanged; relu(partial sums) != partial(relu).
_LINEAR_SAFE = frozenset({
    OT.OP_IDENTITY, OT.OP_CAST, OT.OP_SCALAR_MULTIPLY,
    OT.OP_SCALAR_TRUE_DIV,
})


def propagate_parallel_state(graph: Graph):
    """Re-derive every tensor's ParallelDim degrees and every compute op's
    implied weight shardings from the graph's explicit parallel ops — the
    solve_parallel_dim_mappings analog (reference operator.cc /
    ParallelDimMappingRecord). Raises ValueError on inconsistent state,
    including a partial-sum replica dim flowing through a nonlinear op
    (such a candidate would be mathematically invalid)."""
    # (guid, out_idx) -> True when the tensor's replica dim holds PARTIAL
    # SUMS (row-parallel Linear / head-parallel MHA output) rather than
    # identical copies (Replicate output)
    partial: dict[tuple[int, int], bool] = {}
    for node in graph.topo_order():
        if node.op_type == OT.OP_INPUT:
            if not node.outputs:
                raise ValueError(f"input node {node.name} has no tensor")
            node.inputs = []
            continue
        in_pts: list[ParallelTensor] = []
        in_edges = sorted(graph.in_edges[node.guid], key=lambda e: e.dst_idx)
        for e in in_edges:
            in_pts.append(graph.nodes[e.src].outputs[e.src_idx])
        node.inputs = in_pts
        in_partial = [partial.get((e.src, e.src_idx), False)
                      for e in in_edges]
        in_shapes = [pt.shape for pt in in_pts]
        weight_partition: dict[str, tuple[int, int]] = {}
        out_partial = False

        if node.op_type in _PARALLEL:
            out_shapes = [apply_parallel_op_shape(
                in_shapes[0], node.op_type, node.params)]
            # Reduction consumes partial sums; the others re-place values.
            # A FusedParallelOp is checked per sub-op so a fused Reduction
            # can't bypass the identical-replica check.
            sub_types = ([i.op_type for i in node.params.ops]
                         if node.op_type == OT.OP_FUSED_PARALLEL
                         else [node.op_type])
            cur = in_partial[0] if in_partial else False
            for st in sub_types:
                if st == OT.OP_REDUCTION:
                    if not cur:
                        raise ValueError(
                            f"{node.name}: Reduction over identical "
                            f"replicas would multiply values by the degree")
                    cur = False
            out_partial = cur
        elif node.op_type == OT.OP_LINEAR:
            if any(in_partial):
                raise ValueError(
                    f"{node.name}: Linear consuming a partial-sum tensor "
                    f"is unsupported (bias would be added per replica)")
            out_shapes = [_linear_parallel(node, in_shapes[0],
                                           weight_partition)]
            out_partial = any(d.is_replica_dim for d in out_shapes[0].dims)
        elif node.op_type == OT.OP_MULTIHEAD_ATTENTION:
            if any(in_partial):
                raise ValueError(
                    f"{node.name}: attention over partial sums is invalid "
                    f"(softmax is nonlinear)")
            out_shapes = [_attention_parallel(node, in_shapes,
                                              weight_partition)]
            out_partial = any(d.is_replica_dim for d in out_shapes[0].dims)
        elif node.op_type == OT.OP_CONV2D:
            if any(in_partial):
                raise ValueError(
                    f"{node.name}: Conv2D consuming a partial-sum tensor "
                    f"is unsupported (bias/activation per replica)")
            out_shapes = [_conv_parallel(node, in_shapes[0],
                                         weight_partition)]
            out_partial = any(d.is_replica_dim for d in out_shapes[0].dims)
        elif node.op_type == OT.OP_EMBEDDING:
            if any(in_partial):
                raise ValueError(
                    f"{node.name}: embedding lookup over partial-sum "
                    f"indices is meaningless")
            out_shapes = [_embedding_parallel(node, in_shapes[0],
                                              weight_partition)]
        elif node.op_type in _PASSTHROUGH:
            if in_partial and in_partial[0] and \
                    node.op_type not in _LINEAR_SAFE:
                raise ValueError(
                    f"{node.name} ({node.op_type.name}) is nonlinear and "
                    f"cannot consume a partial-sum replica dim: "
                    f"f(sum x_i) != sum f(x_i)")
            if node.op_type == OT.OP_CAST:
                # a cast changes the VALUE dtype: the IR must carry the
                # target dtype or the ffrules/ffsan dtype-transfer checks
                # would see the stale input dtype
                out_shapes = [ParallelTensorShape(in_shapes[0].dims,
                                                  node.params.dtype)]
            else:
                out_shapes = [in_shapes[0]]
            out_partial = in_partial[0] if in_partial else False
        elif node.op_type in (OT.OP_EW_ADD, OT.OP_EW_SUB, OT.OP_EW_MUL,
                              OT.OP_EW_DIV, OT.OP_EW_MAX, OT.OP_EW_MIN):
            if in_shapes[0].dims != in_shapes[1].dims:
                raise ValueError(
                    f"{node.name}: element-binary operands have different "
                    f"parallel shapes {in_shapes[0]} vs {in_shapes[1]}")
            if any(in_partial):
                # add/sub of two partials distributes over the sum; any
                # other combination (mixed partial/full, nonlinear binop)
                # does not
                if not (all(in_partial) and node.op_type in
                        (OT.OP_EW_ADD, OT.OP_EW_SUB)):
                    raise ValueError(
                        f"{node.name} ({node.op_type.name}): invalid "
                        f"combination of partial-sum operands")
                out_partial = True
            out_shapes = [in_shapes[0]]
        else:
            # generic op: forbid replica dims, propagate positional degrees
            # where the op's inferred output rank matches the input rank,
            # else require unsharded inputs
            for s in in_shapes:
                if s.num_replica_dims:
                    raise ValueError(
                        f"{node.name} ({node.op_type.name}) cannot consume a "
                        f"replicated tensor")
            logical_in = [s.logical_shape for s in in_shapes]
            inferred = node.op_def.infer_shapes(node.params, logical_in)
            out_shapes = []
            for shp in inferred:
                if (in_shapes and len(shp) == len(logical_in[0])
                        and all(d.degree == 1
                                for d in in_shapes[0].dims[1:])):
                    dims = [ParallelDim(shp[0],
                                        in_shapes[0].dims[0].degree,
                                        axes=in_shapes[0].dims[0].axes)]
                    dims += [ParallelDim(s) for s in shp[1:]]
                elif all(d.degree == 1 for s in in_shapes for d in s.dims):
                    dims = [ParallelDim(s) for s in shp]
                else:
                    raise ValueError(
                        f"{node.name} ({node.op_type.name}): unsupported "
                        f"parallel inputs {in_shapes}")
                out_shapes.append(
                    ParallelTensorShape(tuple(dims), in_shapes[0].dtype))

        old = node.outputs
        node.outputs = []
        for i, shape in enumerate(out_shapes):
            name = old[i].name if i < len(old) else f"{node.name}_out{i}"
            pt = ParallelTensor(shape, name=name)
            pt.owner_op, pt.owner_idx = node, i
            node.outputs.append(pt)
            partial[(node.guid, i)] = out_partial
        node._weight_partition = weight_partition


def _linear_parallel(node, in_shape: ParallelTensorShape, wp: dict):
    """Linear under parallel input state (reference linear.cc dim mappings):
    - batch-dim degrees propagate;
    - input replica dim (degree r) → kernel out-dim sharded r, output
      feature dim sharded r, replica dim consumed  [column TP];
    - input feature dim sharded (degree c) → kernel in-dim sharded c, output
      gains a replica dim of degree c (partial sums)  [row TP]."""
    dims = in_shape.dims
    logical = [d for d in dims if not d.is_replica_dim]
    replicas = [d for d in dims if d.is_replica_dim]
    if len(replicas) > 1:
        raise ValueError(f"{node.name}: multiple replica dims unsupported")
    r = replicas[0].degree if replicas else 1
    feat_deg = logical[-1].degree
    if r > 1 and feat_deg > 1:
        raise ValueError(
            f"{node.name}: simultaneous replicate + feature partition "
            f"unsupported")
    out_ch = node.params.out_channels
    out_dims = [replace(d) for d in logical[:-1]]
    if r > 1:
        if out_ch % r != 0:
            raise ValueError(f"{node.name}: out_channels {out_ch} % {r} != 0")
        out_dims.append(ParallelDim(out_ch, r, axes=replicas[0].axes))
        wp["kernel"] = (1, r)
        if node.params.use_bias:
            wp["bias"] = (0, r)
    else:
        out_dims.append(ParallelDim(out_ch))
    if feat_deg > 1:
        wp["kernel"] = (0, feat_deg)
        out_dims.append(ParallelDim(feat_deg, feat_deg, is_replica_dim=True,
                                    axes=logical[-1].axes))
    return ParallelTensorShape(tuple(out_dims), in_shape.dtype)


def _conv_parallel(node, in_shape: ParallelTensorShape, wp: dict):
    """Conv2D (NCHW / OIHW) under parallel input state (reference
    conv_2d.cc dim mappings):
    - sample-dim degrees propagate;
    - input replica dim (degree r) → kernel out-channel dim (O) sharded r,
      output channel dim sharded r, replica consumed  [channel TP];
    - input channel dim sharded (degree c, groups == 1) → kernel in-channel
      dim (I) sharded c, output gains a replica dim of degree c (partial
      sums)  [row-style]."""
    dims = in_shape.dims
    logical = [d for d in dims if not d.is_replica_dim]
    replicas = [d for d in dims if d.is_replica_dim]
    if len(replicas) > 1:
        raise ValueError(f"{node.name}: multiple replica dims unsupported")
    if any(d.degree > 1 for d in logical[2:]):
        raise ValueError(
            f"{node.name}: spatially-sharded conv input unsupported")
    r = replicas[0].degree if replicas else 1
    chan_deg = logical[1].degree
    if r > 1 and chan_deg > 1:
        raise ValueError(
            f"{node.name}: simultaneous replicate + channel partition "
            f"unsupported")
    p = node.params
    out_logical = node.op_def.infer_shapes(
        p, [tuple(d.size for d in logical)])[0]
    out_dims = [replace(logical[0])]
    if r > 1:
        if p.out_channels % r != 0:
            raise ValueError(
                f"{node.name}: out_channels {p.out_channels} % {r} != 0")
        out_dims.append(ParallelDim(p.out_channels, r, axes=replicas[0].axes))
        wp["kernel"] = (0, r)
        if p.use_bias:
            wp["bias"] = (0, r)
    else:
        out_dims.append(ParallelDim(p.out_channels))
    out_dims += [ParallelDim(s) for s in out_logical[2:]]
    if chan_deg > 1:
        if p.groups != 1:
            raise ValueError(
                f"{node.name}: channel-sharded grouped conv unsupported")
        wp["kernel"] = (1, chan_deg)
        out_dims.append(ParallelDim(chan_deg, chan_deg, is_replica_dim=True,
                                    axes=logical[1].axes))
    return ParallelTensorShape(tuple(out_dims), in_shape.dtype)


def _embedding_parallel(node, in_shape: ParallelTensorShape, wp: dict):
    """Embedding under parallel input state (reference embedding.cc:
    partitionable on the sample dim or — via a replicated input — on the
    output-channel dim):
    - sample-dim degrees propagate through the lookup;
    - input replica dim (degree r) → table sharded on the embedding dim,
      output feature dim sharded r, replica consumed (each chip gathers its
      column slice — full value, no partial sums)."""
    from ..fftype import AggrMode

    dims = in_shape.dims
    logical = [d for d in dims if not d.is_replica_dim]
    replicas = [d for d in dims if d.is_replica_dim]
    if len(replicas) > 1:
        raise ValueError(f"{node.name}: multiple replica dims unsupported")
    if any(d.degree > 1 for d in logical[1:]):
        raise ValueError(
            f"{node.name}: entry-dim-sharded embedding input unsupported")
    r = replicas[0].degree if replicas else 1
    p = node.params
    if p.aggr == AggrMode.AGGR_MODE_NONE:
        out_dims = [replace(d) for d in logical]
    else:
        out_dims = [replace(d) for d in logical[:-1]]
    if r > 1:
        if p.out_channels % r != 0:
            raise ValueError(
                f"{node.name}: out_channels {p.out_channels} % {r} != 0")
        out_dims.append(ParallelDim(p.out_channels, r, axes=replicas[0].axes))
        wp["kernel"] = (1, r)
    else:
        out_dims.append(ParallelDim(p.out_channels))
    # lookups emit the table dtype, not the integer index dtype
    return ParallelTensorShape(tuple(out_dims), p.data_type)


def _attention_parallel(node, in_shapes, wp: dict):
    """MHA under replicated input (reference replicate_attention_reduce):
    input replica degree r → q/k/v projections sharded on heads (out dim),
    out-projection row-sharded, output gains a replica dim of degree r
    (partial sums consumed by a Reduction node)."""
    q = in_shapes[0]
    replicas = [d for d in q.dims if d.is_replica_dim]
    r = replicas[0].degree if replicas else 1
    logical = [d for d in q.dims if not d.is_replica_dim]
    if any(d.degree > 1 for d in logical[1:]):
        raise ValueError(f"{node.name}: feature-sharded attention input "
                         f"unsupported")
    out_dims = [replace(d) for d in logical[:-1]]
    out_dims.append(ParallelDim(node.params.embed_dim))
    if r > 1:
        if node.params.num_heads % r != 0:
            raise ValueError(
                f"{node.name}: num_heads {node.params.num_heads} % {r} != 0")
        for w in ("wq", "wk", "wv"):
            wp[w] = (1, r)
        for b in ("bq", "bk", "bv"):
            wp[b] = (0, r)
        wp["wo"] = (0, r)
        out_dims.append(ParallelDim(r, r, is_replica_dim=True,
                                    axes=replicas[0].axes))
    return ParallelTensorShape(tuple(out_dims), q.dtype)


# ---------------------------------------------------------- axis assignment

def assign_axes_from_degrees(graph: Graph, mesh):
    """Map every tensor's ParallelDim degrees to mesh axes and emit weight
    PartitionSpecs — the FFMapper analog for rewritten graphs. Dims whose
    rewrite declared its mesh axes (ParallelDim.axes, threaded from the
    parallel-op params) use them verbatim — including composite multi-axis
    degrees; legacy degree-only dims fall back to size inference (batch
    degrees ride `data`, feature/replica degrees ride `model`). Unsharded
    tensors get the default data-parallel batch sharding
    (graph.cc:1939-1964 fallback)."""
    sizes = dict(mesh.shape)
    data_deg = sizes.get(AXIS_DATA, 1)
    model_deg = sizes.get(AXIS_MODEL, 1)

    def axes_for(dim_idx: int, degree: int, axes=()) -> tuple:
        if axes:
            prod = 1
            for a in axes:
                prod *= sizes.get(a, 1)
            if prod != degree:
                raise ValueError(
                    f"declared axes {axes} (product {prod}) do not carry "
                    f"degree {degree} on mesh {sizes}")
            return tuple(axes)
        if dim_idx == 0 and degree == data_deg:
            return (AXIS_DATA,)
        if degree == model_deg:
            return (AXIS_MODEL,)
        if degree == data_deg:
            return (AXIS_DATA,)
        raise ValueError(
            f"degree {degree} matches no mesh axis in {sizes}")

    def wp_axes(node, degree) -> tuple:
        # a weight partition's degree originates from the Replicate's
        # replica dim (column TP) or a sharded NON-BATCH logical dim
        # (row TP feature / conv channel). The batch dim can carry the
        # same degree on different axes (dp×tp), so it must never source
        # a weight partition's axes — match replica dims first, then
        # non-batch logical dims only.
        for pt in node.inputs:
            for d in pt.shape.dims:
                if d.is_replica_dim and d.degree == degree and d.axes:
                    return d.axes
        for pt in node.inputs:
            logical_idx = -1
            for d in pt.shape.dims:
                if d.is_replica_dim:
                    continue
                logical_idx += 1
                if logical_idx == 0:
                    continue
                if d.degree == degree and d.axes:
                    return d.axes
        return ()

    for node in graph.topo_order():
        for pt in node.outputs:
            assignment = []
            used_axes: set = set()
            logical_idx = 0
            for d in pt.shape.dims:
                if d.is_replica_dim:
                    assignment.append(())
                    continue
                if d.degree > 1:
                    entry = axes_for(logical_idx, d.degree, d.axes)
                    dup = used_axes.intersection(entry)
                    if dup or len(set(entry)) != len(entry):
                        # a mesh axis can shard at most one dim once — a
                        # nested same-axis rewrite must be pruned at
                        # costing, not handed to the executor
                        raise ValueError(
                            f"{node.name}: mesh axes used twice in one "
                            f"tensor assignment ({entry}, already used "
                            f"{sorted(used_axes)})")
                    used_axes.update(entry)
                    assignment.append(entry)
                elif (logical_idx == 0 and data_deg > 1
                      and d.size % data_deg == 0
                      and not is_expert_buffer(node)):
                    # default data-parallel batch sharding composes with the
                    # rewrite-derived feature/replica shardings (dp x tp)
                    assignment.append((AXIS_DATA,))
                else:
                    assignment.append(())
                logical_idx += 1
            pt.assign_axes(tuple(assignment))
        wp = getattr(node, "_weight_partition", None)
        if wp:
            for wname, (dim_idx, degree) in wp.items():
                ws = next((w for w in node.weight_specs if w.name == wname),
                          None)
                if ws is None:
                    continue
                entries = [None] * len(ws.shape)
                axes = axes_for(-1, degree, wp_axes(node, degree))
                entries[dim_idx] = axes if len(axes) > 1 else axes[0]
                node.weight_axes[wname] = PartitionSpec(*entries)


# ------------------------------------------------------------- graph costing

def evaluate_assigned_graph(graph: Graph, mesh, cm: CostModel,
                            overlap_sync: bool = False,
                            totals: dict | None = None
                            ) -> tuple[float, float]:
    """(time, per-chip memory) of a PCG on its ALREADY-materialized
    assignments — no re-derivation, so it is safe on a compiled model
    whose strategy was applied by `_assign_strategy` (the
    weight-update-sharding decision prices the live graph through here).
    Compute ops go through the cost model on their emitted assignments;
    parallel ops are priced as the collectives they lower to. Total time
    is the task-graph makespan. When the cost model prices a ZeRO-sharded
    update (cm.update_sharding + cm.overlap_update), the grad RS+AG rides
    the overlappable channel — max(compute, comm) + hop latency — exactly
    as UnitySearch.evaluate prices it; under stage 3 (cm.param_gather)
    the just-in-time weight-gather pair joins it via price_param_gather
    and the per-chip memory charges weights at 1/shards plus at most two
    gathered layers in flight. `totals`, when a dict, additionally
    accumulates the summed grad-sync seconds under "sync_s" (the
    update-sharding decision reads the sync fraction off it) and the
    summed gather seconds under "param_gather_s"."""
    from .cost_model import (
        _MakespanAccum, price_grad_sync, price_param_gather,
    )

    acc = _MakespanAccum(overlap_sync=overlap_sync)
    mem = 0.0
    gather_peak = 0.0
    machine = cm.machine
    for node in graph.topo_order():
        if node.op_type in (OT.OP_INPUT, UOT.OP_WEIGHT, UOT.OP_NOOP):
            continue
        if node.op_type in _PARALLEL:
            comm, comm_axes = price_parallel_node(node, machine)
            acc.add(node.guid, 0.0, comm, comm_axes=comm_axes)
            continue
        in_shapes, in_assigns = [], []
        for pt in node.inputs:
            in_shapes.append(pt.shape.logical_shape)
            in_assigns.append(_logical_assignment(pt))
        cmx = cm.op_cost(
            node, [_logical_assignment(pt) for pt in node.outputs],
            dict(node.weight_axes), in_shapes, in_assigns)
        grad_sync = cmx.sync_time + cmx.update_sync_time
        if totals is not None:
            totals["sync_s"] = totals.get("sync_s", 0.0) + grad_sync
            totals["param_gather_s"] = (totals.get("param_gather_s", 0.0)
                                        + cmx.param_gather_time)
        # the shared update-mode pricing rules (cost_model.price_grad_sync
        # / price_param_gather — the same rules UnitySearch.evaluate
        # applies, so the decision made through here matches the reported
        # makespan)
        sync, overlap_comm, overlap_overhead, _ = price_grad_sync(
            cmx, cm.update_sharding, getattr(cm, "overlap_update", False))
        pg_serial, pg_overlap, pg_overhead, _ = price_param_gather(
            cmx, getattr(cm, "overlap_update", False))
        acc.add(node.guid, cmx.forward_time + cmx.backward_time,
                cmx.comm_time + pg_serial, sync=sync,
                comm_axes=(AXIS_DATA,)
                if grad_sync > 0 or cmx.param_gather_time > 0 else (),
                overlappable_comm=overlap_comm + pg_overlap,
                overlap_overhead=overlap_overhead + pg_overhead)
        mem += cmx.memory
        gather_peak = max(gather_peak, cmx.gather_bytes)
    mem += 2.0 * gather_peak
    return acc.makespan(graph.in_edges), mem


def evaluate_graph(graph: Graph, mesh, cm: CostModel,
                   overlap_sync: bool = False) -> tuple[float, float]:
    """(time, per-chip memory) of a rewritten PCG: materialize the
    rewrite's degree-derived assignments first (assign_axes_from_degrees
    — the FFMapper analog), then price via evaluate_assigned_graph."""
    assign_axes_from_degrees(graph, mesh)
    return evaluate_assigned_graph(graph, mesh, cm,
                                   overlap_sync=overlap_sync)


def _logical_assignment(pt: ParallelTensor):
    return tuple(a for d, a in zip(pt.shape.dims, pt.axis_assignment)
                 if not d.is_replica_dim)


# ------------------------------------------------------------ rule generators

def _lin_act(act):
    return lambda n: n.params.activation == act


def _axes_tag(axes) -> str:
    return f",axes={'x'.join(axes)}" if axes else ""


def create_partition_linear_combine(degree: int, activation,
                                    axes: tuple = ()) -> GraphXfer:
    """Repartition(sample) → Linear → Combine(sample)
    (substitution.cc:3041). `axes` optionally binds the split to named
    mesh axes (possibly composite, e.g. ('data', 'seq'))."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_linear_combine[deg={degree},"
                  f"act={activation}{_axes_tag(axes)}]")
    inp = x.new_input(0)
    lin1 = OpX(OT.OP_LINEAR, (inp,), constraints=(_lin_act(activation),))
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, degree, axes))
    lin2 = OpX(OT.OP_LINEAR, (rep.outputs[0],), match_src=lin1)
    comb = OpX(OT.OP_COMBINE, (lin2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [lin1]
    x.dst_ops = [rep, lin2, comb]
    x.map_output(lin1.outputs[0], comb.outputs[0])
    return x


def create_replicate_linear_combine(degree: int, activation,
                                    axes: tuple = ()) -> GraphXfer:
    """Replicate → Linear(kernel out-dim sharded) → Combine(feature): column
    tensor parallelism (substitution.cc:3226)."""
    axes = tuple(axes)
    x = GraphXfer(f"replicate_linear_combine[deg={degree},"
                  f"act={activation}{_axes_tag(axes)}]")
    inp = x.new_input(0)
    lin1 = OpX(OT.OP_LINEAR, (inp,), constraints=(_lin_act(activation),))
    repl = OpX(OT.OP_REPLICATE, (inp,),
               make_params=lambda m: ReplicateParams(degree, axes))
    lin2 = OpX(OT.OP_LINEAR, (repl.outputs[0],), match_src=lin1)

    def combine_feature(m):
        lin = m[lin1]
        ndim = len(lin.outputs[0].shape.logical_shape)
        return CombineParams(ndim - 1, degree, axes)

    comb = OpX(OT.OP_COMBINE, (lin2.outputs[0],),
               make_params=combine_feature)
    x.src_ops = [lin1]
    x.dst_ops = [repl, lin2, comb]
    x.map_output(lin1.outputs[0], comb.outputs[0])
    return x


def create_replicate_attention_reduce(degree: int,
                                      axes: tuple = ()) -> GraphXfer:
    """Replicate → MHA(heads sharded, row-parallel out-proj) → Reduction:
    inserts an explicit Reduction node consuming the partial-sum replica dim
    (substitution.cc create_replicate_attention_reduce)."""
    axes = tuple(axes)
    x = GraphXfer(f"replicate_attention_reduce[deg={degree}"
                  f"{_axes_tag(axes)}]")
    inp = x.new_input(0)
    attn1 = OpX(
        OT.OP_MULTIHEAD_ATTENTION, (inp, inp, inp),
        constraints=(lambda n: n.params.num_heads % degree == 0,),
    )
    repl = OpX(OT.OP_REPLICATE, (inp,),
               make_params=lambda m: ReplicateParams(degree, axes))
    r0 = repl.outputs[0]
    attn2 = OpX(OT.OP_MULTIHEAD_ATTENTION, (r0, r0, r0), match_src=attn1)
    red = OpX(OT.OP_REDUCTION, (attn2.outputs[0],),
              make_params=lambda m: ReductionParams(degree, axes))
    x.src_ops = [attn1]
    x.dst_ops = [repl, attn2, red]
    x.map_output(attn1.outputs[0], red.outputs[0])
    return x


def create_partition_attention_combine(degree: int,
                                       axes: tuple = ()) -> GraphXfer:
    """Repartition(sample) → MHA → Combine(sample)
    (substitution.cc create_partition_attention_combine)."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_attention_combine[deg={degree}"
                  f"{_axes_tag(axes)}]")
    inp = x.new_input(0)
    attn1 = OpX(OT.OP_MULTIHEAD_ATTENTION, (inp, inp, inp))
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, degree, axes))
    r0 = rep.outputs[0]
    attn2 = OpX(OT.OP_MULTIHEAD_ATTENTION, (r0, r0, r0), match_src=attn1)
    comb = OpX(OT.OP_COMBINE, (attn2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [attn1]
    x.dst_ops = [rep, attn2, comb]
    x.map_output(attn1.outputs[0], comb.outputs[0])
    return x


def create_partition_add_combine(degree: int, axes: tuple = ()) -> GraphXfer:
    """Repartition both addends on sample, add, Combine back
    (substitution.cc:3257)."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_add_combine[deg={degree}{_axes_tag(axes)}]")
    a, b = x.new_input(0), x.new_input(1)
    add1 = OpX(OT.OP_EW_ADD, (a, b))
    rep1 = OpX(OT.OP_REPARTITION, (a,),
               make_params=lambda m: RepartitionParams(0, degree, axes))
    rep2 = OpX(OT.OP_REPARTITION, (b,),
               make_params=lambda m: RepartitionParams(0, degree, axes))
    # match_src is load-bearing: without it the rewritten add carries
    # params=None and the executor's _binary_forward crashes at runtime
    # (caught by the ffrules semantic oracle)
    add2 = OpX(OT.OP_EW_ADD, (rep1.outputs[0], rep2.outputs[0]),
               match_src=add1)
    comb = OpX(OT.OP_COMBINE, (add2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [add1]
    x.dst_ops = [rep1, rep2, add2, comb]
    x.map_output(add1.outputs[0], comb.outputs[0])
    return x


def _passthrough_partition(op_type: OT, degree: int, tag: str,
                           axes: tuple = ()) -> GraphXfer:
    axes = tuple(axes)
    x = GraphXfer(f"partition_{tag}_combine[deg={degree}{_axes_tag(axes)}]")
    inp = x.new_input(0)
    op1 = OpX(op_type, (inp,))
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, degree, axes))
    op2 = OpX(op_type, (rep.outputs[0],), match_src=op1)
    comb = OpX(OT.OP_COMBINE, (op2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [op1]
    x.dst_ops = [rep, op2, comb]
    x.map_output(op1.outputs[0], comb.outputs[0])
    return x


def create_partition_relu_combine(degree: int, axes: tuple = ()) -> GraphXfer:
    return _passthrough_partition(OT.OP_RELU, degree, "relu", axes)


def create_partition_softmax_combine(degree: int,
                                     axes: tuple = ()) -> GraphXfer:
    return _passthrough_partition(OT.OP_SOFTMAX, degree, "softmax", axes)


def create_partition_conv2d_combine(degree: int,
                                    axes: tuple = ()) -> GraphXfer:
    """Repartition(sample) → Conv2D → Combine(sample)
    (substitution.cc create_partition_conv2d_combine)."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_conv2d_combine[deg={degree}{_axes_tag(axes)}]")
    inp = x.new_input(0)
    c1 = OpX(OT.OP_CONV2D, (inp,))
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, degree, axes))
    c2 = OpX(OT.OP_CONV2D, (rep.outputs[0],), match_src=c1)
    comb = OpX(OT.OP_COMBINE, (c2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [c1]
    x.dst_ops = [rep, c2, comb]
    x.map_output(c1.outputs[0], comb.outputs[0])
    return x


def create_replicate_conv2d_combine(degree: int,
                                    axes: tuple = ()) -> GraphXfer:
    """Replicate → Conv2D(out-channel-sharded kernel) → Combine(channel):
    the channel/attribute-parallel conv rewrite (substitution.cc
    create_partition_attention_combine's conv sibling)."""
    axes = tuple(axes)
    x = GraphXfer(f"replicate_conv2d_combine[deg={degree}{_axes_tag(axes)}]")
    inp = x.new_input(0)
    c1 = OpX(OT.OP_CONV2D, (inp,),
             constraints=(lambda n: n.params.out_channels % degree == 0,))
    repl = OpX(OT.OP_REPLICATE, (inp,),
               make_params=lambda m: ReplicateParams(degree, axes))
    c2 = OpX(OT.OP_CONV2D, (repl.outputs[0],), match_src=c1)
    comb = OpX(OT.OP_COMBINE, (c2.outputs[0],),
               make_params=lambda m: CombineParams(1, degree, axes))
    x.src_ops = [c1]
    x.dst_ops = [repl, c2, comb]
    x.map_output(c1.outputs[0], comb.outputs[0])
    return x


def create_partition_pool2d_combine(degree: int,
                                    axes: tuple = ()) -> GraphXfer:
    return _passthrough_partition(OT.OP_POOL2D, degree, "pool2d", axes)


def create_partition_concat_combine(degree: int,
                                    axes: tuple = ()) -> GraphXfer:
    """Repartition both concat operands on sample, concat, Combine back —
    the 2-ary instance (substitution.cc create_partition_concat_combine;
    the reference generates per num_inputs too)."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_concat_combine[deg={degree}{_axes_tag(axes)}]")
    a, b = x.new_input(0), x.new_input(1)
    # arity constraint is load-bearing: the matcher only checks the node has
    # AT LEAST as many inputs as the pattern, so without it a 3-input
    # concat would match and the rewrite would silently drop operands
    cat1 = OpX(OT.OP_CONCAT, (a, b),
               constraints=(lambda n: n.params.axis != 0,
                            lambda n: n.params.n == 2,))
    rep1 = OpX(OT.OP_REPARTITION, (a,),
               make_params=lambda m: RepartitionParams(0, degree, axes))
    rep2 = OpX(OT.OP_REPARTITION, (b,),
               make_params=lambda m: RepartitionParams(0, degree, axes))
    cat2 = OpX(OT.OP_CONCAT, (rep1.outputs[0], rep2.outputs[0]),
               match_src=cat1)
    comb = OpX(OT.OP_COMBINE, (cat2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [cat1]
    x.dst_ops = [rep1, rep2, cat2, comb]
    x.map_output(cat1.outputs[0], comb.outputs[0])
    return x


def create_partition_embedding_combine(degree: int,
                                       axes: tuple = ()) -> GraphXfer:
    """Repartition(sample) → Embedding → Combine(sample)
    (embedding.cc is partitionable on the sample dim)."""
    axes = tuple(axes)
    x = GraphXfer(f"partition_embedding_combine[deg={degree}"
                  f"{_axes_tag(axes)}]")
    inp = x.new_input(0)
    e1 = OpX(OT.OP_EMBEDDING, (inp,))
    rep = OpX(OT.OP_REPARTITION, (inp,),
              make_params=lambda m: RepartitionParams(0, degree, axes))
    e2 = OpX(OT.OP_EMBEDDING, (rep.outputs[0],), match_src=e1)
    comb = OpX(OT.OP_COMBINE, (e2.outputs[0],),
               make_params=lambda m: CombineParams(0, degree, axes))
    x.src_ops = [e1]
    x.dst_ops = [rep, e2, comb]
    x.map_output(e1.outputs[0], comb.outputs[0])
    return x


def create_fuse_moe_trio(n: int) -> GraphXfer:
    """Fuse the reference-parity unfused MoE trio — Group_by → n per-expert
    Dense → Aggregate (src/ops/moe.cc:20-50) — into the single stacked
    Experts op, whose (n, d, h) kernel shards over the expert/model mesh
    axis (UnitySearch's "ep" config). This is how expert parallelism
    reaches models built through the unfused API: the reference gives the
    trio attribute-parallel machine views (examples/cpp/mixture_of_experts);
    here the capability is delivered by this rewrite + a sharding.

    Expert weights are re-initialized by the rewrite (the reference also
    rebuilds operators from the optimized PCG at compile, model.cc:2830+).
    """
    from ..ops.moe import ExpertsParams

    x = GraphXfer(f"fuse_moe_trio[n={n}]")
    data = x.new_input(0)
    values = x.new_input(1)
    assign = x.new_input(2)
    probs = x.new_input(3)

    gb = OpX(OT.OP_GROUP_BY, (data, assign), num_outputs=n,
             constraints=(lambda node: node.params.n == n,))
    linears = [
        OpX(OT.OP_LINEAR, (TensorX(gb, i),),
            constraints=(lambda node: node.params.use_bias,))
        for i in range(n)
    ]
    agg = OpX(OT.OP_AGGREGATE, tuple(
        [values, assign, assign, probs] + [l.outputs[0] for l in linears]))

    def experts_params(m):
        gbp = m[gb].params
        aggp = m[agg].params
        lps = [m[l].params for l in linears]
        hidden = lps[0].out_channels
        act = lps[0].activation
        if any(p.out_channels != hidden or p.activation != act
               for p in lps):
            raise ValueError("fuse_moe_trio: experts disagree on shape/act")
        act_name = {ActiMode.AC_MODE_RELU: "relu",
                    ActiMode.AC_MODE_GELU: "gelu",
                    ActiMode.AC_MODE_NONE: "none"}.get(act)
        if act_name is None:
            raise ValueError(f"fuse_moe_trio: unsupported activation {act}")
        return ExpertsParams(n, hidden, gbp.alpha, aggp.lambda_bal,
                             use_bias=True, activation=act_name)

    experts = OpX(OT.OP_EXPERTS, (data, values, assign),
                  make_params=experts_params)
    x.src_ops = [gb] + linears + [agg]
    x.dst_ops = [experts]
    x.map_output(agg.outputs[0], experts.outputs[0])
    return x


def create_linear_relu_merge() -> GraphXfer:
    """Fuse Linear(no act) + ReLU into Linear(relu) — the algebraic (non-
    parallel) substitution family (substitution.cc create_linear_relu_merge).
    """
    x = GraphXfer("linear_relu_merge")
    inp = x.new_input(0)
    lin = OpX(OT.OP_LINEAR, (inp,),
              constraints=(_lin_act(ActiMode.AC_MODE_NONE),))
    relu = OpX(OT.OP_RELU, (lin.outputs[0],))

    def fused_params(m):
        return replace(m[lin].params, activation=ActiMode.AC_MODE_RELU)

    fused = OpX(OT.OP_LINEAR, (inp,), match_src=lin,
                make_params=fused_params)
    x.src_ops = [lin, relu]
    x.dst_ops = [fused]
    x.map_output(relu.outputs[0], fused.outputs[0])
    return x


def _axes_kw(kw):
    return tuple(kw.get("axes", ()))


_GENERATORS = {
    "partition_linear_combine":
        lambda deg, **kw: create_partition_linear_combine(
            deg, kw.get("activation", ActiMode.AC_MODE_NONE), _axes_kw(kw)),
    "replicate_linear_combine":
        lambda deg, **kw: create_replicate_linear_combine(
            deg, kw.get("activation", ActiMode.AC_MODE_NONE), _axes_kw(kw)),
    "replicate_attention_reduce":
        lambda deg, **kw: create_replicate_attention_reduce(deg, _axes_kw(kw)),
    "partition_attention_combine":
        lambda deg, **kw: create_partition_attention_combine(deg, _axes_kw(kw)),
    "partition_add_combine":
        lambda deg, **kw: create_partition_add_combine(deg, _axes_kw(kw)),
    "partition_relu_combine":
        lambda deg, **kw: create_partition_relu_combine(deg, _axes_kw(kw)),
    "partition_softmax_combine":
        lambda deg, **kw: create_partition_softmax_combine(deg, _axes_kw(kw)),
    "partition_conv2d_combine":
        lambda deg, **kw: create_partition_conv2d_combine(deg, _axes_kw(kw)),
    "replicate_conv2d_combine":
        lambda deg, **kw: create_replicate_conv2d_combine(deg, _axes_kw(kw)),
    "partition_pool2d_combine":
        lambda deg, **kw: create_partition_pool2d_combine(deg, _axes_kw(kw)),
    "partition_concat_combine":
        lambda deg, **kw: create_partition_concat_combine(deg, _axes_kw(kw)),
    "partition_embedding_combine":
        lambda deg, **kw: create_partition_embedding_combine(deg, _axes_kw(kw)),
    "linear_relu_merge": lambda deg, **kw: create_linear_relu_merge(),
    "fuse_moe_trio": lambda deg, **kw: create_fuse_moe_trio(
        int(kw.get("n", deg))),
}


def generate_all_pcg_xfers(mesh, config, graph: Optional[Graph] = None
                           ) -> list[GraphXfer]:
    """The rule set for a mesh (generate_all_pcg_xfers,
    substitution.cc:1726-1868): one instance of each family per EXPRESSIBLE
    parallel degree, where the mesh's single ICI axes and composite axis
    pairs play the role of the reference's per-degree loops. On a mesh the
    expressible degrees are exactly products of whole named axes (a dim
    shards over whole axes); sub-axis degrees — a degree-2 split on an
    8-wide axis — are reached by re-factorizing the mesh itself
    (search/mesh_search.py), not by a rewrite. Each instance carries its
    axes on the parallel-op params, so assignment and pricing never infer
    an axis from a degree. When the graph is given, data-driven families
    are added too (one fuse_moe_trio per distinct Group_by expert count)."""
    from ..machine import AXIS_SEQ

    xfers: list[GraphXfer] = [create_linear_relu_merge()]
    if graph is not None:
        seen_n = set()
        for node in graph.topo_order():
            if node.op_type == OT.OP_GROUP_BY and node.params.n not in seen_n:
                seen_n.add(node.params.n)
                xfers.append(create_fuse_moe_trio(node.params.n))
    sizes = dict(mesh.shape)
    acts = (ActiMode.AC_MODE_NONE, ActiMode.AC_MODE_RELU,
            ActiMode.AC_MODE_SIGMOID, ActiMode.AC_MODE_GELU)

    def deg_of(axes) -> int:
        d = 1
        for a in axes:
            d *= sizes[a]
        return d

    # batch-split (Repartition) axis groups: data, seq, and their
    # composition; weight-split (Replicate/Reduction) groups: model, and
    # model×seq. The seq axis doubles as extra batch/TP capacity when the
    # graph doesn't need it for ring attention — the search arbitrates.
    batch_groups = [(a,) for a in (AXIS_DATA, AXIS_SEQ)
                    if sizes.get(a, 1) > 1]
    if len(batch_groups) == 2:
        batch_groups.append((AXIS_DATA, AXIS_SEQ))
    tp_groups = [(AXIS_MODEL,)] if sizes.get(AXIS_MODEL, 1) > 1 else []
    if tp_groups and sizes.get(AXIS_SEQ, 1) > 1:
        tp_groups.append((AXIS_MODEL, AXIS_SEQ))

    seen_names = {x.name for x in xfers}

    def add(x: GraphXfer):
        # names encode (family, degree, act, axes): the dedup bound on the
        # candidate pool
        if x.name not in seen_names:
            seen_names.add(x.name)
            xfers.append(x)

    for axes in tp_groups:
        deg = deg_of(axes)
        for act in acts:
            add(create_replicate_linear_combine(deg, act, axes))
        add(create_replicate_attention_reduce(deg, axes))
        add(create_replicate_conv2d_combine(deg, axes))
    for axes in batch_groups:
        deg = deg_of(axes)
        for act in acts:
            add(create_partition_linear_combine(deg, act, axes))
        add(create_partition_attention_combine(deg, axes))
        add(create_partition_add_combine(deg, axes))
        add(create_partition_relu_combine(deg, axes))
        add(create_partition_softmax_combine(deg, axes))
        add(create_partition_conv2d_combine(deg, axes))
        add(create_partition_pool2d_combine(deg, axes))
        add(create_partition_concat_combine(deg, axes))
        add(create_partition_embedding_combine(deg, axes))
    # stable, content-hashable emission order (ffrules pass 5, registry
    # determinism): sorted by the name that encodes (family, degree, act,
    # axes) — the dedup key above — so two processes, or two runs of one
    # process, emit byte-identical rule sets and the registry fingerprint
    # (analysis/rules.rules_fingerprint) is a real content address
    xfers.sort(key=lambda x: x.name)
    return xfers


_ACT_NAMES = {
    "none": ActiMode.AC_MODE_NONE, "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "gelu": ActiMode.AC_MODE_GELU, "tanh": ActiMode.AC_MODE_TANH,
}

# parallel-op param constructors for pattern rules: field lists give the
# JSON "params" keys in positional order
_PARALLEL_PARAMS = {
    OT.OP_REPARTITION: (RepartitionParams, ("dim", "degree")),
    OT.OP_COMBINE: (CombineParams, ("dim", "degree")),
    OT.OP_REPLICATE: (ReplicateParams, ("degree",)),
    OT.OP_REDUCTION: (ReductionParams, ("degree",)),
}


def _op_type_by_name(name: str) -> OT:
    key = f"OP_{name.upper()}"
    try:
        return OT[key]
    except KeyError:
        raise ValueError(f"unknown op type {name!r} in substitution rule")


def _resolve_attr_value(v):
    """JSON attr values: activation names resolve to ActiMode; everything
    else passes through."""
    if isinstance(v, str) and v.strip().lower() in _ACT_NAMES:
        return _ACT_NAMES[v.strip().lower()]
    return v


def _make_constraint(spec: dict):
    """One source-op constraint: {"attr": f, "eq": v} (equality, enum names
    resolved) or {"attr": f, "mod": d} (divisibility) — the expressible
    subset of substitution_loader.cc's PMParameter conditions."""
    attr = spec["attr"]
    if "eq" in spec:
        want = _resolve_attr_value(spec["eq"])
        return lambda n: getattr(n.params, attr, None) == want
    if "mod" in spec:
        d = int(spec["mod"])
        return lambda n: getattr(n.params, attr, 0) % d == 0
    raise ValueError(f"constraint {spec} needs 'eq' or 'mod'")


def compile_pattern_rule(rule: dict) -> GraphXfer:
    """Compile one declarative src→dst pattern rule into a GraphXfer — the
    substitution_loader.cc analog, able to express NEW rewrites (arbitrary
    ops, multi-op patterns, constraints), not just parameterize built-ins.

    Schema:
      {"name": str,
       "src": [{"op": "linear", "inputs": ["$0"], "out": "l1",
                "constraints": [{"attr": "activation", "eq": "none"}]}],
       "dst": [{"op": "repartition", "inputs": ["$0"],
                "params": {"dim": 0, "degree": 4}, "out": "r1"},
               {"op": "linear", "inputs": ["r1"], "match": "l1",
                "params_update": {"activation": "relu"}, "out": "l2"},
               ...],
       "map_outputs": [["l1", "c1"]]}

    `inputs` entries: "$i" = the xfer's free input slot i; "name" or
    "name:idx" = output idx of a previously declared pattern op. `match`
    makes a dst compute op inherit the named src op's params/weights
    (matchOpX); `params_update` overrides fields on the inherited params;
    parallel-op `params` build the op's param struct."""
    x = GraphXfer(rule.get("name", "pattern_rule"))
    tensors: dict[str, TensorX] = {}

    def resolve_input(ref: str) -> TensorX:
        if ref.startswith("$"):
            return x.new_input(int(ref[1:]))
        name, _, idx = ref.partition(":")
        if name not in tensors:
            raise ValueError(
                f"rule {x.name}: input {ref!r} references unknown op")
        base = tensors[name]
        if idx:
            return TensorX(base.op, int(idx))
        return base

    named_ops: dict[str, OpX] = {}
    for spec in rule.get("src", []):
        if not isinstance(spec, dict) or "op" not in spec:
            raise ValueError(
                f"rule {x.name}: each src entry must be an object with "
                f"an 'op' field, got {spec!r}")
        ot = _op_type_by_name(spec["op"])
        ins = tuple(resolve_input(r) for r in spec.get("inputs", []))
        cons = tuple(_make_constraint(c)
                     for c in spec.get("constraints", []))
        op = OpX(ot, ins, num_outputs=int(spec.get("num_outputs", 1)),
                 constraints=cons)
        # the declarative constraint specs stay attached so the ffrules
        # verifier (analysis/rules.py) can honor eq/mod hints when it
        # synthesizes a concrete instance (closures are opaque)
        op._constraint_specs = tuple(spec.get("constraints", []))
        x.src_ops.append(op)
        out = spec.get("out")
        if out:
            named_ops[out] = op
            tensors[out] = op.outputs[0]

    for spec in rule.get("dst", []):
        if not isinstance(spec, dict) or "op" not in spec:
            raise ValueError(
                f"rule {x.name}: each dst entry must be an object with "
                f"an 'op' field, got {spec!r}")
        ot = _op_type_by_name(spec["op"])
        ins = tuple(resolve_input(r) for r in spec.get("inputs", []))
        if ot in _PARALLEL_PARAMS:
            cls, fields = _PARALLEL_PARAMS[ot]
            params = spec.get("params", {})
            missing = [f for f in fields if f not in params]
            if missing:
                raise ValueError(
                    f"rule {x.name}: parallel dst op {spec['op']!r} "
                    f"params missing field(s) {missing} (needs {fields})")
            args = []
            for f in fields:  # dim/degree are ints by schema — coerce
                try:
                    args.append(int(params[f]))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"rule {x.name}: parallel dst op {spec['op']!r} "
                        f"param {f!r} must be an integer, got "
                        f"{params[f]!r}")
            op = OpX(ot, ins, make_params=lambda m, c=cls, a=tuple(args):
                     c(*a))
        elif "match" in spec:
            src_op = named_ops.get(spec["match"])
            if src_op is None or src_op not in x.src_ops:
                raise ValueError(
                    f"rule {x.name}: match={spec['match']!r} names no "
                    f"source op")
            updates = {k: _resolve_attr_value(v)
                       for k, v in spec.get("params_update", {}).items()}
            mk = ((lambda m, s=src_op, u=dict(updates):
                   replace(m[s].params, **u)) if updates else None)
            op = OpX(ot, ins, num_outputs=int(spec.get("num_outputs", 1)),
                     match_src=src_op, make_params=mk)
        else:
            raise ValueError(
                f"rule {x.name}: dst op {spec['op']!r} needs 'match' (to "
                f"inherit a source op's params) or must be a parallel op "
                f"with 'params'")
        x.dst_ops.append(op)
        out = spec.get("out")
        if out:
            named_ops[out] = op
            tensors[out] = op.outputs[0]

    for src_ref, dst_ref in rule.get("map_outputs", []):
        sname, _, sidx = src_ref.partition(":")
        dname, _, didx = dst_ref.partition(":")
        if sname not in named_ops or dname not in named_ops:
            raise ValueError(
                f"rule {x.name}: map_outputs references unknown op")
        x.map_output(TensorX(named_ops[sname], int(sidx or 0)),
                     TensorX(named_ops[dname], int(didx or 0)))
    if not x.src_ops or not x.dst_ops or not x.mapped_outputs:
        raise ValueError(
            f"rule {x.name}: needs src ops, dst ops, and map_outputs")
    return x


def load_rule_collection(path: str, mesh,
                         config=None) -> list[GraphXfer]:
    """JSON rule loader wired to --substitution-json (reference
    substitution_loader.cc + substitutions/graph_subst_3_v2.json). Two rule
    forms, mixable in one file:

      {"rules": [
         {"generator": "replicate_linear_combine",
          "degree": 4, "activation": "relu"},        # parameterized built-in
         {"name": "...", "src": [...], "dst": [...],
          "map_outputs": [...]}                       # full src→dst pattern
      ]}

    `degree` defaults to the mesh's model-axis size. Unknown generators /
    ops / malformed patterns raise (matching the reference loader's
    strictness).

    When `config` is given, every loaded rule is VERIFIED through the
    ffrules passes (analysis/rules.py) before it can reach the search —
    external rules are the trust boundary TASO formalized: an unsound
    rule raises a structured RuleVerificationError naming the rule and
    finding class; `--no-verify-rules` downgrades to a warning with the
    verdict recorded in strategy_report.json's analysis section."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or not isinstance(
            data.get("rules", []), list):
        raise ValueError(
            f"{path}: substitution file must be an object with a "
            f"'rules' list")
    sizes = dict(mesh.shape)
    default_deg = sizes.get(AXIS_MODEL, 1)
    xfers = []
    for rule in data.get("rules", []):
        if not isinstance(rule, dict):
            raise ValueError(
                f"{path}: each rule must be an object, got {rule!r}")
        if "src" in rule or "dst" in rule:
            xfers.append(compile_pattern_rule(rule))
            continue
        gen = rule.get("generator")
        if gen not in _GENERATORS:
            raise ValueError(
                f"unknown substitution generator {gen!r}; have "
                f"{sorted(_GENERATORS)}")
        kw = {}
        if "activation" in rule:
            act = rule["activation"].strip().lower()
            if act not in _ACT_NAMES:
                raise ValueError(
                    f"unknown activation {rule['activation']!r}; have "
                    f"{sorted(_ACT_NAMES)}")
            kw["activation"] = _ACT_NAMES[act]
        if "n" in rule:
            kw["n"] = int(rule["n"])
        xfers.append(_GENERATORS[gen](int(rule.get("degree", default_deg)),
                                      **kw))
    if config is not None:
        from ..analysis.rules import gate_loaded_rules

        gate_loaded_rules(xfers, mesh, config, path)
    return xfers


# -------------------------------------------------------------- base_optimize

def best_first_search(
    graph: Graph,
    xfers: list[GraphXfer],
    cost_fn,
    budget: int,
    alpha: float,
):
    """The base_optimize loop (reference substitution.cc:2229-2311) with the
    candidate evaluator injected: a priority queue of rewritten graphs
    ordered by cost, budgeted pops, alpha pruning against the incumbent, and
    graph-hash dedup. `cost_fn(g) -> (cost, payload)` may raise ValueError
    to reject a candidate. Returns (best graph, best cost, best payload).
    Shared by the degree-priced substitution search and the joint search
    (which prices candidates with the placement DP)."""
    from .. import telemetry

    counter = itertools.count()
    best_cost, best_payload = cost_fn(graph)
    best_g = graph
    pq: list = [(best_cost, next(counter), graph)]
    seen = {graph.hash()}
    pops = 0
    evaluated = 0
    with telemetry.span("search.best_first", budget=budget):
        while pq and pops < budget:
            cost, _, g = heapq.heappop(pq)
            pops += 1
            if cost > best_cost * alpha:
                continue
            for xfer in xfers:
                for m in xfer.find_matches(g):
                    try:
                        ng = xfer.apply(g, m)
                    except ValueError:
                        continue
                    h = ng.hash()
                    if h in seen:
                        continue
                    seen.add(h)
                    try:
                        nc, npayload = cost_fn(ng)
                    except ValueError:
                        continue
                    evaluated += 1
                    if nc < best_cost:
                        best_g, best_cost, best_payload = ng, nc, npayload
                        # best-cost-so-far curve across rewritten candidates
                        telemetry.counter(
                            "search.best_cost_ms",
                            {"cost": best_cost * 1e3})
                    if nc < best_cost * alpha:
                        heapq.heappush(pq, (nc, next(counter), ng))
    telemetry.event("search_candidates", candidates=evaluated, pops=pops,
                    best_cost_s=best_cost)
    return best_g, best_cost, best_payload


def base_optimize(
    graph: Graph,
    mesh,
    cm: CostModel,
    xfers: list[GraphXfer],
    budget: int = 16,
    alpha: float = 1.2,
    hbm_cap: Optional[float] = None,
    overlap_sync: bool = False,
) -> tuple[Graph, float]:
    """Substitution-only search: candidates priced through the fixed
    degree-derived axis assignment (evaluate_graph) with per-chip HBM
    validity (graph.cc is_valid_strategy). The joint search (search/joint.py)
    prices the same candidates with the full placement DP instead."""

    def cost_of(g: Graph):
        t, mem = evaluate_graph(g, mesh, cm, overlap_sync=overlap_sync)
        cap = hbm_cap if hbm_cap is not None else cm.machine.chip.hbm_bytes
        if mem > cap:
            t *= 1.0 + 10.0 * (mem - cap) / cap
        return t, None

    best_g, best_cost, _ = best_first_search(graph, xfers, cost_of,
                                             budget, alpha)
    assign_axes_from_degrees(best_g, mesh)
    return best_g, best_cost


def graph_optimize(graph: Graph, mesh, config,
                   cm: Optional[CostModel] = None) -> Graph:
    """Substitution-search entry (GraphSearchHelper::graph_optimize,
    substitution.cc:1898): build the rule set (JSON rules when
    --substitution-json is given, built-in generators otherwise), run
    base_optimize, return the best rewritten graph with axes assigned."""
    from .machine_model import machine_model_for_mesh

    cm = cm or CostModel(machine_model_for_mesh(mesh))
    if config.substitution_json_path:
        # external rules verify at load (ffrules gate via config=)
        xfers = load_rule_collection(config.substitution_json_path, mesh,
                                     config=config)
    else:
        # built-in registry: swept by scripts/ffrules.py in CI
        xfers = generate_all_pcg_xfers(mesh, config, graph)  # fflint: ok unverified_rule_load
    budget = config.search_budget or 16
    best, _ = base_optimize(
        graph, mesh, cm, xfers, budget=budget, alpha=config.search_alpha,
        overlap_sync=config.search_overlap_backward_update)
    return best
