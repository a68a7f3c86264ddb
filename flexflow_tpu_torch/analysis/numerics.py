"""Pass 5 — dtype-flow numerics verifier (the static half of ffsan; twin
of `flexflow_tpu/analysis/numerics.py`).

GSPMD (Xu et al. 2021, PAPERS.md "Analysis") verifies sharding by
propagating it as a dataflow lattice; mixed-precision training practice
(Micikevicius et al., ICLR 2018, PAPERS.md "Numerics") defines the
matching *precision* invariants: large reductions accumulate in fp32,
trainable weights keep an fp32 master copy, and no tensor round-trips
through a narrower dtype than its consumers need. This pass propagates a
precision lattice through the PCG under the plan — the same
compute_dtype / matmul_dtype / fp32-master policy the port's `executor.py`
runs (`dtype_policy`, read from the `FFConfig`) —
and reports violations BEFORE the first step ever produces a NaN the
`nan_loss` health rule can only post-mortem.

Checks (finding codes are stable identifiers, findings.py):

1. `low_precision_accum`  — a reduction summing many low-precision terms
   without fp32 accumulation: Reduce ops (ops/shape_ops.py accumulates
   in the carried dtype), partial-sum `Reduction` parallel ops over many
   shards, and a grad reduce-scatter whose weight dtype is low-precision.
   Ops in `F32_INTERNAL` (softmax / layernorm / batchnorm / linear /
   batch-matmul / attention — each verified to upcast internally, see
   the registry's source anchors) are exempt.
2. `master_bypass`        — a trainable weight declared in a low-precision
   dtype under the bf16 policy: gradients would accumulate into bf16
   state, bypassing the fp32-master path `_cast_compute`'s VJP provides.
   Error: silent training-quality corruption.
3. `downcast_roundtrip`   — an explicit Cast down followed (through
   value-preserving / parallel ops) by a Cast back up: the information
   is already destroyed, the round trip just spends HBM bandwidth.
4. `parallel_dtype_mismatch` — a parallel op (Combine / Repartition /
   Replicate / Reduction / ...) whose output dtype differs from its
   input's: parallel ops re-place values, they must never transform
   them. Error: the plan materialized an impossible edge.
"""

from __future__ import annotations

from ..fftype import DataType, OperatorType as OT, PARALLEL_OP_TYPES
from ..fftype import UnportedOperatorType as UOT
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "dtype_flow"

LOW_PRECISION = frozenset({DataType.DT_HALF, DataType.DT_BFLOAT16})
_FLOATING = frozenset({DataType.DT_HALF, DataType.DT_BFLOAT16,
                       DataType.DT_FLOAT, DataType.DT_DOUBLE})
# lattice order: wider wins at a join
_WIDTH = {DataType.DT_HALF: 16, DataType.DT_BFLOAT16: 16,
          DataType.DT_FLOAT: 32, DataType.DT_DOUBLE: 64}

# Ops whose forward accumulates in fp32 regardless of the carried
# activation dtype — each entry names the source anchor that upcasts, so
# the exemption is auditable (and removable if the kernel changes).
F32_INTERNAL = {
    OT.OP_SOFTMAX: "ops/core.py softmax: f32 exponentials and normalisation",
    OT.OP_LAYERNORM: "ops/core.py layer_norm: f32 statistics (K1/K4 too)",
    OT.OP_BATCHNORM: "ops/core.py batch_norm: f32 statistics",
    OT.OP_LINEAR: "ops/core.py _mm: f32 accumulation",
    OT.OP_BATCHMATMUL: "ops/core.py _mm: f32 accumulation",
    OT.OP_MULTIHEAD_ATTENTION:
        "ops/attention.py: flash K5-K8 accumulate in f32",
    OT.OP_INC_MULTIHEAD_ATTENTION:
        "ops/inc_attention.py: K2 accumulates in f32",
    OT.OP_PAGED_INC_MULTIHEAD_ATTENTION:
        "ops/inc_attention.py (paged): K3 accumulates in f32",
}

# reduce ops that SUM (max/min/argmax are order statistics — no
# accumulation error to speak of; prod shares sum's compounding)
_SUMMING_REDUCES = frozenset({OT.OP_REDUCE_SUM, OT.OP_REDUCE_MEAN,
                              OT.OP_MEAN, OT.OP_REDUCE_PROD})

# the dims an accumulation must cover before low-precision summing is
# worth a warning (Micikevicius et al. §4: loss scaling exists because
# long bf16/fp16 sums drift; short ones are benign)
ACCUM_ELEMS_WARN = 1024
# partial-sum terms (Reduction degree / reduce-scatter shards) threshold
ACCUM_TERMS_WARN = 32

# ops that only re-place or re-view their input — the dtype (and any
# downcast) flows through them untouched
# (squeeze / unsqueeze have no twin in the port's graphs)
_VALUE_PRESERVING = PARALLEL_OP_TYPES | {
    UOT.OP_NOOP, OT.OP_IDENTITY, OT.OP_RESHAPE, OT.OP_TRANSPOSE,
    OT.OP_DROPOUT,
}


def _is_float(dt: DataType) -> bool:
    return DataType(dt) in _FLOATING


def effective_dtypes(graph, compute_dtype):
    """{(guid, out_idx) -> DataType}: the dtype each tensor is CARRIED in
    at runtime under the mixed-precision policy — declared float dtypes
    collapse to the compute dtype (executor._cast_compute casts params
    and inputs; ops return their input's dtype), explicit Cast ops pin
    their target, integers pass through."""
    eff: dict[tuple[int, int], DataType] = {}
    for node in graph.topo_order():
        in_dts = []
        for e in sorted(graph.in_edges[node.guid],
                        key=lambda e: e.dst_idx):
            dt = eff.get((e.src, e.src_idx))
            if dt is not None:
                in_dts.append(dt)
        for i, pt in enumerate(node.outputs):
            dt = DataType(pt.dtype)
            if node.op_type == OT.OP_CAST:
                dt = DataType(getattr(node.params, "dtype", dt))
            elif node.op_type in _VALUE_PRESERVING and in_dts:
                dt = in_dts[0]
            elif (_is_float(dt) and compute_dtype is not None):
                dt = DataType(compute_dtype)
            eff[(node.guid, i)] = dt
    return eff


def _reduced_extent(node) -> int:
    """Number of accumulated terms of a Reduce node: product of the
    reduced dims (input elements / output elements)."""
    if not node.inputs or not node.outputs:
        return 0
    n_in = node.inputs[0].shape.num_elements()
    n_out = max(1, node.outputs[0].shape.num_elements())
    return max(1, n_in // n_out)


def _walk_value_preserving(graph, node):
    """Yield the transitive consumers of `node` reached only through
    value-preserving ops (the ops a downcast flows through unchanged)."""
    seen = set()
    frontier = [node]
    while frontier:
        cur = frontier.pop()
        for e in graph.out_edges[cur.guid]:
            nxt = graph.nodes[e.dst]
            if nxt.guid in seen:
                continue
            seen.add(nxt.guid)
            yield nxt
            if nxt.op_type in _VALUE_PRESERVING:
                frontier.append(nxt)


def run(graph, mesh, ctx=None) -> list[Finding]:
    config = getattr(ctx, "config", None) if ctx is not None else None
    training = bool(getattr(ctx, "training", True)) if ctx else True
    compute_dtype = getattr(config, "computation_dtype", None) \
        if config is not None else None
    update_specs = (getattr(ctx, "update_specs", None)
                    if ctx is not None else None) or {}
    findings: list[Finding] = []
    eff = effective_dtypes(graph, compute_dtype)
    order = graph.topo_order()
    weight_specs_by_node = {n.name: {ws.name: ws for ws in n.weight_specs}
                            for n in order}

    lp_tensors = sum(1 for dt in eff.values() if dt in LOW_PRECISION)

    for node in order:
        out_dt = eff.get((node.guid, 0))

        # 4) parallel ops must be dtype-preserving re-placements
        if node.is_parallel_op and node.inputs and node.outputs:
            in_dt = DataType(node.inputs[0].dtype)
            decl = DataType(node.outputs[0].dtype)
            if decl != in_dt:
                findings.append(Finding(
                    SEV_ERROR, "parallel_dtype_mismatch",
                    f"parallel op {node.name} ({node.op_type.name}) "
                    f"declares output {decl.name} for input {in_dt.name} "
                    f"— parallel ops re-place values, they cannot "
                    f"transform dtypes; the plan materialized an "
                    f"impossible edge",
                    where=node.name,
                    details={"input": in_dt.name, "output": decl.name}))

        # 1) low-precision accumulation
        if out_dt in LOW_PRECISION and node.op_type not in F32_INTERNAL:
            if node.op_type in _SUMMING_REDUCES:
                extent = _reduced_extent(node)
                if extent >= ACCUM_ELEMS_WARN:
                    findings.append(Finding(
                        SEV_WARNING, "low_precision_accum",
                        f"{node.name} ({node.op_type.name}) sums "
                        f"{extent} terms in {out_dt.name} (ops/"
                        f"shape_ops.py accumulates in the carried "
                        f"dtype) — route through fp32 or shrink the "
                        f"reduction (Micikevicius et al. §4)",
                        where=node.name,
                        details={"terms": extent, "dtype": out_dt.name}))
            elif node.op_type == OT.OP_REDUCTION:
                degree = int(getattr(node.params, "degree", 0) or 0)
                if degree >= ACCUM_TERMS_WARN:
                    findings.append(Finding(
                        SEV_WARNING, "low_precision_accum",
                        f"{node.name} sums {degree} partial results in "
                        f"{out_dt.name} — a wide partial-sum Reduction "
                        f"under the bf16 policy drifts; prefer an fp32 "
                        f"upcast before the combine",
                        where=node.name,
                        details={"terms": degree, "dtype": out_dt.name}))

        # 2) fp32-master bypass
        if (training and compute_dtype is not None
                and not getattr(node, "weight_source", None)):
            for ws in node.weight_specs:
                if ws.trainable and DataType(ws.dtype) in LOW_PRECISION:
                    findings.append(Finding(
                        SEV_ERROR, "master_bypass",
                        f"{node.name}.{ws.name} is a trainable "
                        f"{DataType(ws.dtype).name} weight under the "
                        f"{DataType(compute_dtype).name} policy — "
                        f"gradients would accumulate into low-precision "
                        f"state instead of the fp32 master "
                        f"(_cast_compute's VJP), silently corrupting "
                        f"training (Micikevicius et al. §3.1)",
                        where=f"{node.name}.{ws.name}",
                        details={"dtype": DataType(ws.dtype).name}))

        # 3) downcast → upcast round trip through value-preserving ops
        if node.op_type == OT.OP_CAST and node.inputs:
            src_dt = eff.get((graph.in_edges[node.guid][0].src,
                              graph.in_edges[node.guid][0].src_idx))
            dst_dt = eff.get((node.guid, 0))
            if (src_dt is not None and dst_dt is not None
                    and _is_float(src_dt) and _is_float(dst_dt)
                    and _WIDTH[dst_dt] < _WIDTH[src_dt]):
                for consumer in _walk_value_preserving(graph, node):
                    if consumer.op_type != OT.OP_CAST:
                        continue
                    up_dt = eff.get((consumer.guid, 0))
                    if (up_dt is not None and _is_float(up_dt)
                            and _WIDTH[up_dt] > _WIDTH[dst_dt]):
                        findings.append(Finding(
                            SEV_WARNING, "downcast_roundtrip",
                            f"{node.name} casts {src_dt.name} down to "
                            f"{dst_dt.name} and {consumer.name} casts "
                            f"back up to {up_dt.name} with only "
                            f"value-preserving ops between — the "
                            f"precision is already lost; the round trip "
                            f"spends HBM bandwidth for nothing",
                            where=node.name,
                            details={"down": dst_dt.name,
                                     "up": up_dt.name,
                                     "upcast_at": consumer.name}))
                        break

    # 1b) grad reduce-scatter buckets summing in a low-precision dtype
    # (with fp32 masters the grads are fp32 by construction — this fires
    # exactly when master_bypass broke that invariant for a sharded
    # weight, naming the collective that multiplies the damage)
    for (node_name, w_name), (spec, _shape) in update_specs.items():
        ws = weight_specs_by_node.get(node_name, {}).get(w_name)
        if ws is not None and DataType(ws.dtype) in LOW_PRECISION:
            findings.append(Finding(
                SEV_WARNING, "low_precision_accum",
                f"grad reduce-scatter for {node_name}.{w_name} sums "
                f"shards in {DataType(ws.dtype).name} — the sharded "
                f"update accumulates cross-replica gradients in the "
                f"weight dtype",
                where=f"{node_name}.{w_name}",
                details={"dtype": DataType(ws.dtype).name,
                         "spec": str(spec)}))

    if not findings:
        cd = (DataType(compute_dtype).name
              if compute_dtype is not None else "fp32")
        findings.append(Finding(
            SEV_INFO, "numerics_clean",
            f"{len(eff)} tensors through the precision lattice "
            f"(compute dtype {cd}, {lp_tensors} low-precision): "
            f"accumulations fp32-safe, masters fp32, no downcast "
            f"round trips, parallel edges dtype-uniform"))
    return findings
