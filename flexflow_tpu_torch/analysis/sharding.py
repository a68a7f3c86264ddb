"""Pass 1 — sharding dataflow verifier (twin of
`flexflow_tpu/analysis/sharding.py`).

GSPMD (Xu et al. 2021) shows sharding propagation is a well-defined
dataflow analysis over the graph; this pass re-derives per-tensor /
per-edge sharding facts from the plan INDEPENDENTLY of the executor and
cross-checks them. Two entry points:

- `verify_strategy(overrides, graph, mesh_axes)` — the strategy-level
  (pre-assignment) verifier: unknown nodes/weights, rank mismatches,
  absent mesh axes, indivisible dims, and one mesh axis used on two dims
  of one assignment (a placement no rank can hold a block of). Runs on
  raw override dicts, so the warm-start plan cache and --import-strategy
  gate BEFORE a stale plan touches the graph; `Strategy.validate`
  delegates here with the JAX package's error texts.

- `run(graph, mesh, ctx)` — the compile-time pass over MATERIALIZED
  placements (`ParallelTensor.axis_assignment`, `node.weight_axes`):
  re-checks every pinned assignment, validates replica-dim consistency,
  and walks each edge flagging IMPLICIT reshards — a layout-preserving
  consumer pinned to a different spec than its producer, with no
  explicit parallel op on the edge. The executor re-places the value
  there with a collective no parallel-op node represents; the finding
  carries its class and priced bytes/seconds (the port's
  `search/cost_model.classify_reshard`).

The passes read only the mesh's axis sizes (`mesh.shape`), so any object
with that mapping serves as the mesh.
"""

from __future__ import annotations

from ..fftype import OperatorType as OT
from ..fftype import UnportedOperatorType as UOT
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "sharding_dataflow"

# Ops whose output layout should equal their (first) input's layout: the
# op computes element-wise (or re-places nothing), so a differing pinned
# spec means a pure reshard on the edge — implicit, and invisible to
# anything that only looks for explicit parallel-op nodes.
_LAYOUT_PRESERVING = frozenset({
    OT.OP_RELU, OT.OP_GELU, OT.OP_SIGMOID, OT.OP_TANH, OT.OP_ELU,
    OT.OP_IDENTITY, OT.OP_DROPOUT, OT.OP_SCALAR_MULTIPLY,
    OT.OP_SCALAR_ADD, OT.OP_SCALAR_SUB, OT.OP_SCALAR_TRUE_DIV,
    OT.OP_EXP, OT.OP_SIN, OT.OP_COS, OT.OP_RSQRT, OT.OP_POW,
    OT.OP_EW_ADD, OT.OP_EW_SUB, OT.OP_EW_MUL, OT.OP_EW_DIV,
    OT.OP_EW_MAX, OT.OP_EW_MIN,
})


def _flat_axes(assignment):
    """Flatten a per-dim assignment (tuples of mesh-axis names) into
    [(dim, axis), ...]."""
    out = []
    for i, entry in enumerate(assignment or ()):
        for ax in (entry or ()):
            out.append((i, ax))
    return out


def assignment_problems(assignment, shape, axis_sizes: dict,
                        where: str) -> list[Finding]:
    """Check ONE per-dim axis assignment against its tensor shape and the
    mesh: unknown axes, per-assignment axis reuse (the invalid-
    NamedSharding bug Strategy.validate used to accept), oversharded and
    indivisible dims. `shape` entries may be None (dim size unknown —
    divisibility is skipped)."""
    findings: list[Finding] = []
    seen: dict[str, int] = {}
    for dim, ax in _flat_axes(assignment):
        if ax not in axis_sizes:
            findings.append(Finding(
                SEV_ERROR, "unknown_axis",
                f"mesh axis {ax!r} not in mesh {sorted(axis_sizes)}",
                where=f"{where} dim {dim}"))
            continue
        if ax in seen:
            findings.append(Finding(
                SEV_ERROR, "axis_reuse",
                f"mesh axis {ax!r} used on dim {seen[ax]} and dim {dim} "
                f"of one assignment (invalid NamedSharding: an axis may "
                f"shard a tensor at most once)",
                where=where,
                details={"axis": ax, "dims": [seen[ax], dim]}))
        else:
            seen[ax] = dim
    for i, entry in enumerate(assignment or ()):
        degree = 1
        for ax in (entry or ()):
            degree *= axis_sizes.get(ax, 1)
        if degree <= 1:
            continue
        size = shape[i] if i < len(shape) else None
        if size is None:
            continue
        if degree > size:
            findings.append(Finding(
                SEV_ERROR, "overshard",
                f"dim of size {size} sharded {degree} ways over "
                f"{tuple(entry)} — more shards than elements",
                where=f"{where} dim {i}",
                details={"size": int(size), "degree": int(degree)}))
        elif size % degree != 0:
            findings.append(Finding(
                SEV_ERROR, "indivisible_dim",
                f"dim of size {size} not divisible by total sharding "
                f"degree {degree} over {tuple(entry)}",
                where=f"{where} dim {i}",
                details={"size": int(size), "degree": int(degree)}))
    return findings


def _spec_to_assignment(spec, ndim: int):
    from ..tensor import spec_assignment

    return spec_assignment(spec, ndim)


def verify_strategy(overrides: dict, graph, mesh_axes: dict
                    ) -> list[Finding]:
    """Strategy-level verification of an overrides dict against (graph,
    mesh axis sizes). The superset of the historical Strategy.validate
    checks — `Strategy.validate` delegates here, so the import path, the
    warm-start plan cache, and checkpoint plan adoption all inherit every
    new check for free."""
    axis_sizes = {k: int(v) for k, v in dict(mesh_axes).items()}
    nodes = {n.name: n for n in graph.topo_order()}
    findings: list[Finding] = []
    for name, ov in (overrides or {}).items():
        node = nodes.get(name)
        if node is None:
            findings.append(Finding(
                SEV_ERROR, "unknown_node",
                f"node {name!r} not in this graph (plan exported from a "
                f"different model?)", where=name))
            continue
        for idx, assignment in (ov.get("outputs") or {}).items():
            if idx >= len(node.outputs):
                findings.append(Finding(
                    SEV_ERROR, "unknown_output",
                    f"output index {idx} out of range "
                    f"({len(node.outputs)} outputs)",
                    where=f"{name}:output{idx}"))
                continue
            shape = node.outputs[idx].shape.logical_shape
            if len(assignment) != len(shape):
                findings.append(Finding(
                    SEV_ERROR, "rank_mismatch",
                    f"output {idx} assignment has {len(assignment)} dims, "
                    f"tensor has {len(shape)}",
                    where=f"{name}:output{idx}"))
                continue
            findings.extend(assignment_problems(
                assignment, shape, axis_sizes, f"{name}:output{idx}"))
        declared = {ws.name: ws for ws in node.weight_specs}
        for wname, spec in (ov.get("weights") or {}).items():
            ws = declared.get(wname)
            if ws is None:
                findings.append(Finding(
                    SEV_ERROR, "unknown_weight",
                    f"no weight named {wname!r} (has {sorted(declared)})",
                    where=f"{name}:{wname}"))
                continue
            if len(spec) > len(ws.shape):
                findings.append(Finding(
                    SEV_ERROR, "rank_mismatch",
                    f"weight {wname!r} spec has {len(spec)} dims, weight "
                    f"has {len(ws.shape)}",
                    where=f"{name}:{wname}"))
                continue
            findings.extend(assignment_problems(
                _spec_to_assignment(spec, len(ws.shape)), ws.shape,
                axis_sizes, f"{name}:{wname}"))
    return findings


def strategy_json_problems(strategy_json: dict) -> list[Finding]:
    """Graph-free sanity check of a serialized Strategy (the plan-cache
    entry format): per-assignment axis reuse is detectable from the JSON
    alone, so the cache can reject a poisoned entry without even
    decoding it against a graph."""
    findings: list[Finding] = []
    for name, ov in (strategy_json.get("nodes") or {}).items():
        for idx, assignment in (ov.get("outputs") or {}).items():
            seen: dict = {}
            for dim, entry in enumerate(assignment or []):
                for ax in (entry or []):
                    if ax in seen:
                        findings.append(Finding(
                            SEV_ERROR, "axis_reuse",
                            f"axis {ax!r} on dims {seen[ax]} and {dim}",
                            where=f"{name}:output{idx}"))
                    else:
                        seen[ax] = dim
        for wname, entries in (ov.get("weights") or {}).items():
            seen = {}
            for dim, entry in enumerate(entries or []):
                axes = (entry if isinstance(entry, list)
                        else [entry] if entry is not None else [])
                for ax in axes:
                    if ax in seen:
                        findings.append(Finding(
                            SEV_ERROR, "axis_reuse",
                            f"axis {ax!r} on dims {seen[ax]} and {dim}",
                            where=f"{name}:{wname}"))
                    else:
                        seen[ax] = dim
    return findings


def run(graph, mesh, ctx=None) -> list[Finding]:
    """Compile-time pass over the MATERIALIZED placements (every
    ParallelTensor's axis_assignment + every node's weight_axes) — the
    independent re-derivation that must agree with what the executor will
    pin. `ctx` optionally carries {machine, cost_model} for pricing the
    implicit-reshard findings."""
    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    findings: list[Finding] = []
    machine = getattr(ctx, "machine", None) if ctx is not None else None
    order = graph.topo_order()
    for node in order:
        for i, pt in enumerate(node.outputs):
            where = f"{node.name}:output{i}"
            dims = pt.shape.dims
            shape = [None if d.is_replica_dim else d.size for d in dims]
            findings.extend(assignment_problems(
                pt.axis_assignment, shape, axis_sizes, where))
            # replica-dim consistency: a replica dim exists only to count
            # replicas (size == degree by construction); an axis sharding
            # a replica dim that ALSO shards a logical dim of the same
            # tensor double-uses the axis exactly like in-assignment reuse
            logical_axes = {
                ax for d, entry in zip(dims, pt.axis_assignment)
                if not d.is_replica_dim for ax in entry}
            for d, entry in zip(dims, pt.axis_assignment):
                if not d.is_replica_dim:
                    continue
                if d.size != d.degree:
                    findings.append(Finding(
                        SEV_ERROR, "replica_dim",
                        f"replica dim size {d.size} != degree {d.degree}",
                        where=where))
                overlap = set(entry) & logical_axes
                if overlap:
                    findings.append(Finding(
                        SEV_ERROR, "replica_dim",
                        f"replica dim rides axes {sorted(overlap)} that "
                        f"also shard logical dims of this tensor",
                        where=where))
        for wname, spec in (node.weight_axes or {}).items():
            ws = next((w for w in node.weight_specs if w.name == wname),
                      None)
            if ws is None:
                findings.append(Finding(
                    SEV_ERROR, "unknown_weight",
                    f"placement for unknown weight {wname!r}",
                    where=f"{node.name}:{wname}"))
                continue
            findings.extend(assignment_problems(
                _spec_to_assignment(spec, len(ws.shape)), ws.shape,
                axis_sizes, f"{node.name}:{wname}"))

    # ---- implicit (unpriced) reshards: producer spec != consumer spec
    # on an edge with no explicit parallel op, where the consumer
    # preserves layout — the executor re-places the value with a
    # collective that no parallel-op node represents
    from ..search.cost_model import classify_reshard, dtype_bytes

    for node in order:
        if node.op_type not in _LAYOUT_PRESERVING or not node.outputs:
            continue
        out_pt = node.outputs[0]
        out_assign = tuple(
            a for d, a in zip(out_pt.shape.dims, out_pt.axis_assignment)
            if not d.is_replica_dim)
        for e in graph.in_edges[node.guid]:
            if e.dst_idx != 0:
                continue  # broadcasting second operands re-place freely
            src = graph.nodes[e.src]
            if src.op_type in (OT.OP_INPUT, UOT.OP_WEIGHT):
                continue
            src_pt = src.outputs[e.src_idx]
            src_assign = tuple(
                a for d, a in zip(src_pt.shape.dims,
                                  src_pt.axis_assignment)
                if not d.is_replica_dim)
            if src_assign == out_assign:
                continue
            shape = src_pt.shape.logical_shape
            details = {
                "producer": src.name,
                "producer_spec": [list(a) for a in src_assign],
                "consumer_spec": [list(a) for a in out_assign],
            }
            msg = (f"layout-preserving {node.op_type.name} pinned to a "
                   f"different spec than its producer {src.name} — the "
                   f"executor runs an implicit reshard on this edge (no "
                   f"parallel op represents it)")
            if machine is not None:
                try:
                    seconds = classify_reshard(
                        shape, src_assign, out_assign, src_pt.dtype,
                        machine)
                    details["priced_s"] = seconds
                    details["bytes"] = (
                        src_pt.shape.piece_elements()
                        * dtype_bytes(src_pt.dtype))
                except Exception:
                    pass
            findings.append(Finding(
                SEV_WARNING, "implicit_reshard", msg,
                where=f"{src.name} -> {node.name}", details=details))

    if not findings:
        findings.append(Finding(
            SEV_INFO, "sharding_clean",
            f"{len(order)} nodes: every assignment valid, no implicit "
            f"reshards on layout-preserving edges"))
    return findings
