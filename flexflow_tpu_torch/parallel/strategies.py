"""Parallelization strategies: per-node mesh-axis assignments (twin of
`flexflow_tpu/parallel/strategies.py`).

A `Strategy` maps a node name to {"outputs": {out_idx: assignment},
"weights": {weight_name: PartitionSpec}}, an assignment being a tuple
(one entry per tensor dim) of tuples of mesh axis names.
`FFModel.compile` applies it on top of the data-parallel default, and the
executor keeps every tensor in the placement it names. Its JSON (the
`--export-strategy` / `--import-strategy` file) is the JAX package's, so
a plan written by either package loads in the other.

`megatron_transformer` pairs column- and row-parallel Linear layers and
shards attention by heads; `sequence_parallel_attention` shards the
sequence dim of 3-D activations (with impl="ring" attention, which the
executor runs on each rank's rows of the sequence); `expert_parallel_moe`
waits for the MoE ops (ROADMAP A12).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..config import not_ported
from ..fftype import OperatorType as OT
from ..machine import AXIS_DATA, AXIS_MODEL, AXIS_SEQ
from ..tensor import PartitionSpec, spec_assignment


@dataclass
class Strategy:
    """Per-node placement overrides, mergeable; applied at compile."""

    overrides: dict = field(default_factory=dict)

    def node(self, name: str) -> dict:
        return self.overrides.setdefault(name, {"outputs": {}, "weights": {}})

    def set_output(self, name: str, out_idx: int, assignment):
        self.node(name)["outputs"][out_idx] = tuple(tuple(a) for a in assignment)

    def set_weight(self, name: str, weight_name: str, spec: PartitionSpec):
        self.node(name)["weights"][weight_name] = spec

    def merge(self, other: "Strategy") -> "Strategy":
        out = Strategy({k: {"outputs": dict(v["outputs"]),
                            "weights": dict(v["weights"])}
                        for k, v in self.overrides.items()})
        for k, v in other.overrides.items():
            n = out.node(k)
            n["outputs"].update(v["outputs"])
            n["weights"].update(v["weights"])
        return out

    def __bool__(self):
        return bool(self.overrides)

    def to_json(self) -> dict:
        def spec_entry(e):
            if e is None:
                return None
            if isinstance(e, (tuple, list)):
                return list(e)
            return e

        out = {"version": 1, "nodes": {}}
        for name, ov in self.overrides.items():
            out["nodes"][name] = {
                "outputs": {
                    str(idx): [list(axes) for axes in assignment]
                    for idx, assignment in ov.get("outputs", {}).items()
                },
                "weights": {
                    wname: [spec_entry(spec[i]) for i in range(len(spec))]
                    for wname, spec in ov.get("weights", {}).items()
                },
            }
        return out

    @staticmethod
    def from_json(data: dict) -> "Strategy":
        if data.get("version") != 1:
            raise ValueError(
                f"unsupported strategy file version {data.get('version')!r}")
        s = Strategy()
        for name, ov in data.get("nodes", {}).items():
            for idx, assignment in ov.get("outputs", {}).items():
                s.set_output(name, int(idx),
                             tuple(tuple(a) for a in assignment))
            for wname, entries in ov.get("weights", {}).items():
                s.set_weight(name, wname, PartitionSpec(*[
                    tuple(e) if isinstance(e, list) else e for e in entries
                ]))
        return s

    def validate(self, graph, mesh) -> None:
        """Check that this strategy applies to (graph, mesh); raise
        ValueError listing every problem otherwise: unknown nodes, output
        indices and weights, rank mismatches, axes absent from the mesh,
        an axis on two dims of one assignment, oversharded and
        indivisible dims (the JAX package's `analysis.verify_strategy`
        checks)."""
        axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
        nodes = {n.name: n for n in graph.topo_order()}
        problems: list[str] = []
        for name, ov in self.overrides.items():
            node = nodes.get(name)
            if node is None:
                problems.append(
                    f"{name}: node not in this graph (plan exported from a "
                    f"different model?)")
                continue
            for idx, assignment in (ov.get("outputs") or {}).items():
                where = f"{name}:output{idx}"
                if idx >= len(node.outputs):
                    problems.append(f"{where}: output index out of range "
                                    f"({len(node.outputs)} outputs)")
                    continue
                shape = node.outputs[idx].shape.logical_shape
                if len(assignment) != len(shape):
                    problems.append(
                        f"{where}: assignment has {len(assignment)} dims, "
                        f"tensor has {len(shape)}")
                    continue
                problems += assignment_problems(assignment, shape,
                                                axis_sizes, where)
            declared = {ws.name: ws for ws in node.weight_specs}
            for wname, spec in (ov.get("weights") or {}).items():
                where = f"{name}:{wname}"
                ws = declared.get(wname)
                if ws is None:
                    problems.append(f"{where}: no weight named {wname!r} "
                                    f"(has {sorted(declared)})")
                    continue
                if len(spec) > len(ws.shape):
                    problems.append(
                        f"{where}: spec has {len(spec)} dims, weight has "
                        f"{len(ws.shape)}")
                    continue
                problems += assignment_problems(
                    spec_assignment(spec, len(ws.shape)), ws.shape,
                    axis_sizes, where)
        if problems:
            raise ValueError("strategy does not apply to this graph/mesh:\n  "
                             + "\n  ".join(problems))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "Strategy":
        with open(path) as f:
            return Strategy.from_json(json.load(f))


def assignment_problems(assignment, shape, axis_sizes: dict,
                        where: str) -> list[str]:
    """One assignment against its tensor's shape and the mesh: unknown
    axes, an axis on two dims, more shards than elements, a dim its
    degree does not divide."""
    problems = []
    seen: dict[str, int] = {}
    for dim, entry in enumerate(assignment or ()):
        for ax in entry or ():
            if ax not in axis_sizes:
                problems.append(f"{where} dim {dim}: mesh axis {ax!r} not in "
                                f"mesh {sorted(axis_sizes)}")
            elif ax in seen:
                problems.append(f"{where}: mesh axis {ax!r} used on dim "
                                f"{seen[ax]} and dim {dim}")
            else:
                seen[ax] = dim
    for i, entry in enumerate(assignment or ()):
        degree = 1
        for ax in entry or ():
            degree *= axis_sizes.get(ax, 1)
        if degree <= 1 or i >= len(shape) or shape[i] is None:
            continue
        if degree > shape[i]:
            problems.append(f"{where} dim {i}: size {shape[i]} sharded "
                            f"{degree} ways over {tuple(entry)}")
        elif shape[i] % degree != 0:
            problems.append(f"{where} dim {i}: size {shape[i]} not "
                            f"divisible by degree {degree} over "
                            f"{tuple(entry)}")
    return problems


def _act_assignment(ndims: int, batch_axes=(AXIS_DATA,), last_axes=()):
    """An activation's assignment: batch dim over data, last dim
    optionally over model, the rest replicated."""
    a = [()] * ndims
    if ndims > 0:
        a[0] = tuple(batch_axes)
    if last_axes and ndims > 1:
        a[-1] = tuple(last_axes)
    return tuple(a)


def megatron_transformer(model, model_axis: str = AXIS_MODEL) -> Strategy:
    """Column -> row parallel Linear pairs + head-parallel attention + a
    column-parallel embedding table (the reference's
    create_replicate_linear_combine and create_partition_attention_combine
    applied model-wide)."""
    s = Strategy()
    layers = getattr(model, "layers", model)
    producer = {}
    for l in layers:
        for t in l.outputs:
            producer[t.tensor_guid] = l
    paired_row: set[int] = set()
    paired_col: set[int] = set()

    for l in layers:
        if l.op_type == OT.OP_MULTIHEAD_ATTENTION:
            # QKV column-parallel (heads split over model), O row-parallel
            for w in ("wq", "wk", "wv"):
                s.set_weight(l.name, w, PartitionSpec(None, model_axis))
            for b in ("bq", "bk", "bv"):
                s.set_weight(l.name, b, PartitionSpec(model_axis))
            s.set_weight(l.name, "wo", PartitionSpec(model_axis, None))
            s.set_weight(l.name, "bo", PartitionSpec())
            nd = len(l.outputs[0].dims)
            s.set_output(l.name, 0, _act_assignment(nd))
        elif l.op_type == OT.OP_LINEAR and l.layer_guid not in paired_row:
            nxt = _linear_consumer(l, layers)
            if nxt is None or nxt.layer_guid in paired_col:
                continue
            s.set_weight(l.name, "kernel", PartitionSpec(None, model_axis))
            if any(ws.name == "bias" for ws in _weight_specs(l)):
                s.set_weight(l.name, "bias", PartitionSpec(model_axis))
            nd = len(l.outputs[0].dims)
            s.set_output(l.name, 0, _act_assignment(nd, last_axes=(model_axis,)))
            paired_col.add(l.layer_guid)
            for mid in _chain_between(l, nxt, producer):
                ndm = len(mid.outputs[0].dims)
                s.set_output(mid.name, 0,
                             _act_assignment(ndm, last_axes=(model_axis,)))
            s.set_weight(nxt.name, "kernel", PartitionSpec(model_axis, None))
            s.set_weight(nxt.name, "bias", PartitionSpec())
            ndn = len(nxt.outputs[0].dims)
            s.set_output(nxt.name, 0, _act_assignment(ndn))
            paired_row.add(nxt.layer_guid)
        elif l.op_type == OT.OP_EMBEDDING:
            s.set_weight(l.name, "kernel", PartitionSpec(None, model_axis))
    return s


def _weight_specs(layer):
    from ..ops.base import get_op_def

    in_shapes = [t.dims for t in layer.inputs]
    return get_op_def(layer.op_type).weights(layer.params, in_shapes)


_ELEMENTWISE_CHAIN_OPS = frozenset(
    {
        OT.OP_RELU, OT.OP_GELU, OT.OP_SIGMOID, OT.OP_TANH, OT.OP_ELU,
        OT.OP_IDENTITY, OT.OP_DROPOUT, OT.OP_SCALAR_MULTIPLY,
        OT.OP_SCALAR_ADD, OT.OP_SCALAR_SUB, OT.OP_SCALAR_TRUE_DIV,
    }
)


def _linear_consumer(layer, layers):
    """The Linear fed (possibly through elementwise ops) by `layer`."""
    out_guids = {t.tensor_guid for t in layer.outputs}
    for l in layers:
        if not l.inputs:
            continue
        if l.inputs[0].tensor_guid in out_guids:
            if l.op_type == OT.OP_LINEAR:
                return l
            if l.op_type in _ELEMENTWISE_CHAIN_OPS:
                return _linear_consumer(l, layers)
    return None


def _chain_between(src, dst, producer):
    """Elementwise layers strictly between src and dst."""
    chain = []
    cur = producer.get(dst.inputs[0].tensor_guid)
    while cur is not None and cur.layer_guid != src.layer_guid:
        chain.append(cur)
        if not cur.inputs:
            break
        cur = producer.get(cur.inputs[0].tensor_guid)
    return chain


def sequence_parallel_attention(model, seq_axis: str = AXIS_SEQ) -> Strategy:
    """Shard the sequence dim of 3-D activations over `seq_axis` (batch
    over data); tensors whose seq dim the seq degree does not divide keep
    the default. Attention keeps its rows split only as impl="ring"
    (parallel/ring_attention.py); any other impl gathers the sequence."""
    seq_deg = 0
    cfg = getattr(model, "config", None)
    if cfg is not None:
        try:
            ms = cfg.mesh_shape()
            seq_deg = dict(zip(ms.axis_names, ms.axis_sizes)).get(seq_axis, 0)
        except Exception:
            seq_deg = 0
    s = Strategy()
    layers = getattr(model, "layers", model)
    for l in layers:
        for i, t in enumerate(l.outputs):
            if len(t.dims) == 3:
                if seq_deg > 1 and int(t.dims[1]) % seq_deg != 0:
                    continue
                s.set_output(l.name, i, ((AXIS_DATA,), (seq_axis,), ()))
    return s


def expert_parallel_moe(model, expert_axis: str = AXIS_MODEL) -> Strategy:
    raise not_ported("parallel.expert_parallel_moe (the Experts op)",
                     "A12 (ops/moe.py)")
