"""Parallel computation graph (twin of `flexflow_tpu/pcg/graph.py`, no
`native`).

Nodes, multi-edges (src, dst, src_idx, dst_idx), a deterministic
topological order and the DOT export. Compute ops and the parallel ops
(`is_parallel_op`) are both nodes. A node's `outputs` are ParallelTensors
carrying the mesh axes each output takes (`axis_assignment`), and
`weight_axes` the PartitionSpec of each weight the plan shards (absent:
replicated); `output_shapes` keeps the plain shapes.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass
from typing import Any, Optional

from ..fftype import PARALLEL_OP_TYPES, OperatorType
from ..ops.base import OpDef, WeightSpec, get_op_def

_node_guid = itertools.count(5000000)  # NODE_GUID_FIRST_VALID


@dataclass(frozen=True)
class Edge:
    """src node guid, dst node guid, src output idx, dst input idx."""

    src: int
    dst: int
    src_idx: int = 0
    dst_idx: int = 0


class OpNode:
    """One graph node: an operator instance with its output shapes."""

    def __init__(
        self,
        op_type: OperatorType,
        params: Any,
        name: str = "",
        layer_guid: int = -1,
        initializers: Optional[dict] = None,
    ):
        self.guid = next(_node_guid)
        self.op_type = op_type
        self.params = params
        self.name = name or f"{op_type.name.lower()}_{self.guid}"
        self.layer_guid = layer_guid
        self.initializers = initializers or {}
        self.input_shapes: list[tuple[int, ...]] = []
        self.output_shapes: list[tuple[int, ...]] = []
        # ParallelTensors: the producers' outputs, and this node's
        self.inputs: list = []
        self.outputs: list = []
        # weight name -> PartitionSpec of the weight's compute placement
        self.weight_axes: dict[str, Any] = {}
        self.weight_specs: list[WeightSpec] = []
        # tied weights: the name of the node whose parameters this one
        # reads (FFModel's shared_op), else None
        self.weight_source: Optional[str] = None
        # an input made by FFModel.create_constant: (dims, DataType, value)
        self.constant: Optional[tuple] = None

    @property
    def op_def(self) -> OpDef:
        return get_op_def(self.op_type)

    @property
    def is_parallel_op(self) -> bool:
        return self.op_type in PARALLEL_OP_TYPES

    def __repr__(self):
        return f"OpNode({self.name})"


class Graph:
    """Nodes + explicit edges. Node identity is the guid."""

    def __init__(self):
        self.nodes: dict[int, OpNode] = {}
        self.in_edges: dict[int, list[Edge]] = {}
        self.out_edges: dict[int, list[Edge]] = {}

    def add_node(self, node: OpNode) -> OpNode:
        self.nodes[node.guid] = node
        self.in_edges.setdefault(node.guid, [])
        self.out_edges.setdefault(node.guid, [])
        return node

    def add_edge(self, src: OpNode, dst: OpNode, src_idx: int = 0, dst_idx: int = 0):
        e = Edge(src.guid, dst.guid, src_idx, dst_idx)
        self.in_edges[dst.guid].append(e)
        self.out_edges[src.guid].append(e)

    def sources(self) -> list[OpNode]:
        return [n for g, n in self.nodes.items() if not self.in_edges[g]]

    def sinks(self) -> list[OpNode]:
        return [n for g, n in self.nodes.items() if not self.out_edges[g]]

    def producer(self, node: OpNode, dst_idx: int) -> tuple[OpNode, int]:
        for e in self.in_edges[node.guid]:
            if e.dst_idx == dst_idx:
                return self.nodes[e.src], e.src_idx
        raise KeyError(f"{node.name} has no input {dst_idx}")

    def topo_order(self) -> list[OpNode]:
        indeg = {g: len(es) for g, es in self.in_edges.items()}
        # deterministic: process in guid order among ready nodes
        ready = sorted(g for g, d in indeg.items() if d == 0)
        order = []
        while ready:
            g = ready.pop(0)
            order.append(self.nodes[g])
            for e in self.out_edges[g]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    bisect.insort(ready, e.dst)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order


def export_dot(graph: "Graph", path: str | None = None) -> str:
    """DOT export of the graph (the JAX package's `export_dot`, reference
    print_dot): one box per node with its name, operator, output shape
    and its output's PartitionSpec (empty when replicated)."""
    lines = ["digraph PCG {", '  rankdir="TB";']
    for n in graph.topo_order():
        shape = n.output_shapes[0] if n.output_shapes else ""
        spec = ""
        if n.outputs and any(n.outputs[0].axis_assignment):
            spec = repr(tuple(n.outputs[0].partition_spec()))
        color = "lightblue" if n.is_parallel_op else (
            "gray90" if n.op_type.name in ("OP_INPUT", "OP_NOOP")
            else "white")
        lines.append(
            f'  n{n.guid} [label="{n.name}\\n{n.op_type.name}\\n'
            f'{shape}\\n{spec}", style=filled, fillcolor={color}];'
        )
    for guid, edges in graph.out_edges.items():
        for e in edges:
            lines.append(f"  n{e.src} -> n{e.dst};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
