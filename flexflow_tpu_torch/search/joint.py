"""Joint Unity search (twin of `flexflow_tpu/search/joint.py`): substitution
rewrites × placement DP in ONE optimizer.

This is the reference's actual Unity architecture (the round-3 repo ran the
two halves as an either/or): `GraphSearchHelper::base_optimize`
(substitution.cc:2229-2311) pops candidate graphs from a priority queue,
applies GraphXfer rewrites, and costs every candidate with
`Graph::optimal_cost` (substitution.cc:2253 → graph.cc:1742-1843) — i.e. the
full placement DP runs inside the rewrite search, so rewrites and per-node
placements are optimized together.

Recast over mesh axes:
- a rewrite pins the placement of the nodes it touched (their tensors carry
  ParallelDim degrees; `derive_pinned_configs` turns those into pinned
  NodeConfigs, and explicit parallel-op nodes are priced as the collectives
  they lower to);
- every candidate graph is costed by `UnitySearch` over its FREE nodes (the
  placement-DP half), with one `segment_cache` shared across all candidates
  so structurally unchanged segments cost nothing to re-evaluate (the
  reference's memoized graph_cost plays the same role);
- large graphs recurse through sequence splits at central bottleneck nodes
  before the best-first search runs (generic_sequence_optimize,
  substitution.cc:2530+; find_split_node:2094), which bounds wall time on
  bench-scale LMs;
- the winner's placements (pinned + searched) are materialized onto the
  graph tensors, and the searched half is also returned as a Strategy for
  export (--export-strategy).
"""

from __future__ import annotations

import itertools
from typing import Optional

from ..fftype import OperatorType as OT
from ..fftype import UnportedOperatorType as UOT
from ..pcg.graph import Graph, OpNode
from ..tensor import ParallelTensor
from .cost_model import CostModel
from .substitution import (
    _PARALLEL,
    assign_axes_from_degrees,
    _logical_assignment,
    best_first_search,
    generate_all_pcg_xfers,
    load_rule_collection,
    propagate_parallel_state,
)
from .unity import NodeConfig, UnitySearch

_SKIP = (OT.OP_INPUT, UOT.OP_WEIGHT, UOT.OP_NOOP)


def derive_pinned_configs(graph: Graph, mesh) -> dict:
    """{guid -> NodeConfig} for nodes whose placement a rewrite decided.

    Runs assign_axes_from_degrees (the FFMapper analog) so every tensor
    carries its degree-derived axes, then pins:
    - explicit parallel ops ("xfer_comm": priced as collectives),
    - compute ops with any sharded output/weight ("xfer": the rewrite's
      placement, including implied weight PartitionSpecs).
    Nodes with no rewrite-imposed state stay free for the placement DP."""
    assign_axes_from_degrees(graph, mesh)
    pinned: dict = {}
    for node in graph.topo_order():
        if node.op_type in _SKIP:
            continue
        in_assigns = tuple(_logical_assignment(pt) for pt in node.inputs)
        if node.op_type in _PARALLEL:
            pinned[node.guid] = NodeConfig(
                "xfer_comm", _logical_assignment(node.outputs[0]),
                in_assigns=in_assigns)
            continue
        sharded = any(d.degree > 1 for pt in node.outputs
                      for d in pt.shape.dims)
        wp = getattr(node, "_weight_partition", None)
        if sharded or wp:
            pinned[node.guid] = NodeConfig(
                "xfer", _logical_assignment(node.outputs[0]),
                tuple(sorted(node.weight_axes.items(), key=lambda kv: kv[0])),
                in_assigns=in_assigns)
    return pinned


def _joint_cost(g: Graph, mesh, config, cm: CostModel,
                segment_cache: dict):
    """Cost one candidate graph with the placement DP over its free nodes
    (the Graph::optimal_cost call inside base_optimize). Returns
    (penalized cost, choice, UnitySearch)."""
    pinned = derive_pinned_configs(g, mesh)
    us = UnitySearch(g, mesh, config, cm, segment_cache=segment_cache,
                     pinned=pinned, refine=False)
    choice = us.run()
    t, mem = us.evaluate(choice)
    return us._memory_penalized(t, mem), choice, us


def apply_choice_to_graph(g: Graph, mesh, choice: dict):
    """Materialize the searched placements onto the graph tensors (on top
    of the rewrite-derived axes assign_axes_from_degrees already wrote) so
    the executor's with_sharding_constraint pins exactly what the joint
    search costed."""
    assign_axes_from_degrees(g, mesh)
    for node in g.topo_order():
        cfg = choice.get(node.guid)
        if cfg is None or cfg.name in ("xfer", "xfer_comm"):
            continue
        for pt in node.outputs:
            if len(cfg.out_assign) == len(pt.shape.dims):
                pt.assign_axes(cfg.out_assign)
        declared = {ws.name for ws in node.weight_specs}
        for wname, spec in cfg.weight_specs:
            if wname in declared:
                node.weight_axes[wname] = spec


def _compute_size(g: Graph) -> int:
    return sum(1 for n in g.topo_order() if n.op_type not in _SKIP)


def joint_base_optimize(
    graph: Graph,
    mesh,
    config,
    cm: CostModel,
    xfers,
    segment_cache: dict,
    budget: int,
    alpha: float,
):
    """Best-first search over rewritten graphs, each costed by the placement
    DP (base_optimize, substitution.cc:2229-2311, with optimal_cost inlined
    as UnitySearch). Returns (best graph, best choice, best cost)."""

    def cost_of(g: Graph):
        cost, choice, _ = _joint_cost(g, mesh, config, cm, segment_cache)
        return cost, choice

    best_g, best_cost, best_choice = best_first_search(
        graph, xfers, cost_of, budget, alpha)
    return best_g, best_choice, best_cost


# ------------------------------------------------------- sequence splitting

def _find_split_node(g: Graph) -> Optional[OpNode]:
    """Central bottleneck (find_split_node, substitution.cc:2094): the
    bottleneck node nearest the middle of the topo order, excluding the
    sink. Returns None when no usable bottleneck exists."""
    from ..pcg.graph import find_bottlenecks

    order = g.topo_order()
    pos = {n.guid: i for i, n in enumerate(order)}
    usable = [(pos[n.guid], n) for n in find_bottlenecks(g, order)
              if n.op_type not in _SKIP and len(n.outputs) == 1]
    if not usable:
        return None
    mid = len(order) / 2
    i, n = min(usable, key=lambda t: abs(t[0] - mid))
    # a split at the very edge gains nothing
    if i < 2 or i > len(order) - 3:
        return None
    return n


_boundary_counter = itertools.count()


def _clone_basic(graph: Graph, node: OpNode) -> OpNode:
    nn = OpNode(node.op_type, node.params, name=node.name,
                layer_guid=node.layer_guid,
                initializers=node.initializers)
    nn.weight_specs = list(node.weight_specs)
    nn.weight_axes = dict(node.weight_axes)
    src = getattr(node, "weight_source", None)
    if src:
        nn.weight_source = src  # tied weights survive splits by name
    if node.op_type == OT.OP_INPUT:
        nn.outputs = [ParallelTensor(pt.shape, name=pt.name)
                      for pt in node.outputs]
    if getattr(node, "_is_logits", False):
        nn._is_logits = True
    marks = getattr(node, "_markers", None)
    if marks:
        nn._markers = frozenset(marks)
    graph.add_node(nn)
    return nn


def _split_at(g: Graph, split: OpNode) -> tuple[Graph, Graph, str]:
    """Cut g at a bottleneck node into (pre, post) subgraphs. `split` stays
    the sink of pre, tagged with a unique boundary token (tokens survive
    rewrites and nested splits, unlike a shared boolean); post gets a
    synthetic OP_INPUT standing in for split's output."""
    order = g.topo_order()
    cut = order.index(split)
    pre_nodes = order[:cut + 1]
    post_nodes = order[cut + 1:]
    token = f"boundary_{next(_boundary_counter)}"

    pre = Graph()
    pre_clone: dict[int, OpNode] = {}
    for n in pre_nodes:
        pre_clone[n.guid] = _clone_basic(pre, n)
    bn = pre_clone[split.guid]
    bn._markers = getattr(bn, "_markers", frozenset()) | {token}
    for n in pre_nodes:
        for e in g.in_edges[n.guid]:
            pre.add_edge(pre_clone[e.src], pre_clone[e.dst],
                         e.src_idx, e.dst_idx)

    post = Graph()
    boundary_in = OpNode(OT.OP_INPUT, None, name=f"{split.name}__boundary")
    # tagged too, so the join finds it after the post half's own search
    # (a nested split-join rebuilds the half and its input node)
    boundary_in._markers = frozenset({f"{token}:in"})
    boundary_in.outputs = [
        ParallelTensor(split.outputs[0].shape, name=f"{split.name}__b")]
    post.add_node(boundary_in)
    post_clone: dict[int, OpNode] = {split.guid: boundary_in}
    for n in post_nodes:
        post_clone[n.guid] = _clone_basic(post, n)
    for n in post_nodes:
        for e in g.in_edges[n.guid]:
            src = post_clone.get(e.src)
            if src is None:  # crosses the cut from deeper than split:
                # impossible for a bottleneck cut — every path crosses split
                raise ValueError("non-bottleneck split")
            src_idx = 0 if src is boundary_in else e.src_idx
            post.add_edge(src, post_clone[e.dst], src_idx, e.dst_idx)
    # compute-node clones carry no output tensors — rebuild parallel state
    propagate_parallel_state(pre)
    propagate_parallel_state(post)
    return pre, post, token


def _join(pre: Graph, post: Graph, token: str) -> Graph:
    """Merge optimized halves back into one graph: post's synthetic input
    collapses onto pre's (possibly rewritten) boundary node, each found by
    its token.

    The JAX package finds post's input by identity, which fails when the
    post half was itself split and joined (its nodes are clones then): the
    input stays a source, its edges are lost, and the joined graph falls
    into two parts, each priced as if it ran beside the other (ROADMAP
    queue C, reference-side; tests/test_torch_search.py)."""
    boundary_in = next(n for n in post.topo_order()
                       if f"{token}:in" in getattr(n, "_markers", ()))
    out = Graph()
    clone: dict[int, OpNode] = {}

    def copy_graph(g: Graph):
        for n in g.topo_order():
            if n is boundary_in:
                continue
            clone[n.guid] = _clone_basic(out, n)
        for n in g.topo_order():
            for e in g.in_edges[n.guid]:
                if g.nodes[e.src] is boundary_in:
                    continue  # rewired below
                out.add_edge(clone[e.src], clone[e.dst],
                             e.src_idx, e.dst_idx)

    copy_graph(pre)
    boundary = next(n for n in pre.topo_order()
                    if token in getattr(n, "_markers", ()))
    copy_graph(post)
    for n in post.topo_order():
        for e in post.in_edges[n.guid]:
            if post.nodes[e.src] is boundary_in:
                out.add_edge(clone[boundary.guid], clone[e.dst],
                             0, e.dst_idx)
    # this split's token is spent; nested splits' tokens stay intact
    bj = clone[boundary.guid]
    bj._markers = getattr(bj, "_markers", frozenset()) - {token}
    # cloned compute nodes carry no output tensors yet — rebuild the whole
    # graph's parallel state (clones of rewritten halves keep their
    # parallel ops, so degrees re-derive identically)
    propagate_parallel_state(out)
    return out


def joint_graph_optimize(
    graph: Graph,
    mesh,
    config,
    cost_model: Optional[CostModel] = None,
    _xfers=None,
    _segment_cache=None,
    _depth: int = 0,
):
    """Entry point: ONE search over rewrites × placements
    (GraphSearchHelper::graph_optimize + graph_optimize_task in one).

    Returns (graph, choice, UnitySearch) — the graph carries materialized
    placements; `us.to_strategy(choice)` gives the exportable searched half.
    Graphs larger than 4× base_optimize_threshold are sequence-split at a
    central bottleneck and the halves optimized independently (reference
    generic_sequence_optimize), with the boundary tensor materialized
    data-parallel — the same boundary-fixing the reference applies."""
    from .machine_model import machine_model_for_mesh

    cm = cost_model or CostModel(machine_model_for_mesh(mesh))
    if _xfers is None:
        if config.substitution_json_path:
            # external rules verify at load (the ffrules gate,
            # analysis/rules.py): an unsound JSON rule raises a
            # structured RuleVerificationError before it can reach the
            # search; --no-verify-rules downgrades to a warning
            _xfers = load_rule_collection(config.substitution_json_path,
                                          mesh, config=config)
        else:
            # built-in registry: swept by scripts/ffrules.py in CI
            _xfers = generate_all_pcg_xfers(mesh, config, graph)  # fflint: ok unverified_rule_load
    cache = _segment_cache if _segment_cache is not None else {}
    budget = config.search_budget or 16
    alpha = config.search_alpha

    split_threshold = max(16, 4 * config.base_optimize_threshold)
    split = (_find_split_node(graph)
             if _compute_size(graph) > split_threshold and _depth < 4
             else None)
    if split is not None:
        # sequence split: rewrite-search each half independently (shared
        # segment cache), join, then cost+refine the whole — the reference
        # stitches segment solutions the same way rather than re-running
        # base_optimize over the joined graph
        pre, post, token = _split_at(graph, split)
        pre, _, _ = joint_graph_optimize(
            pre, mesh, config, cm, _xfers, cache, _depth + 1)
        post, _, _ = joint_graph_optimize(
            post, mesh, config, cm, _xfers, cache, _depth + 1)
        best_g = _join(pre, post, token)
        _, best_choice, _ = _joint_cost(best_g, mesh, config, cm, cache)
    else:
        best_g, best_choice, _ = joint_base_optimize(
            graph, mesh, config, cm, _xfers, cache, budget, alpha)
    # refine only the winner (base_optimize-style single-node moves)
    us = UnitySearch(best_g, mesh, config, cm, segment_cache=cache,
                     pinned=derive_pinned_configs(best_g, mesh))
    best_choice = us._refine(best_choice)
    t, mem = us.evaluate(best_choice)
    best_cost = us._memory_penalized(t, mem)
    if best_g is not graph:
        # guarantee the joint result never loses to the pure placement DP:
        # candidates are ranked unrefined, so a rewrite that wins unrefined
        # can refine worse than the refined original — compare refined vs
        # refined and keep the better (optimal_cost in the reference plays
        # the same role of re-anchoring to the un-rewritten baseline)
        us0 = UnitySearch(graph, mesh, config, cm, segment_cache=cache,
                          pinned=derive_pinned_configs(graph, mesh))
        choice0 = us0.run()
        t0, m0 = us0.evaluate(choice0)
        cost0 = us0._memory_penalized(t0, m0)
        if cost0 < best_cost:
            best_g, best_choice, us = graph, choice0, us0
            best_cost = cost0
    if config.perform_memory_search:
        _, mem_f = us.evaluate(best_choice)
        if mem_f > cm.machine.chip.hbm_bytes:
            # λ binary search over the final graph's placements
            # (shared helper; graph_optimize_task, graph.cc:2056-2131)
            from .unity import lambda_memory_search

            best_choice, us = lambda_memory_search(
                lambda: UnitySearch(
                    best_g, mesh, config, cm, segment_cache=cache,
                    pinned=derive_pinned_configs(best_g, mesh)),
                cm.machine.chip.hbm_bytes)
    apply_choice_to_graph(best_g, mesh, best_choice)
    if _depth == 0:
        # one summary record per top-level search (recursive sequence-split
        # halves report through the shared best_first_search events);
        # guarded so the disabled path pays no extra topo_order()
        from .. import telemetry

        if telemetry.active_session() is not None:
            telemetry.event(
                "search", evals=us.evals, cache_hits=us.cache_hits,
                best_cost_s=best_cost, rewritten=best_g is not graph,
                nodes=len(best_g.topo_order()))
    return best_g, best_choice, us
