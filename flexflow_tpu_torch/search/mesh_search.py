"""Mesh factorization search (twin of `flexflow_tpu/search/mesh_search.py`),
the machine-view *grid-shape* half of Unity.

The reference's search ranges over MachineViews: device sub-grids of any
shape, so an op can be split 2-way on an 8-GPU machine simply by taking a
2-device view (graph.cc's view enumeration over numNodes × workersPerNode,
substitution.cc:1726-1868 instantiates rewrites per divisor degree). Here a
dim shards over WHOLE named mesh axes, so intermediate degrees are reached
by re-factorizing the global device mesh itself —
8 devices = (data 8) | (data 4, model 2) | (data 2, model 4) | (model 8) | …

This module enumerates the factorizations of the chip count over the named
axes, runs the joint rewrite × placement search (`joint_graph_optimize`)
on each candidate mesh, and returns the best. Together with the per-axis /
composite-axis rewrite instantiation in `generate_all_pcg_xfers`, every
divisor of the chip count is expressible on some candidate, closing the
divisor-degree gap a fixed mesh leaves open.

Enabled with --search-mesh-shapes (consumed by FFModel.compile)."""

from __future__ import annotations

from typing import Optional

from ..machine import AXIS_DATA, AXIS_MODEL
from .cost_model import CostModel
from .machine_model import machine_model_for_mesh


class MeshSpec:
    """Shape-only stand-in for a Mesh during costing (the search
    stack only reads `.shape`); `build_mesh` materializes the winner."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)

    def __repr__(self):
        return f"MeshSpec({self.shape})"


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_factorizations(n_devices: int,
                             axes: tuple = (AXIS_DATA, AXIS_MODEL)
                             ) -> list[dict]:
    """All ordered factorizations of the chip count over `axes` (size-1
    axes allowed — (data=8, model=1) is plain DP)."""
    if not axes:
        return [{}] if n_devices == 1 else []
    out = []
    for d in _divisors(n_devices):
        for rest in enumerate_factorizations(n_devices // d, axes[1:]):
            out.append({axes[0]: d, **rest})
    return out


def clone_graph(graph):
    """Deep-copy a PCG (nodes + edges + weight metadata) so each candidate
    mesh's rewrite search mutates its own copy."""
    from ..pcg.graph import Graph
    from .joint import _clone_basic
    from .substitution import propagate_parallel_state

    out = Graph()
    clone = {}
    for n in graph.topo_order():
        clone[n.guid] = _clone_basic(out, n)
    for n in graph.topo_order():
        for e in graph.in_edges[n.guid]:
            out.add_edge(clone[e.src], clone[e.dst], e.src_idx, e.dst_idx)
    propagate_parallel_state(out)
    return out


def search_mesh_shapes(
    graph,
    n_devices: int,
    config,
    axes: tuple = (AXIS_DATA, AXIS_MODEL),
    chip=None,
    num_hosts: int = 1,
    calibrated: Optional[CostModel] = None,
    machine_factory=None,
):
    """Run the joint search once per mesh factorization; return
    (best_shape_dict, best_graph, best_choice, best_search, results) where
    `results` is [(shape_dict, cost), ...] for every candidate (the
    unity_vs_dp-style artifact). The input graph is never mutated.

    A calibrated CostModel's measurements transfer across candidates (they
    are per-op, mesh-independent), but each candidate needs its own machine
    model — pass `calibrated` to reuse measurements; its machine is
    replaced per candidate. `machine_factory(mesh) -> TPUMachineModel`
    overrides the analytic default (e.g. machine_model_from_file, so the
    file's topology/congestion fidelity survives the shape search)."""
    from .. import telemetry
    from .joint import joint_graph_optimize

    best = None
    results = []
    skipped: list = []
    for sizes in enumerate_factorizations(n_devices, axes):
        mesh = MeshSpec(sizes)
        machine = (machine_factory(mesh) if machine_factory is not None
                   else machine_model_for_mesh(mesh, chip=chip,
                                               num_hosts=num_hosts))
        cm = CostModel(machine,
                       opt_slots=(calibrated.opt_slots if calibrated else 1))
        if calibrated is not None:
            cm._calibration = calibrated._calibration
        g = clone_graph(graph)
        shape_label = ",".join(f"{a}={d}" for a, d in sizes.items())
        try:
            with telemetry.span("mesh_search.candidate", shape=shape_label):
                g, choice, us = joint_graph_optimize(g, mesh, config, cm)
        except ValueError as e:
            # a factorization the graph cannot shard onto (e.g. batch not
            # divisible): skip it rather than abort the search — but keep
            # the reason, so an every-candidate failure (a search bug, not
            # an unshardable graph) surfaces with diagnostics
            skipped.append((dict(sizes), str(e)))
            telemetry.event("mesh_candidate", shape=dict(sizes),
                            skipped=str(e))
            continue
        t, mem = us.evaluate(choice)
        cost = us._memory_penalized(t, mem)
        results.append((dict(sizes), cost))
        if best is None or cost < best[4]:
            best = (dict(sizes), g, choice, us, cost)
        # per-candidate record: cost + running best — the mesh-shape half
        # of the best-cost-so-far curve
        telemetry.event("mesh_candidate", shape=dict(sizes), cost_s=cost,
                        best_cost_s=best[4], evals=us.evals,
                        cache_hits=us.cache_hits)
        telemetry.counter("mesh_search.best_cost_ms",
                          {"cost": best[4] * 1e3})
    if best is None:
        detail = "; ".join(f"{s}: {r}" for s, r in skipped[:4])
        raise ValueError(
            f"no mesh factorization of {n_devices} devices over {axes} "
            f"admits this graph — per-candidate reasons: {detail}")
    shape, g, choice, us, _ = best
    return shape, g, choice, us, results
