"""Pass 2 — static memory liveness over the fwd+bwd schedule (twin of
`flexflow_tpu/analysis/memory.py`).

The cost model prices per-chip memory as a per-op SUM (op_cost's
weight_mem + act_bytes, the MemoryUsage analog); that is an upper bound
with no notion of WHEN bytes are live. This pass walks the training
step's actual schedule — forward in topo order (activations retained for
the backward), then backward in reverse (activations freed after their
VJP consumes them, transient activation-gradients live across each bwd
op) — and produces:

- a per-op memory TIMELINE (phase, op, live bytes) so an OOM is
  attributable to the op where the peak lands, before it ever reaches
  the device;
- the static peak per-chip HBM, counting fp32 masters, gradients,
  optimizer slots, and the weight-update sharding layout
  (`executor.update_specs` — masters/slots at 1/shards, one gathered
  compute copy), using the SAME per-buffer accounting rules as
  `CostModel.op_cost` so the two estimates are commensurable;
- a cross-check against the cost model's own estimate
  (`memory_model_divergence` when they disagree beyond the transient
  slack liveness legitimately adds).

The port's executor holds buffers the JAX package's does not. `analyze`
keeps JAX's terms exactly (the parity tests hold them to the byte) and
`port_terms` adds each extra buffer class BY NAME:

- `bf16_weight_copies` — a training step under a narrower compute dtype
  casts every trainable master once (`Executor._cast_compute`); autograd
  keeps the copies until the backward (ROADMAP G2);
- `serving_weight_cache` — an inference compile serves from
  `Executor.compute_params`' compute-dtype copy of every weight;
- `graph_static_inputs` — a captured step (`CapturedStep`, CUDA only)
  copies each non-held argument, the batch, into buffers the graph keeps
  for its lifetime.

The OOM gate compares the port's peak (JAX's liveness peak plus these
terms) with the cap, and adds the same terms to the cost model's figure.

OOM gating is deliberately two-keyed: `oom_predicted` is an ERROR only
when BOTH accountings (liveness peak and the cost-model sum) exceed the
per-chip cap — the gate must never abort a plan the priced search
already accepted as fitting on a number the search never saw — and a
WARNING when liveness alone crosses the cap.
"""

from __future__ import annotations

import math

from ..fftype import OperatorType as OT
from ..fftype import UnportedOperatorType as UOT
from .findings import Finding, SEV_ERROR, SEV_INFO, SEV_WARNING

PASS_NAME = "memory_liveness"

_SKIP = (OT.OP_INPUT, UOT.OP_WEIGHT, UOT.OP_NOOP)
_TIMELINE_CAP = 512


def _shard_bytes(shape, assignment, axis_sizes, el_bytes) -> float:
    n = 1.0
    for i, dim in enumerate(shape):
        deg = 1
        if assignment and i < len(assignment):
            for ax in assignment[i]:
                deg *= axis_sizes.get(ax, 1)
        n *= max(1, math.ceil(dim / deg))
    return n * el_bytes


def _logical_assignment(pt):
    return tuple(a for d, a in zip(pt.shape.dims, pt.axis_assignment)
                 if not d.is_replica_dim)


def analyze(graph, mesh, *, opt_slots: int = 1, update_specs=None,
            training: bool = True, update_stage: int = 0) -> dict:
    """Static per-chip memory model of one training (or inference) step.
    Returns {persistent_bytes, peak_bytes, peak_at, timeline,
    weight_bytes, activation_bytes, gather_peak_bytes}.

    `update_stage` 3 (ZeRO-3/FSDP) changes the sharded weights'
    accounting: the resident gathered compute copy leaves the persistent
    set (weights live 1/shards at rest) and each op's gathered copies
    become a TRANSIENT in the timeline — the op's own gather plus the
    one-layer-ahead prefetch, so at most two gathered layers are in
    flight at any point of the fwd (and of the bwd, which re-gathers in
    reverse order). This is the accounting the acceptance criterion's
    "1/shards at rest + transient gather" check verifies."""
    from ..search.cost_model import dtype_bytes
    from ..tensor import spec_assignment as _spec_assignment

    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    update_specs = update_specs or {}
    order = graph.topo_order()
    stage3 = update_stage >= 3 and training

    # ---- persistent: masters + grads + optimizer slots (+ the gathered
    # compute copy under a sharded update), per the op_cost rules. An
    # inference compile (serving decode graphs) carries NO grads or
    # optimizer state — trainable weights cost 1x, not (2 + opt_slots)x,
    # or a trained-then-served model would overstate its footprint ~3x
    # and trip the OOM gate on a serving launch that actually fits.
    persistent = 0.0
    weight_bytes = 0.0
    # stage 3: per owning node, the FULL bytes of its gathered weight
    # copies — a transient charged while the node (or its one-ahead
    # prefetch) is in flight, not a persistent resident
    gather_of: dict[int, float] = {}
    for node in order:
        if getattr(node, "weight_source", None):
            continue  # tied weights live under the source node
        for ws in node.weight_specs:
            el = dtype_bytes(ws.dtype)
            base = _spec_assignment(
                node.weight_axes.get(ws.name), len(ws.shape))
            wb = _shard_bytes(ws.shape, base, axis_sizes, el)
            upd = update_specs.get((node.name, ws.name))
            if not ws.trainable or not training:
                persistent += wb
                weight_bytes += wb
            elif upd is not None:
                rest = _shard_bytes(
                    ws.shape, _spec_assignment(upd[0], len(ws.shape)),
                    axis_sizes, el)
                if stage3:
                    # weights 1/shards at rest; the gathered copy is a
                    # transient (two layers in flight, charged below)
                    persistent += rest * (2 + opt_slots)
                    weight_bytes += rest * (2 + opt_slots)
                    gather_of[node.guid] = gather_of.get(
                        node.guid, 0.0) + wb
                else:
                    # gathered compute copy + master/grad/slots at
                    # 1/shards (stage 2)
                    persistent += wb + rest * (2 + opt_slots)
                    weight_bytes += wb + rest * (2 + opt_slots)
            else:
                persistent += wb * (2 + opt_slots)
                weight_bytes += wb * (2 + opt_slots)

    # ---- activation liveness: fwd retains every activation for the
    # backward; bwd frees each node's inputs after its VJP runs and
    # carries the output-gradient transiently
    act_bytes_of: dict[tuple[int, int], float] = {}
    for node in order:
        for i, pt in enumerate(node.outputs):
            shape = pt.shape.logical_shape
            act_bytes_of[(node.guid, i)] = _shard_bytes(
                shape, _logical_assignment(pt), axis_sizes,
                dtype_bytes(pt.dtype))

    timeline: list[dict] = []
    live = persistent
    peak = persistent
    peak_at = "(weights)"
    compute_nodes = [n for n in order if n.op_type not in _SKIP]
    total_act = 0.0
    # stage-3 transient gather in flight per schedule position: the
    # node's own gathered copies + the one-layer-ahead prefetch (fwd:
    # the NEXT gathering node; bwd: the PREVIOUS one — the reverse walk
    # prefetches in reverse). At most two gathered layers live at once.
    g = [gather_of.get(n.guid, 0.0) for n in compute_nodes]
    nxt_g = [0.0] * len(g)
    run = 0.0
    for t in range(len(g) - 1, -1, -1):
        nxt_g[t] = run
        if g[t] > 0:
            run = g[t]
    prv_g = [0.0] * len(g)
    run = 0.0
    for t in range(len(g)):
        prv_g[t] = run
        if g[t] > 0:
            run = g[t]
    fwd_inflight = [a + b for a, b in zip(g, nxt_g)]
    bwd_inflight = [a + b for a, b in zip(g, prv_g)]
    gather_peak = max(fwd_inflight + bwd_inflight, default=0.0)
    # inference: no backward retains anything — an activation dies after
    # its LAST consumer in the topo schedule
    last_use: dict[tuple[int, int], int] = {}
    free_at: dict[int, list] = {}
    if not training:
        # only compute-node outputs ever enter `live` below — freeing an
        # OP_INPUT producer's bytes would subtract what was never added
        # and understate every later timeline entry
        compute_guids = {n.guid for n in compute_nodes}
        for t, node in enumerate(compute_nodes):
            for e in graph.in_edges[node.guid]:
                if e.src not in compute_guids:
                    continue
                key = (e.src, e.src_idx)
                last_use[key] = max(last_use.get(key, -1), t)
        for key, last in last_use.items():
            free_at.setdefault(last, []).append(key)
    for t, node in enumerate(compute_nodes):
        for i in range(len(node.outputs)):
            b = act_bytes_of.get((node.guid, i), 0.0)
            live += b
            total_act += b
        here = live + fwd_inflight[t]
        timeline.append({"phase": "fwd", "op": node.name,
                         "live_bytes": here})
        if here > peak:
            peak, peak_at = here, f"fwd:{node.name}"
        if not training:
            for key in free_at.get(t, ()):
                live -= act_bytes_of.get(key, 0.0)
    if training:
        for t in range(len(compute_nodes) - 1, -1, -1):
            node = compute_nodes[t]
            # transient: the cotangent of this node's output(s) — and,
            # under stage 3, its re-gathered weight copies — coexists
            # with the still-retained forward activations
            grad = sum(act_bytes_of.get((node.guid, i), 0.0)
                       for i in range(len(node.outputs)))
            here = live + grad + bwd_inflight[t]
            if here > peak:
                peak, peak_at = here, f"bwd:{node.name}"
            timeline.append({"phase": "bwd", "op": node.name,
                             "live_bytes": here})
            for i in range(len(node.outputs)):
                live -= act_bytes_of.get((node.guid, i), 0.0)
    return {
        "persistent_bytes": persistent,
        "weight_bytes": weight_bytes,
        "activation_bytes": total_act,
        "peak_bytes": peak,
        "peak_at": peak_at,
        "gather_peak_bytes": gather_peak,
        "timeline": timeline[:_TIMELINE_CAP],
    }


def port_terms(graph, mesh, *, training: bool = True,
               compute_dtype=None, device_type: str = "cpu") -> dict:
    """The per-chip bytes of the port's buffers JAX's executor does not
    hold, by name (module docstring). `compute_dtype` is the config's
    `computation_dtype` (a DataType or None)."""
    from ..fftype import DataType, dtype_to_torch
    from ..tensor import spec_assignment

    def nbytes(dt) -> int:
        # the element's real size (the cost model's table counts bf16 as
        # 4 bytes, as the JAX package's does)
        return dtype_to_torch(DataType(dt)).itemsize

    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    cd_bytes = nbytes(compute_dtype) if compute_dtype is not None else 0
    copies = 0.0
    for node in graph.topo_order():
        if getattr(node, "weight_source", None):
            continue
        for ws in node.weight_specs:
            if not cd_bytes or cd_bytes >= nbytes(ws.dtype) \
                    or DataType(ws.dtype) not in (
                        DataType.DT_FLOAT, DataType.DT_DOUBLE):
                continue
            if training and not ws.trainable:
                continue
            copies += _shard_bytes(
                ws.shape, spec_assignment(node.weight_axes.get(ws.name),
                                          len(ws.shape)),
                axis_sizes, cd_bytes)
    static = 0.0
    if device_type == "cuda":
        for node in graph.topo_order():
            if node.op_type != OT.OP_INPUT or getattr(node, "constant",
                                                      None) is not None:
                continue
            for pt in node.outputs:
                static += _shard_bytes(
                    pt.shape.logical_shape, _logical_assignment(pt),
                    axis_sizes, nbytes(pt.dtype))
    return {
        "bf16_weight_copies": copies if training else 0.0,
        "serving_weight_cache": 0.0 if training else copies,
        "graph_static_inputs": static,
    }


def _cost_model_memory(graph, cost_model) -> float:
    """The pricer's own per-chip memory figure on the materialized
    assignments (the Σ op_cost memory the search/update-sharding decision
    consumed) — the number this pass cross-checks against."""
    mem = 0.0
    gather_peak = 0.0
    for node in graph.topo_order():
        if node.op_type in _SKIP or node.is_parallel_op:
            continue
        in_shapes = [pt.shape.logical_shape for pt in node.inputs]
        in_assigns = [_logical_assignment(pt) for pt in node.inputs]
        cmx = cost_model.op_cost(
            node, [_logical_assignment(pt) for pt in node.outputs],
            dict(node.weight_axes), in_shapes, in_assigns)
        mem += cmx.memory
        gather_peak = max(gather_peak, cmx.gather_bytes)
    # stage 3: the evaluators' two-gathered-layers-in-flight charge —
    # the same rule, so the cross-check stays commensurable
    return mem + 2.0 * gather_peak


def run(graph, mesh, ctx=None) -> list[Finding]:
    opt_slots = getattr(ctx, "opt_slots", 1) if ctx is not None else 1
    update_specs = (getattr(ctx, "update_specs", None)
                    if ctx is not None else None)
    update_stage = (getattr(ctx, "update_stage", 0)
                    if ctx is not None else 0)
    training = getattr(ctx, "training", True) if ctx is not None else True
    cap = getattr(ctx, "hbm_cap_bytes", 0.0) if ctx is not None else 0.0
    cost_model = getattr(ctx, "cost_model", None) if ctx is not None \
        else None

    m = analyze(graph, mesh, opt_slots=opt_slots,
                update_specs=update_specs, training=training,
                update_stage=update_stage)
    config = getattr(ctx, "config", None) if ctx is not None else None
    extra = port_terms(
        graph, mesh, training=training,
        compute_dtype=getattr(config, "computation_dtype", None),
        device_type=getattr(ctx, "device_type", "cpu")
        if ctx is not None else "cpu")
    extra_bytes = sum(extra.values())
    # the card's peak: JAX's liveness peak plus the port's own buffers
    peak = m["peak_bytes"] + extra_bytes
    findings: list[Finding] = []
    top = sorted(m["timeline"], key=lambda t: -t["live_bytes"])[:8]
    details = {
        "peak_bytes": m["peak_bytes"],
        "peak_at": m["peak_at"],
        "persistent_bytes": m["persistent_bytes"],
        "weight_bytes": m["weight_bytes"],
        "activation_bytes": m["activation_bytes"],
        "gather_peak_bytes": m.get("gather_peak_bytes", 0.0),
        "update_stage": update_stage,
        "hbm_cap_bytes": cap,
        "top_live": top,
        "port_terms": extra,
        "port_peak_bytes": peak,
    }

    cm_mem = None
    if cost_model is not None:
        try:
            cm_mem = _cost_model_memory(graph, cost_model)
            details["cost_model_bytes"] = cm_mem
        except Exception as e:
            # the cross-check degrading to unavailable must be VISIBLE:
            # it silently downgrades the OOM gate below to warning-only
            cm_mem = None
            details["cost_model_error"] = f"{type(e).__name__}: {e}"
    findings.append(Finding(
        SEV_INFO, "memory_timeline",
        f"static peak {m['peak_bytes'] / 2**20:.2f} MiB/chip at "
        f"{m['peak_at']} (persistent "
        f"{m['persistent_bytes'] / 2**20:.2f} MiB; with the port's "
        f"buffers {peak / 2**20:.2f} MiB)",
        details=details))

    if cm_mem is not None and cm_mem > 0:
        ratio = m["peak_bytes"] / cm_mem
        # liveness legitimately adds transient cotangent slack above the
        # pricer's Σ and legitimately frees nothing below it at this
        # granularity; a large gap either way means the two accountings
        # drifted (a new buffer class one of them does not know about)
        if ratio > 1.5 or ratio < 0.1:
            findings.append(Finding(
                SEV_WARNING, "memory_model_divergence",
                f"liveness peak {m['peak_bytes'] / 2**20:.2f} MiB vs "
                f"cost-model estimate {cm_mem / 2**20:.2f} MiB "
                f"(ratio {ratio:.2f}) — the accountings drifted",
                details={"peak_bytes": m["peak_bytes"],
                         "cost_model_bytes": cm_mem}))

    if cap and cap > 0 and peak > cap:
        # two-keyed on purpose (module docstring): ERROR only when both
        # accountings exceed the cap; liveness alone — including when
        # the cost-model estimate is unavailable — stays a warning, so a
        # verifier-side accounting gap can never abort a plan the priced
        # search accepted as fitting
        both = cm_mem is not None and cm_mem + extra_bytes > cap
        timeline_head = [t for t in m["timeline"]
                         if t["live_bytes"] + extra_bytes > cap][:4]
        findings.append(Finding(
            SEV_ERROR if both else SEV_WARNING,
            "oom_predicted",
            f"predicted per-chip HBM {peak / 2**20:.2f} MiB "
            f"exceeds the {cap / 2**20:.2f} MiB cap at {m['peak_at']}"
            + ("" if both
               else " (liveness only — cost-model estimate "
                    + ("unavailable" if cm_mem is None
                       else "disagrees") + ")"),
            details={"peak_bytes": peak, "cap_bytes": cap,
                     "peak_at": m["peak_at"],
                     "first_over_cap": timeline_head}))
    return findings
