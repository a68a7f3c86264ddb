"""Pass 3 — collective-uniformity checker (twin of
`flexflow_tpu/analysis/collectives.py`).

SPMD collectives are correct only when every participant executes the
same schedule with the same arguments. Three checks:

1. **Ring permutations are complete bijections.** Every ring body of the
   port (ring attention's KV rotation, the decomposed allgather-matmul,
   the ring reduce-scatter and all-gather, the hop calibrator) takes its
   send/receive peers from ONE shared helper —
   `parallel.ops.ring_permutation(n)` — and this pass validates that
   helper's output for every ring size the plan can run: each source
   exactly once, each destination exactly once, full coverage of
   range(n). A partial or duplicated permutation leaves a rank waiting
   on a send nobody posts, or drops a shard. (The pipeline's one-sided
   neighbour send in parallel/pipeline.py is deliberately partial and is
   not a ring; it is exempt by construction.)

2. **Reduce-scatter bucket order is deterministic.** The sharded weight
   update's per-layer buckets must be emitted in topological order —
   the order `Executor._build_update_specs` walks — on every rank; a
   bucket order derived from an unordered container would interleave
   differently across ranks and deadlock the collective stream.

3. **No collective behind a coordinator-only branch.** The
   `distributed.broadcast_json` idiom gates the PAYLOAD on
   `is_coordinator()`, never the collective; a collective inside the
   branch deadlocks the mesh. Checked at the source level (lint rule
   `coordinator_collective`) over the port's runtime modules.
"""

from __future__ import annotations

from ..fftype import OperatorType as OT
from .findings import Finding, SEV_ERROR, SEV_INFO
from .sources import runtime_findings

PASS_NAME = "collective_uniformity"


def check_permutation(perm, n: int, where: str = "") -> list[Finding]:
    """Validate one ring permutation: a complete bijection on range(n)."""
    findings: list[Finding] = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    problems = []
    if sorted(srcs) != list(range(n)):
        problems.append(f"sources {sorted(set(srcs))} != 0..{n - 1}")
    if sorted(dsts) != list(range(n)):
        problems.append(f"destinations {sorted(set(dsts))} != 0..{n - 1}")
    oob = [(s, d) for s, d in perm
           if not (0 <= s < n and 0 <= d < n)]
    if oob:
        problems.append(f"out-of-range pairs {oob[:4]}")
    if problems:
        findings.append(Finding(
            SEV_ERROR, "bad_permutation",
            f"ring permutation over {n} shards is not a complete "
            f"bijection ({'; '.join(problems)}) — a missing peer leaves "
            f"a rank waiting or drops a shard, corrupting the ring",
            where=where,
            details={"n": n, "perm": [list(p) for p in perm[:16]]}))
    return findings


def _ring_ops(graph, axis_sizes) -> list[tuple[str, int]]:
    """(where, ring size) for every op in the plan that lowers to a ring
    schedule on this mesh — attribution for the per-size builder check
    below."""
    from ..machine import AXIS_SEQ

    out = []
    seq_deg = axis_sizes.get(AXIS_SEQ, 1)
    for node in graph.topo_order():
        impl = getattr(node.params, "impl", "")
        if (node.op_type == OT.OP_MULTIHEAD_ATTENTION
                and impl == "ring" and seq_deg > 1):
            out.append((f"{node.name} (ring attention over "
                        f"{AXIS_SEQ}={seq_deg})", seq_deg))
    return out


def run(graph, mesh, ctx=None) -> list[Finding]:
    from ..parallel.ops import ring_permutation

    axis_sizes = {k: int(v) for k, v in dict(mesh.shape).items()}
    findings: list[Finding] = []

    # 1) ring permutations: validate the SHARED schedule builder
    # (parallel.ops.ring_permutation) once per DISTINCT ring size any
    # ring body could run over on this mesh — every axis of size > 1,
    # not just the ops the plan names; the plan's own ring ops (+ the
    # sharded update's reduce-scatter axes) attach as attribution in
    # the finding's `where`.
    rings = _ring_ops(graph, axis_sizes)
    update_specs = (getattr(ctx, "update_specs", None)
                    if ctx is not None else None) or {}
    update_axes = sorted({
        ax for spec, _shape in update_specs.values()
        for entry in spec if entry is not None
        for ax in (entry if isinstance(entry, tuple) else (entry,))})
    for ax in update_axes:
        n = axis_sizes.get(ax, 1)
        if n > 1:
            rings.append((f"weight-update reduce-scatter over {ax}={n}",
                          n))
    checked = 0
    for n in sorted({s for s in axis_sizes.values() if s > 1}):
        axes = sorted(a for a, s in axis_sizes.items() if s == n)
        users = [w for w, rn in rings if rn == n]
        where = (f"axes {axes} (size {n})"
                 + (f": {'; '.join(users)}" if users else ""))
        findings.extend(check_permutation(ring_permutation(n), n, where))
        checked += 1

    # 2) reduce-scatter bucket order: the update-spec emission order must
    # follow the topological schedule (the order GSPMD sees the pins)
    if update_specs:
        topo_pos = {n.name: i for i, n in enumerate(graph.topo_order())}
        seq = [topo_pos.get(node_name, -1)
               for (node_name, _w) in update_specs.keys()]
        known = [p for p in seq if p >= 0]
        if known != sorted(known):
            findings.append(Finding(
                SEV_ERROR, "nondeterministic_bucket_order",
                "weight-update buckets are not emitted in topological "
                "order — per-host divergence in reduce-scatter issue "
                "order deadlocks the collective stream",
                details={"positions": known[:32]}))

    # 3) coordinator-only collectives in the runtime host code (plus,
    # once, any scan-infrastructure failure — unparseable module —
    # downgraded to warning by the analysis_crash policy)
    from .sources import scan_problems

    findings.extend(runtime_findings(("coordinator_collective",)))
    findings.extend(scan_problems())

    if not findings:
        findings.append(Finding(
            SEV_INFO, "collectives_clean",
            f"{checked} ring schedule(s) bijective, "
            f"{len(update_specs)} update bucket(s) in deterministic "
            f"order, no coordinator-gated collectives"))
    return findings
