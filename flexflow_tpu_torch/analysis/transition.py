"""fftrans — static plan-transition verifier with priced migration plans
(twin of `flexflow_tpu/analysis/transition.py`).

ffcheck (analysis/) verifies every SINGLE plan before it touches device
memory; this module verifies the TRANSITION between two plans for the
same PCG: a checkpoint's and the restoring compile's (the elastic-resume
path, `resilience/reshard.verify_restore_transition`), or two compiled
models'. An incompatibility (a dropped weight mapping, dtype drift, a
stage-3 at-rest shard re-placed without a gather path, transition-time
OOM with both layouts resident) is a finding before any tensor is
written, not a shape crash or silent corruption mid-restore. Gemini
(SOSP '23, PAPERS.md) motivates in-memory migration; GSPMD (Xu et al.
2021) is the model for deriving the transfer program statically from
the two sharding assignments alone.

Given two `PlanSide`s — a compiled model (`PlanSide.from_model`: every
`model_state_tree` leaf with its LOGICAL shape and the executor's at-rest
placement) or a checkpoint's flat arrays + manifest
(`PlanSide.from_checkpoint`) — `build_transition_plan` derives a
**TransitionPlan**: one `transfer` per state leaf, each carrying the
source→dest sharding pair and the transfer collectives the move needs
(all_gather to unwind source shards, all_to_all for axis moves, free
local slices into the dest layout, a host hop when the source is a
checkpoint or the meshes share no layout). The plan is priced through
the cost model (`search/cost_model.price_transfer_collective`) and
verified by `verify_transition`:

  state_mapping          every old leaf maps (`dropped_state`), every
                         new leaf has a source (`unmapped_state`),
                         dtypes/shapes preserved (`state_dtype_change` /
                         `state_shape_change`), update-stage changes
                         route through a gather path
                         (`missing_gather_path`), KV pool geometry
                         matches (`kv_pool_mismatch`)
  transition_memory      per-chip peak over the transfer schedule, old
                         shard + new shard + transfer buffer, source
                         shards released as each transfer lands
                         (`transition_oom`, two-keyed like ffcheck's)
  transfer_collectives   ring-permutation bijectivity
                         (`bad_transfer_permutation`) and topological
                         transfer order (`nontopological_transfer_order`)
  migration_donation     no source leaf released twice
                         (`migration_donation_hazard`)
  transfer_uniformity    the schedule digest re-derives from the sorted
                         canonical entries alone
                         (`transfer_schedule_divergence`)

The plan serializes into strategy_report.json as a `transition` section:
`verify_transition_total` recomputes `predicted_s` from the per-transfer
entries ALONE (host hops serialize with everything, traffic on one mesh
axis serializes, disjoint axes overlap). The in-process migration that
executes a verified plan on live state is `resilience/migrate.py`
(`migrate_state`), which the elastic re-planner (elastic/) drives.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Optional

from .findings import (
    AnalysisResult,
    Finding,
    PlanVerificationError,
    SEV_ERROR,
    SEV_INFO,
)

PASS_NAMES = ("state_mapping", "transition_memory", "transfer_collectives",
              "migration_donation", "transfer_uniformity")

_TIMELINE_CAP = 256

# state-leaf name prefixes that identify serving KV block pools / caches
# (first-class non-trainable stateful parallel tensors, serving/): their
# geometry is load-bearing — a pool cannot be repacked to a different
# block size by a plain reshard, so mismatches get their own finding
# class instead of the generic shape check
_KV_POOL_PREFIXES = ("pool_k", "pool_v")
_KV_CACHE_PREFIXES = ("pool_k", "pool_v", "cache_k", "cache_v")


def _np_dtype_name(x) -> str:
    """The numpy spelling of a leaf's dtype ("float32", "bfloat16"), for
    torch tensors and numpy arrays alike: the name the JAX package
    records."""
    import numpy as np

    dt = getattr(x, "dtype", None)
    if dt is None:
        return str(np.asarray(x).dtype)
    if isinstance(dt, np.dtype):
        return str(dt)
    return str(dt).replace("torch.", "")


def _itemsize(name: str) -> int:
    """Bytes of one element of a dtype named as `_np_dtype_name` names
    it (numpy lacks bfloat16; torch has every name the port stores)."""
    import torch

    if not name:
        return 4
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    import numpy as np

    return int(np.dtype(name).itemsize)


def _shard_bytes(shape, assignment, axis_sizes, el_bytes) -> float:
    n = 1.0
    for i, dim in enumerate(shape):
        deg = 1
        if assignment and i < len(assignment):
            for ax in assignment[i]:
                deg *= axis_sizes.get(ax, 1)
        n *= max(1, math.ceil(dim / deg))
    return n * el_bytes


def _leaf_layout(executor, path: tuple, leaf) -> tuple:
    """(logical shape, per-dim axis tuples) of one live leaf: a weight
    leaf (a master, a slot, a state tensor) has the weight's logical
    shape and the executor's at-rest placement; every other leaf (step,
    counters, the generator) is whole on every rank."""
    from ..resilience.reshard import _weight_of

    w = _weight_of(executor, path, leaf)
    if w is not None:
        return (tuple(executor.weight_shape(*w)),
                tuple(executor._rest_layout(*w)))
    shape = tuple(getattr(leaf, "shape", ()) or ())
    return shape, ((),) * len(shape)


@dataclass
class LeafInfo:
    """One state leaf on one side of the transition. `key` is the
    checkpoint flat-key space (`checkpointer._keystr` over
    `model_state_tree`), so the restore path and this verifier name
    leaves identically, and as the JAX package does."""

    key: str
    shape: tuple
    dtype: str
    # per-dim tuples of mesh-axis names; None = host-resident (a
    # checkpoint's flat arrays) or unsharded scalar
    assignment: Optional[tuple] = None
    # carries a ZeRO at-rest update sharding (stage >= 2 masters/slots,
    # stage 3 params) — the leaves whose re-placement REQUIRES a gather
    update_sharded: bool = False
    kv_pool: bool = False
    # schedule position: dst-graph topological position of the owning
    # node (scalars/RNG ride last); the transfer order key
    topo_pos: int = 1 << 30


@dataclass
class PlanSide:
    """Everything the transition verifier needs to know about one side."""

    leaves: dict = field(default_factory=dict)  # key -> LeafInfo
    axis_sizes: dict = field(default_factory=dict)
    update_stage: int = 0
    plan_source: str = "none"
    kv_block_size: Optional[int] = None
    on_device: bool = True
    label: str = ""

    @staticmethod
    def from_model(model, label: str = "") -> "PlanSide":
        """Capture a compiled FFModel's full training/serving state
        layout: every `model_state_tree` leaf's logical shape, dtype and
        at-rest placement, plus the mesh, ZeRO stage and KV geometry."""
        from ..fftype import OperatorType as OT
        from ..resilience.checkpointer import _keystr, tree_items
        from ..resilience.reshard import model_state_tree

        side = PlanSide(
            axis_sizes={k: int(v) for k, v in dict(model.mesh.shape).items()},
            update_stage=int((getattr(model, "_update_sharding", None)
                              or {}).get("stage", 0)),
            plan_source=getattr(model, "_plan_source", "none"),
            on_device=True,
            label=label or "model",
        )
        topo_pos = {n.name: i for i, n in enumerate(model.graph.topo_order())}
        has_paged = any(
            n.op_type == OT.OP_PAGED_INC_MULTIHEAD_ATTENTION
            for n in model.graph.topo_order())
        if has_paged:
            side.kv_block_size = int(model.config.serve_kv_block_size)
        upd_keys = {k for k in (model.executor.update_specs or {})} \
            if model.executor is not None else set()
        for path, leaf in tree_items(model_state_tree(model)):
            key = _keystr(path)
            keys = tuple(k for k in path if isinstance(k, str))
            wname = keys[-1] if keys else ""
            shape, assignment = _leaf_layout(model.executor, path, leaf)
            side.leaves[key] = LeafInfo(
                key=key,
                shape=shape,
                dtype=_np_dtype_name(leaf),
                assignment=assignment,
                update_sharded=(len(keys) >= 2
                                and keys[-2:] in upd_keys),
                kv_pool=any(str(wname).startswith(p)
                            for p in _KV_CACHE_PREFIXES),
                topo_pos=topo_pos.get(keys[-2] if len(keys) >= 2 else "",
                                      1 << 30),
            )
        return side

    @staticmethod
    def from_checkpoint(flat_arrays: dict, manifest: dict,
                        label: str = "") -> "PlanSide":
        """Capture a committed checkpoint's state layout from its flat
        arrays + manifest alone: host-resident whole logical arrays (the
        save gathers shards), mesh/stage from the manifest extras — what
        the WRITER ran, recorded for the report."""
        extras = dict(manifest.get("extras") or {})
        upd = dict(extras.get("update_sharding") or {})
        side = PlanSide(
            axis_sizes={k: int(v)
                        for k, v in (extras.get("mesh_axes") or {}).items()},
            update_stage=int(upd.get("stage", 0)),
            plan_source="checkpoint",
            on_device=False,
            label=label or "checkpoint",
        )
        for key in sorted(flat_arrays):
            arr = flat_arrays[key]
            wname = key.rsplit("['", 1)[-1].rstrip("]'")
            side.leaves[key] = LeafInfo(
                key=key,
                shape=tuple(getattr(arr, "shape", ())),
                dtype=_np_dtype_name(arr),
                assignment=None,
                kv_pool=any(str(wname).startswith(p)
                            for p in _KV_CACHE_PREFIXES),
            )
        return side

    def to_json(self) -> dict:
        out = {
            "label": self.label,
            "mesh_axes": dict(self.axis_sizes),
            "update_stage": self.update_stage,
            "plan_source": self.plan_source,
            "on_device": self.on_device,
            "leaves": len(self.leaves),
        }
        if self.kv_block_size is not None:
            out["kv_block_size"] = self.kv_block_size
        return out


# ------------------------------------------------------------ derivation


def derive_transfer_collectives(leaf_src: LeafInfo, src_sizes: dict,
                                leaf_dst: LeafInfo, dst_sizes: dict,
                                el_bytes: int, src_on_device: bool,
                                same_mesh: bool) -> list[dict]:
    """The static GSPMD-style derivation: the collective list one leaf's
    source→dest re-placement lowers to. Each entry carries {kind, axis,
    bytes (wire bytes per chip), out_bytes} — seconds are priced
    separately so the derivation stays machine-independent. Kinds:

      all_gather  unwind a source-sharded axis (the REQUIRED gather path
                  out of a ZeRO at-rest layout)
      all_to_all  an axis moved between dims on one mesh
      slice       dest-side sharding taken as a free local slice
      host_hop    the full logical array crosses the host (checkpoint
                  restore, or meshes with no compatible device layout)
    """
    shape = leaf_src.shape
    logical = el_bytes * float(max(1, math.prod(shape)) if shape else 1)
    src_assign = leaf_src.assignment
    dst_assign = leaf_dst.assignment
    cols: list[dict] = []
    if not src_on_device:
        cols.append({"kind": "host_hop", "axis": "",
                     "bytes": logical, "out_bytes": logical})
    elif same_mesh:
        ndim = len(shape)
        sa = tuple(src_assign or ((),) * ndim)
        da = tuple(dst_assign or ((),) * ndim)
        removed, added = [], []
        for i in range(ndim):
            f = set(sa[i]) if i < len(sa) else set()
            t = set(da[i]) if i < len(da) else set()
            removed += [(i, ax) for ax in sorted(f - t)]
            added += [(i, ax) for ax in sorted(t - f)]
        moved = {ax for _, ax in removed} & {ax for _, ax in added}
        grown = _shard_bytes(shape, sa, src_sizes, el_bytes)
        for _i, ax in removed:
            n = src_sizes.get(ax, 1)
            if ax in moved:
                cols.append({"kind": "all_to_all", "axis": ax,
                             "bytes": (n - 1) / max(1, n) * grown,
                             "out_bytes": grown})
            else:
                grown *= n
                cols.append({"kind": "all_gather", "axis": ax,
                             "bytes": (n - 1) / max(1, n) * grown,
                             "out_bytes": grown})
        for _i, ax in added:
            if ax not in moved:
                cols.append({"kind": "slice", "axis": ax,
                             "bytes": 0.0, "out_bytes": 0.0})
    else:
        # cross-mesh: unwind every source-sharded axis to the full
        # logical array (gather path), then the dest layout is a free
        # local slice — the conservative program device_put realizes
        grown = _shard_bytes(shape, src_assign, src_sizes, el_bytes)
        for i, entry in enumerate(src_assign or ()):
            for ax in entry:
                n = src_sizes.get(ax, 1)
                if n <= 1:
                    continue
                grown *= n
                cols.append({"kind": "all_gather", "axis": ax,
                             "bytes": (n - 1) / max(1, n) * grown,
                             "out_bytes": grown})
        for i, entry in enumerate(dst_assign or ()):
            for ax in entry:
                if dst_sizes.get(ax, 1) > 1:
                    cols.append({"kind": "slice", "axis": ax,
                                 "bytes": 0.0, "out_bytes": 0.0})
    return cols


@dataclass
class TransitionPlan:
    """The static transfer program between two PlanSides, verified by
    `verify_transition` and executed by `resilience.migrate`."""

    src: PlanSide
    dst: PlanSide
    transfers: list = field(default_factory=list)
    predicted_s: float = 0.0
    bytes_on_wire: dict = field(default_factory=dict)
    hbm_cap_bytes: float = 0.0
    schedule_digest: str = ""

    def to_json(self, analysis: Optional[AnalysisResult] = None) -> dict:
        out = {
            "kind": "transition_plan",
            "src": self.src.to_json(),
            "dst": self.dst.to_json(),
            "transfers": [dict(t) for t in self.transfers],
            "predicted_s": self.predicted_s,
            "bytes_on_wire": dict(self.bytes_on_wire),
            "hbm_cap_bytes": self.hbm_cap_bytes,
            "schedule_digest": self.schedule_digest,
        }
        if analysis is not None:
            out["analysis"] = analysis.to_json()
        return out


def schedule_digest(transfers) -> str:
    """Canonical digest of the transfer program: computed over entries
    sorted by leaf key with only schedule-bearing fields, so every host
    that derives the plan from the same (old, new) pair lands on the
    SAME digest regardless of dict iteration order — the
    transfer_uniformity pass re-derives exactly this."""
    canon = []
    for t in sorted(transfers, key=lambda t: t["key"]):
        canon.append([
            t["key"], t["order"],
            [list(map(list, t.get("src_spec") or []))],
            [list(map(list, t.get("dst_spec") or []))],
            [[c["kind"], c["axis"]] for c in t["collectives"]],
        ])
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()[:16]


def transition_totals(transfers) -> tuple[float, dict]:
    """(predicted seconds, bytes-on-wire per axis) from the per-transfer
    entries ALONE — the documented aggregation rule: host hops serialize
    with everything (they drain through the host NIC), ICI collectives
    on the same mesh axis serialize against each other, and disjoint
    axes overlap. This is the makespan-identity function:
    `verify_transition_total` recomputes the plan's predicted_s through
    exactly this from the serialized JSON."""
    host_s = 0.0
    per_axis_s: dict[str, float] = {}
    wire: dict[str, float] = {}
    for t in transfers:
        for c in t["collectives"]:
            if c["kind"] == "slice":
                continue
            if c["kind"] == "host_hop":
                host_s += c.get("seconds", 0.0)
                wire["host"] = wire.get("host", 0.0) + c["bytes"]
            else:
                ax = c.get("axis") or ""
                per_axis_s[ax] = per_axis_s.get(ax, 0.0) \
                    + c.get("seconds", 0.0)
                wire[ax] = wire.get(ax, 0.0) + c["bytes"]
    return host_s + max(per_axis_s.values(), default=0.0), wire


def verify_transition_total(section: dict) -> float:
    """Recompute the transition section's predicted migration seconds
    from its own per-transfer entries under the aggregation rule —
    matches section["predicted_s"] by construction (the ffcheck-identity
    treatment; run_doctor --check gates on it)."""
    total, _ = transition_totals(section.get("transfers") or [])
    return total


def build_transition_plan(src: PlanSide, dst: PlanSide,
                          machine=None, hbm_cap_bytes: float = 0.0
                          ) -> TransitionPlan:
    """Derive + price the static transfer program for every dst leaf
    with a matching src leaf. Leaves missing on either side stay OFF the
    transfer list — that absence is exactly what the state_mapping pass
    reports (`dropped_state` / `unmapped_state`), so an incomplete
    mapping is a finding, not a crash."""
    from ..search.cost_model import price_transfer_collective

    same_mesh = (src.on_device and dst.on_device
                 and src.axis_sizes == dst.axis_sizes)
    plan = TransitionPlan(src=src, dst=dst, hbm_cap_bytes=hbm_cap_bytes)
    order_keys = sorted(
        dst.leaves,
        key=lambda k: (dst.leaves[k].topo_pos, k))
    for order, key in enumerate(order_keys):
        ld = dst.leaves[key]
        ls = src.leaves.get(key)
        if ls is None:
            continue
        el = _itemsize(ls.dtype)
        cols = derive_transfer_collectives(
            ls, src.axis_sizes, ld, dst.axis_sizes, el,
            src.on_device, same_mesh)
        for c in cols:
            c["seconds"] = price_transfer_collective(
                c["kind"], c["bytes"], c["out_bytes"], c["axis"], machine)
        src_b = (_shard_bytes(ls.shape, ls.assignment, src.axis_sizes, el)
                 if src.on_device else 0.0)
        dst_b = _shard_bytes(ld.shape, ld.assignment, dst.axis_sizes, el)
        logical = el * float(max(1, math.prod(ls.shape))
                             if ls.shape else 1)
        # transfer buffer: an on-device gather materializes the full
        # logical array in HBM in flight; a host hop stages the full
        # array in HOST RAM and copies each rank's block in (restore_tree
        # takes the block before it moves: its HBM footprint is the dest
        # shard); a pure same-mesh reshard carries at most the larger
        # shard
        if any(c["kind"] == "all_gather" for c in cols):
            buf = logical
        elif any(c["kind"] == "host_hop" for c in cols):
            buf = dst_b
        else:
            buf = max(src_b, dst_b)
        plan.transfers.append({
            "key": key,
            "order": order,
            "shape": list(ls.shape),
            "dtype": ls.dtype,
            "dst_dtype": ld.dtype,
            "dst_shape": list(ld.shape),
            "src_spec": [list(e) for e in (ls.assignment or ())],
            "dst_spec": [list(e) for e in (ld.assignment or ())],
            "src_shard_bytes": src_b,
            "dst_shard_bytes": dst_b,
            "buffer_bytes": buf,
            "update_sharded": ls.update_sharded,
            "kv_pool": ls.kv_pool,
            "donate_src": True,
            "collectives": cols,
            "seconds": float(sum(c.get("seconds", 0.0) for c in cols)),
        })
    plan.predicted_s, plan.bytes_on_wire = transition_totals(plan.transfers)
    plan.schedule_digest = schedule_digest(plan.transfers)
    return plan


def plan_model_transition(old, new) -> TransitionPlan:
    """TransitionPlan between two compiled FFModels over the same
    logical PCG (`resilience.migrate_state` executes it in-process)."""
    from ..search.machine_model import machine_model_for_mesh

    machine = machine_model_for_mesh(
        old.mesh, num_hosts=old.config.num_nodes)
    cap = (new.config.device_mem if new.config.device_mem > 0
           else machine_model_for_mesh(
               new.mesh, num_hosts=new.config.num_nodes).chip.hbm_bytes)
    return build_transition_plan(
        PlanSide.from_model(old, label="old"),
        PlanSide.from_model(new, label="new"),
        machine=machine, hbm_cap_bytes=cap)


# ---------------------------------------------------------------- passes


def _check_state_mapping(plan: TransitionPlan) -> list[Finding]:
    findings: list[Finding] = []
    mapped_src = {t["key"] for t in plan.transfers}
    mapped_dst = {t["key"] for t in plan.transfers}
    for key in sorted(set(plan.src.leaves) - mapped_src):
        findings.append(Finding(
            SEV_ERROR, "dropped_state",
            f"old-plan leaf {key} has no mapping in the transition — its "
            f"state would be silently lost by the migration",
            where=key))
    for key in sorted(set(plan.dst.leaves) - mapped_dst):
        findings.append(Finding(
            SEV_ERROR, "unmapped_state",
            f"new-plan leaf {key} has no source in the old plan — the "
            f"migrated model would run on uninitialized state "
            f"(architecture mismatch?)",
            where=key))
    kv_flagged = False
    if (plan.src.kv_block_size is not None
            and plan.dst.kv_block_size is not None
            and plan.src.kv_block_size != plan.dst.kv_block_size):
        kv_flagged = True
        findings.append(Finding(
            SEV_ERROR, "kv_pool_mismatch",
            f"serving KV block size changes across the transition "
            f"({plan.src.kv_block_size} -> {plan.dst.kv_block_size}) — "
            f"block pools cannot be repacked by a reshard; drain the "
            f"engine and re-prefill instead",
            details={"src_block_size": plan.src.kv_block_size,
                     "dst_block_size": plan.dst.kv_block_size}))
    for t in plan.transfers:
        key = t["key"]
        if t.get("kv_pool") and tuple(t["shape"]) != tuple(t["dst_shape"]):
            if not kv_flagged:
                findings.append(Finding(
                    SEV_ERROR, "kv_pool_mismatch",
                    f"KV pool {key} geometry changes "
                    f"{tuple(t['shape'])} -> {tuple(t['dst_shape'])} — "
                    f"block pools/page tables cannot be repacked by a "
                    f"reshard", where=key,
                    details={"src_shape": t["shape"],
                             "dst_shape": t["dst_shape"]}))
            continue
        if tuple(t["shape"]) != tuple(t["dst_shape"]):
            findings.append(Finding(
                SEV_ERROR, "state_shape_change",
                f"leaf {key} has shape {tuple(t['shape'])} in the old "
                f"plan but {tuple(t['dst_shape'])} in the new — "
                f"architecture mismatch, not a re-placement",
                where=key,
                details={"src_shape": t["shape"],
                         "dst_shape": t["dst_shape"]}))
        if t["dtype"] != t["dst_dtype"]:
            findings.append(Finding(
                SEV_ERROR, "state_dtype_change",
                f"leaf {key} is {t['dtype']} in the old plan but "
                f"{t['dst_dtype']} in the new — a silent cast here is "
                f"dtype drift, not a re-placement",
                where=key,
                details={"src_dtype": t["dtype"],
                         "dst_dtype": t["dst_dtype"]}))
        # gather path: every source-sharded axis a transfer must unwind
        # (an axis the dest does not keep on the same dim — ALL source
        # axes cross-mesh) needs a recorded all_gather / host_hop; a
        # stage-3 at-rest shard re-placed replicated without one is the
        # corruption class that used to surface as garbage values
        required = _required_unwinds(plan, t)
        # an axis is unwound by its all_gather OR carried to its new dim
        # by an all_to_all (a same-mesh axis move is a legal transfer,
        # not a missing gather)
        got = {c["axis"] for c in t["collectives"]
               if c["kind"] in ("all_gather", "all_to_all")}
        hop = any(c["kind"] == "host_hop" for c in t["collectives"])
        missing = sorted(required - got) if not hop else []
        if missing:
            stage = plan.src.update_stage
            findings.append(Finding(
                SEV_ERROR, "missing_gather_path",
                f"leaf {key} leaves a sharded at-rest layout over "
                f"{missing}"
                + (f" (ZeRO stage {stage})" if t.get("update_sharded")
                   else "")
                + " but the transfer records no gather path — the "
                  "migration would re-place partial shards as whole "
                  "values", where=key,
                details={"missing_axes": missing,
                         "update_sharded": bool(t.get("update_sharded"))}))
    return findings


def _required_unwinds(plan: TransitionPlan, t: dict) -> set:
    if not plan.src.on_device:
        return set()
    same_mesh = (plan.dst.on_device
                 and plan.src.axis_sizes == plan.dst.axis_sizes)
    src_spec = t.get("src_spec") or []
    dst_spec = t.get("dst_spec") or []
    required = set()
    for i, entry in enumerate(src_spec):
        keep = set(dst_spec[i]) if same_mesh and i < len(dst_spec) else set()
        for ax in entry:
            if plan.src.axis_sizes.get(ax, 1) > 1 and ax not in keep:
                required.add(ax)
    return required


def _check_transition_memory(plan: TransitionPlan) -> list[Finding]:
    """Per-chip memory over the transfer schedule: every source shard is
    resident until its transfer lands (then donated), every dest shard
    from when it lands, plus the in-flight transfer buffer. Two-keyed
    like ffcheck's OOM gate: `transition_oom` is an ERROR only when the
    donation-scheduled peak AND the conservative both-layouts-resident
    bound both exceed the cap (the scheduled peak is always <= the
    bound, so an error means even perfect donation cannot fit);
    schedule-fits-only-via-donation is surfaced in the timeline
    details."""
    findings: list[Finding] = []
    transfers = sorted(plan.transfers, key=lambda t: t["order"])
    src_resident = sum(t["src_shard_bytes"] for t in transfers)
    # source leaves with no mapping still occupy their chips until the
    # old state is released — count them resident through the whole walk
    mapped = {t["key"] for t in transfers}
    src_resident += sum(
        _leaf_bytes(plan.src, k) for k in plan.src.leaves
        if k not in mapped and plan.src.on_device)
    dst_resident = 0.0
    peak, peak_at = src_resident, "(start)"
    max_buf = 0.0
    timeline = []
    for t in transfers:
        live = src_resident + dst_resident + t["buffer_bytes"]
        max_buf = max(max_buf, t["buffer_bytes"])
        timeline.append({"key": t["key"], "live_bytes": live})
        if live > peak:
            peak, peak_at = live, t["key"]
        src_resident -= t["src_shard_bytes"]
        dst_resident += t["dst_shard_bytes"]
    conservative = (
        sum(t["src_shard_bytes"] for t in transfers)
        + sum(t["dst_shard_bytes"] for t in transfers) + max_buf)
    cap = plan.hbm_cap_bytes
    details = {
        "peak_bytes": peak, "peak_at": peak_at,
        "conservative_bytes": conservative,
        "hbm_cap_bytes": cap,
        "donation_required": bool(cap and conservative > cap >= peak),
        "timeline": timeline[:_TIMELINE_CAP],
    }
    findings.append(Finding(
        SEV_INFO, "transition_memory_timeline",
        f"transition peak {peak / 2**20:.2f} MiB/chip at {peak_at} "
        f"(both-layouts bound {conservative / 2**20:.2f} MiB)",
        details=details))
    if cap and cap > 0 and peak > cap:
        over = [e for e in timeline if e["live_bytes"] > cap][:4]
        findings.append(Finding(
            SEV_ERROR, "transition_oom",
            f"transition-time per-chip peak {peak / 2**20:.2f} MiB "
            f"exceeds the {cap / 2**20:.2f} MiB cap at {peak_at} even "
            f"under the donation schedule (old shard + new shard + "
            f"transfer buffer)",
            details={"peak_bytes": peak, "cap_bytes": cap,
                     "peak_at": peak_at, "first_over_cap": over}))
    return findings


def _leaf_bytes(side: PlanSide, key: str) -> float:
    leaf = side.leaves[key]
    el = _itemsize(leaf.dtype)
    return _shard_bytes(leaf.shape, leaf.assignment, side.axis_sizes, el)


def _check_transfer_collectives(plan: TransitionPlan) -> list[Finding]:
    from ..parallel.ops import ring_permutation
    from .collectives import check_permutation

    findings: list[Finding] = []
    # ring bijectivity once per distinct ring size any transfer
    # collective runs over (the gathers/all_to_alls lower to the SAME
    # shared ring-schedule builder the runtime rings use)
    sizes = {}
    for t in plan.transfers:
        for c in t["collectives"]:
            if c["kind"] in ("all_gather", "all_to_all") and c["axis"]:
                n = plan.src.axis_sizes.get(
                    c["axis"], plan.dst.axis_sizes.get(c["axis"], 1))
                if n > 1:
                    sizes.setdefault(n, c["axis"])
    for n in sorted(sizes):
        for f in check_permutation(
                ring_permutation(n), n,
                where=f"transfer ring over {sizes[n]}={n}"):
            findings.append(Finding(
                SEV_ERROR, "bad_transfer_permutation", f.message,
                where=f.where, details=f.details))
    # topological transfer order: the schedule must follow the dst
    # graph's topo positions (ties broken by key) — a divergent order
    # breaks the donation schedule's memory accounting and, multihost,
    # the collective issue order
    order_sorted = sorted(plan.transfers, key=lambda t: t["order"])
    expected = sorted(
        plan.transfers,
        key=lambda t: (plan.dst.leaves[t["key"]].topo_pos
                       if t["key"] in plan.dst.leaves else 1 << 30,
                       t["key"]))
    got = [t["key"] for t in order_sorted]
    want = [t["key"] for t in expected]
    if got != want:
        first = next(i for i, (g, w) in enumerate(zip(got, want))
                     if g != w)
        findings.append(Finding(
            SEV_ERROR, "nontopological_transfer_order",
            f"transfer schedule departs from the topological order at "
            f"position {first} ({got[first]} before {want[first]}) — "
            f"the donation-schedule memory accounting and the multihost "
            f"collective issue order both key on it",
            details={"position": first, "got": got[first],
                     "want": want[first]}))
    return findings


def _check_migration_donation(plan: TransitionPlan) -> list[Finding]:
    findings: list[Finding] = []
    seen: dict[str, int] = {}
    for t in plan.transfers:
        if not t.get("donate_src"):
            continue
        if t["key"] in seen:
            findings.append(Finding(
                SEV_ERROR, "migration_donation_hazard",
                f"source leaf {t['key']} is donated by two transfers "
                f"(orders {seen[t['key']]} and {t['order']}) — the "
                f"second would read a dead buffer",
                where=t["key"]))
        seen[t["key"]] = t["order"]
    # the migrate apply path's own host code must be donated-reuse clean
    # (the executables it calls donate their inputs)
    findings.extend(_migrate_source_findings())
    return findings


_migrate_scan_cache: Optional[list] = None


def _migrate_source_findings() -> list[Finding]:
    """donated_reuse scan of resilience/migrate.py (the apply path of
    every migration), cached per process (sources.py pattern)."""
    global _migrate_scan_cache
    if _migrate_scan_cache is None:
        import os

        from .lint import lint_file
        from .sources import package_root

        path = os.path.join(package_root(), "resilience", "migrate.py")
        found: list[Finding] = []
        if os.path.exists(path):
            for f in lint_file(path, select=("donated_reuse",)):
                f.pass_name = ""
                found.append(f)
        _migrate_scan_cache = found
    return list(_migrate_scan_cache)


def _check_transfer_uniformity(plan: TransitionPlan) -> list[Finding]:
    want = schedule_digest(plan.transfers)
    if plan.schedule_digest != want:
        return [Finding(
            SEV_ERROR, "transfer_schedule_divergence",
            f"transfer schedule digest {plan.schedule_digest!r} does not "
            f"re-derive from the canonical sorted entries ({want!r}) — "
            f"hosts would build different transfer programs",
            details={"recorded": plan.schedule_digest, "derived": want})]
    return []


_PASS_RUNNERS = (
    ("state_mapping", _check_state_mapping),
    ("transition_memory", _check_transition_memory),
    ("transfer_collectives", _check_transfer_collectives),
    ("migration_donation", _check_migration_donation),
    ("transfer_uniformity", _check_transfer_uniformity),
)


def verify_transition(plan: TransitionPlan) -> AnalysisResult:
    """Run the transition pass pipeline. Same crash policy as
    run_analysis: a crashed pass reports analysis_crash at WARNING
    instead of taking the caller down with a verifier bug."""
    import time as _time

    from .findings import SEV_WARNING

    result = AnalysisResult()
    t0 = _time.perf_counter()
    for name, runner in _PASS_RUNNERS:
        try:
            result.extend(runner(plan), pass_name=name)
        except Exception as e:
            result.extend([Finding(
                SEV_WARNING, "analysis_crash",
                f"pass {name} crashed (its checks did NOT run): "
                f"{type(e).__name__}: {e}")], pass_name=name)
        result.passes_run.append(name)
    if result.ok:
        result.extend([Finding(
            SEV_INFO, "transition_clean",
            f"{len(plan.transfers)} transfer(s) map completely, "
            f"predicted {plan.predicted_s * 1e3:.3f} ms")],
            pass_name="state_mapping")
    result.elapsed_s = _time.perf_counter() - t0
    return result


def gate_transition(plan: TransitionPlan, config, label: str = "migration"
                    ) -> AnalysisResult:
    """Verify + enforce: raise PlanVerificationError on errors unless
    --no-verify-plan (errors downgrade to logged warnings, still
    recorded) — the gate the checkpoint-restore path calls before
    touching live state."""
    from .. import telemetry
    from ..telemetry import log as fflog

    result = verify_transition(plan)
    telemetry.event(
        "transition_verify", label=label,
        predicted_s=plan.predicted_s,
        transfers=len(plan.transfers), **result.summary())
    errs = result.errors()
    if errs:
        if getattr(config, "verify_plan", True):
            raise PlanVerificationError(result)
        fflog.warning(
            "%s: transition verification found %d error(s) "
            "(--no-verify-plan: applying anyway): %s", label, len(errs),
            "; ".join(str(f) for f in errs[:5]))
    return result
